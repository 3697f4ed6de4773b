from .registry import ModelAPI, build

__all__ = ["ModelAPI", "build"]
