from .pipeline import SyntheticTextTask, token_batches

__all__ = ["SyntheticTextTask", "token_batches"]
