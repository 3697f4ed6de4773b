from .optimizers import (Optimizer, adafactor, adamw, clip_by_global_norm,
                         cosine_schedule, global_norm, make_optimizer)

__all__ = ["Optimizer", "adafactor", "adamw", "clip_by_global_norm",
           "cosine_schedule", "global_norm", "make_optimizer"]
