"""Distribution of the port: the sharding recipes (DTensor placements of
the reference's PartitionSpecs), the GPipe schedule
(``distributed.pipeline``, imported on its own) and int8 gradient
compression."""
from .compression import (compress_with_feedback, dequantize_leaf,
                          init_error_state, make_grad_compressor,
                          quantize_leaf)
from .sharding import (PartitionSpec, ShardingRecipe, cache_specs,
                       current_recipe, hint, make_recipe, param_spec,
                       param_specs, placements, use_recipe)

__all__ = ["PartitionSpec", "ShardingRecipe", "cache_specs",
           "compress_with_feedback", "current_recipe", "dequantize_leaf",
           "hint", "init_error_state", "make_grad_compressor",
           "make_recipe", "param_spec", "param_specs", "placements",
           "quantize_leaf", "use_recipe"]
