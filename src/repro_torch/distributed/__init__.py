"""Distributed training helpers of the port.  The sharding recipes and
the pipeline come with the sharding slice; gradient compression is
here."""
from .compression import (compress_with_feedback, dequantize_leaf,
                          init_error_state, make_grad_compressor,
                          quantize_leaf)

__all__ = ["compress_with_feedback", "dequantize_leaf", "init_error_state",
           "make_grad_compressor", "quantize_leaf"]
