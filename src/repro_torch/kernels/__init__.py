"""Hand-written Hopper kernels for the dedup hot spots, prefill
attention, the index build's LSH signatures and the exact bf16 split of
an fp32 matmul operand, with their plain PyTorch versions.

Each kernel = ``csrc/<name>.cu`` (CUDA C++ for sm_90a, plain C interface,
built by ``_build.py`` at first use) + a wrapper in ``ops.py`` + a plain
version in ``ref.py``.  On the CPU the wrappers run the plain versions.
"""
from . import ref
from .ops import (LAUNCHES, dedup_embedding, dedup_embedding_striped,
                  dedup_matmul, flash_attention, lsh_signature,
                  reset_launches, split_bf16x3)

__all__ = ["ref", "LAUNCHES", "reset_launches", "dedup_embedding",
           "dedup_embedding_striped", "dedup_matmul", "flash_attention",
           "lsh_signature", "split_bf16x3"]
