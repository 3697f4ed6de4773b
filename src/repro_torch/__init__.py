"""PyTorch / CUDA port of the dedup-serving system.

A second package beside ``repro`` (the JAX reference): the same module
names, torch tensors on an explicit device, and hand-written Hopper
kernels in ``repro_torch.kernels`` where the reference has Pallas ones.
It imports neither jax nor anything of ``repro``.
"""
import os

# REPRO_SANITIZE=1 runs the port under its PoolSanitizer (the reference's
# switch, read by its own copy): every BufferPool / DevicePagePool /
# ShardedPagePool of the port constructed from here on is born
# instrumented, and a protocol violation raises at the violating call.
if os.environ.get("REPRO_SANITIZE", "") == "1":
    from .analysis import sanitizer  # noqa: F401  (self-enables, strict)
