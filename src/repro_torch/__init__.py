"""PyTorch / CUDA port of the dedup-serving system.

A second package beside ``repro`` (the JAX reference): the same module
names, torch tensors on an explicit device, and hand-written Hopper
kernels in ``repro_torch.kernels`` where the reference has Pallas ones.
It imports neither jax nor anything of ``repro``.
"""
