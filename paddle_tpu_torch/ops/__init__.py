"""Kernels and their plain PyTorch versions (mirrors ``paddle_tpu.ops``).

Each kernel wrapper takes the plain version only for tensors on the CPU;
on a CUDA tensor it launches its hand-written kernel (``csrc/``) or
raises. Each counts its launches in a module-level integer.
"""
