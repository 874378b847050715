"""Kernels and their plain PyTorch versions (mirrors ``paddle_tpu.ops``).

Each kernel wrapper takes the plain version only for tensors on the CPU;
on a CUDA tensor it launches its hand-written kernel (``csrc/``) or
raises. Each counts its launches in a module-level integer. The decoding
loops (``decoding``) hold no kernel: the reference computes them outside
Pallas too.
"""
from .decoding import (apply_top_k_top_p, apply_top_k_top_p_per_row,
                       beam_search_decode, greedy_decode, sampling_decode,
                       spec_accept_length, spec_rejection_sample,
                       tile_cache_for_beams)

__all__ = ["apply_top_k_top_p", "apply_top_k_top_p_per_row",
           "beam_search_decode", "greedy_decode", "sampling_decode",
           "spec_accept_length", "spec_rejection_sample",
           "tile_cache_for_beams"]
