"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its module paths and names so that each module's counterpart is easy to
find. Plain tensor code is PyTorch. Every Pallas TPU kernel on a ported
path is a hand-written CUDA C++ kernel for Hopper (``csrc/``), built with
``nvcc`` at first use (``ops/_build.py``) and kept beside a plain PyTorch
version of the same function. A wrapper runs the plain version only for
tensors that lie on the CPU; on a CUDA tensor it launches the kernel.

Entry points run on CUDA unless the caller passes ``device="cpu"``.

Ported so far: GPT inference — ``models.gpt.GPT.forward`` (flash
attention forward) and the paged continuous-batching engine
(``serving.ServingEngine``, ragged paged attention), plus the
``inference.serving.ServingPredictor`` front end — and one training step
on one device: ``GPT.loss`` (fused lm-head loss, flash attention
backward), ``optimizer.AdamW`` with the LR schedulers and gradient
clips, and ``distributed.hybrid.HybridPipelineTrainer`` at degree 1.
"""
from .core.place import resolve_device
from .core.rng import seed

__all__ = ["resolve_device", "seed"]
