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
clips, and ``distributed.hybrid.HybridPipelineTrainer`` at degree 1;
process groups and collectives on ``torch.distributed``
(``distributed``: the env protocol and launcher, the mesh, the eager
collectives and SPMD primitives, ``DataParallel``, ``fleet``, the
tensor-parallel layers at tp > 1); the strategy compiler and the hybrid
trainer at dp, tp and ZeRO 1-3, with GPT's heads split over tp and a
vocab-parallel fused loss head; pipeline parallelism (GPipe and
interleaved), ring attention over sp and expert-parallel MoE in the
hybrid trainer; int8 quantized collectives, sharded asynchronous
checkpoints, prefetch, elastic resume and host offload with layer
streaming; and planning without allocation: ``LazyGuard``
(``framework.lazy``), the abstract hybrid trainer, and
``aot_lower``/``aot_compile``/``memory_analysis`` of any trainer on fake
tensors (``distributed.plan``), in a planning world of any size
(``distributed.env.plan_world``); and multi-process serving: the
consensus board (``distributed.consensus``), clock agreement
(``profiler.disttrace.ClockSync``), the KV handoff channel, the routing
function and ``serving.DisaggServer`` (disaggregated and symmetric
layouts, the elastic mesh, prefix routing), on real processes started by
``distributed.mp_mesh``.
"""
from .core.place import resolve_device
from .core.rng import seed
from .distributed.parallel import DataParallel
from .framework.lazy import LazyGuard

__all__ = ["resolve_device", "seed", "DataParallel", "LazyGuard"]
