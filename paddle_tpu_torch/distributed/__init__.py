"""``paddle.distributed`` on ``torch.distributed`` (mirrors
``paddle_tpu/distributed/__init__.py:8-19``; reference surface:
python/paddle/distributed/ — collective.py, parallel.py, spawn.py,
fleet/).

Process groups and the env protocol (``env``), the mesh of named axes
(``mesh``), the eager collectives (``collective``), the SPMD primitives
over a mesh axis (``primitives``), ``DataParallel``, the tensor-parallel
layers, ``fleet``, and the launcher (``python -m
paddle_tpu_torch.distributed.launch``). The trainers over a {dp, pp,
tp, sp, ep} mesh with ZeRO 1-3 are ``hybrid.HybridPipelineTrainer`` (the
pipeline protocol; ``hybrid_gpt.GPTHybridTrainer``) and
``strategy_compiler.compile_train_step`` (any layer; dp, tp and ep);
``qcomm`` holds their data-parallel update, ``pipeline`` the schedules
over ``pp``, ``moe`` the expert-parallel MoE layer and
``ops.ring_attention`` the ring over ``sp``.
"""
from . import fleet, primitives
from .collective import (ReduceOp, all_gather, all_reduce, alltoall,
                         barrier, broadcast, get_group, recv, reduce,
                         reduce_scatter, scatter, send, split)
from .env import (ParallelEnv, get_rank, get_world_size, init_parallel_env,
                  is_initialized)
from .mesh import (P, axis_size, create_mesh, get_mesh, init_mesh, set_mesh,
                   sharding)
from .parallel import DataParallel
from .parallel_layers import (ColumnParallelLinear, ParallelEmbedding,
                              RowParallelLinear, VocabParallelEmbedding)

__all__ = ["fleet", "primitives", "ReduceOp", "all_gather", "all_reduce",
           "alltoall", "barrier", "broadcast", "get_group", "recv", "reduce",
           "reduce_scatter", "scatter", "send", "split", "ParallelEnv",
           "get_rank", "get_world_size", "init_parallel_env",
           "is_initialized", "P", "axis_size", "create_mesh", "get_mesh",
           "init_mesh", "set_mesh", "sharding", "DataParallel",
           "ColumnParallelLinear", "ParallelEmbedding", "RowParallelLinear",
           "VocabParallelEmbedding", "spawn"]


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """reference: distributed/spawn.py. Not served in-process, as in the
    reference: launch one process per rank with the launcher."""
    raise NotImplementedError(
        "spawn: launch one process per rank via `python -m "
        "paddle_tpu_torch.distributed.launch` (env protocol "
        "PADDLE_TRAINER_*).")
