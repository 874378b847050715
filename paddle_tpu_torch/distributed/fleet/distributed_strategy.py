"""DistributedStrategy — the port's own copy of
``paddle_tpu/distributed/fleet/distributed_strategy.py`` (reference:
python/paddle/distributed/fleet/base/distributed_strategy.py +
framework/distributed_strategy.proto:122).

A typed config tree of pure dataclasses, every strategy bit of the
reference represented. The port's trainer
(``distributed/hybrid.py``) reads ``amp``, ``recompute`` and the
degrees; it refuses the parallel and offload switches it does not
run yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class RecomputeConfig:
    checkpoints: List[str] = field(default_factory=list)
    enable_offload: bool = False
    checkpoint_shape: List[int] = field(default_factory=list)


@dataclass
class AMPConfig:
    init_loss_scaling: float = 32768.0
    incr_every_n_steps: int = 1000
    decr_every_n_nan_or_inf: int = 2
    incr_ratio: float = 2.0
    decr_ratio: float = 0.5
    use_dynamic_loss_scaling: bool = True
    custom_white_list: List[str] = field(default_factory=list)
    custom_black_list: List[str] = field(default_factory=list)
    custom_black_varnames: List[str] = field(default_factory=list)
    use_pure_fp16: bool = False
    use_fp16_guard: bool = True
    dtype: str = "bfloat16"  # the amp compute dtype


@dataclass
class ShardingConfig:
    segment_broadcast_MB: float = 32.0
    hybrid_dp: bool = False
    sharding_degree: int = 1
    sharding_stage: int = 2          # 1/2/3 (stage-3 is new vs reference)
    offload: bool = False


@dataclass
class PipelineConfig:
    micro_batch: int = 1
    accumulate_steps: int = 1
    schedule: str = "1F1B"   # improves on reference F-then-B


@dataclass
class TensorParallelConfig:
    tensor_parallel_degree: int = 1
    tensor_init_seed: int = -1


@dataclass
class HybridConfig:
    dp_degree: int = -1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sp_degree: int = 1   # sequence/context parallel (beyond reference)
    ep_degree: int = 1   # expert parallel (beyond reference)


@dataclass
class DGCConfig:
    rampup_begin_step: int = 0
    rampup_step: int = 1
    sparsity: List[float] = field(default_factory=lambda: [0.999])


@dataclass
class LarsConfig:
    lars_coeff: float = 0.001
    lars_weight_decay: float = 0.0005
    epsilon: float = 0.0
    exclude_from_weight_decay: List[str] = field(default_factory=list)


@dataclass
class LambConfig:
    lamb_weight_decay: float = 0.01
    exclude_from_weight_decay: List[str] = field(default_factory=list)


@dataclass
class LocalSGDConfig:
    k_steps: int = 1
    begin_step: int = 1


@dataclass
class AdaptiveLocalSGDConfig:
    init_k_steps: int = 1
    begin_step: int = 1


@dataclass
class GradientMergeConfig:
    k_steps: int = 1
    avg: bool = True


@dataclass
class AsyncConfig:
    k_steps: int = -1
    max_merge_var_num: int = 1
    send_queue_size: int = 16
    independent_recv_thread: bool = False
    thread_pool_size: int = 1
    send_wait_times: int = 1
    runtime_split_send_recv: bool = False


class DistributedStrategy:
    def __init__(self):
        # feature switches (reference proto fields)
        self.recompute = False
        self.recompute_configs = RecomputeConfig()
        self.amp = False
        self.amp_configs = AMPConfig()
        self.sharding = False
        self.sharding_configs = ShardingConfig()
        self.pipeline = False
        self.pipeline_configs = PipelineConfig()
        self.tensor_parallel = False
        self.tensor_parallel_configs = TensorParallelConfig()
        self.hybrid_configs = HybridConfig()
        self.dgc = False
        self.dgc_configs = DGCConfig()
        self.lars = False
        self.lars_configs = LarsConfig()
        self.lamb = False
        self.lamb_configs = LambConfig()
        self.localsgd = False
        self.localsgd_configs = LocalSGDConfig()
        self.adaptive_localsgd = False
        self.adaptive_localsgd_configs = AdaptiveLocalSGDConfig()
        self.gradient_merge = False
        self.gradient_merge_configs = GradientMergeConfig()
        self.fp16_allreduce = False      # bf16 collectives are the default
        self.a_sync = False              # parameter-server async
        self.a_sync_configs = AsyncConfig()
        self.elastic = False
        self.auto = False
        # execution knobs of the reference: accepted and recorded
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 1
        self.fuse_grad_size_in_MB = 32
        self.fuse_grad_size_in_TFLOPS = 50
        self.fuse_all_reduce_ops = True
        self.sync_nccl_allreduce = True
        self.sync_batch_norm = False
        self.find_unused_parameters = False
        self.last_comm_group_size_MB = 1
        self.cudnn_exhaustive_search = False
        self.conv_workspace_size_limit = 512
        self.cudnn_batchnorm_spatial_persistent = False
        # remat policy (an extension of the reference)
        self.recompute_granularity = "full"  # full | selective

    def _config(self, attr, configs: Dict[str, Any]):
        obj = getattr(self, attr)
        for k, v in configs.items():
            if hasattr(obj, k):
                setattr(obj, k, v)
        return obj

    # dict-style setters like the reference python wrapper
    def __setattr__(self, key, value):
        if key.endswith("_configs") and isinstance(value, dict):
            self._config(key, value)
        else:
            object.__setattr__(self, key, value)

    def __repr__(self):
        on = [k for k, v in self.__dict__.items()
              if isinstance(v, bool) and v]
        return f"DistributedStrategy(enabled={on})"
