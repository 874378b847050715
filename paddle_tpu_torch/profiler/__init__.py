"""Host-side metrics (mirrors ``paddle_tpu.profiler``). This slice has the
counter/gauge/histogram registry and the on/off switch that the trainer
reads; the event log, recompile telemetry and device trace come later."""
from .metrics import registry
from .trace import disable, enable, is_enabled

__all__ = ["registry", "enable", "disable", "is_enabled"]
