"""Host-side metrics (mirrors ``paddle_tpu.profiler``). This slice has the
counter/gauge/histogram registry; the event log, recompile telemetry and
device trace come later."""
from .metrics import registry

__all__ = ["registry"]
