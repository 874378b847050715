"""The profiling switch (mirrors ``enable``/``disable``/``is_enabled`` of
``paddle_tpu/profiler/trace.py``). Instrumented code reads one bool per
step while it is off. Host spans, the event log and device traces come
with ROADMAP queue 1 item 6."""
from __future__ import annotations

_enabled = False


def is_enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False
