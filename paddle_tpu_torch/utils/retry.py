"""Bounded retry with exponential backoff (mirrors
``paddle_tpu/utils/retry.py``).

Shared by host-side I/O that may see transient failures: the handoff
channel of disaggregated serving (``serving/disagg.py``) retries every
file operation with it. With ``jitter=0`` the sleeps are ``base_delay *
factor**k`` capped at ``max_delay``, so a test can assert the schedule.
"""
from __future__ import annotations

import functools
import random
import time
from typing import Callable, Optional, Tuple, Type

__all__ = ["retry", "RetryError", "backoff_delays"]


class RetryError(RuntimeError):
    """Every attempt failed; ``last`` holds the final exception."""

    def __init__(self, attempts: int, last: BaseException):
        super().__init__(
            f"retry: {attempts} attempt(s) failed; last error: {last!r}")
        self.attempts = attempts
        self.last = last


def backoff_delays(attempts: int, base_delay: float, factor: float,
                   max_delay: float, jitter: float = 0.0,
                   seed: Optional[int] = None):
    """The sleeps between attempts (``attempts - 1`` of them). ``jitter``
    adds a uniform ``[0, jitter * delay)`` term, deterministic when a
    seed is given."""
    rng = random.Random(seed) if jitter else None
    out = []
    for k in range(max(0, attempts - 1)):
        d = min(base_delay * (factor ** k), max_delay)
        if rng is not None:
            d += rng.uniform(0.0, jitter * d)
        out.append(d)
    return out


def retry(fn: Optional[Callable] = None, *,
          attempts: int = 4,
          base_delay: float = 0.05,
          factor: float = 2.0,
          max_delay: float = 5.0,
          jitter: float = 0.0,
          seed: Optional[int] = None,
          exceptions: Tuple[Type[BaseException], ...] = (Exception,),
          on_retry: Optional[Callable] = None,
          sleep: Callable[[float], None] = time.sleep):
    """Call ``fn()`` up to ``attempts`` times with exponential backoff.

    A positional ``fn`` is called at once and its result returned; with
    no positional argument a decorator is returned::

        retry(lambda: flaky())
        @retry(attempts=6, exceptions=(OSError,))
        def load(): ...

    ``on_retry(attempt_index, exception, delay)`` sees every failed
    attempt that will be retried. Raises ``RetryError`` when all fail.
    """
    delays = backoff_delays(attempts, base_delay, factor, max_delay,
                            jitter=jitter, seed=seed)

    def _run(f, *args, **kwargs):
        last: Optional[BaseException] = None
        for i in range(attempts):
            try:
                return f(*args, **kwargs)
            except exceptions as e:   # noqa: PERF203 - retry loop
                last = e
                if i >= attempts - 1:
                    break
                d = delays[i]
                if on_retry is not None:
                    on_retry(i, e, d)
                if d > 0:
                    sleep(d)
        raise RetryError(attempts, last)

    if fn is not None:
        return _run(fn)

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            return _run(f, *args, **kwargs)

        return wrapper

    return deco
