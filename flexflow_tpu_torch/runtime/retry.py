"""Retry policy: jittered exponential backoff, with accounting.

PyTorch counterpart of ``flexflow_tpu/runtime/retry.py``. Serving's
dispatch (``serving/engine.py``), the scheduler's prefill, decode, draft
and verify dispatches (``serving/scheduler.py``) and the loader's batch
copy (``runtime/dataloader.py``) each wrap their call in a
:class:`RetryPolicy` that retries ``TransientFault``; every attempt, retry
and give-up is counted in the metrics registry as
``retry.<label>.attempts``/``.retries``/``.giveups``. With ``seed`` set the
jitter comes from a fresh ``random.Random(seed)`` per :meth:`call`, so a
replayed run backs off identically; with ``seed`` None the process-wide
generator jitters. :meth:`call` sleeps between attempts, never inside
``fn``, so a caller's lock taken inside ``fn`` is never held while it
sleeps.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, Type

from ..obs.metrics import metrics_registry


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Attempt i (0-based) that fails with one of ``retry_on`` sleeps
    ``min(base_delay_s * multiplier**i, max_delay_s)``, scaled by a uniform
    jitter in ``[1 - jitter, 1 + jitter]``, before the next attempt."""

    max_attempts: int = 3
    base_delay_s: float = 0.01
    multiplier: float = 2.0
    max_delay_s: float = 1.0
    jitter: float = 0.5
    retry_on: Tuple[Type[BaseException], ...] = (OSError,)
    label: str = "io"
    seed: Optional[int] = None

    def delay_s(self, attempt: int, rng=None) -> float:
        """The sleep after ``attempt`` (0-based), jitter applied."""
        d = min(self.base_delay_s * (self.multiplier ** attempt), self.max_delay_s)
        if self.jitter > 0:
            u = rng.random() if rng is not None else random.random()
            d *= 1.0 - self.jitter + 2.0 * self.jitter * u
        return max(0.0, d)

    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn(*args, **kwargs)``, retrying ``retry_on`` failures up to
        ``max_attempts`` attempts in all; the last failure is raised (and
        counted as a give-up)."""
        reg = metrics_registry()
        rng = None  # the seeded generator is made only when a retry needs it
        attempts = max(1, int(self.max_attempts))
        for attempt in range(attempts):
            reg.counter(f"retry.{self.label}.attempts").inc()
            try:
                return fn(*args, **kwargs)
            except self.retry_on:
                if attempt + 1 >= attempts:
                    reg.counter(f"retry.{self.label}.giveups").inc()
                    raise
                reg.counter(f"retry.{self.label}.retries").inc()
                if rng is None and self.seed is not None:
                    rng = random.Random(self.seed)
                time.sleep(self.delay_s(attempt, rng))


__all__ = ["RetryPolicy"]
