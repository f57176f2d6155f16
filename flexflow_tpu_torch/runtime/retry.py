"""Retry policy: jittered exponential backoff.

PyTorch counterpart of ``flexflow_tpu/runtime/retry.py`` without its
metrics counters and the ``label`` that names them (the port has no
metrics registry yet). With ``seed`` set the jitter comes from a fresh
``random.Random(seed)`` per :meth:`call`, so a replayed run backs off
identically; with ``seed`` None the process-wide generator jitters.
:meth:`call` sleeps between attempts, never inside ``fn``, so a caller's
lock taken inside ``fn`` is never held while it sleeps. Nothing in the
port calls it yet: serving's dispatch retry comes with the fault sites that
raise the reference's ``TransientFault``.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, Type


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
        ``max_attempts`` attempts in all; the last failure is raised."""
        rng = None  # the seeded generator is made only when a retry needs it
        attempts = max(1, int(self.max_attempts))
        for attempt in range(attempts):
            try:
                return fn(*args, **kwargs)
            except self.retry_on:
                if attempt + 1 >= attempts:
                    raise
                if rng is None and self.seed is not None:
                    rng = random.Random(self.seed)
                time.sleep(self.delay_s(attempt, rng))


__all__ = ["RetryPolicy"]
