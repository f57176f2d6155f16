"""Serving errors, shared by the engine, the paged KV pool and the
continuous-batching scheduler.

PyTorch counterpart of ``flexflow_tpu/serving/errors.py`` (a module of its
own so the pool and the scheduler raise them without importing the
engine).
"""

from __future__ import annotations


class ShedError(RuntimeError):
    """Request rejected at admission: the queue is past its bound, the
    failure breaker is open, or the paged KV pool can never hold the
    request's worst case. Callers back off or re-route: this is load
    shedding, not a server fault."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it could be served."""


class KVPoolExhausted(ShedError):
    """The paged KV pool cannot reserve the request's worst-case block
    count. A :class:`ShedError`: admission sheds instead of letting the
    decode loop run out of memory mid-request."""


__all__ = ["DeadlineExceeded", "KVPoolExhausted", "ShedError"]
