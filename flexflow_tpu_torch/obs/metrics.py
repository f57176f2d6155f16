"""Metrics registry: named counters, gauges and histograms in one
process-wide instance, exported as JSON or Prometheus text.

PyTorch counterpart of ``flexflow_tpu/obs/metrics.py``, the whole module
(pure Python, so the port keeps its own copy). Every call site feeds the
same registry, so one snapshot (``metrics_registry().to_json()``) or one
scrape (``.to_prometheus()``) shows serving's shed, reject, respawn and
retry counters, its queue-wait and latency histograms, the fault plan's
firings, ``fit``'s and ``eval``'s :class:`EpochThroughput` series, the
pipeline's dispatch counts and the observability layer's own counters
together.
"""

from __future__ import annotations

import collections
import re
import threading
import time
from typing import Dict, List, Optional

# quantiles exported for every histogram (Prometheus summary convention)
_QUANTILES = (0.5, 0.9, 0.99)


def nearest_rank_percentile(xs, q: float) -> float:
    """The nearest-rank quantile every latency percentile uses (the
    histogram reservoirs, the scheduler's session phases), so p99s from
    different surfaces compare. ``xs`` must be non-empty and sorted."""
    return xs[min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))]


class Counter:
    """Monotonic counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        # GIL-atomic enough for stats: a torn read costs one sample of
        # drift, never a crash, and the hot loops take no lock a count
        self.value += n  # concurrency: race-ok (lock-free by design: GIL-atomic add, drift tolerated)

    def to_json(self):
        v = self.value
        return int(v) if float(v).is_integer() else v

    def merge(self, other: "Counter") -> None:
        self.value += other.value  # concurrency: race-ok (merge folds quiesced worker registries)


class Gauge:
    """Last-written value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)  # concurrency: race-ok (lock-free by design: GIL-atomic store of a last-writer-wins sample)

    def to_json(self):
        return self.value

    def merge(self, other: "Gauge") -> None:
        self.value = other.value  # concurrency: race-ok (merge folds quiesced worker registries)


class Histogram:
    """count/sum/min/max plus a bounded reservoir of the most recent
    samples for percentile estimation (latency p50/p90/p99). The
    reservoir keeps the RECENT window — the flight-recorder convention,
    matched to the tracer's ring buffer."""

    __slots__ = ("count", "sum", "min", "max", "_recent")

    def __init__(self, reservoir: int = 1024):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._recent: collections.deque = collections.deque(maxlen=reservoir)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1  # concurrency: race-ok (lock-free by design: GIL-atomic add, drift tolerated)
        self.sum += v  # concurrency: race-ok (lock-free by design, see count)
        if v < self.min:
            self.min = v  # concurrency: race-ok (lock-free by design, see count)
        if v > self.max:
            self.max = v  # concurrency: race-ok (lock-free by design, see count)
        self._recent.append(v)

    def percentile(self, q: float) -> float:
        xs = sorted(self._recent)
        if not xs:
            return 0.0
        return nearest_rank_percentile(xs, q)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_json(self) -> Dict:
        if not self.count:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": round(self.sum, 9),
            "mean": round(self.mean, 9),
            "min": self.min,
            "max": self.max,
            **{f"p{int(q * 100)}": self.percentile(q) for q in _QUANTILES},
        }

    def merge(self, other: "Histogram") -> None:
        self.count += other.count  # concurrency: race-ok (merge folds quiesced worker registries)
        self.sum += other.sum  # concurrency: race-ok (merge folds quiesced registries, see count)
        self.min = min(self.min, other.min)  # concurrency: race-ok (see count)
        self.max = max(self.max, other.max)  # concurrency: race-ok (see count)
        # reservoir merge: appending ALL of other's window into the
        # maxlen-bounded deque would evict every one of self's samples
        # whenever other has >= maxlen entries — merged percentiles would
        # reflect only one process. Instead each window is subsampled
        # (evenly strided, order preserved) to its proportional share of
        # the capacity and the two are interleaved, so future appends
        # evict both processes' samples fairly.
        if not other._recent:
            return
        cap = self._recent.maxlen
        a, b = list(self._recent), list(other._recent)
        if cap is not None and len(a) + len(b) > cap:
            na = min(len(a), max(1, round(cap * len(a) / (len(a) + len(b)))))
            a, b = _strided(a, na), _strided(b, cap - na)
        self._recent = collections.deque(  # concurrency: race-ok (see count)
            _interleave(a, b), maxlen=cap)


def _strided(xs: List[float], n: int) -> List[float]:
    """``n`` evenly-spaced samples of ``xs``, order preserved (the
    deterministic subsample the reservoir merge uses)."""
    if n >= len(xs):
        return list(xs)
    if n <= 0:
        return []
    step = len(xs) / n
    return [xs[min(len(xs) - 1, int(i * step))] for i in range(n)]


def _interleave(a: List[float], b: List[float]) -> List[float]:
    out: List[float] = []
    la, lb = len(a), len(b)
    for i in range(max(la, lb)):
        if i < la:
            out.append(a[i])
        if i < lb:
            out.append(b[i])
    return out


def _prom_name(name: str) -> str:
    """Dotted registry names -> Prometheus-legal metric names."""
    return "flexflow_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


class MetricsRegistry:
    """Name -> metric map. Creation is locked; recording goes straight
    to the (lock-free) metric objects."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(name, cls())
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def get(self, name: str):
        return self._metrics.get(name)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another registry in (same-name metrics must share a
        type): counters add, gauges take the other's value, histograms
        pool. Multi-process aggregation (one registry per worker,
        merged by the parent) and the round-trip tests use this."""
        for name in other.names():
            om = other.get(name)
            self._get(name, type(om)).merge(om)
        return self

    # ---------------------------------------------------------------- export
    def to_json(self) -> Dict:
        return {name: m.to_json() for name, m in sorted(self._metrics.items())}

    def to_prometheus(self) -> str:
        """Prometheus text exposition: counters/gauges as-is, histograms
        as summaries (quantile series + _sum/_count)."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            pn = _prom_name(name)
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pn} counter")
                lines.append(f"{pn} {m.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pn} gauge")
                lines.append(f"{pn} {m.value:g}")
            else:
                lines.append(f"# TYPE {pn} summary")
                for q in _QUANTILES:
                    lines.append(
                        f'{pn}{{quantile="{q}"}} {m.percentile(q):g}')
                lines.append(f"{pn}_sum {m.sum:g}")
                lines.append(f"{pn}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    @staticmethod
    def from_json(doc: Dict) -> "MetricsRegistry":
        """Rebuild a registry from :meth:`to_json` output (histograms
        keep count/sum/min/max — the reservoir, hence percentiles, is
        not serialized). Types round-trip by JSON representation:
        gauges always serialize as floats (``3.0``) and counters as
        ints when integral (``3``), so an integral-valued gauge still
        rebuilds as a Gauge and merges cleanly with a live registry.
        The one ambiguity left: a counter incremented by FRACTIONAL
        amounts rebuilds as a Gauge — keep fractional series on
        histograms/gauges (every built-in series does)."""
        reg = MetricsRegistry()
        for name, v in doc.items():
            if isinstance(v, dict):
                h = reg.histogram(name)
                h.count = int(v.get("count", 0))
                h.sum = float(v.get("sum", 0.0))
                h.min = float(v.get("min", float("inf")))
                h.max = float(v.get("max", float("-inf")))
            elif isinstance(v, float):
                reg.gauge(name).set(v)
            else:
                reg.counter(name).inc(v)
        return reg


_REGISTRY = MetricsRegistry()


def metrics_registry() -> MetricsRegistry:
    return _REGISTRY


# --------------------------------------------------- step-loop throughput
class EpochThroughput:
    """Per-epoch counters of a fit/eval step loop: steps dispatched, time
    blocked on host input, prefetch queue depth and dispatch-ahead depth.
    ``finish()`` renders one JSON-able record (the reference's
    ``fit_profile`` epoch schema), and every sample is mirrored into the
    registry's ``fit.*`` series (``eval.*`` under ``prefix="eval"``).
    """

    def __init__(self, prefix: str = "fit"):
        self.steps = 0
        self.input_wait_s = 0.0
        self.depth_hist: Dict[int, int] = {}
        self._inflight_sum = 0
        self._inflight_obs = 0
        self.input_bytes = 0
        self._t0 = time.perf_counter()
        self.prefix = prefix  # registry series + trace span name prefix
        r = _REGISTRY
        self._m_wait = r.histogram(f"{prefix}.input_wait_s")
        self._m_depth = r.histogram(f"{prefix}.queue_depth")
        self._m_inflight = r.histogram(f"{prefix}.inflight_steps")
        self._m_steps = r.counter(f"{prefix}.steps")
        self._m_bytes = r.counter(f"{prefix}.input_bytes")

    def record_wait(self, seconds: float) -> None:
        """Time the loop spent blocked on host batch assembly or copy."""
        self.input_wait_s += seconds
        self._m_wait.observe(seconds)

    def record_depth(self, depth: int) -> None:
        """Prefetch queue depth sampled at each batch request."""
        self.depth_hist[depth] = self.depth_hist.get(depth, 0) + 1
        self._m_depth.observe(depth)

    def record_inflight(self, n: int) -> None:
        """Dispatch-ahead window size observed when a step was issued."""
        self._inflight_sum += n
        self._inflight_obs += 1
        self._m_inflight.observe(n)

    def record_steps(self, n: int, nbytes: int = 0) -> None:
        self.steps += n
        self.input_bytes += nbytes
        self._m_steps.inc(n)
        self._m_bytes.inc(nbytes)

    def record_tokens(self, valid: int, total: int) -> None:
        """``valid`` real tokens out of ``total`` dispatched; ``finish()``
        adds the padded-token fraction only when this was recorded."""
        v, t = getattr(self, "_tokens", (0, 0))
        self._tokens = (v + int(valid), t + int(total))
        _REGISTRY.counter(f"{self.prefix}.valid_tokens").inc(int(valid))
        _REGISTRY.counter(f"{self.prefix}.total_tokens").inc(int(total))

    def finish(self) -> Dict:
        wall = time.perf_counter() - self._t0
        occ = (self._inflight_sum / self._inflight_obs
               if self._inflight_obs else 0.0)
        if wall > 0:
            _REGISTRY.gauge(f"{self.prefix}.steps_per_s").set(
                round(self.steps / wall, 3))
        rec = {
            "steps": self.steps,
            "wall_s": round(wall, 6),
            "steps_per_s": round(self.steps / wall, 3) if wall > 0 else 0.0,
            "input_wait_s": round(self.input_wait_s, 6),
            "input_mb_per_s": round(
                self.input_bytes / wall / 2**20, 3) if wall > 0 else 0.0,
            "queue_depth_hist": dict(sorted(self.depth_hist.items())),
            "dispatch_ahead_occupancy": round(occ, 3),
        }
        tokens = getattr(self, "_tokens", None)
        if tokens is not None:
            rec["tokens"] = tokens[0]
            rec["padded_token_fraction"] = round(
                1.0 - tokens[0] / max(1, tokens[1]), 6)
        return rec


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "EpochThroughput",
    "metrics_registry", "nearest_rank_percentile",
]
