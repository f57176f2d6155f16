"""Span tracer: ring-buffered Chrome/Perfetto trace-event recording.

PyTorch counterpart of ``flexflow_tpu/obs/trace.py`` (pure Python):

* nearly free when off: :func:`span` is one attribute read returning a
  shared no-op context manager, with no allocation and no lock;
* thread-safe: serving workers record concurrently into a bounded
  ``deque`` (the ring bound keeps an always-on tracer safe in a
  long-lived server);
* :meth:`Tracer.export` writes Chrome trace-event JSON (the
  ``{"traceEvents": [...]}`` form) that ``chrome://tracing`` and Perfetto
  load: spans are complete ("X") events with microsecond ``ts``/``dur``,
  markers instant ("i") events.

It covers the host side that ``torch.profiler`` does not see (batcher
queues, request span trees). One process-wide tracer (:func:`tracer`);
``FFConfig.trace="on"`` arms it at ``compile()``/``fit()``/``eval()``
(:func:`configure_tracer`).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional

# virtual thread-id base for the per-request serving span trees: each
# request renders on its own track, so request spans never partially
# overlap real threads' spans (serving/engine.py)
VIRTUAL_TID_BASE = 1 << 20


class _NoopSpan:
    """Shared do-nothing context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    """A live span: records one complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: Dict):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()  # concurrency: race-ok (a span object lives in one `with` block of one thread; the roles share the class, never an instance)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer.complete(self._name, self._t0, t1 - self._t0,
                              cat=self._cat, args=self._args or None)
        return False


class Tracer:
    """Thread-safe ring buffer of Chrome trace events.

    ``capacity`` bounds memory for always-on recording; the oldest
    events fall off first (flight-recorder semantics — the recent
    window is what a post-mortem needs).
    """

    def __init__(self, enabled: bool = False, capacity: int = 65536):
        self.enabled = bool(enabled)
        # process label stamped into the export's metadata; set by
        # export(label=...) or directly
        self.label: Optional[str] = None
        self._events: collections.deque = collections.deque(maxlen=capacity)
        # the two clocks are read back to back so the wall-clock anchor
        # corresponds to ts == 0: merged cross-process traces realign on
        # anchor + ts/1e6 (perf_counter epochs are per-process arbitrary)
        self._epoch = time.perf_counter()
        self._anchor_unix = time.time()
        self._pid = os.getpid()
        self._lock = threading.Lock()  # export/clear vs concurrent append

    # ------------------------------------------------------------- recording
    def now(self) -> float:
        """The tracer's clock (``time.perf_counter`` seconds); pass the
        values to :meth:`complete` for spans timed outside a ``with``."""
        return time.perf_counter()

    def span(self, name: str, cat: str = "", **args):
        """Context manager timing a code region into one "X" event.
        Returns the shared no-op when disabled — the fast path."""
        if not self.enabled:
            return _NOOP
        return _Span(self, name, cat, args)

    def complete(self, name: str, t0: float, dur_s: float, cat: str = "",
                 tid: Optional[int] = None,
                 args: Optional[Dict] = None) -> None:
        """Record a complete ("X") event from explicit timestamps
        (``t0`` from :meth:`now`, duration in seconds). ``tid``
        overrides the recording thread's id — serving uses virtual
        per-request tracks (``VIRTUAL_TID_BASE``)."""
        if not self.enabled:
            return
        ev = {
            "name": name,
            "ph": "X",
            "ts": round((t0 - self._epoch) * 1e6, 3),
            "dur": round(max(0.0, dur_s) * 1e6, 3),
            "pid": self._pid,
            "tid": threading.get_ident() if tid is None else tid,
        }
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = dict(args)
        self._events.append(ev)

    def instant(self, name: str, cat: str = "", **args) -> None:
        """Record an instant ("i") marker (cache hit, recompile fire)."""
        if not self.enabled:
            return
        ev = {
            "name": name,
            "ph": "i",
            "s": "t",  # thread-scoped marker
            "ts": round((time.perf_counter() - self._epoch) * 1e6, 3),
            "pid": self._pid,
            "tid": threading.get_ident(),
        }
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = dict(args)
        self._events.append(ev)

    # --------------------------------------------------------------- reading
    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def event_count(self) -> int:
        return len(self._events)

    def counts_by_cat(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.events():
            c = ev.get("cat", "")
            out[c] = out.get(c, 0) + 1
        return out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def export_metadata(self) -> Dict:
        """Cross-process merge anchor: ``ts`` values are microseconds
        since a per-process ``perf_counter`` epoch, so traces from two
        processes misalign unless each export says WHEN its epoch was
        (wall clock) and WHOSE it is (process label). A merger shifts
        every event by ``(anchor_a - anchor_b) * 1e6`` to co-plot."""
        import platform

        md = {
            "wall_clock_anchor_unix_s": round(self._anchor_unix, 6),
            "process": f"{platform.node() or 'host'}:{self._pid}",
            "pid": self._pid,
            "clock": "us_since_process_epoch",
        }
        if self.label:
            md["label"] = self.label
        return md

    def export(self, path: str, label: Optional[str] = None) -> int:
        """Write the buffer as Chrome trace-event JSON (with the
        cross-process ``metadata`` anchor); returns the event count
        written. ``label`` names this process's lane when traces of
        several processes are merged."""
        if label is not None:
            self.label = str(label)
        evs = self.events()
        with open(path, "w") as f:
            json.dump({"traceEvents": evs, "displayTimeUnit": "ms",
                       "metadata": self.export_metadata()}, f)
        return len(evs)


# ------------------------------------------------------------ global tracer
_TRACER = Tracer(enabled=False)


def tracer() -> Tracer:
    return _TRACER


def trace_enabled() -> bool:
    return _TRACER.enabled


def span(name: str, cat: str = "", **args):
    """Module-level convenience over the global tracer's :meth:`span`."""
    if not _TRACER.enabled:
        return _NOOP
    return _Span(_TRACER, name, cat, args)


def configure_tracer(config=None, enabled: Optional[bool] = None) -> Tracer:
    """Apply ``config.trace`` ("on"/"off"; anything else raises) or an
    explicit ``enabled`` to the global tracer. ``compile()``, ``fit()``
    and ``eval()`` call it, so whichever runs first arms the recorder.

    An explicit ``enabled`` wins in BOTH directions (a tool or test can
    disarm). The config path only ever ratchets ON: a second model whose
    config left trace at the "off" default must not silently disable the
    recorder an opted-in model armed earlier in the same process."""
    if enabled is not None:
        _TRACER.enabled = bool(enabled)  # concurrency: race-ok (bool flip read racily by design: a worker missing one event at arm time is flight-recorder semantics)
        return _TRACER
    if config is not None:
        mode = getattr(config, "trace", "off") or "off"
        if mode not in ("on", "off"):
            raise ValueError(f"trace={mode!r}: expected 'on' or 'off'")
        if mode == "on":
            _TRACER.enabled = True  # concurrency: race-ok (bool flip, see above)
    return _TRACER


# ----------------------------------------------------------------- validate
def validate_chrome_trace(payload) -> List[str]:
    """Schema check of a trace payload: returns
    a list of problems (empty = valid). Checks the object form, the
    required per-event fields, and that "X" spans properly NEST per
    (pid, tid) track (no partial overlap — the invariant Perfetto's
    slice tracks rely on)."""
    problems: List[str] = []
    if not isinstance(payload, dict) or "traceEvents" not in payload:
        return ["payload is not a {'traceEvents': [...]} object"]
    events = payload["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    # exported traces carry the cross-process merge anchor; when the
    # payload claims one ("metadata" present — every Tracer.export
    # does), it must be usable: a numeric wall-clock anchor + a process
    # label (in-memory event lists under test carry no metadata block)
    if "metadata" in payload:
        md = payload["metadata"]
        if not isinstance(md, dict):
            problems.append("metadata is not an object")
        else:
            anchor = md.get("wall_clock_anchor_unix_s")
            if not isinstance(anchor, (int, float)) or anchor <= 0:
                problems.append(
                    "metadata.wall_clock_anchor_unix_s missing or not a "
                    "positive number — cross-process merge cannot align "
                    "this trace")
            if not md.get("process"):
                problems.append(
                    "metadata.process label missing — merged traces "
                    "cannot attribute events to a process")
    tracks: Dict[tuple, List[Dict]] = {}
    for i, ev in enumerate(events):
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                problems.append(f"event {i} missing '{field}': {ev}")
        if ev.get("ph") == "X":
            if "dur" not in ev:
                problems.append(f"span event {i} missing 'dur': {ev}")
            else:
                tracks.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    eps = 0.05  # us; ts/dur are rounded independently — boundary slack
    for (pid, tid), evs in tracks.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[Dict] = []
        for ev in evs:
            end = ev["ts"] + ev["dur"]
            while stack and \
                    ev["ts"] >= stack[-1]["ts"] + stack[-1]["dur"] - eps:
                stack.pop()
            if stack and end > stack[-1]["ts"] + stack[-1]["dur"] + eps:
                problems.append(
                    f"track ({pid},{tid}): span '{ev['name']}' "
                    f"[{ev['ts']},{end}] partially overlaps "
                    f"'{stack[-1]['name']}'")
            stack.append(ev)
    return problems
