"""Stall watchdog: liveness of last resort, with black-box dumps.

PyTorch counterpart of ``flexflow_tpu/obs/watchdog.py``. An opt-in
daemon thread (``config.watchdog="on"``, ``--watchdog``) is fed
heartbeats by the fit/eval loops, the Prefetcher worker and the serving
workers. A watched section (:func:`watch`) brackets work that must make
progress; :func:`beat` refreshes its timestamp inside it. A source silent
past ``config.watchdog_threshold_s`` makes the monitor write a black-box
dump to ``.ffcache/obs/blackbox/``: every thread's stack, the tracer
ring's tail, the metrics snapshot and the last ledger record. Arming also
points :mod:`faulthandler` at that directory, so a fatal signal leaves
all-thread stacks there too; disarming hands faulthandler back as it was.

``_watched``, ``_dumped`` and ``_dumps`` are guarded by one Condition;
the dump's file I/O runs outside it. ``enabled`` is a lock-free flag, so
the disarmed path costs one attribute read a call.
"""

from __future__ import annotations

import faulthandler
import json
import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

BLACKBOX_SCHEMA = 1
DEFAULT_DIR = os.path.join(".ffcache", "obs", "blackbox")
DEFAULT_THRESHOLD_S = 60.0
# dumps per process cap: a persistent stall re-fires once per source,
# and a pathological source churn must not fill the disk
MAX_DUMPS = 8

# events included from the tracer ring (the RECENT window is the
# post-mortem's interesting part; the full ring can be 64k events)
_TRACE_TAIL = 512


class _NullSection:
    """Shared no-op context manager: the disarmed fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSection()


class _WatchSection:
    __slots__ = ("_wd", "_name")

    def __init__(self, wd: "Watchdog", name: str):
        self._wd = wd
        self._name = name

    def __enter__(self):
        self._wd._enter(self._name)
        return self

    def __exit__(self, *exc):
        self._wd._exit(self._name)
        return False


class Watchdog:
    """Heartbeat monitor + black-box writer. One process-wide instance
    (:func:`watchdog`); tests construct their own with tight timings."""

    def __init__(self, threshold_s: float = DEFAULT_THRESHOLD_S,
                 poll_s: Optional[float] = None,
                 dump_dir: str = DEFAULT_DIR,
                 max_dumps: int = MAX_DUMPS):
        self.enabled = False
        self._threshold = float(threshold_s)
        self._poll = float(poll_s) if poll_s else max(
            0.05, self._threshold / 4.0)
        self._dir = dump_dir
        self._max_dumps = int(max_dumps)
        self._cv = threading.Condition()
        self._watched: Dict[str, float] = {}  # source -> last beat (monotonic)
        self._dumped: set = set()  # sources already reported this stall
        self._dumps = 0            # dumps written this process
        self._seen: set = set()    # every source ever watched (report)
        self._thread: Optional[threading.Thread] = None
        self._fatal_file = None
        self._fatal_was_enabled = False

    # ------------------------------------------------------------ lifecycle
    def arm(self, threshold_s: Optional[float] = None,
            dump_dir: Optional[str] = None) -> "Watchdog":
        """Start (or retune) the monitor; idempotent."""
        with self._cv:
            if threshold_s is not None:
                self._threshold = float(threshold_s)
                self._poll = max(0.05, self._threshold / 4.0)
            if dump_dir:
                self._dir = dump_dir
            dirpath = self._dir
            # thread creation decided AND recorded under the lock: two
            # concurrent arm() calls must not both observe "no monitor"
            # and spawn duplicate ff-watchdog threads. A created-but-
            # not-yet-started thread has ident None and is_alive False —
            # it counts as the monitor (its creator starts it below).
            cur = self._thread
            t = None
            if cur is None or (cur.ident is not None
                               and not cur.is_alive()):
                t = threading.Thread(target=self._run, daemon=True,
                                     name="ff-watchdog")
                self._thread = t
            # wake a running monitor out of its OLD poll wait so a
            # retune (e.g. a much tighter threshold) takes effect now,
            # not at the end of the previous interval
            self._cv.notify_all()
        # lock-free flag flip: a worker missing one beat at arm time only
        # delays detection a tick
        self.enabled = True  # concurrency: race-ok (lock-free flag flip, the tracer's enabled pattern: a worker missing one beat at arm time only delays detection a tick)
        if t is not None:
            self._enable_faulthandler(dirpath)
            t.start()
        return self

    def disarm(self) -> None:
        """Stop the monitor and join it; watched sources are kept (the
        next :meth:`arm` resumes them)."""
        self.enabled = False  # concurrency: race-ok (lock-free flag flip, see arm)
        with self._cv:
            t = self._thread
            self._cv.notify_all()
        # a created-but-unstarted thread (a racing arm() between lock
        # release and start()) cannot be joined; its run loop exits on
        # the enabled flag the moment the creator starts it, and the
        # dead-thread check in arm() reclaims the slot
        if t is not None and t.ident is not None:
            t.join(timeout=10)
        with self._cv:
            # only null the slot for a thread that actually exited: a
            # monitor stuck past the join timeout (e.g. a slow dump
            # write) must keep the slot, or the next arm() would spawn
            # a duplicate next to the survivor
            if self._thread is t and t is not None \
                    and t.ident is not None and not t.is_alive():
                self._thread = None
        if self._fatal_file is not None:
            try:
                faulthandler.disable()
                self._fatal_file.close()
                if self._fatal_was_enabled:
                    # the handler that was there before arming (pytest's,
                    # a user's) gets stderr back
                    faulthandler.enable(sys.__stderr__, all_threads=True)
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
            self._fatal_file = None

    def _enable_faulthandler(self, dirpath: str) -> None:
        """Fatal-signal black box: SIGSEGV/SIGFPE/SIGABRT/SIGBUS dump
        every thread's stack into the blackbox dir (the interpreter is
        dying — JSON is off the table, faulthandler's text is not)."""
        try:
            os.makedirs(dirpath, exist_ok=True)
            self._fatal_was_enabled = faulthandler.is_enabled()
            self._fatal_file = open(
                os.path.join(dirpath, f"fatal-{os.getpid()}.log"), "w")
            faulthandler.enable(self._fatal_file, all_threads=True)
        except Exception:  # noqa: BLE001 — a RO filesystem must not
            self._fatal_file = None  # block arming the stall monitor

    # ----------------------------------------------------------- heartbeats
    def _enter(self, name: str) -> None:
        with self._cv:
            self._watched[name] = time.monotonic()
            self._dumped.discard(name)
            self._seen.add(name)

    def _exit(self, name: str) -> None:
        with self._cv:
            self._watched.pop(name, None)
            self._dumped.discard(name)

    def watch(self, name: str):
        """Context manager bracketing work that must make progress;
        entry counts as a beat, exit stops the watch (idle waiting —
        an empty serving queue, a full prefetch buffer — is NOT
        watched)."""
        return _WatchSection(self, name)

    def beat(self, name: str) -> None:
        """Refresh a watched source's timestamp (no-op for sources not
        inside a :meth:`watch` section)."""
        with self._cv:
            if name in self._watched:
                self._watched[name] = time.monotonic()
                self._dumped.discard(name)

    # -------------------------------------------------------------- monitor
    def _run(self) -> None:
        while self.enabled:
            with self._cv:
                self._cv.wait(self._poll)
                now = time.monotonic()
                stalled = {name: round(now - t, 3)
                           for name, t in self._watched.items()
                           if now - t > self._threshold
                           and name not in self._dumped}
                self._dumped.update(stalled)
            if stalled:
                self.dump("stall", stalled)

    # ----------------------------------------------------------- black box
    def dump(self, reason: str, stalled: Optional[Dict] = None) -> Optional[str]:
        """Write one black-box JSON dump; returns its path (None when
        the per-process cap is hit or the write failed)."""
        with self._cv:
            if self._dumps >= self._max_dumps:
                return None
            self._dumps += 1
            n = self._dumps
            threshold = self._threshold
            dirpath = self._dir
            watched = {k: round(time.monotonic() - t, 3)
                       for k, t in self._watched.items()}
        doc = {
            "schema": BLACKBOX_SCHEMA,  # knobflow: schema-ok (black-box dumps are post-mortem artifacts for a person; no reader in the port parses them — the supervisor only lists their file names)
            "reason": reason,
            "ts_unix_s": round(time.time(), 3),
            "pid": os.getpid(),
            "threshold_s": threshold,
            "stalled": dict(stalled or {}),
            "watched_age_s": watched,
            "threads": self._thread_stacks(),
        }
        try:
            from .metrics import metrics_registry
            from .trace import tracer

            doc["metrics"] = metrics_registry().to_json()
            doc["trace_tail"] = tracer().events()[-_TRACE_TAIL:]
            metrics_registry().counter("watchdog.dumps").inc()
        except Exception as e:  # noqa: BLE001 — a half dump beats none
            doc["recorder_error"] = f"{type(e).__name__}: {e}"
        try:
            from .ledger import last_record

            doc["last_ledger_record"] = last_record()
        except Exception as e:  # noqa: BLE001 — a half dump beats none
            doc["ledger_error"] = f"{type(e).__name__}: {e}"
        path = os.path.join(dirpath, f"blackbox-{os.getpid()}-{n}.json")
        try:
            os.makedirs(dirpath, exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f, default=str)
        except Exception as e:  # noqa: BLE001 — never crash the monitor
            print(f"[watchdog] black-box write failed: {e}",
                  file=sys.stderr, flush=True)
            return None
        print(f"[watchdog] {reason}: "
              f"{sorted((stalled or {}).items()) or 'manual'} — "
              f"black box written to {path}", file=sys.stderr, flush=True)
        return path

    @staticmethod
    def _thread_stacks() -> Dict[str, list]:
        names = {t.ident: t.name for t in threading.enumerate()}
        out = {}
        for tid, frame in sys._current_frames().items():
            label = f"{names.get(tid, 'thread')}-{tid}"
            out[label] = [ln.rstrip("\n")
                          for ln in traceback.format_stack(frame)]
        return out

    # -------------------------------------------------------------- reading
    def stats(self) -> Dict:
        with self._cv:
            now = time.monotonic()
            return {
                "enabled": self.enabled,
                "threshold_s": self._threshold,
                "dump_dir": self._dir,
                "watched": sorted(self._watched),
                # seconds since each live source's last beat — the obs
                # server's /healthz liveness signal (age near the
                # threshold = a stall about to dump)
                "watched_age_s": {k: round(now - t, 3)
                                  for k, t in sorted(
                                      self._watched.items())},
                "sources_seen": sorted(self._seen),
                "dumps": self._dumps,
            }


# ------------------------------------------------------------ global state
_WATCHDOG = Watchdog()


def watchdog() -> Watchdog:
    return _WATCHDOG


def watchdog_mode(config) -> str:
    """The validated ``config.watchdog`` mode (typo fails at fit/compile
    entry, the mode-knob convention)."""
    mode = getattr(config, "watchdog", "off") or "off"
    if mode not in ("on", "off"):
        raise ValueError(f"watchdog={mode!r}: expected 'on' or 'off'")
    return mode


def configure_watchdog(config=None, enabled: Optional[bool] = None) -> Watchdog:
    """Apply ``config.watchdog`` (or an explicit ``enabled``, which wins
    in both directions) to the process watchdog. The config path only
    ratchets ON — a later model whose config left the knob at "off"
    must not disarm a monitor an opted-in model armed (the tracer's
    contract)."""
    if enabled is not None:
        if enabled:
            _WATCHDOG.arm()
        else:
            _WATCHDOG.disarm()
        return _WATCHDOG
    if config is not None and watchdog_mode(config) == "on":
        _WATCHDOG.arm(
            threshold_s=float(getattr(config, "watchdog_threshold_s",
                                      DEFAULT_THRESHOLD_S)
                              or DEFAULT_THRESHOLD_S),
            dump_dir=getattr(config, "watchdog_dir", None) or DEFAULT_DIR)
    return _WATCHDOG


def watch(name: str):
    """Module-level fast path: a shared no-op section while disarmed
    (one attribute read), a real watched section once armed."""
    wd = _WATCHDOG
    if not wd.enabled:
        return _NULL
    return wd.watch(name)


def beat(name: str) -> None:
    """Module-level heartbeat: ~free while disarmed."""
    wd = _WATCHDOG
    if wd.enabled:
        wd.beat(name)


def list_dumps(dirpath: Optional[str] = None) -> List[str]:
    """Sorted black-box dump paths under ``dirpath`` (default
    :data:`DEFAULT_DIR`); the supervisor (``parallel/launch.py``)
    attaches these to a hung peer's diagnosis."""
    dirpath = dirpath or DEFAULT_DIR
    try:
        names = sorted(n for n in os.listdir(dirpath)
                       if n.startswith("blackbox-"))
    except OSError:
        return []
    return [os.path.join(dirpath, n) for n in names]


__all__ = [
    "BLACKBOX_SCHEMA", "Watchdog", "beat", "configure_watchdog",
    "list_dumps", "watch", "watchdog", "watchdog_mode",
]
