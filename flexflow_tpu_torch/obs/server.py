"""Zero-dependency observability HTTP server: the live scrape surface.

PyTorch counterpart of ``flexflow_tpu/obs/server.py``, the same
endpoints and JSON bodies, from the standard library alone:

=================  ====================================================
``/metrics``       Prometheus text of the process registry
``/healthz``       JSON liveness: pid, the watchdog's arm state and each
                   source's heartbeat age, dump count
``/runs``          the run ledger's tail as JSON (``?n=``, default 20)
``/trace``         the tracer ring as a Chrome trace-event JSON
``/attribution``   the latest attribution report (``?kind=serving`` for
                   the serving phase table); 404 until one exists
``/advice``        the latest perf-advisor report; 404 until one exists
``/cohort``        the latest cohort report; 404 until one exists
=================  ====================================================

One background thread (``ff-obs-server``) runs the accept loop; the
handlers only read thread-safe surfaces. ``config.obs_server_port`` is
None (default: no socket, no thread) or a port (``0`` = any free port,
read from ``ObsServer.port``). The config path only ratchets on.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

from .metrics import metrics_registry

DEFAULT_RUNS_TAIL = 20

# latest reports published by the fit/serving hooks + the ledger dir
# the configuring model resolved (a --ledger-dir override must be the
# directory /runs scrapes, not the env/default fallback); one lock
# guards every slot (written by whichever thread runs fit/compile or
# the serving scheduler, read by handler threads). Attribution keeps
# one slot PER KIND ("fit" and "serving") so a process doing both
# never loses one surface to the other.
_attr_mu = threading.Lock()
_LATEST_ATTRIBUTION: Dict[str, Dict] = {}
_LATEST_ADVICE: Optional[Dict] = None
_LATEST_COHORT: Optional[Dict] = None
_LEDGER_DIR: Optional[str] = None


def publish_attribution(report: Dict, kind: Optional[str] = None) -> None:
    """Make an attribution report visible on ``/attribution``. ``kind``
    defaults to the report's own ``kind`` field ("fit" when absent —
    the historical fit-report contract); continuous-batching serving
    sessions publish under ``"serving"``."""
    k = kind or report.get("kind") or "fit"
    with _attr_mu:
        _LATEST_ATTRIBUTION[k] = dict(report)


def latest_attribution(kind: Optional[str] = None) -> Optional[Dict]:
    """The latest attribution report: an explicit ``kind``'s slot, or —
    unqualified — the fit report when one exists, else the serving
    report (so serving-only processes stop 404ing)."""
    with _attr_mu:
        if kind is not None:
            rec = _LATEST_ATTRIBUTION.get(kind)
        else:
            rec = (_LATEST_ATTRIBUTION.get("fit")
                   or _LATEST_ATTRIBUTION.get("serving"))
        return dict(rec) if rec is not None else None


def publish_advice(report: Dict) -> None:
    """Make the newest advisor report visible on ``/advice``."""
    global _LATEST_ADVICE
    with _attr_mu:
        _LATEST_ADVICE = dict(report)


def latest_advice() -> Optional[Dict]:
    with _attr_mu:
        return dict(_LATEST_ADVICE) if _LATEST_ADVICE is not None else None


def publish_cohort(report: Dict) -> None:
    """Make the newest cohort report visible on ``/cohort``
    (obs/cohort.build_cohort_report calls this)."""
    global _LATEST_COHORT
    with _attr_mu:
        _LATEST_COHORT = dict(report)


def latest_cohort() -> Optional[Dict]:
    with _attr_mu:
        return dict(_LATEST_COHORT) if _LATEST_COHORT is not None else None


def _publish_ledger_dir(dirpath: Optional[str]) -> None:
    global _LEDGER_DIR
    with _attr_mu:
        _LEDGER_DIR = dirpath


def _served_ledger_dir() -> Optional[str]:
    with _attr_mu:
        return _LEDGER_DIR


# ----------------------------------------------------------- the handler
class _Handler(BaseHTTPRequestHandler):
    # the stdlib logs every request to stderr by default — route the
    # signal to the metrics registry instead of polluting training logs
    def log_message(self, fmt, *args):  # noqa: D102 — stdlib override
        pass

    def _send(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, doc, status: int = 200) -> None:
        self._send(status, json.dumps(doc, sort_keys=True,
                                      default=str).encode(),
                   "application/json")

    def do_GET(self):  # noqa: N802 — stdlib contract
        reg = metrics_registry()
        reg.counter("obs_server.requests").inc()
        url = urlparse(self.path)
        try:
            if url.path == "/metrics":
                self._send(200, reg.to_prometheus().encode(),
                           "text/plain; version=0.0.4")
            elif url.path == "/healthz":
                self._send_json(_healthz())
            elif url.path == "/runs":
                q = parse_qs(url.query)
                try:
                    n = int(q.get("n", [DEFAULT_RUNS_TAIL])[0])
                except (TypeError, ValueError):
                    n = DEFAULT_RUNS_TAIL
                self._send_json(_runs_tail(max(1, n)))
            elif url.path == "/trace":
                from .trace import tracer

                tr = tracer()
                self._send_json({"traceEvents": tr.events(),
                                 "displayTimeUnit": "ms",
                                 "metadata": tr.export_metadata()})
            elif url.path == "/attribution":
                q = parse_qs(url.query)
                kind = (q.get("kind") or [None])[0]
                rec = latest_attribution(kind)
                if rec is None:
                    self._send_json(
                        {"unavailable": "no attribution report yet — "
                         "run a fit with config.attribution='on' or a "
                         "continuous-batching serving session"},
                        status=404)
                else:
                    self._send_json(rec)
            elif url.path == "/advice":
                rec = latest_advice()
                if rec is None:
                    self._send_json(
                        {"unavailable": "no advisor report yet — run a "
                         "fit with config.advisor='on' or a serving "
                         "session"},
                        status=404)
                else:
                    self._send_json(rec)
            elif url.path == "/cohort":
                rec = latest_cohort()
                if rec is None:
                    self._send_json(
                        {"unavailable": "no cohort report yet — run "
                         "ranks with config.cohort_obs='on' under the "
                         "supervisor's --cohort-obs"},
                        status=404)
                else:
                    self._send_json(rec)
            else:
                self._send_json(
                    {"error": f"unknown path {url.path!r}",
                     "endpoints": ["/metrics", "/healthz", "/runs",
                                   "/trace", "/attribution", "/advice",
                                   "/cohort"]},
                    status=404)
        except Exception as e:  # noqa: BLE001 — a bad scrape must not
            reg.counter("obs_server.errors").inc()  # kill the server
            try:
                self._send_json(
                    {"error": f"{type(e).__name__}: {e}"}, status=500)
            except Exception:  # noqa: BLE001 — client already gone
                pass


def _healthz() -> Dict:
    import os

    from .metrics import metrics_registry
    from .watchdog import watchdog

    wd = watchdog().stats()
    doc = {
        "ok": wd["dumps"] == 0,
        "pid": os.getpid(),
        "watchdog": wd,
    }
    # continuous-batching serving snapshot, when the process serves
    # generation (gauges exist once a scheduler has run): throughput +
    # paged-pool occupancy — the SLO scrape ROADMAP item 1 names
    reg = metrics_registry()
    serving = {}
    for key, metric in (("tokens_per_s", "serving.tokens_per_s"),
                        ("kv_blocks_in_use", "serving.kv_blocks_in_use")):
        m = reg.get(metric)
        if m is not None:
            serving[key] = m.to_json()
    if serving:
        doc["serving"] = serving
    return doc


def _runs_tail(n: int) -> Dict:
    from .ledger import ledger_dir, scan_ledger

    # the directory the CONFIGURING model writes to (configure_obs_server
    # published it), falling back to the env/default resolution for a
    # server started without a config
    d = _served_ledger_dir() or ledger_dir()
    scan = scan_ledger(d)
    return {
        "dir": d,
        "files": scan["files"],
        "total_runs": len(scan["runs"]),
        "corrupt_lines": scan["corrupt_lines"],
        "runs": scan["runs"][-n:],
    }


def _make_httpd(host: str, port: int) -> ThreadingHTTPServer:
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.daemon_threads = True  # per-request threads die with us
    return httpd


# ------------------------------------------------------------- the server
class ObsServer:
    """One background accept loop serving the endpoints above. Tests
    construct their own on port 0; the process-wide instance comes from
    :func:`configure_obs_server`."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._host = host
        self._requested_port = int(port)
        self._mu = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._port: Optional[int] = None

    @property
    def port(self) -> Optional[int]:
        """The bound port (None until :meth:`start`)."""
        with self._mu:
            return self._port

    @property
    def url(self) -> Optional[str]:
        with self._mu:
            if self._port is None:
                return None
            return f"http://{self._host}:{self._port}"

    def running(self) -> bool:
        with self._mu:
            return self._thread is not None and self._thread.is_alive()

    def start(self) -> int:
        """Bind + serve in the background; idempotent. Returns the
        bound port."""
        with self._mu:
            # a created-but-not-yet-started thread (ident None) counts
            # as the server: its creator starts it below — two racing
            # start() calls must not bind two sockets (watchdog.arm's
            # duplicate-monitor discipline)
            cur = self._thread
            if cur is not None and (cur.ident is None
                                    or cur.is_alive()):
                return self._port
            httpd = _make_httpd(self._host, self._requested_port)
            self._httpd = httpd
            self._port = int(httpd.server_address[1])
            t = threading.Thread(target=httpd.serve_forever,
                                 name="ff-obs-server", daemon=True)
            self._thread = t
            port = self._port
        t.start()
        metrics_registry().gauge("obs_server.port").set(float(port))
        return port

    def stop(self) -> None:
        """Shut the accept loop down and join the thread; the socket
        teardown and join run OUTSIDE the lock (they block)."""
        with self._mu:
            httpd = self._httpd
            t = self._thread
            self._httpd = None
            self._thread = None
            self._port = None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if t is not None:
            t.join(timeout=10)


# -------------------------------------------------------- process server
_server_mu = threading.Lock()
_SERVER: Optional[ObsServer] = None


def obs_server() -> Optional[ObsServer]:
    """The process-wide server, or None when never configured."""
    with _server_mu:
        return _SERVER


def server_port_knob(config) -> Optional[int]:
    """The validated ``config.obs_server_port`` (None = off; 0 =
    ephemeral; a non-int or negative value fails loudly at
    compile/fit entry, the mode-knob convention)."""
    port = getattr(config, "obs_server_port", None)
    if port is None:
        return None
    try:
        port = int(port)
    except (TypeError, ValueError):
        raise ValueError(
            f"obs_server_port={port!r}: expected None or an int >= 0")
    if port < 0 or port > 65535:
        raise ValueError(
            f"obs_server_port={port}: expected 0 (ephemeral) or a "
            f"valid TCP port")
    return port


def configure_obs_server(config=None,
                         port: Optional[int] = None) -> Optional[ObsServer]:
    """Apply ``config.obs_server_port`` (or an explicit ``port``) to
    the process server. The config path only ratchets ON — a later
    model whose config left the knob unset must not tear down a
    surface an opted-in model started (the tracer/watchdog contract).
    The FIRST configuration binds the socket; a later call asking for
    a *different* port keeps the running server (one scrape surface
    per process) and says so loudly — read ``obs_server().port`` for
    the port actually bound."""
    global _SERVER
    if port is None:
        if config is None:
            return obs_server()
        port = server_port_knob(config)
        if port is None:
            return obs_server()
    with _server_mu:
        srv = _SERVER
        if srv is None:
            srv = _SERVER = ObsServer(port=port)
    bound = srv.start()
    if port not in (0, bound) and srv._requested_port != port:
        import sys

        print(f"[obs-server] already serving on port {bound}; "
              f"ignoring the later request for port {port} (one "
              f"scrape surface per process — stop_obs_server() first "
              f"to rebind)", file=sys.stderr, flush=True)
        metrics_registry().counter("obs_server.port_conflicts").inc()
    if config is not None:
        from .ledger import ledger_dir

        _publish_ledger_dir(ledger_dir(config))
    return srv


def stop_obs_server() -> None:
    """Tear the process server down (tests + explicit shutdown only —
    nothing in the workload path calls this)."""
    global _SERVER
    with _server_mu:
        srv = _SERVER
        _SERVER = None
    if srv is not None:
        srv.stop()


__all__ = [
    "DEFAULT_RUNS_TAIL", "ObsServer", "configure_obs_server",
    "latest_advice", "latest_attribution", "latest_cohort", "obs_server",
    "publish_advice", "publish_attribution", "publish_cohort",
    "server_port_knob", "stop_obs_server",
]
