"""Elastic multi-process launcher: spawn, supervise and heal a cohort of
ranks training one model, resuming from its sharded checkpoints.

PyTorch counterpart of the JAX package's ``tools/mh_launch.py``; run it as
``python -m flexflow_tpu_torch.parallel.launch``.

* **worker** (``--worker``, spawned once a rank): :func:`~flexflow_tpu_torch.parallel.multihost.elastic_init`
  (the rendezvous at the supervisor's ``tcp://127.0.0.1:<port>``, bounded
  and retried, the ``multihost.init_timeout`` site inside), the capability
  probe, then the job: ``--job module:function`` builds and compiles a
  model over the cohort (by default a small MLP on ``{"data": nproc}``)
  and ``fit`` runs with ``resume_from`` and checkpoints every
  ``--interval`` steps (``MultiHostCheckpointManager``: each rank's shard,
  rank 0's manifest). A heartbeat file (the iteration and when it last
  moved) is the supervisor's evidence of life; the result (the params'
  digest, the epochs' metrics, the checkpoint counters) is written as
  ``result-<rank>.json`` and rank 0 writes the whole params.
* **supervisor** (the default): launches the cohort and watches for a
  dead peer (a non-zero exit: the ``multihost.peer_kill`` site, a real
  crash) or a hung one (a heartbeat that has not moved for
  ``--hang-threshold`` seconds once it moved twice: the
  ``multihost.slow_peer`` site). Either way it tears the whole cohort down
  and launches it again with the same ``resume_from``; a fault plan is
  armed on the first launch only, so the recovery runs clean.
* **matrix** (``--smoke``): ``baseline``, ``kill_resume`` (a peer killed at
  step 6 resumes equal to the baseline bit for bit), ``shrink_resize`` (one
  process resumes the killed cohort's directory through the counted
  elastic restore) and ``hang_relaunch``; one JSON line, exit 1 on any
  violation.

Usage::

    python -m flexflow_tpu_torch.parallel.launch --nproc 2
    python -m flexflow_tpu_torch.parallel.launch --smoke
    python -m flexflow_tpu_torch.parallel.launch --nproc 2 --fault-rank 1 \\
        --fault-plan '{"schema":1,"sites":{"multihost.peer_kill":{"at_step":6}}}'

A job whose ``FFConfig`` searches through the strategy cache
(``search_budget`` > 0, ``search_cache="on"``) re-searches after a
resize: the cache key covers the ``torch.distributed`` world size
(``search/cache.py``).

Each rank's ledger (``<run-dir>/ledger/rank-<r>``) and cost corpus are
its own directories; after a successful cohort the supervisor folds them
into ``ledger/cohort`` and ``costcorpus/cohort`` (``merge_runs``,
deduplicated by run id: merging twice adds nothing). With
``--watchdog-threshold`` each worker arms the stall watchdog, whose
black-box dumps (``blackbox-r<r>``) the supervisor attaches to a hung
peer's event; with ``--cohort-obs`` the ranks export their traces and
metrics and the supervisor adds the cohort report (merged trace, skew,
straggler, OBS003) and stamps its skew onto the merged fit records.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

KILL_EXIT = 43
EPOCHS = 3          # 64 samples / batch 16 = 4 steps an epoch -> 12 steps
INTERVAL = 2        # a checkpoint every 2 steps
DEFAULT_JOB = "flexflow_tpu_torch.parallel.launch:mlp_job"

# the package's parent: the workers' PYTHONPATH
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# ----------------------------------------------------------------- shared
def _atomic_json(path: str, doc: Dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_json(path: str) -> Optional[Dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _file_barrier(dirpath: str, name: str, rank: int, nproc: int, timeout_s: float) -> bool:
    """Write this rank's marker, wait for every rank's: keeps a cohort in
    rough step after unequal compiles, so the manifest barriers stay
    short."""
    _atomic_json(os.path.join(dirpath, f"{name}-{rank}.json"), {"rank": rank})
    want = [os.path.join(dirpath, f"{name}-{r}.json") for r in range(nproc)]
    deadline = time.monotonic() + timeout_s
    while not all(os.path.exists(p) for p in want):
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.05)
    return True


def params_digest(params: Dict) -> str:
    """The sha256 of a ``numpy_params`` tree's bytes in name order."""
    h = hashlib.sha256()
    for op in sorted(params):
        for w in sorted(params[op]):
            h.update(params[op][w].tobytes())
    return h.hexdigest()


def mlp_job(config: Dict, nproc: int, zero: bool = False):
    """The default job, the JAX launcher's: a 8-16-4 MLP with Adam on
    ``{"data": nproc}`` (ZeRO-1 with ``zero``), 64 samples of a seeded
    linear task, batch 16."""
    import numpy as np

    from ..config import FFConfig
    from ..ffconst import LossType
    from ..models.mlp import build_mlp
    from ..runtime.model import FFModel
    from ..runtime.optimizer import AdamOptimizer

    ff = FFModel(FFConfig(batch_size=16, seed=3, mesh_shape={"data": nproc},
                          zero_optimizer=zero, **config))
    build_mlp(ff, 16, in_dim=8, hidden_dims=(16,), num_classes=4)
    ff.compile(optimizer=AdamOptimizer(alpha=0.01),
               loss_type=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=["sparse_categorical_crossentropy"])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    w = rng.normal(size=(8, 4)).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.int32).reshape(-1, 1)
    return ff, x, y


def _load_job(spec: str) -> Callable:
    mod, _, fn = spec.partition(":")
    return getattr(importlib.import_module(mod), fn)


class _Heartbeat:
    """The worker's liveness file: ``{iteration, armed, progress_unix_s}``
    every ``period_s``. The progress time moves whenever ``(iteration,
    checkpoint barrier polls)`` changes: a rank waiting at the manifest
    barrier for a slow peer is alive, a rank stuck inside a step is not.
    ``armed`` turns true once two steps ran in this process
    (``get_steps``, fit's ``fit.steps`` counter), so neither a resume's
    restored iteration nor the first step's warm-up reads as a hang. The
    JAX package arms on the iteration's moves alone; steps short enough to
    run several between two beats (a small job's foreach updates) would
    then move it once and never arm. An orphaned worker (its supervisor died) exits. The
    loop runs on a thread it owns rather than a ``Thread`` subclass's
    ``run``, a name every ``subprocess.run`` call would also reach in the
    concurrency audit's call graph."""

    def __init__(self, path: str, get_token, get_steps, period_s: float = 0.15):
        self._path, self._get, self._steps, self._period = path, get_token, get_steps, period_s
        self._halt = threading.Event()
        self._ppid0 = os.getppid()
        self._thread = threading.Thread(target=self._beat, name="ff-heartbeat", daemon=True)

    def start(self):
        self._thread.start()

    def _beat(self):
        last, progress = None, time.time()
        steps0 = int(self._steps())
        while not self._halt.is_set():
            if os.getppid() != self._ppid0:
                os._exit(42)
            try:
                tok = tuple(int(v) for v in self._get())
            except Exception:  # noqa: BLE001 (liveness is best effort)
                tok = (-1, -1)
            now = time.time()
            if tok != last:
                last, progress = tok, now
            try:
                _atomic_json(self._path, {"iteration": tok[0],
                                          "armed": int(self._steps()) - steps0 >= 2,
                                          "progress_unix_s": progress, "ts_unix_s": now})
            except OSError:
                pass
            self._halt.wait(self._period)

    def stop(self):
        self._halt.set()
        self._thread.join()


# ----------------------------------------------------------------- worker
def run_worker(ns) -> int:
    """One cohort member: bootstrap, the job's model, ``fit`` with
    checkpoints and a heartbeat, the result file."""
    import numpy as np
    import torch.distributed as dist

    from .. import kernels
    from ..obs.metrics import metrics_registry
    from ..runtime import faults as _faults
    from ..runtime.checkpoint import topology_signature
    from .multihost import elastic_init, multiprocess_compute_support

    plan = json.loads(ns.fault_plan) if ns.fault_plan else None
    # armed before the bootstrap, so multihost.init_timeout can fire in
    # elastic_init's attempt; fit arms the equal spec again, keeping counts
    _faults.configure_faults(type("_Plan", (), {"fault_plan": plan}))
    if ns.nproc > 1:
        init = elastic_init(coordinator_address=ns.coord, num_processes=ns.nproc,
                            process_id=ns.rank, timeout_s=ns.init_timeout, seed=ns.rank)
        multiprocess_compute_support()
    else:
        init = {"attempts": 0}
    config = dict(epochs=ns.epochs, checkpoint_interval_steps=ns.interval,
                  checkpoint_dir=ns.ckpt_dir, checkpoint_barrier_timeout_s=120.0,
                  elastic_resume=True, fault_plan=plan, device=ns.device)
    if ns.watchdog_threshold > 0:
        config.update(watchdog="on", watchdog_threshold_s=ns.watchdog_threshold,
                      watchdog_dir=os.path.join(ns.run_dir, f"blackbox-r{ns.rank}"))
    if ns.cohort_obs:
        # the artifact directory comes in through FLEXFLOW_TPU_COHORT_DIR
        config.update(cohort_obs="on", cohort_skew_threshold=ns.cohort_threshold)
    ff, x, y = _load_job(ns.job)(config, ns.nproc, **json.loads(ns.job_args or "{}"))
    hb_dir = os.path.join(ns.run_dir, "hb")
    os.makedirs(hb_dir, exist_ok=True)
    if not _file_barrier(hb_dir, "ready", ns.rank, ns.nproc, 600.0):
        print(f"[launch worker {ns.rank}] ready barrier timed out; going on",
              file=sys.stderr, flush=True)
    polls = metrics_registry().counter("checkpoint.barrier_polls")
    steps = metrics_registry().counter("fit.steps")
    hb = _Heartbeat(os.path.join(hb_dir, f"hb-{ns.rank}.json"),
                    lambda: (ff.compiled.iteration, polls.value), lambda: steps.value)
    hb.start()
    try:
        history = ff.fit(x, y, verbose=False, resume_from=ns.ckpt_dir)
    finally:
        hb.stop()
    params = ff.numpy_params()  # every rank gathers
    if ns.rank == 0:
        np.savez(os.path.join(ns.run_dir, "params.npz"),
                 **{f"{op}/{w}": a for op, ws in params.items() for w, a in ws.items()})
    reg = metrics_registry()
    result = {
        "rank": ns.rank, "nproc": ns.nproc, "init_attempts": init["attempts"],
        "params_sha": params_digest(params),
        "iteration": int(ff.compiled.resume_state()["iteration"]),
        "epochs": [{"count": pm.train_all, "sparse_cce_loss": pm.sparse_cce_loss,
                    "mse_loss": pm.mse_loss} for pm in history],
        "epochs_run": len(history),
        **{k.split(".")[1]: int(reg.counter(k).value) for k in (
            "checkpoint.resumes", "checkpoint.elastic_resumes", "checkpoint.torn_manifests",
            "checkpoint.shard_saves", "checkpoint.barrier_timeouts")},
        "faults": _faults.faults_block(),
        "kernel_launches": kernels.launch_counts(),
        "topology": topology_signature(ff.compiled.device, ns.nproc, ff.compiled.mesh),
    }
    _atomic_json(os.path.join(ns.run_dir, f"result-{ns.rank}.json"), result)
    if ns.nproc > 1:
        # leave only after every peer's result landed: rank 0 holds the
        # rendezvous store, and its exit would fail a peer still finishing
        want = [os.path.join(ns.run_dir, f"result-{r}.json") for r in range(ns.nproc)]
        deadline = time.monotonic() + 600.0
        while not all(os.path.exists(p) for p in want) and time.monotonic() < deadline:
            time.sleep(0.05)
        if all(os.path.exists(p) for p in want):
            dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    # skip the interpreter's teardown, where a process group's C++
    # threads were seen to abort under load
    os._exit(0)


# ------------------------------------------------------------- supervisor
def _spawn(rank: int, nproc: int, coord: str, run_dir: str, ckpt_dir: str, epochs: int,
           interval: int, init_timeout: float, fault_plan: Optional[Dict], attempt: int,
           launch_id: str, job: str, job_args: Optional[Dict], device: str,
           watchdog_threshold: float = 0.0, cohort_obs: bool = False,
           cohort_threshold: float = 0.25) -> Dict:
    env = dict(os.environ)
    # the cohort's incarnation: the manifest barrier counts only acks of
    # this launch (runtime/checkpoint.MultiHostCheckpointManager)
    env["FLEXFLOW_TPU_MH_LAUNCH_ID"] = launch_id
    # a ledger and a cost corpus a rank, folded into the cohort's after
    env["FLEXFLOW_TPU_LEDGER_DIR"] = os.path.join(run_dir, "ledger", f"rank-{rank}")
    env["FLEXFLOW_TPU_COSTCORPUS_DIR"] = os.path.join(run_dir, "costcorpus", f"rank-{rank}")
    if cohort_obs:
        # one shared directory: every artifact's name carries its rank
        env["FLEXFLOW_TPU_COHORT_DIR"] = os.path.join(run_dir, "cohort")
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [_ROOT, os.getcwd(),
                                                      env.get("PYTHONPATH")]))
    # a worker killed as hung leaves its threads' stacks in its log
    env.setdefault("PYTHONFAULTHANDLER", "1")
    cmd = [sys.executable, "-m", "flexflow_tpu_torch.parallel.launch", "--worker",
           "--rank", str(rank), "--nproc", str(nproc), "--coord", coord,
           "--run-dir", run_dir, "--ckpt-dir", ckpt_dir, "--epochs", str(epochs),
           "--interval", str(interval), "--init-timeout", str(init_timeout),
           "--job", job, "--job-args", json.dumps(job_args or {}), "--device", device,
           "--watchdog-threshold", str(watchdog_threshold)]
    if cohort_obs:
        cmd += ["--cohort-obs", "--cohort-threshold", str(cohort_threshold)]
    if fault_plan is not None:
        cmd += ["--fault-plan", json.dumps(fault_plan)]
    logs = os.path.join(run_dir, "logs")
    os.makedirs(logs, exist_ok=True)
    out = open(os.path.join(logs, f"rank-{rank}-a{attempt}.out"), "w")
    err = open(os.path.join(logs, f"rank-{rank}-a{attempt}.err"), "w")
    proc = subprocess.Popen(cmd, env=env, stdout=out, stderr=err, text=True)
    return {"rank": rank, "proc": proc, "out": out, "err": err, "err_path": err.name}


def _teardown(workers: List[Dict]) -> None:
    """SIGTERM every live worker, SIGKILL what is left after 5 s."""
    for w in workers:
        if w["proc"].poll() is None:
            try:
                w["proc"].send_signal(signal.SIGTERM)
            except OSError:
                pass
    deadline = time.monotonic() + 5.0
    for w in workers:
        try:
            w["proc"].wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            w["proc"].kill()
            w["proc"].wait()
    for w in workers:
        w["out"].close()
        w["err"].close()


def _monitor(workers: List[Dict], run_dir: str, hb_dir: str, hang_threshold_s: float,
             timeout_s: float) -> Dict:
    """Watch the cohort until it finishes, a peer dies (a non-zero exit
    before its result), a peer hangs (an armed heartbeat that has not
    moved for ``hang_threshold_s``) or ``timeout_s`` passes."""
    t0 = time.monotonic()

    def has_result(rank: int) -> bool:
        return os.path.exists(os.path.join(run_dir, f"result-{rank}.json"))

    while True:
        time.sleep(0.1)
        rcs = {w["rank"]: w["proc"].poll() for w in workers}
        dead = {r: rc for r, rc in rcs.items() if rc not in (None, 0) and not has_result(r)}
        if dead:
            return {"outcome": "dead", "failed": dead}
        if all(rc is not None for rc in rcs.values()):
            return {"outcome": "ok", "failed": {}}
        if hang_threshold_s > 0:
            now = time.time()
            for w in workers:
                if rcs[w["rank"]] is not None or has_result(w["rank"]):
                    continue  # finished: a stopped heartbeat is no hang
                hb = _read_json(os.path.join(hb_dir, f"hb-{w['rank']}.json"))
                if hb and hb.get("armed") and \
                        now - hb.get("progress_unix_s", now) > hang_threshold_s:
                    return {"outcome": "hung", "failed": {w["rank"]: None}, "heartbeat": hb}
        if time.monotonic() - t0 > timeout_s:
            return {"outcome": "timeout",
                    "failed": {r: rc for r, rc in rcs.items() if rc is None}}


def _collect_dumps(run_dir: str, nproc: int) -> List[str]:
    """Every worker's black-box dumps under the run directory."""
    from ..obs.watchdog import list_dumps

    out: List[str] = []
    for r in range(nproc):
        out += list_dumps(os.path.join(run_dir, f"blackbox-r{r}"))
    return sorted(out)


def _log_tail(path: str, n: int = 1500) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def supervise(nproc: int = 2, run_dir: Optional[str] = None, ckpt_dir: Optional[str] = None,
              epochs: int = EPOCHS, interval: int = INTERVAL,
              fault_plan: Optional[Dict] = None, fault_rank: int = 0,
              hang_threshold_s: float = 0.0, max_relaunches: int = 2,
              init_timeout_s: float = 60.0, cohort_timeout_s: float = 420.0,
              job: str = DEFAULT_JOB, job_args: Optional[Dict] = None,
              device: str = "cuda", watchdog_threshold_s: float = 0.0,
              cohort_obs: bool = False, cohort_threshold: float = 0.25) -> Dict:
    """Launch and heal one cohort; returns the supervisor's report.

    The fault plan goes to ``fault_rank`` on the first launch only: a
    relaunch is the recovery and runs clean. Every launch passes the same
    ``resume_from`` (an empty directory starts fresh). ``device``: the
    workers' device, as ``FFConfig.device``: ``cuda`` raises here when
    this process sees no card; a CPU cohort asks for ``cpu``. Ranks that
    share a card run over gloo."""
    from ..config import FFConfig

    FFConfig(device=device).torch_device()
    run_dir = run_dir or tempfile.mkdtemp(prefix="ff_launch_")
    os.makedirs(run_dir, exist_ok=True)
    ckpt_dir = ckpt_dir or os.path.join(run_dir, "ckpt")
    hb_dir = os.path.join(run_dir, "hb")
    os.makedirs(hb_dir, exist_ok=True)
    events: List[Dict] = []
    ok = False
    live: List[Dict] = []

    def on_signal(signum, _frame):
        _teardown(live)
        raise SystemExit(128 + signum)

    try:  # a killed supervisor takes its cohort down (main thread only)
        old = (signal.signal(signal.SIGTERM, on_signal), signal.signal(signal.SIGINT, on_signal))
    except ValueError:
        old = None
    attempt = 0
    t0 = time.perf_counter()
    try:
        for attempt in range(max_relaunches + 1):
            # a torn-down attempt's liveness and result files must not leak
            for r in range(nproc):
                for p in (os.path.join(hb_dir, f"hb-{r}.json"),
                          os.path.join(hb_dir, f"ready-{r}.json"),
                          os.path.join(run_dir, f"result-{r}.json")):
                    try:
                        os.remove(p)
                    except OSError:
                        pass
            coord = f"127.0.0.1:{_free_port()}"
            launch_id = uuid.uuid4().hex
            live = [_spawn(r, nproc, coord, run_dir, ckpt_dir, epochs, interval, init_timeout_s,
                           fault_plan if (attempt == 0 and r == fault_rank) else None, attempt,
                           launch_id, job, job_args, device, watchdog_threshold_s, cohort_obs,
                           cohort_threshold)
                    for r in range(nproc)]
            status = _monitor(live, run_dir, hb_dir, hang_threshold_s, cohort_timeout_s)
            _teardown(live)
            workers, live = live, []
            if status["outcome"] == "ok":
                ok = True
                break
            events.append({
                "attempt": attempt, "outcome": status["outcome"],
                "failed": {str(r): rc for r, rc in status["failed"].items()},
                "heartbeat": status.get("heartbeat"),
                # the hung worker's black-box dumps are its diagnosis: every
                # thread's stack, the tracer's tail, the last ledger record
                "blackbox_dumps": [os.path.basename(p)
                                   for p in _collect_dumps(run_dir, nproc)],
                "log_tails": {str(w["rank"]): _log_tail(w["err_path"]) for w in workers
                              if str(w["rank"]) in {str(r) for r in status["failed"]}}})
    finally:
        _teardown(live)
        if old is not None:
            signal.signal(signal.SIGTERM, old[0])
            signal.signal(signal.SIGINT, old[1])
    report: Dict = {"ok": ok, "nproc": nproc, "relaunches": attempt, "events": events,
                    "run_dir": run_dir, "ckpt_dir": ckpt_dir,
                    "seconds": time.perf_counter() - t0}
    if not ok:
        report["error"] = (f"cohort failed after {attempt + 1} launches "
                           f"({events[-1]['outcome'] if events else '?'})")
        return report
    results = {}
    for r in range(nproc):
        doc = _read_json(os.path.join(run_dir, f"result-{r}.json"))
        if doc is None:
            report.update(ok=False, error=f"rank {r} exited 0 without a result file")
            return report
        results[str(r)] = doc
    report["results"] = results
    first = results["0"]
    report["agree"] = all(res["params_sha"] == first["params_sha"]
                          and res["epochs"] == first["epochs"] for res in results.values())
    _fold_cohort_obs(report, run_dir, nproc, cohort_obs, cohort_threshold)
    return report


def _fold_cohort_obs(report: Dict, run_dir: str, nproc: int, cohort_obs: bool,
                     cohort_threshold: float) -> None:
    """One cohort ledger and cost corpus from every rank's, deduplicated
    (a second merge must add nothing), and under ``cohort_obs`` the
    cohort report with its skew stamped onto the merged fit records."""
    from ..obs.costcorpus import merge_corpus
    from ..obs.ledger import merge_runs

    cohort_dir = os.path.join(run_dir, "ledger", "cohort")
    merged = remerged = 0
    for r in range(nproc):
        src = os.path.join(run_dir, "ledger", f"rank-{r}")
        merged += merge_runs(src, cohort_dir)
        remerged += merge_runs(src, cohort_dir)
    report["ledger"] = {"cohort_dir": cohort_dir, "merged": merged, "remerged": remerged}
    corpus_cohort = os.path.join(run_dir, "costcorpus", "cohort")
    srcs = [os.path.join(run_dir, "costcorpus", f"rank-{r}") for r in range(nproc)]
    srcs = [d for d in srcs if os.path.isdir(d)]
    if srcs:
        report["cost_corpus"] = {"cohort_dir": corpus_cohort,
                                 "merged": sum(merge_corpus(d, corpus_cohort) for d in srcs)}
    if cohort_obs:
        from ..obs.cohort import annotate_ledger_with_skew, build_cohort_report

        try:
            report["cohort"] = build_cohort_report(os.path.join(run_dir, "cohort"),
                                                   threshold=cohort_threshold)
            report["cohort"]["ledger_annotated"] = annotate_ledger_with_skew(
                cohort_dir, report["cohort"])
        except Exception as exc:  # noqa: BLE001 — the report never fails the run
            report["cohort"] = {"error": f"cohort report failed: {exc}"}


# ------------------------------------------------------------ the matrix
def _sc_baseline(ctx, violations) -> Dict:
    rep = supervise(nproc=ctx["nproc"], run_dir=os.path.join(ctx["base"], "baseline"),
                    max_relaunches=0, cohort_timeout_s=ctx["timeout"], **ctx["job"])
    ctx["baseline"] = rep
    row = {"ok": rep["ok"], "agree": rep.get("agree")}
    if not rep["ok"]:
        violations.append(f"baseline: cohort failed ({rep.get('error')}; {rep['events']})")
    elif not rep["agree"]:
        violations.append("baseline: the ranks disagree on the trajectory")
    return row


def _sc_kill_resume(ctx, violations) -> Dict:
    plan = {"schema": 1, "seed": 0,
            "sites": {"multihost.peer_kill": {"at_step": ctx["kill_step"],
                                              "exit_code": KILL_EXIT}}}
    rep = supervise(nproc=ctx["nproc"], run_dir=os.path.join(ctx["base"], "kill"),
                    fault_plan=plan, fault_rank=ctx["nproc"] - 1, max_relaunches=2,
                    cohort_timeout_s=ctx["timeout"], **ctx["job"])
    ctx["kill"] = rep
    row = {"ok": rep["ok"], "relaunches": rep["relaunches"],
           "events": [e["outcome"] for e in rep["events"]]}
    if not rep["ok"]:
        violations.append(f"kill_resume: cohort failed ({rep.get('error')}; {rep['events']})")
        return row
    ev = rep["events"][0] if rep["events"] else {}
    if rep["relaunches"] != 1 or ev.get("outcome") != "dead" or \
            ev.get("failed", {}).get(str(ctx["nproc"] - 1)) != KILL_EXIT:
        violations.append(f"kill_resume: the supervisor did not see the killed peer once "
                          f"({rep['relaunches']} relaunches, event {ev})")
    res = rep["results"]
    row["resumed"] = {r: d["resumes"] for r, d in res.items()}
    if any(d["resumes"] < 1 for d in res.values()):
        violations.append("kill_resume: a relaunched rank did not resume from its shard")
    base = (ctx.get("baseline") or {}).get("results", {}).get("0")
    if base:
        row["bit_identical"] = res["0"]["params_sha"] == base["params_sha"]
        if not row["bit_identical"]:
            violations.append("kill_resume: the resumed params differ from the "
                              "uninterrupted cohort's")
    return row


def _sc_shrink_resize(ctx, violations) -> Dict:
    kill = ctx.get("kill")
    if not kill or not kill.get("ok"):
        violations.append("shrink_resize: no finished kill_resume checkpoint to shrink onto")
        return {"ok": False}
    steps = (kill.get("results") or {}).get("0", {}).get("iteration", 0)
    rep = supervise(nproc=1, run_dir=os.path.join(ctx["base"], "shrink"),
                    ckpt_dir=kill["ckpt_dir"], max_relaunches=0,
                    cohort_timeout_s=ctx["timeout"], **dict(ctx["job"], epochs=ctx["epochs"] + 1))
    row = {"ok": rep["ok"]}
    if not rep["ok"]:
        violations.append(f"shrink_resize: the shrunk cohort failed ({rep.get('error')})")
        return row
    res = rep["results"]["0"]
    row.update(elastic_resumes=res["elastic_resumes"], epochs_run=res["epochs_run"],
               iteration=res["iteration"])
    if res["elastic_resumes"] < 1:
        violations.append("shrink_resize: the resume under a changed topology did not take "
                          "the counted elastic path")
    if res["epochs_run"] < 1 or res["iteration"] <= steps:
        violations.append(f"shrink_resize: the shrunk run did not train past the restored "
                          f"step (iteration {res['iteration']})")
    return row


def _sc_hang_relaunch(ctx, violations) -> Dict:
    plan = {"schema": 1, "seed": 0,
            "sites": {"multihost.slow_peer": {"at_step": ctx["kill_step"] - 1,
                                              "stall_s": 600.0}}}
    rep = supervise(nproc=ctx["nproc"], run_dir=os.path.join(ctx["base"], "hang"),
                    fault_plan=plan, fault_rank=ctx["nproc"] - 1,
                    hang_threshold_s=ctx["hang_threshold"], max_relaunches=2,
                    cohort_timeout_s=ctx["timeout"], **ctx["job"])
    row = {"ok": rep["ok"], "relaunches": rep["relaunches"],
           "events": [e["outcome"] for e in rep["events"]]}
    if not rep["ok"]:
        violations.append(f"hang_relaunch: cohort failed ({rep.get('error')}; {rep['events']})")
        return row
    if rep["relaunches"] != 1 or rep["events"][0]["outcome"] != "hung":
        violations.append(f"hang_relaunch: expected one relaunch after a hung peer, got "
                          f"{row['events']}")
    base = (ctx.get("baseline") or {}).get("results", {}).get("0")
    if base and rep["results"]["0"]["params_sha"] != base["params_sha"]:
        violations.append("hang_relaunch: the relaunched params differ from the baseline")
    return row


MATRIX = {"baseline": _sc_baseline, "kill_resume": _sc_kill_resume,
          "shrink_resize": _sc_shrink_resize, "hang_relaunch": _sc_hang_relaunch}


def run_matrix(scenarios=None, base_dir: Optional[str] = None, nproc: int = 2,
               cohort_timeout_s: float = 420.0, job: str = DEFAULT_JOB,
               job_args: Optional[Dict] = None, epochs: int = EPOCHS, interval: int = INTERVAL,
               kill_step: int = 6, hang_threshold_s: float = 8.0,
               device: str = "cuda") -> Dict:
    """The scenarios in order (``baseline`` always: the bit-identity
    reference; ``shrink_resize`` pulls in ``kill_resume``, whose directory
    it resumes)."""
    t0 = time.perf_counter()
    want = set(scenarios) if scenarios else set(MATRIX)
    want.add("baseline")
    if "shrink_resize" in want:
        want.add("kill_resume")
    ctx = {"base": base_dir or tempfile.mkdtemp(prefix="ff_launch_matrix_"), "nproc": nproc,
           "timeout": cohort_timeout_s, "epochs": epochs, "kill_step": kill_step,
           "hang_threshold": hang_threshold_s,
           "job": dict(job=job, job_args=job_args, epochs=epochs, interval=interval,
                       device=device)}
    violations: List[str] = []
    rows = {name: fn(ctx, violations) for name, fn in MATRIX.items() if name in want}
    return {"scenarios": rows, "violations": violations,
            "seconds": time.perf_counter() - t0, "exit": 1 if violations else 0}


# ------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--coord", default=None)
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--interval", type=int, default=INTERVAL)
    ap.add_argument("--init-timeout", type=float, default=60.0)
    ap.add_argument("--job", default=DEFAULT_JOB,
                    help="module:function(config, nproc, **job_args) -> (ff, x, y)")
    ap.add_argument("--job-args", default=None, help="JSON keyword arguments of the job")
    ap.add_argument("--device", default="cuda",
                    help="the workers' device: cuda (raises without a card) or cpu")
    ap.add_argument("--fault-plan", default=None,
                    help="JSON fault plan (armed on --fault-rank, first launch only)")
    ap.add_argument("--fault-rank", type=int, default=0)
    ap.add_argument("--hang-threshold", type=float, default=0.0,
                    help="seconds an armed heartbeat may stand still (0: off)")
    ap.add_argument("--max-relaunches", type=int, default=2)
    ap.add_argument("--watchdog-threshold", type=float, default=0.0,
                    help="arm each worker's stall watchdog at this many seconds (0: off)")
    ap.add_argument("--cohort-obs", action="store_true",
                    help="export each rank's trace and metrics; add the cohort report")
    ap.add_argument("--cohort-threshold", type=float, default=0.25,
                    help="the steady-state skew fraction past which OBS003 fires")
    ap.add_argument("--smoke", action="store_true", help="the scenario matrix; one JSON line")
    ap.add_argument("--scenario", action="append", default=None,
                    help="a matrix scenario (repeatable; implies --smoke)")
    ns = ap.parse_args(argv)
    if ns.worker:
        return run_worker(ns)
    job_args = json.loads(ns.job_args) if ns.job_args else None
    if ns.smoke or ns.scenario:
        out = run_matrix(ns.scenario, ns.run_dir, ns.nproc, job=ns.job, job_args=job_args,
                         epochs=ns.epochs, interval=ns.interval, device=ns.device)
        print(json.dumps(out, sort_keys=True, default=str))
        return out["exit"]
    rep = supervise(nproc=ns.nproc, run_dir=ns.run_dir, ckpt_dir=ns.ckpt_dir,
                    epochs=ns.epochs, interval=ns.interval,
                    fault_plan=json.loads(ns.fault_plan) if ns.fault_plan else None,
                    fault_rank=ns.fault_rank, hang_threshold_s=ns.hang_threshold,
                    max_relaunches=ns.max_relaunches, init_timeout_s=ns.init_timeout,
                    job=ns.job, job_args=job_args, device=ns.device,
                    watchdog_threshold_s=ns.watchdog_threshold, cohort_obs=ns.cohort_obs,
                    cohort_threshold=ns.cohort_threshold)
    print(json.dumps(rep, sort_keys=True, default=str))
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
