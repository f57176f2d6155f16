"""The port's three source gates against the JAX package's.

* The fixture sources of ``tests/test_analysis_lint.py``,
  ``tests/test_concurrency_check.py`` and ``tests/test_knobflow_check.py``
  go, as the same text, through both packages' checkers: each of those
  tests runs with its checker swapped for one that calls both and holds
  the port's findings (code, severity, file, line) to the JAX package's,
  then hands the JAX result to the test's own assertions. The torch
  rules of HOT001/HOT002 differ by design (a torch sync set, torch calls
  on workers) and have fixtures of their own below.
* The port's tree: 0 errors in each gate and no reasonless pragma, each
  package scan run once for the module.
* The repairs the gates asked for, each failing before its fix.
"""

import importlib
import inspect
import os
import pathlib
import textwrap
import threading
import time

import pytest
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)
from _torch_shared import run_once

from flexflow_tpu.analysis import concurrency_check as jccy
from flexflow_tpu.analysis import hotpath_lint as jhot
from flexflow_tpu.analysis import knobflow_check as jknb
from flexflow_tpu_torch.analysis import concurrency_check as tccy
from flexflow_tpu_torch.analysis import hotpath_lint as thot
from flexflow_tpu_torch.analysis import knobflow_check as tknb
from flexflow_tpu_torch.analysis import pragmas

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = str(ROOT / "flexflow_tpu_torch")


def _fkey(findings, exclude=()):
    return [(f.code, f.severity, f.file, f.line) for f in findings if f.code not in exclude]


def _findings_of(result):
    return getattr(result, "findings", result)


def _worker_key(pairs, exclude=()):
    return [(getattr(n, "name", "<lambda>"), n.lineno, roles) for n, roles in pairs]


# checker name in the JAX test module -> (JAX function, port function,
# key, codes left out of the comparison)
_SWAPS = {
    "test_analysis_lint": {
        "lint_hotpath_source": (jhot.lint_source, thot.lint_source, _fkey,
                                ("HOT001", "HOT002")),
        "lint_hotpaths": (jhot.lint_paths, thot.lint_paths, _fkey, ("HOT001", "HOT002")),
    },
    "test_concurrency_check": {
        "check_source": (jccy.check_source, tccy.check_source, _fkey, ()),
        "check_package": (jccy.check_package, tccy.check_package,
                          lambda r, ex: _fkey(_findings_of(r), ex), ()),
        "module_worker_functions": (jccy.module_worker_functions,
                                    tccy.module_worker_functions, _worker_key, ()),
    },
    "test_knobflow_check": {
        "check_sources": (jknb.check_sources, tknb.check_sources, _fkey, ()),
    },
}
# the fixture tests of each module: the ones over the repo, the Makefile,
# the tools or the ledger read the JAX package itself and stay its own
_SKIP = ("repo", "make", "tool", "pcg_lint", "dot", "cohort_key", "serving_knob",
         "sentinel", "build_package", "report_error_class", "deleting")


def _fixture_tests():
    out = []
    for modname in _SWAPS:
        mod = importlib.import_module(modname)
        for name, fn in inspect.getmembers(mod, inspect.isfunction):
            if not name.startswith("test_") or any(s in name for s in _SKIP):
                continue
            params = list(inspect.signature(fn).parameters)
            if set(params) <= {"tmp_path"}:
                out.append((modname, name))
    return out


@pytest.mark.parametrize("modname,name", _fixture_tests())
def test_fixture_findings_equal_the_jax_checkers(modname, name, monkeypatch, tmp_path):
    mod = importlib.import_module(modname)
    calls = []
    for attr, (jfn, tfn, key, exclude) in _SWAPS[modname].items():
        if not hasattr(mod, attr):
            continue

        def both(*a, _j=jfn, _t=tfn, _k=key, _x=exclude, **kw):
            want, got = _j(*a, **kw), _t(*a, **kw)
            assert _k(got, _x) == _k(want, _x)
            calls.append(1)
            return want

        monkeypatch.setattr(mod, attr, both)
    fn = getattr(mod, name)
    fn(tmp_path) if "tmp_path" in inspect.signature(fn).parameters else fn()
    assert calls, f"{modname}.{name} reached no checker"


# ------------------------------------------------- the port's own tree
def _scan_port():
    t0 = time.perf_counter()
    out = {"hotpath": thot.lint_paths([PORT]),
           "concurrency": tccy.check_package([PORT]),
           "knobflow": tknb.check_package([PORT],
                                          extra_read_paths=tknb.default_extra_paths(PORT))}
    out["seconds"] = time.perf_counter() - t0
    return out


@pytest.fixture(scope="module")
def port_scans(tmp_path_factory):
    """The three gates over the port's tree, walked once for the run
    (whichever xdist worker asks first) and shared by every test here."""
    return run_once(tmp_path_factory, "port_scans", _scan_port)


def test_port_tree_is_hotpath_clean(port_scans):
    assert not port_scans["hotpath"], "\n".join(f.format() for f in port_scans["hotpath"])


def test_port_tree_is_concurrency_clean(port_scans):
    rep = port_scans["concurrency"]
    assert not rep.errors, rep.format()
    # the roots the audit must see in the port: the Prefetcher, the two
    # serving workers, the watchdog, the checkpoint commit and the
    # heartbeat of parallel/launch.py
    roots = " ".join(str(r) for r in rep.roles)
    for want in ("ff-prefetch", "serving/engine.py", "serving/scheduler.py",
                 "ff-watchdog", "_commit", "ff-heartbeat"):
        assert want in roots, sorted(rep.roles)


def test_port_tree_is_knobflow_clean(port_scans):
    rep = port_scans["knobflow"]
    # no error and no warning: every knob read somewhere (KNB003), every
    # field with a flag or a reasoned flag-ok (KNB004), every perf knob
    # cohorted or reasoned (KNB002)
    assert not rep.findings, rep.format()


def test_port_tree_has_no_reasonless_pragma():
    bad = []
    paths = list(pathlib.Path(PORT).rglob("*.py")) + [ROOT / "chip_smoke.py"]
    paths += sorted((ROOT / "tools").glob("torch_*.py"))
    for path in paths:
        for line, p in pragmas.lint_reasonless(path.read_text()):
            if p.tool in ("hotpath", "audit", "concurrency", "knobflow"):
                bad.append(f"{path}:{line} {p.tool}: {p.token}")
    assert not bad, bad


def test_gate_cli_modules_exit_one_on_a_finding(tmp_path):
    """``python -m flexflow_tpu_torch.analysis.<gate> <paths>``: 1 on an
    error finding, 0 on a clean tree."""
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "loop.py").write_text(textwrap.dedent("""
        import threading

        def fit(cm, batches):
            for b in batches:
                loss = cm.train_step(b)
                print(loss.item())

        class W:
            def __init__(self):
                self._lock = threading.Lock()
                threading.Thread(target=self._run).start()

            def _run(self):
                self.n = 1
    """))
    clean = tmp_path / "clean"
    clean.mkdir()
    (clean / "ok.py").write_text("X = 1\n")
    assert thot.main([str(bad)]) == 1 and thot.main([str(clean)]) == 0
    assert tccy.main([str(bad)]) == 1 and tccy.main([str(clean)]) == 0
    assert tknb.main([str(clean)]) == 0


# -------------------------------------------------- torch-specific rules
def _hot(src):
    return [f.code for f in thot.lint_source(textwrap.dedent(src), "fix.py")]


@pytest.mark.parametrize("sync", ["loss.item()", "loss.tolist()", "loss.cpu()",
                                  "loss.numpy()", "float(loss)", "int(loss)", "bool(loss)",
                                  "np.asarray(loss)", "torch.cuda.synchronize()",
                                  "ev.synchronize()"])
def test_torch_host_sync_in_step_loop_fires_hot001(sync):
    src = f"""
        import numpy as np
        import torch

        def fit(cm, batches, ev):
            for b in batches:
                p, o, loss, m = cm.train_step(cm.params, cm.opt, 0, *b)
                x = {sync}
    """
    assert _hot(src) == ["HOT001"]
    pragma = src.replace(sync, sync + "  # hotpath: sync-ok (fixture)")
    assert _hot(pragma) == []


def test_host_values_in_step_loop_are_not_syncs():
    assert _hot("""
        def fit(cm, batches):
            for b in batches:
                cm.train_step(cm.params, cm.opt, 0, *b)
                n = int(len(b))
                k = int(3)
    """) == []


@pytest.mark.parametrize("call,fires", [("torch.zeros(4)", True), ("x.cuda()", True),
                                        ("x.to(dev)", True), ("torch.device('cpu')", False),
                                        ("torch.cuda.is_available()", False)])
def test_torch_call_in_worker_fires_hot002(call, fires):
    src = f"""
        import threading
        import torch

        class Loader:
            def start(self):
                threading.Thread(target=self._work, daemon=True).start()

            def _work(self):
                x = self.q.get()
                dev = 'cuda'
                y = {call}
    """
    assert _hot(src) == (["HOT002"] if fires else [])


def test_synchronize_under_a_lock_fires_ccy003():
    src = textwrap.dedent("""
        import threading
        import torch

        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self.done = threading.Event()
                threading.Thread(target=self._run, daemon=True).start()

            def _run(self):
                while not self.done.is_set():
                    with self._lock:
                        torch.cuda.synchronize()

            def stop(self):
                self.done.set()
    """)
    assert "CCY003" in [f.code for f in tccy.check_source(src, "fix.py")]


def test_port_parse_args_flag_table_counts_for_knb004():
    """The port's parse_args keeps a flag table, not an if/elif chain:
    each ``"--flag": ("field", conv)`` entry gives its field a flag."""
    files = {"config.py": textwrap.dedent("""
        from dataclasses import dataclass

        @dataclass
        class FFConfig:
            alpha: int = 1
            beta: int = 2

            @staticmethod
            def parse_args(argv):
                cfg = FFConfig()
                flags = {"--alpha": ("alpha", int), "--typo": ("gamma", int)}
                for a in argv:
                    if a in flags:
                        setattr(cfg, flags[a][0], 1)
                return cfg
    """)}
    found = [(f.code, f.severity, f.message) for f in tknb.check_sources(files)
             if f.code == "KNB004"]
    assert any("'beta' has no CLI flag" in m for _, _, m in found)
    assert any("unknown config field 'gamma'" in m and s == "error" for _, s, m in found)
    assert not any("'alpha'" in m for _, _, m in found)


# ------------------------------------------------------------- repairs
def test_engine_group_scheduler_is_assigned_in_the_constructor(port_scans):
    """CCY001 at serving/engine.py: a rank group's scheduler was assigned
    outside the constructor, where the audit cannot see that it happens
    before the instance is published; it is now assigned in __init__."""
    assert not [f for f in port_scans["concurrency"].findings
                if f.file == "serving/engine.py"]
    from flexflow_tpu_torch.serving.engine import GenerationInstance

    assert "self.scheduler = self._group_scheduler(" in inspect.getsource(
        GenerationInstance.__init__)


def test_checkpoint_commit_thread_has_a_join_path(port_scans):
    """CCY005 at runtime/checkpoint.py: the commit thread's join went
    through a tuple swap the audit could not follow; it reads the
    pending thread and clears it in two statements, as the JAX package."""
    assert not [f for f in port_scans["concurrency"].findings
                if f.code == "CCY005"]


def test_heartbeat_owns_its_thread_and_stops(tmp_path):
    """CCY003 at parallel/launch.py: the heartbeat subclassed Thread, so
    every ``subprocess.run`` in the package resolved to its ``run`` and
    its event wait read as held under native_bridge's build lock. It now
    runs on a thread it owns; start and stop still write and join. It arms
    once two steps ran after it started (the steps counter), not before."""
    from flexflow_tpu_torch.parallel.launch import _Heartbeat

    path = tmp_path / "hb.json"
    steps = [5]
    hb = _Heartbeat(str(path), lambda: (3, 0), lambda: steps[0], period_s=0.01)
    assert not isinstance(hb, threading.Thread)
    hb.start()
    for _ in range(200):
        if path.exists():
            break
        time.sleep(0.01)
    assert '"armed": false' in path.read_text()
    steps[0] += 2
    for _ in range(200):
        if '"armed": true' in path.read_text():
            break
        time.sleep(0.01)
    hb.stop()
    assert path.exists() and not hb._thread.is_alive()
    text = path.read_text()
    assert '"iteration": 3' in text and '"armed": true' in text


# ------------------------------------------------------------ the tools
def test_gate_tools_emit_one_json_line(tmp_path):
    """The four tools, each one JSON line with its JAX namesake's keys,
    run side by side: exit 0 over the port (the two zoo sweeps on one
    model each), exit 1 on a reasonless pragma."""
    import json
    import subprocess
    import sys

    bad = tmp_path / "pkg"
    bad.mkdir()
    (bad / "m.py").write_text("x = 1  # concurrency: race-ok\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    runs = {
        "pcg": ["tools/torch_pcg_lint.py", "--model", "mlp", "--device", "cpu"],
        "audit": ["tools/torch_program_audit.py", "--model", "mlp", "--device", "cpu"],
        "ccy": ["tools/torch_concurrency_lint.py"],
        "knb": ["tools/torch_knob_lint.py"],
        "ccy_bad": ["tools/torch_concurrency_lint.py", str(bad)],
    }
    procs = {k: subprocess.Popen([sys.executable, *v], cwd=ROOT, env=env, text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for k, v in runs.items()}
    docs, codes = {}, {}
    for k, p in procs.items():
        out, err = p.communicate(timeout=300)
        lines = out.strip().splitlines()
        assert len(lines) == 1, (k, out[-500:], err[-500:])
        docs[k], codes[k] = json.loads(lines[0]), p.returncode
    assert codes == {"pcg": 0, "audit": 0, "ccy": 0, "knb": 0, "ccy_bad": 1}
    assert set(docs["pcg"]) >= {"reports", "codes", "mesh", "meshes", "searched", "exit"}
    assert docs["pcg"]["reports"]["mlp"]["errors"] == 0
    assert set(docs["audit"]) >= {"models", "donated_reuse", "audit_frac_max", "codes", "exit"}
    prog = docs["audit"]["models"]["mlp"]["programs"]["train_step"]
    assert prog["ops"] > 0 and prog["record_s"] > 0 and "static_peak_bytes" in prog
    assert docs["ccy"]["errors"] == 0 and docs["ccy"]["n_roles"] >= 7
    assert docs["knb"]["errors"] == 0 and docs["knb"]["coverage"]["cohort_cover_hash"]
    assert docs["ccy_bad"]["reasonless"][0]["pragma"] == "concurrency: race-ok"
