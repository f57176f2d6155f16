"""Rules the port keeps: it (and chip_smoke.py, which drives it on the
card, and the ranks it spawns) imports neither JAX nor the JAX package,
it never runs on the CPU unless asked to, and only
``flexflow_tpu_torch/parallel/`` calls a ``torch.distributed``
collective, so staging through the host and its count stay in one
place."""

import ast
import pathlib
import subprocess
import sys

import pytest
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

PORT = pathlib.Path(__file__).resolve().parents[1] / "flexflow_tpu_torch"


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts), path


def _is_forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flexflow_tpu", "orbax")


# modules the rules must cover by name (each slice adds its own)
REQUIRED = ("flexflow_tpu_torch.obs", "flexflow_tpu_torch.obs.metrics",
            "flexflow_tpu_torch.obs.trace", "flexflow_tpu_torch.runtime.faults",
            "flexflow_tpu_torch.runtime.retry", "flexflow_tpu_torch.native_bridge",
            "flexflow_tpu_torch.serving.placement", "flexflow_tpu_torch.serving.engine",
            "flexflow_tpu_torch.models.mlp", "flexflow_tpu_torch.ops.structural",
            "flexflow_tpu_torch.ops.conv", "flexflow_tpu_torch.ops.reduce",
            "flexflow_tpu_torch.ops.recurrent", "flexflow_tpu_torch.models.alexnet",
            "flexflow_tpu_torch.models.resnet", "flexflow_tpu_torch.models.resnext",
            "flexflow_tpu_torch.models.inception", "flexflow_tpu_torch.models.dlrm",
            "flexflow_tpu_torch.models.xdl", "flexflow_tpu_torch.models.candle_uno",
            "flexflow_tpu_torch.models.nmt", "flexflow_tpu_torch.ops.fused",
            "flexflow_tpu_torch.keras", "flexflow_tpu_torch.keras.regularizers",
            "flexflow_tpu_torch.runtime.buckets", "flexflow_tpu_torch.runtime.guard",
            "flexflow_tpu_torch.runtime.checkpoint", "flexflow_tpu_torch.runtime.recompile",
            "flexflow_tpu_torch.parallel", "flexflow_tpu_torch.parallel.collectives",
            "flexflow_tpu_torch.parallel.distributed", "flexflow_tpu_torch.parallel.ring_attention",
            "flexflow_tpu_torch.core.machine", "flexflow_tpu_torch.ops.parallel_ops",
            "flexflow_tpu_torch.parallel.schedule", "flexflow_tpu_torch.parallel.pipeline",
            "flexflow_tpu_torch.parallel.pipeline_compiled",
            "flexflow_tpu_torch.parallel.multihost", "flexflow_tpu_torch.parallel.launch",
            "flexflow_tpu_torch.serving.group", "flexflow_tpu_torch.sim",
            "flexflow_tpu_torch.sim.machine_model", "flexflow_tpu_torch.sim.network",
            "flexflow_tpu_torch.sim.cost_model", "flexflow_tpu_torch.sim.simulator",
            "flexflow_tpu_torch.sim.calibrate", "flexflow_tpu_torch.search",
            "flexflow_tpu_torch.search.substitution", "flexflow_tpu_torch.search.unity",
            "flexflow_tpu_torch.search.graph_xfer", "flexflow_tpu_torch.search.mcmc",
            "flexflow_tpu_torch.search.cache", "flexflow_tpu_torch.search.rule_interpreter",
            "flexflow_tpu_torch.analysis", "flexflow_tpu_torch.analysis.findings",
            "flexflow_tpu_torch.analysis.pragmas", "flexflow_tpu_torch.analysis.pcg_check",
            "flexflow_tpu_torch.analysis.strategy_lint",
            "flexflow_tpu_torch.analysis.concurrency_check",
            "flexflow_tpu_torch.analysis.hotpath_lint",
            "flexflow_tpu_torch.analysis.knobflow_check",
            "flexflow_tpu_torch.analysis.program_audit",
            "flexflow_tpu_torch.obs.ledger", "flexflow_tpu_torch.obs.watchdog",
            "flexflow_tpu_torch.obs.exec_telemetry", "flexflow_tpu_torch.obs.divergence",
            "flexflow_tpu_torch.obs.attribution", "flexflow_tpu_torch.obs.advisor",
            "flexflow_tpu_torch.obs.costcorpus", "flexflow_tpu_torch.obs.server",
            "flexflow_tpu_torch.obs.cohort", "flexflow_tpu_torch.runtime.profiling",
            "flexflow_tpu_torch.utils.dot")


def test_rules_cover_the_required_modules():
    names = {name for name, _ in _modules()}
    assert set(REQUIRED) <= names, sorted(set(REQUIRED) - names)


def test_importing_every_port_module_loads_no_jax():
    names = [name for name, _ in _modules()]
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flexflow_tpu', 'orbax'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=PORT.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_source_imports_no_jax():
    offenders = []
    sources = list(_modules()) + [("chip_smoke", PORT.parent / "chip_smoke.py")]
    for name, path in sources:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                found = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                found = [node.module or ""]
            else:
                continue
            offenders += [f"{name}:{node.lineno} imports {n}"
                          for n in found if _is_forbidden(n)]
    assert len(sources) > 20 and not offenders, offenders


ANALYSIS = ("pragmas", "findings", "pcg_check", "strategy_lint", "concurrency_check",
            "hotpath_lint", "knobflow_check", "program_audit")


@pytest.mark.parametrize("name", ANALYSIS)
def test_analysis_modules_are_the_ports_own(name):
    """Each static-analysis module lives in the port and imports neither
    JAX nor the JAX package, not even its pure-AST modules; the gate
    tools beside it are the port's own too."""
    path = PORT / "analysis" / f"{name}.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    found = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    found += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [n for n in found if _is_forbidden(n)], found


@pytest.mark.parametrize("tool", ["torch_pcg_lint", "torch_program_audit",
                                  "torch_concurrency_lint", "torch_knob_lint"])
def test_gate_tools_import_no_jax(tool):
    path = PORT.parent / "tools" / f"{tool}.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    found = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    found += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert "flexflow_tpu_torch.analysis" in " ".join(found)
    assert not [n for n in found if _is_forbidden(n)], found


def test_ffmodel_without_device_cpu_raises_without_a_card():
    import torch

    from flexflow_tpu_torch import FFConfig, FFModel

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FFModel()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FFModel(FFConfig(device="cuda:0"))
    assert FFModel(FFConfig(device="cpu")).device.type == "cpu"


@pytest.mark.parametrize("module", [
    "flexflow_tpu_torch.ops.fused", "flexflow_tpu_torch.keras",
    "flexflow_tpu_torch.keras.regularizers", "flexflow_tpu_torch.runtime.buckets",
    "flexflow_tpu_torch.runtime.guard", "flexflow_tpu_torch.runtime.checkpoint",
    "flexflow_tpu_torch.runtime.recompile"])
def test_training_robustness_modules_import_no_orbax(module):
    """The checkpoint payload is the port's own (torch.save), so no module
    of this layer reads orbax, which the card's machine does not have."""
    path = dict(_modules())[module]
    tree = ast.parse(path.read_text(), filename=str(path))
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n.split(".")[0] == "orbax"]


# torch.distributed's collectives and point-to-point calls
COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
               "reduce_scatter", "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
               "broadcast", "broadcast_object_list", "reduce", "gather", "scatter", "barrier",
               "send", "recv", "isend", "irecv", "batch_isend_irecv", "P2POp"}


def _collective_calls(tree) -> list:
    """(line, name) of each use of a torch.distributed collective: an
    attribute of a name bound to ``torch.distributed`` (``dist.x``,
    ``torch.distributed.x``) or a name imported from it."""
    aliases, names = {"torch.distributed"}, set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            aliases |= {a.asname for a in node.names
                        if a.name == "torch.distributed" and a.asname}
        elif isinstance(node, ast.ImportFrom) and node.module == "torch.distributed":
            names |= {a.asname or a.name for a in node.names if a.name in COLLECTIVES}
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            aliases |= {a.asname or a.name for a in node.names if a.name == "distributed"}
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in COLLECTIVES:
            if ast.unparse(node.value) in aliases:
                found.append((node.lineno, node.attr))
        elif isinstance(node, ast.Name) and node.id in names:
            found.append((node.lineno, node.id))
    return found


def test_only_the_parallel_package_calls_collectives():
    offenders, seen = [], set()
    for name, path in _modules():
        calls = _collective_calls(ast.parse(path.read_text(), filename=str(path)))
        if name.startswith("flexflow_tpu_torch.parallel"):
            seen |= {c for _, c in calls}
        else:
            offenders += [f"{name}:{line} calls {c}" for line, c in calls]
    assert not offenders, offenders
    # the rule sees the calls the collectives module does make
    assert {"all_reduce", "all_gather", "all_to_all_single", "batch_isend_irecv"} <= seen
    bad = ast.parse("import torch.distributed as d\nfrom torch.distributed import all_reduce\n"
                    "d.broadcast(x)\nall_reduce(y)\ntorch.distributed.send(z, 1)\n")
    assert sorted(c for _, c in _collective_calls(bad)) == ["all_reduce", "broadcast", "send"]


def test_a_spawned_rank_loads_no_jax():
    """A rank imports the worker's module by name and the port: no JAX
    (the test process has it loaded; the ranks start afresh)."""
    import _torch_mesh_workers as workers
    from flexflow_tpu_torch.parallel.distributed import spawn

    assert "jax" in sys.modules
    assert spawn(workers.loaded_modules, 2) == [[], []]
