"""Rules the port keeps: it (and chip_smoke.py, which drives it on the
card) imports neither JAX nor the JAX package, and it never runs on the
CPU unless asked to."""

import ast
import pathlib
import subprocess
import sys

import pytest

PORT = pathlib.Path(__file__).resolve().parents[1] / "flexflow_tpu_torch"


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts), path


def _is_forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flexflow_tpu")


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
            "flexflow_tpu_torch.models.nmt")


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
        "('jax', 'jaxlib', 'flexflow_tpu'))\n"
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
