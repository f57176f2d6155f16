"""The port's flat C model-building API (``flexflow_tpu_torch/native/
model_capi.cc``, the ABI of ``native/include/flexflow_tpu_c.h``), held to
``tests/test_c_api.py``'s C program: ``examples/c/mlp_train.c`` compiled
with gcc against the library the port builds itself
(``native_bridge.build_capi``, never the reference's ``make -C native
capi``) and run as a real C program in its own process. A ``jax``
package that records its import and raises goes first on the program's
``PYTHONPATH``: the process must never import it. On the CPU
(``FLEXFLOW_TPU_DEVICE=cpu``) the program trains to well above chance;
the Python side's helpers are held to the JAX package's ``capi_host``
(the same model, seeded weights copied across, one eval's accuracy and
summed loss within 1e-5 relative)."""

import os
import shutil
import subprocess

import numpy as np
import pytest

from flexflow_tpu_torch import native_bridge

from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "examples", "c", "mlp_train.c")

pytestmark = pytest.mark.skipif(shutil.which("gcc") is None or shutil.which("g++") is None,
                                reason="no C toolchain")


@pytest.fixture(scope="module")
def c_program(tmp_path_factory):
    lib = native_bridge.build_capi()
    assert lib.parent == native_bridge.BUILD_DIR
    out = str(tmp_path_factory.mktemp("capi") / "mlp_train")
    subprocess.run(["gcc", DEMO, f"-I{ROOT}/native/include", str(lib),
                    f"-Wl,-rpath,{lib.parent}", "-o", out], check=True, capture_output=True)
    return out


def test_c_program_trains_through_the_ports_library_without_jax(c_program, tmp_path):
    fake = tmp_path / "fakejax" / "jax"
    fake.mkdir(parents=True)
    marker = tmp_path / "jax_imported"
    (fake / "__init__.py").write_text(
        f"open({str(marker)!r}, 'w').close()\n"
        "raise ImportError('the port imported jax')\n")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=f"{fake.parent}{os.pathsep}{ROOT}", FLEXFLOW_TPU_DEVICE="cpu",
               FLEXFLOW_TPU_LEDGER_DIR=str(tmp_path / "ledger"))
    proc = subprocess.run([c_program], env=env, capture_output=True, text=True, timeout=600,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, (proc.stdout, proc.stderr[-2000:])
    assert not marker.exists(), "the C program's interpreter imported jax"
    words = proc.stdout.split()
    assert words[0] == "ACCURACY" and words[2] == "LOSS", proc.stdout
    assert float(words[1]) > 0.5  # learned well beyond 1/4 chance
    assert float(words[3]) > 0.0  # the loss metric flowed back through the C surface


def test_capi_host_helpers_match_jax():
    """The helpers the C surface calls, in both packages: the same MLP
    (reference enum values), the JAX package's initial weights copied
    into the port, one eval's [accuracy, summed loss] and a forward."""
    from flexflow_tpu import capi_host as jhost
    from flexflow_tpu_torch import capi_host as phost
    from flexflow_tpu_torch import load_numpy_params

    rng = np.random.default_rng(4)
    x = rng.uniform(-0.5, 0.5, size=(64, 32)).astype(np.float32)
    y = np.argmax(x[:, :4], axis=1).astype(np.int32)
    models = {}
    for name, host in (("jax", jhost), ("port", phost)):
        if name == "port":
            os.environ["FLEXFLOW_TPU_DEVICE"] = "cpu"
        try:
            m = host.model_create(32, 1, 0, 1, 0)
        finally:
            os.environ.pop("FLEXFLOW_TPU_DEVICE", None)
        if name == "jax":
            m.config.ledger, m.config.audit_programs = "off", "off"
        t = host.create_tensor(m, (64, 32), 0)
        h = host.dense(m, t, 16, 11, 1)
        host.dense(m, h, 4, 10, 1)
        host.compile_model(m, "sgd", 0.2, "sparse_categorical_crossentropy",
                           "accuracy,sparse_categorical_crossentropy")
        models[name] = (host, m)
    # the layers' generated names follow each package's own counters:
    # pair them by order
    jff, pff = models["jax"][1], models["port"][1]
    jp = jff.compiled.params
    pairs = zip([l.name for l in jff.layers if l.name in jp],
                [l.name for l in pff.layers if l.name in pff.compiled.params])
    load_numpy_params(pff, {pn: {w: np.asarray(a) for w, a in jp[jn].items()}
                            for jn, pn in pairs})
    got = {}
    for name, (host, m) in models.items():
        xb, yb = memoryview(x.tobytes()), memoryview(y.tobytes())
        ev = host.evaluate(m, [xb], [(64, 32)], yb, (64,), 1)
        out = np.zeros(64 * 4, np.float32)
        host.forward(m, [xb], [(64, 32)], memoryview(out))
        got[name] = (ev, out)
    assert got["port"][0][0] == got["jax"][0][0]
    np.testing.assert_allclose(got["port"][0][1], got["jax"][0][1], rtol=1e-5)
    np.testing.assert_allclose(got["port"][1], got["jax"][1], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="one device"):
        phost.model_create(32, 1, 2, 1, 0)
