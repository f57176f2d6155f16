"""The port's program audit: the recorded aten stream of one real call.

Seeded steps (a fixture module whose source lines the pragmas anchor on)
fire each of AUD001-AUD005 and a pragma (``allow_undonated`` for the
recorded AUD002) suppresses each; AUD000 is a call that raises; AUD006's
absence is the departure against the JAX audit. Then the gate: the
builders' programs against the JAX audit's codes, ``ProgramAuditError``,
the dense and paged decode audits, the pipeline's first-dispatch audit,
``audit_profile`` in the compile ledger record, OBS002 on the audit's
estimate, and a ``fit`` with the gate on equal to one with it off, bit
for bit."""

import importlib.util
import json
import textwrap

import numpy as np
import pytest
import torch
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)

import flexflow_tpu as J
import flexflow_tpu_torch as T
from flexflow_tpu_torch.analysis import ProgramAuditError
from flexflow_tpu_torch.analysis import program_audit as PA
from flexflow_tpu_torch.models import (GPTConfig, MoeConfig, TransformerConfig,
                                       build_gpt, build_moe_mnist, zoo_smoke_builders)
from flexflow_tpu_torch.models.transformer import build_bert_proxy, build_transformer

_FIXTURE = '''
import torch

from flexflow_tpu_torch.parallel import collectives as C

BIG = torch.ones(512, 1024)


class _Group:
    ranks = (0, 1, 2)
    index = 0
    size = 3


def aud001(x):
    return x + BIG{p1}


def aud002(state, x):
    state["w"] = state["w"] * 2
    return state, x.sum()


def aud003(x):
    s = x.sum().item(){p3}
    return x * s


def aud004(xs):
    acc = torch.zeros(4, dtype=torch.bfloat16)
    for x in xs:
        acc = acc + x{p4}
    return acc


def aud005(x):
    C._count(0, "shift", _Group(), [(0, 1), (1, 1), (2, 0)]){p5}
    return x * 2


def clean(x):
    y = x * 2
    return y + 1


def boom(x):
    raise ValueError("fixture refuses to run")
'''
_PRAGMAS = {"p1": "  # audit: const-ok (fixture)", "p3": "  # audit: callback-ok (fixture)",
            "p4": "  # audit: accum-ok (fixture)", "p5": "  # audit: collective-ok (fixture)"}


def _fixture(tmp_path, monkeypatch, pragma: bool):
    name = "fixture_pragma" if pragma else "fixture_plain"
    path = tmp_path / f"{name}.py"
    path.write_text(_FIXTURE.format(**{k: (v if pragma else "") for k, v in _PRAGMAS.items()}))
    monkeypatch.setattr(PA, "SOURCE_ROOTS", PA.SOURCE_ROOTS + [str(tmp_path)])
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _audit(fn, args, donated=(), **kw):
    spec = PA.ExecutableSpec(fn.__name__, fn, make_args=lambda: args, donated=donated, **kw)
    return PA.audit_spec(spec)


def _seeded(mod):
    x = torch.ones(4)
    return {
        "AUD001": _audit(mod.aud001, (torch.ones(512, 1024),)),
        "AUD002": _audit(mod.aud002, ({"w": torch.ones(512, 1024)}, x), donated=(0,)),
        "AUD003": _audit(mod.aud003, (x,)),
        "AUD004": _audit(mod.aud004, ([x.bfloat16()] * 3,)),
        "AUD005": _audit(mod.aud005, (x,)),
    }


def test_each_seeded_step_fires_its_code(tmp_path, monkeypatch):
    mod = _fixture(tmp_path, monkeypatch, pragma=False)
    for code, rep in _seeded(mod).items():
        assert rep.codes() == [code], (code, rep.format())
        f = rep.findings[0]
        if code != "AUD002":   # the recorded AUD002 names a state path, not a line
            assert f.file.endswith("fixture_plain.py") and f.line, f.format()
    assert _audit(mod.clean, (torch.ones(4),)).codes() == []
    sev = {c: r.findings[0].severity for c, r in _seeded(mod).items()}
    assert sev == {"AUD001": "warning", "AUD002": "warning", "AUD003": "error",
                   "AUD004": "error", "AUD005": "error"}


def test_each_pragma_suppresses_its_code(tmp_path, monkeypatch):
    mod = _fixture(tmp_path, monkeypatch, pragma=True)
    reps = _seeded(mod)
    for code in ("AUD001", "AUD003", "AUD004", "AUD005"):
        assert reps[code].codes() == [], reps[code].format()
        assert reps[code].programs[f"aud00{code[-1]}"]["suppressed"] == 1
    # the recorded AUD002 is waived as in the JAX package: allow_undonated
    waived = _audit(mod.aud002, ({"w": torch.ones(512, 1024)}, torch.ones(4)),
                    donated=(0,), allow_undonated={"['w']": "fixture"})
    assert waived.codes() == [] and waived.programs["aud002"]["suppressed"] == 1
    # the suppressed host round trip still counts at its site
    assert list(reps["AUD003"].programs["aud003"]["host_syncs"].values()) == [1]


def test_reasonless_pragma_does_not_suppress(tmp_path, monkeypatch):
    mod = _fixture(tmp_path, monkeypatch, pragma=False)
    path = tmp_path / "fixture_plain.py"
    path.write_text(path.read_text().replace(".item()", ".item()  # audit: callback-ok"))
    assert _audit(mod.aud003, (torch.ones(4),)).codes() == ["AUD003"]


def test_aud000_on_a_call_that_raises(tmp_path, monkeypatch):
    mod = _fixture(tmp_path, monkeypatch, pragma=False)
    rep = _audit(mod.boom, (torch.ones(4),))
    assert [(f.code, f.severity) for f in rep.findings] == [("AUD000", "warning")]
    assert rep.programs["boom"]["trace_failed"] and "refuses" in rep.findings[0].message


def test_data_dependent_shapes_and_host_copies_are_aud003(tmp_path, monkeypatch):
    monkeypatch.setattr(PA, "SOURCE_ROOTS", PA.SOURCE_ROOTS + [str(tmp_path)])

    def step(x, r):
        a = torch.nonzero(x)
        b = torch.repeat_interleave(x, r)
        c = torch.repeat_interleave(x, r, output_size=int(r.sum()))
        return a, b, c

    rec, out, _ = PA.record_call(step, (torch.arange(4.0), torch.tensor([1, 2, 0, 1])))
    rep = PA.audit_recorded("dd", rec, out)
    # nonzero, the repeat_interleave without output_size, and int(r.sum())
    assert rep.codes() == ["AUD003", "AUD003", "AUD003"], rep.format()


def test_stage_sequences_disagreeing_is_aud005():
    rep = PA.ValidationReport(tag="audit")
    PA.check_stage_sequences("pipe", {0: (("send_recv", 2),), 1: (("send_recv", 2),)}, rep)
    assert rep.codes() == []
    PA.check_stage_sequences("pipe", {0: (("send_recv", 2), ("all_reduce", 2)),
                                      1: (("send_recv", 2),)}, rep)
    assert rep.codes() == ["AUD005"] and "stage 0" in rep.findings[0].message


def test_p2p_table_checks():
    assert PA.p2p_problem([(1, 11), (1, 12)], 2) is None
    assert "out of range" in PA.p2p_problem([(2, 11)], 2)
    assert "duplicate" in PA.p2p_problem([(1, 11), (1, 11)], 2)
    assert PA.perm_problem([(0, 1), (1, 0)], 2) is None


def test_aud006_departure_against_the_jax_audit():
    """The JAX audit fires AUD006 on a weak-typed scalar a jitted step
    closes over (mutating it would replay the stale executable). The
    port's eager step reads its closure on every call: the recording
    has no AUD006 and the step sees the new value."""
    import jax
    import jax.numpy as jnp

    from flexflow_tpu.analysis.program_audit import audit_traced

    lr = jnp.asarray(0.125)
    jrep = audit_traced("fix6", jax.jit(lambda x: x * lr).trace(
        jax.ShapeDtypeStruct((4,), jnp.float32)))
    assert jrep.codes() == ["AUD006"]
    box = {"lr": 0.125}

    def step(x):
        return x * box["lr"]

    rec, out, _ = PA.record_call(step, (torch.ones(4),))
    assert PA.audit_recorded("fix6", rec, out).codes() == []
    box["lr"] = 0.5
    assert float(step(torch.ones(4))[0]) == 0.5
    assert "AUD006" in T.analysis.CODE_CATALOG


def test_donated_reuse_lint_against_the_jax_lint():
    from flexflow_tpu.analysis.program_audit import lint_donated_reuse as jlint

    reuse = ("def run(cm, params, state, rng, x, y):\n"
             "    loss = cm.train_step(params, state, rng, x, y)\n"
             "    return loss, params['w']{}\n")
    for src in (reuse.format(""), reuse.format("  # audit: donate-ok (host copy first)"),
                "def run(cm, params, state, rng, x, y):\n"
                "    params, state, loss = cm.train_step(params, state, rng, x, y)\n"
                "    return loss, params\n"):
        assert [(f.code, f.line) for f in PA.lint_donated_reuse(src)] == \
            [(f.code, f.line) for f in jlint(src)]
    # departure: the port's eval_step updates nothing in place, so reading
    # its label after the call is no reuse (the JAX eval donates it)
    ev = "def run(cm, p, x, y):\n    out = cm.eval_step(p, x, y)\n    return y.mean()\n"
    assert [f.code for f in jlint(ev)] == ["AUD002"] and PA.lint_donated_reuse(ev) == []


# ------------------------------------------------------ the builders
def _tf_cfg():
    return TransformerConfig(hidden_size=32, embedding_size=32, num_heads=4, num_layers=2,
                             sequence_length=8)


def _builders():
    from flexflow_tpu.models import GPTConfig as JGPTConfig
    from flexflow_tpu.models import MoeConfig as JMoeConfig
    from flexflow_tpu.models import build_gpt as jbuild_gpt
    from flexflow_tpu.models import build_moe_mnist as jbuild_moe
    from flexflow_tpu.models import zoo_smoke_builders as jzoo
    from flexflow_tpu.models.transformer import TransformerConfig as JTC
    from flexflow_tpu.models.transformer import build_bert_proxy as jbert
    from flexflow_tpu.models.transformer import build_transformer as jtf

    gpt = dict(vocab_size=64, max_positions=32, hidden_size=32, num_heads=4, num_layers=2)
    moe = dict(input_dim=16, num_exp=4, num_select=2, expert_hidden_size=16)
    tf = dict(hidden_size=32, embedding_size=32, num_heads=4, num_layers=2, sequence_length=8)
    out = {
        "transformer": (lambda ff: jtf(ff, 8, JTC(**tf)),
                        lambda ff: build_transformer(ff, 8, TransformerConfig(**tf))),
        "gpt": (lambda ff: jbuild_gpt(ff, 8, 16, JGPTConfig(**gpt)),
                lambda ff: build_gpt(ff, 8, 16, GPTConfig(**gpt))),
        "bert_proxy": (lambda ff: jbert(ff, 8, JTC(**tf)),
                       lambda ff: build_bert_proxy(ff, 8, TransformerConfig(**tf))),
        "moe_mnist": (lambda ff: jbuild_moe(ff, 8, JMoeConfig(**moe)),
                      lambda ff: build_moe_mnist(ff, 8, MoeConfig(**moe))),
    }
    jz, tz = jzoo(), zoo_smoke_builders()
    # the three convolution nets take tens of seconds a compile on this
    # CPU; tools/torch_program_audit.py sweeps them
    for name in sorted(set(tz) - {"inception_v3", "resnet50", "resnext50"}):
        out[f"zoo:{name}"] = (lambda ff, n=name: jz[n](ff, 8), lambda ff, n=name: tz[n](ff, 8))
    return out


BUILDERS = _builders()
# the JAX audit's AUD004 on the bf16 LSTM: its scan's transpose carries
# the recurrent kernel's gradient in bf16 across the timesteps. The port
# unrolls the recurrence in Python and autograd sums that gradient; the
# engine's fan-in sums are outside the port's AUD004 (program_audit.py)
AUD_DEPARTURES = {("zoo:nmt", "bfloat16"): {"AUD004"}}


@pytest.mark.parametrize("name", sorted(BUILDERS))
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_builder_programs_give_the_jax_audits_codes(name, dtype):
    """Each builder compiled under audit_programs="warn" in both packages
    (f32 and bf16): the port's codes equal the JAX audit's, both clean of
    errors. The JAX audit's AUD002 warnings on undonated arguments have
    no counterpart: the port's steps update their state in place."""
    jb, tb = BUILDERS[name]
    kw = {"compute_dtype": dtype} if dtype else {}
    jff = J.FFModel(J.FFConfig(batch_size=8, audit_programs="warn", **kw))
    jb(jff)
    jff.compile(J.SGDOptimizer(lr=0.01), J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    ff = T.FFModel(T.FFConfig(batch_size=8, device="cpu", audit_programs="warn", **kw))
    tb(ff)
    ff.compile(T.SGDOptimizer(lr=0.01), T.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    want = set(jff.audit_report.codes()) - {"AUD002"} - AUD_DEPARTURES.get((name, dtype), set())
    assert sorted(set(ff.audit_report.codes())) == sorted(want), ff.audit_report.format()
    assert not ff.audit_report.errors
    progs = ff.audit_profile["programs"]
    assert set(progs) == {"train_step", "eval_step"}
    assert progs["train_step"]["donated_args"] > 0 and progs["train_step"]["ops"] > 0


def test_compile_raises_program_audit_error(monkeypatch):
    """A host round trip in the training step fails the default gate."""
    from flexflow_tpu_torch.runtime import compiler

    real = compiler.compute_loss

    def syncing(*a, **kw):
        loss = real(*a, **kw)
        float(loss.detach())
        return loss

    monkeypatch.setattr(compiler, "compute_loss", syncing)
    ff = T.FFModel(T.FFConfig(batch_size=8, device="cpu"))
    build_transformer(ff, 8, _tf_cfg())
    with pytest.raises(ProgramAuditError) as ei:
        ff.compile(T.SGDOptimizer(lr=0.01), T.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    assert "AUD003" in str(ei.value) and "runtime/compiler.py" in str(ei.value)
    assert isinstance(ei.value, T.PCGValidationError)
    ff = T.FFModel(T.FFConfig(batch_size=8, device="cpu", audit_programs="off"))
    build_transformer(ff, 8, _tf_cfg())
    ff.compile(T.SGDOptimizer(lr=0.01), T.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    assert ff.audit_report is None and ff.audit_profile is None


def test_train_k_steps_and_the_inference_forward_are_audited():
    ff = T.FFModel(T.FFConfig(batch_size=8, device="cpu", steps_per_dispatch=3))
    build_transformer(ff, 8, _tf_cfg())
    ff.compile(T.SGDOptimizer(lr=0.01), T.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    assert set(ff.audit_profile["programs"]) == {"train_step", "train_k_steps", "eval_step"}
    inf = T.FFModel(T.FFConfig(batch_size=8, device="cpu",
                               computation_mode=T.CompMode.INFERENCE))
    build_transformer(inf, 8, _tf_cfg())
    inf.compile()
    assert set(inf.audit_profile["programs"]) == {"forward"}


# ------------------------------------------------------ serving
def _gpt_lm(**cfg):
    ff = T.FFModel(T.FFConfig(batch_size=2, device="cpu", computation_mode=T.CompMode.INFERENCE,
                              **cfg))
    build_gpt(ff, 2, 8, GPTConfig(vocab_size=50, max_positions=32, hidden_size=32,
                                  num_heads=4, num_layers=2))
    ff.compile()
    return ff


def test_dense_decode_step_is_audited():
    from flexflow_tpu_torch.serving import Generator

    ff = _gpt_lm()
    gen = Generator(ff, max_length=16)
    rep = gen.audit_report
    assert rep is not None and rep.ok(), rep.format()
    st = rep.programs["serving.decode_step"]
    assert st["ops"] > 0 and st["static_peak_bytes"] > 0
    prompt = np.array([[3, 4, 5], [6, 7, 8]], np.int32)
    out = gen.generate(prompt, 4)
    off = Generator(_gpt_lm(audit_programs="off"), max_length=16)
    assert off.audit_report is None
    np.testing.assert_array_equal(out, off.generate(prompt, 4))


def test_paged_decode_step_is_audited_on_a_scratch_pool():
    from flexflow_tpu_torch.serving.generation import PagedDecoder

    ff = _gpt_lm()
    dec = PagedDecoder(ff, 16, decode_slots=2, block_size=4)
    rep = dec.audit_report
    assert rep is not None and rep.ok(), rep.format()
    assert rep.programs["serving.paged_decode_step"]["ops"] > 0
    # the decoder's own pool and counters are as a fresh one's
    fresh = PagedDecoder(_gpt_lm(audit_programs="off"), 16, decode_slots=2, block_size=4)
    assert dec.decode_steps == dec.decode_dispatches == 0
    assert dec.pool.num_blocks == fresh.pool.num_blocks
    for name, kv in dec.pool.kv.items():
        for a, b in zip(kv, fresh.pool.kv[name]):
            assert torch.equal(a, b)


def _sync_after(real):
    """``real`` followed by a host round trip inside the same call."""
    def step(*a, **kw):
        out = real(*a, **kw)
        float(out.sum())
        return out

    return step


@pytest.mark.parametrize("decoder", ["dense", "paged"])
@pytest.mark.parametrize("mode", ["error", "warn"])
def test_decode_audit_finding_applies_the_gate_mode(decoder, mode, monkeypatch, capsys):
    """A host round trip seeded in the decode step is AUD003: the default
    gate raises ProgramAuditError at the decoder's construction, "warn"
    prints the finding and goes on."""
    from flexflow_tpu_torch.serving import Generator
    from flexflow_tpu_torch.serving.generation import PagedDecoder

    cls, attr = (Generator, "_step") if decoder == "dense" else (PagedDecoder, "_decode_step")
    monkeypatch.setattr(cls, attr, _sync_after(getattr(cls, attr)))
    ff = _gpt_lm(audit_programs=mode)
    make = (lambda: Generator(ff, max_length=16)) if decoder == "dense" else \
        (lambda: PagedDecoder(ff, 16, decode_slots=2, block_size=4))
    if mode == "error":
        with pytest.raises(ProgramAuditError, match="AUD003"):
            make()
        return
    dec = make()
    assert "AUD003" in dec.audit_report.codes()
    assert "[audit]" in capsys.readouterr().out


# ------------------------------------------------------ the pipeline
def test_pipeline_first_dispatch_is_audited_and_changes_nothing():
    import _torch_mesh_workers as workers
    from flexflow_tpu_torch.parallel.distributed import spawn

    rng = np.random.default_rng(0)
    shape = dict(hidden_size=32, embedding_size=32, num_heads=4, num_layers=2,
                 sequence_length=8)
    x = rng.standard_normal((8, 8, 32)).astype(np.float32)
    y = rng.standard_normal((8, 8, 1)).astype(np.float32)
    on = spawn(workers.pipe_audit, 2, "error", shape, x, y)
    off = spawn(workers.pipe_audit, 2, "off", shape, x, y)
    for r_on, r_off in zip(on, off):
        assert r_on["engine"] == "compiled" and r_off["programs"] is None
        assert r_on["loss"] == r_off["loss"]
        for op, ws in r_on["params"].items():
            for w, a in ws.items():
                np.testing.assert_array_equal(a, r_off["params"][op][w])
        # the compiled model's own train steps are not recorded under a
        # pipeline engine; the engine's program is, at its first call
        assert "train_step" not in r_on["compile_programs"]
        st = r_on["programs"]["pipeline.1f1b"]
        assert r_on["codes"] == [] and st["collectives"] > 0
        # the compile's recordings (side calls) leave the process-wide
        # collective counts as they were; the recorded first dispatch is
        # a real step and counts there as well as on its recording
        assert r_on["compile_calls"] == r_off["compile_calls"]
        assert r_on["step_calls"] == r_off["step_calls"] == st["collectives"]
        assert {k for k, _ in st["collective_sequence"]} >= {"send_recv"}


def test_pipeline_first_dispatch_applies_the_gate_and_never_reruns():
    """Stages whose recorded first steps issue different collective
    sequences fail the default gate on every rank (AUD005); a recorded
    step that raises surfaces its own error, after every rank has joined
    the sequence gather, and is not run a second time."""
    import _torch_mesh_workers as workers
    from flexflow_tpu_torch.parallel.distributed import spawn

    rng = np.random.default_rng(0)
    shape = dict(hidden_size=32, embedding_size=32, num_heads=4, num_layers=2,
                 sequence_length=8)
    x = rng.standard_normal((8, 8, 32)).astype(np.float32)
    y = rng.standard_normal((8, 8, 1)).astype(np.float32)
    for r in spawn(workers.pipe_audit_fault, 2, "mismatch", shape, x, y):
        assert r["raised"] == "ProgramAuditError" and "AUD005" in r["msg"], r
        assert r["runs"] == 1 and "AUD005" in r["codes"]
    for r in spawn(workers.pipe_audit_fault, 2, "raise", shape, x, y):
        assert r["raised"] == "RuntimeError" and "seeded step fault" in r["msg"], r
        assert r["runs"] == 1 and r["codes"] == ["AUD000"]


# --------------------------------------- ledger, OBS002, bit-for-bit fit
def test_audit_profile_lands_in_the_compile_ledger_record(tmp_path, monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_LEDGER_DIR", str(tmp_path))
    ff = T.FFModel(T.FFConfig(batch_size=8, device="cpu"))
    build_transformer(ff, 8, _tf_cfg())
    ff.compile(T.SGDOptimizer(lr=0.01), T.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    recs = [json.loads(l) for p in tmp_path.rglob("*.jsonl") for l in p.read_text().splitlines()]
    comp = [r for r in recs if r.get("kind") == "compile"][-1]
    assert comp["audit"]["programs"] == ["eval_step", "train_step"]
    assert comp["audit"]["errors"] == 0 and comp["audit"]["record_s"] > 0
    assert ff.audit_profile["walk_s"] < ff.audit_profile["wall_time_s"]


def test_obs002_reconciles_against_the_audits_estimate(monkeypatch, capsys):
    """With the telemetry on, its measured grad_step is the audit's
    recording of that program, and OBS002 holds the measured peak (faked
    here: the CPU reads none) against the audit's static peak."""
    from flexflow_tpu_torch.obs import exec_telemetry as et

    real = et.collect_traced

    def with_peak(name, step, device):
        out = real(name, step, device)
        out["peak_bytes"] = 10 ** 12
        return out

    monkeypatch.setattr(et, "collect_traced", with_peak)
    ff = T.FFModel(T.FFConfig(batch_size=8, device="cpu", exec_telemetry="on"))
    build_transformer(ff, 8, _tf_cfg())
    ff.compile(T.SGDOptimizer(lr=0.01), T.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    static = ff.audit_report.programs["grad_step"]["static_peak_bytes"]
    [row] = ff.exec_telemetry["reconciliation"]
    assert row["static_peak_bytes"] == static and row["finding"]["code"] == "OBS002"
    assert "[obs] OBS002" in capsys.readouterr().out
    # without the audit the estimate is the simulator's, as before
    ff2 = T.FFModel(T.FFConfig(batch_size=8, device="cpu", exec_telemetry="on",
                               audit_programs="off"))
    build_transformer(ff2, 8, _tf_cfg())
    ff2.compile(T.SGDOptimizer(lr=0.01), T.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    assert ff2.exec_telemetry["reconciliation"][0]["static_peak_bytes"] == \
        et.static_peak_bytes(ff2)


def _fit_params(build, mode, x, y, loss, opt, **cfg):
    ff = T.FFModel(T.FFConfig(batch_size=8, device="cpu", audit_programs=mode, **cfg))
    build(ff)
    ff.compile(opt(), loss)
    ff.fit(x, y, epochs=2, verbose=False)
    return ff.numpy_params(), ff.compiled.iteration


@pytest.mark.parametrize("case", ["gpt_f32", "gpt_bf16_adam", "transformer_dropout",
                                  "moe", "bn_conv"])
def test_fit_with_the_gate_on_equals_off_bit_for_bit(case):
    rng = np.random.default_rng(0)
    sgd = lambda: T.SGDOptimizer(lr=0.05, momentum=0.9)   # noqa: E731
    adam = lambda: T.AdamOptimizer(alpha=0.01)             # noqa: E731
    mse, sce = (T.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                T.LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    gcfg = GPTConfig(vocab_size=50, max_positions=32, hidden_size=32, num_heads=4,
                     num_layers=2)
    toks = rng.integers(0, 50, (16, 8)).astype(np.int32)
    pos = np.tile(np.arange(8, dtype=np.int32), (16, 1))
    if case.startswith("gpt"):
        build = lambda ff: build_gpt(ff, 8, 8, gcfg)       # noqa: E731
        x, y, loss = [toks, pos], np.roll(toks, -1, 1), sce
        opt, cfg = (adam, {"compute_dtype": "bfloat16"}) if "bf16" in case else (sgd, {})
    elif case == "transformer_dropout":
        def build(ff):
            t = ff.create_tensor((8, 8, 32), name="input")
            t = ff.multihead_attention(t, t, t, 32, 4, dropout=0.25, name="attn")
            t = ff.dropout(ff.dense(t, 32, T.ActiMode.RELU, name="ff"), 0.3, name="drop")
            ff.dense(t, 1, name="head")
        x = rng.standard_normal((16, 8, 32)).astype(np.float32)
        y, loss, opt, cfg = rng.standard_normal((16, 8, 1)).astype(np.float32), mse, sgd, {}
    elif case == "moe":
        build = lambda ff: build_moe_mnist(ff, 8, MoeConfig(   # noqa: E731
            input_dim=16, num_exp=4, num_select=2, expert_hidden_size=16))
        x = rng.standard_normal((16, 16)).astype(np.float32)
        y, loss, opt, cfg = rng.integers(0, 10, (16, 1)).astype(np.int32), sce, adam, {}
    else:
        def build(ff):
            t = ff.create_tensor((8, 3, 8, 8), name="img")
            t = ff.conv2d(t, 4, 3, 3, 1, 1, 1, 1, name="c1")
            t = ff.batch_norm(t, name="bn")
            ff.dense(ff.flat(t), 3, name="head")
        x = rng.standard_normal((16, 3, 8, 8)).astype(np.float32)
        y, loss, opt, cfg = rng.standard_normal((16, 3)).astype(np.float32), mse, sgd, {}
    on = _fit_params(build, "error", x, y, loss, opt, **cfg)
    off = _fit_params(build, "off", x, y, loss, opt, **cfg)
    assert on[1] == off[1]
    for op, ws in on[0].items():
        for w, a in ws.items():
            np.testing.assert_array_equal(a, off[0][op][w], err_msg=f"{op}.{w}")
