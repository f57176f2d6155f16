"""The HF-aware importer of the port against the JAX package's
(``torch_frontend/hf.py``): a tiny ``BertModel`` and ``GPT2Model`` built
from configs (no weights are downloaded, as ``tests/test_hf_import.py``
builds them) traced by both give equal IR record lists (SDPA decomposed
onto batch_matmul/softmax, buffers folded to constants); the port's
replay with ``copy_weights`` is held to the module and to the JAX
package's replay; the trace patches are restored, also when the trace
raises; and the imported BERT fine-tunes three SGD steps as the JAX
package's does.

Tolerances (f32): forwards 1e-4 relative and 1e-5 absolute (BERT, the
reference's bound) and 1e-5 both (GPT-2); losses 1e-5 relative."""

import sys

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
from transformers import BertConfig, BertModel, GPT2Config, GPT2Model  # noqa: E402
from transformers.models.gpt2.modeling_gpt2 import GPT2Attention  # noqa: E402

import jax  # noqa: E402

from flexflow_tpu import DataType as JDataType  # noqa: E402
from flexflow_tpu import FFConfig as JFFConfig  # noqa: E402
from flexflow_tpu import FFModel as JFFModel  # noqa: E402
from flexflow_tpu import LossType as JLossType  # noqa: E402
from flexflow_tpu import SGDOptimizer as JSGDOptimizer  # noqa: E402
from flexflow_tpu.torch_frontend import PyTorchModel as JPyTorchModel  # noqa: E402
from flexflow_tpu.torch_frontend.model import copy_weights as jcopy_weights  # noqa: E402
from flexflow_tpu_torch import DataType, FFConfig, FFModel, LossType, SGDOptimizer  # noqa: E402
from flexflow_tpu_torch.torch_frontend import PyTorchModel, copy_weights  # noqa: E402

from _torch_ledger import _ledger_in_tmp  # noqa: F401,E402  (records under tmp)

B, S = 2, 8


def _bert():
    torch.manual_seed(0)
    return BertModel(BertConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                                intermediate_size=64, vocab_size=100,
                                max_position_embeddings=16, hidden_dropout_prob=0.0,
                                attention_probs_dropout_prob=0.0)).eval()


def _gpt2():
    torch.manual_seed(0)
    return GPT2Model(GPT2Config(n_embd=32, n_layer=2, n_head=2, vocab_size=100, n_positions=16,
                                resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
                                use_cache=False)).eval()


MODELS = {"bert": (_bert, 1e-4, 1e-5), "gpt2": (_gpt2, 1e-5, 1e-5)}


def _replay(pm, pkg, head=False):
    if pkg == "port":
        ff = FFModel(FFConfig(batch_size=B, seed=0, device="cpu", audit_programs="off"))
        x = ff.create_tensor((B, S), DataType.INT32, name="input_ids")
    else:
        ff = JFFModel(JFFConfig(batch_size=B, seed=0, ledger="off", audit_programs="off",
                                attribution="off"))
        x = ff.create_tensor((B, S), JDataType.INT32, name="input_ids")
    outs = pm.apply(ff, [x])
    out = outs[-1]
    if head:
        out = ff.dense(out, 1, name="reg_head")
    opt = (SGDOptimizer if pkg == "port" else JSGDOptimizer)(lr=0.05)
    loss = (LossType if pkg == "port" else JLossType).MEAN_SQUARED_ERROR_AVG_REDUCE
    ff.compile(optimizer=opt, loss_type=loss if head else None, metrics=[], logits_tensor=out)
    (copy_weights if pkg == "port" else jcopy_weights)(ff, pm.module, pm.module_paths)
    return ff


def _import(name, cls):
    return cls(MODELS[name][0](), input_names=["input_ids"], batch_size=B, seq_length=S)


@pytest.mark.parametrize("name", list(MODELS))
def test_hf_import_ir_and_forward_match_jax(name):
    pm, jpm = _import(name, PyTorchModel), _import(name, JPyTorchModel)
    assert pm.ir == jpm.ir
    ops = {r["op"] for r in pm.ir}
    assert {"dense", "layer_norm", "embedding", "batch_matmul", "softmax"} <= ops
    assert "multihead_attention" not in ops  # SDPA stays decomposed
    ids = np.random.default_rng(0).integers(0, 100, (B, S)).astype(np.int32)
    with torch.no_grad():
        o = pm.module(input_ids=torch.from_numpy(ids.astype(np.int64)))
    want = (o.pooler_output if name == "bert" else o.last_hidden_state).numpy()
    ff, jff = _replay(pm, "port"), _replay(jpm, "jax")
    got = ff.compiled.forward_fn(ff.compiled.params, torch.from_numpy(ids)).numpy()
    jgot = np.asarray(jff.compiled.forward_fn(jff.compiled.params, ids))
    _, rtol, atol = MODELS[name]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got, jgot, rtol=rtol, atol=atol)


def _patched_now():
    masks = {n: m.create_causal_mask for n, m in list(sys.modules.items())
             if n.startswith("transformers") and getattr(m, "create_causal_mask", None)}
    return GPT2Attention.forward, masks


def test_hf_trace_patches_are_restored_also_on_error(monkeypatch):
    before = _patched_now()
    _import("gpt2", PyTorchModel)
    assert _patched_now() == before

    def boom(*a, **k):
        raise RuntimeError("trace failed")

    # the failure comes inside the patched section, after the patches
    monkeypatch.setattr(sys.modules["transformers.utils.fx"], "symbolic_trace", boom)
    with pytest.raises(RuntimeError, match="trace failed"):
        _import("gpt2", PyTorchModel)
    assert _patched_now() == before


def _finetune(pkg, cls):
    pm = _import("bert", cls)
    ff = _replay(pm, pkg, head=True)
    rng = np.random.default_rng(0)
    cm, losses = ff.compiled, []
    # the head is not imported: the same seeded weights in both packages
    head = {"kernel": rng.normal(size=(32, 1)).astype(np.float32) * 0.2,
            "bias": np.zeros(1, np.float32)}
    for w, a in head.items():
        if pkg == "port":
            cm.params["reg_head"][w].copy_(torch.from_numpy(a))
        else:
            cm.params["reg_head"][w] = jax.numpy.asarray(a)
    for _ in range(3):
        ids = rng.integers(0, 100, (B, S)).astype(np.int32)
        y = rng.normal(size=(B, 1)).astype(np.float32)
        if pkg == "port":
            cm.params, cm.opt_state, l, _ = cm.train_step(
                cm.params, cm.opt_state, None, torch.from_numpy(ids), torch.from_numpy(y))
        else:
            cm.params, cm.opt_state, l, _ = cm.train_step(
                cm.params, cm.opt_state, jax.random.key(0), ids, y)
        losses.append(float(l))
    return losses


def test_hf_bert_finetunes_like_jax():
    np.testing.assert_allclose(_finetune("port", PyTorchModel),
                               _finetune("jax", JPyTorchModel), rtol=1e-5)
