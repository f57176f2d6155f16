"""Serving on more than one card: an instance group of two, one instance
a card (``InferenceEngine.register_built_instances``). Marked ``cuda``; it
skips without two cards. The file imports no JAX, so the card's machine
runs it with ``--noconftest``."""

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.models import build_mlp
from flexflow_tpu_torch.serving import InferenceEngine
from _torch_ledger import _ledger_in_tmp  # noqa: F401  (records under tmp)


@pytest.mark.cuda
def test_two_instances_on_two_cards():
    """An instance group of two, one instance a card, serving one burst
    (each answer as one direct forward of instance 0 gives it)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    eng = InferenceEngine(batch_timeout_s=0.005)
    insts = eng.register_built_instances(lambda ff, bs: build_mlp(ff, bs, in_dim=8,
                                                                  hidden_dims=(16,),
                                                                  num_classes=4),
                                         "m", ["cuda:0", "cuda:1"], batch_size=4)
    assert [i.devices for i in insts] == [frozenset({torch.device("cuda", 0)}),
                                          frozenset({torch.device("cuda", 1)})]
    xs = np.random.default_rng(6).normal(size=(32, 8)).astype(np.float32)
    futs = [eng.infer_async("m", [x]) for x in xs]
    got = np.stack([f.result(120) for f in futs])
    eng.stop()
    cm = insts[0]._cm
    want = np.concatenate([cm.forward_fn(cm.params, torch.from_numpy(xs[i:i + 4]).cuda())
                           .cpu().numpy() for i in range(0, 32, 4)])
    # the same f32 graph on two cards of one kind, batches cut differently
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert all(i.dispatches > 0 for i in insts)
