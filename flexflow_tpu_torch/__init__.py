"""flexflow_tpu_torch: the PyTorch/CUDA port of flexflow_tpu for NVIDIA Hopper.

The JAX package ``flexflow_tpu`` is the reference; this package follows its
layout and names module by module, in PyTorch's idiom, and imports neither
JAX nor ``flexflow_tpu``. Its Pallas TPU kernels become hand-written CUDA
kernels for ``sm_90a`` under ``kernels/csrc``, built at first use.

Ported so far, for the reference Transformer
(``models.transformer.build_transformer``): classic one-shot inference
through ``serving.engine.InferenceEngine`` with the flash-attention forward
kernel, and training through ``FFModel.compile`` -> ``fit``/``eval`` (SGD or
Adam, the five losses) with the flash-attention backward kernels; for
the mixture-of-experts model (``models.moe.build_moe_mnist``), serving and
training through the same entry points with the MoE row-gather kernels;
and for the GPT causal LM (``models.gpt.build_gpt``) and the BERT proxy
(``models.transformer.build_bert_proxy``), built on the LayerNorm,
embedding, elementwise and dropout ops, training through the same entry
points and, for GPT, generation through the dense KV-cache
``serving.generation.Generator`` and continuous batching over a paged KV
pool. Serving also has the reference's breadth: instance groups, the
model repository (``serving.placement.load_repository``), the native
batcher (``native_bridge``), admission bounds, deadlines, the failure
breaker and worker respawn, driven by the fault plan
(``runtime.faults``, ``FFConfig.fault_plan``) and observed through the
metrics registry and the span tracer (``obs``, ``FFConfig.trace``).
The rest of the zoo (AlexNet, ResNet-50 with batch norm, ResNeXt-50,
Inception-v3, DLRM, XDL, CANDLE-Uno and the LSTM NMT model; every
``models.zoo_smoke_builders()`` entry) trains and serves through the same
entry points, on the structural, reduce, convolution, pooling,
batch-norm and recurrent ops (cuDNN and cuBLAS through stock torch, as
they are XLA, not Pallas, in the reference).
"""

from .config import FFConfig
from .ffconst import (ActiMode, AggrMode, CompMode, DataType, LossType, MetricsType,
                      OpType)
from .runtime.model import FFModel, load_numpy_params
from .runtime.optimizer import AdamOptimizer, SGDOptimizer

__all__ = ["ActiMode", "AdamOptimizer", "AggrMode", "CompMode", "DataType", "FFConfig",
           "FFModel", "LossType", "MetricsType", "OpType", "SGDOptimizer",
           "load_numpy_params"]
