"""flexflow_tpu_torch: the PyTorch/CUDA port of flexflow_tpu for NVIDIA Hopper.

The JAX package ``flexflow_tpu`` is the reference; this package follows its
layout and names module by module, in PyTorch's idiom, and imports neither
JAX nor ``flexflow_tpu``. Its Pallas TPU kernels become hand-written CUDA
kernels for ``sm_90a`` under ``kernels/csrc``, built at first use.

Ported so far: classic one-shot inference of the reference Transformer
(``models.transformer.build_transformer``) through
``serving.engine.InferenceEngine``, with the flash-attention forward kernel.
"""

from .config import FFConfig
from .ffconst import ActiMode, CompMode, DataType, OpType
from .runtime.model import FFModel, load_numpy_params

__all__ = ["ActiMode", "CompMode", "DataType", "FFConfig", "FFModel",
           "OpType", "load_numpy_params"]
