"""PyTorch frontend: torch.fx trace → IR file → FFModel replay.

PyTorch counterpart of ``flexflow_tpu/torch_frontend`` (reference:
python/flexflow/torch/model.py — ``symbolic_trace`` at model.py:2444, the
per-node IR serialized by ``torch_to_file`` model.py:2597 and replayed
onto FFModel by ``PyTorchModel.apply``). The IR is JSON lines, the same
records as the JAX package's.
"""

from .model import PyTorchModel, copy_weights, torch_to_flexflow

__all__ = ["PyTorchModel", "copy_weights", "torch_to_flexflow"]
