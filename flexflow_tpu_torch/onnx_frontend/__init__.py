"""ONNX frontend, the PyTorch counterpart of ``flexflow_tpu/onnx_frontend``
(reference: python/flexflow/onnx/model.py — ``ONNXModel`` walking the onnx
graph with one ``handleX`` per op type).

The ``onnx`` package is imported lazily: ``ONNXModel`` raises a clear
error when it is missing.
"""

from .model import ONNXModel

__all__ = ["ONNXModel"]
