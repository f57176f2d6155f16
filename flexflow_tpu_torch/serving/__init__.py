"""Serving: the classic one-shot inference engine and the dense KV-cache
generator."""

from .engine import InferenceEngine, ModelInstance
from .generation import Generator, sample_next_token

__all__ = ["Generator", "InferenceEngine", "ModelInstance", "sample_next_token"]
