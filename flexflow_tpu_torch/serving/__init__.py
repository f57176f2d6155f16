"""Serving: the classic one-shot inference engine (dynamic batching over
the native batcher, instance groups, the model repository and the
degradation bounds: admission, deadlines, breaker, worker respawn), the
dense KV-cache generator, and continuous-batching generation over a paged
KV pool (``InferenceEngine.register_generator`` -> :class:`GenerationInstance`
-> :class:`ContinuousBatchingScheduler` -> :class:`PagedDecoder` ->
:class:`PagedKVPool`), with speculative decoding and int8 KV arenas; an
instance or a generator over a mesh runs as a group of rank processes
(``group``)."""

from .engine import (DeadlineExceeded, GenerationInstance, InferenceEngine,
                     InferenceRequest, ModelInstance, ShedError)
from .errors import KVPoolExhausted
from .generation import Generator, PagedDecoder, build_draft_model, sample_next_token
from .kv_cache import KV_DTYPES, PagedKVPool
from .group import GroupFailure, MeshInstance
from .placement import MeshPlacement, instance_meshes, load_repository
from .scheduler import ContinuousBatchingScheduler, GenerationRequest

__all__ = ["ContinuousBatchingScheduler", "DeadlineExceeded", "GenerationInstance",
           "GenerationRequest", "Generator", "GroupFailure", "InferenceEngine",
           "InferenceRequest", "KVPoolExhausted", "KV_DTYPES", "MeshInstance", "MeshPlacement",
           "ModelInstance", "PagedDecoder", "PagedKVPool", "ShedError", "build_draft_model",
           "instance_meshes", "load_repository", "sample_next_token"]
