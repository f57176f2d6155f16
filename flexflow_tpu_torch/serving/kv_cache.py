"""Paged (block) KV cache pool for continuous-batching generation.

PyTorch counterpart of ``flexflow_tpu/serving/kv_cache.py``. Where the
dense :class:`~flexflow_tpu_torch.serving.generation.Generator` reserves a
``(B, max_length, H, D)`` rectangle per attention op, the pool holds one
``(num_blocks, block_size, H, D)`` K and V arena per attention op, carved
into blocks, and each request owns a **block table** that maps its logical
positions to blocks. A request reserves its worst case (prompt +
``max_new_tokens``, rounded up to blocks) at admission and frees it when it
retires, so the pool's memory is bounded by construction: admission sheds
(:class:`KVPoolExhausted`) instead of running out mid-decode, and the
decode step's shapes depend only on (decode slots, pool geometry).

Block 0 is the **null block**: never allocated, the write target of
inactive decode slots and prompt padding, and what unreserved table
entries read. Its contents are arbitrary but finite; every read through
it is masked by position before the softmax.

Arenas are stored in the compute dtype (``kv_dtype="float32"``), in bf16
(``"bfloat16"``), or in int8 with per-(token, head) f32 scale and
zero-point sidecars of shape ``(num_blocks, block_size, H)``
(``"int8"``): ``head_dim + 8`` bytes a token and head against f32's
``4 * head_dim``. The arenas live on the model's device and are updated in
place by the decoder (index-put on their flattened views); their shapes
never change. Every admission and free sets the registry's
``serving.kv_blocks_in_use`` gauge, as in the reference.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs.metrics import metrics_registry
from .errors import KVPoolExhausted

NULL_BLOCK = 0  # reserved write/read sink; never allocated

# arena storage: "float32" stores the pool's compute dtype (bf16 under a
# bf16 compute config), "bfloat16" forces bf16, "int8" adds the f32
# scale/zero-point sidecars
KV_DTYPES = ("float32", "bfloat16", "int8")


class PagedKVPool:
    """Block pool and allocator for one model's attention ops.

    ``specs``: ``{attention op name: (num_heads, head_dim)}``, one arena
    entry per op, all sharing one block geometry and one allocator (a token
    takes one slot in every layer's arena, so a block id spans all layers).
    :attr:`kv` maps each op to its entry: ``(k, v)``, or for int8 the
    6-tuple ``(k_q, v_q, k_scale, k_zero, v_scale, v_zero)``. The allocator
    state is host state under one lock: the scheduler thread allocates,
    other threads read occupancy.
    """

    def __init__(self, specs: Dict[str, Tuple[int, int]], *, num_blocks: int,
                 block_size: int, max_blocks_per_request: int,
                 dtype: torch.dtype = torch.float32, kv_dtype: str = "float32",
                 device=None):
        if num_blocks < 2:
            raise ValueError(f"num_blocks {num_blocks} < 2: block 0 is the "
                             f"reserved null block, so a usable pool needs "
                             f"at least one more")
        if block_size < 1:
            raise ValueError(f"block_size {block_size} < 1")
        if max_blocks_per_request < 1:
            raise ValueError(f"max_blocks_per_request {max_blocks_per_request} < 1")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {kv_dtype!r}: expected one of {KV_DTYPES}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.max_blocks_per_request = int(max_blocks_per_request)
        self.dtype = dtype
        self.kv_dtype = kv_dtype
        self.specs = dict(specs)
        # no device: FFConfig's default, the card (raises without one)
        from ..config import FFConfig

        self.device = FFConfig(device=FFConfig.device if device is None
                               else str(device)).torch_device()
        self.kv: Dict[str, Tuple[torch.Tensor, ...]] = {}
        with torch.inference_mode():
            for name, (heads, head_dim) in self.specs.items():
                shape = (self.num_blocks, self.block_size, heads, head_dim)
                if kv_dtype == "int8":
                    side = (self.num_blocks, self.block_size, heads)
                    self.kv[name] = (
                        *(torch.zeros(shape, dtype=torch.int8, device=self.device)
                          for _ in range(2)),
                        *(torch.zeros(side, dtype=torch.float32, device=self.device)
                          for _ in range(4)))
                else:
                    store = torch.bfloat16 if kv_dtype == "bfloat16" else dtype
                    self.kv[name] = tuple(
                        torch.zeros(shape, dtype=store, device=self.device)
                        for _ in range(2))
        # LIFO free list: the blocks freed last are reused first (their
        # stale contents are masked by position either way)
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._mu = threading.Lock()
        self._high_water = 0
        self._gauge()

    # ---- geometry ----------------------------------------------------------
    @property
    def capacity_blocks(self) -> int:
        """Allocatable blocks (block 0 is the reserved null block)."""
        return self.num_blocks - 1

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` cache entries."""
        return max(1, math.ceil(int(tokens) / self.block_size))

    def memory_bytes(self) -> int:
        """Arena bytes over all ops, K and V; an int8 pool counts its f32
        scale and zero-point sidecars."""
        if self.kv_dtype == "int8":
            per_tok = sum(2 * h * d + 2 * 2 * h * 4 for h, d in self.specs.values())
            return self.num_blocks * self.block_size * per_tok
        item = 2 if self.kv_dtype == "bfloat16" else self.dtype.itemsize
        per_tok = sum(2 * h * d for h, d in self.specs.values())
        return self.num_blocks * self.block_size * per_tok * item

    # ---- allocator ---------------------------------------------------------
    def in_use(self) -> int:
        with self._mu:
            return self.capacity_blocks - len(self._free)

    @property
    def high_water(self) -> int:
        with self._mu:
            return self._high_water

    def try_admit(self, total_tokens: int) -> Optional[np.ndarray]:
        """Reserve the worst case of a request of ``total_tokens`` (prompt
        + max_new_tokens). Returns its block table, ``(max_blocks_per_request,)``
        int32 with :data:`NULL_BLOCK` in the unused tail, or None when the
        pool is too full now: the caller waits for a retirement and tries
        again. Raises :class:`KVPoolExhausted` when the request can never
        fit (a shed, not a wait)."""
        need = self.blocks_for(total_tokens)
        if need > self.max_blocks_per_request:
            raise KVPoolExhausted(
                f"request needs {need} blocks > max_blocks_per_request "
                f"{self.max_blocks_per_request} ({total_tokens} tokens, "
                f"block_size {self.block_size})")
        if need > self.capacity_blocks:
            raise KVPoolExhausted(
                f"request worst case ({need} blocks for {total_tokens} tokens) "
                f"exceeds the whole pool ({self.capacity_blocks} allocatable "
                f"blocks)")
        with self._mu:
            if need > len(self._free):
                return None
            blocks = [self._free.pop() for _ in range(need)]
            self._high_water = max(self._high_water,
                                   self.capacity_blocks - len(self._free))
        self._gauge()
        table = np.full(self.max_blocks_per_request, NULL_BLOCK, np.int32)
        table[:need] = blocks
        return table

    def free(self, table: np.ndarray) -> None:
        """Return a request's blocks (every non-null table entry). Raises
        on a double free, which would hand one block to two requests."""
        blocks = [int(b) for b in np.asarray(table).ravel() if int(b) != NULL_BLOCK]
        with self._mu:
            self._free.extend(blocks)
            if len(self._free) > self.capacity_blocks:
                raise RuntimeError(
                    f"double free: {len(self._free)} free blocks > capacity "
                    f"{self.capacity_blocks}")
        self._gauge()

    def _gauge(self) -> None:
        metrics_registry().gauge("serving.kv_blocks_in_use").set(self.in_use())

    def stats(self) -> Dict:
        """Occupancy snapshot."""
        with self._mu:
            used = self.capacity_blocks - len(self._free)
            hw = self._high_water
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "capacity_blocks": self.capacity_blocks,
            "max_blocks_per_request": self.max_blocks_per_request,
            "in_use": used,
            "high_water": hw,
            "memory_bytes": int(self.memory_bytes()),
            "kv_dtype": self.kv_dtype,
        }


__all__ = ["KV_DTYPES", "NULL_BLOCK", "KVPoolExhausted", "PagedKVPool"]
