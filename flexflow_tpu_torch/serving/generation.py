"""Autoregressive generation with KV caches over a compiled model.

PyTorch counterpart of ``flexflow_tpu/serving/generation.py``. Each block
step walks the compiled model's op graph: every op runs its ordinary
``forward`` on the (B, S_blk, ·) activations except causal
self-attention, which writes the block's K and V into a cache and attends
over it, masking unwritten and future slots by position to -1e30 (where
``exp`` gives exactly 0). Shapes stay static, as the reference keeps them
for its compiled steps, so a later graph capture can take the steps. The
cached attention is plain torch ops, as it is XLA and not Pallas in the
reference. Sampling (greedy or temperature) happens on the host between
steps, through :func:`sample_next_token`. Two cache layouts share the
graph walk:

* :class:`Generator`: the dense rectangle, ``(B, max_length, H, D)`` per
  attention op, one fixed batch decoded in lockstep;
* :class:`PagedDecoder`: the continuous-batching layout, a
  :class:`~flexflow_tpu_torch.serving.kv_cache.PagedKVPool` of
  ``(num_blocks, block_size, H, D)`` arenas read and written through
  per-request block tables. One decode step of a fixed slot width serves
  every mix of live requests; prompts run through a prefill padded to a
  bucket length, whose K/V is written into the pool in the same step; a
  speculative verify step scores a window of W tokens a slot at once; the
  arenas may be int8, held to a divergence budget at construction
  (KVQ001). :func:`build_draft_model` builds the draft model that
  speculative decoding proposes with.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import sys
import weakref
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.op import LowerCtx
from ..ffconst import OpType
from ..kernels.flash_attention import NEG_INF
from ..obs.metrics import metrics_registry
from ..runtime.compiler import _resolve_compute_dtype
from .kv_cache import NULL_BLOCK, PagedKVPool

Cache = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _qkv(op, weights, x: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (B, S, H, D) query, key and value projections of (B, S, E)
    ``x``, biases added."""
    qh, kh, vh = (op._project(x, weights[w]) for w in ("wq", "wk", "wv"))
    if op.use_bias:
        qh, kh, vh = qh + weights["bq"], kh + weights["bk"], vh + weights["bv"]
    return qh, kh, vh


def _out_proj(op, weights, ctxv: torch.Tensor) -> torch.Tensor:
    """The output projection of the (B, S, H, D) attention context, in
    its dtype, bias added."""
    out = torch.matmul(ctxv.flatten(-2), weights["wo"].flatten(0, 1).to(ctxv.dtype))
    if op.use_bias:
        out = out + weights["bo"]
    return out


def _attn_with_cache(op, weights, x: torch.Tensor, kcache: torch.Tensor,
                     vcache: torch.Tensor, offset: int) -> torch.Tensor:
    """Causal self-attention of a (B, S_blk, E) block over [cache ∪ block].

    The block's K and V are written into the (B, max_length, H, D) caches
    at ``offset``, the absolute position of its first token, in place.
    Scores span the whole cache; slots after each query's position (future
    or unwritten) are masked to -1e30, where ``exp`` gives exactly 0."""
    qh, kh, vh = _qkv(op, weights, x)
    s_blk = x.shape[1]
    kcache[:, offset:offset + s_blk] = kh
    vcache[:, offset:offset + s_blk] = vh
    scale = 1.0 / math.sqrt(op.head_dim)
    scores = torch.einsum("bqhd,bkhd->bhqk", qh, kcache) * scale
    qpos = offset + torch.arange(s_blk, device=x.device)
    kpos = torch.arange(kcache.shape[1], device=x.device)
    scores = scores.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctxv = torch.einsum("bhqk,bkhd->bqhd", probs, vcache)
    return _out_proj(op, weights, ctxv)


def _quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Asymmetric int8 quantization over head_dim, per (token, head).
    ``x``: (T, H, D) -> (q int8, scale f32 (T, H), zero f32 (T, H)): the
    zero-point at the range's midpoint, the scale spanning [-127, 127],
    rounding half to even as ``jnp.round`` does; ``q * scale + zero``
    dequantizes."""
    x = x.float()
    hi = x.amax(-1)
    lo = x.amin(-1)
    zero = 0.5 * (hi + lo)
    scale = torch.clamp((hi - lo) / 254.0, min=1e-8)
    q = torch.clamp(torch.round((x - zero[..., None]) / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale, zero


def _entry_write(entry: Tuple[torch.Tensor, ...], flat: torch.Tensor,
                 kh: torch.Tensor, vh: torch.Tensor) -> None:
    """Write T new K/V rows (``kh``/``vh``: (T, H, D)) into a pool arena
    entry at flat token slots ``flat`` (T,), in place, quantizing when the
    entry is an int8 6-tuple (the scale/zero sidecars share the
    addressing)."""
    if len(entry) == 2:
        k, v = entry
        k.flatten(0, 1)[flat] = kh.to(k.dtype)
        v.flatten(0, 1)[flat] = vh.to(v.dtype)
        return
    kq, vq, ks, kz, vs, vz = entry
    for arena, scale, zero, rows in ((kq, ks, kz, kh), (vq, vs, vz, vh)):
        q, s, z = _quant_rows(rows)
        arena.flatten(0, 1)[flat] = q
        scale.flatten(0, 1)[flat] = s
        zero.flatten(0, 1)[flat] = z


def _entry_read(entry: Tuple[torch.Tensor, ...],
                tables: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather each slot's logical (max_blocks * block_size, H, D) K/V view
    through its block table; int8 entries dequantize to f32 here (the arena
    stays int8, only the gathered rows pay the f32 width)."""
    n = tables.shape[0]
    if len(entry) == 2:
        k, v = entry
        return (k[tables].reshape(n, -1, *k.shape[2:]),
                v[tables].reshape(n, -1, *v.shape[2:]))
    kq, vq, ks, kz, vs, vz = entry

    def deq(q, scale, zero):
        h = q.shape[2]
        return (q[tables].reshape(n, -1, h, q.shape[3]).float()
                * scale[tables].reshape(n, -1, h)[..., None]
                + zero[tables].reshape(n, -1, h)[..., None])

    return deq(kq, ks, kz), deq(vq, vs, vz)


def _attn_with_paged_cache(op, weights, x: torch.Tensor, entry, tables: torch.Tensor,
                           seq_lens: torch.Tensor) -> torch.Tensor:
    """W-token causal self-attention through a paged KV pool.

    ``x``: (n, W, E), W new tokens a decode slot at absolute positions
    ``seq_lens .. seq_lens + W - 1`` (W = 1: a decode step; W = k + 1: a
    speculative verify window). ``entry``: this op's pool arena entry.
    ``tables``: (n, max_blocks) int64 block tables. ``seq_lens``: (n,)
    int64, the tokens each slot has cached.

    Writes the W new K/V rows at each slot's positions, in place (inactive
    slots, whose tables are all null, write the null block; so do positions
    past the table's span), then gathers each slot's logical view through
    its table and masks each query's later positions to -1e30, as the dense
    path does. The scores run in the wider of the compute dtype and the
    gathered K/V's (f32 for an int8 pool), and the output is cast back to
    the compute dtype. There the port departs from the reference on
    purpose: with bf16 compute and an int8 pool the reference's f32 output
    promotes the rest of its graph to f32, while the port's ops take one
    dtype, so its graph stays in bf16 (``tests/test_torch_paged_generation
    .py`` holds the two by tolerance)."""
    qh, kh, vh = _qkv(op, weights, x)
    bs, heads, hdim = entry[0].shape[1:]
    n, w = x.shape[0], x.shape[1]
    mb = tables.shape[1]
    pos = seq_lens[:, None] + torch.arange(w, device=x.device)[None, :]   # (n, W)
    blk = torch.gather(tables, 1, torch.clamp(pos // bs, 0, mb - 1))
    # a window past the table's span (a verify window overrunning its
    # request's worst case) writes the null block, never a real block
    flat = torch.where(pos < mb * bs, blk * bs + pos % bs, NULL_BLOCK * bs)
    _entry_write(entry, flat.reshape(-1), kh.reshape(n * w, heads, hdim),
                 vh.reshape(n * w, heads, hdim))
    k, v = _entry_read(entry, tables)
    dt = torch.promote_types(qh.dtype, k.dtype)
    scale = 1.0 / math.sqrt(op.head_dim)
    scores = torch.einsum("bqhd,bkhd->bhqk", qh.to(dt), k.to(dt)) * scale
    kpos = torch.arange(k.shape[1], device=x.device)
    scores = scores.masked_fill((kpos[None, None, :] > pos[:, :, None])[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctxv = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(dt))
    return _out_proj(op, weights, ctxv).to(x.dtype)


def _causal_attn(op, weights, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense causal self-attention of (B, S, E) ``x`` from position 0 in
    torch ops (the reference's einsum path for its prefill and its
    calibration reference, not the flash kernel). Returns (output, K, V),
    K and V (B, S, H, D) for the caller to cache."""
    qh, kh, vh = _qkv(op, weights, x)
    scale = 1.0 / math.sqrt(op.head_dim)
    scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    pos = torch.arange(x.shape[1], device=x.device)
    scores = scores.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    ctxv = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), vh)
    return _out_proj(op, weights, ctxv), kh, vh


def sample_next_token(row_logits: np.ndarray, temperature: float,
                      rng: Optional[np.random.Generator]) -> int:
    """One host-side sampling decision for one request: greedy
    (temperature=0) argmax, else a softmax draw from ``rng``."""
    if temperature > 0:
        p = np.exp((row_logits - row_logits.max()) / temperature)
        p /= p.sum()
        return int(rng.choice(row_logits.shape[-1], p=p))
    return int(row_logits.argmax(-1))


class _ExecParamsCache:
    """Cast-once cache of the params in the decode compute dtype (bf16:
    one cast per params version, not one per token).

    Keyed on the compiled model's ``params_version`` (bumped by a guard
    rollback and a checkpoint restore), every leaf's identity (weak
    references: a replaced params tree stays collectable) and its in-place
    version counter, so replacing the tree, swapping one weight, an
    optimizer step and ``load_numpy_params`` (which update in place) all
    re-derive the cast."""

    __slots__ = ("_key", "_cast")

    def __init__(self):
        self.invalidate()

    def invalidate(self) -> None:
        self._key = None
        self._cast = None

    def get(self, params, compute_dtype: Optional[torch.dtype], params_version: int = 0):
        if compute_dtype is None:
            return params
        leaves = [t for ws in params.values() for t in ws.values()]
        if (self._cast is not None and self._key[0] == params_version
                and len(self._key[1]) == len(leaves)
                and all(ref() is t and ver == t._version
                        for (ref, ver), t in zip(self._key[1], leaves))):
            return self._cast
        with torch.no_grad():
            self._cast = {op: {w: t.to(compute_dtype) if t.is_floating_point() else t
                               for w, t in ws.items()} for op, ws in params.items()}
        self._key = (params_version, tuple((weakref.ref(t), t._version) for t in leaves))
        return self._cast


class _DecodeGraph:
    """The compiled-graph contract of a causal LM: causal self-attention
    ops only, (tokens, positions) as the inputs, the position table's
    capacity, and the exec-params cast cache."""

    def __init__(self, ff, max_length: int):
        cm = ff.compiled
        if cm is None:
            raise ValueError("compile() the model before generating")
        self._cm = cm
        self.max_length = int(max_length)
        self._attn_ops = [op for op in cm.ops
                          if op.op_type is OpType.MULTIHEAD_ATTENTION]
        for op in self._attn_ops:
            ids = {t.tensor_id for t in op.layer.inputs}
            if len(ids) != 1 or not op.causal:
                raise ValueError(f"{op.name}: generation needs causal SELF-attention")
        if len(cm.input_tensors) != 2:
            raise ValueError(
                f"generation needs a (tokens, positions) graph; this one has "
                f"{len(cm.input_tensors)} inputs")
        self._token_id = cm.input_tensors[0]
        self._pos_id = cm.input_tensors[1]
        # the position table bounds how far the model can decode: a
        # position past it would read a NaN row
        pos_tid = self._pos_id.tensor_id
        for op in cm.ops:
            if (op.op_type is OpType.EMBEDDING
                    and op.layer.inputs[0].tensor_id == pos_tid):
                cap = op.attrs["num_entries"]
                if self.max_length > cap:
                    raise ValueError(
                        f"max_length {self.max_length} exceeds the position "
                        f"embedding capacity {cap} ({op.name})")
        self._params_cache = _ExecParamsCache()

    def _compute_dtype(self) -> Optional[torch.dtype]:
        return _resolve_compute_dtype(self._cm.config.compute_dtype)

    def _exec_params(self):
        """Params in the decode compute dtype, cast once per params
        version (see :class:`_ExecParamsCache`)."""
        return self._params_cache.get(self._cm.params, self._compute_dtype(),
                                      self._cm.params_version)

    def invalidate_params_cache(self) -> None:
        """Drop the cast copy of the params. The cache already follows
        replaced and updated tensors by their versions; this is the
        reference's explicit call, for code written against it."""
        self._params_cache.invalidate()

    def _forward_block(self, params, acts, attn) -> torch.Tensor:
        """Walk the op graph over the activations in ``acts``; ``attn``
        handles each causal self-attention op. Returns the (B, S, vocab)
        logits in float32."""
        ctx = LowerCtx(training=False, aux_losses=[])
        for op in self._cm.ops:
            ins = [acts[t.tensor_id] for t in op.layer.inputs]
            p = params.get(op.name, {})
            if op.op_type is OpType.MULTIHEAD_ATTENTION:
                outs = [attn(op, p, ins[0])]
            else:
                outs = op.forward(ctx, ins, p)
            for out, t in zip(outs, op.layer.outputs):
                acts[t.tensor_id] = out
        return acts[self._cm.logits_tensor.tensor_id].float()


class Generator(_DecodeGraph):
    """KV-cache incremental decoding for a compiled causal LM: a graph of
    (tokens, positions) int32 inputs and (B, S, vocab) logits whose
    attention ops are causal self-attention (``models/gpt.py``'s
    contract). ``batch_size`` defaults to the compiled batch."""

    def __init__(self, ff, max_length: int, batch_size: Optional[int] = None):
        super().__init__(ff, max_length)
        self.batch_size = batch_size or self._cm.input_tensors[0].dims[0]
        self.device = self._cm.device

    # ---- cache ------------------------------------------------------------
    def init_cache(self) -> Cache:
        """Zero (B, max_length, H, D) K and V caches per attention op, in
        the compute dtype."""
        dt = self._compute_dtype() or torch.float32
        cache = {}
        with torch.inference_mode():
            for op in self._attn_ops:
                shape = (self.batch_size, self.max_length, op.num_heads, op.head_dim)
                cache[op.name] = (torch.zeros(shape, dtype=dt, device=self.device),
                                  torch.zeros(shape, dtype=dt, device=self.device))
        return cache

    # ---- one block step (prefill: S = prompt, decode: S = 1) -------------
    def _step(self, params, tokens: torch.Tensor, cache: Cache,
              offset: int) -> torch.Tensor:
        """Logits (B, S_blk, vocab) f32 of one block at absolute position
        ``offset``; writes the block's K/V into ``cache`` in place."""
        b, s_blk = tokens.shape
        positions = (offset + torch.arange(s_blk, dtype=torch.int32, device=self.device)
                     ).expand(b, s_blk)
        acts = {self._token_id.tensor_id: tokens, self._pos_id.tensor_id: positions}

        def attn(op, p, x):
            k, v = cache[op.name]
            return _attn_with_cache(op, p, x, k, v, offset)

        with torch.inference_mode():
            return self._forward_block(params, acts, attn)

    def _tokens(self, ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(ids, np.int32)).to(self.device)

    # ---- public API --------------------------------------------------------
    def prefill(self, prompt_ids: np.ndarray, cache: Optional[Cache] = None,
                offset: int = 0) -> Tuple[torch.Tensor, Cache, int]:
        """Run a prompt block starting at absolute position ``offset``
        (pass the previous round's end position and its cache to continue).
        Partial batches are padded with zero rows, whose logits are junk.
        Returns (last-token logits (B, vocab) f32 on the model's device,
        cache, end position)."""
        prompt_ids = np.asarray(prompt_ids, np.int32)
        b = prompt_ids.shape[0]
        if b > self.batch_size:
            raise ValueError(f"{b} prompts > compiled batch width {self.batch_size}")
        if b < self.batch_size:
            prompt_ids = np.concatenate([
                prompt_ids,
                np.zeros((self.batch_size - b,) + prompt_ids.shape[1:], np.int32)], axis=0)
        end = offset + prompt_ids.shape[1]
        if end > self.max_length:
            # a write past the cache would be cut short, not raise
            raise ValueError(
                f"offset {offset} + prompt {prompt_ids.shape[1]} exceeds "
                f"max_length {self.max_length}")
        if cache is None:
            if offset != 0:
                raise ValueError(
                    "offset > 0 needs the cache from the previous round "
                    "(a fresh cache has no K/V for positions < offset)")
            cache = self.init_cache()
        elif offset == 0:
            raise ValueError(
                "continuing with an existing cache requires the offset the "
                "previous round ended at (offset=0 would overwrite it)")
        logits = self._step(self._exec_params(), self._tokens(prompt_ids), cache, offset)
        return logits[:, -1, :], cache, end

    def generate(self, prompt_ids: np.ndarray, max_new_tokens: int,
                 temperature: float = 0.0, seed: Union[int, Sequence[int]] = 0,
                 eos_id: Optional[int] = None) -> np.ndarray:
        """Greedy (temperature=0) or sampled decoding. ``prompt_ids``:
        (b, S_prompt) int32, b at most the batch width; rows beyond b are
        padding and never sampled. ``seed``: one int (one stream, drawn in
        row order) or one seed per row (each row its own stream). With
        ``eos_id`` a row repeats it once drawn, and decoding stops when
        every row has. Returns (b, S_prompt + new) token ids."""
        prompt_ids = np.asarray(prompt_ids, np.int32)
        b, s0 = prompt_ids.shape
        if b > self.batch_size:
            raise ValueError(f"{b} prompts > compiled batch width {self.batch_size}")
        if s0 + max_new_tokens > self.max_length:
            raise ValueError(
                f"{s0} prompt + {max_new_tokens} new > max_length {self.max_length}")
        if isinstance(seed, (int, np.integer)):
            rngs = [np.random.default_rng(int(seed))] * b
        else:
            if len(seed) != b:
                raise ValueError(f"per-row seeds: got {len(seed)} for {b} rows")
            rngs = [np.random.default_rng(int(s)) for s in seed]
        logits, cache, pos = self.prefill(prompt_ids)
        exec_params = self._exec_params()
        out = [prompt_ids]
        done = np.zeros(b, bool)
        for i in range(max_new_tokens):
            lg = logits[:b].cpu().numpy()  # padding rows are never sampled
            nxt = np.array([sample_next_token(lg[j], temperature, rngs[j])
                            for j in range(b)], np.int32)
            if eos_id is not None:
                nxt = np.where(done, eos_id, nxt)
                done |= nxt == eos_id
            out.append(nxt[:, None])
            if i == max_new_tokens - 1 or (eos_id is not None and done.all()):
                break  # the last token is sampled: skip the unused step
            step_tokens = np.zeros((self.batch_size, 1), np.int32)
            step_tokens[:b, 0] = nxt
            logits = self._step(exec_params, self._tokens(step_tokens), cache, pos)[:, -1, :]
            pos += 1
        return np.concatenate(out, axis=1)


def default_prefill_buckets(max_length: int, smallest: int = 8) -> List[int]:
    """The pad-to-bucket ladder: powers of two from ``smallest``, capped by
    a last bucket of exactly ``max_length``."""
    out: List[int] = []
    b = smallest
    while b < max_length:
        out.append(b)
        b *= 2
    out.append(max_length)
    return out


@dataclasses.dataclass(frozen=True)
class KVQuantReport:
    """The finding of a failed quantized-pool calibration (the reference
    files it as a ``ValidationReport`` warning, which the port has no
    counterpart for yet)."""

    code: str
    message: str


class PagedDecoder(_DecodeGraph):
    """Prefill, decode and verify steps over a paged KV pool: the compute
    core of continuous batching (the scheduling loop is
    ``serving/scheduler.py``).

    * ``decode_slots``: the fixed batch width of the decode step, which
      batches every active request (inactive slots ride along, masked): one
      dispatch a step whatever the live mix.
    * ``num_blocks`` × ``block_size``: the pool (default: one worst-case
      request a slot, plus the null block); admission reserves each
      request's worst case, so a decode never outgrows it.
    * prompts run through a prefill padded to a bucket of
      ``prefill_buckets`` (default :func:`default_prefill_buckets`) that
      writes their K/V into the pool through their block tables and
      returns their logits: one dispatch a group of prompts.
    * ``kv_dtype``: the arenas' storage (``KV_DTYPES``). A quantized pool
      is calibrated at construction (``calibrate``) against the dense
      float reference and falls back loudly to float32 past
      ``kv_divergence_budget`` (KVQ001).
    """

    def __init__(self, ff, max_length: int, *, decode_slots: int = 4,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 kv_dtype: str = "float32",
                 kv_divergence_budget: Optional[float] = None,
                 calibrate: bool = True):
        super().__init__(ff, max_length)
        if decode_slots < 1:
            raise ValueError(f"decode_slots {decode_slots} < 1")
        self.device = self._cm.device
        self.decode_slots = int(decode_slots)
        self.block_size = int(block_size)
        self.max_blocks_per_request = max(1, math.ceil(self.max_length / self.block_size))
        if num_blocks is None:
            num_blocks = self.decode_slots * self.max_blocks_per_request + 1
        self.kv_dtype = str(kv_dtype)
        self.pool = self._new_pool(int(num_blocks))
        if prefill_buckets is None:
            prefill_buckets = default_prefill_buckets(self.max_length)
        self.prefill_buckets = sorted({min(int(b), self.max_length) for b in prefill_buckets})
        if self.prefill_buckets[-1] < self.max_length:
            self.prefill_buckets.append(self.max_length)
        # (bucket, rows) prefill shapes dispatched so far: the reference
        # compiles one executable each (serving.prefill_bucket_compiles)
        self._prefill_shapes: set = set()
        # one a decode or verify step: a verify IS its step's decode
        self.decode_dispatches = 0
        self.decode_steps = 0
        # KVQ001: the quantized pool's measured largest |logit| divergence
        # from the dense float reference, its budget, and the report of a
        # fallback to float32
        self.kv_divergence: Optional[float] = None
        self.kv_divergence_budget: Optional[float] = None
        self.kv_quant_report: Optional[KVQuantReport] = None
        if self.kv_dtype != "float32" and calibrate:
            self._calibrate_kv_quant(kv_divergence_budget)

    def _new_pool(self, num_blocks: int) -> PagedKVPool:
        return PagedKVPool(
            {op.name: (op.num_heads, op.head_dim) for op in self._attn_ops},
            num_blocks=num_blocks, block_size=self.block_size,
            max_blocks_per_request=self.max_blocks_per_request,
            dtype=self._compute_dtype() or torch.float32, kv_dtype=self.kv_dtype,
            device=self.device)

    def _ids(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(self.device)

    # ---- steps ---------------------------------------------------------------
    def _verify_step(self, params, tokens: torch.Tensor, tables: torch.Tensor,
                     seq_lens: torch.Tensor) -> torch.Tensor:
        """A window step for all slots: ``tokens`` (slots, W), each slot's
        last accepted token and W - 1 proposals, at absolute positions
        ``seq_lens .. seq_lens + W - 1``. Writes K/V for all W positions
        through the block tables and returns (slots, W, vocab) f32 logits:
        row j is the next-token distribution after window position j, what
        W sequential decode steps would give, since each query attends only
        to keys at or before its position. A rejected suffix needs no undo:
        the scheduler rolls ``seq_len`` back, and the stale rows stay masked
        by position until a later window (which starts at or before them)
        writes over them."""
        w = tokens.shape[1]
        positions = seq_lens[:, None] + torch.arange(w, device=self.device)[None, :]
        acts = {self._token_id.tensor_id: tokens, self._pos_id.tensor_id: positions}

        def attn(op, p, x):
            return _attn_with_paged_cache(op, p, x, self.pool.kv[op.name], tables, seq_lens)

        with torch.inference_mode():
            return self._forward_block(params, acts, attn)

    def _decode_step(self, params, tokens: torch.Tensor, tables: torch.Tensor,
                     seq_lens: torch.Tensor) -> torch.Tensor:
        """One decode step for all slots: ``tokens`` (slots, 1). Returns
        (slots, vocab) f32 logits."""
        return self._verify_step(params, tokens, tables, seq_lens)[:, -1, :]

    def _prefill_step(self, params, tokens: torch.Tensor, tables: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
        """Prefill for a group of prompts: ``tokens`` (P, Sb), each prompt
        padded to the bucket; ``tables`` (P, MB); ``lengths`` (P,) the true
        prompt lengths. Rows are independent: dense causal attention (each
        valid query masks the padding keys after it), each row's K/V written
        through its own table, padding positions into the null block.
        Returns (P, Sb, vocab) f32 logits."""
        b, s_blk = tokens.shape
        pos = torch.arange(s_blk, device=self.device)
        acts = {self._token_id.tensor_id: tokens,
                self._pos_id.tensor_id: pos.expand(b, s_blk)}
        bs = self.block_size

        def attn(op, p, x):
            out, kh, vh = _causal_attn(op, p, x)
            flat = torch.where(pos[None, :] < lengths[:, None],
                               tables[:, pos // bs] * bs + (pos % bs)[None, :],
                               NULL_BLOCK * bs)
            _entry_write(self.pool.kv[op.name], flat.reshape(-1),
                         kh.reshape(b * s_blk, *kh.shape[2:]),
                         vh.reshape(b * s_blk, *vh.shape[2:]))
            return out

        with torch.inference_mode():
            return self._forward_block(params, acts, attn)

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.prefill_buckets:
            if b >= prompt_len:
                return b
        raise ValueError(f"prompt length {prompt_len} exceeds the largest prefill "
                         f"bucket {self.prefill_buckets[-1]}")

    # ---- host API (the scheduler's surface) -----------------------------------
    def prefill(self, prompt: np.ndarray, table: np.ndarray) -> np.ndarray:
        """Prefill one request, writing its K/V into the pool. ``prompt``:
        (S,) int32; ``table``: its block table. Returns the last prompt
        position's logits, (vocab,) f32."""
        return self.prefill_many([prompt], [table])[0]

    def prefill_many(self, prompts: Sequence[np.ndarray],
                     tables: Sequence[np.ndarray]) -> np.ndarray:
        """Prefill a group of requests in one dispatch, at the bucket of the
        longest prompt (the scheduler groups by bucket). The rows are padded
        up to a power of two with zero-length rows whose writes all land in
        the null block, so the shapes stay few: (bucket, power-of-two rows).
        Returns (len(prompts), vocab) f32 logits of each prompt's last
        position, row-aligned with ``prompts``."""
        if not prompts or len(prompts) != len(tables):
            raise ValueError("prefill group needs matching non-empty prompt/table lists")
        arrs = [np.asarray(p, np.int32).ravel() for p in prompts]
        lens = [int(a.shape[0]) for a in arrs]
        if min(lens) < 1:
            raise ValueError("empty prompt")
        if max(lens) > self.max_length:
            raise ValueError(f"prompt {max(lens)} tokens > max_length {self.max_length}")
        bucket = self.bucket_for(max(lens))
        width = 1
        while width < len(arrs):
            width *= 2
        toks = np.zeros((width, bucket), np.int64)
        tabs = np.full((width, self.max_blocks_per_request), NULL_BLOCK, np.int64)
        lengths = np.zeros((width,), np.int64)
        for i, (a, t) in enumerate(zip(arrs, tables)):
            toks[i, :lens[i]] = a
            t = np.asarray(t, np.int64).ravel()
            tabs[i, :t.shape[0]] = t
            lengths[i] = lens[i]
        if (bucket, width) not in self._prefill_shapes:
            self._prefill_shapes.add((bucket, width))
            metrics_registry().counter("serving.prefill_bucket_compiles").inc()
        logits = self._prefill_step(self._exec_params(), self._ids(toks), self._ids(tabs),
                                    self._ids(lengths))
        rows = torch.arange(len(arrs), device=self.device)
        return logits[rows, self._ids(lens) - 1].cpu().numpy()

    def decode(self, tokens: np.ndarray, tables: np.ndarray,
               seq_lens: np.ndarray) -> np.ndarray:
        """One decode step for all slots (one dispatch however many are
        active). Returns (slots, vocab) f32 logits."""
        self.decode_steps += 1
        self.decode_dispatches += 1
        logits = self._decode_step(self._exec_params(), self._ids(tokens)[:, None],
                                   self._ids(tables), self._ids(seq_lens))
        return logits.cpu().numpy()

    def verify(self, tokens: np.ndarray, tables: np.ndarray,
               seq_lens: np.ndarray) -> np.ndarray:
        """A speculative verify step for all slots: ``tokens`` (slots, W),
        each slot's last accepted token and W - 1 draft proposals. One
        dispatch, counted as the step's decode. Returns (slots, W, vocab)
        f32 logits."""
        self.decode_steps += 1
        self.decode_dispatches += 1
        logits = self._verify_step(self._exec_params(), self._ids(tokens),
                                   self._ids(tables), self._ids(seq_lens))
        return logits.cpu().numpy()

    # ---- the quantized pool's gate (KVQ001) -----------------------------------
    def _dense_reference_logits(self, tokens: np.ndarray) -> np.ndarray:
        """A cache-free dense causal forward over one sequence, the
        reference a quantized pool is calibrated against. Returns (S, vocab)
        f32 logits."""
        tokens = np.asarray(tokens, np.int32)
        s = tokens.shape[0]
        acts = {self._token_id.tensor_id: self._ids(tokens[None, :]),
                self._pos_id.tensor_id: self._ids(np.arange(s)[None, :])}

        def attn(op, p, x):
            return _causal_attn(op, p, x)[0]

        with torch.inference_mode():
            return self._forward_block(self._exec_params(), acts, attn)[0].cpu().numpy()

    def _calibrate_kv_quant(self, budget: Optional[float]) -> None:
        """The ``serving_kv_divergence_budget`` gate: run a calibration
        prompt through the quantized prefill and one decode step, compare
        the decode logits with the dense reference's, and fall back loudly
        to a float32 pool (a ``[serving] KVQ001`` line on stderr and
        :attr:`kv_quant_report`) when the largest |difference| exceeds the
        budget. :attr:`kv_divergence` keeps the measurement either way."""
        if budget is None:
            budget = getattr(self._cm.config, "serving_kv_divergence_budget", None)
        # 0.0 is the knob's "unset", not a zero tolerance
        budget = float(budget) if budget else 0.05
        self.kv_divergence_budget = budget
        vocab = int(self._cm.logits_tensor.dims[-1])
        prompt_len = int(max(1, min(self.block_size + 1, self.max_length - 1, 12)))
        prompt = np.random.default_rng(0).integers(0, vocab, size=prompt_len).astype(np.int32)
        ref = self._dense_reference_logits(prompt)
        nxt = int(ref[-1].argmax(-1))
        ref_row = self._dense_reference_logits(np.concatenate([prompt, [nxt]]))[-1]
        table = self.pool.try_admit(prompt_len + 1)
        try:
            self.prefill(prompt, table)
            toks = np.zeros(self.decode_slots, np.int32)
            toks[0] = nxt
            tabs = np.full((self.decode_slots, self.max_blocks_per_request), NULL_BLOCK,
                           np.int32)
            tabs[0] = table
            lens = np.zeros(self.decode_slots, np.int32)
            lens[0] = prompt_len
            q_row = self.decode(toks, tabs, lens)[0]
        finally:
            self.pool.free(table)
        self.kv_divergence = float(np.max(np.abs(q_row - ref_row)))
        if self.kv_divergence <= budget:
            return
        self.kv_quant_report = KVQuantReport(
            "KVQ001",
            f"kv_dtype={self.kv_dtype!r} calibration divergence "
            f"{self.kv_divergence:.3e} exceeds serving_kv_divergence_budget "
            f"{budget:.3e}; falling back to float32 arenas (admission headroom "
            f"reverts to the f32 pool size)")
        metrics_registry().counter("serving.kv_dtype_fallbacks").inc()
        print(f"[serving] KVQ001: {self.kv_quant_report.message}", file=sys.stderr)
        self.kv_dtype = "float32"
        self.pool = self._new_pool(self.pool.num_blocks)


def build_draft_model(ff, spec: str):
    """Build and compile a draft causal LM for speculative decoding that
    shares ``ff``'s vocab and position contract
    (:func:`~flexflow_tpu_torch.runtime.compiler.causal_lm_signature`).
    ``spec``:

    * ``"self:N"``: a GPT of the target's geometry cut to its first N
      blocks, every parameter of a shared name (embeddings, blocks 0..N-1,
      the final LayerNorm, the head) copied from the target in place, so the
      draft approximates the target with no training;
    * ``"gpt:layers=1,hidden=16,heads=2"``: a fresh random GPT at the
      target's vocab and positions (every key optional; hidden and heads
      default to the target's).

    Returns the compiled draft FFModel."""
    from ..ffconst import CompMode
    from ..models.gpt import GPTConfig, build_gpt
    from ..runtime.compiler import causal_lm_signature
    from ..runtime.model import FFModel

    cm = ff.compiled
    if cm is None:
        raise ValueError("compile() the target before building a draft")
    sig = causal_lm_signature(cm)
    attn_ops = [op for op in cm.ops if op.op_type is OpType.MULTIHEAD_ATTENTION]
    if not attn_ops:
        raise ValueError("target has no attention ops: not a causal LM")
    t_heads = attn_ops[0].num_heads
    t_hidden = attn_ops[0].num_heads * attn_ops[0].head_dim
    kind, _, rest = spec.partition(":")
    if kind == "self":
        layers = int(rest or 1)
        if layers < 1 or layers > len(attn_ops):
            raise ValueError(f"draft spec {spec!r}: need 1 <= N <= {len(attn_ops)} "
                             f"target blocks")
        up = cm.params.get("block0_mlp_up", {}).get("kernel")
        ratio = int(up.shape[-1] // t_hidden) if up is not None else 4
        gcfg = GPTConfig(vocab_size=sig["vocab_size"],
                         max_positions=sig["max_positions"] or 1024,
                         hidden_size=t_hidden, num_heads=t_heads, num_layers=layers,
                         mlp_ratio=ratio)
    elif kind == "gpt":
        kw = {}
        for part in filter(None, rest.split(",")):
            key, _, val = part.partition("=")
            kw[key.strip()] = int(val)
        gcfg = GPTConfig(vocab_size=sig["vocab_size"],
                         max_positions=sig["max_positions"] or 1024,
                         hidden_size=kw.get("hidden", t_hidden),
                         num_heads=kw.get("heads", t_heads),
                         num_layers=kw.get("layers", 1), mlp_ratio=kw.get("mlp_ratio", 4))
    else:
        raise ValueError(f"draft spec {spec!r}: expected 'self:N' or "
                         f"'gpt:layers=...,hidden=...,heads=...'")
    dcfg = copy.deepcopy(ff.config)
    dcfg.computation_mode = CompMode.INFERENCE
    draft = FFModel(dcfg)
    build_gpt(draft, cm.input_tensors[0].dims[0], 8, gcfg)
    draft.compile()
    if kind == "self":
        # the shapes of shared names match by construction; copying in place
        # bumps each tensor's version, which the draft's cast cache reads
        with torch.no_grad():
            for name, weights in draft.compiled.params.items():
                src = cm.params.get(name, {})
                for w, t in weights.items():
                    if w in src and src[w].shape == t.shape:
                        t.copy_(src[w])
    return draft
