"""Autoregressive generation with a dense KV cache over a compiled model.

PyTorch counterpart of the dense part of
``flexflow_tpu/serving/generation.py``: :class:`Generator` decodes one
fixed batch in lockstep over a ``(B, max_length, H, D)`` K/V cache per
attention op. Each block step (the prompt, then one token at a time) walks
the compiled model's op graph: every op runs its ordinary ``forward`` on
the (B, S_blk, ·) activations except causal self-attention, which writes
the block's K and V into the cache at its offset and attends over the
FULL static cache, masking unwritten and future slots by position to
-1e30 (no growing shapes, as the reference keeps them for its compiled
step; the shapes stay static for a later graph capture). The cached
attention is plain torch ops, as it is XLA and not Pallas in the
reference. Sampling (greedy or temperature) happens on the host between
steps, through :func:`sample_next_token`, the reference's function.

Not ported yet: the paged pool (``PagedKVPool``), ``PagedDecoder``, the
scheduler, speculative decoding and the int8 KV cache.
"""

from __future__ import annotations

import math
import weakref
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.op import LowerCtx
from ..ffconst import OpType
from ..kernels.flash_attention import NEG_INF
from ..runtime.compiler import _resolve_compute_dtype

Cache = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _attn_with_cache(op, weights, x: torch.Tensor, kcache: torch.Tensor,
                     vcache: torch.Tensor, offset: int) -> torch.Tensor:
    """Causal self-attention of a (B, S_blk, E) block over [cache ∪ block].

    The block's K and V are written into the (B, max_length, H, D) caches
    at ``offset``, the absolute position of its first token, in place.
    Scores span the whole cache; slots after each query's position (future
    or unwritten) are masked to -1e30, where ``exp`` gives exactly 0."""
    qh = op._project(x, weights["wq"])
    kh = op._project(x, weights["wk"])
    vh = op._project(x, weights["wv"])
    if op.use_bias:
        qh = qh + weights["bq"]
        kh = kh + weights["bk"]
        vh = vh + weights["bv"]
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
    out = torch.matmul(ctxv.flatten(-2), weights["wo"].flatten(0, 1))
    if op.use_bias:
        out = out + weights["bo"]
    return out


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

    Keyed on every leaf's identity (weak references: a replaced params
    tree stays collectable) and its in-place version counter, so replacing
    the tree, swapping one weight, an optimizer step and
    ``load_numpy_params`` (which update in place) all re-derive the cast."""

    __slots__ = ("_key", "_cast")

    def __init__(self):
        self._key = None
        self._cast = None

    def get(self, params, compute_dtype: Optional[torch.dtype]):
        if compute_dtype is None:
            return params
        leaves = [t for ws in params.values() for t in ws.values()]
        if (self._cast is not None and len(self._key) == len(leaves)
                and all(ref() is t and ver == t._version
                        for (ref, ver), t in zip(self._key, leaves))):
            return self._cast
        with torch.no_grad():
            self._cast = {op: {w: t.to(compute_dtype) if t.is_floating_point() else t
                               for w, t in ws.items()} for op, ws in params.items()}
        self._key = tuple((weakref.ref(t), t._version) for t in leaves)
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
        return self._params_cache.get(self._cm.params, self._compute_dtype())

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
