"""Continuous (in-flight) batching over the paged KV cache.

PyTorch counterpart of ``flexflow_tpu/serving/scheduler.py``. Requests are
admitted and retired between single decode steps, so a batch never waits
for its longest member:

* one decode step at a fixed ``decode_slots`` width batches every active
  request (:class:`~flexflow_tpu_torch.serving.generation.PagedDecoder`),
  one dispatch a step however many slots are live;
* prompts run through the bucketed prefill, their K/V written straight
  into the pool; while requests are active at most
  ``max_prefills_per_step`` prompts (or, with ``prefill_token_budget``,
  that many padded prompt tokens) are prefilled between two decode steps,
  so a burst of prompts cannot stall the decodes without bound;
* with a draft model and ``spec_k``, each step is a speculative round: the
  draft proposes ``spec_k`` tokens a slot, and one target verify step
  decides them;
* admission degrades gracefully: a queue past ``admission_limit`` sheds
  (:class:`ShedError`), a request whose worst case can never fit the pool
  sheds at once (:class:`KVPoolExhausted`), a deadline that passes in the
  queue or mid-flight rejects before the next decode step
  (:class:`DeadlineExceeded`), ``breaker_threshold`` failed steps in a row
  open a breaker for ``breaker_cooldown_s``, and a crashed worker respawns
  under ``worker_retry_budget`` with every accepted future still resolving
  (the scheduler, not the thread, owns the request state).

Each request samples from its own ``np.random.default_rng(seed)`` through
:func:`~flexflow_tpu_torch.serving.generation.sample_next_token`, so equal
logits give equal tokens whatever the batching.

As in the reference, the loop is the ``serving.worker`` fault site (a
crash there respawns the worker, which resumes every request), each
prefill, decode, draft and verify dispatch retries a ``TransientFault``
through ``_DECODE_RETRY``, every admission, shed, reject, step and token
is counted in the metrics registry under the reference's ``serving.*``
names, and with the tracer on each retired request records its span tree
(``serving.request`` over ``queue_wait``, ``prefill``, ``decode`` and
``reply``). Decode work in hand is a watched section of the stall watchdog
(``serving.gen.<name>``); retirements publish the session's attribution
on the obs server (``/attribution?kind=serving``), and ``stop()`` writes
one serving ledger record and publishes the advisor's report
(``/advice``).
"""

from __future__ import annotations

import collections
import itertools
import sys
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..obs.metrics import metrics_registry, nearest_rank_percentile
from ..obs.trace import VIRTUAL_TID_BASE, tracer
from ..obs.watchdog import _NULL as _NULL_SECTION
from ..obs.watchdog import watch as _wd_watch
from ..runtime.faults import InjectedFault, TransientFault
from ..runtime.faults import fire as _fault_fire
from ..runtime.retry import RetryPolicy
from .errors import DeadlineExceeded, ShedError
from .generation import PagedDecoder, sample_next_token

# retirements between refreshes of the obs server's /attribution (the
# first retirement and stop() always publish)
_PUBLISH_EVERY = 16

# generation request tracks sit above the classic engine's, so the two
# engines' per-request trace tracks never collide
_GEN_TID_BASE = VIRTUAL_TID_BASE + (1 << 19)

# transient prefill, decode, draft and verify failures back off briefly
# before the step fails (the classic engine's dispatch retry)
_DECODE_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.002, max_delay_s=0.02,
                            retry_on=(TransientFault,), label="serving_decode", seed=0)

# per-phase latency windows kept for stats() (a long session keeps the
# most recent ones)
_PHASE_WINDOW = 4096


def _temp_softmax(row_logits: np.ndarray, temperature: float) -> np.ndarray:
    """The temperature softmax :func:`sample_next_token` samples from, as a
    distribution: the speculative rejection test needs p and q themselves,
    with the sampling path's numerics."""
    p = np.exp((np.asarray(row_logits, np.float64) - float(row_logits.max()))
               / temperature)
    return p / p.sum()


def _percentiles(xs) -> Optional[Dict]:
    xs = sorted(xs)
    if not xs:
        return None
    return {"count": len(xs), "mean": sum(xs) / len(xs),
            "p50": nearest_rank_percentile(xs, 0.5),
            "p99": nearest_rank_percentile(xs, 0.99)}


class GenerationRequest:
    """One queued or in-flight generation request. ``future`` resolves to
    the whole (prompt + generated) int32 token array, a row of
    ``Generator.generate``."""

    __slots__ = ("request_id", "prompt", "max_new_tokens", "temperature", "seed",
                 "eos_id", "deadline_s", "t_enqueue", "future",
                 # runtime state, mutated by the scheduler thread only
                 "table", "seq_len", "tokens", "rng", "t_admit", "t_prefill_done",
                 "t_first_token", "decode_t0", "decode_steps")

    def __init__(self, request_id: int, prompt: np.ndarray, max_new_tokens: int,
                 temperature: float, seed: int, eos_id: Optional[int],
                 deadline_s: Optional[float]):
        self.request_id = request_id
        self.prompt = np.asarray(prompt, np.int32).ravel()
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.eos_id = eos_id
        self.deadline_s = deadline_s
        self.t_enqueue = time.perf_counter()
        self.future: Future = Future()
        self.table = None
        self.seq_len = 0
        self.tokens: List[int] = []
        self.rng = None
        self.t_admit = None
        self.t_prefill_done = None
        self.t_first_token = None
        self.decode_t0 = None
        self.decode_steps = 0

    def expired(self, now: float) -> bool:
        return self.deadline_s is not None and now - self.t_enqueue > self.deadline_s


class ContinuousBatchingScheduler:
    """The continuous-batching loop for one compiled causal LM.

    One condition ``_mu`` guards the queue, the slots, the lifecycle flags,
    the breaker and the session counts; every blocking call (a dispatch, a
    join) runs outside it. A request's runtime state is mutated only by the
    scheduler thread; other threads read it under ``_mu``."""

    def __init__(self, ff, name: str = "lm", *, max_length: Optional[int] = None,
                 decode_slots: int = 4, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 max_prefills_per_step: int = 1, prefill_token_budget: int = 0,
                 admission_limit: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 breaker_threshold: int = 0, breaker_cooldown_s: float = 1.0,
                 worker_retry_budget: int = 2, draft_ff=None, spec_k: int = 0,
                 kv_dtype: str = "float32",
                 kv_divergence_budget: Optional[float] = None, decoder=None):
        self.name = name
        self._ff = ff
        if decoder is not None:
            # a generation group's decoder (serving/group.py): the ranks
            # own the model and the arenas, this process the allocator
            self.decoder = decoder
        else:
            if max_length is None:
                max_length = _position_capacity(ff)
            self.decoder = PagedDecoder(
                ff, max_length, decode_slots=decode_slots, block_size=block_size,
                num_blocks=num_blocks, prefill_buckets=prefill_buckets, kv_dtype=kv_dtype,
                kv_divergence_budget=kv_divergence_budget)
        self.spec_k = max(0, int(spec_k))
        self.draft: Optional[PagedDecoder] = None
        if self.spec_k > 0:
            if draft_ff is None:
                raise ValueError(
                    f"{name!r}: spec_k={self.spec_k} needs a draft model: pass "
                    f"draft_ff (or set serving_draft_model so the "
                    f"GenerationInstance builds one)")
            from ..runtime.compiler import causal_lm_signature

            tsig = causal_lm_signature(ff.compiled)
            dsig = causal_lm_signature(draft_ff.compiled)
            if dsig["vocab_size"] != tsig["vocab_size"]:
                raise ValueError(
                    f"{name!r}: draft vocab {dsig['vocab_size']} != target vocab "
                    f"{tsig['vocab_size']}: speculation needs a shared vocab")
            if (dsig["max_positions"] is not None
                    and dsig["max_positions"] < self.decoder.max_length):
                raise ValueError(
                    f"{name!r}: draft position capacity {dsig['max_positions']} < "
                    f"serving max_length {self.decoder.max_length}")
            # the draft shares the target's block tables (same geometry) and
            # writes its own arenas at the same coordinates; its allocator
            # is never used: admission lives in the target's pool
            self.draft = PagedDecoder(
                draft_ff, self.decoder.max_length, decode_slots=self.decoder.decode_slots,
                block_size=self.decoder.block_size,
                num_blocks=self.decoder.pool.num_blocks,
                prefill_buckets=self.decoder.prefill_buckets,
                kv_dtype=self.decoder.kv_dtype, calibrate=False)
        self._spec_rounds = 0
        self._spec_slot_rounds = 0
        self._spec_proposed = 0
        self._spec_matched = 0
        self._spec_emitted = 0
        self.max_prefills_per_step = max(1, int(max_prefills_per_step))
        self.prefill_token_budget = max(0, int(prefill_token_budget))
        self._prefill_dispatches = 0
        self._prefill_prompts = 0
        self.admission_limit = int(admission_limit) if admission_limit else None
        self.default_deadline_s = float(default_deadline_s) if default_deadline_s else None
        self.breaker_threshold = max(0, int(breaker_threshold))
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.worker_retry_budget = max(0, int(worker_retry_budget))
        self._mu = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._slots: List[Optional[GenerationRequest]] = [None] * self.decoder.decode_slots
        self._ids = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._consec_failures = 0
        self._breaker_open_until = 0.0
        self._tokens_total = 0
        self._t_first_activity: Optional[float] = None
        # per-phase latency windows (seconds) and the shed and deadline
        # counts behind this scheduler's stats(): the registry's
        # serving.decode_step_s, serving.shed and serving.deadline_rejects
        # are process-global, summed over every scheduler and engine.
        # _step_served, _count_shed and _count_deadline_reject record each
        # event in both places
        self._lat: Dict[str, collections.deque] = {
            k: collections.deque(maxlen=_PHASE_WINDOW)
            for k in ("queue_wait", "prefill", "decode", "decode_step", "ttft",
                      "per_token", "e2e")}
        self._shed = 0
        self._deadline_rejects = 0
        self._completed = 0
        self._session_recorded = False

    # ---- admission ---------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int, temperature: float = 0.0,
               seed: int = 0, eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Future:
        """Submit one request. Raises :class:`ShedError` when the queue is
        at its bound or the breaker is open, and :class:`KVPoolExhausted`
        when the request's worst case can never fit the pool."""
        prompt = np.asarray(prompt, np.int32).ravel()
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens {max_new_tokens} < 1")
        total = prompt.size + int(max_new_tokens)
        if total > self.decoder.max_length:
            raise ValueError(f"{prompt.size} prompt + {max_new_tokens} new > "
                             f"max_length {self.decoder.max_length}")
        reg = metrics_registry()
        # a request that can never fit must not hold the queue's head forever
        if self.decoder.pool.blocks_for(total) > self.decoder.pool.capacity_blocks:
            self._count_shed()
            self.decoder.pool.try_admit(total)  # raises with the details
        req = GenerationRequest(
            next(self._ids), prompt, max_new_tokens, temperature, seed, eos_id,
            float(deadline_s) if deadline_s is not None else self.default_deadline_s)
        with self._mu:
            if self._closed:
                raise RuntimeError(f"{self.name!r}: generation scheduler is stopped")
            now = time.monotonic()
            if self._breaker_open_until and now < self._breaker_open_until:
                self._count_shed()
                reg.counter("serving.breaker_shed").inc()
                raise ShedError(
                    f"{self.name!r}: decode failure breaker is open "
                    f"({self.breaker_threshold} consecutive step failures); "
                    f"shedding until the cooldown elapses")
            if self._breaker_open_until and now >= self._breaker_open_until:
                # the cooldown elapsed: close the breaker, let traffic probe
                self._breaker_open_until = 0.0
                self._consec_failures = 0
            if (self.admission_limit is not None
                    and len(self._queue) >= self.admission_limit):
                self._count_shed()
                raise ShedError(f"{self.name!r}: admission queue at its bound "
                                f"({self.admission_limit}); shedding")
            self._queue.append(req)
            depth = len(self._queue)
            if self._t_first_activity is None:
                self._t_first_activity = time.perf_counter()
            self._start_locked()
            self._mu.notify_all()
        reg.counter("serving.requests").inc()
        reg.counter("serving.gen_requests").inc()
        reg.histogram("serving.queue_depth").observe(depth)
        return req.future

    def generate(self, prompt: np.ndarray, max_new_tokens: int,
                 timeout: Optional[float] = 120.0, **kw) -> np.ndarray:
        return self.submit(prompt, max_new_tokens, **kw).result(timeout)

    # ---- lifecycle ---------------------------------------------------------
    def _start_locked(self) -> None:
        if self._thread is not None or self._closed:
            return
        t = threading.Thread(target=self._worker_main, daemon=True,
                             name=f"ffserve-gen-{self.name}")
        self._thread = t
        t.start()

    def stop(self) -> None:
        """Drain and stop: queued requests fail with a RuntimeError, active
        ones decode to the end (their worst case is bounded). A stopped
        scheduler does not restart. The session's serving ledger record is
        written once, however often ``stop`` is called."""
        with self._mu:
            self._closed = True
            self._mu.notify_all()
            t = self._thread
            already = self._session_recorded
            self._session_recorded = True
        if t is not None:
            t.join(timeout=120)  # outside _mu
        if not already:
            self._record_session()

    # ---- worker ------------------------------------------------------------
    def _worker_main(self) -> None:
        """Respawn supervisor: the loop's state lives on the scheduler, so a
        respawned loop resumes every in-flight request."""
        reg = metrics_registry()
        for crashes in range(self.worker_retry_budget + 1):
            try:
                self._loop()
                return  # clean shutdown
            except Exception as e:  # noqa: BLE001 — the decode loop died
                reg.counter("serving.worker_crashes").inc()
                if crashes >= self.worker_retry_budget:
                    reg.counter("serving.worker_abandoned").inc()
                    print(f"[serving] generation worker {self.name} crashed "
                          f"{crashes + 1}x ({type(e).__name__}: {e}); respawn "
                          f"budget exhausted, abandoning", file=sys.stderr, flush=True)
                    self._abandon(e)
                    return
                reg.counter("serving.worker_respawns").inc()
                print(f"[serving] generation worker {self.name} crashed "
                      f"({type(e).__name__}: {e}); respawning "
                      f"({crashes + 1}/{self.worker_retry_budget})",
                      file=sys.stderr, flush=True)

    def _abandon(self, err: Exception) -> None:
        """The respawn budget is spent: every accepted future still
        resolves. Queued and active requests fail loudly, their blocks are
        freed, and the breaker opens for good (admission sheds)."""
        with self._mu:
            self._breaker_open_until = float("inf")
            pending = list(self._queue)
            self._queue.clear()
            active = [r for r in self._slots if r is not None]
            self._slots = [None] * len(self._slots)
        metrics_registry().counter("serving.abandoned_failed").inc(len(pending) + len(active))
        wrapped = RuntimeError(
            f"{self.name!r}: generation worker exhausted its respawn budget "
            f"({type(err).__name__}: {err}); request failed")
        for r in active:
            self.decoder.pool.free(r.table)
        for r in pending + active:
            if not r.future.done():
                r.future.set_exception(wrapped)

    def _loop(self) -> None:
        first_step = True
        while True:
            with self._mu:
                while (not self._closed and not self._queue
                       and not any(r is not None for r in self._slots)):
                    self._mu.wait()
                if (self._closed and not self._queue
                        and not any(r is not None for r in self._slots)):
                    return
                closed = self._closed
            # fault site: a worker crash; the state stays on the scheduler,
            # so the respawned worker resumes every request
            rule = _fault_fire("serving.worker")
            if rule is not None:
                raise InjectedFault(f"injected fault at site 'serving.worker' ({rule})")
            self._admit(closed)
            with self._mu:
                active = any(r is not None for r in self._slots)
            if not active:
                continue
            # the watchdog watches decode work in hand; the first step runs
            # unwatched (the kernels' first launch is not a stall)
            section = (_NULL_SECTION if first_step
                       else _wd_watch(f"serving.gen.{self.name}"))
            first_step = False
            with section:
                self._decode_once()

    # ---- admission between decode steps ------------------------------------
    def _reject_expired(self, req: GenerationRequest, now: float) -> bool:
        """Fail a queued request whose deadline passed; True if it did."""
        if not req.expired(now):
            return False
        self._count_deadline_reject()
        if not req.future.done():
            req.future.set_exception(DeadlineExceeded(
                f"request {req.request_id} waited {now - req.t_enqueue:.3f}s > "
                f"deadline {req.deadline_s:.3f}s"))
        return True

    def _free_slot(self, taken=()) -> Optional[int]:
        with self._mu:
            for i, r in enumerate(self._slots):
                if r is None and i not in taken:
                    return i
        return None

    def _admit(self, closed: bool) -> None:
        """Move queued requests into free decode slots and prefill them: a
        request whose deadline passed is rejected, one that finds no slot or
        that the pool cannot hold now waits (the queue's head keeps its
        place). While decodes are active at most ``max_prefills_per_step``
        prompts are admitted a call, one prefill dispatch each. With
        ``prefill_token_budget`` the admitted prompts are grouped by prefill
        bucket instead, each group one dispatch of at most
        ``prefill_token_budget // bucket`` prompts, and while decodes are
        active collection stops once the padded prompt tokens would pass the
        budget, so the decode stall is bounded in tokens."""
        with self._mu:
            active = any(r is not None for r in self._slots)
            n_slots = len(self._slots)
        token_budget = self.prefill_token_budget
        limit = self.max_prefills_per_step if active and not token_budget else n_slots
        batch: List = []  # (slot, req, bucket)
        reserved: set = set()
        spent = 0
        while len(batch) < limit:
            with self._mu:
                if not self._queue:
                    break
                req = self._queue.popleft()
            if closed:
                if not req.future.done():
                    req.future.set_exception(RuntimeError("engine stopped"))
                continue
            now = time.perf_counter()
            if self._reject_expired(req, now):
                continue
            bucket = self.decoder.bucket_for(req.prompt.size)
            slot = self._free_slot(reserved)
            table = None
            if slot is not None and not (token_budget and active and batch
                                         and spent + bucket > token_budget):
                table = self.decoder.pool.try_admit(req.prompt.size + req.max_new_tokens)
            if table is None:
                # over the budget, no slot, or the pool is full now: the
                # head waits for a retirement (bounded: active requests
                # free their worst case)
                with self._mu:
                    self._queue.appendleft(req)
                break
            with self._mu:
                req.table = table
                req.t_admit = now
                self._lat["queue_wait"].append(now - req.t_enqueue)
            metrics_registry().histogram("serving.gen_queue_wait_s").observe(
                now - req.t_enqueue)
            reserved.add(slot)
            spent += bucket
            batch.append((slot, req, bucket))
        if not token_budget:
            for slot, req, _ in batch:
                self._prefill_group([(slot, req)])
            return
        groups: Dict[int, List] = {}
        for slot, req, bucket in batch:
            groups.setdefault(bucket, []).append((slot, req))
        for bucket in sorted(groups):
            members = groups[bucket]
            cap = max(1, token_budget // bucket)
            for i in range(0, len(members), cap):
                self._prefill_group(members[i:i + cap])

    def _prefill_group(self, members: List) -> None:
        """One prefill dispatch for admitted same-bucket ``(slot, request)``
        pairs (the draft's arenas primed through the same tables: its logits
        are unused, the first token comes from the target); each request
        then samples its first token and takes its slot. A failed dispatch
        fails exactly the group's requests (their blocks are freed)."""
        reg = metrics_registry()
        reqs = [r for _, r in members]
        prompts, tables = [r.prompt for r in reqs], [r.table for r in reqs]
        t0 = time.perf_counter()
        try:
            logits = _DECODE_RETRY.call(self.decoder.prefill_many, prompts, tables)
            if self.draft is not None:
                _DECODE_RETRY.call(self.draft.prefill_many, prompts, tables)
        except Exception as e:  # noqa: BLE001 — fail the group only
            reg.counter("serving.errors").inc()
            for req in reqs:
                self.decoder.pool.free(req.table)
                if not req.future.done():
                    req.future.set_exception(e)
            return
        t_done = time.perf_counter()
        with self._mu:
            self._prefill_dispatches += 1
            self._prefill_prompts += len(reqs)
            for req in reqs:
                req.t_prefill_done = t_done
                req.seq_len = req.prompt.size
                req.rng = np.random.default_rng(req.seed)
                self._lat["prefill"].append(t_done - t0)
        reg.histogram("serving.prefill_s").observe(t_done - t0)
        for i, (slot, req) in enumerate(members):
            self._append_token(req, logits[i])
            if req.future.done():  # a one-token request retires here
                continue
            with self._mu:
                self._slots[slot] = req

    # ---- decode ------------------------------------------------------------
    def _step_inputs(self) -> tuple:
        """Reject the in-flight requests whose deadline passed (before their
        next step: their tokens would go to nobody; their blocks are freed)
        and gather the rest: (active [(slot, req)], last tokens, tables,
        seq_lens), the arrays at the full slot width."""
        now = time.perf_counter()
        with self._mu:
            slots = list(self._slots)
        active = []
        for i, req in enumerate(slots):
            if req is None:
                continue
            if not req.expired(now):
                active.append((i, req))
                continue
            with self._mu:
                self._slots[i] = None
            self._count_deadline_reject()
            self.decoder.pool.free(req.table)
            if not req.future.done():
                req.future.set_exception(DeadlineExceeded(
                    f"request {req.request_id} exceeded its deadline "
                    f"{req.deadline_s:.3f}s mid-decode "
                    f"({len(req.tokens)}/{req.max_new_tokens} tokens)"))
        n_slots = len(slots)
        tokens = np.zeros(n_slots, np.int32)
        tables = np.zeros((n_slots, self.decoder.max_blocks_per_request), np.int32)
        seq_lens = np.zeros(n_slots, np.int32)
        with self._mu:
            for i, req in active:
                tokens[i] = req.tokens[-1]
                tables[i] = req.table
                seq_lens[i] = req.seq_len
                if req.decode_t0 is None:
                    req.decode_t0 = time.perf_counter()
        return active, tokens, tables, seq_lens

    def _step_failed(self, active: List, err: Exception) -> None:
        """A failed step fails its requests (their blocks are freed) and
        counts toward the breaker."""
        reg = metrics_registry()
        reg.counter("serving.errors").inc()
        for i, req in active:
            with self._mu:
                self._slots[i] = None
            self.decoder.pool.free(req.table)
            if not req.future.done():
                req.future.set_exception(err)
        if self.breaker_threshold:
            with self._mu:
                self._consec_failures += 1
                # on the transition only: failures behind an open breaker
                # must not extend its cooldown
                opened = self._consec_failures == self.breaker_threshold
                if opened:
                    self._breaker_open_until = time.monotonic() + self.breaker_cooldown_s
            if opened:
                reg.counter("serving.breaker_opens").inc()

    def _count_shed(self) -> None:
        metrics_registry().counter("serving.shed").inc()
        with self._mu:
            self._shed += 1

    def _count_deadline_reject(self) -> None:
        metrics_registry().counter("serving.deadline_rejects").inc()
        with self._mu:
            self._deadline_rejects += 1

    def _step_served(self, dt: float) -> None:
        metrics_registry().histogram("serving.decode_step_s").observe(dt)
        with self._mu:
            self._lat["decode_step"].append(dt)
            if self.breaker_threshold:  # a served step ends the failure streak
                self._consec_failures = 0

    def _decode_once(self) -> None:
        if self.spec_k > 0 and self.draft is not None:
            return self._spec_once()
        active, tokens, tables, seq_lens = self._step_inputs()
        if not active:
            return
        t0 = time.perf_counter()
        try:
            logits = _DECODE_RETRY.call(self.decoder.decode, tokens, tables, seq_lens)
        except Exception as e:  # noqa: BLE001 — fail the step's requests
            self._step_failed(active, e)
            return
        self._step_served(time.perf_counter() - t0)
        for i, req in active:
            with self._mu:
                req.seq_len += 1
                req.decode_steps += 1
            self._append_token(req, logits[i])

    def _spec_once(self) -> None:
        """One speculative round: ``spec_k`` draft proposals a live slot
        (k + 1 draft dispatches: the last writes the last proposal's K/V so
        the draft's cache stays complete for the next round), then one
        target verify dispatch over the (k + 1)-token window. The verify is
        the step's decode dispatch.

        Commit rule a slot, walking the verify rows in order (row j is the
        target's distribution after window position j):

        * greedy: commit the target's argmax; a proposal equal to it keeps
          the walk going (its K/V is already cached in place), the first
          mismatch commits the target's token and rolls ``seq_len`` back.
          The tokens are the target's own argmax chain, as without
          speculation.
        * temperature: rejection sampling; accept proposal d with
          probability min(1, p(d)/q(d)), else sample the correction from
          normalize(max(p - q, 0)). The draws come from the request's own
          stream in a fixed order (k proposals, then the acceptance draws),
          so runs replay.
        * every proposal accepted: a bonus token from the last verify row.
        """
        active, base_tokens, tables, seq_lens = self._step_inputs()
        if not active:
            return
        k = self.spec_k
        n_slots = len(base_tokens)
        t0 = time.perf_counter()
        proposals = np.zeros((n_slots, k), np.int32)
        qdists: List[Optional[List[np.ndarray]]] = [None] * n_slots
        try:
            cur = base_tokens.copy()
            lens = seq_lens.copy()
            for j in range(k + 1):
                dlogits = _DECODE_RETRY.call(self.draft.decode, cur, tables, lens)
                lens = lens + 1
                if j == k:
                    break  # the cache-completing dispatch: its logits are unused
                nxt = np.zeros(n_slots, np.int32)
                for i, req in active:
                    if req.temperature > 0:
                        q = _temp_softmax(dlogits[i], req.temperature)
                        if qdists[i] is None:
                            qdists[i] = []
                        qdists[i].append(q)
                        nxt[i] = int(req.rng.choice(q.shape[-1], p=q))
                    else:
                        nxt[i] = int(dlogits[i].argmax(-1))
                proposals[:, j] = nxt
                cur = nxt
            window = np.concatenate([base_tokens[:, None], proposals], axis=1)
            vlogits = _DECODE_RETRY.call(self.decoder.verify, window, tables, seq_lens)
        except Exception as e:  # noqa: BLE001 — fail the step's requests
            self._step_failed(active, e)
            return
        self._step_served(time.perf_counter() - t0)
        reg = metrics_registry()
        for i, req in active:
            matched = 0
            emitted = 0
            done = False
            accepted = True
            for j in range(k):
                row = vlogits[i, j]
                d = int(proposals[i, j])
                if req.temperature > 0:
                    p = _temp_softmax(row, req.temperature)
                    q = qdists[i][j]
                    u = req.rng.uniform()
                    if q[d] > 0 and u < min(1.0, float(p[d]) / float(q[d])):
                        tok = d
                        accepted = True
                    else:
                        resid = np.maximum(p - q, 0.0)
                        tot = resid.sum()
                        tok = (int(req.rng.choice(resid.shape[-1], p=resid / tot))
                               if tot > 0 else int(req.rng.choice(p.shape[-1], p=p)))
                        accepted = False
                else:
                    tok = int(row.argmax(-1))
                    accepted = tok == d
                emitted += 1
                done = self._commit_token(req, tok, advance_seq=True)
                if done or not accepted:
                    break
                matched += 1
            if accepted and not done and matched == k:
                # every proposal accepted: the bonus token rides the last row
                tok = sample_next_token(vlogits[i, k], req.temperature, req.rng)
                emitted += 1
                self._commit_token(req, tok, advance_seq=True)
            with self._mu:
                req.decode_steps += 1
                self._spec_slot_rounds += 1
                self._spec_proposed += k
                self._spec_matched += matched
                self._spec_emitted += emitted
            reg.histogram("serving.spec_accept_rate").observe(matched / k)
            reg.histogram("serving.spec_tokens_per_dispatch").observe(emitted)
        with self._mu:  # one verify dispatch served the round
            self._spec_rounds += 1

    def _append_token(self, req: GenerationRequest, row_logits) -> None:
        """Sample a live request's next token and retire it when done."""
        self._commit_token(req, sample_next_token(np.asarray(row_logits),
                                                  req.temperature, req.rng))

    def _commit_token(self, req: GenerationRequest, tok: int,
                      advance_seq: bool = False) -> bool:
        """Record one committed token and retire the request when it is
        done. ``advance_seq`` advances ``seq_len`` with the append (the
        speculative path: each commit means the previous token's K/V is
        cached); the plain decode advances it a dispatch. Returns True when
        the request retired."""
        now = time.perf_counter()
        ttft = None
        with self._mu:
            if advance_seq:
                req.seq_len += 1
            req.tokens.append(int(tok))
            if req.t_first_token is None:
                req.t_first_token = now
                ttft = now - req.t_enqueue
                self._lat["ttft"].append(ttft)
            self._tokens_total += 1
            total = self._tokens_total
            t_start = self._t_first_activity
        reg = metrics_registry()
        if ttft is not None:
            reg.histogram("serving.ttft_s").observe(ttft)
        reg.counter("serving.gen_tokens").inc()
        if t_start is not None and now > t_start:
            reg.gauge("serving.tokens_per_s").set(total / (now - t_start))
        done = (len(req.tokens) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id))
        if done:
            self._retire(req, now)
        return done

    def _retire(self, req: GenerationRequest, now: float) -> None:
        self.decoder.pool.free(req.table)
        n = len(req.tokens)
        e2e = now - req.t_enqueue
        with self._mu:
            for i, r in enumerate(self._slots):
                if r is req:
                    self._slots[i] = None
            self._completed += 1
            self._lat["e2e"].append(e2e)
            self._lat["per_token"].append(e2e / n)
            if req.decode_t0 is not None:
                self._lat["decode"].append(now - req.decode_t0)
        reg = metrics_registry()
        reg.histogram("serving.gen_e2e_s").observe(e2e)
        reg.histogram("serving.per_token_s").observe(e2e / n)
        reg.counter("serving.batches").inc()
        self._record_request_spans(req, now)
        req.future.set_result(np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)]))
        # published after the future resolves and throttled: the first
        # retirement arms /attribution, every _PUBLISH_EVERY-th refreshes
        # it, and stop() publishes the final table
        with self._mu:
            completed = self._completed
        if completed % _PUBLISH_EVERY == 1:
            self._publish_attribution()

    def _record_request_spans(self, req: GenerationRequest, t_end: float) -> None:
        """``serving.request`` over ``queue_wait`` -> ``prefill`` ->
        ``decode`` (its step count in the args) -> ``reply``, each request
        on its own virtual track."""
        tr = tracer()
        if not tr.enabled:
            return
        tid = _GEN_TID_BASE + req.request_id
        tr.complete("serving.request", req.t_enqueue, t_end - req.t_enqueue,
                    cat="serving", tid=tid,
                    args={"model": self.name, "request_id": req.request_id,
                          "tokens": len(req.tokens)})
        tr.complete("serving.queue_wait", req.t_enqueue, req.t_admit - req.t_enqueue,
                    cat="serving", tid=tid)
        if req.t_prefill_done is not None:
            tr.complete("serving.prefill", req.t_admit, req.t_prefill_done - req.t_admit,
                        cat="serving", tid=tid)
        if req.decode_t0 is not None:
            tr.complete("serving.decode", req.decode_t0, t_end - req.decode_t0,
                        cat="serving", tid=tid, args={"steps": req.decode_steps})
        tr.complete("serving.reply", t_end, 0.0, cat="serving", tid=tid)

    # ---- stats -------------------------------------------------------------
    def _publish_attribution(self) -> None:
        """Keep the obs server's ``/attribution`` current for this session
        (queue_wait, prefill and decode), so a serving-only process has
        the surface a fit process has."""
        try:
            from ..obs.attribution import serving_attribution
            from ..obs.server import publish_attribution

            rec = serving_attribution(self.stats())
            if rec is not None:
                publish_attribution(rec, kind="serving")
        except Exception:  # noqa: BLE001 — telemetry never fails serving
            metrics_registry().counter("serving.obs_errors").inc()

    def _record_session(self) -> None:
        """One serving ledger record a scheduler session, with the final
        attribution and the advisor's report published."""
        from ..obs.ledger import model_context, record_serving

        extra = self.stats()
        try:
            ctx = model_context(self._ff)
            if ctx.get("model_sig"):
                extra["model_sig"] = ctx["model_sig"]
        except Exception:  # noqa: BLE001 — telemetry never kills stop
            pass
        self._publish_attribution()
        try:
            from ..obs.advisor import advise_record
            from ..obs.server import publish_advice

            report = advise_record(dict(extra))
            if report is not None:
                publish_advice(report)
        except Exception:  # noqa: BLE001 — advice never kills stop
            metrics_registry().counter("advisor.errors").inc()
        record_serving(extra, config=getattr(self._ff, "config", None))

    def stats(self) -> Dict:
        """A live snapshot of the session: counts, per-phase latency
        percentiles (seconds), pool occupancy, throughput."""
        with self._mu:
            queued = len(self._queue)
            active = sum(1 for r in self._slots if r is not None)
            tokens = self._tokens_total
            t_start = self._t_first_activity
            shed = self._shed
            deadline = self._deadline_rejects
            completed = self._completed
            prefill_dispatches = self._prefill_dispatches
            prefill_prompts = self._prefill_prompts
            phases = {k: _percentiles(v) for k, v in self._lat.items()}
            spec = (self._spec_rounds, self._spec_slot_rounds, self._spec_proposed,
                    self._spec_matched, self._spec_emitted)
        now = time.perf_counter()
        tps = tokens / (now - t_start) if t_start is not None and now > t_start else 0.0
        kv = self.decoder.pool.stats()
        if self.decoder.kv_divergence is not None:
            kv["divergence"] = self.decoder.kv_divergence
            kv["quant_fallback"] = self.decoder.kv_quant_report is not None
        out = {
            "serving_engine": "continuous",
            "model": self.name,
            "queued": queued,
            "active": active,
            "completed": completed,
            "tokens": tokens,
            "tokens_per_s": round(tps, 3),
            "shed": shed,
            "deadline_rejects": deadline,
            "phases": phases,
            "kv": kv,
            "decode_steps": self.decoder.decode_steps,
            "decode_dispatches": self.decoder.decode_dispatches,
            "prefill_dispatches": prefill_dispatches,
            "prefill_prompts": prefill_prompts,
            "prefill_buckets": list(self.decoder.prefill_buckets),
            "knobs": {
                "decode_slots": self.decoder.decode_slots,
                "block_size": self.decoder.block_size,
                "num_blocks": self.decoder.pool.num_blocks,
                "max_length": self.decoder.max_length,
                "max_prefills_per_step": self.max_prefills_per_step,
                **({"prefill_token_budget": self.prefill_token_budget}
                   if self.prefill_token_budget > 0 else {}),
                **({"spec_k": self.spec_k} if self.spec_k > 0 else {}),
                **({"kv_dtype": self.decoder.kv_dtype}
                   if self.decoder.kv_dtype != "float32" else {}),
            },
        }
        if self.spec_k > 0 and self.draft is not None:
            rounds, slot_rounds, proposed, matched, emitted = spec
            out["spec"] = {
                "k": self.spec_k,
                # rounds = verify dispatches; slot_rounds = per-slot walks
                "rounds": rounds,
                "slot_rounds": slot_rounds,
                "proposed": proposed,
                "matched": matched,
                "emitted": emitted,
                "accept_rate": round(matched / proposed, 4) if proposed else 0.0,
                # tokens one slot commits a verify dispatch (1..k+1)
                "tokens_per_dispatch": (round(emitted / slot_rounds, 3)
                                        if slot_rounds else 0.0),
                "draft_dispatches": self.draft.decode_dispatches,
            }
        return out


def _position_capacity(ff) -> int:
    """The default ``max_length``: the position embedding's capacity, the
    model's own bound on decoding."""
    from ..runtime.compiler import causal_lm_signature

    if ff.compiled is None:
        raise ValueError("compile() the model before serving it")
    cap = causal_lm_signature(ff.compiled)["max_positions"]
    if cap is None:
        raise ValueError("cannot infer max_length: no position-embedding op found; "
                         "pass max_length explicitly")
    return cap


__all__ = ["ContinuousBatchingScheduler", "GenerationRequest"]
