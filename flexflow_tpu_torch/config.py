"""Runtime configuration.

PyTorch counterpart of ``flexflow_tpu/config.py``. ``FFConfig`` keeps the
JAX package's field names and defaults for the fields the port reads so
far, and adds ``device``: the port runs on the card unless the caller asks
for the CPU, and a missing card is an error, never a quiet CPU run.
:meth:`FFConfig.parse_args` reads the JAX package's flags for those
fields; :class:`FFIterationConfig` carries the per-iteration sequence
length. ``mesh_shape`` names the mesh of ranks a model is compiled over
(one process per rank; ``core/machine.py``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import torch

from .ffconst import CompMode


@dataclasses.dataclass
class FFIterationConfig:
    """Per-iteration dynamic config: ``seq_length`` > 0 truncates the
    sequence dims that ops declare (BatchMatmul's ``a/b_seq_length_dim``)
    for this iteration; -1 truncates nothing."""

    seq_length: int = -1

    def reset(self) -> None:
        self.seq_length = -1


@dataclasses.dataclass
class FFConfig:
    """Global runtime config (the subset of ``flexflow_tpu.FFConfig`` that
    the port reads so far)."""

    batch_size: int = 64
    epochs: int = 1  # fit()'s default epoch count
    # --- the strategy search (search/unity.py, search/mcmc.py) ---
    # nonzero: compile() runs the search when no strategy is given
    search_budget: int = 0
    search_alpha: float = 1.2
    # "unity" (the DP over layers and meshes) or "mcmc" (annealing)
    search_method: str = "unity"
    # the simulator overlaps the gradient all-reduce with the backward
    search_overlap_backward_update: bool = True
    # drop every strategy: plain data parallelism
    only_data_parallel: bool = False
    # shard the inputs' batch dim over the data axis
    enable_sample_parallel: bool = True
    enable_parameter_parallel: bool = False
    enable_attribute_parallel: bool = False
    # structural rewrites (search/graph_xfer.py) compete with the graph
    enable_graph_rewrites: bool = True
    # the runtime/memory lambda search; the budget is memory_threshold_mb
    # when set, else the machine model's device memory
    perform_memory_search: bool = False
    memory_threshold_mb: Optional[int] = None
    # a plan sharded beyond data parallelism is adopted only when its
    # predicted speedup over data parallelism exceeds this factor
    # (0 = auto, search/unity.py adoption_margin)
    search_adoption_margin: float = 0.0
    # > 0: the first fit after a search times this many steps of the
    # searched plan against a data-parallel compile and keeps the faster
    playoff_steps: int = 0
    # full_search's forked worker pool: 0 = auto, 1 = serial, N workers
    search_num_workers: int = 0
    # skip candidates whose compute-only lower bound exceeds the incumbent
    search_prune: bool = True
    # the strategy cache (search/cache.py): "on", "off" or "refresh"
    search_cache: str = "off"
    search_cache_dir: str = ".ffcache/strategies"
    # extra strategy templates ({"rules": {...}}, search/substitution.py)
    substitution_json_path: Optional[str] = None
    # a machine-model file (sim/machine_model.py load_machine_model) in
    # place of detect_machine_model
    machine_model_file: Optional[str] = None
    # the search's beam: frontier states kept a layer (at least 8)
    base_optimize_threshold: int = 10
    # print the search's plan and the auto schedule's ranking, each fit's
    # epoch throughput, phase table and top suggestion
    profiling: bool = False
    # graph exports written right after compile (runtime/profiling.py):
    # the op graph (``--compgraph``, cost rows with include_costs_dot_graph)
    # and the simulator's task graph (``--taskgraph``)
    export_strategy_computation_graph_file: Optional[str] = None
    export_strategy_task_graph_file: Optional[str] = None
    include_costs_dot_graph: bool = False
    computation_mode: CompMode = CompMode.TRAINING
    # "bfloat16" runs activations and matmuls in bf16 while the params
    # stay float32; None/"float32" = full precision
    compute_dtype: Optional[str] = None
    seed: int = 0
    # "cuda" (default) or "cpu"; "cuda:N" picks a card
    device: str = "cuda"
    # mesh axes and degrees ({"data": 2, "model": 2}); the product must be
    # the process group's world size. None: a data mesh over every rank
    # (one rank: no mesh)
    mesh_shape: Optional[dict] = None
    # ZeRO-1: each optimizer-state array is sharded over the data axis on
    # its first unsharded dim the data degree divides; each rank updates
    # its slice of the parameter and all-gathers it
    zero_optimizer: bool = False
    # --- pipeline (parallel/schedule.py, parallel/pipeline.py) ---
    # the microbatch order when compile() enables the pipeline on a pipe
    # axis: "gpipe", "1f1b", "interleaved" (1f1b over pipeline_interleave
    # chunks a stage) or "auto", the simulator's ranking
    # (sim/simulator.py rank_pipeline_schedules)
    pipeline_schedule: str = "auto"
    # rematerialize each chunk's forward inside its backward
    pipeline_remat: bool = False
    # chunks a stage under schedule="interleaved" (>= 2)
    pipeline_interleave: int = 2
    # fuse straight chains of weightless unary ops into one FusedOp at
    # compile (ops/fused.py); the logits tensor is never fused away
    perform_fusion: bool = False
    # --- crash safety (runtime/checkpoint.py) ---
    # > 0: fit saves a full resume checkpoint (params, optimizer state and
    # the step loop's position) every N steps into checkpoint_dir;
    # fit(resume_from=dir) restores the newest intact one and replays the
    # loop from there
    checkpoint_interval_steps: int = 0
    # None = .ffcache/ckpt under the working directory
    checkpoint_dir: Optional[str] = None
    checkpoint_max_to_keep: int = 3
    # a resume whose checkpoint was written under another topology raises
    # CKPT001 unless this opts into the counted portable restore
    elastic_resume: bool = False
    # multi-process checkpoints: rank 0 waits this long for every rank's
    # ack before it writes a step's manifest; past it the step is not
    # manifested (counted on checkpoint.barrier_timeouts)
    checkpoint_barrier_timeout_s: float = 60.0
    # gradient accumulation: each step splits its batch into K
    # microbatches, sums their gradients and metrics, divides the
    # gradients by K and updates once
    grad_accum_steps: int = 1
    # --- the step loop ---
    # Prefetcher queue depth: a worker thread assembles host batches ahead
    # of the step; 0 = inline assembly
    prefetch_depth: int = 0
    # steps fit keeps in flight on the card before it waits for the oldest
    max_inflight_steps: int = 2
    # K > 1: fit runs K consecutive batches through train_k_steps in one
    # host call (off under seq_buckets or a recompile state)
    steps_per_dispatch: int = 1
    # --- sequence buckets (runtime/buckets.py) ---
    # "off" = pad to the data's width; "pow2" = powers of two from
    # seq_bucket_min up to seq_bucket_max (0 = the data's width); or a
    # comma list ("32,64,128"). Row lengths come from the sparse-CE
    # labels' trailing -1 padding, and -1 positions are masked out of the
    # loss, the metrics and the gradients
    seq_buckets: str = "off"
    seq_bucket_min: int = 8
    seq_bucket_max: int = 0
    # > 0: pack each epoch by tokens (rows x bucket width <= budget)
    # instead of fixed batch_size rows; needs seq_buckets
    token_budget: int = 0
    # "on": keep the packing plan but pad every batch to the ladder's top
    # (the pad-to-max comparison run)
    seq_bucket_pad_max: str = "off"
    # --- continuous-batching generation (serving/scheduler.py): the
    # defaults of a GenerationInstance, each overridable per instance ---
    # decode slots: the fixed batch width of the one decode step
    serving_decode_slots: int = 4
    # paged KV pool: tokens a block, and blocks (0 = auto: one worst-case
    # request a decode slot, plus the null block)
    serving_block_size: int = 16
    serving_num_blocks: int = 0
    # longest sequence served (prompt + generated); 0 = the position
    # embedding's capacity
    serving_max_length: int = 0
    # prefill bucket lengths, comma-separated ("16,64,256"); None = powers
    # of two from 8 up to max_length
    serving_prefill_buckets: Optional[str] = None
    # prompts prefilled between two decode steps while requests are active
    serving_max_prefills_per_step: int = 1
    # > 0: group admitted prompts by bucket, up to budget // bucket a
    # prefill dispatch; 0 = one prompt a dispatch
    serving_prefill_token_budget: int = 0
    # speculative decoding: the draft ("self:N" = the target's first N
    # blocks with its weights, "gpt:layers=..,hidden=..,heads=.." = a fresh
    # GPT) and the proposals a round; "" / 0 = off
    serving_draft_model: str = ""
    serving_spec_k: int = 0
    # arena storage: "float32" (the compute dtype), "bfloat16" or "int8";
    # int8 is held to the divergence budget at construction (0.0 = the
    # default budget, 0.05) and falls back to float32 loudly past it
    serving_kv_dtype: str = "float32"
    serving_kv_divergence_budget: float = 0.0
    # span tracer (obs/trace.py): "on" arms the process-wide recorder at
    # compile/fit/eval; "off" keeps the hot loops span-free
    trace: str = "off"
    # --- observability (obs/): the JAX package's knobs and defaults ---
    # sim-vs-measured divergence (obs/divergence.py) after each fit:
    # "off", "e2e" (est_step_time vs the measured step) or "on" (also the
    # per-op cost model against profile_ops)
    divergence: str = "off"
    # |measured/predicted - 1| past which OBS001 fires
    divergence_threshold: float = 1.0
    # run ledger (obs/ledger.py): "on" appends one JSONL record a
    # compile/fit/eval/serving run to ledger_dir (None = the
    # FLEXFLOW_TPU_LEDGER_DIR env, else .ffcache/obs/runs)
    ledger: str = "on"
    ledger_dir: Optional[str] = None
    # executable telemetry (obs/exec_telemetry.py): "on" counts a traced
    # step's flops (FlopCounterMode) and its peak bytes on the card, and
    # reconciles the peak with the simulator's (OBS002 past
    # exec_mem_threshold; exec_mem_allow waives a program with a reason)
    exec_telemetry: str = "off"
    exec_mem_threshold: float = 3.0
    exec_mem_allow: Optional[dict] = None
    # step-time attribution (obs/attribution.py) into
    # fit_profile["attribution"]; top_k rows in its rankings
    attribution: str = "on"
    attribution_top_k: int = 8
    # perf advisor (obs/advisor.py) into fit_profile["advice"]
    advisor: str = "on"
    advisor_max_suggestions: int = 5
    # per-op cost corpus (obs/costcorpus.py): every op timed forward and
    # backward after fit, appended to cost_corpus_dir (None = the
    # FLEXFLOW_TPU_COSTCORPUS_DIR env, else .ffcache/costmodel/corpus)
    cost_corpus: str = "off"
    cost_corpus_dir: Optional[str] = None
    # observability HTTP server (obs/server.py): a port arms it (0 = any
    # free port, read from obs_server().port); None = no socket
    obs_server_port: Optional[int] = None
    # divergence per-op rows kept on a ledger fit record
    ledger_per_op_topk: int = 16
    # stall watchdog (obs/watchdog.py): "on" arms a daemon thread; a
    # watched source silent past the threshold writes a black-box dump
    watchdog: str = "off"
    watchdog_threshold_s: float = 60.0
    watchdog_dir: str = ".ffcache/obs/blackbox"
    # cohort observability (obs/cohort.py): "on" arms the tracer and
    # exports this rank's trace, metrics and manifest after each fit
    cohort_obs: str = "off"
    cohort_skew_threshold: float = 0.25
    # None = the FLEXFLOW_TPU_COHORT_DIR env, else .ffcache/obs/cohort
    cohort_obs_dir: Optional[str] = None
    # deterministic fault plan (runtime/faults.py), armed at compile, fit
    # and serving-instance construction; None = no chaos
    fault_plan: Optional[dict] = None

    def torch_device(self) -> torch.device:
        """The device the model lives on; raises when it asks for a card
        this process cannot see."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"FFConfig.device={self.device!r} but torch sees no CUDA "
                f"device; pass device='cpu' to run on the CPU")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device!r}")
        return dev

    @staticmethod
    def parse_args(argv: Sequence[str]) -> "FFConfig":
        """The JAX package's command-line flags for the fields the port
        has; unknown flags are ignored, as there."""
        cfg = FFConfig()
        flags = {
            "-e": ("epochs", int), "--epochs": ("epochs", int),
            "-b": ("batch_size", int), "--batch-size": ("batch_size", int),
            "--budget": ("search_budget", int), "--search-budget": ("search_budget", int),
            "--seed": ("seed", int), "--compute-dtype": ("compute_dtype", str),
            "--checkpoint-interval": ("checkpoint_interval_steps", int),
            "--checkpoint-dir": ("checkpoint_dir", str),
            "--checkpoint-keep": ("checkpoint_max_to_keep", int),
            "--checkpoint-barrier-timeout": ("checkpoint_barrier_timeout_s", float),
            "--grad-accum-steps": ("grad_accum_steps", int),
            "--prefetch-depth": ("prefetch_depth", int),
            "--max-inflight-steps": ("max_inflight_steps", int),
            "--steps-per-dispatch": ("steps_per_dispatch", int),
            "--seq-buckets": ("seq_buckets", str),
            "--seq-bucket-min": ("seq_bucket_min", int),
            "--seq-bucket-max": ("seq_bucket_max", int),
            "--seq-bucket-pad-max": ("seq_bucket_pad_max", str),
            "--token-budget": ("token_budget", int),
            "--serving-decode-slots": ("serving_decode_slots", int),
            "--serving-block-size": ("serving_block_size", int),
            "--serving-num-blocks": ("serving_num_blocks", int),
            "--serving-max-length": ("serving_max_length", int),
            "--serving-prefill-buckets": ("serving_prefill_buckets", str),
            "--serving-max-prefills": ("serving_max_prefills_per_step", int),
            "--serving-prefill-token-budget": ("serving_prefill_token_budget", int),
            "--serving-draft-model": ("serving_draft_model", str),
            "--serving-spec-k": ("serving_spec_k", int),
            "--serving-kv-dtype": ("serving_kv_dtype", str),
            "--serving-kv-divergence-budget": ("serving_kv_divergence_budget", float),
            "--pipeline-schedule": ("pipeline_schedule", str),
            "--pipeline-interleave": ("pipeline_interleave", int),
            "--alpha": ("search_alpha", float), "--search-alpha": ("search_alpha", float),
            "--search-method": ("search_method", str),
            "--base-optimize-threshold": ("base_optimize_threshold", int),
            "--memory-threshold": ("memory_threshold_mb", int),
            "--adoption-margin": ("search_adoption_margin", float),
            "--playoff-steps": ("playoff_steps", int),
            "--search-workers": ("search_num_workers", int),
            "--search-cache": ("search_cache", str),
            "--search-cache-dir": ("search_cache_dir", str),
            "--substitution-json": ("substitution_json_path", str),
            "--machine-model-file": ("machine_model_file", str),
            "--compgraph": ("export_strategy_computation_graph_file", str),
            "--taskgraph": ("export_strategy_task_graph_file", str),
            "--divergence": ("divergence", str),
            "--divergence-threshold": ("divergence_threshold", float),
            "--ledger": ("ledger", str), "--ledger-dir": ("ledger_dir", str),
            "--exec-mem-threshold": ("exec_mem_threshold", float),
            "--attribution": ("attribution", str),
            "--attribution-top-k": ("attribution_top_k", int),
            "--advisor": ("advisor", str),
            "--advisor-max-suggestions": ("advisor_max_suggestions", int),
            "--cost-corpus-dir": ("cost_corpus_dir", str),
            "--obs-server-port": ("obs_server_port", int),
            "--ledger-per-op-topk": ("ledger_per_op_topk", int),
            "--cohort-skew-threshold": ("cohort_skew_threshold", float),
            "--cohort-obs-dir": ("cohort_obs_dir", str),
            "--watchdog-threshold": ("watchdog_threshold_s", float),
            "--watchdog-dir": ("watchdog_dir", str),
        }
        switches = {"--fusion": ("perform_fusion", True),
                    "--elastic-resume": ("elastic_resume", True),
                    "--zero-optimizer": ("zero_optimizer", True),
                    "--pipeline-remat": ("pipeline_remat", True),
                    "--trace": ("trace", "on"),
                    "--only-data-parallel": ("only_data_parallel", True),
                    "--enable-parameter-parallel": ("enable_parameter_parallel", True),
                    "--enable-attribute-parallel": ("enable_attribute_parallel", True),
                    "--disable-graph-rewrites": ("enable_graph_rewrites", False),
                    "--memory-search": ("perform_memory_search", True),
                    "--disable-sample-parallel": ("enable_sample_parallel", False),
                    "--disable-overlap": ("search_overlap_backward_update", False),
                    "--disable-search-prune": ("search_prune", False),
                    "--profiling": ("profiling", True),
                    "--exec-telemetry": ("exec_telemetry", "on"),
                    "--cost-corpus": ("cost_corpus", "on"),
                    "--cohort-obs": ("cohort_obs", "on"),
                    "--watchdog": ("watchdog", "on"),
                    "--include-costs-dot-graph": ("include_costs_dot_graph", True)}
        args = list(argv)
        i = 0
        while i < len(args):
            a = args[i]
            if a in flags and i + 1 < len(args):
                field, conv = flags[a]
                i += 1
                setattr(cfg, field, conv(args[i]))
            elif a in switches:
                setattr(cfg, *switches[a])
            elif a == "--fault-plan" and i + 1 < len(args):
                # a JSON file path; the plan is validated at compile/fit
                i += 1
                with open(args[i]) as f:
                    cfg.fault_plan = json.load(f)
            i += 1
        return cfg
