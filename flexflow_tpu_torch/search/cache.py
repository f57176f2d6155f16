"""Persistent strategy cache.

PyTorch counterpart of ``flexflow_tpu/search/cache.py``: the reference's
``--export-strategy``/``--import-strategy`` (model.cc:3609-3618) made
automatic. ``FFModel._run_search`` consults the cache before any search
runs; on a hit the stored :class:`~.unity.GraphSearchResult` is
rehydrated and the compile proceeds with ZERO simulator or cost-model
queries.

Key = SHA-256 over three signatures:

* **graph**: the layer toposort with op types, attrs and input/output
  tensor shapes and dtypes, tensor ids remapped to dense local indices and
  auto-generated layer names canonicalized, so identical models built in
  different processes collide on one key;
* **machine**: the :class:`~..sim.machine_model.MachineModel` class,
  device count, full chip spec (the ``h100``/``h100-bf16`` choice
  included) and topology attributes;
* **config**: every knob that can change what the search selects
  (``_SEARCH_KNOBS``, the pinned mesh, the content hash of a substitution
  or machine-model file) and, in a multi-process group, the
  ``torch.distributed`` world size, so a resized relaunch misses and
  re-searches.

Values are JSON files under ``<cache_dir>/<key>.json``, written
atomically, carrying the payload ``schema`` version: rehydration checks
it and every required field before reading anything, so a truncated or
hand-edited entry is a miss (:class:`CacheSchemaWarning`). A hit is then
checked by ``FFModel`` through ``build_ops`` over the stored strategies
and mesh; a failure demotes it to a miss. A result that won on a
rewritten graph stores only the rewrite names, re-derived through
:func:`~.graph_xfer.rehydrate_variant`; a mismatch is a miss, so the
cache can go stale, never wrong.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
import warnings
from typing import Dict, List, Optional, Sequence

from ..sim.machine_model import world_size as _world_size
from .unity import GraphSearchResult

# v2: auto-generated layer names are canonicalized in the graph
# signature (they embed the process-global layer guid, which broke the
# "same graph, same key" promise for any graph with an unnamed layer),
# and payloads carry the toposorted layer-name list so strategies remap
# positionally on rehydration in another process.
CACHE_VERSION = 2

# Version of the RESULT payload layout inside an entry (the fields
# result_to_payload writes and result_from_payload reads). Orthogonal to
# CACHE_VERSION, which versions the KEY derivation: a key-derivation
# change re-addresses entries, a payload-layout change invalidates their
# CONTENT. Rehydration validates this before touching any field, so a
# layout change (or a hand-edited entry) fails with a clear
# schema-mismatch message instead of a downstream AttributeError.
# v3: pipe-prefixed plans carry the schedule the bubble model selected
# (pipe_schedule/pipe_interleave) — a pre-schedule-knob entry would
# otherwise rehydrate with an UNDEFINED schedule, so it demotes to a
# clean, attributed CacheSchemaWarning miss instead.
# v4: plans additionally carry ``pipe_engine`` — the engine family
# (compiled|host) the schedule ranking priced. The compiled envelope
# widened (interleaved + pipe×data submeshes, COST_MODEL_VERSION 3), so
# a v3 entry's est_step_time may embed host-engine dispatch overhead a
# compiled run no longer pays; demote rather than replay a stale price.
PAYLOAD_SCHEMA = 4

# required payload fields and their validators: rehydration checks every
# one of these BEFORE constructing a GraphSearchResult
_PAYLOAD_FIELDS = {
    "strategies": lambda v: (isinstance(v, dict)
                             and all(isinstance(k, str)
                                     and isinstance(s, dict)
                                     for k, s in v.items())),
    "mesh_shape": lambda v: (isinstance(v, dict)
                             and all(isinstance(s, int)
                                     and not isinstance(s, bool)
                                     and s >= 1
                                     for s in v.values())),
    "est_step_time": lambda v: isinstance(v, (int, float)),
    "est_memory": lambda v: isinstance(v, (int, float)),
    "rewrites": lambda v: (isinstance(v, list)
                           and all(isinstance(r, str) for r in v)),
    # the pipeline schedule dimension (None on un-piped plans)
    "pipe_schedule": lambda v: v is None or (
        isinstance(v, str)
        and v in ("gpipe", "1f1b", "interleaved")),
    "pipe_interleave": lambda v: (isinstance(v, int)
                                  and not isinstance(v, bool)
                                  and v >= 1),
    # the engine family the schedule ranking priced (None on un-piped
    # plans): the widened compiled envelope makes this a pricing
    # dimension, not a runtime detail
    "pipe_engine": lambda v: v is None or v in ("compiled", "host"),
}


class CacheSchemaWarning(UserWarning):
    """A cache entry was rejected for SCHEMA reasons (version mismatch
    or malformed payload). Schema failures are always a MISS, never an
    error: malformed storage must never fail a compile. (A schema-valid
    entry whose strategies fail ``build_ops`` is demoted to a miss by
    ``FFModel._validate_cached``.)"""

# config knobs that can change what the search selects (NOT how fast it
# runs) — the adoption margin depends on playoff_steps, the beam on
# base_optimize_threshold, pipe microbatching on batch_size, ...
_SEARCH_KNOBS = (
    "batch_size",
    "search_method",
    "search_budget",
    "search_alpha",
    "search_overlap_backward_update",
    "only_data_parallel",
    "enable_sample_parallel",
    "enable_parameter_parallel",
    "enable_attribute_parallel",
    "perform_fusion",
    "enable_graph_rewrites",
    "perform_memory_search",
    "memory_threshold_mb",
    "search_adoption_margin",
    "playoff_steps",
    "base_optimize_threshold",
    "zero_optimizer",
    "compute_dtype",
    # the schedule knob is a selection dimension: _pipe_adjusted ranks
    # schedules (or pins the requested one) per candidate mesh
    "pipeline_schedule",
    "pipeline_interleave",
    # remat changes the stage program the ranked schedules execute;
    # grad_accum microbatching changes the step the plan is priced for;
    # comp_mode splits training plans from inference plans. (search_prune
    # stays out: bound pruning is selection-neutral by construction.)
    "pipeline_remat",
    "grad_accum_steps",
    "computation_mode",
)


def _attr_sig(v):
    """JSON-stable attribute value: scalars pass through, containers
    recurse, everything else (initializer objects, ...) collapses to its
    class name — object reprs carry memory addresses that would make the
    key process-local."""
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    if isinstance(v, (tuple, list)):
        return [_attr_sig(x) for x in v]
    if isinstance(v, dict):
        return sorted((str(k), _attr_sig(x)) for k, x in v.items())
    if hasattr(v, "value") and hasattr(v, "name"):  # enum
        return f"{v.__class__.__name__}.{v.name}"
    return v.__class__.__name__


def _canon_layer_name(layer) -> str:
    """A layer's name with the process-local guid scrubbed. Unnamed
    layers auto-name as ``{op_type}_{layer_guid}`` (core/layer.py) and
    the guid counter is process-global, so the raw name would make the
    key process-local — exactly what the dense tensor-id remap below
    exists to prevent. Explicit user names pass through untouched."""
    auto = f"{layer.op_type.value}_{layer.layer_guid}"
    if layer.name == auto:
        return f"{layer.op_type.value}__auto"
    return layer.name


def graph_signature(layers: Sequence, input_tensors: Sequence,
                    protected: Optional[frozenset] = None) -> List:
    """Layer toposort with tensor ids remapped to dense local indices
    and auto-generated layer names canonicalized (see
    :func:`_canon_layer_name`), so two identical models built in
    different processes — or twice in one — collide on the same key.
    ``protected`` (tensor ids that must survive as graph outputs — the
    logits choice) is part of the signature: it changes rewrite legality
    and the pipe-stage bound, so two compiles of the same graph with
    different ``logits_tensor=`` overrides must not share an entry."""
    tid_local: Dict[int, int] = {}

    def tref(t) -> List:
        if t.tensor_id not in tid_local:
            tid_local[t.tensor_id] = len(tid_local)
        return [tid_local[t.tensor_id], list(t.dims), str(t.dtype)]

    sig: List = [["inputs", [tref(t) for t in input_tensors]]]
    for layer in layers:
        attrs = sorted(
            (k, _attr_sig(v)) for k, v in layer.attrs.items()
            if not k.startswith("_")
        )
        sig.append([
            _canon_layer_name(layer),
            str(layer.op_type),
            attrs,
            [tref(t) for t in layer.inputs],
            [tref(t) for t in layer.outputs],
        ])
    sig.append(["protected",
                sorted(tid_local.get(tid, -1) for tid in (protected or ()))])
    return sig


def machine_signature(machine) -> Dict:
    """Everything the cost/comm models read off the machine."""
    sig: Dict = {
        "class": machine.__class__.__name__,
        "n": machine.num_devices(),
        "chip": dataclasses.asdict(machine.chip),
    }
    for a in ("shared_host", "axis_degrees", "axis_links", "wraparound",
              "dcn_axes", "device_order", "staging"):
        v = getattr(machine, a, None)
        if v is not None:
            sig[a] = _attr_sig(v)
    topo = getattr(machine, "topology", None)
    if topo is not None:
        sig["topology"] = _attr_sig(getattr(topo, "__dict__", str(topo)))
    return sig


def config_signature(config, mesh_axes: Optional[Dict[str, int]]) -> Dict:
    sig: Dict = {"mesh_axes": sorted((mesh_axes or {}).items())}
    # launch topology: a resized cohort (changed world size) must
    # RE-SEARCH, never warm-hit a plan selected for the old topology.
    # Stamped only in a multi-process group, so a one-process entry keeps
    # its key (a 2-process entry carries the field, a 1-process lookup
    # does not: resized worlds still miss)
    world = _world_size()
    if world > 1:
        sig["process_count"] = world
    # token-native dynamic shapes: the bucket ladder / packing budget
    # change the shapes the plan will be dispatched at, so a bucketed
    # compile must never warm-hit a pad-to-max plan (or vice versa).
    # Stamped only when the mode is ON — the process_count pattern —
    # so every pre-existing fixed-shape cache entry keeps its key.
    if getattr(config, "seq_buckets", "off") not in (None, "off"):
        for k in ("seq_buckets", "seq_bucket_min", "seq_bucket_max",
                  "token_budget", "seq_bucket_pad_max"):
            sig[k] = _attr_sig(getattr(config, k, None))
    for k in _SEARCH_KNOBS:
        sig[k] = _attr_sig(getattr(config, k, None))
    # extra substitution rules change the candidate set: hash the file
    # content (not the path — same rules from another path must hit) and
    # any process-global rule table loaded via load_substitution_json
    path = getattr(config, "substitution_json_path", None)
    if path:
        try:
            with open(path, "rb") as f:
                sig["substitution_json"] = hashlib.sha256(
                    f.read()).hexdigest()
        except OSError:
            sig["substitution_json"] = f"unreadable:{path}"
    # a machine model file drives the cost model that prices every
    # candidate (pipeline envelope included): hash the CONTENT, same
    # contract as substitution_json — retuned numbers re-search, the
    # same file from another path still hits
    path = getattr(config, "machine_model_file", None)
    if path:
        try:
            with open(path, "rb") as f:
                sig["machine_model_file"] = hashlib.sha256(
                    f.read()).hexdigest()
        except OSError:
            sig["machine_model_file"] = f"unreadable:{path}"
    from .substitution import _JSON_RULES

    if _JSON_RULES:
        sig["global_rules"] = _attr_sig(_JSON_RULES)
    return sig


def strategy_cache_key(layers, input_tensors, machine, config,
                       mesh_axes: Optional[Dict[str, int]] = None,
                       protected: Optional[frozenset] = None) -> str:
    from ..sim.cost_model import COST_MODEL_VERSION

    doc = {
        "version": CACHE_VERSION,
        # plans are only as good as the pricing that selected them: a
        # retuned cost model (bumped COST_MODEL_VERSION) re-searches
        # instead of serving plans chosen under the old model forever
        "cost_model": COST_MODEL_VERSION,
        "graph": graph_signature(layers, input_tensors, protected),
        "machine": machine_signature(machine),
        "config": config_signature(config, mesh_axes),
    }
    blob = json.dumps(doc, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


# ------------------------------------------------------------------ storage
def cache_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"{key}.json")


def result_to_payload(result: GraphSearchResult,
                      layers: Optional[Sequence] = None) -> Dict:
    """``layers``: the toposorted layer list the strategies refer to
    (the rewritten variant when one won, else the builder graph).
    Stored as ``layer_names`` so rehydration in ANOTHER process — where
    auto-generated names carry different guids — can remap strategy
    keys positionally instead of missing on every unnamed layer."""
    names_src = result.layers if result.layers is not None else layers
    payload = {
        "strategies": result.strategies,
        "mesh_shape": result.mesh_shape,
        "est_step_time": result.est_step_time,
        "est_memory": result.est_memory,
        "states_explored": result.states_explored,
        "mem_lambda": result.mem_lambda,
        "rewrites": list(result.rewrites),
        "candidates": result.candidates,
        "pruned": result.pruned,
        "pipe_schedule": result.pipe_schedule,
        "pipe_interleave": result.pipe_interleave,
        "pipe_engine": result.pipe_engine,
    }
    if names_src is not None:
        payload["layer_names"] = [l.name for l in names_src]
    return payload


def store_result(cache_dir: str, key: str, result: GraphSearchResult,
                 layers: Optional[Sequence] = None) -> Optional[str]:
    """Atomic write; returns the path, or None when the cache dir is
    unwritable (caching must never fail a compile)."""
    try:
        os.makedirs(cache_dir, exist_ok=True)
        path = cache_path(cache_dir, key)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({
                "version": CACHE_VERSION,
                "schema": PAYLOAD_SCHEMA,
                "key": key,
                "created_at": time.time(),
                "result": result_to_payload(result, layers),
            }, f, indent=1)
        os.replace(tmp, path)
        return path
    except OSError:
        return None


def validate_payload(payload) -> List[str]:
    """Schema problems in a result payload (empty list = valid). Checked
    BEFORE rehydration reads any field, so a truncated/hand-edited entry
    is rejected with a named-field message instead of surfacing later as
    an AttributeError inside the search machinery."""
    if not isinstance(payload, dict):
        return [f"payload is {type(payload).__name__}, expected object"]
    problems = []
    if "layer_names" in payload and not (
            isinstance(payload["layer_names"], list)
            and all(isinstance(n, str) for n in payload["layer_names"])):
        problems.append("optional field 'layer_names' is not a list of "
                        "strings")
    for field, check in _PAYLOAD_FIELDS.items():
        if field not in payload:
            problems.append(f"missing required field '{field}'")
            continue
        try:
            ok = check(payload[field])
        except (TypeError, ValueError):
            ok = False
        if not ok:
            problems.append(
                f"field '{field}' has malformed value "
                f"{payload[field]!r:.80}")
    return problems


def load_payload(cache_dir: str, key: str) -> Optional[Dict]:
    path = cache_path(cache_dir, key)
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError:
        return None
    except ValueError as e:
        warnings.warn(f"strategy cache entry {path} is not valid JSON "
                      f"({e}); treating as a miss", CacheSchemaWarning)
        return None
    if doc.get("version") != CACHE_VERSION or doc.get("key") != key:
        return None
    if doc.get("schema") != PAYLOAD_SCHEMA:
        warnings.warn(
            f"strategy cache entry {path} has payload schema "
            f"{doc.get('schema')!r}, this build expects {PAYLOAD_SCHEMA}; "
            f"treating as a miss (delete the cache dir to silence)",
            CacheSchemaWarning)
        return None
    payload = doc.get("result")
    problems = validate_payload(payload)
    if problems:
        warnings.warn(
            f"strategy cache entry {path} failed payload validation: "
            f"{'; '.join(problems)}; treating as a miss",
            CacheSchemaWarning)
        return None
    return payload


def result_from_payload(payload: Dict, layers, config=None,
                        protected: Optional[frozenset] = None
                        ) -> Optional[GraphSearchResult]:
    """Rehydrate a stored result against THIS process's layer graph.

    Returns None (a miss) when the stored rewrites no longer reproduce a
    variant of this graph or the stored strategies don't cover its layer
    names — the stale-entry safety net."""
    from .graph_xfer import rehydrate_variant

    try:
        rewrites = list(payload.get("rewrites", []))
        vlayers = rehydrate_variant(layers, rewrites, config, protected)
        if vlayers is None:
            return None
        names = {l.name for l in vlayers}
        strategies = {
            k: dict(v) for k, v in payload["strategies"].items()
        }
        # cross-process rename map: auto-generated layer names embed the
        # process-global guid counter, so the stored names need not
        # match this process's. The stored toposort aligns 1:1 with the
        # replayed variant (same graph signature, same rewrites), so
        # strategy keys remap positionally; anything left unmapped must
        # still name a current layer or the entry is stale.
        stored_names = payload.get("layer_names")
        if stored_names is not None and len(stored_names) == len(vlayers):
            rename = {str(old): l.name
                      for old, l in zip(stored_names, vlayers)}
            strategies = {rename.get(k, k): v
                          for k, v in strategies.items()}
        if not set(strategies).issubset(names):
            return None
        return GraphSearchResult(
            strategies,
            {str(a): int(s) for a, s in payload["mesh_shape"].items()},
            float(payload["est_step_time"]),
            int(payload["est_memory"]),
            int(payload.get("states_explored", 0)),
            float(payload.get("mem_lambda", 0.0)),
            rewrites=rewrites,
            layers=vlayers if rewrites else None,
            candidates=int(payload.get("candidates", 0)),
            pruned=int(payload.get("pruned", 0)),
            pipe_schedule=payload.get("pipe_schedule"),
            pipe_interleave=int(payload.get("pipe_interleave", 1)),
            pipe_engine=payload.get("pipe_engine"),
        )
    except (KeyError, TypeError, ValueError):
        return None
