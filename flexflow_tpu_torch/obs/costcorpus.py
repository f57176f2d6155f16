"""Per-op cost corpus: the learned cost model's training set.

PyTorch counterpart of ``flexflow_tpu/obs/costcorpus.py``, the same row
schema and dedup key. :func:`build_rows` times every compiled op forward
and backward under its real sharding (``profile_ops``, CUDA events on
the card, where the attention op runs the flash kernels: its forward row
launches K1, its backward K2 and K3) and pairs each measurement with:

* its features: op type, input/output/weight shapes, dtypes and
  shardings, mesh degrees, analytic flops and local bytes;
* the analytic prediction;
* a content key over the features and the machine (never the measured
  values), so re-profiling the same op on the same machine adds no row.

Rows append as schema-versioned JSONL under
``.ffcache/costmodel/corpus/`` (``config.cost_corpus_dir`` or
``FLEXFLOW_TPU_COSTCORPUS_DIR`` move it), one file a process, torn lines
skipped and counted. ``config.cost_corpus`` is ``"off"`` (default) or
``"on"``; the fit tail collects after the divergence hook.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Set

from .metrics import metrics_registry
from .trace import span

CORPUS_SCHEMA = 1
DEFAULT_DIR = os.path.join(".ffcache", "costmodel", "corpus")

_mu = threading.Lock()  # guards appends (one writer file per process)


def corpus_mode(config) -> str:
    """The validated ``config.cost_corpus`` mode (typo fails at fit
    entry, the mode-knob convention)."""
    mode = getattr(config, "cost_corpus", "off") or "off"
    if mode not in ("on", "off"):
        raise ValueError(
            f"cost_corpus={mode!r}: expected 'on' or 'off'")
    return mode


def corpus_dir(config=None) -> str:
    """Resolution order: explicit config knob > env override > default
    (cwd-relative ``.ffcache/costmodel/corpus``)."""
    d = getattr(config, "cost_corpus_dir", None) \
        if config is not None else None
    return d or os.environ.get("FLEXFLOW_TPU_COSTCORPUS_DIR") \
        or DEFAULT_DIR


# ----------------------------------------------------------- featurization
def _pshape_doc(ps) -> Dict:
    """JSON view of a ParallelTensorShape: logical dims, dtype, and the
    (axis, degree) sharding per dim — the features a learned model
    regresses over."""
    return {
        "dims": [d.size for d in ps.dims],
        "dtype": str(getattr(ps.dtype, "name", ps.dtype)),
        "sharding": [[d.axis, d.degree] if d.is_partitioned else None
                     for d in ps.dims],
    }


def op_features(op, mesh_axes: Dict[str, int]) -> Dict:
    """The model-free feature block for one compiled op: op type,
    per-tensor shapes/dtypes/shardings, mesh degrees, analytic flops and
    local bytes accessed."""
    from ..sim.cost_model import _pshape_local_bytes

    in_b = sum(_pshape_local_bytes(p) for p in op.input_shapes)
    out_b = sum(_pshape_local_bytes(p) for p in op.output_shapes)
    w_b = sum(_pshape_local_bytes(p) for p in op.weight_shapes.values())
    return {
        "op_type": op.op_type.value,
        "inputs": [_pshape_doc(p) for p in op.input_shapes],
        "outputs": [_pshape_doc(p) for p in op.output_shapes],
        "weights": {k: _pshape_doc(p)
                    for k, p in sorted(op.weight_shapes.items())},
        "mesh": dict(sorted(mesh_axes.items())),
        "flops": float(op.flops()),
        "bytes_accessed": int(in_b + out_b + w_b),
    }


def row_key(features: Dict, machine: Dict) -> str:
    """Content-addressed dedup key: the featurization plus the machine
    fingerprint, NEVER the measured values or timestamps — the same op
    re-profiled on the same machine is the same row; a different
    sharding, shape, or machine is a new one."""
    doc = {"features": features,
           "machine": {k: machine.get(k)
                       for k in ("host", "backend", "devices", "torch",
                                 "device_name")}}
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True, default=str).encode()
    ).hexdigest()[:24]


def build_rows(ffmodel, iters: int = 3) -> List[Dict]:
    """Measure every compiled op fwd+bwd under its real mesh sharding
    (one ``profile_ops(backward=True)`` pass) and pair each measurement
    with its features, the analytic prediction, and the dedup key."""
    from ..core.machine import mesh_axis_sizes
    from ..runtime.profiling import profile_ops
    from .divergence import op_predictions
    from .ledger import machine_fingerprint

    cm = ffmodel.compiled
    assert cm is not None, "compile() first"
    mesh_axes = mesh_axis_sizes(cm.mesh) if cm.mesh is not None else {}
    machine = machine_fingerprint()
    predicted = op_predictions(ffmodel)
    with span("costcorpus.profile_ops", cat="obs"):
        measured = profile_ops(ffmodel, iters=iters, warmup=1,
                               backward=True)
    by_name = {op.name: op for op in cm.ops}
    rows: List[Dict] = []
    for m in measured:
        op = by_name.get(m["name"])
        if op is None:
            continue
        feats = op_features(op, mesh_axes)
        p_fwd, p_bwd = predicted.get(m["name"]) or (0.0, 0.0)
        rows.append({
            "schema": CORPUS_SCHEMA,
            "key": row_key(feats, machine),
            "name": m["name"],
            **feats,
            "measured": {
                "forward_ms": round(m["forward_ms"], 6),
                "backward_ms": (round(m["backward_ms"], 6)
                                if m.get("backward_ms") is not None
                                else None),
                "gflops_per_s": round(m.get("gflops_per_s", 0.0), 3),
                "iters": iters,
            },
            "predicted": {
                "forward_ms": round(p_fwd * 1e3, 6),
                "backward_ms": round(p_bwd * 1e3, 6),
            },
            "machine": machine,
            "ts_unix_s": round(time.time(), 3),
            "pid": os.getpid(),
        })
    return rows


# ------------------------------------------------------------- read/write
def scan_corpus(dirpath: Optional[str] = None) -> Dict:
    """Read every ``*.jsonl`` under the corpus dir; corrupt lines
    (crash-truncated appends, foreign garbage) are skipped and counted,
    the ledger's tolerance discipline — and so are rows whose
    ``schema`` VALUE is not this reader's ``CORPUS_SCHEMA``. Returns
    ``{"rows": [...], "files": n, "corrupt_lines": n,
    "foreign_schema": n}``."""
    dirpath = dirpath or corpus_dir()
    rows: List[Dict] = []
    files = corrupt = foreign = 0
    try:
        names = sorted(os.listdir(dirpath))
    except OSError:
        names = []
    for name in names:
        if not name.endswith(".jsonl"):
            continue
        files += 1
        try:
            with open(os.path.join(dirpath, name), errors="replace") as f:
                lines = f.read().splitlines()
        except OSError:
            corrupt += 1
            continue
        for line in lines:
            if not line.strip():
                continue
            try:
                doc = json.loads(line)
                if not isinstance(doc, dict) or "key" not in doc \
                        or "schema" not in doc:
                    raise ValueError("not a corpus row")
            except ValueError:
                corrupt += 1
                continue
            if doc["schema"] != CORPUS_SCHEMA:
                # a future/foreign row layout: counted and skipped —
                # half-parsing it into training data would be worse
                # than losing it
                foreign += 1
                continue
            rows.append(doc)
    return {"rows": rows, "files": files, "corrupt_lines": corrupt,
            "foreign_schema": foreign}


def existing_keys(dirpath: Optional[str] = None) -> Set[str]:
    return {r["key"] for r in scan_corpus(dirpath)["rows"]}


def append_rows(rows: List[Dict], config=None,
                dirpath: Optional[str] = None) -> Dict:
    """Append rows not already in the corpus (dedup by ``key`` against
    EVERY file in the directory, so two processes profiling the same
    model converge to one row set). Never throws into the workload —
    failures count on ``costcorpus.errors``. Returns
    ``{"appended": n, "duplicates": n, "dir": path}``."""
    dirpath = dirpath or corpus_dir(config)
    try:
        have = existing_keys(dirpath)
        fresh, dups = [], 0
        seen: Set[str] = set()
        for r in rows:
            if r["key"] in have or r["key"] in seen:
                dups += 1
                continue
            seen.add(r["key"])
            fresh.append(r)
        if fresh:
            os.makedirs(dirpath, exist_ok=True)
            path = os.path.join(dirpath, f"corpus-{os.getpid()}.jsonl")
            with _mu:
                with open(path, "a") as f:
                    for r in fresh:
                        f.write(json.dumps(r, sort_keys=True,
                                           default=str) + "\n")
        reg = metrics_registry()
        reg.counter("costcorpus.rows").inc(len(fresh))
        reg.counter("costcorpus.duplicates").inc(dups)
        return {"appended": len(fresh), "duplicates": dups,
                "dir": dirpath}
    except Exception as e:  # noqa: BLE001 — telemetry never kills a fit
        metrics_registry().counter("costcorpus.errors").inc()
        import sys

        print(f"[costcorpus] append failed: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        return {"appended": 0, "duplicates": 0, "dir": dirpath,
                "error": f"{type(e).__name__}: {e}"}


def merge_corpus(src_dir: str, dst_dir: str) -> int:
    """Fold another corpus directory's rows into ``dst_dir`` (e.g. the
    ranks' corpora onto the supervisor's after a cohort run),
    de-duplicated by the content ``key``: merging is idempotent, and the
    same op profiled on the same machine by N ranks converges to one
    row. Returns the number of rows appended."""
    fresh = [r for r in scan_corpus(src_dir)["rows"]]
    out = append_rows(fresh, dirpath=dst_dir)
    return int(out.get("appended", 0))


def load_rows(dirpath: Optional[str] = None,
              op_type: Optional[str] = None, **match) -> List[Dict]:
    """The filtered corpus (e.g. ``op_type="linear"`` for a per-op-type
    regressor's training split)."""
    rows = scan_corpus(dirpath)["rows"]
    if op_type is not None:
        rows = [r for r in rows if r.get("op_type") == op_type]
    return [r for r in rows
            if all(r.get(k) == v for k, v in match.items())]


def maybe_collect_corpus(ffmodel) -> Optional[Dict]:
    """fit()'s hook: under ``config.cost_corpus="on"`` measure + append
    this model's rows and record the outcome in
    ``fit_profile["cost_corpus"]``."""
    if corpus_mode(ffmodel.config) == "off":
        return None
    try:
        rows = build_rows(ffmodel)
        out = append_rows(rows, config=ffmodel.config)
    except Exception as e:  # noqa: BLE001 — never kill a fit
        metrics_registry().counter("costcorpus.errors").inc()
        import sys

        print(f"[costcorpus] collection failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
        return None
    if ffmodel.fit_profile is not None:
        ffmodel.fit_profile["cost_corpus"] = out
    return out


__all__ = [
    "CORPUS_SCHEMA", "append_rows", "build_rows", "corpus_dir",
    "corpus_mode", "existing_keys", "load_rows", "maybe_collect_corpus",
    "merge_corpus", "op_features", "row_key", "scan_corpus",
]
