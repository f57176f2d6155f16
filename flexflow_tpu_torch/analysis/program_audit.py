"""Program auditor: checks over the recorded aten stream of one real call.

PyTorch counterpart of ``flexflow_tpu/analysis/program_audit.py``. The
JAX package walks the jaxpr of every jitted step program. The port has
no traced program to walk: its hand-written kernels are ``ctypes`` calls
on raw device pointers (``kernels/_build.py``), so fake or meta tensors
cannot pass through them, and a tracer that swapped in the plain
versions would audit a program the card never runs. The port's
*program* is instead **the ordered stream of aten ops of one real
call**, recorded by a ``TorchDispatchMode`` (the hook family of the
``FlopCounterMode`` the executable telemetry uses). Each recorded op
keeps its aten name, the shapes, dtypes, devices and storages of its
inputs and outputs, and its source line: the innermost frame inside the
package outside ``analysis/``. Kernel launches (``kernels.count_launch``)
and collectives (``parallel/collectives.py``) made during the call land
in the program's stats; a side call's (the compile's audit on clones)
stay off the process-wide counts, a real step's count there too.

Findings (``AUD0xx`` in :data:`.findings.CODE_CATALOG`):

* **AUD000** — the recorded call raised (warning; compile goes on and
  the first real call surfaces the error).
* **AUD001** — an op input of at least ``audit_const_bytes`` that is
  neither an argument's storage nor made inside the call: a tensor the
  step closes over; or a host→card copy of that size inside the step
  (warning).
* **AUD002** — a param or optimizer-state tensor of at least
  ``audit_donate_bytes`` whose value after the step lives in a new
  storage instead of its own (the port's optimizer updates in place,
  which is how it donates); plus :func:`lint_donated_reuse`, the
  caller-side check.
* **AUD003** — a host round trip in the step: a scalar read
  (``aten._local_scalar_dense``), a card→host copy, or an op whose
  output shape depends on the data.
* **AUD004** — a chain of two or more add-accumulations into one
  bf16/f16 value by one add instruction of one frame (a Python loop's
  running sum; the jaxpr's scan carry). The autograd engine's gradient
  fan-in sums are out of scope: they are the counterpart of a jaxpr's
  ``add_any``, which the JAX audit does not flag either outside a scan
  (the port has no scan whose transpose would carry them).
* **AUD005** — a collective's partner table that is not a permutation
  within its group, or pipeline stages whose programs issue different
  ordered collective sequences (:func:`check_stage_sequences`).
* **AUD006** — cannot fire: an eager step reads its closures on every
  call and nothing caches a traced program. The code stays in the
  catalog.

Suppressions use the shared pragma grammar (:mod:`.pragmas`) at the
op's source line: ``const-ok``, ``donate-ok``, ``callback-ok``,
``accum-ok``, and ``collective-ok`` at the line that called the
collective (the JAX package's AUD005 has no suppression: its tables are
traced constants; the port's are runtime values). AUD002's recorded
check is waived by ``allow_undonated`` entries, as in the JAX package. Each program's stats carry ``ops``, ``consts_bytes``,
``args``, ``donated_args``, ``suppressed``, ``record_s``, ``walk_s``,
``static_peak_bytes`` (a liveness walk over the stream), ``kernels``,
``collectives``, ``host_syncs`` (every AUD003 site by source line,
suppressed or not) and ``ops_by_site`` (the source lines that issue the
most ops).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import sys
import time
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

from .. import kernels
from ..parallel import collectives
from . import pragmas
from .findings import Finding, ValidationReport, gate_mode

# ------------------------------------------------------------ thresholds
DEFAULT_CONST_BYTES = 1 << 20   # AUD001: closed-over tensors below this are fine
DEFAULT_DONATE_BYTES = 1 << 20  # AUD002: state below this is not worth it
TOP_SITES = 10                  # source lines kept in a program's ops_by_site

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__)) + os.sep

# ops whose output shape depends on the data: the host reads a size back
_DATA_DEPENDENT = {"nonzero", "masked_select", "unique", "_unique", "_unique2",
                   "unique_dim", "unique_consecutive", "bincount", "nonzero_static"}
_SCALAR_READS = {"_local_scalar_dense", "equal"}
_COPIES = {"_to_copy", "copy_", "_copy_from", "to"}
_ADDS = {"add", "add_", "sub", "sub_"}
_LOW_PRECISION = {torch.bfloat16, torch.float16}
# caller-side donating step calls: public name -> (donated positional
# indices, minimum positional-arg count). The port's train_step and
# train_k_steps take (params, opt_state, rng, *batch) and update the
# first two in place; eval donates nothing.
DONATING_STEP_CALLS: Dict[str, Tuple[Tuple[int, ...], int]] = {
    "train_step": ((0, 1), 4),
    "train_k_steps": ((0, 1), 4),
}


# ---------------------------------------------------------------- records
@dataclasses.dataclass
class TensorInfo:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: str
    storage: int      # the storage's data pointer (0: none)
    nbytes: int       # the storage's size


@dataclasses.dataclass
class RecordedOp:
    name: str                    # the overload packet: "add", "mm", ...
    overload: str                # "aten::add.Tensor"
    inputs: List[TensorInfo]
    outputs: List[TensorInfo]
    file: Optional[str]
    line: Optional[int]
    kwargs: Tuple[str, ...] = ()  # the keyword names the call passed
    # a low-precision add consuming the previous add of the same line in
    # the same frame: a running sum's second (or later) accumulation
    accum: bool = False


@dataclasses.dataclass
class _Collective:
    kind: str
    ranks: Tuple[int, ...]
    table: Optional[tuple]
    file: Optional[str]   # the line that called into parallel/collectives.py
    line: Optional[int]


def _info(t: torch.Tensor) -> TensorInfo:
    try:
        st = t.untyped_storage()
        ptr, nb = int(st.data_ptr()), int(st.nbytes())
    except Exception:  # noqa: BLE001 — sparse/nested tensors have no plain storage
        ptr, nb = 0, t.numel() * t.element_size()
    return TensorInfo(tuple(t.shape), t.dtype, t.device.type, ptr, nb)


def _tensors(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
    walk(tree)
    return out


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor leaf of a dict/list/tuple tree, in
    a stable order."""
    out: List[Tuple[str, torch.Tensor]] = []
    if isinstance(tree, torch.Tensor):
        out.append((prefix, tree))
    elif isinstance(tree, dict):
        for k in tree:
            out += flatten_with_paths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += flatten_with_paths(v, f"{prefix}[{i}]")
    return out


_COLLECTIVES_FILE = os.path.join(_PKG_DIR, "parallel", "collectives.py")
# directories whose frames count as source lines: the package's, and any
# a caller adds (a test's fixture module)
SOURCE_ROOTS: List[str] = [_PKG_DIR]


def _source_frame(depth: int = 2, skip: Tuple[str, ...] = ()):
    """The innermost frame inside :data:`SOURCE_ROOTS` and outside
    ``analysis/`` and ``skip`` (None when the op came from elsewhere,
    e.g. the autograd engine's own thread)."""
    f = sys._getframe(depth)
    while f is not None:
        fn = f.f_code.co_filename
        if any(fn.startswith(r) for r in SOURCE_ROOTS) \
                and not fn.startswith(_ANALYSIS_DIR) and fn not in skip:
            return f
        f = f.f_back
    return None


def _engine_op() -> bool:
    """True for an op the autograd engine issues for a built-in node (its
    gradient fan-in sums among them: the counterpart of a jaxpr's
    ``add_any``, not a loop's running sum). A custom Function's backward
    runs Python of its own and stays in scope."""
    node = torch._C._current_autograd_node()
    return node is not None and not isinstance(node, torch.autograd.function.BackwardCFunction)


class ProgramRecorder(TorchDispatchMode):
    """Records the aten ops of the calls made under it (see the module
    docstring). The kernels' and the collectives' observers (installed
    below) find it through the dispatch-mode stack
    (:func:`active_recorder`), in this thread and in the autograd
    engine's, which inherits the mode, and call ``note_launch`` and
    ``note_collective``."""

    def __init__(self, side: bool = True):
        super().__init__()
        # a side call (a compile's audit on clones, a decode step on a
        # scratch cache, the telemetry's measured step) keeps its launches
        # and collectives off the process-wide counts; a recorded real
        # step (the pipeline's first dispatch) counts them there too
        self.side = side
        self.ops: List[RecordedOp] = []
        self.kernels: Counter = Counter()
        self.collectives: List[_Collective] = []
        self.staged_bytes = 0
        # (file, line, instruction) -> (frame, output storage) of the last
        # low-precision add there; one frame a site is held, dropped at the end
        self._last_add: Dict[Tuple[str, int, int], Tuple[Any, int]] = {}
        # the arguments' storages, taken by record_call before the call
        self.arg_infos: List[TensorInfo] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        frame = _source_frame()
        op = RecordedOp(
            name=func.overloadpacket.__name__, overload=func.name(),
            inputs=[_info(t) for t in _tensors((args, kwargs))],
            outputs=[_info(t) for t in _tensors(out)],
            file=frame.f_code.co_filename if frame is not None else None,
            line=frame.f_lineno if frame is not None else None,
            kwargs=tuple(k for k, v in kwargs.items() if v is not None))
        if frame is not None and op.name in _ADDS and op.outputs \
                and op.outputs[0].dtype in _LOW_PRECISION and not _engine_op():
            # the same instruction of the same frame run again: a loop (two
            # adds of one expression are two instructions)
            key = (op.file, op.line, frame.f_lasti)
            prev = self._last_add.get(key)
            op.accum = (prev is not None and prev[0] is frame
                        and any(t.storage == prev[1] for t in op.inputs))
            self._last_add[key] = (frame, op.outputs[0].storage)  # concurrency: race-ok (one recording is driven by one call: its ops arrive in order, from the caller's thread or from the autograd engine's while the caller waits on it)
        self.ops.append(op)
        return out

    def __exit__(self, *exc):
        self._last_add.clear()
        return super().__exit__(*exc)

    # hooks ------------------------------------------------------------
    def note_launch(self, name: str) -> None:
        self.kernels[name] += 1

    def note_collective(self, kind: str, ranks: Sequence[int],
                        table: Optional[Sequence[Tuple[int, int]]] = None,
                        staged: int = 0) -> None:
        """One collective over ``ranks``; ``table`` is a shift's (source,
        destination) permutation or a point-to-point exchange's (peer,
        tag) sends, in group indices."""
        frame = _source_frame(2, skip=(_COLLECTIVES_FILE,))
        self.collectives.append(_Collective(
            kind, tuple(ranks), tuple(tuple(p) for p in table) if table is not None else None,
            frame.f_code.co_filename if frame is not None else None,
            frame.f_lineno if frame is not None else None))
        self.staged_bytes += int(staged)


def active_recorder() -> Optional[ProgramRecorder]:
    """The recorder of the current thread's dispatch-mode stack, if any."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, ProgramRecorder):
            return mode
    return None


def _observe_launch(name: str) -> bool:
    """The kernels' launch observer: a launch under a recording is noted
    on it, and counts process-wide unless the recording is a side call's."""
    rec = active_recorder()
    if rec is None:
        return True
    rec.note_launch(name)
    return not rec.side


def _observe_collective(kind: str, ranks, table, staged: int) -> bool:
    """The collectives' observer, as :func:`_observe_launch`."""
    rec = active_recorder()
    if rec is None:
        return True
    rec.note_collective(kind, ranks, table, staged)
    return not rec.side


kernels.set_launch_observer(_observe_launch)
collectives.set_observer(_observe_collective)


# ------------------------------------------------------------- the checks
def _suppressed(file: Optional[str], line: Optional[int], token: str) -> bool:
    return pragmas.file_has(file, line, "audit", token)


def _rel(file: Optional[str]) -> Optional[str]:
    if file and file.startswith(_PKG_DIR):
        return os.path.join(os.path.basename(_PKG_DIR.rstrip(os.sep)),
                            file[len(_PKG_DIR):])
    return file


def _site(op: RecordedOp) -> str:
    return f"{_rel(op.file)}:{op.line}" if op.file else "<autograd>"


def _check_consts(name, rec: ProgramRecorder, arg_ptrs: set, report, thresh, stats) -> None:
    internal: set = set()
    seen_ext: Dict[int, int] = {}
    flagged: set = set()
    for op in rec.ops:
        for t in op.inputs:
            if not t.storage or t.storage in arg_ptrs or t.storage in internal:
                continue
            seen_ext.setdefault(t.storage, t.nbytes)
            if t.nbytes < thresh or t.storage in flagged:
                continue
            flagged.add(t.storage)
            if _suppressed(op.file, op.line, "const-ok"):
                stats["suppressed"] += 1
                continue
            report.add(
                "AUD001",
                f"program '{name}' closes over a {t.nbytes / 2**20:.1f}MiB tensor "
                f"({t.dtype}, {t.shape}) read by '{op.overload}' — pass it as an "
                f"argument (or annotate '# audit: const-ok (reason)')",
                severity="warning", file=_rel(op.file), line=op.line)
        if op.name in _COPIES and op.inputs and op.outputs \
                and op.inputs[0].device == "cpu" and op.outputs[0].device == "cuda":
            nb = op.outputs[0].nbytes
            if nb >= thresh:
                if _suppressed(op.file, op.line, "const-ok"):
                    stats["suppressed"] += 1
                else:
                    report.add(
                        "AUD001",
                        f"program '{name}' copies {nb / 2**20:.1f}MiB from the host to "
                        f"the card inside the step — pass it as an argument",
                        severity="warning", file=_rel(op.file), line=op.line)
        for t in op.outputs:
            if t.storage:
                internal.add(t.storage)
    stats["consts_bytes"] = int(sum(seen_ext.values()))


def _check_donation(name, before: List[Tuple[str, TensorInfo]], after: Dict[str, torch.Tensor],
                    report, thresh, allow_undonated: Dict[str, str], stats) -> None:
    stats["donated_args"] = 0
    for path, info in before:
        t = after.get(path)
        if t is None:
            continue
        if _info(t).storage == info.storage:
            stats["donated_args"] += 1
            continue
        if info.nbytes < thresh:
            continue
        waived = next((r for frag, r in allow_undonated.items() if frag in path), None)
        if waived:
            stats["suppressed"] += 1
            continue
        report.add(
            "AUD002",
            f"program '{name}': state {path} ({info.nbytes / 2**20:.1f}MiB, "
            f"{info.dtype}) is not updated in place — its new value lives in a "
            f"new storage, so peak memory holds both",
            severity="warning")


def _host_round_trip(op: RecordedOp) -> Optional[str]:
    if op.name in _SCALAR_READS:
        return f"scalar read aten.{op.name} (.item()/float()/bool())"
    if op.name in _DATA_DEPENDENT:
        return f"data-dependent output shape (aten.{op.name})"
    if op.name == "repeat_interleave" and "output_size" not in op.kwargs \
            and len(op.inputs) >= 1 and op.overload.endswith(".Tensor"):
        return "data-dependent output shape (repeat_interleave without output_size)"
    if op.name in _COPIES and op.inputs and op.outputs \
            and op.inputs[0].device == "cuda" and op.outputs[0].device == "cpu":
        return f"card-to-host copy (aten.{op.name})"
    return None


def _check_callbacks(name, rec: ProgramRecorder, report, stats) -> None:
    sites: Counter = Counter()
    for op in rec.ops:
        what = _host_round_trip(op)
        if what is None:
            continue
        sites[_site(op)] += 1
        if _suppressed(op.file, op.line, "callback-ok"):
            stats["suppressed"] += 1
            continue
        report.add(
            "AUD003",
            f"host round trip {what} inside step program '{name}' — the host "
            f"waits for the card every call (annotate "
            f"'# audit: callback-ok (reason)' if intentional)",
            severity="error", file=_rel(op.file), line=op.line)
    stats["host_syncs"] = dict(sites)


def _check_accumulators(name, rec: ProgramRecorder, report, stats) -> None:
    flagged: set = set()
    for op in rec.ops:
        key = (op.file, op.line)
        if not op.accum or key in flagged:
            continue
        flagged.add(key)
        if _suppressed(op.file, op.line, "accum-ok"):
            stats["suppressed"] += 1
            continue
        dt = str(op.outputs[0].dtype).removeprefix("torch.")
        report.add(
            "AUD004",
            f"program '{name}': a running sum add-accumulates in {dt} at this "
            f"line — every iteration rounds it; keep accumulators in float32",
            severity="error", file=_rel(op.file), line=op.line)


def perm_problem(table: Sequence[Tuple[int, int]], size: int) -> Optional[str]:
    """Why a (source, destination) partner table is not a partial
    permutation within a group of ``size`` (None when it is)."""
    pairs = [tuple(p) for p in table]
    srcs = [p[0] for p in pairs]
    dsts = [p[1] for p in pairs]
    if len(set(srcs)) != len(srcs):
        dup = [s for s in set(srcs) if srcs.count(s) > 1]
        return f"duplicate source rank(s) {sorted(dup)}"
    if len(set(dsts)) != len(dsts):
        dup = [d for d in set(dsts) if dsts.count(d) > 1]
        return (f"duplicate destination rank(s) {sorted(dup)} — two ranks would send "
                f"to one receiver")
    bad = [r for r in srcs + dsts if not (0 <= r < size)]
    if bad:
        return f"rank(s) {sorted(set(bad))} out of range for a group of size {size}"
    return None


def p2p_problem(sends: Sequence[Tuple[int, int]], size: int) -> Optional[str]:
    """Why a point-to-point exchange's (peer, tag) sends are illegal in a
    group of ``size``: a peer out of range, or two messages to one peer
    under one tag (the receiver cannot tell them apart)."""
    pairs = [tuple(p) for p in sends]
    bad = sorted({p for p, _t in pairs if not (0 <= p < size)})
    if bad:
        return f"peer(s) {bad} out of range for a group of size {size}"
    dup = sorted({p for p in pairs if pairs.count(p) > 1})
    if dup:
        return f"duplicate (peer, tag) message(s) {dup}"
    return None


def _check_collectives(name, rec: ProgramRecorder, report, stats) -> None:
    stats["collectives"] = len(rec.collectives)
    for c in rec.collectives:
        if c.table is None:
            continue
        problem = (p2p_problem if c.kind == "send_recv" else perm_problem)(
            c.table, len(c.ranks))
        if not problem:
            continue
        if _suppressed(c.file, c.line, "collective-ok"):
            stats["suppressed"] += 1
            continue
        report.add(
            "AUD005",
            f"program '{name}': {c.kind} partner table {c.table} over ranks "
            f"{list(c.ranks)} is not legal ({problem}) — ranks would wait on "
            f"transfers that never arrive",
            severity="error", file=_rel(c.file), line=c.line)


def check_stage_sequences(name: str, sequences: Dict[int, Tuple],
                          report: ValidationReport) -> None:
    """AUD005 across the pipeline: every stage's program (stage index ->
    its stats' ``collective_sequence``, the ordered (kind, group size)
    pairs) must issue the same sequence, or a stage waits on a peer that
    never joins."""
    uniq = {tuple(map(tuple, seq)) for seq in sequences.values()}
    if len(uniq) > 1:
        desc = " vs ".join(
            f"stage {s}: [{', '.join(f'{k}@{n}' for k, n in seq)}]"
            for s, seq in sorted(sequences.items()))
        report.add(
            "AUD005",
            f"program '{name}': the pipeline stages issue different collective "
            f"sequences ({desc}) — a stage waits on a peer that never joins",
            severity="error")


def _liveness(rec: ProgramRecorder, arg_ptrs: Dict[int, int], out_ptrs: set) -> int:
    """Static peak-live bytes over the stream: the arguments' storages
    live throughout; a storage made inside the call lives from the op
    that made it to its last use (to the end when the call returns it).
    A pointer an op outputs fresh (no input of the op shares it) starts
    a new lifetime: the allocator reuses freed addresses."""
    n = len(rec.ops)
    spans: List[List[int]] = []          # [start, end, nbytes]
    current: Dict[int, List[int]] = {}
    for i, op in enumerate(rec.ops):
        in_ptrs = {t.storage for t in op.inputs}
        for t in op.inputs:
            s = current.get(t.storage)
            if s is not None:
                s[1] = i
        for t in op.outputs:
            if not t.storage or t.storage in arg_ptrs:
                continue
            s = current.get(t.storage)
            if s is None or t.storage not in in_ptrs and s[1] < i:
                s = [i, i, t.nbytes]
                current[t.storage] = s
                spans.append(s)
            else:
                s[1] = i
                s[2] = max(s[2], t.nbytes)
    for ptr, s in current.items():
        if ptr in out_ptrs:
            s[1] = n
    delta = [0] * (n + 2)
    for start, end, nb in spans:
        delta[start] += nb
        delta[end + 1] -= nb
    base = sum(arg_ptrs.values())
    peak = live = 0
    for d in delta:
        live += d
        peak = max(peak, live)
    return int(base + peak)


# ------------------------------------------------------------ the program
@dataclasses.dataclass
class ExecutableSpec:
    """One program to audit: ``make_args()`` builds fresh arguments (the
    zero batch at the compiled shapes, clones of the params and optimizer
    state) and ``fn(*args)`` is the call recorded.
    ``donated``: positional indices whose tensors the call updates in
    place (AUD002's subjects)."""

    name: str
    fn: Callable
    make_args: Callable[[], tuple]
    donated: Tuple[int, ...] = ()
    allow_undonated: Dict[str, str] = dataclasses.field(default_factory=dict)


def _new_stats() -> Dict[str, Any]:
    return {"ops": 0, "consts_bytes": 0, "args": 0, "donated_args": 0, "suppressed": 0}


def _report(report: Optional[ValidationReport], source: str) -> ValidationReport:
    report = report if report is not None else ValidationReport(source=source, tag="audit")
    if not hasattr(report, "programs"):
        report.programs = {}
    return report


def record_call(fn: Callable, args: tuple, side: bool = True):
    """``(recorder, result, record_s)`` of one call of ``fn`` under a
    :class:`ProgramRecorder` (``side``: see its docstring); raises what
    the call raises."""
    rec = ProgramRecorder(side)
    # the arguments' storages as the call receives them (a step may
    # rebind its state containers' entries)
    rec.arg_infos = [_info(t) for t in _tensors(args)]
    t0 = time.perf_counter()
    with rec:
        out = fn(*args)
    return rec, out, time.perf_counter() - t0


def audit_recorded(name: str, rec: ProgramRecorder, out, *,
                   donated: Sequence[int] = (), donated_before=None,
                   allow_undonated: Optional[Dict[str, str]] = None, config=None,
                   report: Optional[ValidationReport] = None, source: str = "program",
                   record_s: float = 0.0) -> ValidationReport:
    """Run every AUD check over one recorded call. ``donated_before``:
    the ``(path, TensorInfo)`` of the donated arguments taken before the
    call (in-place updates keep the storage; the info is what it was)."""
    report = _report(report, source)
    t0 = time.perf_counter()
    const_thresh = int(getattr(config, "audit_const_bytes", DEFAULT_CONST_BYTES)
                       or DEFAULT_CONST_BYTES)
    donate_thresh = int(getattr(config, "audit_donate_bytes", DEFAULT_DONATE_BYTES)
                        or DEFAULT_DONATE_BYTES)
    stats = _new_stats()
    stats["ops"] = len(rec.ops)
    arg_ptrs = {i.storage: i.nbytes for i in rec.arg_infos if i.storage}
    stats["args"] = len(rec.arg_infos)
    out_ptrs = {_info(t).storage for t in _tensors(out)}
    _check_consts(name, rec, set(arg_ptrs), report, const_thresh, stats)
    if donated_before is not None:
        after = {}
        outs = out if isinstance(out, tuple) else (out,)
        for pos in donated:
            if pos < len(outs):
                after.update(dict(flatten_with_paths(outs[pos], f"arg{pos}")))
        _check_donation(name, donated_before, after, report, donate_thresh,
                        dict(allow_undonated or {}), stats)
    _check_callbacks(name, rec, report, stats)
    _check_accumulators(name, rec, report, stats)
    _check_collectives(name, rec, report, stats)
    stats["collective_sequence"] = [(c.kind, len(c.ranks)) for c in rec.collectives]
    stats["static_peak_bytes"] = _liveness(rec, arg_ptrs, out_ptrs)
    # where the program's host work is issued: the busiest source lines
    stats["ops_by_site"] = dict(Counter(_site(op) for op in rec.ops).most_common(TOP_SITES))
    stats["kernels"] = dict(rec.kernels)
    stats["staged_bytes"] = int(rec.staged_bytes)
    stats["record_s"] = round(record_s, 6)
    stats["walk_s"] = round(time.perf_counter() - t0, 6)
    report.programs[name] = stats
    return report


def audit_spec(spec: ExecutableSpec, *, config=None,
               report: Optional[ValidationReport] = None,
               source: str = "program") -> ValidationReport:
    """Record one :class:`ExecutableSpec`'s call and audit it. A call
    that raises becomes an AUD000 warning rather than masking the compile
    (the first real call surfaces the true error with full context)."""
    report = _report(report, source)
    try:
        args = spec.make_args()
        before = []
        for pos in spec.donated:
            before += [(p, _info(t)) for p, t in flatten_with_paths(args[pos], f"arg{pos}")]
        rec, out, record_s = record_call(spec.fn, args)
    except Exception as e:  # noqa: BLE001 — the audit must not mask compile
        report.add("AUD000",
                   f"program '{spec.name}' could not be recorded for audit: "
                   f"{type(e).__name__}: {e}", severity="warning")
        report.programs[spec.name] = dict(_new_stats(), trace_failed=True)
        return report
    return audit_recorded(spec.name, rec, out, donated=spec.donated,
                          donated_before=before, allow_undonated=spec.allow_undonated,
                          config=config, report=report, source=source,
                          record_s=record_s)


def audit_compiled_model(cm, *, config=None, source: str = "compile",
                         skip: Sequence[str] = ()) -> ValidationReport:
    """Audit every step program a CompiledModel lists in ``audit_exec``
    (runtime/compiler.py). ``skip`` names programs the caller will never
    call (``train_step`` when a pipeline engine trains)."""
    report = ValidationReport(source=f"audit:{source}", tag="audit")
    report.programs = {}
    for spec in (getattr(cm, "audit_exec", None) or []):
        if spec.name in skip:
            continue
        audit_spec(spec, config=config, report=report, source=source)
    return report


def count_metrics(report: ValidationReport, programs: int) -> None:
    """The ``audit.*`` counters a gate run adds to."""
    from ..obs.metrics import metrics_registry

    reg = metrics_registry()
    reg.counter("audit.programs").inc(programs)
    reg.counter("audit.errors").inc(len(report.errors))
    reg.counter("audit.warnings").inc(len(report.warnings))


# --------------------------------- AUD002 (caller side): donated reuse
def _attach_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._pa_parent = node  # type: ignore[attr-defined]


def _enclosing_stmt(node: ast.AST) -> Optional[ast.stmt]:
    cur = node
    while cur is not None and not isinstance(cur, ast.stmt):
        cur = getattr(cur, "_pa_parent", None)
    return cur


def _scope_walk(fn: ast.AST):
    """Walk one function's own scope: nested def/lambda subtrees are
    pruned (their same-named params are different bindings)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _assign_target_names(stmt: Optional[ast.stmt]) -> set:
    names = set()
    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    names.add(n.id)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        for n in ast.walk(stmt.target):
            if isinstance(n, ast.Name):
                names.add(n.id)
    return names


def lint_donated_reuse(src: str, filename: str = "<string>",
                       donating: Optional[Dict[str, Tuple[Tuple[int, ...], int]]] = None
                       ) -> List[Finding]:
    """AUD002 caller-side check: a local name passed at a donated
    position of a step call and then read again (before any rebind) in
    the same function. In the port the step updates that buffer in
    place, so the later read sees the updated value, not the one the
    caller passed. Only ``obj.method(...)`` calls with the table's
    minimum arity count; rebinding in the same assignment
    (``p, s, ... = cm.train_step(p, s, ...)``) is the sanctioned idiom.
    Suppress with ``# audit: donate-ok (reason)`` on the reuse line."""
    donating = dict(DONATING_STEP_CALLS if donating is None else donating)
    findings: List[Finding] = []
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError as e:
        findings.append(Finding(code="HOT000", severity="error", file=filename,
                                line=e.lineno or 0, message=f"syntax error: {e.msg}"))
        return findings
    _attach_parents(tree)
    lines = src.splitlines()
    for fn in [n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        for call in [n for n in _scope_walk(fn) if isinstance(n, ast.Call)]:
            if not isinstance(call.func, ast.Attribute):
                continue
            attr = call.func.attr
            if attr not in donating:
                continue
            positions, min_args = donating[attr]
            if len(call.args) < min_args:
                continue
            rebound = _assign_target_names(_enclosing_stmt(call))
            for pos in positions:
                if not (-len(call.args) <= pos < len(call.args)):
                    continue
                arg = call.args[pos]
                if not isinstance(arg, ast.Name) or arg.id in rebound:
                    continue
                nm = arg.id
                events = sorted(((n.lineno, n) for n in _scope_walk(fn)
                                 if isinstance(n, ast.Name) and n.id == nm
                                 and n.lineno > call.lineno), key=lambda t: t[0])
                for lineno, n in events:
                    if isinstance(n.ctx, ast.Store):
                        break
                    if pragmas.line_has(lines, lineno, "audit", "donate-ok"):
                        break
                    findings.append(Finding(
                        code="AUD002", severity="error", file=filename, line=lineno,
                        message=f"'{nm}' was donated to {attr}() at line {call.lineno} "
                                f"and is read again here — the step updated it in "
                                f"place (annotate '# audit: donate-ok (reason)' if "
                                f"this is not a live read)"))
                    break
    return findings


def lint_donated_reuse_paths(paths: Sequence[str]) -> List[Finding]:
    """Run :func:`lint_donated_reuse` over .py files/directories."""
    findings: List[Finding] = []
    for p in paths:
        files = []
        if os.path.isfile(p):
            files = [p]
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                files.extend(os.path.join(dirpath, f) for f in sorted(filenames)
                             if f.endswith(".py"))
        for f in files:
            with open(f) as fh:
                findings.extend(lint_donated_reuse(fh.read(), filename=f))
    return findings


# ------------------------------------------- one call, both gates
def audit_mode(config) -> str:
    """The validated ``config.audit_programs`` mode ("off" without a config)."""
    return gate_mode(getattr(config, "audit_programs", "off"), "audit_programs")


def audit_call(name: str, fn: Callable, args: tuple, *, config, device, source: str,
               static_peak=None, report: Optional[ValidationReport] = None,
               count: bool = True, side: bool = True):
    """One call of a program that is not a compile's step (the serving
    decode steps, the pipeline's single-call program), recorded for the
    program audit (``config.audit_programs``) and measured for the
    executable telemetry (``config.exec_telemetry``): one call serves
    both gates. Returns ``(report, telemetry, box)``: the audit report
    (None when the audit is off), the telemetry block (None when it is
    off) and ``{"out": result}`` when the call returned, or
    ``{"error": exception}`` when it raised. A call that raises is an
    AUD000 warning and an ``unavailable`` telemetry reason, never an
    exception here; nor does this apply the audit's mode: the caller
    does, with ``report.handle``. Its OBS002 estimate is the audit's static
    peak when the audit ran, else ``static_peak``. ``count``: add the
    program to the ``audit.*`` counters (a compile counts its report's
    programs once, at its end). ``side``: False for a real step, whose
    launches and collectives also count process-wide."""
    from ..obs.exec_telemetry import (_feed_metrics, collect_traced,
                                      reconcile_peak_memory, telemetry_mode)

    mode, tmode = audit_mode(config), telemetry_mode(config)
    box: Dict[str, Any] = {}
    if mode == "off" and tmode == "off":
        return None, None, box

    def call():
        try:
            if mode != "off":
                box["rec"], box["out"], box["record_s"] = record_call(fn, args, side)
            else:
                box["out"] = fn(*args)
        except Exception as e:
            box["error"] = e
            raise

    tel = err = None
    if tmode == "on":
        prog = collect_traced(name, call, device)
        _feed_metrics(name, prog)
        tel = {"programs": {name: prog}}
        err = prog.get("unavailable")
    else:
        try:
            call()
        except Exception as e:  # noqa: BLE001 — the audit must not mask the program
            err = f"{type(e).__name__}: {e}"
    if mode != "off":
        report = _report(report, source)
        if "rec" in box:
            audit_recorded(name, box["rec"], box["out"], config=config, report=report,
                           source=source, record_s=box["record_s"])
            static_peak = report.programs[name]["static_peak_bytes"]
        else:
            report.add("AUD000", f"program '{name}' could not be recorded for audit: {err}",
                       severity="warning")
            report.programs[name] = dict(_new_stats(), trace_failed=True)
        if count:
            count_metrics(report, 1)
    if tel is not None and tel["programs"][name].get("peak_bytes"):
        tel["reconciliation"] = [reconcile_peak_memory(
            name, static_peak, tel["programs"][name]["peak_bytes"], config=config,
            allow=getattr(config, "exec_mem_allow", None))]
    box.pop("rec", None)
    return report, tel, box
