"""Profiling: torch.profiler traces and an op-level cost count.

Port of ``openglraytracer_tpu/utils/profiling.py``. ``trace`` captures a
``torch.profiler`` trace (CPU activity, and CUDA activity where a card is
present) into a directory as a TensorBoard/Chrome trace. ``cost_analysis``
stands in for XLA's per-compilation cost analysis, under its key names:
XLA's counts are of fused HLO and cannot be reproduced op by op, and
``torch.utils.flop_counter.FlopCounterMode`` counts matrix products only,
about 0 for this renderer, which is elementwise. So a dispatch mode counts
every aten op that the function runs:

  * "bytes accessed": the bytes of each op's tensor inputs and outputs
    (a view or an allocation counts too; a kernel's own reads and writes
    are not seen, it runs through ctypes);
  * "flops": the output elements of each arithmetic op (``ARITHMETIC``:
    elementwise math, comparisons excluded, and reductions), plus 2·M·N·K
    for each matrix product (``mm``, ``bmm``, ``addmm``, ``baddbmm``);
  * "launches": each hand kernel's launches, by wrapper name
    (kernels.LAUNCHES).

The program's own spans and counters. ``span(layer, name)`` marks a layer
boundary of a frame or a step (raygen, broad_phase, narrow_phase, shade,
soft_composite, backward, optimizer, quantize, under the entry layer's
``render`` and ``step``); ``count(name, value)`` records the work a layer
was given (``primary_trips``, ``shadow_trips`` and ``narrow_tiles`` from
ops/culled.py; ``soft_rays``, ``soft_kept_pairs`` and ``soft_live_pairs``
from ops/soft.py; ``raygen_calls`` and ``raygen_graph_replays`` from
ops/raygen.py). The soft forward's spans are ``broad_phase/soft_tile_cones``
and ``broad_phase/soft_compact``, ``soft_composite/block`` (a block's
forward; one a view on the card) and, on the CPU's plain path only,
``soft_composite/recompute`` (a block's recompute in the backward, under
checkpoint), inside ``soft_composite/view`` (train/inverse.py, one a
view of a soft step). Tracing is on exactly while a
torch.profiler session records (``trace``, ``cli render/fit
--profile-dir``, or any other session): a span then opens a
``record_function`` range named ``oglrt/<layer>/<name>``, which the trace
shows beside the kernels it launched, and appends to an in-memory record
that ``record()`` returns after the session. Off, ``span`` returns one
shared null context and ``count`` returns at once: neither opens a range
nor records anything.

A layer's host time in a Chrome trace: on the thread that holds the
``oglrt/entry/...`` ranges, the time its ``oglrt/<layer>/...`` ranges
cover less the parts covered by ranges of another layer inside them (the
narrow phase's ``culled_geometry`` holds the broad phase's ranges). The
backward runs partly on autograd's device thread; on the caller's thread
``oglrt/backward/autograd`` covers all of it.

A new record begins with the first span or counter made while tracing is
on after a call (or ``record()``) found it off, so each session of a
process has its own; two sessions with no call of the program and no read
between them share one. The record's times are taken just inside each
range, on the profiler's clock (``time.time_ns``), so they lie within a
few microseconds of the range's event, except in a session's first range,
whose clock reading is late by up to a millisecond.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from openglraytracer_tpu_torch import kernels

# aten ops counted at one float operation an output element
ARITHMETIC = frozenset({
    "add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "div", "div_",
    "neg", "abs", "sqrt", "rsqrt", "reciprocal", "exp", "log", "pow",
    "sin", "cos", "tan", "atan2", "maximum", "minimum", "clamp", "clamp_",
    "clamp_min", "clamp_max", "fmod", "remainder", "floor", "ceil",
    "sigmoid", "tanh", "sum", "mean", "amax", "amin", "prod", "cumsum",
    "addcmul", "addcdiv", "lerp", "index_add", "index_add_", "square",
    "linalg_vector_norm", "norm", "dot"})
_PRODUCTS = frozenset({"mm", "bmm", "addmm", "baddbmm"})


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace into log_dir, viewable in TensorBoard
    or as a Chrome trace (CPU, and CUDA where a card is present)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def _bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


class _CostCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        self.bytes += _bytes((args, kwargs)) + _bytes(out)
        if name in _PRODUCTS:
            a, b = (args[1], args[2]) if name.startswith(("addmm", "badd")) \
                else (args[0], args[1])
            self.flops += 2 * a.numel() * b.shape[-1]
        elif name in ARITHMETIC:
            self.flops += sum(t.numel() for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor))
        return out


def cost_analysis(fn, *args, **kwargs) -> dict:
    """{"flops", "bytes accessed", "launches"} of one call of
    fn(*args, **kwargs), counted as the module docstring says (fn runs
    once)."""
    before = kernels.LAUNCHES.copy()
    count = _CostCount()
    with count:
        fn(*args, **kwargs)
    launches = kernels.LAUNCHES - before
    return {"flops": float(count.flops),
            "bytes accessed": float(count.bytes),
            "launches": dict(launches)}


def flops_estimate(fn, *args, **kwargs) -> float:
    return float(cost_analysis(fn, *args, **kwargs).get("flops", 0.0))


# ---------------------------------------------------------------------------
# The program's spans and counters
# ---------------------------------------------------------------------------

SPAN_PREFIX = "oglrt/"
# a span of this layer with none open on its thread begins a unit: one
# frame (ops/render.py render) or one training step (train/inverse.py
# step_fn), whose spans and counters share its sequence number
ENTRY = "entry"
# what span returns while tracing is off, for every call
OFF = contextlib.nullcontext()


class SpanRecord(NamedTuple):
    """One span: its times are the profiler's clock (Unix-epoch ns, as
    time.time_ns), taken just after its range opened and just before it
    closed. parent: the index in Record.spans of the span open on the same
    thread when it opened (None: none was); unit: the sequence number of
    its frame or step."""
    layer: str
    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    unit: int
    thread: int


class Counter(NamedTuple):
    """A counter's value in the last unit that recorded it."""
    unit: int
    value: int


class Record(NamedTuple):
    """What the newest profiler session recorded: its spans in the order
    they opened, and each counter of its last unit that recorded it."""
    spans: list
    counters: dict


class _State:
    """The record of the newest profiler session. One per process, as the
    profiler's session is: the program's spans reach it from any caller or
    thread, and the benchmark reads it after its session."""

    def __init__(self):
        self.lock = threading.Lock()
        # set by every call made while tracing is off: the next span or
        # counter made while it is on begins a new record
        self.stale = True
        self.session = 0
        self.unit = -1
        # [layer, name, start, end, parent's row, unit, thread] each
        self.rows = []
        # name -> [unit, host int, [(device tensor, reduce)]]
        self.counters = {}
        self.local = threading.local()      # each thread's open spans


_STATE = _State()


def _begin(st: _State):
    """Under st.lock: a new record if a call saw tracing off since the last
    one."""
    if st.stale:
        st.stale = False
        st.session += 1
        st.unit = -1
        st.rows = []
        st.counters = {}


def _open_spans(st: _State) -> list:
    local = st.local
    if getattr(local, "session", None) != st.session:
        local.session = st.session
        local.stack = []
        local.entries = 0
    return local.stack


class _Span:
    __slots__ = ("layer", "name", "_range", "_row")

    def __init__(self, layer: str, name: str):
        self.layer, self.name = layer, name

    def __enter__(self):
        self._range = torch.profiler.record_function(
            f"{SPAN_PREFIX}{self.layer}/{self.name}")
        self._range.__enter__()
        start = time.time_ns()
        st = _STATE
        with st.lock:
            _begin(st)
            stack = _open_spans(st)
            if self.layer == ENTRY:
                if st.local.entries == 0:
                    st.unit += 1
                st.local.entries += 1
            self._row = [self.layer, self.name, start, None,
                         stack[-1] if stack else None, st.unit,
                         threading.get_ident()]
            st.rows.append(self._row)
        stack.append(self._row)
        return self

    def __exit__(self, *exc):
        self._row[3] = time.time_ns()
        st = _STATE
        stack = _open_spans(st)
        if stack and stack[-1] is self._row:
            stack.pop()
            if self.layer == ENTRY:
                st.local.entries -= 1
        self._range.__exit__(*exc)
        return False


def span(layer: str, name: str):
    """Context manager of one span of ``layer`` (a frame's or step's
    layer, as the module docstring lists them). Off (no profiler session
    records): the shared null context OFF, nothing recorded. On: a
    record_function range ``oglrt/<layer>/<name>`` and a SpanRecord.
    Tracing is torch's own flag, set while any session runs, on every
    thread."""
    if not _autograd_profiler._is_profiler_enabled:
        _STATE.stale = True
        return OFF
    return _Span(layer, name)


def tracing() -> bool:
    """Whether a profiler session records (spans and counters are on). A
    counter whose value takes launches of its own is computed only then."""
    return _autograd_profiler._is_profiler_enabled


def count(name: str, value, reduce: Callable | None = None):
    """Record a counter of the current unit (frame or step). A host int
    adds to the unit's value. A device tensor is kept by reference (no
    launch, no copy, no wait) and reduced only when record() reads it:
    by reduce(tensor) if given, else by its sum. A new unit's first call
    replaces the previous unit's value, so the record holds the last
    unit's. Off: returns at once."""
    if not _autograd_profiler._is_profiler_enabled:
        _STATE.stale = True
        return
    st = _STATE
    with st.lock:
        _begin(st)
        slot = st.counters.get(name)
        if slot is None or slot[0] != st.unit:
            slot = st.counters[name] = [st.unit, 0, []]
        if isinstance(value, torch.Tensor):
            slot[2].append((value, reduce))
        else:
            slot[1] += int(value)


def record() -> Record:
    """The spans and counters of the newest profiler session (of the one
    running, so far, if called inside it). Device counters are reduced
    here, which waits for the device. A span still open has end_ns None."""
    st = _STATE
    with st.lock:
        if not _autograd_profiler._is_profiler_enabled:
            st.stale = True
        rows = list(st.rows)
        slots = list(st.counters.items())
    index = {id(r): i for i, r in enumerate(rows)}
    spans = [SpanRecord(r[0], r[1], r[2], r[3],
                        None if r[4] is None else index.get(id(r[4])),
                        r[5], r[6]) for r in rows]
    counters = {}
    for name, (unit, host, tensors) in slots:
        total = host
        for t, reduce in tensors:
            total += int(reduce(t) if reduce is not None else t.sum())
        counters[name] = Counter(unit, total)
    return Record(spans, counters)
