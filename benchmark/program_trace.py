"""The program's own spans and counters of a traced window: the record that
the port's ``utils/profiling.py`` keeps while a torch.profiler session
runs (``record()``: spans ``oglrt/<layer>/<name>`` on the profiler's
clock, each with its parent on its thread and its unit, one a frame or
step; counters of the last unit). This file and ``port.py`` are the
benchmark's only files that reach the program.

A program that keeps no such record (``record`` missing) reads as
nothing: every metric built on it returns None and its line leaves it out.

Host time is read on the threads that hold the entry layer's spans (the
caller's; the backward's spans on autograd's device thread are not added
again). A layer's host time is its self time: the time in which one of
its spans is the innermost open on that thread, which is each span's
duration less its children's, summed over the layer. The window's last
unit stands for every unit in its counters: a cell's layout is fixed, so
every frame or step gives the culled narrow phase the same lists.
"""

from __future__ import annotations

import importlib
from collections import defaultdict

from benchmark.port import PACKAGE

ENTRY = "entry"
_cache = [None, None]       # [the traced window's summary, its Program]


class Program:
    """What one traced window's record reads: per-layer self ns and the
    outermost entry spans' ns on the entry threads, and the counters."""

    def __init__(self, spans, counters):
        threads = {s.thread for s in spans if s.layer == ENTRY}
        done = [s.end_ns is not None for s in spans]
        child_ns = defaultdict(int)
        for s, ok in zip(spans, done):
            if ok and s.parent is not None:
                child_ns[s.parent] += s.end_ns - s.start_ns
        self.self_ns = defaultdict(int)
        self.enqueue_ns = 0
        for i, (s, ok) in enumerate(zip(spans, done)):
            if not ok or s.thread not in threads:
                continue
            self.self_ns[s.layer] += s.end_ns - s.start_ns - child_ns[i]
            if s.layer == ENTRY and not _entry_above(s, spans):
                self.enqueue_ns += s.end_ns - s.start_ns
        self.layers = {s.layer for s in spans if s.thread in threads}
        self.counters = counters


def _entry_above(s, spans) -> bool:
    p = s.parent
    while p is not None:
        if spans[p].layer == ENTRY:
            return True
        p = spans[p].parent
    return False


def read(trace):
    """The Program of the traced window ``trace`` (benchmark/spans.py's
    Summary; read once, kept for the window's other metrics), or None
    where the program keeps no record or the record holds no span."""
    if _cache[0] is trace:
        return _cache[1]
    try:
        profiling = importlib.import_module(f"{PACKAGE}.utils.profiling")
    except ImportError:
        return None
    record = getattr(profiling, "record", None)
    out = None
    if record is not None:
        rec = record()
        if rec.spans:
            out = Program(rec.spans, rec.counters)
    _cache[0], _cache[1] = trace, out
    return out


def host_ms(trace, layer: str):
    """Host ms a frame or step in ``layer``'s self time; None where the
    window recorded no span of it."""
    prog = read(trace)
    if prog is None or layer not in prog.layers or not trace.units:
        return None
    return prog.self_ns[layer] / 1e6 / trace.units


def enqueue_ms(trace):
    """Host ms a frame or step inside the outermost entry spans: the whole
    enqueue of a frame (render) or a step (step_fn)."""
    prog = read(trace)
    if prog is None or ENTRY not in prog.layers or not trace.units:
        return None
    return prog.enqueue_ns / 1e6 / trace.units


def tests_per_ray(trace, trips: str):
    """Pair tests a ray of the last unit made in the narrow phase: the
    counter ``trips`` (trip counts summed over the tiles) over the
    ``narrow_tiles`` of the same unit. Every tile holds the same rays, so
    this is the trips times each tile's rays over the rays."""
    prog = read(trace)
    if prog is None:
        return None
    got, tiles = prog.counters.get(trips), prog.counters.get("narrow_tiles")
    if got is None or tiles is None or got.unit != tiles.unit \
            or tiles.value <= 0:
        return None
    return got.value / tiles.value
