"""Spans of a traced run and their reduction to per-layer numbers.

``Spans`` wraps the program's functions that ``layers/<layer>.json`` name
(``"functions"``: ``"module:attribute"``; ``"returned"``: a factory and
the positions of the callables it returns that are to be wrapped) in
``torch.profiler.record_function`` ranges named ``bench/<layer>/<name>``.
A function is replaced wherever a module of the program holds it, so a
name imported elsewhere is spanned too. The loops add ``bench/window``
(the traced window) and ``bench/unit`` (one frame or step).

``reduce`` reads the profiler's events: each device operation (kernel,
copy, set) is tied to the host call that launched it by its correlation
id, and counts for the innermost layer span open at that launch (its
device time) and for every layer span open then (its launches). The
device's busy time is the union of its operations' intervals inside the
window; the idle gaps are labelled with what the host was doing when each
began.
"""

from __future__ import annotations

import functools
import importlib
import json
import sys
from collections import defaultdict
from pathlib import Path

import torch

from benchmark.port import PACKAGE

PREFIX = "bench/"


def _spanned(fn, name):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


class Spans:
    def __init__(self, layer_files):
        self.layers = {}
        for path in layer_files:
            with open(path) as f:
                self.layers[Path(path).stem] = json.load(f)
        self._undo = []

    def span(self, name):
        return torch.profiler.record_function(name)

    def _replace(self, mod, fn, wrapped):
        holders = [mod] + [m for name, m in list(sys.modules.items())
                           if m is not None and name.split(".")[0] == PACKAGE]
        for m in holders:
            for key, value in list(vars(m).items()):
                if value is fn:
                    setattr(m, key, wrapped)
                    self._undo.append((m, key, fn))

    def install(self):
        for layer, spec in self.layers.items():
            for target in spec.get("functions", []):
                mod_name, attr = target.split(":")
                mod = importlib.import_module(mod_name)
                fn = getattr(mod, attr)
                self._replace(mod, fn, _spanned(fn, f"{PREFIX}{layer}/{attr}"))
            for target, positions in spec.get("returned", {}).items():
                mod_name, attr = target.split(":")
                mod = importlib.import_module(mod_name)
                self._replace(mod, getattr(mod, attr), self._factory(
                    getattr(mod, attr), layer, attr, positions))

    def _factory(self, fn, layer, attr, positions):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            out = list(fn(*args, **kwargs))
            for i in positions:
                out[i] = _spanned(out[i], f"{PREFIX}{layer}/{attr}[{i}]")
            return tuple(out)
        return call

    def uninstall(self):
        for m, key, fn in reversed(self._undo):
            setattr(m, key, fn)
        self._undo = []


def start_profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def _is_runtime(name: str) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
    cudaMemcpyAsync, ...)."""
    return name.startswith("cuda") or (
        name.startswith("cu") and len(name) > 2 and name[2].isupper())


class Summary:
    """What a traced window read: per-unit layer numbers, busy and idle."""

    def __init__(self, units, window_s, busy_s, layer_ms, layer_launches,
                 ops, gaps, links):
        self.units = units
        self.window_s = window_s
        self.busy_s = busy_s
        self.layer_ms = layer_ms
        self.layer_launches = layer_launches
        self.ops = ops
        self.gaps = gaps
        self.links = links

    def per_unit_ms(self, layer: str):
        if self.units == 0 or layer not in self.layer_launches:
            return None
        return self.layer_ms.get(layer, 0.0) / self.units

    def per_unit_launches(self, layer: str):
        if self.units == 0 or layer not in self.layer_launches:
            return None
        return self.layer_launches[layer] / self.units

    def idle_pct(self):
        if self.window_s <= 0 or self.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self):
        top = sorted(self.ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _innermost(open_list, ends, x):
    """Drop the closed entries of open_list at time x; return it."""
    return [i for i in open_list if ends[i] >= x]


def reduce(prof, units: int, spans: Spans) -> Summary:
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    gpu = []            # (start, end, name, corr, linked)
    cpu = []            # (start, end, name, corr)
    for e in events:
        name = e.name()
        s = e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            gpu.append((s, s + e.duration_ns(), name, e.correlation_id(),
                        e.linked_correlation_id()))
        else:
            cpu.append((s, s + e.duration_ns(), name, e.correlation_id()))
    # a record_function range (the spans, torch.optim's) has a device-side
    # copy of the same name that spans the range, not an operation: it
    # counts for neither the busy time nor a layer
    host_names = {c[2] for c in cpu}
    gpu = [g for g in gpu if g[2] not in host_names]
    win = [c for c in cpu if c[2] == PREFIX + "window"]
    if not win:
        raise RuntimeError("the traced window's span is missing")
    w0, w1 = win[0][0], win[0][1]
    window_s = (w1 - w0) / 1e9

    runtime = {c[3]: c[0] for c in cpu if _is_runtime(c[2])}
    ops_by_id = {c[3]: c[0] for c in cpu if not _is_runtime(c[2])}
    layer_spans = []
    for c in cpu:
        if c[2].startswith(PREFIX):
            parts = c[2][len(PREFIX):].split("/")
            if parts[0] in spans.layers:
                layer_spans.append((c[0], c[1], parts[0]))
    layer_spans.sort()
    s_start = [s[0] for s in layer_spans]
    s_end = [s[1] for s in layer_spans]

    gpu = [g for g in gpu if w0 <= g[0] <= w1]
    links = {"device_ops": len(gpu), "via_runtime": 0, "via_op": 0,
             "unlinked": 0}
    launches = []
    for i, g in enumerate(gpu):
        t = runtime.get(g[3])
        if t is not None:
            links["via_runtime"] += 1
        else:
            t = ops_by_id.get(g[4])
            if t is not None:
                links["via_op"] += 1
            else:
                links["unlinked"] += 1
                continue
        launches.append((t, i))
    launches.sort()

    layer_ms = defaultdict(float)
    layer_launches = defaultdict(int)
    for layer in spans.layers:
        if any(s[2] == layer for s in layer_spans
               if w0 <= s[0] <= w1):
            layer_launches[layer] += 0
    open_l, k = [], 0
    for t, i in launches:
        while k < len(layer_spans) and s_start[k] <= t:
            open_l.append(k)
            k += 1
        open_l = _innermost(open_l, s_end, t)
        if not open_l:
            continue
        g = gpu[i]
        layer_ms[layer_spans[open_l[-1]][2]] += (g[1] - g[0]) / 1e6
        for layer in {layer_spans[j][2] for j in open_l}:
            layer_launches[layer] += 1

    # busy: the union of the device intervals, clipped to the window
    ivs = sorted((max(g[0], w0), min(g[1], w1)) for g in gpu)
    busy, gaps_iv, cur_s, cur_e = 0, [], None, None
    prev_end = w0
    for s, e in ivs:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                prev_end = cur_e
            if s > prev_end:
                gaps_iv.append((prev_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if w1 > cur_e:
            gaps_iv.append((cur_e, w1))

    ops = defaultdict(float)
    for g in gpu:
        ops[g[2][:120]] += (min(g[1], w1) - max(g[0], w0)) / 1e9

    # label each idle gap by the host's innermost open event at its start
    cpu_w = sorted(c for c in cpu if c[1] >= w0 and c[0] <= w1
                   and c[2] != PREFIX + "window")
    c_start = [c[0] for c in cpu_w]
    c_end = [c[1] for c in cpu_w]
    gaps = defaultdict(float)
    open_c, k = [], 0
    for gs, ge in gaps_iv:
        while k < len(cpu_w) and c_start[k] <= gs:
            open_c.append(k)
            k += 1
        open_c = _innermost(open_c, c_end, gs)
        names = [cpu_w[j][2] for j in open_c]
        layer = next((n for n in reversed(names) if n.startswith(PREFIX)),
                     "outside the spans")
        inner = names[-1] if names else "host between calls"
        label = layer if inner == layer else f"{layer} > {inner}"
        gaps[label[:120]] += (ge - gs) / 1e9
    return Summary(units, window_s, busy / 1e9, dict(layer_ms),
                   dict(layer_launches), dict(ops), dict(gaps), links)
