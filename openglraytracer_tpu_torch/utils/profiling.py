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
"""

from __future__ import annotations

import contextlib

import torch
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
