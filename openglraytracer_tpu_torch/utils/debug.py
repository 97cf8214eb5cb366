"""Numerical-safety tooling: a NaN-checked render and a finite check.

Port of ``openglraytracer_tpu/utils/debug.py``. The reference wraps its
render in ``checkify`` with ``float_checks``, which flags any primitive
with a NaN in its output, whatever its inputs held. Here a
``TorchDispatchMode`` applies the same rule to every aten op that the
render runs:

  * ``checked_render`` returns (error, image); ``error.throw()`` raises
    ``FloatingPointError`` naming the first op whose floating output held a
    NaN. The ops' flags stay on the device and are read once, at the end.
    The kernels are called through ctypes, out of the mode's sight, so each
    kernel wrapper (``kernels.wrapper``) runs as one op whose outputs are
    checked: its kernel on a CUDA tensor and its plain version on a CPU
    tensor alike. One construction writes NaN on purpose and is exempt:
    kernel B's survivor rows, radius NaN in an invalid slot
    (ops/culled.py ``_shadow_sphere_rows``, ``kernels.unchecked``).
    Ops that allocate without writing (``empty`` and the like) are not
    checked: their memory holds whatever was there.
  * ``assert_finite_tree`` checks every float leaf of a dict, NamedTuple
    or dataclass of tensors and arrays (gradients, parameters, scenes),
    naming the first non-finite leaf by its path.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from openglraytracer_tpu_torch import kernels

# aten ops that allocate without writing
_UNWRITTEN = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided", "resize_"})


class NanError:
    """The outcome of checked_render: get() is None when no op produced a
    NaN, else a message naming the first that did; throw() raises it."""

    def __init__(self, message: str | None):
        self._message = message

    def get(self) -> str | None:
        return self._message

    def throw(self) -> None:
        if self._message is not None:
            raise FloatingPointError(self._message)


class _NanCheck(TorchDispatchMode):
    """Records, for every aten op with a floating output (and every kernel
    wrapper's outputs), a device flag: does the output hold a NaN."""

    def __init__(self):
        super().__init__()
        self.flags, self.names = [], []
        self._paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self._paused and \
                func.overloadpacket.__name__ not in _UNWRITTEN:
            self.record_outputs(str(func), out)
        return out

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def record_outputs(self, name: str, out) -> None:
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and t.numel():
                with self.paused():     # a kernel wrapper's check runs
                    flag = torch.isnan(t).any()     # outside the mode
                self.flags.append(flag)
                self.names.append(name)

    def error(self) -> NanError:
        if not self.flags:
            return NanError(None)
        dev = next((f.device for f in self.flags if f.device.type != "cpu"),
                   torch.device("cpu"))
        bad = torch.stack([f.to(dev) for f in self.flags]).cpu().nonzero()
        if not len(bad):
            return NanError(None)
        i = int(bad[0])
        return NanError(f"nan generated by {self.names[i]} (op {i + 1} of "
                        f"{len(self.names)} checked)")


def checked_render(scene, camera, height, width, **kwargs):
    """Render (without autograd) under the NaN check; returns (error,
    image). error.throw() raises if any op of the pipeline produced a NaN
    (kernel B's exempt rows aside). kwargs are ops/render.render's."""
    from openglraytracer_tpu_torch.ops.render import render
    check = _NanCheck()
    token = kernels.NAN_CHECK.set(check)
    try:
        with check, torch.no_grad():
            image = render(scene, camera, height, width, **kwargs)
    finally:
        kernels.NAN_CHECK.reset(token)
    return check.error(), image


def _leaves(tree, path: str):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), f"{path}.{k}")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_finite_tree(tree, name: str = "tree") -> None:
    """Host-side finite check over every float leaf (for grads/params):
    raises FloatingPointError naming the first non-finite leaf's path."""
    for path, leaf in _leaves(tree, name):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating) and \
                not np.isfinite(arr).all():
            raise FloatingPointError(f"non-finite values in {path}")
