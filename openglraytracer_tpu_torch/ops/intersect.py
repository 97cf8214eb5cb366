"""Hit record and the numeric guards of the intersection math.

Port of the constants, ``Hit`` and the small helpers of
``openglraytracer_tpu/ops/intersect.py`` that the culled and dense narrow
phases (``ops/culled.py``, ``ops/dense.py``) and their winner replay
(``ops/geometry.py``) use; ``_inv_safe`` and ``_fma`` are the kernels'
reciprocal and ``fmaf`` as their plain versions compute them. The
plain-XLA dense engine of that module is not part of this package yet (see
ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INF_T = 1.0e10
_DIV_EPS = 1.0e-12
_SQRT_EPS = 1.0e-20


class Hit(NamedTuple):
    """The reference's Collision struct, SoA over rays."""

    t: torch.Tensor         # (R,) hit distance; >= MISS_T on miss
    p: torch.Tensor         # (R, 3) world hit point
    n: torch.Tensor         # (R, 3) world unit normal (flipped when inside)
    inside: torch.Tensor    # (R,) bool — ray started inside the object
    material_id: torch.Tensor  # (R,) int32 (0 on miss)
    obj_id: torch.Tensor    # (R,) int32 global object index (-1 on miss)
    hit: torch.Tensor       # (R,) bool


def _safe_div(a, b):
    """a / b with |b| clamped away from 0 (sign-preserving)."""
    b_safe = torch.where(torch.abs(b) < _DIV_EPS,
                         torch.where(b < 0, -_DIV_EPS, _DIV_EPS), b)
    return a / b_safe


def _inv_safe(x):
    """Sign-preserving 1/x, |x| clamped away from 0."""
    xs = torch.where(torch.abs(x) < _DIV_EPS,
                     torch.where(x < 0, -_DIV_EPS, _DIV_EPS), x)
    return 1.0 / xs


def _fma(a, b, c):
    """a * b + c rounded once, as the kernel's fmaf: the float32 product is
    exact in float64, so only the sum rounds (the float64 -> float32 double
    rounding differs from fmaf on a tie, about once in 2^29)."""
    return (a.double() * b.double() + c.double()).float()


def _safe_normalize(v, dim=-1):
    n2 = torch.sum(v * v, dim=dim, keepdim=True)
    return v * torch.rsqrt(torch.clamp(n2, min=_SQRT_EPS))


# The 3x3 products are written out component by component, in the order of
# the reference, so that each sum rounds as it does there.

def _rot_apply(rot, vx, vy, vz):
    """rot: (..., 3, 3); v components broadcastable -> rotated components."""
    rx = rot[..., 0, 0] * vx + rot[..., 0, 1] * vy + rot[..., 0, 2] * vz
    ry = rot[..., 1, 0] * vx + rot[..., 1, 1] * vy + rot[..., 1, 2] * vz
    rz = rot[..., 2, 0] * vx + rot[..., 2, 1] * vy + rot[..., 2, 2] * vz
    return rx, ry, rz


def _rot_apply_t(rot, vx, vy, vz):
    """Apply rot^T (world -> local for an orthonormal rotation)."""
    rx = rot[..., 0, 0] * vx + rot[..., 1, 0] * vy + rot[..., 2, 0] * vz
    ry = rot[..., 0, 1] * vx + rot[..., 1, 1] * vy + rot[..., 2, 1] * vz
    rz = rot[..., 0, 2] * vx + rot[..., 1, 2] * vy + rot[..., 2, 2] * vz
    return rx, ry, rz
