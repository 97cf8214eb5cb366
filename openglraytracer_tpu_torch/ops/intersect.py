"""Hit record and the numeric guards of the intersection math.

Port of the constants and ``Hit`` of ``openglraytracer_tpu/ops/intersect.py``.
The dense all-objects engine of that module is not part of this package yet
(see ROADMAP.md); the culled narrow phase lives in ``ops/culled.py``.
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


def _safe_normalize(v, dim=-1):
    n2 = torch.sum(v * v, dim=dim, keepdim=True)
    return v * torch.rsqrt(torch.clamp(n2, min=_SQRT_EPS))
