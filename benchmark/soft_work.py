"""The work of a soft fit step that any implementation must do, counted
once from the soft forward's equations (``reference/soft.py``), for
``metrics/soft_roofline_pct.py``; and the program's soft counters per ray.

Float operations, an add, multiply, min or max one each and a fused
multiply-add two (the H100's 67 TFLOP/s of float32 counts it as two);
a division, square root, reciprocal square root, exp or log one each,
though each costs more. Comparisons and selects count nothing. Terms that
are constant for a sphere over every ray (a light's ambient times the
material's, its diffuse and specular products, the emissive colour) are
not counted per pair: an implementation can take them once a sphere.

Per live ray-sphere pair (coverage non-zero after the cut and the front
gate: the program's ``soft_live_pairs``), forward:
  oc = o - c 3, b = oc . d 5, |oc|^2 5, r^2 1, disc = r^2 - (|oc|^2 - b^2)
  3, logit = disc / (bw r^2) 2, sigmoid 3, t = -b - sqrt(disc) 2, the
  clamp of t 2, p = o + t d 6, p - c 3, its normalisation 9;
  per light: l = lp - p 3 and its normalisation 9, cos_t 5, the reflection
  2 cos_t n - l 7, its length 6, cos_p 6, diffuse 8 (max, and four
  multiply-adds), specular 11 (pow as exp(s log x), and four multiply-adds);
  rgb * alpha 3, the weight alpha exp((t_min - t) / gamma) 4, the sums of
  the weight and of the weighted colour 7.
Per ray: the background's weight 3, the quotient 4, the squared error 9;
per plane its hit 12, point 6, shade as a pair's per light, alpha and
weight 7 and sums 7.

The backward is counted at the forward's count (each operation's adjoint
is at least one operation), and no recompute, no dead and no culled pair
is counted, so that the count is a floor of any implementation's work and
a kernel judged on it cannot read above 100 %. Bytes: each ray reads its
target's three float32 channels once; rays are made on the chip, and the
scene's rows are small beside them.
"""

from __future__ import annotations

from benchmark import program_trace

PEAK_FLOPS = 67e12          # H100 SXM, float32 without tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM, HBM3

PAIR_BASE = 3 + 5 + 5 + 1 + 3 + 2 + 3 + 2 + 2 + 6 + 3 + 9 + 3 + 4 + 7
PAIR_LIGHT = 3 + 9 + 5 + 7 + 6 + 6 + 8 + 11
RAY_BASE = 3 + 4 + 9
PLANE_BASE = 12 + 6 + 3 + 7 + 7
TARGET_BYTES = 3 * 4


def pair_flops(lights: int) -> int:
    """Forward and backward float operations of one live pair."""
    return 2 * (PAIR_BASE + PAIR_LIGHT * lights)


def ray_flops(lights: int, planes: int) -> int:
    """Forward and backward float operations of one ray beside its pairs."""
    return 2 * (RAY_BASE + planes * (PLANE_BASE + PAIR_LIGHT * lights))


def ideal_ms(live_pairs: int, rays: int, lights: int, planes: int) -> float:
    """max(bytes / 3.35 TB/s, float ops / 67 TFLOP/s) of a step's work,
    in ms."""
    flops = live_pairs * pair_flops(lights) + rays * ray_flops(lights,
                                                                planes)
    return 1e3 * max(rays * TARGET_BYTES / PEAK_BYTES, flops / PEAK_FLOPS)


def counters(trace, *names):
    """The program's counters ``names`` of the traced window's last unit,
    or None where the program keeps none of them or they come from
    different units."""
    prog = program_trace.read(trace)
    if prog is None:
        return None
    got = [prog.counters.get(n) for n in names]
    if any(c is None for c in got) or len({c.unit for c in got}) != 1:
        return None
    return [c.value for c in got]


def per_ray(trace, name: str):
    """The counter ``name`` over ``soft_rays`` of the same unit."""
    got = counters(trace, name, "soft_rays")
    if got is None or got[1] <= 0:
        return None
    return got[0] / got[1]
