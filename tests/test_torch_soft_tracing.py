"""PyTorch port: the soft fit step's own spans and counters
(utils/profiling.py, ops/soft.py, train/inverse.py soft_loss).

Under a torch.profiler session on the CPU, a multi-view soft step on the
culled soft pass records the soft broad phase's spans, each view's span,
each block's forward and its recompute in the backward; its counters
``soft_rays``, ``soft_kept_pairs`` and ``soft_live_pairs`` equal a hand
count from the same survivor lists and coverages. With no session, the
step opens no range and launches the operations of a traced step less the
counters' own. Imports no jax."""

import math

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from openglraytracer_tpu_torch.models import builders as tb
from openglraytracer_tpu_torch.ops import soft as ts
from openglraytracer_tpu_torch.ops.accel import (_gather_tile_rows,
                                                 _sphere_table, compact_mask,
                                                 sphere_vs_cone, tile_cones,
                                                 tile_image)
from openglraytracer_tpu_torch.ops.intersect import _safe_sqrt
from openglraytracer_tpu_torch.ops.raygen import generate_rays
from openglraytracer_tpu_torch.train import inverse
from openglraytracer_tpu_torch.utils import profiling

H = W = 64
TILE = (16, 16)
BW, GAMMA = 0.5, 0.6
VIEWS = (0.0, 45.0, -45.0)

STEP = {("entry", "step"), ("optimizer", "zero_grad"),
        ("optimizer", "step"), ("backward", "autograd"),
        ("soft_composite", "view"), ("broad_phase", "soft_tile_cones"),
        ("broad_phase", "soft_compact"), ("soft_composite", "block"),
        ("soft_composite", "recompute")}


def _orbit(cam, phi_deg):
    phi = math.radians(phi_deg)
    x, y, z = (float(v) for v in cam.position)
    a = [float(v) for v in cam.angles]
    return cam._replace(
        position=torch.tensor((x * math.cos(phi) - y * math.sin(phi),
                               x * math.sin(phi) + y * math.cos(phi), z)),
        angles=torch.tensor([a[0], a[1] + phi_deg, a[2]]))


def _soft_step():
    """(step_fn, params, opt, scene, target, cameras, specs) of the
    three-view soft fit on a 4x4 grid, from centers moved off the truth."""
    true, cam = tb.sphere_grid_scene(4, seed=5, device="cpu")
    cams = tuple(_orbit(cam, v) for v in VIEWS)
    specs = tuple(ts.suggest_soft_cull(true, c, H, W, TILE, BW,
                                       headroom=2.0) for c in cams)
    with torch.no_grad():
        target = torch.stack([ts.soft_render(true, c, H, W, bw=BW,
                                             gamma=GAMMA, cull=s)
                              for c, s in zip(cams, specs)])
    g = torch.Generator().manual_seed(2)
    start = true._replace(spheres=true.spheres._replace(
        center=true.spheres.center + 0.1 * torch.randn(
            true.spheres.center.shape, generator=g)))
    cfg = inverse.FitConfig(height=H, width=W, soft=(BW, GAMMA), cull=specs)
    init_fn, step_fn = inverse.make_train_step(
        cams, cfg, optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-3))
    params, opt = init_fn(start)
    return step_fn, params, opt, start, target, cams, specs


def _hand_count(scene, cams, specs):
    """(rays, kept pairs, live pairs) of one step's forward, from the
    survivor lists and coverages recomputed as the soft pass makes them."""
    rays = kept = live = 0
    table = _sphere_table(scene)
    for cam, ((th, tw), k) in zip(cams, specs):
        origins, dirs = generate_rays(cam, H, W)
        o = tile_image(origins, th, tw).reshape(-1, th * tw, 3)
        d = tile_image(dirs, th, tw).reshape(-1, th * tw, 3)
        axis, cos_half = tile_cones(d)
        mask = sphere_vs_cone(o[0, 0], axis, cos_half, scene.spheres.center,
                              scene.spheres.radius * ts.expand_factor(BW))
        idx, valid, _ = compact_mask(mask, k)
        rows = _gather_tile_rows(table, idx)               # (T, K, 6)
        rays += o.shape[0] * o.shape[1]
        kept += int(valid.sum()) * th * tw
        oc = o[:, :, None, :] - rows[:, None, :, :3]       # (T, P, K, 3)
        b = (oc * d[:, :, None, :]).sum(-1)
        r2 = torch.clamp(rows[..., 3] ** 2, min=1e-12)[:, None, :]
        disc = r2 - ((oc * oc).sum(-1) - b * b)
        alpha = torch.sigmoid(disc / (BW * r2))
        t_hit = -b - _safe_sqrt(disc)
        on = (alpha > 1e-3) & (t_hit > 1e-3) & valid[:, None, :]
        live += int(on.sum())
    return rays, kept, live


def test_a_soft_step_records_its_spans_and_counters():
    step_fn, params, opt, start, target, cams, specs = _soft_step()
    scene = inverse.apply_params(start, {k: v.detach()
                                         for k, v in params.items()})
    want = _hand_count(scene, cams, specs)
    with profile(activities=[ProfilerActivity.CPU]):
        step_fn(params, opt, start, target)
    rec = profiling.record()
    assert {(s.layer, s.name) for s in rec.spans} == STEP
    names = [(s.layer, s.name) for s in rec.spans]
    assert names.count(("soft_composite", "view")) == len(VIEWS)
    blocks = names.count(("soft_composite", "block"))
    assert blocks >= len(VIEWS) and \
        names.count(("soft_composite", "recompute")) == blocks
    for i, s in enumerate(rec.spans):
        if s.name == "recompute":
            # on the CPU autograd runs the backward on the caller's thread
            assert rec.spans[s.parent].layer == "backward"
        if s.name in ("soft_tile_cones", "soft_compact", "block"):
            assert rec.spans[s.parent].name == "view"
    got = tuple(rec.counters[n].value for n in
                ("soft_rays", "soft_kept_pairs", "soft_live_pairs"))
    assert got == want
    assert want[0] == len(VIEWS) * H * W and 0 < want[2] < want[1]


def test_the_dense_soft_pass_counts_every_pair():
    scene, cam = tb.sphere_grid_scene(3, seed=5, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("entry", "step"):
            with torch.no_grad():
                ts.soft_render(scene, cam, 32, 32, bw=BW, gamma=GAMMA)
    rec = profiling.record()
    assert {(s.layer, s.name) for s in rec.spans} == {
        ("entry", "step"), ("soft_composite", "block")}
    assert rec.counters["soft_rays"].value == 32 * 32
    assert rec.counters["soft_kept_pairs"].value == 32 * 32 * 9
    assert 0 < rec.counters["soft_live_pairs"].value < 32 * 32 * 9


class _Ops(TorchDispatchMode):
    """The aten operations a call runs, in order (the profiler's own
    record_function ops left out)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace != "profiler":
            self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_untraced_step_opens_no_range_and_adds_no_operation(monkeypatch):
    step_fn, params, opt, start, target, _, _ = _soft_step()
    step_fn(params, opt, start, target)
    traced = _Ops()
    with profile(activities=[ProfilerActivity.CPU]):
        with traced:
            step_fn(params, opt, start, target)

    def no_range(*args, **kwargs):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert not profiling.tracing()
    untraced = _Ops()
    with untraced:
        step_fn(params, opt, start, target)
    counted = traced.ops.count("count_nonzero")
    assert counted == sum(1 for s in profiling.record().spans
                          if s.name == "block")
    assert untraced.ops == [op for op in traced.ops if op != "count_nonzero"]


def test_tracing_changes_no_number_of_the_step():
    runs = []
    for traced in (False, True):
        step_fn, params, opt, start, target, _, _ = _soft_step()
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                _, _, loss, ovf = step_fn(params, opt, start, target)
        else:
            _, _, loss, ovf = step_fn(params, opt, start, target)
        runs.append((float(loss), int(ovf),
                     {k: v.detach().clone() for k, v in params.items()}))
    assert runs[0][:2] == runs[1][:2]
    for k in runs[0][2]:
        assert torch.equal(runs[0][2][k], runs[1][2][k]), k
