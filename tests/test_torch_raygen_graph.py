"""PyTorch port: generate_rays' CUDA graphs (ops/raygen.py RayGraphs).

On the CPU: a CPU camera never reaches the graphs, the key separates every
ray grid, the cache keeps its bound under threads, and the counters count
each call. On the card (``cuda``): the graph's rays equal the eager ops'
bit for bit, a later replay leaves an earlier call's rays alone, a soft
three-view step is the eager path's bit for bit, a camera being fitted
gets its gradient, a replay never waits for the host, and a traced frame,
hard step and soft step replay every call. Imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_raygen_graph.py -q
"""

import math
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openglraytracer_tpu_torch.models.builders import sphere_grid_scene
from openglraytracer_tpu_torch.ops import raygen
from openglraytracer_tpu_torch.utils import profiling


def _cpu_camera(side=8):
    return sphere_grid_scene(side, device="cpu")[1]


class _NoGraphs:
    def dirs(self, *args, **kwargs):
        raise AssertionError("a CPU camera reached the graphs")


@pytest.mark.parametrize("grid", [(16, 16, None, None),
                                  (16, 24, slice(0, 8), slice(8, 16))])
def test_a_cpu_camera_never_reaches_the_graphs(monkeypatch, grid):
    monkeypatch.setattr(raygen, "GRAPHS", _NoGraphs())
    cam = _cpu_camera()
    o, d = raygen.generate_rays(cam, *grid)
    o_e, d_e = raygen._rays_eager(cam, *grid)
    assert torch.equal(d, d_e) and torch.equal(o, o_e)


def _key(cam, height=32, width=32, rows=None, cols=None):
    return raygen.graph_key(cam, height, width, rows, cols)


@pytest.mark.parametrize("change", ["height", "width", "dtype", "rows",
                                    "cols", "device"])
def test_the_key_separates_each_grid(change):
    cam = _cpu_camera()
    base = _key(cam, rows=slice(0, 16), cols=slice(0, 16))
    other = {
        "height": lambda: _key(cam, 48, rows=slice(0, 16), cols=slice(0, 16)),
        "width": lambda: _key(cam, 32, 48, slice(0, 16), slice(0, 16)),
        "dtype": lambda: _key(cam._replace(**{k: v.double() for k, v in
                                              cam._asdict().items()}),
                              rows=slice(0, 16), cols=slice(0, 16)),
        "rows": lambda: _key(cam, rows=slice(16, 32), cols=slice(0, 16)),
        "cols": lambda: _key(cam, rows=slice(0, 16), cols=slice(0, 32, 2)),
        "device": lambda: _key(cam._replace(**{k: v.to("meta") for k, v in
                                               cam._asdict().items()}),
                               rows=slice(0, 16), cols=slice(0, 16)),
    }[change]()
    assert other != base


def test_one_grid_one_key():
    """Another camera on the same grid shares its key, and a slice names
    its pixels, not its spelling."""
    cam = _cpu_camera()
    moved = cam._replace(position=cam.position + 1.0,
                         angles=cam.angles + 5.0)
    assert _key(cam) == _key(moved)
    assert _key(cam) == _key(cam, rows=slice(None), cols=slice(0, 32))
    assert _key(cam, rows=slice(8, None)) == _key(cam, rows=slice(8, 32, 1))


class _FakeGraph:
    """Stands in for _RayGraph on the CPU: replays the eager ops."""
    captured = []

    def __init__(self, cam, height, width, rows, cols):
        self.grid = (height, width, rows, cols)
        _FakeGraph.captured.append(raygen.graph_key(cam, *self.grid))

    def replay(self, cam):
        return raygen._rays_eager(cam, *self.grid)[1]


@pytest.fixture
def fake_graphs(monkeypatch):
    monkeypatch.setattr(raygen, "_RayGraph", _FakeGraph)
    _FakeGraph.captured = []
    return _FakeGraph


def test_eviction_keeps_the_bound(fake_graphs):
    cam = _cpu_camera()
    graphs = raygen.RayGraphs(capacity=3)
    sizes = [8, 16, 24, 32]
    for s in sizes[:3]:
        graphs.dirs(cam, s, s)
    graphs.dirs(cam, 8, 8)                  # 8 is now the newest
    graphs.dirs(cam, 32, 32)                # evicts 16, the oldest
    assert [k[1] for k in graphs.keys()] == [24, 8, 32]
    assert len(fake_graphs.captured) == 4
    graphs.dirs(cam, 16, 16)                # captured anew
    assert len(graphs.keys()) == 3 and len(fake_graphs.captured) == 5


def test_threads_share_the_graphs(fake_graphs):
    """More threads than cores on a few grids, with a short switch
    interval: each call gets its own grid's rays, and the bound holds."""
    cam = _cpu_camera()
    graphs = raygen.RayGraphs(capacity=2)
    grids = [(8, 8), (8, 16), (16, 8)]
    want = {g: raygen._rays_eager(cam, *g)[1] for g in grids}
    bad, n_threads = [], 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(i):
        for j in range(12):
            g = grids[(i + j) % len(grids)]
            if not torch.equal(graphs.dirs(cam, *g), want[g]):
                bad.append(g)

    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == [] and len(graphs.keys()) <= 2


def _traced_counters(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("entry", "render"):
            fn()
    rec = profiling.record()
    return (rec.counters["raygen_calls"].value,
            rec.counters["raygen_graph_replays"].value)


def test_the_counters_count_each_call(monkeypatch, fake_graphs):
    cam = _cpu_camera()
    assert _traced_counters(lambda: raygen.generate_rays(cam, 8, 8)) == \
        (1, 0)
    # where the graph is taken (here a stand-in), every call replays
    monkeypatch.setattr(raygen, "_graphable", lambda c: True)
    monkeypatch.setattr(raygen, "GRAPHS", raygen.RayGraphs())

    def three():
        for _ in range(3):
            raygen.generate_rays(cam, 8, 8)
    assert _traced_counters(three) == (3, 3)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


def _orbit(cam, phi_deg):
    phi = math.radians(phi_deg)
    x, y, z = (float(v) for v in cam.position)
    a = [float(v) for v in cam.angles]
    dev = cam.position.device
    return cam._replace(
        position=torch.tensor((x * math.cos(phi) - y * math.sin(phi),
                               x * math.sin(phi) + y * math.cos(phi), z),
                              device=dev),
        angles=torch.tensor([a[0], a[1] + phi_deg, a[2]], device=dev))


GRIDS = {
    "c3": (8, 1024, 1024, None, None),
    "c5": (64, 2048, 2048, None, None),
    "soft_0": (64, 512, 512, None, None, 0.0),
    "soft_+45": (64, 512, 512, None, None, 45.0),
    "soft_-45": (64, 512, 512, None, None, -45.0),
    "tile_1_0": (64, 2048, 2048, slice(1024, 2048), slice(0, 1024)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRIDS))
def test_graph_rays_equal_the_eager_ones(dev, name):
    side, h, w, rows, cols, *phi = GRIDS[name]
    cam = sphere_grid_scene(side, device=dev)[1]
    if phi:
        cam = _orbit(cam, phi[0])
    with torch.no_grad():
        o_e, d_e = raygen._rays_eager(cam, h, w, rows, cols)
        for _ in range(2):          # the capture's call, then a replay
            o, d = raygen.generate_rays(cam, h, w, rows, cols)
            assert torch.equal(d, d_e) and torch.equal(o, o_e)
    assert raygen.graph_key(cam, h, w, rows, cols) in raygen.GRAPHS.keys()


@pytest.mark.cuda
def test_a_later_call_leaves_the_earlier_rays(dev):
    cam = sphere_grid_scene(64, device=dev)[1]
    cams = [_orbit(cam, phi) for phi in (0.0, 45.0, -45.0)]
    with torch.no_grad():
        got = [raygen.generate_rays(c, 512, 512)[1] for c in cams]
        want = [raygen._rays_eager(c, 512, 512)[1] for c in cams]
    for g, e in zip(got, want):
        assert torch.equal(g, e)
    assert not torch.equal(got[0], got[1])


@pytest.mark.cuda
def test_a_soft_step_equals_the_eager_path(dev, monkeypatch):
    """A three-view soft fit step at the soft cell's shapes: its loss and
    gradients with the graph equal those with the eager ops bit for bit
    (under deterministic algorithms, as the step's index_add_ folds ask)."""
    from openglraytracer_tpu_torch.ops import soft as ts
    from openglraytracer_tpu_torch.train import inverse
    true, cam = sphere_grid_scene(64, seed=1, device=dev)
    cams = tuple(_orbit(cam, v) for v in (0.0, 45.0, -45.0))
    specs = tuple(ts.suggest_soft_cull(true, c, 512, 512, (16, 16), 0.5,
                                       headroom=2.0) for c in cams)
    with torch.no_grad():
        target = torch.stack([ts.soft_render(true, c, 512, 512, bw=0.5,
                                             gamma=0.6, cull=s)
                              for c, s in zip(cams, specs)])
    start = true._replace(spheres=true.spheres._replace(
        center=true.spheres.center + 0.05))
    cfg = inverse.FitConfig(height=512, width=512, soft=(0.5, 0.6),
                            cull=specs)
    init_fn, step_fn = inverse.make_train_step(
        cams, cfg, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.0))

    def step():
        params, opt = init_fn(start)
        loss = step_fn(params, opt, start, target)[2]
        return loss.clone(), {k: v.grad.clone() for k, v in params.items()}

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        step()                                  # captures the 512² grid
        loss_g, grads_g = step()
        monkeypatch.setattr(raygen, "generate_rays", raygen._rays_eager)
        loss_e, grads_e = step()
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(loss_g, loss_e)
    for k in grads_e:
        assert torch.equal(grads_g[k], grads_e[k]), k


@pytest.mark.cuda
def test_a_fitted_camera_takes_the_eager_path(dev):
    cam = sphere_grid_scene(8, device=dev)[1]
    cam = cam._replace(position=cam.position.clone().requires_grad_(True),
                       angles=cam.angles.clone().requires_grad_(True))
    before = raygen.GRAPHS.keys()
    o, d = raygen.generate_rays(cam, 64, 64)
    assert d.requires_grad and raygen.GRAPHS.keys() == before
    (o.sum() + d.sum()).backward()
    for t in (cam.position, cam.angles):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
    assert bool(cam.angles.grad.any())
    with torch.no_grad():
        d_e = raygen._rays_eager(cam, 64, 64)[1]
    assert torch.equal(d.detach(), d_e)


@pytest.mark.cuda
def test_a_replay_is_sync_free(dev):
    cam = sphere_grid_scene(64, device=dev)[1]
    with torch.no_grad():
        raygen.generate_rays(cam, 512, 512)
        moved = _orbit(cam, 30.0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            d = raygen.generate_rays(moved, 512, 512)[1]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(d, raygen._rays_eager(moved, 512, 512)[1])


@pytest.mark.cuda
def test_traced_units_replay_every_call(dev):
    """Under tracing, raygen_graph_replays equals raygen_calls in a frame,
    a hard step and a soft step (three views)."""
    from openglraytracer_tpu_torch.ops import soft as ts
    from openglraytracer_tpu_torch.ops.accel import suggest_cull_config
    from openglraytracer_tpu_torch.ops.render import render
    from openglraytracer_tpu_torch.train import inverse
    scene, cam = sphere_grid_scene(8, device=dev)
    spec = suggest_cull_config(scene, cam, 128, 128, (32, 32))
    cfg = inverse.FitConfig(height=128, width=128, engine="culled_pallas",
                            cull=spec, trainable=inverse.DEFAULT_TRAINABLE)
    init_fn, step_fn = inverse.make_train_step(
        cam, cfg, optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-7))
    params, opt = init_fn(scene)
    target = torch.zeros((128, 128, 3), device=dev)

    def frame():
        with torch.no_grad():
            render(scene, cam, 128, 128, engine="culled_pallas", cull=spec)

    true, c5 = sphere_grid_scene(64, seed=1, device=dev)
    cams = tuple(_orbit(c5, v) for v in (0.0, 45.0, -45.0))
    specs = tuple(ts.suggest_soft_cull(true, c, 128, 128, (16, 16), 0.5,
                                       headroom=2.0) for c in cams)
    with torch.no_grad():
        soft_target = torch.stack([ts.soft_render(true, c, 128, 128,
                                                  bw=0.5, gamma=0.6, cull=s)
                                   for c, s in zip(cams, specs)])
    soft_init, soft_step = inverse.make_train_step(
        cams, inverse.FitConfig(height=128, width=128, soft=(0.5, 0.6),
                                cull=specs),
        optimizer=lambda ps: torch.optim.SGD(ps, lr=0.0))
    soft_params, soft_opt = soft_init(true)
    units = {"frame": (frame, 1),
             "hard step": (lambda: step_fn(params, opt, scene, target), 1),
             "soft step": (lambda: soft_step(soft_params, soft_opt, true,
                                             soft_target), 3)}
    for name, (unit, calls) in units.items():
        unit()                                  # captures
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            unit()
        rec = profiling.record()
        got = (rec.counters["raygen_calls"].value,
               rec.counters["raygen_graph_replays"].value)
        assert got == (calls, calls), name
