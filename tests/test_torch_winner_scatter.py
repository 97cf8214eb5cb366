"""PyTorch port: the backward's winner scatter (ops/geometry.py
winner_scatter, csrc/winner_scatter.cu) and the material routing's
autograd op (ops/accel.py _MaterialRowsOp).

On the CPU the wrapper runs its plain version, which must equal the
index_add_ formulation the backward used before it exactly: each ray's row
added into its tile's survivor slot, the slots into the objects, the plane
rows into the planes (and through the planes' material ids into the
material table). The material routing's op must give the forward of the
gathers it replaces bit for bit and the gradient that autograd gives
through them. Cases: rays with no slot (-1), lost winners, a tile whose
rays all hit a plane, three planes, box rows (18 columns), material rows
(20), and planes alone, grouped by a fixed run of rays (the dense engines).

The tests marked ``cuda`` hold the kernel against the exact sums at the c3
and c5 tile shapes, and check that it gives the same bits on every run
under torch's deterministic algorithms, on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_winner_scatter.py -q

The kernel sums in float32 in its own order: a shuffle tree in a warp (5
additions deep), then the warps' sums in warp order into a block's row
(at most SCATTER_CHUNK / 32 additions, one a warp round), then index_add_
of the block rows into an output row (one addition a block row that
received a ray). A float32 sum through chains of at most d additions lies
within d * eps * sum|x| of the exact sum (first order, twice the unit
roundoff), so the card's cases hold each output row of the kernel to its
own d against the plain version summed in float64. The plain version in
float32 is index_add_ with one atomic a ray into a few rows: a plane's row
is one chain of up to millions of additions, which strays further. Imports
no jax.
"""

import pytest
import torch

from openglraytracer_tpu_torch.models import animated as t_animated
from openglraytracer_tpu_torch.models import builders as tb
from openglraytracer_tpu_torch.models.scene import Planes
from openglraytracer_tpu_torch.ops import culled, geometry
from openglraytracer_tpu_torch.ops.accel import (_gather_tile_rows,
                                                 _select_winner_rows,
                                                 culled_material_rows,
                                                 parse_cull_spec,
                                                 suggest_cull_config,
                                                 tile_image)
from openglraytracer_tpu_torch.ops.geometry import (PLANE_GROUP,
                                                    winner_scatter,
                                                    winner_scatter_plain)
from openglraytracer_tpu_torch.ops.raygen import generate_rays
from openglraytracer_tpu_torch.ops.shading import (material_table,
                                                   static_shadow_mask)

H = W = 32
TILE = (16, 16)
EPS32 = torch.finfo(torch.float32).eps


# ---------------------------------------------------------------------------
# The index_add_ formulation the backward used before the kernel
# ---------------------------------------------------------------------------

def _slots_then_objects(contrib, surv_idx, j_local, n_obj):
    """Rays into their tile's survivor slots (slot -1 adds its zero row into
    slot 0), then the T * K slots into the objects."""
    t_tiles, k = surv_idx.shape
    base = torch.arange(t_tiles)[:, None] * k
    slot = (base + j_local.clamp(min=0)).reshape(-1)
    g_rows = torch.zeros((t_tiles * k, contrib.shape[-1]),
                         dtype=contrib.dtype).index_add_(0, slot, contrib)
    return torch.zeros((n_obj, contrib.shape[-1]),
                       dtype=contrib.dtype).index_add_(
                           0, surv_idx.reshape(-1).long(), g_rows)


def _plane_sum(g_pln, pid, n_pln):
    return torch.zeros((n_pln, g_pln.shape[-1]),
                       dtype=g_pln.dtype).index_add_(0, pid.long(), g_pln)


def _old_material_rows(scene, hit, aux, tile_p):
    """culled_material_rows as it was: the gathers under autograd."""
    r_total = hit.t.shape[0]
    t_tiles = r_total // tile_p
    n_sph, n_box = scene.spheres.count, scene.boxes.count
    table = material_table(scene)
    rows = torch.zeros((t_tiles, tile_p, table.shape[-1]), dtype=table.dtype)
    if n_sph:
        mid = _gather_tile_rows(scene.spheres.material_id[:, None],
                                aux.p_idx)[..., 0]
        rows = _select_winner_rows(_gather_tile_rows(table, mid),
                                   aux.j_local, rows)
    if n_box:
        mid = _gather_tile_rows(scene.boxes.material_id[:, None],
                                aux.b_idx)[..., 0]
        rows = _select_winner_rows(_gather_tile_rows(table, mid),
                                   aux.jb_local, rows)
    rows = rows.reshape(r_total, -1)
    pln = scene.planes
    if pln.count:
        pln_rows = torch.index_select(table, 0, pln.material_id)
        is_pln = hit.hit & (hit.obj_id >= n_sph + n_box)
        pid = torch.clamp(hit.obj_id - n_sph - n_box, 0, pln.count - 1)
        rows = torch.where(is_pln[:, None],
                           torch.index_select(pln_rows, 0, pid), rows)
    return rows


# ---------------------------------------------------------------------------
# Synthetic rays: each ray's winner is a slot, a plane or nothing
# ---------------------------------------------------------------------------

def _rays(t_tiles, group, k, n_obj, n_pln, f, seed, plane_tile=None,
          lost=0.0):
    """(rows, slot, obj, plane_rows, plane_slot, kinds) for T tiles of G
    rays: each ray is a slot's (kind 0), a plane's (1) or nobody's (2);
    rows are zero where the ray is not its slot's and plane rows where it
    is not its plane's, as winner_backward hands them. lost: the share of
    slot rays that lose their slot (-1, row zero), as a hot tile's
    overflow does. plane_tile: a tile whose rays all hit a plane."""
    g = torch.Generator().manual_seed(seed)
    r = t_tiles * group
    kinds = torch.randint(0, 3, (r,), generator=g)
    if not n_pln:
        kinds = torch.where(kinds == 1, 2, kinds)
    if plane_tile is not None:
        kinds.view(t_tiles, group)[plane_tile] = 1
    slot = torch.randint(0, k, (r,), generator=g, dtype=torch.int32)
    lose = torch.rand(r, generator=g) < lost
    slot = torch.where((kinds == 0) & ~lose, slot, -1)
    obj = torch.randint(0, n_obj, (t_tiles, k), generator=g,
                        dtype=torch.int32)
    rows = torch.where((slot >= 0)[:, None],
                       torch.randn((r, f), generator=g), 0.0)
    plane_slot = plane_rows = None
    if n_pln:
        plane_slot = torch.where(
            kinds == 1, torch.randint(0, n_pln, (r,), generator=g,
                                      dtype=torch.int32), -1)
        plane_rows = torch.where((plane_slot >= 0)[:, None],
                                 torch.randn((r, f), generator=g), 0.0)
    return (rows, slot.reshape(t_tiles, group), obj, plane_rows, plane_slot,
            kinds)


_CASES = {
    # name: (T, G, K, objects, planes, F, extra)
    "spheres_and_a_plane": (6, 32, 5, 9, 1, 4, {}),
    "three_planes": (4, 64, 3, 7, 3, 4, {}),
    "lost_winners": (5, 48, 4, 6, 1, 4, {"lost": 0.3}),
    "an_all_plane_tile": (4, 32, 4, 8, 2, 4, {"plane_tile": 2}),
    "boxes": (3, 40, 6, 5, 0, 18, {}),
    "materials": (6, 32, 5, 11, 2, 20, {}),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_plain_path_equals_the_index_add_formula(case):
    t_tiles, group, k, n_obj, n_pln, f, extra = _CASES[case]
    rows, slot, obj, prow, pslot, _ = _rays(t_tiles, group, k, n_obj, n_pln,
                                            f, seed=len(case), **extra)
    want = _slots_then_objects(rows, obj, slot, n_obj)
    out = torch.zeros((n_obj, f))
    if not n_pln:
        got, _ = winner_scatter(rows, slot, obj, out)
        assert torch.equal(got, want)
        return
    pid = pslot.clamp(min=0)
    if case == "materials":
        # the material table: slots and planes into one table, the planes
        # through their material ids
        pobj = torch.randint(0, n_obj, (n_pln,), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(3))
        want = want.index_add_(0, pobj.long(), _plane_sum(prow, pid, n_pln))
        got, got_p = winner_scatter(rows, slot, obj, out, prow, pslot, pobj,
                                    out)
        assert got_p is got and torch.equal(got, want)
        return
    g_pln = torch.zeros((n_pln, f))
    got, got_p = winner_scatter(rows, slot, obj, out, prow, pslot, None,
                                g_pln)
    assert torch.equal(got, want)
    assert torch.equal(got_p, _plane_sum(prow, pid, n_pln))


@pytest.mark.parametrize("n_rays", [PLANE_GROUP - 7, 2 * PLANE_GROUP + 5])
def test_planes_alone_equal_their_index_add(n_rays):
    """The dense engines' plane sum: no survivor list, three planes."""
    g = torch.Generator().manual_seed(n_rays)
    pslot = torch.randint(-1, 3, (n_rays,), generator=g, dtype=torch.int32)
    prow = torch.where((pslot >= 0)[:, None],
                       torch.randn((n_rays, 4), generator=g), 0.0)
    g_pln = torch.zeros((3, 4))
    _, got = winner_scatter(None, None, None, None, prow, pslot, None, g_pln)
    assert torch.equal(got, _plane_sum(prow, pslot.clamp(min=0), 3))


def test_the_plane_takes_precedence_over_the_slot():
    """A ray with a plane and a slot adds its plane row only (the routing
    patches plane winners over the survivor rows)."""
    rows = torch.ones((4, 4))
    slot = torch.tensor([[0, 0, 1, -1]], dtype=torch.int32)
    obj = torch.tensor([[2, 0]], dtype=torch.int32)
    pslot = torch.tensor([0, -1, 0, 0], dtype=torch.int32)
    prow = torch.full((4, 4), 10.0)
    out, g_pln = torch.zeros((3, 4)), torch.zeros((1, 4))
    winner_scatter(rows, slot, obj, out, prow, pslot, None, g_pln)
    assert out[:, 0].tolist() == [0.0, 0.0, 1.0]
    assert g_pln[0, 0].item() == 30.0


# ---------------------------------------------------------------------------
# The material routing's op on culled frames
# ---------------------------------------------------------------------------

def _three_planes(scene):
    """The grid with two walls beside its ground, each of its own
    material."""
    pl = scene.planes
    k = scene.materials.diffuse.shape[0]
    return scene._replace(planes=Planes(
        normal=torch.cat([pl.normal, torch.tensor([[1.0, 0.0, 0.0],
                                                   [0.0, -1.0, 0.0]])]),
        offset=torch.cat([pl.offset, torch.tensor([-4.0, -4.0])]),
        material_id=torch.cat([pl.material_id,
                               torch.tensor([k - 2, k - 3],
                                            dtype=torch.int32)])))


def _world(name):
    if name == "obb":
        scene, cam = t_animated.reference_frame(1.2, device="cpu")
    else:
        scene, cam = tb.sphere_grid_scene(3, seed=5, device="cpu")
        if name == "grid_three_planes":
            scene = _three_planes(scene)
    spec = suggest_cull_config(scene, cam, H, W, TILE, headroom=2.0)
    (th, tw), kp, ks, hot_m, kb, ksb = parse_cull_spec(spec)
    origins, dirs = generate_rays(cam, H, W)
    o = tile_image(origins, th, tw).reshape(-1, 3)
    d = tile_image(dirs, th, tw).reshape(-1, 3)
    hit, _, aux = culled.culled_geometry(scene, o, d, th * tw, kp, ks,
                                         static_shadow_mask(scene), hot_m,
                                         kb, ksb)
    if name == "grid_lost":
        # a hot tile's overflow: sphere winners that lost their slot
        lost = torch.zeros_like(aux.j_local, dtype=torch.bool)
        lost.view(-1)[::7] = True
        aux = aux._replace(j_local=torch.where(lost, -1, aux.j_local))
    return scene, hit, aux, th * tw


_LEAVES = ("ambient", "diffuse", "specular", "shininess", "emissive")


@pytest.mark.parametrize("name", ["grid", "grid_three_planes", "grid_lost",
                                  "obb"])
def test_material_rows_op_forward_and_gradients(name):
    scene, hit, aux, tile_p = _world(name)
    n_sph, n_box = scene.spheres.count, scene.boxes.count
    is_pln = hit.hit & (hit.obj_id >= n_sph + n_box)
    if name == "obb":
        assert int((aux.jb_local >= 0).sum()) > 0
    else:
        assert bool(is_pln.any())
    if name == "grid_three_planes":
        assert torch.unique(hit.obj_id[is_pln]).numel() == 3
    mats = scene.materials._replace(**{
        k: getattr(scene.materials, k).clone().requires_grad_()
        for k in _LEAVES})
    s = scene._replace(materials=mats)
    leaves = [getattr(mats, k) for k in _LEAVES]
    new = culled_material_rows(s, hit, aux, tile_p)
    old = _old_material_rows(s, hit, aux, tile_p)
    assert new.grad_fn is not None and "MaterialRows" in type(
        new.grad_fn).__name__
    assert torch.equal(new, old)
    with torch.no_grad():
        assert torch.equal(culled_material_rows(s, hit, aux, tile_p), old)
    cot = torch.randn(new.shape, generator=torch.Generator().manual_seed(1))
    g_new = torch.autograd.grad(new, leaves, cot)
    g_old = torch.autograd.grad(old, leaves, cot)
    for k, a, b in zip(_LEAVES, g_new, g_old):
        assert float(b.abs().max()) > 0.0, k
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


# ---------------------------------------------------------------------------
# The kernel on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


# (T, G, K, objects, planes, F): c3 (64x64 tiles, 1024x1024) and c5 (32x32
# tiles, 2048x2048) at their survivor widths, spheres with the ground plane
# and the material table; boxes; a list too wide for shared memory (a
# block sums its slot rows in its rows of the output buffer)
_CARD_CASES = {
    "c3_spheres": (256, 4096, 12, 64, 1, 4),
    "c3_materials": (256, 4096, 12, 65, 1, 20),
    "c5_spheres": (4096, 1024, 32, 4096, 1, 4),
    "c5_materials": (4096, 1024, 32, 4097, 1, 20),
    "boxes": (64, 1024, 24, 300, 0, 18),
    "wide_list": (16, 1024, 4096, 4096, 3, 20),
}


def _exact(fn_args, *outs):
    """winner_scatter_plain in float64 on (rows, slot, obj, prow, pslot,
    pobj), into float64 copies of outs (out, plane_out; one table where
    they are the same tensor)."""
    rows, slot, obj, prow, pslot, pobj = fn_args
    out, pout = (None if x is None else x.double() for x in outs)
    if outs[1] is not None and outs[1] is outs[0]:
        pout = out
    return winner_scatter_plain(
        None if rows is None else rows.double(), slot, obj, out,
        None if prow is None else prow.double(), pslot, pobj, pout)


def _depths(slot, obj, pslot, pobj, n_out, n_pout, same):
    """(out, plane_out) rows' longest chains of float32 additions in the
    kernel's sums, as (N, 1) columns: 5 in a warp's tree, SCATTER_CHUNK /
    32 into its block's row, and one for each block row with a ray that
    index_add_ adds into the output row (same: plane_out is out)."""
    ref = slot if slot is not None else pslot
    dev = ref.device
    n_rays = ref.numel()
    group = slot.shape[1] if slot is not None else PLANE_GROUP
    k = obj.shape[1] if obj is not None else 0
    chunks = -(-group // geometry.SCATTER_CHUNK)
    r = torch.arange(n_rays, device=dev)
    block = (r // group) * chunks + (r % group) // geometry.SCATTER_CHUNK
    none = torch.full((n_rays,), -1, dtype=torch.long, device=dev)
    key, dest, to_pln = none, none, torch.zeros_like(none, dtype=torch.bool)
    if slot is not None:
        s = slot.reshape(-1).long()
        ok = (s >= 0) & (s < k)
        key = torch.where(ok, s, key)
        dest = torch.where(ok, obj.long()[r // group, s.clamp(0, k - 1)],
                           dest)
    if pslot is not None:
        p = pslot.long()
        to_pln = p >= 0
        key = torch.where(to_pln, k + p, key)
        row = pobj.long()[p.clamp(min=0)] if pobj is not None else p
        dest = torch.where(to_pln, row, dest)
    live = key >= 0
    pairs, inv = torch.unique(block[live] * (int(key.max()) + 1) + key[live],
                              return_inverse=True)
    pair_dest = torch.zeros_like(pairs).scatter_(0, inv, dest[live])
    pair_pln = torch.zeros_like(pairs, dtype=torch.bool).scatter_(
        0, inv, to_pln[live])
    base = 5 + geometry.SCATTER_CHUNK // 32
    if same:
        pair_pln = torch.zeros_like(pair_pln)
    d_out = d_pout = None
    if n_out:
        d_out = base + torch.bincount(pair_dest[~pair_pln],
                                      minlength=n_out)[:, None]
    if n_pout:
        d_pout = base + torch.bincount(pair_dest[pair_pln],
                                       minlength=n_pout)[:, None]
    return d_out, d_out if same else d_pout


def _within_sum_order(got, exact, abs_sum, depth):
    tol = depth * EPS32 * abs_sum + 1e-30
    err = (got.double() - exact).abs()
    bad = err > tol
    assert not bool(bad.any()), (
        f"{int(bad.sum())} elements off; worst "
        f"{float((err / tol).max()):.3g} of the tolerance")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_CARD_CASES))
def test_kernel_equals_the_exact_sums_on_the_card(case):
    dev = _card()
    t_tiles, group, k, n_obj, n_pln, f = _CARD_CASES[case]
    rows, slot, obj, prow, pslot, _ = (
        None if x is None else x.to(dev) for x in _rays(
            t_tiles, group, k, n_obj, n_pln, f, seed=7, lost=0.1))
    pobj = (torch.arange(n_pln, dtype=torch.int32, device=dev) + n_obj - n_pln
            if f == 20 and n_pln else None)

    def run(fn, r, p):
        out = torch.zeros((n_obj, f), device=dev)
        po = None
        if n_pln:
            po = out if pobj is not None else torch.zeros((n_pln, f),
                                                          device=dev)
        return fn(r, slot, obj, out, p, pslot, pobj, po)

    from openglraytracer_tpu_torch import kernels
    before = kernels.LAUNCHES["winner_scatter"]
    got = run(winner_scatter, rows, prow)
    assert kernels.LAUNCHES["winner_scatter"] == before + 1
    exact = _exact((rows, slot, obj, prow, pslot, pobj), *run(
        lambda *a: (a[3], a[7]), rows, prow))
    scale = _exact((rows.abs(), slot, obj,
                    None if prow is None else prow.abs(), pslot, pobj),
                   *run(lambda *a: (a[3], a[7]), rows, prow))
    depths = _depths(slot, obj, pslot, pobj, n_obj,
                     n_pln if pobj is None else 0, pobj is not None)
    for g_, e_, s_, d_ in zip(got, exact, scale, depths):
        if g_ is not None:
            _within_sum_order(g_, e_, s_, d_)


@pytest.mark.cuda
def test_kernel_planes_alone_on_the_card():
    dev = _card()
    n_rays = 2048 * 2048 + 77
    g = torch.Generator().manual_seed(2)
    pslot = torch.randint(-1, 3, (n_rays,), generator=g,
                          dtype=torch.int32).to(dev)
    prow = torch.where((pslot >= 0)[:, None],
                       torch.randn((n_rays, 4), generator=g).to(dev), 0.0)

    def exact(p):
        return _exact((None, None, None, p, pslot, None), None,
                      torch.zeros((3, 4), device=dev))[1]

    got = winner_scatter(None, None, None, None, prow, pslot, None,
                         torch.zeros((3, 4), device=dev))[1]
    _within_sum_order(got, exact(prow), exact(prow.abs()),
                      _depths(None, None, pslot, None, 0, 3, False)[1])


@pytest.mark.cuda
def test_kernel_gives_the_same_bits_under_deterministic_algorithms():
    """Under torch.use_deterministic_algorithms the wrapper still launches
    the kernel (its sums have one order, fixed by the rays) and index_add_
    adds the block rows in a fixed order: two calls agree bit for bit, on
    a c5 tile shape whose ground plane gathers every block's row."""
    dev = _card()
    rows, slot, obj, prow, pslot, _ = (
        x.to(dev) for x in _rays(4096, 1024, 32, 4097, 1, 20, seed=3))
    pobj = torch.tensor([4096], dtype=torch.int32, device=dev)

    def run():
        out = torch.zeros((4097, 20), device=dev)
        return winner_scatter(rows, slot, obj, out, prow, pslot, pobj, out)[0]

    from openglraytracer_tpu_torch import kernels
    before = kernels.LAUNCHES["winner_scatter"]
    torch.use_deterministic_algorithms(True)
    try:
        a, b = run(), run()
    finally:
        torch.use_deterministic_algorithms(False)
    assert kernels.LAUNCHES["winner_scatter"] == before + 2
    assert torch.equal(a, b)
