"""Hand-built kernel inputs on which the lanes of a warp take different
branches: rays that graze spheres (the discriminant at 0 and an ulp either
side, spheres behind the origin, invalid rows) for kernel 2's hot launch
and kernel 7, warps that only some lanes' shadow segments are blocked in,
for kernel 7, shadow segments that graze spheres on hot and cold (tile,
light) pairs for kernel 3, and ragged masks for kernel 6.
``chip_smoke.py``, the GPU tests (``tests/test_torch_cuda.py``) and
``scripts/ablate_torch_kernels.py`` hold the kernels to their plain
versions on them."""

from __future__ import annotations

import torch


def graze_target(dev, n_sph: int, n_rays: int):
    """The sphere each graze ray is tangent to, and whether it lies ahead
    of the ray (one ray in eight starts on the far side, so its tangent
    sphere is behind its origin and must not be hit)."""
    i = torch.arange(n_rays, device=dev)
    return (i * 7919) % n_sph, i % 8 != 7


def _graze_rays(dev, n_sph: int, n_rays: int):
    """(origins, dirs) of the graze rays (graze_hot_inputs)."""
    target, ahead = graze_target(dev, n_sph, n_rays)
    one = torch.ones(target.shape, dtype=torch.float32, device=dev)
    origins = torch.stack([one, 4.0 * target.to(torch.float32),
                           torch.where(ahead, -one, one)], -1)
    dirs = torch.stack([0.0 * one, 0.0 * one, one], -1)
    return origins, dirs


def graze_hot_inputs(dev, n_sph: int, n_tiles: int,
                     tile_p: int = 1024):
    """Arguments of kernel 2's hot launch (culled.primary_hit_ray with
    tile_ids) whose rays graze spheres, so that neighbouring lanes of a warp
    take different branches. Sphere j sits at (0, 4 j, 0); ray i starts at
    c_j + (1, 0, -1) of sphere j = 7919 i mod n_sph and runs along +z, so
    its qd = 4 - 4 (2 - r^2) is exactly 0 at r^2 = 1 and at r^2 = 1 - 2^-24
    (qc rounds to 1), and one ulp of 4 below or above 0 at r^2 = 1 - 2^-23
    or 1 + 2^-23 (by j mod 4); every other sphere is passed by far. One ray
    in eight starts at c_j + (1, 0, 1) instead, the sphere behind it
    (graze_target). One sphere in seven is marked invalid, so its rays must
    miss it. A plane at
    z = 50 takes the rays that miss. The last block row is slack (counts
    0). n_sph above one staging chunk of csrc/primary_hit.cu's hot launch
    (kHotRows, 1024 rows) runs several."""
    f32 = torch.float32
    j = torch.arange(n_sph, device=dev)
    r2 = torch.tensor([1.0 - 2.0 ** -23, 1.0 - 2.0 ** -24, 1.0,
                       1.0 + 2.0 ** -23], dtype=f32, device=dev)[j % 4]
    zero = torch.zeros(n_sph, dtype=f32, device=dev)
    sph = torch.stack([zero, 4.0 * j.to(f32), zero, r2, (j % 64).to(f32),
                       j.to(f32), (j % 7 != 6).to(f32), zero], -1)
    origins, dirs = _graze_rays(dev, n_sph, n_tiles * tile_p)
    pln = torch.zeros((1, 16), dtype=f32, device=dev)
    pln[0, :10] = torch.tensor([0.0, 0.0, 1.0, 50.0, 0.0, 0.0, 1.0, 50.0,
                                64.0, float(n_sph)])
    cnt = torch.tensor([[n_sph, 0]] * n_tiles + [[0, 0]], dtype=torch.int32,
                       device=dev)
    tile_ids = torch.tensor(list(range(n_tiles)) + [0], dtype=torch.int32,
                            device=dev)
    return ((dirs.contiguous(), origins.contiguous(), sph[None].contiguous(),
             torch.zeros((1, 0, 24), dtype=f32, device=dev), pln, cnt,
             tile_p), dict(tile_ids=tile_ids))


def graze_dense_inputs(dev, n_sph: int, n_rays: int):
    """Arguments of kernel 7 (dense.dense_hit) whose rays graze spheres, as
    graze_hot_inputs: sphere j at (0, 4 j, 0) with r = 1 - 2^-24, 1 or
    1 + 2^-23 (by j mod 3: r * r rounds to 1 - 2^-23, 1 and 1 + 2^-22, so
    disc = 4 - 4 (2 - r^2) is an ulp below 0, 0 and two ulps above), ray i
    from c_j + (1, 0, -1), j = 7919 i mod n_sph, along +z (one in eight
    from c_j + (1, 0, 1), the sphere behind it); a plane at
    z = 50 and two lights. n_sph above one staging chunk of
    csrc/dense_hit.cu (256 rows) runs its chunked path."""
    f32 = torch.float32
    j = torch.arange(n_sph, device=dev)
    r = torch.tensor([1.0 - 2.0 ** -24, 1.0, 1.0 + 2.0 ** -23], dtype=f32,
                     device=dev)[j % 3]
    zero = torch.zeros(n_sph, dtype=f32, device=dev)
    sph = torch.stack([zero, 4.0 * j.to(f32), zero, r], -1)
    origins, dirs = _graze_rays(dev, n_sph, n_rays)
    pln = torch.tensor([[0.0, 0.0, 1.0, 50.0]], dtype=f32, device=dev)
    lights = torch.tensor([[0.0, 0.0, 1000.0], [500.0, 0.0, 10.0]],
                          dtype=f32, device=dev)
    return (origins.contiguous(), dirs.contiguous(), sph.contiguous(),
            torch.zeros((0, 18), dtype=f32, device=dev), pln, lights)


def partial_block_inputs(dev, n_rays: int, n_sph: int = 64):
    """Arguments of kernel 7 where a light's segment is blocked by the first
    sphere on some lanes of a warp and not on others: rays straight down
    from (x, y, 5), x = (lane - 15.5) / 10 across each warp, onto the plane
    z = 0; the first sphere, (0, 0, 3) with r = 0.5, shades the plane
    around the origin from a light at (0, 0, 10) (a second at (4, 3, 10));
    the other n_sph - 1 spheres lie under the plane and block nothing, so
    a blocked lane could skip all of them."""
    f32 = torch.float32
    i = torch.arange(n_rays, device=dev)
    x = ((i % 32).to(f32) - 15.5) * 0.1
    y = ((i // 32) % 16).to(f32) * 0.1 - 0.75
    origins = torch.stack([x, y, torch.full_like(x, 5.0)], -1)
    dirs = torch.zeros_like(origins)
    dirs[:, 2] = -1.0
    k = torch.arange(n_sph, device=dev).to(f32)
    sph = torch.stack([3.0 * k, torch.full_like(k, 20.0),
                       torch.where(k == 0, 3.0, -5.0),
                       torch.full_like(k, 0.5)], -1)
    sph[0, :2] = 0.0
    pln = torch.tensor([[0.0, 0.0, 1.0, 0.0]], dtype=f32, device=dev)
    lights = torch.tensor([[0.0, 0.0, 10.0], [4.0, 3.0, 10.0]], dtype=f32,
                          device=dev)
    return (origins.contiguous(), dirs.contiguous(), sph.contiguous(),
            torch.zeros((0, 18), dtype=f32, device=dev), pln, lights)


def mixed_warps(occ, hit):
    """Share of the warps (32 consecutive rays) in which some hit lanes are
    blocked from light 0 and some are not."""
    n = occ.shape[1] // 32 * 32
    o = (occ[0, :n] & hit[:n]).reshape(-1, 32)
    f = ((~occ[0, :n]) & hit[:n]).reshape(-1, 32)
    return float((o.any(dim=1) & f.any(dim=1)).float().mean())


def _segment_floor(f32):
    """The largest float32 d with d * d <= _DIV_EPS (1e-12) in float32."""
    eps = torch.tensor(1.0e-12, dtype=f32)
    d = torch.tensor(1.0e-6, dtype=f32)
    zero, one = torch.tensor(0.0, dtype=f32), torch.tensor(1.0, dtype=f32)
    while d * d > eps:
        d = torch.nextafter(d, zero)
    while torch.nextafter(d, one) ** 2 <= eps:
        d = torch.nextafter(d, one)
    return torch.stack([torch.nextafter(d, zero), d, torch.nextafter(d, one)])


def shadow_graze_inputs(dev, n_sph: int, tile_p: int = 1024):
    """Arguments (args, kwargs) of kernel 3 (culled.shadow_occlusion) on 4
    tiles and 2 lights whose shadow segments graze spheres, so that the
    lanes of a warp are blocked at different rows or not at all. Sphere j
    sits at (0, 4 j, 0) with r = 1 - 2^-24, 1 or 1 + 2^-23 by j mod 3
    (r * r rounds to 1 - 2^-23, 1 and 1 + 2^-22). Ray i, j = 7919 i mod
    n_sph, has its hit point at (0, 0, 992) under lights at (0, 0, 1000)
    and (0, 0, 994), so its segments are (0, 0, 8) and (0, 0, 2), and by
    i mod 8 casts from:
      0-4: c_j + (1, 0, -1), tangent to sphere j: the discriminant an ulp
           below 0, at 0 and two ulps above;
      5:   c_j + (1, 0, 1), the sphere behind the segment;
      6:   c_j + (0.5, 0, 0), inside the sphere (blocked: the end is out);
      7:   c_j + (-1 - 2^-23, 0, 0), just outside, with its hit point at
           (-d, 0, 1000): light 0's segment (d, 0, 0) ends inside the
           sphere, so it is blocked iff qa = d * d > _DIV_EPS, and d is the
           float whose square is the last at or below _DIV_EPS or an ulp
           either side.
    A plane at z = 50 blocks nothing. Hot pairs (hot_ids): light 0 on
    tiles 0 and 1, light 1 on tiles 1 and 3, so tile 0 is hot for light 0
    only, tile 3 for light 1 only and tile 2 for neither. A cold pair
    lists the spheres of its tile's first 8 rays, slot 5 invalid (r NaN),
    and counts 7 of them. n_sph above 1024 runs several staged chunks of
    the hot pairs' table (n_sph % 1024 != 0: a partial last one)."""
    f32 = torch.float32
    n_tiles, n_lights, ks = 4, 2, 8
    j = torch.arange(n_sph, device=dev)
    r = torch.tensor([1.0 - 2.0 ** -24, 1.0, 1.0 + 2.0 ** -23], dtype=f32,
                     device=dev)[j % 3]
    zero = torch.zeros(n_sph, dtype=f32, device=dev)
    spheres = torch.stack([zero, 4.0 * j.to(f32), zero, r], -1)
    i = torch.arange(n_tiles * tile_p, device=dev)
    target, kind = (i * 7919) % n_sph, i % 8
    cx = torch.tensor([1.0] * 6 + [0.5, -1.0 - 2.0 ** -23], dtype=f32,
                      device=dev)[kind]
    cz = torch.tensor([-1.0] * 5 + [1.0, 0.0, 0.0], dtype=f32,
                      device=dev)[kind]
    cast = torch.stack([cx, 4.0 * target.to(f32), cz], -1)
    d = _segment_floor(f32).to(dev)[(i // 8) % 3]
    near = kind == 7
    hit_p = torch.stack([torch.where(near, -d, 0.0), 0.0 * d,
                         torch.where(near, 1000.0, 992.0)], -1)
    lights = torch.tensor([[0.0, 0.0, 1000.0], [0.0, 0.0, 994.0]],
                          dtype=f32, device=dev)
    first = target.reshape(n_tiles, tile_p)[:, :ks]            # (T, Ks)
    rows = spheres[first]                                      # (T, Ks, 4)
    rows[:, 5, 3] = torch.nan
    ssph = rows[:, None].expand(n_tiles, n_lights, ks, 4).contiguous()
    hot_ids = torch.tensor([[0, 1], [1, 3]], dtype=torch.int32, device=dev)
    cnt = torch.zeros((n_tiles, n_lights, 2), dtype=torch.int32, device=dev)
    cnt[..., 0] = ks - 1
    for li in range(n_lights):
        cnt[hot_ids[li].long(), li, 0] = -1
    pln = torch.zeros((1, 16), dtype=f32, device=dev)
    pln[0, :4] = torch.tensor([0.0, 0.0, 1.0, 50.0])
    return ((cast.contiguous(), hit_p.contiguous(), lights, (True, True),
             ssph, torch.zeros((n_tiles, n_lights, 0, 24), dtype=f32,
                               device=dev), pln, cnt, tile_p),
            dict(hot_ids=hot_ids, spheres=spheres.contiguous()))


def ragged_masks(dev):
    """(mask, k) cases of kernel 6: widths 1025, 4095 and 4097 (rows that
    start off a 16-byte boundary, a ragged head and tail), each with rows
    of 0, K - 1, K, K + 1 and N survivors and rows of random density."""
    gen = torch.Generator(device="cpu").manual_seed(6)
    cases = []
    for n in (1025, 4095, 4097):
        k = 232
        rows = []
        for c in (0, k - 1, k, k + 1, n):
            row = torch.zeros(n, dtype=torch.bool)
            row[torch.randperm(n, generator=gen)[:c]] = True
            rows.append(row)
        for p in (0.001, 0.02, 0.3):
            rows.append(torch.rand(n, generator=gen) < p)
        mask = torch.stack(rows + rows[::-1] + rows)        # 24 rows
        cases.append((mask.to(dev), k))
    return cases
