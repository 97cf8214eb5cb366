"""Fused Phong shade kernels: the forward and its analytic backward.

Port of ``openglraytracer_tpu/ops/pallas_shade.py`` (``phong_fused`` /
``shade_fused``). ``phong_fused`` is a ``torch.autograd.Function``:

  forward   ``phong_shade``: csrc/phong_shade.cu on CUDA tensors — one pass
            per ray: material row, direction, hit point and normal and the
            per-light occlusion bytes go in, rgb * alpha comes out — and its
            plain version ``shading.phong_core`` on CPU tensors;
  backward  ``phong_shade_bwd``: csrc/phong_shade_bwd.cu on CUDA tensors,
            ``phong_shade_bwd_plain`` on CPU tensors — the hand-derived
            cotangents of the material rows, directions, hit points and
            normals per ray, and of the light columns summed over rays. The
            occlusion gets no cotangent (it is binary).

Each wrapper counts its launches in ``kernels.LAUNCHES``.
"""

from __future__ import annotations

import torch

from openglraytracer_tpu_torch import kernels
from openglraytracer_tpu_torch.ops.intersect import _SQRT_EPS
from openglraytracer_tpu_torch.ops.shading import _POW_EPS, phong_core

MAT_COLS, LIGHT_COLS = 20, 16
LIGHT_GRADS = 15      # per light: pos(3) amb(4) diff(4) spec(4)
_BLOCK = 256          # rays per block of the backward kernel (kBlock in
                      # csrc/common.cuh): one row of light partial sums each


def _light_table(lpos, lamb, ldiff, lspec):
    """(L, 16) [pos(3) pad amb(4) diff(4) spec(4)], the kernels' layout."""
    return torch.cat([lpos, torch.zeros_like(lpos[:, :1]), lamb, ldiff,
                      lspec], dim=-1)


def _check_rays(dev, lights, mat_rows, dirs, p, n, occluded):
    r_total, n_lights = dirs.shape[0], lights.shape[0]
    f32 = torch.float32
    kernels.check("lights", lights, dev, f32, (n_lights, LIGHT_COLS))
    kernels.check("mat_rows", mat_rows, dev, f32, (r_total, MAT_COLS))
    kernels.check("dirs", dirs, dev, f32, (r_total, 3))
    kernels.check("p", p, dev, f32, (r_total, 3))
    kernels.check("n", n, dev, f32, (r_total, 3))
    kernels.check("occluded", occluded, dev, torch.bool,
                  (r_total, n_lights))


@kernels.wrapper
def phong_shade(mat_rows, lpos, lamb, ldiff, lspec, dirs, p, n, occluded):
    """Forward wrapper: ADS Phong per ray. mat_rows (R, 20); lpos (L, 3);
    lamb/ldiff/lspec (L, 4); dirs/p/n (R, 3); occluded (R, L) bool.
    Returns (R, 3). Kernel csrc/phong_shade.cu on CUDA tensors,
    shading.phong_core on CPU tensors."""
    if kernels.on_cpu(dirs):
        return phong_core(mat_rows, lpos, lamb, ldiff, lspec, dirs, p, n,
                          occluded)
    dev = dirs.device
    lights = _light_table(lpos, lamb, ldiff, lspec)
    _check_rays(dev, lights, mat_rows, dirs, p, n, occluded)
    r_total, n_lights = dirs.shape[0], lpos.shape[0]
    rgb = torch.empty((r_total, 3), dtype=torch.float32, device=dev)
    kernels.launch("oglrt_phong_shade", dev, lights, mat_rows, dirs, p, n,
                   occluded, r_total, n_lights, rgb)
    kernels.LAUNCHES["phong_fused"] += 1
    return rgb


def _dot(a, b):
    """Row-wise 3-vector dot (R, 1), summed x + y + z as the kernels do."""
    return a[:, 0:1] * b[:, 0:1] + a[:, 1:2] * b[:, 1:2] + a[:, 2:3] * b[:, 2:3]


def _sum4(x):
    """(R, 4) -> (R, 1), summed 0 + 1 + 2 + 3 as the kernels do."""
    return x[:, 0:1] + x[:, 1:2] + x[:, 2:3] + x[:, 3:4]


def _light_terms(lpos_j, p, n, v, m_shin, occluded_j):
    """Forward terms of one light, as csrc/phong_shade.cu computes them."""
    tl = lpos_j - p
    stl = _dot(tl, tl)
    inv_tl = torch.rsqrt(torch.clamp(stl, min=_SQRT_EPS))
    ld = tl * inv_tl
    lit = (~occluded_j)[:, None].to(p.dtype)
    dn = -_dot(ld, n)
    r0 = -ld - 2.0 * dn * n
    sr = _dot(r0, r0)
    inv_r = torch.rsqrt(torch.clamp(sr, min=_SQRT_EPS))
    rh = r0 * inv_r
    ct_raw = _dot(ld, n)
    cos_phi = _dot(v, rh)
    sb = torch.clamp(cos_phi, min=_POW_EPS)
    logsb = torch.log(sb)
    val = torch.exp(m_shin * logsb)
    lit_ct = lit * torch.clamp(ct_raw, min=0.0)
    lit_pw = lit * torch.where(cos_phi > 0.0, val, 0.0)
    return (stl, inv_tl, ld, lit, dn, sr, inv_r, rh, ct_raw, cos_phi, sb,
            logsb, val, lit_ct, lit_pw)


def phong_shade_bwd_plain(mat_rows, lpos, lamb, ldiff, lspec, dirs, p, n,
                          occluded, g):
    """Plain version of the backward kernel: the analytic VJP of
    phong_shade at cotangent g (R, 3), vectorized over rays and looping over
    lights in the kernel's order. Returns (g_mat (R, 20), g_lpos (L, 3),
    g_lamb, g_ldiff, g_lspec (L, 4), g_dirs, g_p, g_n (R, 3)). The gates
    are strict (cos_phi > 0, cos_phi > 1e-12, l.n > 0) and each normalize's
    VJP drops its projection term at squared lengths <= 1e-20: the
    reference kernel's semantics, which differ from autograd of phong_core
    only at those measure-zero ties."""
    dtype = dirs.dtype
    m_amb, m_dif, m_spe, m_emi = (mat_rows[:, 4 * q:4 * q + 4]
                                  for q in range(4))
    m_shin = mat_rows[:, 16:17]
    sd = _dot(dirs, dirs)
    inv_d = torch.rsqrt(torch.clamp(sd, min=_SQRT_EPS))
    v = -dirs * inv_d
    n_lights = lpos.shape[0]

    amb = torch.zeros_like(m_amb)
    dif = torch.zeros_like(m_amb)
    spe = torch.zeros_like(m_amb)
    for j in range(n_lights):
        amb = amb + lamb[j] * m_amb
        *_, lit_ct, lit_pw = _light_terms(lpos[j], p, n, v, m_shin,
                                          occluded[:, j])
        dif = dif + ldiff[j] * m_dif * lit_ct
        spe = spe + lspec[j] * m_spe * lit_pw
    ph = amb + dif + spe + m_emi

    g_ph = torch.cat([g * ph[:, 3:4], _dot(g, ph)], dim=-1)
    g_amb = torch.zeros_like(g_ph)
    g_dif = torch.zeros_like(g_ph)
    g_spe = torch.zeros_like(g_ph)
    g_shin = torch.zeros_like(m_shin)
    gv = torch.zeros_like(dirs)
    gp = torch.zeros_like(dirs)
    gn = torch.zeros_like(dirs)
    light_rows = []
    for j in range(n_lights):
        (stl, inv_tl, ld, lit, dn, sr, inv_r, rh, ct_raw, cos_phi, sb, logsb,
         val, lit_ct, lit_pw) = _light_terms(lpos[j], p, n, v, m_shin,
                                             occluded[:, j])
        g_amb = g_amb + lamb[j] * g_ph
        g_dif = g_dif + ldiff[j] * lit_ct * g_ph
        g_spe = g_spe + lspec[j] * lit_pw * g_ph
        g_lit_ct = _sum4(ldiff[j] * m_dif * g_ph)
        g_lit_pw = _sum4(lspec[j] * m_spe * g_ph)
        g_cos_theta = lit * g_lit_ct
        g_val = torch.where(cos_phi > 0.0, lit * g_lit_pw, 0.0)
        g_shin = g_shin + g_val * val * logsb
        g_cos_phi = torch.where(cos_phi > _POW_EPS,
                                g_val * val * m_shin / sb, 0.0)
        g_ct_raw = torch.where(ct_raw > 0.0, g_cos_theta, 0.0)
        # cos_phi = v . rhat; rhat = r0 * inv_r
        gv = gv + g_cos_phi * rh
        grh = g_cos_phi * v
        gate_r = (sr > _SQRT_EPS).to(dtype)
        gr0 = inv_r * (grh - gate_r * rh * _dot(rh, grh))
        # r0 = -l - 2 dn n; dn = -(l . n); ct_raw = l . n
        g_dn = -2.0 * _dot(n, gr0)
        gn = gn - 2.0 * dn * gr0
        gl = -gr0 - g_dn * n
        gn = gn - g_dn * ld
        gl = gl + g_ct_raw * n
        gn = gn + g_ct_raw * ld
        # l = tl * inv_tl; tl = light - p
        gate_tl = (stl > _SQRT_EPS).to(dtype)
        gtl = inv_tl * (gl - gate_tl * ld * _dot(ld, gl))
        gp = gp - gtl
        light_rows.append(torch.cat([
            torch.sum(gtl, dim=0), torch.sum(m_amb * g_ph, dim=0),
            torch.sum(m_dif * lit_ct * g_ph, dim=0),
            torch.sum(m_spe * lit_pw * g_ph, dim=0)]))

    gate_d = (sd > _SQRT_EPS).to(dtype)
    g_dirs = -(inv_d * (gv - gate_d * v * _dot(v, gv)))
    g_mat = torch.cat([g_amb, g_dif, g_spe, g_ph, g_shin,
                       torch.zeros_like(dirs)], dim=-1)
    lg = (torch.stack(light_rows) if light_rows
          else torch.zeros((0, LIGHT_GRADS), dtype=dtype, device=dirs.device))
    return (g_mat, lg[:, 0:3], lg[:, 3:7], lg[:, 7:11], lg[:, 11:15], g_dirs,
            gp, gn)


@kernels.wrapper
def phong_shade_bwd(mat_rows, lpos, lamb, ldiff, lspec, dirs, p, n,
                    occluded, g):
    """Backward wrapper: csrc/phong_shade_bwd.cu on CUDA tensors,
    phong_shade_bwd_plain on CPU tensors; arguments and results as
    phong_shade_bwd_plain. The kernel writes per-block partial sums of the
    light cotangents, which one torch.sum adds up on the device."""
    if kernels.on_cpu(dirs):
        return phong_shade_bwd_plain(mat_rows, lpos, lamb, ldiff, lspec,
                                     dirs, p, n, occluded, g)
    dev = dirs.device
    lights = _light_table(lpos, lamb, ldiff, lspec)
    _check_rays(dev, lights, mat_rows, dirs, p, n, occluded)
    r_total, n_lights = dirs.shape[0], lpos.shape[0]
    f32 = torch.float32
    kernels.check("g", g, dev, f32, (r_total, 3))
    if mat_rows.data_ptr() % 16:
        raise ValueError("mat_rows: the kernel reads rows as float4 and "
                         "needs a 16-byte aligned tensor")
    g_mat = torch.empty((r_total, MAT_COLS), dtype=f32, device=dev)
    g_dirs, g_p, g_n = (torch.empty((r_total, 3), dtype=f32, device=dev)
                        for _ in range(3))
    blocks = -(-r_total // _BLOCK)
    part = torch.empty((blocks, n_lights * LIGHT_GRADS), dtype=f32,
                       device=dev)
    kernels.launch("oglrt_phong_shade_bwd", dev, lights, mat_rows, dirs, p, n,
                   occluded, g, r_total, n_lights, g_mat, g_dirs, g_p, g_n,
                   part)
    kernels.LAUNCHES["phong_shade_bwd"] += 1
    lg = torch.sum(part, dim=0).reshape(n_lights, LIGHT_GRADS)
    return (g_mat, lg[:, 0:3], lg[:, 3:7], lg[:, 7:11], lg[:, 11:15], g_dirs,
            g_p, g_n)


class _PhongFused(torch.autograd.Function):
    """Forward phong_shade, backward phong_shade_bwd; no cotangent for the
    occlusion."""

    @staticmethod
    def forward(ctx, mat_rows, lpos, lamb, ldiff, lspec, dirs, p, n,
                occluded):
        ctx.save_for_backward(mat_rows, lpos, lamb, ldiff, lspec, dirs, p, n,
                              occluded)
        return phong_shade(mat_rows, lpos, lamb, ldiff, lspec, dirs, p, n,
                           occluded)

    @staticmethod
    def backward(ctx, g):
        grads = phong_shade_bwd(*ctx.saved_tensors, g.contiguous())
        return (*(gr if want else None
                  for gr, want in zip(grads, ctx.needs_input_grad)), None)


def phong_fused(mat_rows, lpos, lamb, ldiff, lspec, dirs, p, n, occluded):
    """ADS Phong per ray with the analytic backward: mat_rows (R, 20);
    lpos (L, 3); lamb/ldiff/lspec (L, 4); dirs/p/n (R, 3); occluded (R, L)
    bool. Returns (R, 3)."""
    return _PhongFused.apply(mat_rows, lpos, lamb, ldiff, lspec, dirs, p, n,
                             occluded)


def shade_fused(scene, dirs, hit, occluded, mat_rows):
    """Phong color (R, 3) of each ray's hit from its survivor-routed
    material rows (R, 20) and occlusion (R, L); garbage-but-finite on
    misses (the caller masks)."""
    lights = scene.lights
    return phong_fused(mat_rows, lights.position, lights.ambient,
                       lights.diffuse, lights.specular, dirs, hit.p, hit.n,
                       occluded)
