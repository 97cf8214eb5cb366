"""Phong ADS shading math.

Port of ``openglraytracer_tpu/ops/shading.py``: the packed 20-column
material table and its per-ray views, the static masks of lights that need
shadow rays and of bounce branches that can contribute, ``phong_core`` —
the lighting math over raw per-ray arrays, which is also the plain version
of the fused shade kernel (``ops/shade.py``) — ``phong_shade_lit``, the
plain-torch shade of the dense engines and of bounce children (as in the
reference, which shades them with its XLA chain, not the fused kernel),
and ``shadow_masks`` and ``phong_shade``, the shade with its own
``any_hit`` shadow queries that engine 'autodiff' differentiates through.
Reference quirks kept: the shadow segment is the
unnormalized light_pos - p, and the output is ``phong.rgb * phong.a``.
"""

from __future__ import annotations

import torch

from openglraytracer_tpu_torch.models.scene import Scene
from openglraytracer_tpu_torch.ops.intersect import (Hit, _safe_normalize,
                                                     any_hit)

_POW_EPS = 1.0e-12
SHADOW_EPS = 0.01  # shadow-ray origin offset along the normal


def _safe_pow(base, exponent):
    """pow(max(base, 0), e), written as exp(e * log(max(base, eps)))."""
    val = torch.exp(exponent * torch.log(torch.clamp(base, min=_POW_EPS)))
    return torch.where(base > 0.0, val, 0.0)


def material_table(scene: Scene):
    """All 20 material columns packed into one (K, 20) table:
    [ambient(4) diffuse(4) specular(4) emissive(4) shininess reflectivity
    transparency refraction_index]."""
    m = scene.materials
    return torch.cat([
        m.ambient, m.diffuse, m.specular, m.emissive,
        m.shininess[:, None], m.reflectivity[:, None],
        m.transparency[:, None], m.refraction_index[:, None],
    ], dim=-1)


def materials_from_rows(scene: Scene, rows):
    """(R, 20) packed rows -> a Materials of (R, ...) columns."""
    return scene.materials._replace(
        ambient=rows[..., 0:4],
        diffuse=rows[..., 4:8],
        specular=rows[..., 8:12],
        emissive=rows[..., 12:16],
        shininess=rows[..., 16],
        reflectivity=rows[..., 17],
        transparency=rows[..., 18],
        refraction_index=rows[..., 19],
    )


def gather_materials(scene: Scene, material_id):
    """Per-ray materials (a Materials of (R, ...) columns) gathered from the
    packed table by material id."""
    return materials_from_rows(scene, torch.index_select(
        material_table(scene), 0, material_id))


def static_shadow_mask(scene: Scene) -> tuple:
    """Which lights need shadow rays: a light with zero diffuse AND zero
    specular cannot change the image when occluded (its ambient term is
    added regardless), so its shadow casts are skipped. Reads the light
    table on the host: call it once, outside a frame."""
    d = scene.lights.diffuse.detach().cpu().numpy()
    s = scene.lights.specular.detach().cpu().numpy()
    return tuple(bool((d[i] != 0.0).any() or (s[i] != 0.0).any())
                 for i in range(scene.lights.count))


def static_bounce_mask(scene: Scene) -> tuple[bool, bool]:
    """(has_reflection, has_refraction): which bounce branches can
    contribute. A reflection child counts only where reflectivity > 0 and a
    refraction child only where transparency > 0, so a material table whose
    maxima are 0 makes that branch dead for every ray, and skipping it is
    output- and gradient-identical. Reads the material table on the host:
    call it once, outside a frame."""
    refl = scene.materials.reflectivity.detach().cpu()
    tau = scene.materials.transparency.detach().cpu()
    return bool((refl > 0.0).any()), bool((tau > 0.0).any())


def phong_core(mat_rows, lpos, lamb, ldiff, lspec, dirs, p, n, occluded):
    """ADS Phong from raw arrays. mat_rows (R, 20) packed material rows
    (material_table layout); lpos/lamb/ldiff/lspec the (L, ...) light
    columns; dirs/p/n (R, 3); occluded (R, L) bool. Returns (R, 3)."""
    ambient = torch.zeros_like(mat_rows[..., 0:4])    # (R, 4)
    diffuse = torch.zeros_like(ambient)
    specular = torch.zeros_like(ambient)
    m_amb = mat_rows[..., 0:4]
    m_diff = mat_rows[..., 4:8]
    m_spec = mat_rows[..., 8:12]
    m_emis = mat_rows[..., 12:16]
    m_shin = mat_rows[..., 16]

    view_dir = _safe_normalize(-dirs)

    for j in range(lpos.shape[0]):
        ambient = ambient + lamb[j] * m_amb

        to_light = lpos[j] - p                # unnormalized segment
        light_dir = _safe_normalize(to_light)
        lit = (~occluded[:, j])[:, None].to(dirs.dtype)

        # reflect(-light_dir, n) = d - 2 dot(n, d) n with d = -light_dir
        ld = -light_dir
        light_ref = _safe_normalize(
            ld - 2.0 * torch.sum(n * ld, dim=-1, keepdim=True) * n)
        cos_theta = torch.sum(light_dir * n, dim=-1, keepdim=True)
        cos_phi = torch.sum(view_dir * light_ref, dim=-1, keepdim=True)

        diffuse = diffuse + lit * ldiff[j] * m_diff \
            * torch.clamp(cos_theta, min=0.0)
        specular = specular + lit * lspec[j] * m_spec \
            * _safe_pow(cos_phi, m_shin[:, None])

    phong = ambient + diffuse + specular + m_emis
    return phong[..., :3] * phong[..., 3:4]   # rgb * alpha


def phong_shade_lit(scene: Scene, dirs, hit: Hit, occluded, mat_rows=None):
    """ADS Phong (R, 3) of each ray's hit given the occlusion (R, L), in
    plain torch over phong_core. mat_rows: the (R, 20) material rows routed
    through the cull survivor lists; None gathers them by material id."""
    if mat_rows is None:
        mat_rows = torch.index_select(material_table(scene), 0,
                                      hit.material_id)
    lights = scene.lights
    return phong_core(mat_rows, lights.position, lights.ambient,
                      lights.diffuse, lights.specular, dirs, hit.p, hit.n,
                      occluded)


def shadow_masks(scene: Scene, hit: Hit, chunk_size: int = 512,
                 remat: bool = False):
    """Per-light occlusion (R, L) bool (True = in shadow): an any_hit
    query per light along the segment from p + 0.01 n to the light."""
    shadow_org = hit.p + hit.n * SHADOW_EPS
    cols = [any_hit(scene, shadow_org, scene.lights.position[j] - hit.p,
                    max_t=1.0, chunk_size=chunk_size, remat=remat)
            for j in range(scene.lights.count)]
    if not cols:
        return torch.zeros((hit.p.shape[0], 0), dtype=torch.bool,
                           device=hit.p.device)
    return torch.stack(cols, dim=-1)


def phong_shade(scene: Scene, dirs, hit: Hit, chunk_size: int = 512,
                remat: bool = False):
    """ADS Phong (R, 3) of each ray's hit with its shadow queries (every
    light casts); finite but meaningless on misses (the caller masks)."""
    occluded = shadow_masks(scene, hit, chunk_size=chunk_size, remat=remat)
    return phong_shade_lit(scene, dirs, hit, occluded)
