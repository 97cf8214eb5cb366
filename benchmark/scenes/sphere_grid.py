"""The benchmark's frozen copy of the sphere-grid recipe of configurations
3 and 5 (a side x side grid of spheres over a ground plane, one material
row per sphere, two point lights), drawn on the device.

The layout (grid positions, the spheres' heights and radii) comes from the
configuration's fixed ``layout_seed``, so every run renders the same
geometry and does the same work; the run's seed draws the spheres' colors
and shininess. Everything is made on ``device`` by a ``torch.Generator``
there, in a few large calls.

Returns plain tensors, the form both the program's adapter and the plain
reference take:

  scene:  center (N, 3), radius (N,), sphere_material (N,) int32,
          plane_normal (P, 3), plane_offset (P,), plane_material (P,) int32,
          ambient / diffuse / specular / emissive (K, 4), shininess,
          reflectivity, transparency, refraction_index (K,),
          light_position (L, 3), light_ambient / light_diffuse /
          light_specular (L, 4)
  camera: position (3,), angles (3,) pitch/yaw/roll degrees, v_fov,
          aspect, near, far (scalars)
"""

from __future__ import annotations

import torch


def _vec4(x):
    """A scalar broadcast to four channels (GLSL vec4(x)), or four values."""
    return [float(x)] * 4 if isinstance(x, (int, float)) else list(x)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make(spec: dict, seed: int, device, dtype=torch.float32):
    side, spacing = int(spec["side"]), float(spec["spacing"])
    n = side * side
    extent = side * spacing
    kw = dict(device=device, dtype=dtype)

    g_layout = generator(spec["layout_seed"], device)
    heights = spec["height_min"] + spec["height_span"] * torch.rand(
        n, generator=g_layout, **kw)
    radius = spec["radius_min"] + spec["radius_span"] * torch.rand(
        n, generator=g_layout, **kw)
    idx = torch.arange(side, device=device, dtype=dtype)
    half = (side - 1) / 2.0
    gx, gy = torch.meshgrid(idx, idx, indexing="ij")
    center = torch.stack([((gx - half) * spacing).reshape(-1),
                          ((gy - half) * spacing).reshape(-1), heights], -1)

    g = generator(seed, device)
    colors = spec["color_min"] + spec["color_span"] * torch.rand(
        (n, 3), generator=g, **kw)
    shininess = spec["shininess_min"] + spec["shininess_span"] * torch.rand(
        n, generator=g, **kw)

    sm, gm = spec["sphere_material"], spec["ground_material"]

    def column(sphere_value, ground_value):
        rows = torch.tensor([sphere_value], **kw).expand(n, -1)
        return torch.cat([rows, torch.tensor([ground_value], **kw)])

    ones = torch.ones((n, 1), **kw)
    scene = dict(
        center=center.contiguous(),
        radius=radius,
        sphere_material=torch.arange(n, device=device, dtype=torch.int32),
        plane_normal=torch.tensor([[0.0, 0.0, 1.0]], **kw),
        plane_offset=torch.tensor([spec["ground_offset"]], **kw),
        plane_material=torch.tensor([n], device=device, dtype=torch.int32),
        ambient=column(_vec4(sm["ambient"]), _vec4(gm["ambient"])),
        diffuse=torch.cat([torch.cat([colors, ones], -1),
                           torch.tensor([_vec4(gm["diffuse"])], **kw)]),
        specular=column(_vec4(sm["specular"]), _vec4(gm["specular"])),
        emissive=column(_vec4(sm["emissive"]), _vec4(gm["emissive"])),
        shininess=torch.cat([shininess,
                             torch.tensor([gm["shininess"]], **kw)]),
        reflectivity=torch.zeros(n + 1, **kw),
        transparency=torch.zeros(n + 1, **kw),
        refraction_index=torch.ones(n + 1, **kw),
        light_position=torch.tensor(
            [[c * extent for c in li["position_of_extent"]]
             for li in spec["lights"]], **kw),
        light_ambient=torch.tensor(
            [_vec4(li["ambient"]) for li in spec["lights"]], **kw),
        light_diffuse=torch.tensor(
            [_vec4(li["diffuse"]) for li in spec["lights"]], **kw),
        light_specular=torch.tensor(
            [_vec4(li["specular"]) for li in spec["lights"]], **kw),
    )
    cam = spec["camera"]
    camera = dict(
        position=torch.tensor([c * extent for c in cam["position_of_extent"]],
                              **kw),
        angles=torch.tensor(cam["angles"], **kw),
        v_fov=torch.tensor(float(cam["v_fov"]), **kw),
        aspect=torch.tensor(1.0, **kw),
        near=torch.tensor(float(cam["near"]), **kw),
        far=torch.tensor(float(cam["far"]), **kw),
    )
    return scene, camera
