"""Procedural scene builders for the benchmark configs.

Port of ``openglraytracer_tpu/models/builders.py``. The random draws come
from the same seeded numpy generators in the same order, and float64 host
values round to float32 exactly as ``jnp.asarray`` rounds them, so every
scene here is bit-identical to its JAX twin. Every sphere gets its own
material row.
"""

from __future__ import annotations

import numpy as np
import torch

from openglraytracer_tpu_torch.models.scene import (
    Camera,
    Planes,
    Scene,
    Spheres,
    _t,
    make_camera,
    make_lights,
    make_materials,
    make_scene,
)


def _matte(diffuse, ambient=0.15, specular=0.4, shininess=16.0,
           reflectivity=0.0, transparency=0.0, refraction_index=1.0):
    return dict(ambient=ambient, diffuse=tuple(diffuse) + (1.0,)
                if len(diffuse) == 3 else diffuse,
                specular=specular, shininess=shininess, emissive=0.0,
                reflectivity=reflectivity, transparency=transparency,
                refraction_index=refraction_index)


def _ground_plane(material_id, z=-1.0, dtype=torch.float32,
                  device="cuda") -> Planes:
    return Planes(
        normal=_t([[0.0, 0.0, 1.0]], dtype, device),
        offset=_t([z], dtype, device),
        material_id=_t([material_id], torch.int32, device),
    )


def single_sphere_scene(dtype=torch.float32,
                        device="cuda") -> tuple[Scene, Camera]:
    """Config 1: single sphere + ground plane, 1 point light, 256x256."""
    mats = make_materials([
        _matte((0.9, 0.25, 0.2), shininess=32.0),   # sphere
        _matte((0.5, 0.5, 0.55), specular=0.2),     # ground
    ], dtype, device)
    spheres = Spheres(
        center=_t([[0.0, 0.0, 0.5]], dtype, device),
        radius=_t([1.5], dtype, device),
        material_id=_t([0], torch.int32, device),
    )
    lights = make_lights([
        dict(position=(5.0, -4.0, 6.0), ambient=0.15, diffuse=1.0,
             specular=1.0),
    ], dtype, device)
    scene = make_scene(spheres=spheres,
                       planes=_ground_plane(1, -1.0, dtype, device),
                       materials=mats, lights=lights)
    cam = make_camera((0.0, -7.0, 2.5), angles=(-12.0, 0.0, 0.0),
                      aspect=1.0, dtype=dtype, device=device)
    return scene, cam


def eight_sphere_scene(dtype=torch.float32,
                       device="cuda") -> tuple[Scene, Camera]:
    """Config 2: 8 spheres + plane, 2 lights with hard shadows, 512x512."""
    rng = np.random.default_rng(8)
    n = 8
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    centers = np.stack([3.0 * np.cos(ang), 3.0 * np.sin(ang),
                        0.4 + 0.9 * rng.random(n)], -1)
    radii = 0.5 + 0.5 * rng.random(n)
    colors = 0.25 + 0.75 * rng.random((n, 3))

    mats = make_materials(
        [_matte(tuple(c), shininess=8.0 + 40.0 * rng.random())
         for c in colors] + [_matte((0.45, 0.5, 0.45), specular=0.2)],
        dtype, device)
    spheres = Spheres(
        center=_t(centers, dtype, device),
        radius=_t(radii, dtype, device),
        material_id=torch.arange(n, dtype=torch.int32, device=device),
    )
    lights = make_lights([
        dict(position=(8.0, -6.0, 7.0), ambient=0.08, diffuse=0.9,
             specular=0.9),
        dict(position=(-7.0, 2.0, 5.0), ambient=0.05,
             diffuse=(0.4, 0.5, 1.0, 1.0), specular=(0.4, 0.5, 1.0, 1.0)),
    ], dtype, device)
    scene = make_scene(spheres=spheres,
                       planes=_ground_plane(n, -0.5, dtype, device),
                       materials=mats, lights=lights)
    cam = make_camera((0.0, -10.0, 4.0), angles=(-16.0, 0.0, 0.0),
                      aspect=1.0, dtype=dtype, device=device)
    return scene, cam


def sphere_grid_scene(side: int = 8, spacing: float = 2.5,
                      reflectivity: float = 0.0, seed: int = 64,
                      dtype=torch.float32,
                      device="cuda") -> tuple[Scene, Camera]:
    """Config 3 (side=8 -> 64 spheres @1024^2) and config 5 (side=64 -> 4096
    spheres @2048^2): a side x side grid of spheres over a ground plane,
    per-sphere materials. reflectivity > 0 turns it into the config-4 mirror
    variant."""
    rng = np.random.default_rng(seed)
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    half = (side - 1) / 2.0
    centers = np.stack([
        (ii.ravel() - half) * spacing,
        (jj.ravel() - half) * spacing,
        0.7 + 0.8 * rng.random(n),
    ], -1)
    radii = 0.45 + 0.4 * rng.random(n)
    colors = 0.15 + 0.85 * rng.random((n, 3))

    mats = make_materials(
        [_matte(tuple(c), shininess=4.0 + 60.0 * rng.random(),
                reflectivity=reflectivity) for c in colors]
        + [_matte((0.4, 0.42, 0.48), specular=0.15,
                  reflectivity=reflectivity * 0.5)], dtype, device)
    spheres = Spheres(
        center=_t(centers, dtype, device),
        radius=_t(radii, dtype, device),
        material_id=torch.arange(n, dtype=torch.int32, device=device),
    )
    lights = make_lights([
        dict(position=(side * spacing, -side * spacing, side * spacing),
             ambient=0.1, diffuse=1.0, specular=1.0),
        dict(position=(-side * spacing * 0.6, side * spacing * 0.4,
                       side * spacing * 0.8),
             ambient=0.03, diffuse=(0.8, 0.3, 0.2, 1.0),
             specular=(0.8, 0.3, 0.2, 1.0)),
    ], dtype, device)
    scene = make_scene(spheres=spheres,
                       planes=_ground_plane(n, 0.0, dtype, device),
                       materials=mats, lights=lights)
    dist = side * spacing
    cam = make_camera((0.0, -dist, dist * 0.55),
                      angles=(-28.0, 0.0, 0.0), aspect=1.0, dtype=dtype,
                      device=device)
    return scene, cam


def mirror_scene(dtype=torch.float32, device="cuda") -> tuple[Scene, Camera]:
    """Config 4: 1-bounce mirror reflection, 1024x1024."""
    return sphere_grid_scene(side=8, reflectivity=0.6, seed=4, dtype=dtype,
                             device=device)


def mirror_grid4096_scene(dtype=torch.float32,
                          device="cuda") -> tuple[Scene, Camera]:
    """4096 mirror spheres at depth 1 (the c4 x c5 composition)."""
    return sphere_grid_scene(side=64, reflectivity=0.6, seed=1, dtype=dtype,
                             device=device)


def glass_grid_scene(side: int = 64, dtype=torch.float32,
                     device="cuda") -> tuple[Scene, Camera]:
    """side x side GLASS spheres (reflectivity 0.25 and transparency 0.35,
    so both bounce branches live) over an opaque ground plane: the c5 grid
    (seed 1) with every sphere refractive at index 1.45; side=64 gives
    the 4096-sphere scene of the culled stack engine's benchmark row
    (``bench.py glass_grid_scene``)."""
    scene, cam = sphere_grid_scene(side, reflectivity=0.25, seed=1,
                                   dtype=dtype, device=device)
    m = scene.materials
    transparency = torch.full_like(m.transparency, 0.35)
    transparency[-1] = 0.0                  # the ground plane stays opaque
    scene = scene._replace(materials=m._replace(
        transparency=transparency,
        refraction_index=torch.full_like(m.refraction_index, 1.45)))
    return scene, cam


BENCH_CONFIGS = {
    # name -> (builder, height, width, depth); builder(dtype=, device=)
    "c1_sphere_plane": (single_sphere_scene, 256, 256, 0),
    "c2_eight_spheres": (eight_sphere_scene, 512, 512, 0),
    "c3_grid64": (lambda dtype=torch.float32, device="cuda":
                  sphere_grid_scene(8, dtype=dtype, device=device),
                  1024, 1024, 0),
    "c4_mirror": (mirror_scene, 1024, 1024, 1),
    "c5_grid4096": (lambda dtype=torch.float32, device="cuda":
                    sphere_grid_scene(64, dtype=dtype, device=device),
                    2048, 2048, 0),
    "c4_mirror4096": (mirror_grid4096_scene, 1024, 1024, 1),
}
