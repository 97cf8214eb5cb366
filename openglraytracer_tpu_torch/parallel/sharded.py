"""Tile-sharded rendering: one process per device, one pixel tile each.

Port of ``openglraytracer_tpu/parallel/sharded.py``. The render is
embarrassingly parallel over pixels: each rank traces the rays of its
(H/dx, W/dy) tile of the mesh (parallel/mesh.py) against the replicated
scene, with no communication in the forward pass. The reference's
``shard_map`` body is ``render_tile``, a function of the mesh coordinate,
so that one process can also run every coordinate in turn (one card, or
the CPU tests). The only collectives are the overflow count's and, in
training, the gradients' ``all_reduce`` (train/inverse.py) and the image
gather (parallel/distributed.gather_image).
"""

from __future__ import annotations

import torch.distributed as dist

from openglraytracer_tpu_torch.models.scene import Camera, Scene
from openglraytracer_tpu_torch.ops.accel import parse_cull_spec
from openglraytracer_tpu_torch.ops.raygen import generate_rays
from openglraytracer_tpu_torch.ops.render import (CULLED, _check_device,
                                                  render_rays)
from openglraytracer_tpu_torch.parallel.mesh import TileMesh, tile_slice


def render_tile(scene: Scene, camera: Camera, height: int, width: int, *,
                mesh_shape: tuple[int, int], coord: tuple[int, int],
                depth: int = 0, chunk_size: int = 512, remat: bool = False,
                mirror_only: bool = False, engine: str = "auto",
                cull: tuple | None = None,
                shadow_lights: tuple | None = None,
                bounce_mask: tuple = (True, True),
                child_cull: tuple | None = None, fused_shade: bool = True):
    """The tile of coordinate coord on a mesh of mesh_shape (dx, dy):
    returns (tile (H/dx, W/dy, 3), overflow), overflow a device int32
    scalar counting this tile's culled-K overflow events (0 for the dense
    engines). Only the tile's rays are generated, equal bit for bit to the
    whole image's cut to the tile, and rendered by ops/render.render_rays.

    The culled engines cull per tile against its own sub-image's cones:
    cull = ((th, tw), kp, ks[, hot_m[, kb, ksb]]) with (th, tw) dividing
    the tile, and child_cull, with the same (th, tw), traces the bounce
    children on the culled path, as ops/render.render."""
    dx, dy = mesh_shape
    if height % dx:
        raise ValueError(f"height {height} not divisible by mesh dx={dx}")
    if width % dy:
        raise ValueError(f"width {width} not divisible by mesh dy={dy}")
    tile_h, tile_w = height // dx, width // dy
    if engine in CULLED and cull is not None:
        (cth, ctw) = parse_cull_spec(cull)[0]
        if tile_h % cth or tile_w % ctw:
            raise ValueError(f"cull tile {(cth, ctw)} must divide the "
                             f"per-device tile {(tile_h, tile_w)}")
    _check_device(scene, camera, camera.position.device)
    rows, cols = tile_slice(mesh_shape, height, width, coord)
    origins, dirs = generate_rays(camera, height, width, rows, cols)
    return render_rays(scene, origins, dirs, depth=depth,
                       chunk_size=chunk_size, remat=remat,
                       mirror_only=mirror_only, engine=engine, cull=cull,
                       shadow_lights=shadow_lights, with_cull_stats=True,
                       bounce_mask=bounce_mask, child_cull=child_cull,
                       fused_shade=fused_shade)


def render_sharded(scene: Scene, camera: Camera, height: int, width: int,
                   *, mesh: TileMesh, depth: int = 0, chunk_size: int = 512,
                   remat: bool = False, mirror_only: bool = False,
                   engine: str = "auto", cull: tuple | None = None,
                   shadow_lights: tuple | None = None,
                   with_cull_stats: bool = False,
                   bounce_mask: tuple = (True, True),
                   child_cull: tuple | None = None,
                   fused_shade: bool = True):
    """This rank's (H/dx, W/dy, 3) tile of the image, the scene
    replicated: render_tile at mesh.coord. The whole image is assembled
    only by parallel/distributed.gather_image (or utils/image.save_png),
    as the reference's is a sharded global array.

    with_cull_stats: also return the overflow count summed over the mesh's
    ranks (an all_reduce), a device int32 scalar on every rank (0 for the
    dense engines)."""
    if mesh.group is None and mesh.size > 1:
        raise ValueError(f"a {mesh.shape} mesh needs a process group of "
                         f"{mesh.size} ranks (parallel/distributed."
                         "init_distributed); in one process, loop "
                         "render_tile over the coordinates")
    img, ovf = render_tile(scene, camera, height, width,
                           mesh_shape=mesh.shape, coord=mesh.coord,
                           depth=depth, chunk_size=chunk_size, remat=remat,
                           mirror_only=mirror_only, engine=engine, cull=cull,
                           shadow_lights=shadow_lights,
                           bounce_mask=bounce_mask, child_cull=child_cull,
                           fused_shade=fused_shade)
    if not with_cull_stats:
        return img
    if mesh.group is not None:
        dist.all_reduce(ovf, group=mesh.group)
    return img, ovf
