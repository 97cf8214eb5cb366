"""The tile mesh of the sharded render: one process per device.

Port of ``openglraytracer_tpu/parallel/mesh.py``. The reference shards the
(H, W) pixel grid over a 2-D ``jax.sharding.Mesh`` with axes ('dx', 'dy')
in one controller; PyTorch runs one process per device, so the mesh here is
a description: its shape (dx, dy), this process's coordinate (i, j) in it
(from its rank, row-major) and the ``torch.distributed`` process group of
its ranks. The scene is replicated; coordinate (i, j) owns the pixel tile
of rows [i H/dx, (i+1) H/dx) and columns [j W/dy, (j+1) W/dy).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch.distributed as dist

AXIS_X = "dx"  # image rows
AXIS_Y = "dy"  # image cols


def _factor2(n: int) -> tuple[int, int]:
    """Near-square factorization of n (prefers more row shards)."""
    best = (n, 1)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (n // a, a)
    return best


@dataclass(frozen=True)
class TileMesh:
    """shape (dx, dy) over the axes ``names``; coord, this rank's (i, j);
    group, the process group of the mesh's ranks (None without a process
    group: a single process, the (1, 1) mesh)."""
    shape: tuple[int, int]
    coord: tuple[int, int]
    group: Any = None
    names: tuple[str, str] = (AXIS_X, AXIS_Y)

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]


def make_mesh(world_size: int | None = None,
              shape: tuple[int, int] | None = None,
              group=None) -> TileMesh:
    """The ('dx', 'dy') mesh over the ranks of ``group`` (default: the
    initialized world, else the single process). world_size, when given,
    must be the group's size; shape defaults to its near-square
    factorization and must multiply to it."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    n_group = dist.get_world_size(group) if group is not None else 1
    n = n_group if world_size is None else world_size
    if n != n_group:
        raise ValueError(f"world_size {n} but the process group has "
                         f"{n_group} rank(s)")
    if shape is None:
        shape = _factor2(n)
    shape = tuple(shape)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh {shape} != {n} devices")
    rank = dist.get_rank(group) if group is not None else 0
    return TileMesh(shape=shape, coord=(rank // shape[1], rank % shape[1]),
                    group=group)


def tile_slice(mesh, height: int, width: int,
               coord: tuple[int, int]) -> tuple[slice, slice]:
    """(rows, cols) of the pixel tile that coord owns on mesh (a TileMesh
    or its shape (dx, dy)) over an image of height x width; the mesh must
    divide the image."""
    dx, dy = mesh.shape if isinstance(mesh, TileMesh) else mesh
    if height % dx or width % dy:
        raise ValueError(f"mesh {dx}x{dy} must divide the image "
                         f"{height}x{width}")
    th, tw = height // dx, width // dy
    i, j = coord
    if not (0 <= i < dx and 0 <= j < dy):
        raise ValueError(f"coordinate {coord} is outside the mesh {dx}x{dy}")
    return slice(i * th, (i + 1) * th), slice(j * tw, (j + 1) * tw)
