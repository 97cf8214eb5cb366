"""Multi-process runtime: initialization and the image gather.

Port of ``openglraytracer_tpu/parallel/distributed.py``. The reference
starts JAX's multi-host runtime and assembles the sharded image with a DCN
all-gather. PyTorch runs one process per device: ``init_distributed``
starts the ``torch.distributed`` process group (NCCL for CUDA devices, gloo
for the CPU), and ``gather_image`` assembles the ranks' pixel tiles with an
``all_gather`` on every rank.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def _launcher_environment() -> bool:
    """True where a launcher set up a world of more than one process: a
    WORLD_SIZE above 1 with a MASTER_ADDR, as torchrun sets them."""
    try:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    except ValueError:
        return False
    return world > 1 and bool(os.environ.get("MASTER_ADDR"))


def _backend(device) -> str:
    """nccl for a CUDA device (which must exist), gloo for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed(device='cuda'): no CUDA "
                               "device is available (pass device='cpu' for "
                               "a gloo world on the CPU)")
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"init_distributed: no backend for device {device!r}")


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device="cuda") -> None:
    """Start the torch.distributed process group.

    Explicit arguments initialize unconditionally (errors propagate: a
    mis-specified cluster must never silently fall back to one process):
    coordinator_address "host:port" becomes ``tcp://host:port`` (None reads
    MASTER_ADDR and MASTER_PORT from the environment), num_processes the
    world size and process_id this process's rank. With no arguments, a
    launcher environment (WORLD_SIZE > 1 with MASTER_ADDR, as torchrun sets
    it) initializes from the environment; a plain single process stays
    single. No-op if already initialized. The backend follows device: nccl
    for 'cuda' (the process then uses card LOCAL_RANK, else rank modulo the
    card count), gloo for 'cpu'."""
    if dist.is_initialized():
        return
    explicit = coordinator_address is not None or num_processes is not None
    if not (explicit or _launcher_environment()):
        return
    backend = _backend(device)
    if explicit:
        dist.init_process_group(
            backend,
            init_method=(f"tcp://{coordinator_address}"
                         if coordinator_address is not None else "env://"),
            world_size=num_processes if num_processes is not None else -1,
            rank=process_id if process_id is not None else -1)
    else:
        dist.init_process_group(backend, init_method="env://")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    log.info("torch.distributed initialized (%s): rank %d/%d", backend,
             dist.get_rank(), dist.get_world_size())


def rank_device(device) -> torch.device:
    """The card of this process: for a CUDA device in an initialized
    world, the one init_distributed made current (cuda:LOCAL_RANK), with
    its index, so that what is built on it stays there whatever device is
    current later; any other device as it is."""
    device = torch.device(device)
    if device.type == "cuda" and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def gather_image(image, mesh=None) -> np.ndarray:
    """The whole image as numpy, on every rank.

    Where the mesh (default: parallel.mesh.make_mesh() over the initialized
    world) has more than one rank, image is this rank's (H/dx, W/dy, ...)
    tile, and the tiles are all-gathered over the mesh's group and placed
    at their coordinates; otherwise image is the whole image and is copied
    to the host."""
    from openglraytracer_tpu_torch.parallel.mesh import make_mesh
    if mesh is None:
        mesh = make_mesh()
    if not isinstance(image, torch.Tensor):
        image = torch.as_tensor(np.asarray(image))
    image = image.detach()
    if mesh.group is None:
        return image.cpu().numpy()
    tile = image.contiguous()
    tiles = [torch.empty_like(tile) for _ in range(mesh.size)]
    dist.all_gather(tiles, tile, group=mesh.group)
    dx, dy = mesh.shape
    rows = [torch.cat(tiles[i * dy:(i + 1) * dy], dim=1) for i in range(dx)]
    return torch.cat(rows, dim=0).cpu().numpy()
