"""Primary camera ray generation.

Port of ``openglraytracer_tpu/ops/raygen.py``: NDC coords from integer pixel
ids, two clip-space points at z=0.5 and z=1.0 unprojected through
inverse(proj @ view) with w-divide, origin at the camera position, direction
normalize(end - start). Row 0 is the bottom of the image (GL convention).

Every op rounds as the JAX package's on the CPU (the camera inverse, the
pairwise unprojection sums, the fused |d|^2), so the rays are the
reference's bit for bit at the c3, c5 and OBB cameras.

The reference's integer division is kept: ``(pixel.x - width/2) /
(width/2)`` divides by the integer half width, so odd resolutions match.

The rays take ~217 launches on 1-16-element tensors and on the pixels,
which cost the host far more than the device. So on a CUDA camera that
autograd does not track, ``generate_rays`` replays them from one CUDA
graph per ray grid (``RayGraphs``): the camera's six tensors copied into
the graph's static camera in one launch, one graph launch, one clone of
its directions. The graph holds the same kernels in the same order, so
the rays are the eager ones bit for bit. A CPU camera, or one being
fitted, runs the eager ops (``_rays_eager``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from openglraytracer_tpu_torch.models.scene import Camera
from openglraytracer_tpu_torch.ops.transforms import _fma, camera_matrices
from openglraytracer_tpu_torch.utils.profiling import count


def pixel_ndc(height: int, width: int, dtype=torch.float32, device="cuda",
              rows: slice | None = None, cols: slice | None = None):
    """Per-pixel NDC xy coords, shape (H, W) each, on ``device`` (the GPU
    unless asked otherwise, as every builder of the port). rows and cols
    cut the pixel grid to a tile, of the same values: each pixel's coords
    depend on its own ids only."""
    half_w = width // 2
    half_h = height // 2
    r = range(height)[rows] if rows is not None else range(height)
    c = range(width)[cols] if cols is not None else range(width)
    px = torch.arange(c.start, c.stop, c.step, dtype=dtype, device=device)
    py = torch.arange(r.start, r.stop, r.step, dtype=dtype, device=device)
    x = (px - half_w) / half_w
    y = (py - half_h) / half_h
    shape = (len(r), len(c))
    return x[None, :].expand(shape), y[:, None].expand(shape)


def unproject(inv_vp, x, y, z: float):
    """inverse-viewproj @ (x, y, z, 1) with w-divide; x/y arbitrary shape.
    Each row's 4-term product is summed pairwise, (x m0 + y m1) + (z m2 +
    m3), every op rounded once: the JAX package's float32 matmul rounds so
    on the CPU, jitted or not."""
    xs, ys = x[..., None], y[..., None]
    world = ((xs * inv_vp[:, 0] + ys * inv_vp[:, 1])
             + (z * inv_vp[:, 2] + inv_vp[:, 3]))
    return world[..., :3] / world[..., 3:4]


def _rays_eager(cam: Camera, height: int, width: int,
                rows: slice | None = None, cols: slice | None = None):
    """generate_rays op by op."""
    _, _, inv_vp = camera_matrices(cam)
    x, y = pixel_ndc(height, width, dtype=cam.position.dtype,
                     device=cam.position.device, rows=rows, cols=cols)
    start = unproject(inv_vp, x, y, 0.5)
    end = unproject(inv_vp, x, y, 1.0)
    d = end - start
    # |d|^2 with fused multiply-adds and a correctly rounded sqrt, as the
    # JAX package's jnp.linalg.norm rounds on the CPU
    dx, dy, dz = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    n2 = _fma(dz, dz, _fma(dy, dy, dx * dx))
    d = d / torch.sqrt(n2.double()).to(d.dtype)
    origins = cam.position.expand(d.shape)
    return origins, d


def graph_key(cam: Camera, height: int, width: int,
              rows: slice | None = None, cols: slice | None = None):
    """What one graph of generate_rays is captured for: the device, the
    image, the tile's pixel ranges, and each camera tensor's dtype and
    shape (a copy into the static camera must not cast)."""
    r = range(height)[rows] if rows is not None else range(height)
    c = range(width)[cols] if cols is not None else range(width)
    return (cam.position.device, height, width, (r.start, r.stop, r.step),
            (c.start, c.stop, c.step), tuple((t.dtype, t.shape) for t in cam))


class _RayGraph:
    """One captured _rays_eager: the static camera it reads, the graph,
    and the directions it writes."""

    def __init__(self, cam: Camera, height: int, width: int, rows, cols):
        dev = cam.position.device
        with torch.cuda.device(dev), torch.inference_mode(False), \
                torch.no_grad():
            self.cam = Camera(*(t.detach().clone() for t in cam))
            # warm up on the capture's stream, as torch's graph notes ask
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                _rays_eager(self.cam, height, width, rows, cols)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side,
                                  capture_error_mode="thread_local"):
                self.dirs = _rays_eager(self.cam, height, width, rows,
                                        cols)[1]
            self.stream = torch.cuda.current_stream()

    def replay(self, cam: Camera):
        """The directions of cam, in a tensor of the caller's (the static
        output is overwritten by the next replay)."""
        stream = torch.cuda.current_stream(self.dirs.device)
        if stream != self.stream:
            stream.wait_stream(self.stream)
            self.stream = stream
        torch._foreach_copy_(list(self.cam), list(cam))   # one launch
        self.graph.replay()
        return self.dirs.clone()


class RayGraphs:
    """The captured graphs of generate_rays by graph_key, at most
    ``capacity``, the least recently used evicted first. One lock
    serialises capture and each copy-replay-clone, so that a caller on
    another thread (the viewer's producer) never overwrites a static
    camera before its replay; a caller on another stream waits for the
    last replay's clone."""

    def __init__(self, capacity: int = 8):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._graphs = OrderedDict()

    def keys(self) -> list:
        """The keys held, least recently used first."""
        with self._lock:
            return list(self._graphs)

    def dirs(self, cam: Camera, height: int, width: int,
             rows: slice | None = None, cols: slice | None = None):
        """generate_rays' directions from the key's graph, captured on its
        first use (a host sync: set-up, not a frame)."""
        key = graph_key(cam, height, width, rows, cols)
        with self._lock:
            graph = self._graphs.get(key)
            if graph is None:
                graph = _RayGraph(cam, height, width, rows, cols)
                self._graphs[key] = graph
                # the capture synchronised the device: no evicted graph's
                # replay is still running
                if len(self._graphs) > self.capacity:
                    self._graphs.popitem(last=False)
            else:
                self._graphs.move_to_end(key)
            return graph.replay(cam)


GRAPHS = RayGraphs()


def _graphable(cam: Camera) -> bool:
    """Whether a graph may stand in for the eager ops: every camera tensor
    on one CUDA device, none tracked by autograd, and no dispatch mode that
    sees each op (utils/profiling.cost_analysis)."""
    dev = cam.position.device
    if dev.type != "cuda" or any(t.device != dev for t in cam):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in cam):
        return False
    return _get_current_dispatch_mode() is None


def generate_rays(cam: Camera, height: int, width: int,
                  rows: slice | None = None, cols: slice | None = None):
    """Returns (origins (H,W,3), dirs (H,W,3)) world-space primary rays on
    the camera's device; with rows and cols, those of that tile of the
    image alone, equal bit for bit to the whole image's cut to it. On a
    CUDA camera that autograd does not track, dirs come from GRAPHS (a
    tensor of the caller's, bit for bit the eager ops'). Counters (while
    tracing): ``raygen_calls`` and ``raygen_graph_replays``."""
    graphed = _graphable(cam)
    count("raygen_calls", 1)
    count("raygen_graph_replays", int(graphed))
    if not graphed:
        return _rays_eager(cam, height, width, rows, cols)
    d = GRAPHS.dirs(cam, height, width, rows, cols)
    return cam.position.expand(d.shape), d
