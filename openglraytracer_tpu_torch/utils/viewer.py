"""Live viewer: the reference's real-time window as an HTTP MJPEG stream.

Port of ``openglraytracer_tpu/utils/viewer.py``. The reference's runtime is
a GLFW window redrawn every vsync with the wall clock as the scene's only
animation input. A GPU host is headless, so a producer thread renders
``reference_frame(wall_time)`` as fast as the card allows (or an
``fps_cap``, the vsync analog) and every connected browser shows the latest
frame through ``multipart/x-mixed-replace``.

Frames are JPEG at ``quality`` (85), encoded by the port's native codec
(native/imageio.cpp, utils/native_imageio.py) into the bytes PIL writes
for the reference. ctypes releases the interpreter lock during the
encode, so the pool's workers encode frames in parallel.

Endpoints:
  /           HTML page: the live stream and an FPS/stats readout
  /stream     MJPEG multipart stream of image/jpeg frames
  /frame.jpg  the latest frame; its X-Frame-Time header is the t it shows
  /stats      JSON {frame, fps, width, height, depth, engine, transport}

The producer is a depth-N pipeline: the dispatch loop enqueues a frame's
device work (scene build, render, and ``pack_yuv420_device`` or
``to_uint8_device``) and starts its device-to-host copy into pinned memory
without waiting; a pool of workers each waits for its frame's copy and
encodes it, while the card renders the next. Publishes are forced in
order, so consumers never see time run backwards. The fetch is one copy a
frame: the packed planes (or the uint8 frame), and on the culled engines
the overflow count appended (saturated at 255). A frame that overflowed
(objects dropped; it still shows) makes the dispatch loop resize the cull
spec from the current frame and carry on.
"""

from __future__ import annotations

import json
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from openglraytracer_tpu_torch.ops.render import CULLED

_BOUNDARY = "oglrtframe"


class FrameStreamer:
    """Producer thread: renders the animated reference world at wall time t
    on ``device`` and holds the latest JPEG for any number of consumers."""

    def __init__(self, height: int = 360, width: int = 640, depth: int = 0,
                 engine: str = "auto", cull_tile: int = 8,
                 fps_cap: float | None = None, max_frames: int | None = None,
                 start_time: float = 0.0, quality: int = 85,
                 pipeline_depth: int = 3, transport: str = "auto",
                 device="cuda"):
        self.height, self.width = height, width
        self.depth, self.engine = depth, engine
        # transport: what crosses to the host a frame.
        #   'rgb'    (H, W, 3) uint8, 3 bytes a pixel
        #   'yuv420' Y and 2x2-subsampled Cb, Cr, 1.5 bytes a pixel: what
        #            the 4:2:0 JPEG keeps anyway
        #   'auto'   'yuv420' when both sides are even, else 'rgb'
        even = height % 2 == 0 and width % 2 == 0
        if transport == "auto":
            transport = "yuv420" if even else "rgb"
        if transport not in ("rgb", "yuv420"):
            raise ValueError(f"transport {transport!r}: 'rgb', 'yuv420' or "
                             "'auto'")
        if transport == "yuv420" and not even:
            raise ValueError(f"transport 'yuv420' needs even frame sides, "
                             f"got {width}x{height}")
        self.transport = transport
        self.quality = quality
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FrameStreamer(device='cuda'): no CUDA "
                               "device is available (pass device='cpu')")
        self.cull_tile = cull_tile
        self.fps_cap = fps_cap
        self.max_frames = max_frames
        self.start_time = start_time
        self.pipeline_depth = max(1, pipeline_depth)
        self.frame_no = 0
        self.fps = 0.0
        self.encode_s = 0.0         # summed worker encode time, seconds
        self.rebuilds = 0
        self.error: BaseException | None = None
        self._jpeg: bytes | None = None
        self._t: float | None = None
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._cull = None
        self._next_pub = 0        # next sequence number to publish
        self._rebuild = False     # a worker saw cull overflow
        self._window: list[float] = []

    # -- producer ----------------------------------------------------------
    def _render_setup(self):
        from openglraytracer_tpu_torch.models.animated import reference_frame
        from openglraytracer_tpu_torch.ops.shading import (static_bounce_mask,
                                                           static_shadow_mask)
        s0, c0 = reference_frame(self.start_time, device=self.device)
        # light and material structure is the same at every t
        self._shadow_lights = static_shadow_mask(s0)
        self._bounce_mask = (static_bounce_mask(s0) if self.depth > 0
                             else (True, True))
        if self.engine in CULLED:
            from openglraytracer_tpu_torch.ops.accel import \
                suggest_cull_config
            t = self.cull_tile
            if self.height % t or self.width % t:
                raise ValueError(f"cull tile {t} must divide the frame "
                                 f"{self.width}x{self.height}")
            self._cull = suggest_cull_config(
                s0, c0, self.height, self.width, (t, t), headroom=2.0,
                shadow_lights=self._shadow_lights)

    def frame(self, t: float) -> torch.Tensor:
        """The flat uint8 frame of wall time t as it crosses to the host:
        pack_yuv420_device of the render on 'yuv420', to_uint8_device of it
        on 'rgb' (rows top-first), and on the culled engines one more byte,
        the frame's overflow count saturated at 255. Enqueues device work
        only."""
        from openglraytracer_tpu_torch.models.animated import reference_frame
        from openglraytracer_tpu_torch.ops.render import render
        from openglraytracer_tpu_torch.utils.image import (pack_yuv420_device,
                                                           to_uint8_device)
        scene, cam = reference_frame(t, device=self.device)
        with torch.no_grad():
            img, ovf = render(scene, cam, self.height, self.width,
                              depth=self.depth, engine=self.engine,
                              cull=self._cull,
                              shadow_lights=self._shadow_lights,
                              bounce_mask=self._bounce_mask,
                              with_cull_stats=True)
        out = (pack_yuv420_device(img) if self.transport == "yuv420"
               else to_uint8_device(img).reshape(-1))
        if self._cull is not None:
            out = torch.cat([out, torch.clamp(ovf, max=255)
                             .to(torch.uint8).reshape(1)])
        return out

    def _rebuild_cull(self, t: float):
        """The moving scene outgrew the cull lists: resize from the frame
        at t, its K's rounded up to multiples of 16 (so that a scene
        oscillating around a size does not resize every frame). Called from
        the dispatch loop with the pipeline drained. The overflowed frames
        still showed: only their overflowed tiles may drop objects."""
        from openglraytracer_tpu_torch.models.animated import reference_frame
        from openglraytracer_tpu_torch.ops.accel import suggest_cull_config
        scene, cam = reference_frame(t, device=self.device)
        cull = suggest_cull_config(scene, cam, self.height, self.width,
                                   self._cull[0], headroom=2.0,
                                   shadow_lights=self._shadow_lights)
        self._cull = (cull[0],) + tuple(
            -(-k // 16) * 16 if k else k for k in cull[1:])
        self.rebuilds += 1

    def _fetch(self, dev: torch.Tensor):
        """Start the frame's one device-to-host copy; returns (host buffer,
        the event to wait for, None on the CPU)."""
        if dev.device.type != "cuda":
            return dev, None
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def encode(self, buf) -> bytes:
        """The JPEG of a frame as frame() fetched it, without the overflow
        byte."""
        from openglraytracer_tpu_torch.utils.image import (_rgb_to_jpeg,
                                                           unpack_yuv420,
                                                           yuv420_to_jpeg)
        if self.transport == "yuv420":
            return yuv420_to_jpeg(*unpack_yuv420(buf, self.height,
                                                 self.width),
                                  quality=self.quality)
        return _rgb_to_jpeg(buf.reshape(self.height, self.width, 3),
                            quality=self.quality)

    def _finish(self, seq: int, t: float, host, done) -> None:
        """Worker: wait for the frame's copy, encode the JPEG (in parallel
        across workers), publish in sequence order."""
        try:
            if done is not None:
                done.synchronize()
            buf = host.numpy()
            if self._cull is not None:
                if buf[-1] > 0:
                    self._rebuild = True    # the dispatch loop resizes
                buf = buf[:-1]
            t0 = time.perf_counter()
            jpeg = self.encode(buf)
            enc = time.perf_counter() - t0
            with self._cond:
                self._cond.wait_for(
                    lambda: self._next_pub == seq or self._stop.is_set())
                if self._next_pub == seq:
                    now = time.monotonic()
                    w = self._window
                    w.append(now)
                    while w and now - w[0] > 2.0:
                        w.pop(0)
                    self._jpeg, self._t = jpeg, t
                    self.frame_no += 1
                    self.encode_s += enc
                    self._next_pub += 1
                    self.fps = len(w) / max(now - w[0], 1e-6) \
                        if len(w) > 1 else 0.0
                self._cond.notify_all()
        except BaseException as e:      # surfaced as .error, then re-raised
            self._fail(e)
            raise

    def _fail(self, e: BaseException) -> None:
        traceback.print_exc()
        self.error = e
        self._stop.set()
        with self._cond:
            self._cond.notify_all()

    def _loop(self):
        try:
            self._loop_inner()
        except BaseException as e:   # a producer thread dying silently
            self._fail(e)            # looks like a 0-FPS hang

    def _loop_inner(self):
        self._render_setup()
        t0 = time.monotonic()
        seq = 0
        futures: list = []
        with ThreadPoolExecutor(self.pipeline_depth) as pool:
            while not self._stop.is_set():
                if self.max_frames is not None and seq >= self.max_frames:
                    break
                if self._rebuild:
                    for f in futures:       # no frame of the old spec
                        f.result()          # in flight
                    futures.clear()
                    self._rebuild = False
                    self._rebuild_cull(self.start_time
                                       + (time.monotonic() - t0))
                # at most pipeline_depth frames in flight
                while len(futures) >= self.pipeline_depth:
                    futures.pop(0).result()
                tick = time.monotonic()
                t = self.start_time + (tick - t0)
                host, done = self._fetch(self.frame(t))
                futures.append(pool.submit(self._finish, seq, t, host, done))
                seq += 1
                if self.fps_cap:
                    budget = 1.0 / self.fps_cap - (time.monotonic() - tick)
                    if budget > 0:
                        time.sleep(budget)
            for f in futures:
                f.result()
        with self._cond:           # wake any /stream waiters so they exit
            self._cond.notify_all()

    # -- lifecycle / consumers --------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60.0)

    @property
    def done(self) -> bool:
        return self._stop.is_set() or (
            self.max_frames is not None and self.frame_no >= self.max_frames)

    def wait_frame(self, after: int, timeout: float = 60.0):
        """Block until frame_no > after (or the stream ends); return the
        latest (frame_no, jpeg)."""
        with self._cond:
            self._cond.wait_for(lambda: self.frame_no > after or self.done,
                                timeout=timeout)
            return self.frame_no, self._jpeg

    def latest(self):
        """(frame_no, jpeg, t) of the latest published frame, t the wall
        time it shows (None before the first)."""
        with self._cond:
            return self.frame_no, self._jpeg, self._t

    def stats(self) -> dict:
        return {"frame": self.frame_no, "fps": round(self.fps, 1),
                "width": self.width, "height": self.height,
                "depth": self.depth, "engine": self.engine,
                "transport": self.transport}


_PAGE = """<!doctype html>
<title>oglrt view</title>
<body style="margin:0;background:#111;color:#eee;font:14px monospace">
<div id="s" style="padding:4px"></div>
<img src="/stream" style="image-rendering:pixelated">
<script>
setInterval(async () => {
  const r = await fetch('/stats'); const j = await r.json();
  document.getElementById('s').textContent =
    `frame ${j.frame}  ${j.fps} FPS  ${j.width}x${j.height}` +
    `  depth=${j.depth}  engine=${j.engine}`;
}, 500);
</script>
"""


def _make_handler(streamer: FrameStreamer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, ctype: str, body: bytes, headers=()):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                if self.path == "/":
                    self._send("text/html", _PAGE.encode())
                elif self.path == "/stats":
                    self._send("application/json",
                               json.dumps(streamer.stats()).encode())
                elif self.path == "/frame.jpg":
                    streamer.wait_frame(0)
                    _, jpeg, t = streamer.latest()
                    if jpeg is None:
                        self.send_error(503, "no frame yet")
                        return
                    self._send("image/jpeg", jpeg,
                               [("X-Frame-Time", repr(t))])
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        f"multipart/x-mixed-replace; boundary={_BOUNDARY}")
                    self.end_headers()
                    seen = 0
                    while True:
                        n, jpeg = streamer.wait_frame(seen)
                        if jpeg is None or (n == seen and streamer.done):
                            break
                        seen = n
                        self.wfile.write(
                            f"--{_BOUNDARY}\r\nContent-Type: image/jpeg\r\n"
                            f"Content-Length: {len(jpeg)}\r\n\r\n".encode())
                        self.wfile.write(jpeg)
                        self.wfile.write(b"\r\n")
                        if streamer.done:
                            break
                else:
                    self.send_error(404)
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client went away

    return Handler


def serve(streamer: FrameStreamer, port: int = 0,
          host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Start the HTTP server (not the render loop) on the given port
    (0 = ephemeral); returns the server — run serve_forever() yourself or in
    a thread. ``server.server_address[1]`` is the bound port."""
    server = ThreadingHTTPServer((host, port), _make_handler(streamer))
    server.daemon_threads = True
    return server


def run_viewer(height: int, width: int, depth: int = 0, engine: str = "auto",
               cull_tile: int = 8, port: int = 8000,
               fps_cap: float | None = None,
               max_frames: int | None = None, start_time: float = 0.0,
               device="cuda"):
    """The blocking CLI entry: render loop and HTTP server until Ctrl-C
    (or max_frames). Prints an FPS readout once a second."""
    streamer = FrameStreamer(height, width, depth, engine, cull_tile,
                             fps_cap, max_frames, start_time,
                             device=device).start()
    server = serve(streamer, port)
    bound = server.server_address[1]
    print(f"oglrt view: http://localhost:{bound}/  "
          f"({width}x{height}, depth={depth}, engine={engine})", flush=True)
    srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
    srv_thread.start()
    try:
        last = -1
        while not streamer.done:
            time.sleep(1.0)
            if streamer.frame_no != last:
                last = streamer.frame_no
                print(f"frame {streamer.frame_no}  {streamer.fps:.1f} FPS",
                      flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        streamer.stop()
        server.shutdown()
        server.server_close()
    if streamer.error is not None:
        raise RuntimeError("the viewer's producer failed") \
            from streamer.error
    return streamer
