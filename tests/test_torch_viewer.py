"""PyTorch port: the live viewer (utils/viewer.py), the four cases of
tests/test_viewer.py on the reference's JPEG frames, on the CPU at tiny
sizes: the stream end to end (every endpoint; /frame.jpg is byte for byte
the reference's yuv420_to_jpeg, through PIL, of the planes of the render
of the t it names), the pipelined producer's in-order publishes, the FPS
cap, and a culled engine with the overflow count packed beside the frame;
and frames with an odd side, which fall back to the 'rgb' transport."""

import json
import threading
import time
import urllib.error
import urllib.request

import io

import numpy as np
import pytest
import torch
from PIL import Image

from openglraytracer_tpu.utils import image as j_image
from openglraytracer_tpu_torch.models.animated import reference_frame
from openglraytracer_tpu_torch.ops.render import render
from openglraytracer_tpu_torch.utils.image import (pack_yuv420_device,
                                                   to_uint8, unpack_yuv420)
from openglraytracer_tpu_torch.utils.viewer import (_BOUNDARY, FrameStreamer,
                                                    serve)

import _torch_helpers  # noqa: F401  (one torch thread per worker)

JPEG_SOI = b"\xff\xd8"


def _decode(jpeg: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB"))


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.status, r.headers, r.read()


def test_viewer_stream_end_to_end():
    streamer = FrameStreamer(height=24, width=32, depth=0, engine="xla",
                             max_frames=3, device="cpu").start()
    server = serve(streamer, port=0, host="127.0.0.1")
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        status, headers, body = _get(port, "/frame.jpg")
        assert status == 200 and headers["Content-Type"] == "image/jpeg"
        assert body[:2] == JPEG_SOI
        ft = float(headers["X-Frame-Time"])
        scene, cam = reference_frame(ft, device="cpu")
        with torch.no_grad():
            img = render(scene, cam, 24, 32, engine="xla")
        planes = unpack_yuv420(pack_yuv420_device(img), 24, 32)
        assert body == j_image.yuv420_to_jpeg(*planes, quality=85)
        assert _decode(body).shape == (24, 32, 3)
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/frame.png")        # the reference has no PNG frame
        assert e.value.code == 404

        status, _, body = _get(port, "/stats")
        stats = json.loads(body)
        assert (stats["width"], stats["height"]) == (32, 24)
        assert stats["frame"] >= 1 and stats["transport"] == "yuv420"

        req = urllib.request.urlopen(f"http://127.0.0.1:{port}/stream",
                                     timeout=60)
        assert _BOUNDARY in req.headers["Content-Type"]
        chunk = req.read()  # the stream ends after max_frames
        assert f"--{_BOUNDARY}".encode() in chunk
        assert b"Content-Type: image/jpeg" in chunk and JPEG_SOI in chunk

        status, headers, body = _get(port, "/")
        assert status == 200 and b"/stream" in body
    finally:
        streamer.stop()
        server.shutdown()
        server.server_close()
    assert streamer.error is None and streamer.frame_no == 3


def test_pipelined_producer_publishes_all_frames_in_order():
    """The depth-N pipeline: concurrent encode workers publish every frame
    exactly once, in order, and stop cleanly."""
    seen = []
    streamer = FrameStreamer(height=16, width=16, depth=0, engine="xla",
                             max_frames=8, pipeline_depth=3, device="cpu")
    streamer.start()
    last = 0
    while not streamer.done:
        n, jpeg = streamer.wait_frame(last, timeout=60)
        if n > last:
            assert jpeg[:2] == JPEG_SOI
            seen.append(n)
            last = n
    streamer.stop()
    assert streamer.error is None
    assert streamer.frame_no == 8
    assert seen == sorted(seen), "publishes must be in order"


def test_pipelined_producer_respects_fps_cap():
    streamer = FrameStreamer(height=16, width=16, depth=0, engine="xla",
                             max_frames=6, pipeline_depth=2, fps_cap=30.0,
                             device="cpu")
    t0 = time.monotonic()
    streamer.start()
    streamer.wait_frame(5, timeout=60)
    streamer.stop()
    assert streamer.error is None
    assert streamer.frame_no == 6
    # 6 frames at <= 30 FPS: at least 5 inter-frame gaps of 1/30 s
    assert time.monotonic() - t0 >= 5 / 30.0


def test_culled_viewer_with_packed_overflow_flag(monkeypatch):
    """A culled engine rides the overflow count in the frame's one fetch,
    on both transports: frames still come, a frame that overflowed makes
    the dispatch loop resize the spec from the current frame; 'yuv420' on
    an odd side is refused."""
    from openglraytracer_tpu_torch.ops import accel
    with pytest.raises(ValueError, match="yuv420"):
        FrameStreamer(height=16, width=15, transport="yuv420", device="cpu")
    real, specs = accel.suggest_cull_config, []

    def first_too_small(*args, **kwargs):
        # one survivor a list overflows the OBB world's tiles
        spec = ((8, 8), 1, 1, 0, 1, 1) if not specs else real(*args,
                                                               **kwargs)
        specs.append(spec)
        return spec
    monkeypatch.setattr(accel, "suggest_cull_config", first_too_small)
    streamer = FrameStreamer(height=16, width=16, depth=0, engine="culled",
                             cull_tile=8, max_frames=4, pipeline_depth=2,
                             transport="rgb", device="cpu")
    streamer.start()
    n, jpeg = streamer.wait_frame(0, timeout=120)
    while not streamer.done:
        n, jpeg = streamer.wait_frame(n, timeout=120)
    streamer.stop()
    assert streamer.error is None
    assert streamer.frame_no == 4
    assert jpeg[:2] == JPEG_SOI and _decode(jpeg).shape == (16, 16, 3)
    assert streamer.rebuilds >= 1 and streamer._cull[1] >= 16
    frame = streamer.frame(0.5)
    assert frame.dtype == torch.uint8 and frame.shape == (16 * 16 * 3 + 1,)
    assert int(frame[-1]) == 0
    good = streamer._cull
    streamer._cull = specs[0]
    assert int(streamer.frame(0.5)[-1]) > 0
    # the 'yuv420' transport packs the byte after the planes
    streamer.transport, streamer._cull = "yuv420", good
    frame = streamer.frame(0.5)
    assert frame.shape == (16 * 16 * 3 // 2 + 1,) and int(frame[-1]) == 0
    assert streamer.encode(frame[:-1].numpy())[:2] == JPEG_SOI


def test_viewer_odd_sides_fall_back_to_rgb():
    """'auto' with an odd side takes the 'rgb' transport, as the
    reference's does: the JPEG is PIL's of to_uint8 of the render."""
    streamer = FrameStreamer(height=15, width=22, depth=0, engine="xla",
                             max_frames=2, device="cpu")
    assert streamer.transport == "rgb"
    assert FrameStreamer(height=16, width=22, device="cpu").transport == \
        "yuv420"
    streamer.start()
    streamer.wait_frame(1, timeout=60)
    streamer.stop()
    assert streamer.error is None and streamer.frame_no == 2
    _, jpeg, t = streamer.latest()
    scene, cam = reference_frame(t, device="cpu")
    with torch.no_grad():
        rgb8 = to_uint8(render(scene, cam, 15, 22, engine="xla"))
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgb8)).save(buf, "JPEG", quality=85)
    assert jpeg == buf.getvalue()
    assert streamer.stats()["transport"] == "rgb"
