"""PyTorch port: CLI, image output, metrics, import hygiene and the rule
that a kernel wrapper never gives way to its plain version on a device."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from openglraytracer_tpu.utils import image as j_image
from openglraytracer_tpu.utils.metrics import rays_per_frame as j_rays
from openglraytracer_tpu_torch import cli, kernels
from openglraytracer_tpu_torch.models.builders import sphere_grid_scene
from openglraytracer_tpu_torch.ops.accel import suggest_cull_config
from openglraytracer_tpu_torch.ops.render import render
from openglraytracer_tpu_torch.utils import image as t_image
from openglraytracer_tpu_torch.utils import metrics as t_metrics

import _torch_helpers  # noqa: F401  (one torch thread per worker)

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    """The port and its CLI load without jax and without the JAX package.
    In a subprocess: this test process has jax loaded by conftest.py."""
    code = ("import sys, openglraytracer_tpu_torch, "
            "openglraytracer_tpu_torch.cli, openglraytracer_tpu_torch.kernels;"
            "import openglraytracer_tpu_torch.ops.render;"
            "import openglraytracer_tpu_torch.train.inverse;"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'openglraytracer_tpu.')) or "
            "m == 'openglraytracer_tpu');"
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernel_build_without_nvcc_names_the_tool(monkeypatch, tmp_path):
    """Asking for the kernels where there is no CUDA compiler raises an
    error naming it; it never hands back the plain versions."""
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed here")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()
    kernels.library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.library()
    kernels.library.cache_clear()


def test_wrappers_dispatch_by_device():
    """CPU tensors take the plain version; a device with neither a kernel
    nor a plain version raises."""
    assert kernels.on_cpu(torch.zeros(1))
    with pytest.raises(ValueError, match="no kernel"):
        kernels.on_cpu(torch.empty(1, device="meta"))


def test_kernel_argument_checks():
    x = torch.zeros((4, 3))
    kernels.check("x", x, x.device, torch.float32, (4, 3))
    with pytest.raises(TypeError, match="dtype"):
        kernels.check("x", x.double(), x.device, torch.float32, (4, 3))
    with pytest.raises(ValueError, match="shape"):
        kernels.check("x", x, x.device, torch.float32, (3, 4))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.check("x", x.T, x.device, torch.float32, (3, 4))


def test_render_rejects_unported_paths():
    scene, cam = sphere_grid_scene(2)
    spec = ((8, 8), 8, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render(scene, cam, 16, 16, engine="xla", cull=spec)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render(scene, cam, 16, 16, depth=1, cull=spec)
    with pytest.raises(ValueError, match="cull"):
        render(scene, cam, 16, 16)
    with pytest.raises(ValueError, match="must be on"):
        render(scene, cam, 16, 16, cull=spec, device="meta")


def test_cli_render_cpu_writes_png(tmp_path, capsys):
    """render --device cpu: the PNG holds the port's image, quantized and
    row-flipped exactly as the JAX package writes it."""
    from PIL import Image
    out = tmp_path / "c3.png"
    scene_json = tmp_path / "c3.json"
    cli.main(["render", "--scene", "c3_grid64", "--width", "64", "--height",
              "64", "--cull-tile", "16", "--device", "cpu", "--out",
              str(out), "--save-scene", str(scene_json)])
    printed = capsys.readouterr().out
    assert "cull: tile=16 kp=48 ks=64 hot_m=0" in printed
    png = np.asarray(Image.open(out).convert("RGB"))
    scene, cam = sphere_grid_scene(8)
    spec = suggest_cull_config(scene, cam, 64, 64, (16, 16))
    img = render(scene, cam, 64, 64, cull=spec)
    np.testing.assert_array_equal(png, j_image.to_uint8(img.numpy()))
    # the saved scene+camera renders the same image
    out2 = tmp_path / "again.png"
    cli.main(["render", "--scene", str(scene_json), "--width", "64",
              "--height", "64", "--cull-tile", "16", "--device", "cpu",
              "--out", str(out2)])
    assert out2.read_bytes() == out.read_bytes()


@pytest.mark.parametrize("flags", [
    ["--engine", "xla"], ["--engine", "auto"], ["--child-cull"],
    ["--bounce", "stack"], ["--depth", "1"], ["--cull-tile", "24"],
    ["--time"]])
def test_cli_rejects_unserved_flags(flags, tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["render", "--scene", "c1_sphere_plane", "--width", "32",
                  "--height", "32", "--cull-tile", "16", "--device", "cpu",
                  "--out", str(tmp_path / "x.png")] + flags)
    assert isinstance(e.value.code, str) and e.value.code


def test_cli_fit_cpu(tmp_path, capsys):
    """fit --device cpu: the synthetic sphere-grid fit through the plain
    versions; the loss falls and the fitted scene and its render are
    written."""
    out, scene_json = tmp_path / "fit.png", tmp_path / "fit.json"
    cli.main(["fit", "--device", "cpu", "--grid-side", "2", "--width", "32",
              "--height", "32", "--steps", "5", "--out", str(out),
              "--save-scene", str(scene_json)])
    printed = capsys.readouterr().out
    assert "cull: ((32, 32)," in printed
    line = next(x for x in printed.splitlines() if x.startswith("fit:"))
    first, final = (float(line.split(w)[1].split(",")[0])
                    for w in (" first ", " final "))
    assert "2 logged losses" in line and final < first
    assert out.stat().st_size > 0
    fitted = json.loads(scene_json.read_text())
    assert len(fitted["spheres"]["center"]) == 4 and "camera" in fitted


@pytest.mark.parametrize("flags", [
    ["--target", "t.png"], ["--scene", "s.json"], ["--soft", "0.3,0.3"],
    ["--sharded"], ["--checkpoint-dir", "ckpt"], ["--row-block", "8"],
    ["--engine", "xla"], ["--depth", "1"]])
def test_cli_fit_rejects_unported(flags):
    with pytest.raises(SystemExit) as e:
        cli.main(["fit", "--device", "cpu", "--grid-side", "2", "--width",
                  "32", "--height", "32", "--steps", "1"] + flags)
    assert isinstance(e.value.code, str) and "ROADMAP" in e.value.code


def test_cli_fit_checks_the_tile(tmp_path):
    with pytest.raises(SystemExit, match="must divide"):
        cli.main(["fit", "--device", "cpu", "--width", "48", "--height",
                  "48", "--cull-tile", "32"])


def test_cli_device_cuda_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["render", "--out", str(tmp_path / "x.png")])


def test_cli_configs(capsys):
    cli.main(["configs"])
    out = capsys.readouterr().out
    assert "c3_grid64" in out and "1024x1024 depth=0" in out


def test_image_helpers_match_jax():
    rgb = np.random.default_rng(2).random((9, 7, 3)).astype(np.float32) * 1.2
    np.testing.assert_array_equal(t_image.to_uint8(torch.from_numpy(rgb)),
                                  j_image.to_uint8(rgb))
    u8 = j_image.to_uint8(rgb)
    assert t_image.encode_png_py(u8) == j_image.encode_png_py(u8)
    with pytest.raises(ValueError, match="uint8"):
        t_image.encode_png_py(rgb)


def test_rays_per_frame_matches_jax():
    for args in [(1024, 1024, 2, 0), (64, 32, 3, 2)]:
        assert t_metrics.rays_per_frame(*args) == j_rays(*args)
    kw = dict(shadow_lights=(False, True, True), bounce_mask=(True, False))
    assert t_metrics.rays_per_frame(256, 256, 3, 1, **kw) == \
        j_rays(256, 256, 3, 1, **kw)
    assert t_metrics.rays_per_frame(1024, 1024, 2) == 3 * 1024 * 1024


def test_metrics_logger_and_timer(tmp_path, capsys):
    path = tmp_path / "m.jsonl"
    t_metrics.MetricsLogger("render", str(path)).log(sec=0.5)
    rec = json.loads(path.read_text())
    assert rec["name"] == "render" and rec["sec"] == 0.5
    assert json.loads(capsys.readouterr().err)["sec"] == 0.5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_metrics.time_fn(lambda: None)
