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
from openglraytracer_tpu_torch.models.builders import (eight_sphere_scene,
                                                      sphere_grid_scene)
from openglraytracer_tpu_torch.ops.accel import (suggest_cull_config,
                                                 suggest_stack_cull_config)
from openglraytracer_tpu_torch.ops.render import render
from openglraytracer_tpu_torch.utils import image as t_image
from openglraytracer_tpu_torch.utils import metrics as t_metrics

import _torch_helpers  # noqa: F401  (one torch thread per worker)

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    """Every module of the port (pkgutil.walk_packages over the package)
    loads without jax and without the JAX package; and chip_smoke.py
    imports neither (an ast walk of its import statements). In a
    subprocess: this test process has jax loaded by conftest.py."""
    import ast
    code = ("import sys, pkgutil, importlib, openglraytracer_tpu_torch as p;"
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "p.__name__ + '.')];"
            "[importlib.import_module(n) for n in names];"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'openglraytracer_tpu.')) or "
            "m == 'openglraytracer_tpu');"
            "print(len(names), bad); sys.exit(1 if bad or len(names) < 30 "
            "else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    imported = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
    imported += [n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module]
    assert imported and not [m for m in imported if m == "jax" or m.startswith(
        ("jax.", "openglraytracer_tpu.")) or m == "openglraytracer_tpu"], \
        imported


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
    """An engine the package does not know raises; the culled engines
    need a cull spec and take no row blocks; row blocks must divide the
    height."""
    scene, cam = sphere_grid_scene(2, device="cpu")
    spec = ((8, 8), 8, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        render(scene, cam, 16, 16, engine="soft", cull=spec)
    for engine in ("culled", "culled_pallas"):
        with pytest.raises(ValueError, match="cull"):
            render(scene, cam, 16, 16, engine=engine)
    with pytest.raises(ValueError, match="row_block"):
        render(scene, cam, 16, 16, engine="culled", cull=spec, row_block=8)
    with pytest.raises(ValueError, match="row_block"):
        render(scene, cam, 16, 16, engine="culled_pallas", cull=spec,
               row_block=8)
    with pytest.raises(ValueError, match="divide"):
        render(scene, cam, 16, 16, row_block=6)
    with pytest.raises(ValueError, match="must be on"):
        render(scene, cam, 16, 16, cull=spec, device="meta")


def test_render_defaults_to_the_plain_dense_engine(monkeypatch):
    """render(scene, cam, h, w) names no engine and renders through engine
    'xla' ('auto'), the reference's default: one call of the plain dense
    geometry, no kernel launch, the same image as engine='xla'."""
    from openglraytracer_tpu_torch.ops import dense
    calls = []
    real = dense.xla_geometry
    monkeypatch.setattr(dense, "xla_geometry", lambda *a: (
        calls.append(1), real(*a))[1])
    scene, cam = sphere_grid_scene(2, device="cpu")
    kernels.LAUNCHES.clear()
    img = render(scene, cam, 16, 16)
    assert calls == [1] and sum(kernels.LAUNCHES.values()) == 0
    assert torch.equal(img, render(scene, cam, 16, 16, engine="xla"))


def test_cli_render_cpu_writes_png(tmp_path, capsys):
    """render --device cpu: the PNG holds the port's image, quantized and
    row-flipped exactly as the JAX package writes it."""
    from PIL import Image
    out = tmp_path / "c3.png"
    scene_json = tmp_path / "c3.json"
    cli.main(["render", "--scene", "c3_grid64", "--width", "64", "--height",
              "64", "--engine", "culled_pallas", "--cull-tile", "16",
              "--device", "cpu", "--out", str(out), "--save-scene",
              str(scene_json)])
    printed = capsys.readouterr().out
    assert "cull: tile=16 kp=48 ks=64 hot_m=0" in printed
    png = np.asarray(Image.open(out).convert("RGB"))
    scene, cam = sphere_grid_scene(8, device="cpu")
    spec = suggest_cull_config(scene, cam, 64, 64, (16, 16))
    img = render(scene, cam, 64, 64, engine="culled_pallas", cull=spec)
    np.testing.assert_array_equal(png, j_image.to_uint8(img.numpy()))
    # the saved scene+camera renders the same image
    out2 = tmp_path / "again.png"
    cli.main(["render", "--scene", str(scene_json), "--width", "64",
              "--height", "64", "--engine", "culled_pallas", "--cull-tile",
              "16", "--device", "cpu", "--out", str(out2)])
    assert out2.read_bytes() == out.read_bytes()


@pytest.mark.parametrize("flags", [
    ["--child-cull"], ["--engine", "autodiff", "--bounce", "stack"],
    ["--engine", "culled_pallas", "--cull-tile", "24"], ["--time"],
    ["--engine", "pallas", "--child-cull"],
    ["--engine", "culled", "--row-block", "8"]])
def test_cli_rejects_unserved_flags(flags, tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["render", "--scene", "c1_sphere_plane", "--width", "32",
                  "--height", "32", "--cull-tile", "16", "--device", "cpu",
                  "--out", str(tmp_path / "x.png")] + flags)
    assert isinstance(e.value.code, str) and e.value.code


def test_cli_render_stack_cpu(tmp_path, capsys):
    """render --bounce stack --depth 2: the PNG holds the image of
    render(..., bounce='stack'); on culled_pallas the stack spec is sized
    and printed, and the image is that spec's render."""
    from PIL import Image
    out = tmp_path / "s.png"
    cli.main(["render", "--scene", "c2_eight_spheres", "--width", "32",
              "--height", "32", "--depth", "2", "--bounce", "stack",
              "--device", "cpu", "--out", str(out)])
    scene, cam = eight_sphere_scene(device="cpu")
    with torch.no_grad():
        img = render(scene, cam, 32, 32, depth=2, bounce="stack")
    png = np.asarray(Image.open(out).convert("RGB"))
    np.testing.assert_array_equal(png, j_image.to_uint8(img.numpy()))
    capsys.readouterr()
    cli.main(["render", "--scene", "c2_eight_spheres", "--width", "32",
              "--height", "32", "--depth", "2", "--bounce", "stack",
              "--engine", "culled_pallas", "--cull-tile", "16", "--device",
              "cpu", "--out", str(out)])
    assert "stack cull: tile=16 " in capsys.readouterr().out
    spec = suggest_stack_cull_config(scene, cam, 32, 32, (16, 16))
    with torch.no_grad():
        img = render(scene, cam, 32, 32, depth=2, bounce="stack",
                     engine="culled_pallas", cull=spec)
    png = np.asarray(Image.open(out).convert("RGB"))
    np.testing.assert_array_equal(png, j_image.to_uint8(img.numpy()))


@pytest.mark.parametrize("engine,depth,bounce", [
    ("pallas", 0, "tree"), ("pallas", 1, "tree"), ("xla", 2, "stack"),
    ("pallas", 4, "stack")])
def test_cli_time_charges_the_reference_rays(monkeypatch, tmp_path, capsys,
                                             engine, depth, bounce):
    """render --time logs the Mrays/s of the reference CLI's count for
    every engine (openglraytracer_tpu/cli.py:125-135): the static
    shadow-casting lights and, at depth > 0, the static bounce mask. On the
    OBB world, whose first light is ambient only, 3 rays a cast on
    --engine pallas too, not the 4 kernel 7 casts. The CUDA timer is
    replaced by one that reports 1 microsecond a frame."""
    from openglraytracer_tpu.models.animated import reference_frame as jref
    from openglraytracer_tpu.ops.shading import (static_bounce_mask,
                                                 static_shadow_mask)
    from openglraytracer_tpu_torch.models.animated import reference_frame
    from openglraytracer_tpu_torch.models.scene import save_scene
    monkeypatch.setattr(cli, "_check_timing", lambda device: None)
    monkeypatch.setattr(t_metrics, "time_fn", lambda fn: (fn(), 1e-6)[1])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "cpu")
    scene, cam = reference_frame(1.2, device="cpu")
    save_scene(scene, str(tmp_path / "obb.json"), camera=cam)
    capsys.readouterr()
    cli.main(["render", "--scene", str(tmp_path / "obb.json"), "--width",
              "16", "--height", "8", "--engine", engine, "--depth",
              str(depth), "--bounce", bounce, "--time", "--device", "cpu",
              "--out", str(tmp_path / "o.png")])
    record = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    jscene, _ = jref(1.2)
    want = j_rays(8, 16, jscene.lights.count, depth,
                  shadow_lights=static_shadow_mask(jscene),
                  bounce_mask=(static_bounce_mask(jscene) if depth > 0
                               else None))
    assert want == 8 * 16 * (2 ** (depth + 1) - 1) * 3
    assert record["mrays_per_s"] == round(want / 1e-6 / 1e6, 2)


def test_cli_fit_cpu(tmp_path, capsys):
    """fit --device cpu: the synthetic sphere-grid fit through the plain
    versions; the loss falls and the fitted scene and its render are
    written."""
    out, scene_json = tmp_path / "fit.png", tmp_path / "fit.json"
    cli.main(["fit", "--engine", "culled_pallas", "--device", "cpu",
              "--grid-side", "2", "--width", "32", "--height", "32",
              "--steps", "5", "--out", str(out), "--save-scene",
              str(scene_json)])
    printed = capsys.readouterr().out
    assert "cull: ((32, 32)," in printed
    line = next(x for x in printed.splitlines() if x.startswith("fit:"))
    first, final = (float(line.split(w)[1].split(",")[0])
                    for w in (" first ", " final "))
    assert "2 logged losses" in line and final < first
    assert out.stat().st_size > 0
    fitted = json.loads(scene_json.read_text())
    assert len(fitted["spheres"]["center"]) == 4 and "camera" in fitted


@pytest.mark.parametrize("flags,message", [
    (["--target", "t.png"], "needs --scene init.json"),
    (["--scene", "s.json"], "pass --target too"),
    (["--sharded", "--row-block", "8"], "not used by --sharded")])
def test_cli_fit_rejects_unported(flags, message):
    """The fit's flag checks: a PNG target needs its initial scene JSON,
    --scene belongs to a --target fit, and the sharded fit renders tiles,
    not row blocks."""
    with pytest.raises(SystemExit) as e:
        cli.main(["fit", "--device", "cpu", "--grid-side", "2", "--width",
                  "32", "--height", "32", "--steps", "1"] + flags)
    assert isinstance(e.value.code, str) and message in e.value.code


def test_cli_fit_sharded_builds_on_rank_card(monkeypatch):
    """fit --sharded under a launcher's 2-rank CUDA environment (the
    process group and the cards stubbed): the world is started first, and
    the scene and target are built on this rank's card, cuda:LOCAL_RANK,
    not on the bare 'cuda' (card 0 in every process)."""
    import torch.distributed as dist
    from openglraytracer_tpu_torch.models import builders
    for k, v in (("WORLD_SIZE", "2"), ("RANK", "1"), ("LOCAL_RANK", "1"),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    state = {"up": False, "card": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: state.update(card=i))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["card"])
    monkeypatch.setattr(dist, "is_initialized", lambda: state["up"])
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: state.update(up=True, args=a))
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)

    def built(side, seed=0, device="cuda", **kw):
        state["built_on"] = torch.device(device)
        raise SystemExit("built")
    monkeypatch.setattr(builders, "sphere_grid_scene", built)
    with pytest.raises(SystemExit, match="built"):
        cli.main(["fit", "--sharded", "--grid-side", "2", "--width", "32",
                  "--height", "32", "--steps", "1"])
    assert state["args"] == ("nccl",) and state["card"] == 1
    assert state["built_on"] == torch.device("cuda", 1)


@pytest.mark.parametrize("flags", [
    ["--soft", "0.3,0.3"], ["--checkpoint-dir", "ckpt"],
    ["--engine", "culled", "--checkpoint-dir", "ckpt"]])
def test_cli_fit_soft_and_checkpoints(tmp_path, capsys, flags):
    """fit --soft BW,GAMMA sizes and prints the soft spec and fits the soft
    forward against a soft target; --checkpoint-dir saves at step 100 (the
    reference's checkpoint_every) and a second run resumes there and runs
    only the steps after it."""
    flags = [str(tmp_path / f) if f == "ckpt" else f for f in flags]
    base = ["fit", "--device", "cpu", "--grid-side", "2", "--width", "16",
            "--height", "16", "--cull-tile", "16"]
    steps = "5" if "--soft" in flags else "100"
    cli.main(base + ["--steps", steps] + flags)
    printed = capsys.readouterr().out
    line = next(x for x in printed.splitlines() if x.startswith("fit:"))
    first, final = (float(line.split(w)[1].split(",")[0])
                    for w in (" first ", " final "))
    assert final < first
    if "--soft" in flags:
        assert "soft cull: ((16, 16), 4)" in printed
        return
    ckpt = tmp_path / "ckpt"
    assert [p.name for p in ckpt.iterdir()] == ["ckpt_000000100.pt"]
    cli.main(base + ["--steps", "103"] + flags)
    records = [json.loads(x) for x in capsys.readouterr().err.splitlines()
               if x.startswith('{"name": "fit"')]
    assert [r["step"] for r in records] == [100, 102]


@pytest.mark.parametrize("flags,message", [
    (["--soft", "0.3"], "BW,GAMMA"),
    (["--soft", "0.3,0.3", "--engine", "culled"], "drop --engine"),
    (["--soft", "0.3,0.3", "--sharded"], "unsharded"),
    (["--soft", "0.3,0.3", "--cull-tile", "24"], "must divide")])
def test_cli_fit_soft_checks(flags, message):
    with pytest.raises(SystemExit, match=message):
        cli.main(["fit", "--device", "cpu", "--grid-side", "2", "--width",
                  "32", "--height", "32", "--steps", "1"] + flags)


def test_cli_fit_checks_the_tile(tmp_path):
    with pytest.raises(SystemExit, match="must divide"):
        cli.main(["fit", "--engine", "culled_pallas", "--device", "cpu",
                  "--width", "48", "--height", "48", "--cull-tile", "32"])


def test_cli_render_pallas_cpu(tmp_path, capsys):
    """render --engine pallas: the dense engine needs no cull spec; the PNG
    holds the port's image."""
    from PIL import Image
    out = tmp_path / "c3p.png"
    cli.main(["render", "--scene", "c3_grid64", "--engine", "pallas",
              "--width", "48", "--height", "32", "--device", "cpu", "--out",
              str(out)])
    assert "cull:" not in capsys.readouterr().out
    png = np.asarray(Image.open(out).convert("RGB"))
    scene, cam = sphere_grid_scene(8, device="cpu")
    img = render(scene, cam, 32, 48, engine="pallas")
    np.testing.assert_array_equal(png, j_image.to_uint8(img.numpy()))


def test_cli_animate_cpu(tmp_path, capsys):
    """animate: a PNG per frame of the reference's animated world, at
    start_time + i / fps, depth 1 through the dense engine; the frames
    move."""
    from PIL import Image
    pattern = str(tmp_path / "frame_{:02d}.png")
    cli.main(["animate", "--frames", "2", "--fps", "4", "--width", "32",
              "--height", "18", "--depth", "1", "--device", "cpu",
              "--out-pattern", pattern])
    printed = capsys.readouterr().out
    assert "frame 1: t=0.250s" in printed
    frames = [np.asarray(Image.open(pattern.format(i)).convert("RGB"))
              for i in range(2)]
    assert frames[0].shape == (18, 32, 3)
    assert (frames[0] != frames[1]).any()


@pytest.mark.parametrize("flags", [
    ["--gif", "x.gif"], ["--engine", "culled", "--gif", "x.gif"]])
def test_cli_animate_rejects_unported(flags, tmp_path, monkeypatch, capsys):
    """--gif, once rejected here, is ported: with the default and a culled
    engine, animate now writes the GIF beside the PNG frames."""
    from PIL import Image
    monkeypatch.chdir(tmp_path)
    cli.main(["animate", "--frames", "1", "--width", "32", "--height",
              "16", "--device", "cpu", "--out-pattern",
              str(tmp_path / "f{}.png")] + flags)
    assert "wrote x.gif (1 frames @ 30 fps)" in capsys.readouterr().out
    im = Image.open(tmp_path / "x.gif")
    assert (im.n_frames, im.size, im.info["duration"], im.info["loop"]) == \
        (1, (32, 16), 30, 0)


def test_cli_animate_gif_matches_jax_cli(tmp_path, capsys):
    """animate --gif against the JAX package's CLI with the same flags (3
    frames at 640x360, the default size, as PIL reads the files): the same
    frame count, per-frame duration (int(1000 / fps) ms, stored in
    hundredths) and loop; each frame within the reference GIF's mean
    absolute error against its PNG frame plus 1.0 code value."""
    from PIL import Image

    from openglraytracer_tpu import cli as j_cli
    base = ["animate", "--frames", "3", "--fps", "24", "--start-time", "0.5"]
    cli.main(base + ["--device", "cpu", "--out-pattern",
                     str(tmp_path / "t{}.png"), "--gif",
                     str(tmp_path / "t.gif")])
    j_cli.main(base + ["--out-pattern", str(tmp_path / "j{}.png"), "--gif",
                       str(tmp_path / "j.gif")])
    read = {}
    for side in "tj":
        im = Image.open(tmp_path / f"{side}.gif")
        frames, durations = [], []
        for i in range(im.n_frames):
            im.seek(i)
            frames.append(np.asarray(im.convert("RGB"), np.int16))
            durations.append(im.info["duration"])
        read[side] = (im.n_frames, im.size, durations, im.info["loop"],
                      frames)
    assert read["t"][:4] == read["j"][:4] == (3, (640, 360), [40] * 3, 0)
    for i in range(3):
        errs = [np.abs(read[side][4][i] - _png(tmp_path / f"{side}{i}.png"))
                .mean() for side in "tj"]
        assert errs[0] <= errs[1] + 1.0, errs


def _png(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"), np.int16)


# flags that exited before the plain dense engine was ported: each now runs
# and writes what the JAX package's CLI writes
RUNS = {
    "render": [["--engine", "xla"], ["--engine", "auto"], ["--depth", "1"]],
    "fit": [["--engine", "xla"], ["--depth", "1"], ["--row-block", "8"]],
    "animate": [["--engine", "xla"],
                ["--engine", "culled_pallas", "--depth", "1", "--cull-tile",
                 "16"]],
}


@pytest.mark.parametrize("cmd,flags", [(c, f) for c, fs in RUNS.items()
                                       for f in fs])
def test_cli_runs_the_dense_engine_flags(cmd, flags, tmp_path, capsys):
    """Each flag runs, and its PNG is within one 8-bit level of the JAX
    package's: render and animate against the JAX package's CLI run with
    the same flags; fit (whose start is perturbed by another generator)
    against the JAX package's render of the fitted scene the port saved,
    since the fit writes its output with the default engine. One level:
    the JAX package renders under jit, where XLA contracts multiply-adds
    into fused ones (tests/test_torch_xla_render.py)."""
    from openglraytracer_tpu import cli as j_cli
    out, ref = tmp_path / "t.png", tmp_path / "j.png"
    if cmd == "render":
        base = ["render", "--scene", "c1_sphere_plane", "--width", "32",
                "--height", "32"]
        cli.main(base + ["--device", "cpu", "--out", str(out)] + flags)
        j_cli.main(base + ["--out", str(ref)] + flags)
    elif cmd == "animate":
        base = ["animate", "--frames", "1", "--width", "32", "--height",
                "16", "--start-time", "0.7"]
        cli.main(base + ["--device", "cpu", "--out-pattern",
                         str(tmp_path / "t{}.png")] + flags)
        j_cli.main(base + ["--out-pattern", str(tmp_path / "j{}.png")]
                   + flags)
        out, ref = tmp_path / "t0.png", tmp_path / "j0.png"
    else:
        from openglraytracer_tpu.models.scene import load_scene_camera
        from openglraytracer_tpu.ops.render import render as j_render
        scene_json = tmp_path / "fit.json"
        cli.main(["fit", "--device", "cpu", "--grid-side", "2", "--width",
                  "32", "--height", "32", "--steps", "3", "--out", str(out),
                  "--save-scene", str(scene_json)] + flags)
        line = next(x for x in capsys.readouterr().out.splitlines()
                    if x.startswith("fit:"))
        first, final = (float(line.split(w)[1].split(",")[0])
                        for w in (" first ", " final "))
        assert final < first
        depth = int(flags[1]) if flags[0] == "--depth" else 0
        scene, cam = load_scene_camera(str(scene_json))
        j_image.save_png(j_render(scene, cam, 32, 32, depth=depth), str(ref))
    a, b = _png(out), _png(ref)
    assert a.shape == b.shape and int(np.abs(a - b).max()) <= 1


def test_cli_animate_culled_cpu(tmp_path, capsys):
    """animate --engine culled_pallas at depth 0: one cull spec, rechecked
    per frame."""
    pattern = str(tmp_path / "c{}.png")
    cli.main(["animate", "--frames", "2", "--width", "32", "--height",
              "16", "--engine", "culled_pallas", "--device", "cpu",
              "--out-pattern", pattern])
    assert "cull: tile=8" in capsys.readouterr().out
    assert (tmp_path / "c1.png").stat().st_size > 0


def test_cli_fit_pallas_cpu(capsys):
    """fit --engine pallas: the synthetic fit through the dense engine, at
    depth 1 (no child spec needed); the loss falls."""
    cli.main(["fit", "--engine", "pallas", "--device", "cpu",
              "--grid-side", "2", "--width", "32", "--height", "32",
              "--depth", "1", "--steps", "5"])
    printed = capsys.readouterr().out
    assert "cull:" not in printed
    line = next(x for x in printed.splitlines() if x.startswith("fit:"))
    first, final = (float(line.split(w)[1].split(",")[0])
                    for w in (" first ", " final "))
    assert final < first


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
