"""PyTorch port: the host surface against the JAX package's. Scene files
both ways (exact), the external-target CLI fit (fitted parameters to 1e-4),
the NumPy oracle (equal to the reference's, float64, exactly), the port's
renders against its oracle at tests/test_render_golden.py's tolerances,
the NaN-checked render (clean where the reference's is, and flagging a NaN
radius as it does), assert_finite_tree, and the op-level cost count (a hand
count, exactly)."""

import json

import numpy as np
import pytest
import torch

from openglraytracer_tpu import cli as j_cli
from openglraytracer_tpu.models import animated as j_animated
from openglraytracer_tpu.models import builders as jb
from openglraytracer_tpu.models import scene as j_scene
from openglraytracer_tpu.utils import debug as j_debug
from openglraytracer_tpu.utils import oracle as j_oracle
from openglraytracer_tpu_torch import cli as t_cli
from openglraytracer_tpu_torch import kernels
from openglraytracer_tpu_torch.models import animated as t_animated
from openglraytracer_tpu_torch.models import builders as tb
from openglraytracer_tpu_torch.models import scene as t_scene
from openglraytracer_tpu_torch.ops.accel import suggest_cull_config
from openglraytracer_tpu_torch.ops.render import render
from openglraytracer_tpu_torch.utils import debug as t_debug
from openglraytracer_tpu_torch.utils import oracle as t_oracle
from openglraytracer_tpu_torch.utils import profiling

from _torch_helpers import np_, to_torch_camera, to_torch_scene

# the oracle fixtures of tests/test_render_golden.py: (JAX builder, port
# builder, height, width, depth)
ORACLE = {
    "c1": (jb.single_sphere_scene, tb.single_sphere_scene, 64, 64, 0),
    "c2": (jb.eight_sphere_scene, tb.eight_sphere_scene, 96, 96, 0),
    "obb": (lambda: j_animated.reference_frame(2.3),
            lambda device: t_animated.reference_frame(2.3, device=device),
            72, 128, 0),
    "mirror_d1": (jb.mirror_scene, tb.mirror_scene, 64, 64, 1),
    "mirror_d2": (jb.mirror_scene, tb.mirror_scene, 32, 32, 2),
}


def _golden(got, want, tol=2e-3, frac=0.995, mean_tol=1e-4):
    """tests/test_render_golden.py's comparison."""
    got = np.asarray(got, np.float64)
    err = np.abs(got - want).max(-1)
    ok = (err < tol).mean()
    assert ok >= frac, f"only {ok:.4%} pixels within {tol}; max {err.max()}"
    assert err.mean() < mean_tol, f"mean err {err.mean()}"


def _scene_arrays(scene):
    return {k: {f: np_(v) for f, v in getattr(scene, k)._asdict().items()}
            for k in scene._fields}


def test_load_scene_both_ways(tmp_path):
    scene, cam = jb.mirror_scene()
    j_scene.save_scene(scene, str(tmp_path / "j.json"), camera=cam)
    loaded = t_scene.load_scene(str(tmp_path / "j.json"), device="cpu")
    want = _scene_arrays(scene)
    for k, cols in _scene_arrays(loaded).items():
        for f, v in cols.items():
            assert v.dtype == want[k][f].dtype, (k, f)
            np.testing.assert_array_equal(v, want[k][f], err_msg=f"{k}.{f}")
    t_scene.save_scene(loaded, str(tmp_path / "t.json"),
                       camera=to_torch_camera(cam))
    # the reference loads the port's file as it loads its own (an empty
    # 2-D column comes back from JSON as shape (0,) in both)
    back = _scene_arrays(j_scene.load_scene(str(tmp_path / "t.json")))
    own = _scene_arrays(j_scene.load_scene(str(tmp_path / "j.json")))
    for k, cols in back.items():
        for f, v in cols.items():
            assert v.dtype == own[k][f].dtype, (k, f)
            np.testing.assert_array_equal(v, own[k][f], err_msg=f"{k}.{f}")


def test_cli_fit_external_target_matches_jax(tmp_path):
    """fit --target t.png --scene init.json: 3 Adam steps at 32x32 from the
    same files, the fitted centers within 1e-4 of the JAX CLI's."""
    init, target = str(tmp_path / "init.json"), str(tmp_path / "t.png")
    j_cli.main(["render", "--scene", "c1_sphere_plane", "--width", "32",
                "--height", "32", "--out", target, "--save-scene", init])
    d = json.loads(open(init).read())
    d["spheres"]["center"][0][0] += 0.4
    open(init, "w").write(json.dumps(d))
    common = ["fit", "--target", target, "--scene", init, "--steps", "3",
              "--lr", "0.05", "--trainable", "spheres.center"]
    j_cli.main(common + ["--save-scene", str(tmp_path / "j_fit.json")])
    t_cli.main(common + ["--device", "cpu",
                         "--save-scene", str(tmp_path / "t_fit.json")])
    want = np.asarray(json.loads((tmp_path / "j_fit.json").read_text())
                      ["spheres"]["center"])
    got = np.asarray(json.loads((tmp_path / "t_fit.json").read_text())
                     ["spheres"]["center"])
    assert np.abs(want - np.asarray(d["spheres"]["center"])).max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-4)
    with pytest.raises(SystemExit, match="must match"):
        t_cli.main(common + ["--device", "cpu", "--width", "16"])


@pytest.mark.parametrize("name", list(ORACLE))
def test_oracle_equals_the_reference(name):
    jbuild, tbuild, h, w, depth = ORACLE[name]
    jscene, jcam = jbuild()
    tscene, tcam = tbuild(device="cpu")
    want = j_oracle.render(jscene, jcam, h, w, depth=depth)
    got = t_oracle.render(tscene, tcam, h, w, depth=depth)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # the same from the JAX package's scene handed over through numpy
    np.testing.assert_array_equal(
        t_oracle.render(to_torch_scene(jscene), to_torch_camera(jcam), h, w,
                        depth=depth), want)


@pytest.mark.parametrize("case", ["c1", "c2", "c3", "mirror_d1", "obb",
                                  "c3_culled_pallas"])
def test_port_renders_against_its_oracle(case):
    """tests/test_render_golden.py's cases and tolerances, on 'xla' and on
    culled_pallas (kernels' plain versions)."""
    kw, tol = {}, {}
    if case.startswith("c3"):
        scene, cam = tb.sphere_grid_scene(8, device="cpu")
        h = w = 96
        depth = 0
        tol = dict(frac=0.99)
        if case == "c3_culled_pallas":
            kw = dict(engine="culled_pallas",
                      cull=suggest_cull_config(scene, cam, h, w, (16, 16)))
    else:
        _, tbuild, h, w, depth = ORACLE[case]
        scene, cam = tbuild(device="cpu")
        tol = {"c1": {}, "c2": {}, "mirror_d1": dict(frac=0.99),
               "obb": dict(frac=0.99, mean_tol=3e-4)}[case]
    with torch.no_grad():
        got = render(scene, cam, h, w, depth=depth, **kw)
    _golden(got.numpy(), t_oracle.render(scene, cam, h, w, depth=depth),
            **tol)


def test_checked_render():
    """Clean on c2 ('xla') and on c3 culled_pallas (kernels A, B and 4 as
    opaque ops, kernel B's NaN rows exempt); a NaN radius is flagged, as
    the JAX package's checkify flags it, naming an aten op."""
    scene, cam = tb.eight_sphere_scene(device="cpu")
    err, img = t_debug.checked_render(scene, cam, 16, 16, engine="xla")
    err.throw()
    assert err.get() is None and torch.isfinite(img).all()
    c3, c3cam = tb.sphere_grid_scene(8, device="cpu")
    spec = suggest_cull_config(c3, c3cam, 64, 64, (16, 16))
    err, img = t_debug.checked_render(c3, c3cam, 64, 64,
                                      engine="culled_pallas", cull=spec)
    err.throw()
    assert torch.isfinite(img).all()

    jscene, jcam = jb.eight_sphere_scene()
    jbad = jscene._replace(spheres=jscene.spheres._replace(
        radius=jscene.spheres.radius.at[0].set(float("nan"))))
    assert j_debug.checked_render(jbad, jcam, 16, 16)[0].get() is not None
    bad = to_torch_scene(jbad)
    err, _ = t_debug.checked_render(bad, to_torch_camera(jcam), 16, 16)
    assert err.get() is not None and "aten." in err.get()
    with pytest.raises(FloatingPointError, match="nan"):
        err.throw()


def test_checked_render_checks_kernel_outputs(monkeypatch):
    """A kernel wrapper is one op to the check: a NaN in its output is
    flagged under its name, and the NaN inside its plain version is not
    looked into."""
    from openglraytracer_tpu_torch.ops import shade
    real = shade.phong_core

    def nan_core(*args):
        out = real(*args)
        return out + torch.nan * (out[:1] > -1)     # every row NaN
    monkeypatch.setattr(shade, "phong_core", nan_core)
    c3, cam = tb.sphere_grid_scene(2, device="cpu")
    spec = suggest_cull_config(c3, cam, 32, 32, (16, 16))
    err, _ = t_debug.checked_render(c3, cam, 32, 32, engine="culled_pallas",
                                    cull=spec)
    assert "kernel phong_shade" in err.get()
    assert kernels.NAN_CHECK.get() is None


def test_assert_finite_tree():
    scene, _ = tb.eight_sphere_scene(device="cpu")
    t_debug.assert_finite_tree(scene, "scene")
    t_debug.assert_finite_tree({"spheres.center": scene.spheres.center})
    bad = scene._replace(spheres=scene.spheres._replace(
        radius=scene.spheres.radius.clone().index_fill(
            0, torch.tensor([0]), float("nan"))))
    with pytest.raises(FloatingPointError, match=r"scene\.spheres\.radius"):
        t_debug.assert_finite_tree(bad, "scene")
    with pytest.raises(FloatingPointError, match=r"g\['r'\]"):
        t_debug.assert_finite_tree({"r": torch.tensor([np.inf])}, "g")


def test_cost_analysis_counts_by_hand():
    """sqrt(x * y + x) on (64, 32) float32: three arithmetic ops of 2048
    outputs; bytes: mul reads 2 and writes 1 tensor, add the same, sqrt
    reads 1 and writes 1 (8 KiB each); a (8, 16) @ (16, 4) product adds
    2*8*16*4 flops and its 512 + 256 + 128 bytes."""
    x = torch.rand(64, 32)
    y = torch.rand(64, 32)
    cost = profiling.cost_analysis(lambda a, b: torch.sqrt(a * b + a), x, y)
    assert cost == {"flops": 3 * 2048.0, "bytes accessed": 8 * 8192.0,
                    "launches": {}}
    a, b = torch.rand(8, 16), torch.rand(16, 4)
    assert profiling.cost_analysis(torch.mm, a, b)["flops"] == 2 * 8 * 16 * 4
    assert profiling.flops_estimate(torch.mm, a, b) == 1024.0
    assert profiling.cost_analysis(torch.mm, a, b)["bytes accessed"] == \
        4 * (128 + 64 + 32)
