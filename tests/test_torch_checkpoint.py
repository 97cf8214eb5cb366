"""PyTorch port: the fit's checkpoints (utils/checkpoint.py) and fit()'s
resume, against the contract of the JAX package's utils/checkpoint.py and
its tests/test_train.py: at most three checkpoints kept, None when there
is none, numbered steps, and a resumed fit that runs only the steps after
the saved one. On the CPU a resumed fit equals an uninterrupted one bit
for bit (the same ops in the same order, the optimizer state restored)."""

import numpy as np
import pytest
import torch

from openglraytracer_tpu.models.builders import sphere_grid_scene
from openglraytracer_tpu.ops.render import render as j_render
from openglraytracer_tpu.train import inverse as jinv
from openglraytracer_tpu_torch.models import builders as tb
from openglraytracer_tpu_torch.ops.render import render
from openglraytracer_tpu_torch.train import inverse as tinv
from openglraytracer_tpu_torch.utils import checkpoint as ck

from _torch_helpers import np_, to_torch_camera, to_torch_scene


def test_restore_latest_without_checkpoints(tmp_path):
    assert ck.restore_latest(str(tmp_path / "missing")) is None
    assert ck.restore_latest(str(tmp_path)) is None
    (tmp_path / "notes.txt").write_text("not a checkpoint")
    assert ck.restore_latest(str(tmp_path), torch.device("cpu")) is None


def test_save_keeps_the_newest_three(tmp_path):
    d = str(tmp_path / "ckpt")
    for step in (1, 2, 5, 10, 11):
        ck.save(d, {"params": {"a": torch.full((2,), float(step))},
                    "step": step}, step)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "ckpt_000000005.pt", "ckpt_000000010.pt", "ckpt_000000011.pt"]
    state = ck.restore_latest(d, torch.zeros(()))
    assert state["step"] == 11
    assert torch.equal(state["params"]["a"], torch.full((2,), 11.0))


def test_a_torn_save_is_never_restored(tmp_path):
    """A run killed while saving leaves only the temporary name behind,
    which restore_latest does not take."""
    d = tmp_path / "ckpt"
    ck.save(str(d), {"step": 4}, 4)
    (d / "ckpt_000000008.pt.tmp").write_bytes(b"torn")
    assert ck.restore_latest(str(d))["step"] == 4


def _setup(h, w):
    """The reference's tests/test_train.py setup, the JAX package's scene
    and target handed to the port: 4 spheres, centers perturbed with
    seeded noise."""
    import jax
    scene_true, cam = sphere_grid_scene(2, seed=7)
    target = j_render(scene_true, cam, h, w)
    key = jax.random.PRNGKey(3)
    scene_init = scene_true._replace(spheres=scene_true.spheres._replace(
        center=scene_true.spheres.center
        + 0.25 * jax.random.normal(key, scene_true.spheres.center.shape)))
    return (to_torch_scene(scene_init), to_torch_camera(cam),
            torch.from_numpy(np.array(target)))


def test_fit_checkpoint_resume(tmp_path):
    """The reference's test: fit 20 steps saving every 10, then a fit to 30
    steps from the same directory resumes from step 20."""
    scene_init, cam, target = _setup(32, 32)
    ckpt = str(tmp_path / "ckpt")
    kw = dict(height=32, width=32, learning_rate=1e-2, log_every=5,
              checkpoint_dir=ckpt, checkpoint_every=10,
              trainable=("spheres.center",))
    tinv.fit(scene_init, target, cam, tinv.FitConfig(steps=20, **kw))
    _, losses = tinv.fit(scene_init, target, cam,
                         tinv.FitConfig(steps=30, **kw))
    assert losses[0][0] >= 20


@pytest.mark.parametrize("engine", ["auto", "culled"])
def test_resumed_fit_equals_uninterrupted(tmp_path, engine):
    """An Adam fit of 6 steps, against 4 steps saving every 2 and a fresh
    fit to 6 from the same directory: the fresh fit restores step 4, logs
    steps 4 and 5 with the uninterrupted fit's losses, and ends at its
    parameters bit for bit."""
    scene_init, cam, target = _setup(32, 32)
    cull = None
    if engine == "culled":
        from openglraytracer_tpu_torch.ops.accel import suggest_cull_config
        cull = suggest_cull_config(scene_init, cam, 32, 32, (16, 16),
                                   headroom=2.0)
    kw = dict(height=32, width=32, learning_rate=2e-2, log_every=1,
              engine=engine, cull=cull,
              trainable=("spheres.center", "spheres.radius",
                         "materials.diffuse"))
    fit_u, loss_u = tinv.fit(scene_init, target, cam,
                             tinv.FitConfig(steps=6, **kw))
    ckpt = str(tmp_path / "ckpt")
    tinv.fit(scene_init, target, cam,
             tinv.FitConfig(steps=4, checkpoint_dir=ckpt,
                            checkpoint_every=2, **kw))
    fit_r, loss_r = tinv.fit(scene_init, target, cam,
                             tinv.FitConfig(steps=6, checkpoint_dir=ckpt,
                                            checkpoint_every=2, **kw))
    assert [s for s, _ in loss_r] == [4, 5]
    assert loss_r == loss_u[4:]
    for k in kw["trainable"]:
        assert torch.equal(tinv.get_path(fit_r, k), tinv.get_path(fit_u, k))
    assert ck.restore_latest(ckpt)["step"] == 6


def test_checkpoint_holds_params_optimizer_and_step(tmp_path):
    """A checkpoint is {params, optimizer, step}, loadable with
    weights_only=True, its params the fit's after that step."""
    scene_init, cam, target = _setup(16, 16)
    ckpt = str(tmp_path / "ckpt")
    fitted, _ = tinv.fit(scene_init, target, cam, tinv.FitConfig(
        height=16, width=16, steps=3, checkpoint_dir=ckpt,
        checkpoint_every=3, trainable=("spheres.center",)))
    state = ck.restore_latest(ckpt, torch.device("cpu"))
    assert set(state) == {"params", "optimizer", "step"}
    assert state["step"] == 3
    assert torch.equal(state["params"]["spheres.center"],
                       fitted.spheres.center)
    assert state["optimizer"]["state"][0]["step"] == 3


def test_fit_config_follows_the_reference():
    """FitConfig has the reference's fields in its order, and its
    defaults (checkpoint_every 100)."""
    assert list(tinv.FitConfig.__dataclass_fields__) == list(
        jinv.FitConfig.__dataclass_fields__)
    t, j = tinv.FitConfig(), jinv.FitConfig()
    for f in tinv.FitConfig.__dataclass_fields__:
        assert getattr(t, f) == getattr(j, f), f
    assert t.checkpoint_every == 100


def test_fitted_scene_renders(tmp_path):
    """The resumed fit's scene is an ordinary scene: it renders."""
    scene, cam = tb.sphere_grid_scene(2, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    with torch.no_grad():
        target = render(scene, cam, 16, 16)
    cfg = tinv.FitConfig(height=16, width=16, steps=2, checkpoint_dir=ckpt,
                         checkpoint_every=1)
    tinv.fit(scene, target, cam, cfg)
    cfg.steps = 3
    fitted, losses = tinv.fit(scene, target, cam, cfg)
    assert [s for s, _ in losses] == [2]
    with torch.no_grad():
        img = render(fitted, cam, 16, 16)
    assert bool(torch.isfinite(img).all())
    assert np_(img).shape == (16, 16, 3)
