"""Faults planted underneath the timed path, to show that the check catches
them (``tests/test_benchmark_faults.py`` at a test's size, ``calibrate.py
--fault`` at a cell's own size on the chip). Each is a context manager
that replaces a function of the program and restores it on exit.

  half_batch      render: the upper half of the rays of each image is
                  left out (black); train: the loss is the mean over the
                  lower half of the image's rows, the rest left out
  altered_answer  render: each image is altered where it is produced,
                  8/255 added to its red channel
  unchanged_state train: the step computes its loss and gradients, and
                  its parameters come back unchanged
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def half_batch(loop: str):
    from openglraytracer_tpu_torch.ops import render as render_mod
    from openglraytracer_tpu_torch.train import inverse

    if loop == "render":
        orig = render_mod.render

        def render(*args, **kwargs):
            img, ovf = orig(*args, **kwargs)
            img = img.clone()
            img[img.shape[0] // 2:] = 0.0
            return img, ovf

        with _patched(render_mod, "render", render):
            yield
        return
    orig_render, orig_make = inverse.render, inverse.make_train_step

    def render_rows(*args, **kwargs):
        img, ovf = orig_render(*args, **kwargs)
        return img[:img.shape[0] // 2], ovf

    def make_train_step(*args, **kwargs):
        init_fn, step_fn = orig_make(*args, **kwargs)

        def step(params, opt, scene, target):
            return step_fn(params, opt, scene,
                           target[:target.shape[0] // 2])
        return init_fn, step

    with _patched(inverse, "render", render_rows), \
            _patched(inverse, "make_train_step", make_train_step):
        yield


@contextlib.contextmanager
def altered_answer(loop: str):
    from openglraytracer_tpu_torch.ops import render as render_mod
    orig = render_mod.render

    def render(*args, **kwargs):
        img, ovf = orig(*args, **kwargs)
        img = img.clone()
        img[..., 0] += 8.0 / 255.0
        return img, ovf

    with _patched(render_mod, "render", render):
        yield


@contextlib.contextmanager
def unchanged_state(loop: str):
    from openglraytracer_tpu_torch.train import inverse
    orig_make = inverse.make_train_step

    def make_train_step(*args, **kwargs):
        init_fn, step_fn = orig_make(*args, **kwargs)

        def step(params, opt, scene, target):
            before = {k: v.detach().clone() for k, v in params.items()}
            out = step_fn(params, opt, scene, target)
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(before[k])
            return out
        return init_fn, step

    with _patched(inverse, "make_train_step", make_train_step):
        yield


FAULTS = {"half_batch": half_batch, "altered_answer": altered_answer,
          "unchanged_state": unchanged_state}
# the faults each loop can have
LOOP_FAULTS = {"render": ("half_batch", "altered_answer"),
               "train": ("half_batch", "unchanged_state")}
