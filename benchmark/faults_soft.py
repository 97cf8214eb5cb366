"""Faults of the soft fit step, planted underneath the timed path to show
that the check catches them (``tests/test_benchmark_soft.py`` at a test's
size, ``calibrate_soft.py --fault`` at the cell's own size on the chip).
Each is a context manager that replaces a function of the program and
restores it on exit.

  view_left_out    the step fits every view but the last: its loss is the
                   mean over the others, and the last view's target is
                   never read
  unchanged_state  the step computes its loss and gradients, and its
                   parameters come back unchanged (``faults.py``'s)
"""

from __future__ import annotations

import contextlib
import dataclasses

from benchmark import faults


@contextlib.contextmanager
def view_left_out(loop: str):
    from openglraytracer_tpu_torch.train import inverse
    orig_make = inverse.make_train_step

    def make_train_step(camera, cfg, *args, **kwargs):
        cfg = dataclasses.replace(cfg, cull=tuple(cfg.cull)[:-1])
        init_fn, step_fn = orig_make(tuple(camera)[:-1], cfg, *args,
                                     **kwargs)

        def step(params, opt, scene, target):
            return step_fn(params, opt, scene, target[:-1])
        return init_fn, step

    with faults._patched(inverse, "make_train_step", make_train_step):
        yield


FAULTS = {"view_left_out": view_left_out,
          "unchanged_state": faults.unchanged_state}
