"""The lower-precision control: the plain reference put in the program's
place, computed in bfloat16 (the configurations state float32, and the
reference takes no matrix product that TF32 would change, so bfloat16 is
the nearest precision below). Run through the harness, it has to come
out not correct; ``calibrate.py`` reads its numbers on the chip and
``tests/test_benchmark_control.py`` at a test's size.

It has the program adapter's interface (``port.Port``)."""

from __future__ import annotations

import torch

from benchmark.port import PLAIN
from benchmark.reference import tracer

LOW = torch.bfloat16


class Control:
    def __init__(self, config: dict, device, dtype=LOW):
        self.config = config
        self.device = torch.device(device)
        self.h, self.w = int(config["height"]), int(config["width"])
        self.dtype = dtype

    def scene(self, t: dict):
        return dict(t)

    def camera(self, cam: dict, position=None):
        return cam if position is None else dict(cam, position=position)

    def shadow_lights(self, scene):
        return None

    def cull_spec(self, scene, camera, lights):
        return None

    def render(self, scene, camera, spec, lights):
        img = tracer.render(scene, camera, self.h, self.w, self.dtype)
        return img.float(), torch.zeros((), dtype=torch.int32,
                                         device=self.device)

    def to_uint8(self, image):
        return tracer.to_uint8(image)

    def train_step(self, camera, spec, traffic: dict):
        keys = [PLAIN[k] for k in traffic["trainable"]]
        lr = {PLAIN[k]: float(v)
              for k, v in traffic["learning_rates"].items()}
        h, w, dtype = self.h, self.w, self.dtype

        def init_fn(scene):
            params = {k: scene[k].to(dtype) for k in keys}
            return params, tracer.Adam(params, lr)

        def step_fn(params, opt, scene, target):
            loss, grads = tracer.loss_and_grads(scene, camera, h, w, target,
                                                opt.params, dtype)
            opt.step(grads)
            return opt.params, opt, loss.float(), torch.zeros(
                (), dtype=torch.int32, device=self.device)

        return init_fn, step_fn

    def params_plain(self, params: dict) -> dict:
        return {k: v.float() for k, v in params.items()}

    def first_grad(self, opt, params: dict) -> dict:
        return {k: (m / (1.0 - opt.b1)).float() for k, m in opt.m.items()}
