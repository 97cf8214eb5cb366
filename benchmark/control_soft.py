"""The lower-precision control of the soft-fit cells: the plain soft
reference (``reference/soft.py``) put in the program's place, computed in
bfloat16 (the configuration states float32, and the reference takes no
matrix product that TF32 would change, so bfloat16 is the nearest
precision below). Run through the harness it has to come out not correct;
``calibrate_soft.py --control`` reads its numbers on the chip.

It has the soft adapter's interface (``port_soft.SoftPort``)."""

from __future__ import annotations

import torch

from benchmark.port import PLAIN
from benchmark.reference import soft, tracer

LOW = torch.bfloat16


class SoftControl:
    def __init__(self, config: dict, device, dtype=LOW):
        self.config = config
        self.device = torch.device(device)
        self.h, self.w = int(config["height"]), int(config["width"])
        s = config["soft"]
        self.bw, self.gamma = float(s["bw"]), float(s["gamma"])
        self.t_bg = float(s["t_bg"])
        self.dtype = dtype

    def scene(self, t: dict):
        return dict(t)

    def camera(self, cam: dict, position=None):
        return cam if position is None else dict(cam, position=position)

    def soft_cull(self, scene, camera):
        return None

    def soft_render(self, scene, cameras, specs):
        img = soft.render(scene, cameras, self.h, self.w, self.bw,
                          self.gamma, self.t_bg, self.dtype)
        return img.float(), torch.zeros((), dtype=torch.int32,
                                         device=self.device)

    def soft_train_step(self, cameras, specs, traffic: dict):
        keys = [PLAIN[k] for k in traffic["trainable"]]
        lr = {PLAIN[k]: float(v)
              for k, v in traffic["learning_rates"].items()}

        def init_fn(scene):
            params = {k: scene[k].to(self.dtype) for k in keys}
            return params, tracer.Adam(params, lr)

        def step_fn(params, opt, scene, target):
            loss, grads = soft.loss_and_grads(
                scene, cameras, self.h, self.w, target, opt.params, self.bw,
                self.gamma, self.t_bg, self.dtype)
            opt.step(grads)
            return opt.params, opt, loss.float(), torch.zeros(
                (), dtype=torch.int32, device=self.device)

        return init_fn, step_fn

    def params_plain(self, params: dict) -> dict:
        return {k: v.float() for k, v in params.items()}

    def first_grad(self, opt, params: dict) -> dict:
        return {k: (m / (1.0 - opt.b1)).float() for k, m in opt.m.items()}
