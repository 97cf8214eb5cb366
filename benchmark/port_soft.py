"""The program under test in the soft-fit cells: the port's soft-coverage
fit step (``ops/soft.py`` through ``train/inverse.py make_train_step`` with
``FitConfig.soft``), over several views. Beside ``port.py``, this is the
one other file of the benchmark that reaches the port (``program_trace.py``
reads its record, and ``faults.py`` and ``faults_soft.py`` plant faults in
it); the reference never does.

``SoftPort`` keeps ``port.Port``'s scene, camera and Adam-state readers,
and adds the soft broad phase's sizing (``suggest_soft_cull``), the soft
render of the target and the multi-view fit step with Adam, one rate for
each trainable leaf, held at its base rate. Both render in blocks of the
configuration's ``block_pairs`` ray-sphere pairs; a program whose soft
forward takes no block size cannot run the configuration and is refused
at once.
"""

from __future__ import annotations

import inspect

import torch

from benchmark.port import Port

# the port's soft forward draws the background at this depth (soft_render's
# t_bg, which FitConfig does not set)
PORT_T_BG = 200.0


class SoftPort(Port):
    def __init__(self, config: dict, device):
        super().__init__(config, device)
        soft = config["soft"]
        self.bw, self.gamma = float(soft["bw"]), float(soft["gamma"])
        if float(soft["t_bg"]) != PORT_T_BG:
            raise ValueError(f"the port's soft fit draws its background at "
                             f"t_bg {PORT_T_BG}, not {soft['t_bg']}")
        from openglraytracer_tpu_torch.ops import soft as soft_ops
        if "block_pairs" not in inspect.signature(
                soft_ops.soft_render).parameters:
            raise RuntimeError("this program's soft forward takes no block "
                               "size (block_pairs): it cannot run the "
                               "configuration")
        self.block_pairs = int(config["block_pairs"])

    def soft_cull(self, scene, camera):
        """((th, tw), k) of one view, sized on ``scene`` by the port's host
        pass with the configuration's headroom."""
        from openglraytracer_tpu_torch.ops.soft import suggest_soft_cull
        return suggest_soft_cull(
            scene, camera, self.h, self.w, tuple(self.config["cull_tile"]),
            self.bw, headroom=float(self.config["cull_headroom"]))

    def soft_render(self, scene, cameras, specs):
        """(images (V, H, W, 3), overflow events summed over the views, a
        device int32 scalar)."""
        from openglraytracer_tpu_torch.ops.soft import soft_render
        imgs, ovf = [], None
        with torch.no_grad():
            for cam, spec in zip(cameras, specs):
                img, o = soft_render(scene, cam, self.h, self.w, bw=self.bw,
                                     gamma=self.gamma, cull=spec,
                                     t_bg=PORT_T_BG,
                                     block_pairs=self.block_pairs,
                                     with_cull_stats=True)
                imgs.append(img)
                ovf = o if ovf is None else ovf + o
        return torch.stack(imgs), ovf

    def soft_train_step(self, cameras, specs, traffic: dict):
        """(init_fn, step_fn) of the port's multi-view soft fit step with
        Adam; step_fn(params, opt, scene, target (V, H, W, 3))."""
        from openglraytracer_tpu_torch.train import inverse
        trainable = tuple(traffic["trainable"])
        rates = [float(traffic["learning_rates"][k]) for k in trainable]
        cfg = inverse.FitConfig(height=self.h, width=self.w,
                                trainable=trainable,
                                soft=(self.bw, self.gamma),
                                cull=tuple(specs))
        return inverse.make_train_step(
            tuple(cameras), cfg, optimizer=(
                lambda ps: torch.optim.Adam([{"params": [p], "lr": lr}
                                             for p, lr in zip(ps, rates)])),
            soft_block_pairs=self.block_pairs)
