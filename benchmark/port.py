"""The program under test, as the benchmark reaches it: the PyTorch and
CUDA port ``openglraytracer_tpu_torch``. Nothing else of the benchmark
imports it, and the reference never does.

The adapter builds the port's scene and camera from the benchmark's plain
tensors (the same tensors the reference takes), sizes the cull spec with
the port's own host pass, and calls the port's entry points: ``render``
(``ops/render.py``), ``to_uint8_device`` (``utils/image.py``) and
``make_train_step`` (``train/inverse.py``) with Adam.
"""

from __future__ import annotations

import torch

PACKAGE = "openglraytracer_tpu_torch"

# the program's trainable paths -> the benchmark's plain tensor names
PLAIN = {"spheres.center": "center", "spheres.radius": "radius",
         "materials.diffuse": "diffuse"}


class Port:
    def __init__(self, config: dict, device):
        self.config = config
        self.device = torch.device(device)
        self.h, self.w = int(config["height"]), int(config["width"])

    def scene(self, t: dict):
        from openglraytracer_tpu_torch.models.scene import (
            Lights, Materials, Planes, Scene, Spheres, empty_boxes)
        return Scene(
            spheres=Spheres(t["center"], t["radius"], t["sphere_material"]),
            boxes=empty_boxes(dtype=t["center"].dtype, device=self.device),
            planes=Planes(t["plane_normal"], t["plane_offset"],
                          t["plane_material"]),
            materials=Materials(t["ambient"], t["diffuse"], t["specular"],
                                t["shininess"], t["emissive"],
                                t["reflectivity"], t["transparency"],
                                t["refraction_index"]),
            lights=Lights(t["light_position"], t["light_ambient"],
                          t["light_diffuse"], t["light_specular"]))

    def camera(self, cam: dict, position=None):
        from openglraytracer_tpu_torch.models.scene import Camera
        return Camera(position=cam["position"] if position is None
                      else position, angles=cam["angles"],
                      v_fov=cam["v_fov"], aspect=cam["aspect"],
                      near=cam["near"], far=cam["far"])

    def shadow_lights(self, scene):
        from openglraytracer_tpu_torch.ops.shading import static_shadow_mask
        return static_shadow_mask(scene)

    def cull_spec(self, scene, camera, lights):
        from openglraytracer_tpu_torch.ops.accel import suggest_cull_config
        return suggest_cull_config(
            scene, camera, self.h, self.w, tuple(self.config["cull_tile"]),
            headroom=float(self.config["cull_headroom"]),
            shadow_lights=lights)

    def render(self, scene, camera, spec, lights):
        """(image (H, W, 3) float, overflow events device int32 scalar)."""
        from openglraytracer_tpu_torch.ops import render as render_mod
        with torch.no_grad():
            return render_mod.render(
                scene, camera, self.h, self.w, depth=self.config["depth"],
                engine=self.config["engine"], cull=spec,
                shadow_lights=lights, with_cull_stats=True)

    def to_uint8(self, image):
        from openglraytracer_tpu_torch.utils import image as image_mod
        return image_mod.to_uint8_device(image)

    def train_step(self, camera, spec, traffic: dict):
        """(init_fn, step_fn) of the port's fit step with Adam, one rate
        for each trainable leaf."""
        from openglraytracer_tpu_torch.train import inverse
        trainable = tuple(traffic["trainable"])
        rates = [float(traffic["learning_rates"][k]) for k in trainable]
        cfg = inverse.FitConfig(
            height=self.h, width=self.w, depth=self.config["depth"],
            engine=self.config["engine"], cull=spec, trainable=trainable)
        return inverse.make_train_step(camera, cfg, optimizer=lambda ps: (
            torch.optim.Adam([{"params": [p], "lr": lr}
                              for p, lr in zip(ps, rates)])))

    def params_plain(self, params: dict) -> dict:
        return {PLAIN[k]: v for k, v in params.items()}

    def first_grad(self, opt, params: dict) -> dict:
        """The first step's gradient as Adam received it, from its state
        after one step: exp_avg = (1 - beta1) g."""
        beta1 = opt.param_groups[0]["betas"][0]     # every group's
        return {PLAIN[k]: opt.state[p]["exp_avg"].detach() / (1.0 - beta1)
                for k, p in params.items()}
