"""The reference's animated world: its hardcoded 5-object scene and orbiting
camera as a function of time.

Port of ``openglraytracer_tpu/models/animated.py``. The scene at time t
(seconds; animated at t * TIME_SCALE): a red glass sphere, a +-11 wall cube
around everything, a pulsing, bobbing and spinning mirror cube, a tilting
green glass floor slab and a tumbling blue glass box; no plane; three
lights, the first of them ambient only. The camera orbits at radius 10 with
the reference's literal 180 / 3.1416 (not pi) in its yaw.

Every value is computed in float32 tensor ops in the order of the JAX
package; its sin and cos may differ from XLA's by an ulp.
"""

from __future__ import annotations

import torch

from openglraytracer_tpu_torch.models.scene import (REF_LIGHTS, REF_MATERIALS,
                                                    TIME_SCALE, Boxes, Camera,
                                                    Scene, Spheres,
                                                    empty_planes, make_lights,
                                                    make_materials,
                                                    make_scene)

# Material table order (ids): 0=red_glass (sphere), 1=wall, 2=mirror,
# 3=green_glass, 4=blue_glass
_MAT_ORDER = ["red_glass", "wall", "mirror", "green_glass", "blue_glass"]


def reference_materials(dtype=torch.float32, device="cuda"):
    return make_materials([REF_MATERIALS[k] for k in _MAT_ORDER], dtype,
                          device)


def reference_scene(time, dtype=torch.float32, device="cuda") -> Scene:
    """The 5-object animated scene at a given time (seconds)."""
    def v(*xs):
        return torch.tensor(xs, dtype=dtype, device=device)

    t = torch.tensor(time, dtype=dtype, device=device) * TIME_SCALE
    one3, zero3 = v(1.0, 1.0, 1.0), v(0.0, 0.0, 0.0)
    zero = torch.zeros((), dtype=dtype, device=device)

    spheres = Spheres(center=v(-3.0, 4.0, 1.0)[None], radius=v(2.0),
                      material_id=torch.tensor([0], dtype=torch.int32,
                                               device=device))
    ext = 0.5 * torch.sin(t * 0.5) + 1.5       # pulsing mirror half-extent
    boxes = Boxes(
        mins=torch.stack([-11.0 * one3,                # wall
                          -one3 * ext,                 # mirror cube
                          v(-10.0, -10.0, -1.0),       # floor slab
                          v(-1.0, -1.0, -2.0)]),       # blue box
        maxs=torch.stack([11.0 * one3, one3 * ext, v(10.0, 10.0, 1.0),
                          v(1.0, 1.0, 2.0)]),
        position=torch.stack([zero3,
                              torch.stack([zero, zero,
                                           torch.sin(t * 3.0)]),  # bobbing
                              v(0.0, 0.0, -3.0), v(3.0, 4.0, 1.0)]),
        angles=torch.stack([
            zero3,
            torch.stack([zero, t * 90.0, zero]),                   # spin
            torch.stack([torch.sin(t * 5.0) * 10.0, v(45.0)[0], zero]),
            torch.stack([45.0 + t * 45.0, zero, 45.0 + t * 180.0]),  # tumble
        ]),
        material_id=torch.tensor([1, 2, 3, 4], dtype=torch.int32,
                                 device=device))
    return make_scene(spheres=spheres, boxes=boxes,
                      planes=empty_planes(dtype, device),
                      materials=reference_materials(dtype, device),
                      lights=make_lights(REF_LIGHTS, dtype, device))


def reference_camera(time, dtype=torch.float32, device="cuda") -> Camera:
    """The orbiting camera."""
    def s(x):
        return torch.tensor(x, dtype=dtype, device=device)

    time = s(time)
    radius = 10.0
    speed = time * TIME_SCALE + 0.5
    zero = s(0.0)
    position = torch.stack([radius * torch.cos(speed),
                            radius * torch.sin(speed), zero])
    # the reference's literal constant 3.1416, not pi
    yaw = torch.remainder(speed * (180.0 / 3.1416), 360.0) + 90.0
    return Camera(position=position, angles=torch.stack([zero, yaw, zero]),
                  v_fov=s(90.0), aspect=s(16.0 / 9.0), near=s(0.1),
                  far=s(1000.0))


def reference_frame(time, dtype=torch.float32, device="cuda"):
    """(Scene, Camera) of the reference demo at `time` seconds."""
    return (reference_scene(time, dtype, device),
            reference_camera(time, dtype, device))
