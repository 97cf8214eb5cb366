"""openglraytracer_tpu_torch — the raytracer ported to PyTorch and CUDA.

A second package beside the JAX reference ``openglraytracer_tpu``. Plain
tensor code is PyTorch; every Pallas kernel of the reference's main path is a
CUDA C++ kernel written for Hopper (``csrc/``, built by ``kernels.py``), with a
plain PyTorch version of the same function beside it. On a CPU tensor a kernel
wrapper runs its plain version; on a CUDA tensor it launches the kernel or
raises.

This slice is the forward render of engine ``culled_pallas``: ray generation,
the tile-cone broad phase, the primary-hit and shadow-occlusion narrow-phase
kernels, survivor-routed materials and the fused Phong shade kernel. Other
engines, bounces and gradients are listed in ROADMAP.md.

The package imports neither ``jax`` nor ``openglraytracer_tpu``.
"""

__version__ = "0.1.0"

from openglraytracer_tpu_torch.models.scene import (  # noqa: F401
    Boxes,
    Camera,
    Lights,
    Materials,
    Planes,
    Scene,
    Spheres,
)
from openglraytracer_tpu_torch.ops.render import render  # noqa: F401
