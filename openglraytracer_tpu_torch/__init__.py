"""openglraytracer_tpu_torch — the raytracer ported to PyTorch and CUDA.

A second package beside the JAX reference ``openglraytracer_tpu``. Plain
tensor code is PyTorch; every Pallas kernel of the reference's main path is a
CUDA C++ kernel written for Hopper (``csrc/``, built by ``kernels.py``), with a
plain PyTorch version of the same function beside it. On a CPU tensor a kernel
wrapper runs its plain version; on a CUDA tensor it launches the kernel or
raises.

The port covers engine ``culled_pallas``, forward and backward, at depth 0
and with bounce children on the culled path: ray generation, the tile-cone
broad phase with its compaction kernel, the primary-hit kernel (shared-origin
and per-ray modes, with the hot-primary launch) and the shadow-occlusion
kernel, survivor-routed materials, the fused Phong shade kernel and the
bounce blend; the analytic winner backward of the narrow phase, the shade
backward kernel and the inverse-rendering fit (``train/inverse.py``). Other
engines and dense bounce children are listed in ROADMAP.md.

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
