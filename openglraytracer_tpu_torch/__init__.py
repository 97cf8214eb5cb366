"""openglraytracer_tpu_torch — the raytracer ported to PyTorch and CUDA.

A second package beside the JAX reference ``openglraytracer_tpu``. Plain
tensor code is PyTorch; every Pallas kernel of the reference's main path is a
CUDA C++ kernel written for Hopper (``csrc/``, built by ``kernels.py``), with a
plain PyTorch version of the same function beside it. On a CPU tensor a kernel
wrapper runs its plain version; on a CUDA tensor it launches the kernel or
raises.

The port covers the engines ``culled_pallas``, ``culled`` (its narrow
phase in plain PyTorch), ``pallas`` (the dense kernel), ``xla`` (``auto``)
and ``autodiff``, forward and backward, at any depth: ray generation, the tile-cone broad phase with its compaction kernel,
the primary-hit kernel (shared-origin and per-ray modes, with the
hot-primary launch) and the shadow-occlusion kernel, survivor-routed
materials, the fused Phong shade kernel, the dense hit kernel, the bounce
tree and the stack bounce engine; the analytic winner backward, the shade
backward kernel and the inverse-rendering fit (``train/inverse.py``). Around
them: PNG output and input with the native encoder (``utils/image.py``),
scene files, the NumPy oracle, the NaN-checked render, profiling and the
live viewer (``utils/``), and the tile-sharded render and fit over
``torch.distributed``, one process per device (``parallel/``). The
reference's ``bench.py`` is not ported yet (ROADMAP.md).

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
