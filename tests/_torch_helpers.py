"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The tests build scenes with the JAX package, hand them to the port through
numpy, run the JAX function and its port on the same inputs, and compare.
The suite runs under several xdist workers, so each keeps torch to one
thread.
"""

import numpy as np
import torch

from openglraytracer_tpu_torch.models.scene import (camera_from_numpy,
                                                    scene_from_numpy)

torch.set_num_threads(1)


def np_(x):
    """JAX array or torch tensor -> numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_torch_scene(scene):
    """JAX Scene -> port Scene with identical arrays."""
    return scene_from_numpy({k: {f: np_(v) for f, v in
                                 getattr(scene, k)._asdict().items()}
                             for k in scene._fields}, device="cpu")


def to_torch_camera(cam):
    return camera_from_numpy({f: np_(v) for f, v in cam._asdict().items()},
                             device="cpu")


def to_torch(*xs):
    """JAX arrays -> CPU tensors with the same values."""
    out = tuple(torch.from_numpy(np.array(x)) for x in xs)
    return out if len(out) > 1 else out[0]


def assert_same_aux(aux_j, aux_t):
    """CullAux equality: survivor ids where valid, every other field exact
    (ids where ~valid are unspecified by the compaction contract)."""
    for f in aux_j._fields:
        a, b = np_(getattr(aux_j, f)), np_(getattr(aux_t, f))
        if f in ("p_idx", "b_idx"):
            valid = np_(aux_j.p_valid if f == "p_idx" else aux_j.b_valid)
            a, b = a * valid, b * valid
        np.testing.assert_array_equal(b, a, err_msg=f"CullAux.{f}")


def jitted_sphere_rows(monkeypatch):
    """Run the JAX package's culled_pallas row packer (pallas_culled.
    _primary_sphere_rows) jitted, as its render runs it, also where a test
    traces the reference eagerly: XLA then sums qc = |oc|^2 with fused
    multiply-adds, which the port's rows do (at 4096 spheres the sum
    rounded op by op flips tangent grazes, tests/test_torch_c5_faults.py).
    The rest of the eager trace is unchanged."""
    import jax
    from openglraytracer_tpu.ops import pallas_culled
    monkeypatch.setattr(pallas_culled, "_primary_sphere_rows",
                        jax.jit(pallas_culled._primary_sphere_rows))

