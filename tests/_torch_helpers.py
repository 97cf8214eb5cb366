"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The tests build scenes with the JAX package, hand them to the port through
numpy, run the JAX function and its port on the same inputs, and compare.
The suite runs under several xdist workers, so each keeps torch to one
thread.
"""

import os
import socket
import subprocess
import sys

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


# the workers of run_world: tests/_torch_dist_worker.py
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_torch_dist_worker.py")
WORKER_TIMEOUT = 120    # seconds, each worker process
LAUNCHER_VARS = ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK",
                  "LOCAL_RANK")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(mode: str, n: int) -> list:
    """Run n processes of tests/_torch_dist_worker.py MODE in one gloo
    world on the CPU (address 127.0.0.1, a free port); assert each ends
    with its "rank i OK" and return their outputs."""
    addr = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, _WORKER, mode, str(i), str(n),
                               addr], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out}"
        assert f"rank {i} OK" in out, out
    return outs
