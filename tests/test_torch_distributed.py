"""PyTorch port: the multi-process runtime (parallel/distributed.py) in
real gloo worlds of 2 and 4 processes on the CPU (tests/_torch_dist_worker.py:
init_distributed's explicit path, render_sharded and gather_image equal to
a render in one process, two sharded Adam steps equal on every rank and
within 1e-5 of the unsharded steps), and the unit tests of
tests/test_distributed.py for its environment detection, transposed to a
launcher's WORLD_SIZE and MASTER_ADDR."""

import pytest
import torch.distributed as dist

from openglraytracer_tpu_torch.parallel import distributed as d

from _torch_helpers import LAUNCHER_VARS, run_world


@pytest.mark.parametrize("n", [2, 4])
def test_gloo_world(n):
    run_world("world", n)


def _clear(monkeypatch):
    for k in LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)


def test_launcher_environment_detection(monkeypatch):
    _clear(monkeypatch)
    assert not d._launcher_environment()
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    assert not d._launcher_environment()   # one process: stay single
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert d._launcher_environment()
    monkeypatch.delenv("MASTER_ADDR")
    assert not d._launcher_environment()
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "four")
    assert not d._launcher_environment()


def test_init_distributed_noop_single_process(monkeypatch):
    """No arguments and no launcher environment: torch.distributed is not
    touched."""
    _clear(monkeypatch)
    called = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: called.append((a, kw)))
    d.init_distributed(device="cpu")
    assert called == []


def test_init_distributed_launcher_env_autoinit(monkeypatch):
    """A launcher's environment initializes from it, on the device's
    backend; an initialized world is left alone."""
    _clear(monkeypatch)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    called = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: called.append((a, kw)))
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    d.init_distributed(device="cpu")
    assert called == [(("gloo",), {"init_method": "env://"})]
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    d.init_distributed(device="cpu")
    assert len(called) == 1


def test_init_distributed_explicit_errors_propagate(monkeypatch):
    """Explicit arguments never fall back to one process, and the backend
    is never chosen against the device."""
    _clear(monkeypatch)

    def boom(*a, **kw):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        d.init_distributed(coordinator_address="10.0.0.1:1",
                           num_processes=2, process_id=0, device="cpu")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        d.init_distributed(coordinator_address="10.0.0.1:1",
                           num_processes=2, process_id=0, device="cuda")
