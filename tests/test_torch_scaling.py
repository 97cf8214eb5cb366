"""PyTorch port: the scaling-efficiency harness (parallel/scaling.py) and
`cli scale`. As tests/test_scaling.py, these check the harness's mechanics
on the CPU, not a device's efficiency: the device counts, the rows of a
2-process gloo world (every rank the same rows, the slowest rank's time),
and the CLI in one process."""

import json

import pytest

from openglraytracer_tpu.parallel.scaling import \
    default_device_counts as j_counts
from openglraytracer_tpu_torch import cli
from openglraytracer_tpu_torch.models.builders import single_sphere_scene
from openglraytracer_tpu_torch.parallel.scaling import (default_device_counts,
                                                        format_table,
                                                        measure_scaling)

from _torch_helpers import run_world


def test_default_device_counts():
    for n in range(1, 17):
        assert default_device_counts(n) == j_counts(n)


def test_measure_scaling_two_ranks():
    outs = run_world("scaling", 2)
    per_rank = [[json.loads(x) for x in out.splitlines()
                 if x.startswith("{")] for out in outs]
    assert per_rank[0] == per_rank[1]
    for result in per_rank[0]:
        rows = result["rows"]
        assert [r["devices"] for r in rows] == [1, 2]
        assert [r["mesh"] for r in rows] == ["1x1", "2x1"]
        assert rows[0]["efficiency"] == pytest.approx(1.0)
        for r in rows:
            assert r["sec"] > 0 and r["mrays_per_s"] > 0
            assert r["efficiency_baseline_devices"] == 1
        assert "efficiency" in format_table(rows)


def test_measure_scaling_one_process():
    scene, cam = single_sphere_scene(device="cpu")
    rows = measure_scaling(scene, cam, 16, 16, mode="step", warmup=0,
                           iters=1)
    assert [r["devices"] for r in rows] == [1] and rows[0]["sec"] > 0
    with pytest.raises(ValueError, match="2 devices requested, have 1"):
        measure_scaling(scene, cam, 16, 16, device_counts=[1, 2])
    with pytest.raises(ValueError, match="mode"):
        measure_scaling(scene, cam, 16, 16, mode="fit")


def test_scale_cli(tmp_path, capsys):
    out = tmp_path / "scale.json"
    cli.main(["scale", "--scene", "c1_sphere_plane", "--height", "32",
              "--width", "32", "--iters", "1", "--device", "cpu",
              "--json", str(out)])
    rows = json.loads(out.read_text())
    assert [r["devices"] for r in rows] == [1]
    captured = capsys.readouterr().out
    assert "worst-case efficiency" in captured and "1x1" in captured
