"""Worker of the PyTorch port's multi-process tests
(tests/test_torch_distributed.py, tests/test_torch_scaling.py), in the
manner of tests/_dcn_worker.py. Run as

    python _torch_dist_worker.py MODE RANK WORLD HOST:PORT

Each process of a gloo world on the CPU starts the process group through
init_distributed's explicit path, then, with MODE

  world:   renders its tile (render_sharded, engines 'auto' and
           culled_pallas with its overflow count), assembles the image with
           gather_image and checks it against a render in this process;
           takes two sharded Adam steps and checks that every rank holds
           the same parameters, close to two unsharded steps;
  scaling: runs measure_scaling over counts 1 and WORLD and prints its
           rows as JSON.

It prints "rank RANK OK" at the end. Imports nothing of JAX.
"""

import json
import sys


def world(rank: int, n: int) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from openglraytracer_tpu_torch.models.builders import sphere_grid_scene
    from openglraytracer_tpu_torch.ops.accel import suggest_cull_config
    from openglraytracer_tpu_torch.ops.render import render
    from openglraytracer_tpu_torch.parallel.distributed import gather_image
    from openglraytracer_tpu_torch.parallel.mesh import make_mesh
    from openglraytracer_tpu_torch.parallel.sharded import render_sharded
    from openglraytracer_tpu_torch.train.inverse import (FitConfig,
                                                         make_train_step)

    mesh = make_mesh()
    assert mesh.size == n and mesh.group is not None, mesh
    h = w = 16
    scene, cam = sphere_grid_scene(2, seed=3, device="cpu")
    with torch.no_grad():
        tile = render_sharded(scene, cam, h, w, mesh=mesh)
        assert tuple(tile.shape) == (h // mesh.shape[0], w // mesh.shape[1],
                                     3)
        ref = render(scene, cam, h, w, bounce_mask=(True, True))
        np.testing.assert_array_equal(gather_image(tile, mesh), ref.numpy())

        spec = suggest_cull_config(scene, cam, h, w, (4, 4))
        tile, ovf = render_sharded(scene, cam, h, w, mesh=mesh,
                                   engine="culled_pallas", cull=spec,
                                   with_cull_stats=True)
        ref, ref_ovf = render(scene, cam, h, w, engine="culled_pallas",
                              cull=spec, with_cull_stats=True)
        np.testing.assert_allclose(gather_image(tile, mesh), ref.numpy(),
                                   atol=1e-6, rtol=0)
        assert int(ovf) == int(ref_ovf), (int(ovf), int(ref_ovf))
        target = ref * 0.8

    cfg = FitConfig(height=h, width=w, learning_rate=0.02)

    def two_steps(m):
        init_fn, step_fn = make_train_step(cam, cfg, mesh=m)
        params, opt = init_fn(scene)
        losses = []
        for _ in range(2):
            params, opt, loss, _ = step_fn(params, opt, scene, target)
            losses.append(float(loss))
        return params, losses

    sharded, loss_s = two_steps(mesh)
    single, loss_1 = two_steps(None)
    np.testing.assert_allclose(loss_s, loss_1, rtol=1e-5)
    for k, v in sharded.items():
        v = v.detach()
        every = [torch.empty_like(v) for _ in range(n)]
        dist.all_gather(every, v)
        assert all(torch.equal(x, v) for x in every), f"{k} differs by rank"
        np.testing.assert_allclose(v.numpy(), single[k].detach().numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def scaling(rank: int, n: int) -> None:
    from openglraytracer_tpu_torch.models.builders import single_sphere_scene
    from openglraytracer_tpu_torch.parallel.scaling import measure_scaling

    scene, cam = single_sphere_scene(device="cpu")
    for mode in ("render", "step"):
        rows = measure_scaling(scene, cam, 16, 16, mode=mode,
                               device_counts=[1, n], warmup=0, iters=1)
        print(json.dumps({"mode": mode, "rows": rows}), flush=True)


def main():
    mode, rank, n, addr = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                           sys.argv[4])
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist

    from openglraytracer_tpu_torch.parallel.distributed import \
        init_distributed
    init_distributed(coordinator_address=addr, num_processes=n,
                     process_id=rank, device="cpu")
    assert dist.get_world_size() == n and dist.get_rank() == rank
    assert dist.get_backend() == "gloo"
    try:
        {"world": world, "scaling": scaling}[mode](rank, n)
    finally:
        dist.destroy_process_group()
    print(f"rank {rank} OK", flush=True)


if __name__ == "__main__":
    main()
