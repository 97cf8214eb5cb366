"""Time each design step of the redesigned kernels apart, on the GPU, at
full size: kernel 2's hot launch and kernel 7, kernel 3 (shadow occlusion
with its hot pairs) and kernel 6 (compaction).

    python scripts/ablate_torch_kernels.py [--turns 4] [--out FILE]

Builds the sources of chip_smoke.EARLIER_SOURCES once per step: a copy of
the shipped sources with the text edits of EDITS that undo a design step
or change a design constant, written under the git-ignored
_build/ablate/, and the earlier sources in earlier_csrc/ where that copy
is present (git-ignored; see chip_smoke.py; the earlier kernel 3 runs
through chip_smoke.earlier_shadow, with the dense pass over its hot
tiles). Captures the full-size inputs of kernel 2's hot and cold
launches (a c4_mirror4096 frame: 1024x1024, depth 1, 32x32 tiles and the
child spec; and kernel 3 on its primary level, hot_m 32), of kernels A
and 3 (a c3_grid64 frame, 64x64 tiles), of kernels 3 and 6 on a
c5_grid4096 frame (2048x2048, 32x32 tiles, hot_m 64) and of kernel 7 (a
c3_grid64 frame and the OBB world's primary rays at 1280x720, engine
pallas). Checks that every build gives the shipped
build's outputs bit for bit, then times every build of a kernel in turns
(forward, then backward through the list, TURNS times; device time per
call behind a spin kernel, as chip_smoke.py times a kernel) and prints the
medians, each kernel's registers and spills from ptxas, the card's name
and power limit, and one JSON line (also written to FILE).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import shutil
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from openglraytracer_tpu_torch import kernels  # noqa: E402

SOURCES = chip_smoke.EARLIER_SOURCES
FILES = SOURCES + kernels.HEADERS
SHIPPED = "shipped"
EARLIER = "earlier"
_NO_EXIT = "      if (blocked) continue;   // to the next stage()\n"
# name -> [(file, text of the shipped source, its replacement)]: each
# undoes one design step or changes one constant
EDITS = {
    # kernel 2 hot, (a) off: the root and the winner update on every test
    "hot_root_every_test": [(
        "primary_hit.cu",
        "  if (!(qd >= 0.0f)) return;   // a miss: kInfT, no update\n"
        "  bool ok = ray.qa_ok;",
        "  bool ok = (qd >= 0.0f) && ray.qa_ok;")],
    # (b): the rows a staged chunk holds; all 4096, the table resident
    # (64 KB, above 48 KB of dynamic shared memory after an opt-in)
    **{f"hot_rows_{n}": [(
        "primary_hit.cu", "constexpr int kHotRows = 1024;",
        f"constexpr int kHotRows = {n};")] for n in (64, 256, 2048)},
    "hot_resident": [
        ("primary_hit.cu", "constexpr int kHotRows = 1024;",
         "constexpr int kHotRows = 4096;"),
        ("primary_hit.cu", "  primary_hit_hot_kernel<<<grid, kBlock, smem,",
         "  cudaFuncSetAttribute(primary_hit_hot_kernel,\n"
         "                       cudaFuncAttributeMaxDynamicSharedMemorySize,"
         "\n                       smem);\n"
         "  primary_hit_hot_kernel<<<grid, kBlock, smem,")],
    # the threads (rays) of a block, of every kernel of the build
    **{f"threads_{n}": [(
        "common.cuh", "constexpr int kBlock = 256;",
        f"constexpr int kBlock = {n};")] for n in (128, 512)},
    # (e) off, both kernels: the staged rows read as plain C++ arrays
    "row_addr_plain": [
        ("primary_hit.cu", "  const unsigned rows = smem_addr(s_row);\n", ""),
        ("primary_hit.cu", "staged_row(rows, jj)", "s_row[jj]"),
        ("dense_hit.cu", "  const unsigned sph_rows = smem_addr(s_sph);\n",
         ""),
        ("dense_hit.cu", "staged_row(sph_rows, j)", "s_sph[j]")],
    # (e) in part: the address still taken into a register, unused, and
    # the rows read as arrays
    "rows_as_arrays": [
        ("primary_hit.cu", "staged_row(rows, jj)", "s_row[jj]"),
        ("dense_hit.cu", "staged_row(sph_rows, j)", "s_sph[j]")],
    # kernel 7, (a) off
    "dense_root_every_test": [(
        "dense_hit.cu", "  return !(q.disc >= 0.0f);", "  return false;")],
    # kernel 7, (b) off: no test skipped once a segment is blocked
    "dense_no_exit": [
        ("dense_hit.cu", _NO_EXIT, ""),
        ("dense_hit.cu", "j < m && !blocked", "j < m")],
    # kernel 7, (b) checked before every test
    "dense_exit_each_test": [
        ("dense_hit.cu", _NO_EXIT + "      for (int j = 0; j < m; ++j) {",
         "      for (int j = 0; j < m && !blocked; ++j) {"),
        ("dense_hit.cu", _NO_EXIT + "      for (int k = 0; k < m; ++k) {",
         "      for (int k = 0; k < m && !blocked; ++k) {")],
    # kernel 3: each hot pair's table in one block, not split
    "shadow_splits_1": [(
        "shadow_occlusion.cu",
        "  splits = splits < 1 ? 1 : (splits > chunks ? chunks : splits);",
        "  splits = 1;")],
    # kernel 3: the rows a staged chunk of the hot pairs' table holds
    **{f"shadow_rows_{n}": [(
        "shadow_occlusion.cu", "constexpr int kHotRows = 1024;",
        f"constexpr int kHotRows = {n};")] for n in (256, 2048)},
    # kernel 3: a block scans every chunk, whether or not a lane is open
    "shadow_no_block_exit": [(
        "shadow_occlusion.cu", "    if (!__syncthreads_or(open)) break;",
        "    __syncthreads();")],
    # kernel 3: the tests a lane runs between checks for a blocker
    **{f"shadow_tests_{n}": [(
        "shadow_occlusion.cu", "constexpr int kHotTests = 16;",
        f"constexpr int kHotTests = {n};")] for n in (1, 8, 32)},
    # kernel 3's first launch: the survivor tests between exit checks
    **{f"cold_tests_{n}": [(
        "shadow_occlusion.cu", "constexpr int kColdTests = 4;",
        f"constexpr int kColdTests = {n};")] for n in (1, 8)},
    # kernel 3's hot launch: the table's split from the blocks an SM
    # really holds at the kernel's registers, not from 2048 threads an SM
    "shadow_splits_occupancy": [(
        "shadow_occlusion.cu",
        "  int splits = sms * (2048 / oglrt::kBlock) / blocks;",
        "  int per_sm = 0;\n"
        "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
        "      &per_sm, oglrt::shadow_hot_kernel, oglrt::kBlock, 0);\n"
        "  int splits = sms * per_sm / blocks;")],
    # kernel 3: the staged rows read as a plain C++ array
    "shadow_rows_as_arrays": [(
        "shadow_occlusion.cu", "staged_row(rows, j)", "s_row[j]")],
    # kernel 6: the next step's 16 bytes loaded after this step's scan
    "compact_no_prefetch": [
        ("compact_mask.cu",
         "    const uint4 nxt = load_vec(v, base + kWarp + lane, n_vec);\n",
         ""),
        ("compact_mask.cu", "    cur = nxt;\n",
         "    cur = load_vec(v, base + kWarp + lane, n_vec);\n")],
}
# kernel -> [(step, the EDITS that build it, or None for the earlier
# sources)]: each step adds one design step to the one before it, then the
# shipped constants are varied one at a time
STEPS = {
    "primary_hit_hot": [
        (EARLIER, None),
        ("16-byte rows staged in 64-row chunks, root on every test",
         ("hot_rows_64", "hot_root_every_test", "row_addr_plain")),
        ("+ (a) no root on a miss", ("hot_rows_64", "row_addr_plain")),
        ("+ (b) 1024-row chunks", ("row_addr_plain",)),
        (SHIPPED + ": + (e) the row address in a register", ()),
        ("(b) 256-row chunks", ("hot_rows_256",)),
        ("(b) 2048-row chunks", ("hot_rows_2048",)),
        ("(b) the table resident, 4096 rows", ("hot_resident",)),
        ("(e) in part: the address taken, the rows read as arrays",
         ("rows_as_arrays",)),
        ("128 threads", ("threads_128",)),
        ("512 threads", ("threads_512",)),
    ],
    "dense_hit": [
        (EARLIER, None),
        ("+ (c) [c r^2] rows, root on every test, no early exit",
         ("dense_root_every_test", "dense_no_exit", "row_addr_plain")),
        ("+ (a) no root on a miss", ("dense_no_exit", "row_addr_plain")),
        ("+ (b) a blocked lane skips later boxes and chunks",
         ("row_addr_plain",)),
        ("(b) a blocked lane skips every later test",
         ("dense_exit_each_test",)),
        (SHIPPED + ": + (e) the row address in a register", ()),
        ("(e) in part: the address taken, the rows read as arrays",
         ("rows_as_arrays",)),
    ],
    # kernel 3 on a c5_grid4096 frame's inputs (hot_m 64 a light)
    "shadow_occlusion_c5": [
        (EARLIER, None),
        ("two launches, the table not split, a lane's exit checked at every "
         "test", ("shadow_splits_1", "shadow_tests_1")),
        ("+ sixteen tests between exit checks", ("shadow_splits_1",)),
        (SHIPPED + ": + the table split among up to four blocks a pair", ()),
        ("eight tests between exit checks", ("shadow_tests_8",)),
        ("thirty-two tests between exit checks", ("shadow_tests_32",)),
        ("256-row chunks", ("shadow_rows_256",)),
        ("2048-row chunks", ("shadow_rows_2048",)),
        ("no skip of a block's chunks once every lane is blocked",
         ("shadow_no_block_exit",)),
        ("the staged rows read as arrays", ("shadow_rows_as_arrays",)),
        ("the table split by the blocks an SM holds",
         ("shadow_splits_occupancy",)),
        ("first launch: a survivor's exit checked at every test",
         ("cold_tests_1",)),
        ("first launch: eight survivor tests between checks",
         ("cold_tests_8",)),
        ("128 threads", ("threads_128",)),
        ("512 threads", ("threads_512",)),
    ],
    # kernel 3 on a c3_grid64 frame's inputs (no hot pair)
    "shadow_occlusion": [
        (EARLIER, None),
        ("a survivor's exit checked at every test", ("cold_tests_1",)),
        (SHIPPED + ": + four survivor tests between checks", ()),
        ("eight survivor tests between checks", ("cold_tests_8",)),
        ("128 threads", ("threads_128",)),
        ("512 threads", ("threads_512",)),
    ],
    # kernel 6 on a c5_grid4096 (4096, 4096) mask
    "compact_mask": [
        (EARLIER, None),
        ("16 bytes a lane, the next load after the scan",
         ("compact_no_prefetch",)),
        (SHIPPED + ": + the next load before the scan", ()),
        ("128 threads", ("threads_128",)),
        ("512 threads", ("threads_512",)),
    ],
}

# kernels that share the hot launch's source: the earlier and the shipped
# build only, to show their time did not move
SHARED = ("primary_hit", "primary_hit_ray")


def variant_sources(edits: tuple):
    """A directory holding the shipped sources with these EDITS made."""
    out = kernels.BUILD_ROOT / "ablate" / ("-".join(edits) or SHIPPED)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    text = {f: (kernels.CSRC / f).read_text() for f in FILES}
    for name in edits:
        for f, old, new in EDITS[name]:
            if old not in text[f]:
                raise SystemExit(f"edit {name}: {old!r} is not in {f}: the "
                                 "source moved on, update EDITS")
            text[f] = text[f].replace(old, new)
    for f, t in text.items():
        (out / f).write_text(t)
    return out


def build_all():
    """{edits or None: (library, ptxas lines)} for every step."""
    edit_sets = {e for steps in STEPS.values() for _, e in steps}

    def one(edits):
        if edits is None:
            lib, build_log = chip_smoke.earlier_library(kernels)
        else:
            path, build_log = kernels.build(variant_sources(edits), SOURCES)
            lib = kernels.load(path, chip_smoke.EARLIER_FUNCTIONS
                               + ("oglrt_shadow_occlusion",
                                  "oglrt_shadow_hot"))
        return edits, (lib, chip_smoke.ptxas_lines(build_log))

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        return dict(pool.map(one, edit_sets))


def capture(dev):
    """{kernel: (wrapper, args, kwargs)} of the full-size calls (and the
    c3 and OBB inputs of kernel 7 under "dense_hit" and "dense_hit_obb",
    the c3, c5 and c4_mirror4096 primary-level inputs of kernel 3 under
    "shadow_occlusion", "shadow_occlusion_c5" and
    "shadow_occlusion_c4m")."""
    from openglraytracer_tpu_torch.models.animated import reference_frame
    from openglraytracer_tpu_torch.models.builders import BENCH_CONFIGS
    from openglraytracer_tpu_torch.ops import accel, culled, dense, shade
    from openglraytracer_tpu_torch.ops import shading
    from openglraytracer_tpu_torch.ops.render import render

    calls = {}
    with torch.no_grad():
        builder, h, w, depth = BENCH_CONFIGS["c4_mirror4096"]
        scene, cam = builder(device=dev)
        lights = shading.static_shadow_mask(scene)
        spec = accel.suggest_cull_config(scene, cam, h, w, (32, 32),
                                         shadow_lights=lights)
        child = accel.suggest_child_cull_config(scene, cam, h, w, spec,
                                                shadow_lights=lights)
        with chip_smoke.Capture(culled, shade, accel) as cap:
            render(scene, cam, h, w, depth=depth, engine="culled_pallas",
                   cull=spec, child_cull=child, shadow_lights=lights,
                   bounce_mask=shading.static_bounce_mask(scene))
        calls["primary_hit_hot"] = (culled.primary_hit_ray,
                                    cap.args["primary_hit_hot"],
                                    cap.kwargs["primary_hit_hot"])
        calls["primary_hit_ray"] = (culled.primary_hit_ray,
                                    cap.args["primary_hit_ray"], {})
        calls["shadow_occlusion_c4m"] = (culled.shadow_occlusion, next(
            x for n, x, _ in cap.log if n == "shadow_occlusion"), {})
        scene, cam = BENCH_CONFIGS["c3_grid64"][0](device=dev)
        lights = shading.static_shadow_mask(scene)
        spec = accel.suggest_cull_config(scene, cam, 1024, 1024, (64, 64),
                                         shadow_lights=lights)
        with chip_smoke.Capture(culled, shade, accel) as cap:
            render(scene, cam, 1024, 1024, engine="culled_pallas",
                   cull=spec, shadow_lights=lights)
        calls["primary_hit"] = (culled.primary_hit, cap.args["primary_hit"],
                                {})
        calls["shadow_occlusion"] = (culled.shadow_occlusion,
                                     cap.args["shadow_occlusion"], {})
        builder, h, w, _ = BENCH_CONFIGS["c5_grid4096"]
        c5, c5_cam = builder(device=dev)
        c5_lights = shading.static_shadow_mask(c5)
        c5_spec = accel.suggest_cull_config(c5, c5_cam, h, w, (32, 32),
                                            shadow_lights=c5_lights)
        with chip_smoke.Capture(culled, shade, accel) as cap:
            render(c5, c5_cam, h, w, engine="culled_pallas", cull=c5_spec,
                   shadow_lights=c5_lights)
        calls["shadow_occlusion_c5"] = (culled.shadow_occlusion,
                                        cap.args["shadow_occlusion"], {})
        calls["compact_mask"] = (accel.compact_mask, next(
            c for c in cap.calls if c[0].shape[-1] >= accel.MIN_N_FOR_KERNEL),
            {})
        seen = []
        fn = dense.dense_hit
        dense.dense_hit = lambda *a: (seen.append(a), fn(*a))[1]
        try:
            render(scene, cam, 1024, 1024, engine="pallas")
            render(*reference_frame(1.2, device=dev), 720, 1280,
                   engine="pallas")
        finally:
            dense.dense_hit = fn
        calls["dense_hit"] = (dense.dense_hit, seen[0], {})
        calls["dense_hit_obb"] = (dense.dense_hit, seen[1], {})
    return calls


def main(argv=None) -> int:
    from openglraytracer_tpu_torch.ops import accel, culled

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--turns", type=int, default=4)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = chip_smoke.smi_line()
    print(f"{torch.cuda.get_device_name(0)}; {smi}", flush=True)

    libs = build_all()
    if libs[None][0] is None:
        print(f"no earlier sources at {chip_smoke.EARLIER_CSRC}: the "
              "earlier step is left out", flush=True)
    calls = capture(dev)
    plan = dict(STEPS)
    shipped = [x for x in STEPS["primary_hit_hot"] if x[1] == ()]
    for k in SHARED:
        plan[k] = [STEPS["primary_hit_hot"][0]] + shipped
    plan["dense_hit_obb"] = STEPS["dense_hit"]
    plan["shadow_occlusion_c4m"] = STEPS["shadow_occlusion_c5"]
    result = {"card": smi, "kernels": {}}
    for name, steps in plan.items():
        steps = [(s, e) for s, e in steps if libs[e][0] is not None]
        fn, a, kw = calls[name]

        def runner(edits, fn=fn, a=a, kw=kw):
            """The call of a step's build, its outputs as a tuple."""
            lib = libs[edits][0]
            if edits is None and fn is culled.shadow_occlusion:
                old = chip_smoke.earlier_shadow(torch, accel, lib, a,
                                                kw)["both"]
                return lambda: (old(),)

            def run():
                with chip_smoke.using_library(kernels, lib):
                    out = fn(*a, **kw)
                return out if isinstance(out, tuple) else (out,)
            return run

        with torch.no_grad():
            want = runner(())()
            runs = {step: runner(edits) for step, edits in steps}
            same = {step: all(torch.equal(x, y)
                              for x, y in zip(run(), want))
                    for step, run in runs.items()}
            times = {step: [] for step, _ in steps}
            for turn in range(args.turns):
                for step, _ in (steps if turn % 2 == 0 else steps[::-1]):
                    times[step].append(chip_smoke.device_ms(
                        torch, runs[step], ()))
        rows = {}
        for step, edits in steps:
            rows[step] = dict(median_ms=statistics.median(times[step]),
                              ms=times[step], same_as_shipped=same[step],
                              edits=edits)
            print(f"{name:16s} {rows[step]['median_ms']:.4f} ms "
                  f"(same outputs: {same[step]}) {step}", flush=True)
        result["kernels"][name] = rows
        if not all(same.values()):
            print(f"FAIL: a build of {name} gives other outputs",
                  flush=True)
            return 1
    result["ptxas"] = {(" ".join(edits) or SHIPPED) if edits is not None
                       else EARLIER: lines
                       for edits, (lib, lines) in libs.items()
                       if lib is not None}
    for edits, lines in result["ptxas"].items():
        print(f"ptxas [{edits}]:", flush=True)
        for line in lines:
            print(f"  {line}", flush=True)
    print(smi, flush=True)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
