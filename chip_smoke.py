#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: python3 chip_smoke.py

Drives the port's main paths through the entry points a user calls — the
forward ``render`` and the training step of ``train/inverse.make_train_step``
(value and gradient of the pixel MSE with respect to spheres.center,
spheres.radius and materials.diffuse, then an SGD step) — at the full size
of rows of the reference's benchmark. Engine culled_pallas: c3_grid64 (64
spheres, 1024x1024, depth 0, 64x64 tiles), c5_grid4096 (4096 spheres,
2048x2048, depth 0, 32x32 tiles) and c4_mirror4096 (4096 mirror spheres,
1024x1024, depth 1 with culled bounce children, 32x32 tiles). Engine pallas
(the dense engine, kernel 7): c3_grid64 at depth 0, and the reference's
animated OBB world (reference_frame(1.2): a glass sphere, four rotated
glass, mirror and wall boxes, no plane, 3 lights) at 1280x720, depth 0 and
depth 1, its training step also with respect to the boxes' positions and
angles. Engine 'xla' (the plain dense engine, the default 'auto'; no
kernel): c1_sphere_plane (256x256), c2_eight_spheres (512x512) and the OBB
world (the reference's animated_obb_720p row), and the children of
c4_mirror (64 mirror spheres and a plane, 1024x1024, depth 1, a
culled_pallas parent with 64x64 tiles). The stack bounce engine
(render(bounce='stack')): the reference's glass rows glass_stack_depth4
(the OBB world at 1024x1024, depth 4, 'xla' and 'pallas') and
glass4096_stack_culled (4096 glass spheres, 1024x1024, depth 4,
culled_pallas). Engine 'culled' (the XLA culled engine: the culled narrow
phase in plain PyTorch, kernel 6 on masks of 1024 objects or more): the
reference's rows c3_grid64_culled_xla, c5_grid4096_culled_xla,
c4_mirror4096_xlachild and c4_mirror4096_densechild, and the stack on
'culled' (a 1024-sphere glass grid). The training extras: the reference's
config 5 fit on c5's scene, its soft multi-view step and its checkpointed
hard stage, and remat on 'autodiff'. The host surface (PNG output and
input, the NaN-checked render, the op count, cli fit --target), the live
viewer at 1280x720, and the tile-sharded render and training step over
torch.distributed (NCCL, one process). Every call names its engine. It
exits non-zero on any failure. Phases:

  1. device: the card's name, and its name and power limit from nvidia-smi
  2. build: compile the CUDA kernels from csrc/ (one nvcc per source, in
     parallel, sm_90a), each kernel's registers, shared memory and spills
     from ptxas; and the earlier kernel sources in earlier_csrc/ where that
     copy is present (EARLIER_CSRC)
  3. each c3 kernel against its plain PyTorch version on the card, on the
     inputs the c3 paths give it, and on a small hand-built scene with
     rotated boxes (the box paths of kernels A and B, kernel B with and
     without hot shadow tiles, and the box winner replay of the backward
     against kernel A's own hits)
  4. the c3 forward path for 3 frames: every kernel launched on every
     frame, no cull overflow, a finite image within 1/255 of the plain
     versions' image on >= 99.9% of pixels, and a small render equal to
     the CPU's
  5. c3 forward timing with CUDA events: 3 windows of 10 frames under
     torch.cuda.set_sync_debug_mode("error"), and each forward kernel
     beside its plain version
  6. the c3 training path for 3 SGD steps (lr 1e-7, zero target): all four
     kernels launched on every step, no overflow, finite non-zero
     gradients that agree with the same step through the plain versions
  7. c3 training timing: 3 windows of 10 chained steps, the step's device
     time, and the shade backward kernel beside its plain version
  8. a short fit through train/inverse.fit (Adam, 128x128, grid side 4):
     the loss falls
  9. the compaction kernel against its plain version on every mask of at
     least 1024 objects that a c5_grid4096 and a c4_mirror4096 frame
     compact, and on ragged masks (kernel_cases.ragged_masks: widths 1025,
     4095, 4097; rows of 0, K - 1, K, K + 1 and N survivors): ids, valid
     flags and counts exactly equal
 10. kernel 3 (B, shadow occlusion: its first launch and its hot launch)
     against its plain version, bit for bit, on the inputs a c5_grid4096
     frame and both levels of a c4_mirror4096 frame hand it, hot (tile,
     light) pairs included (fails unless a hot tile's survivors exceed
     Ks), and on shadow_graze_inputs (tangent segments with the
     discriminant at 0 and an ulp either side, cast origins inside a
     sphere, qa at _DIV_EPS, tiles hot for one light only) against 4096,
     5000 and 5120 spheres; then kernel 2 (per-ray primary hit), its cold
     launch and its hot launch over the global table, against its plain
     version on the inputs a c4_mirror4096 frame hands them, cut to the 8
     hottest and 24 cold tiles; fails unless the child spec has a hot
     budget and a tile of the frame is truly hot. Then the hot launch on
     rays that split warps
     (graze_hot_inputs: tangent grazes with qd at 0 and an ulp either side,
     spheres behind the origin, invalid rows, a slack block) against 4096
     and 5120 spheres (four and five staged chunks): no discrete mismatch
     at all
 11. the c5_grid4096 and c4_mirror4096 forward paths for 3 frames each:
     every kernel of the path launched on every frame, no overflow, a
     finite image within 1/255 of the plain versions' on >= 99.9% of pixels,
     and no call of the dense hot-shadow pass accel._segment_occluded
 12. their frame and training step timed as in phases 5 and 7 (and their
     peak device memory), and kernels 6, 2 and 3 (each of its launches and
     the two together, on every shadow call of the frames) beside their
     plain versions at full size, in turns with the earlier build where it
     is present (as kernels A and 3 at c3 in phase 5; the earlier kernel 3
     with the dense pass over its hot tiles, earlier_shadow)
 13. their training paths for 3 steps each: every kernel launched on every
     step, no overflow, gradients as in phase 6
 14. kernel 7 (dense_hit) against its plain version on the inputs the
     pallas paths hand it: c3's 1,048,576 primary rays, the OBB world's
     primary rays and both sets of depth-1 children, zero-direction rays
     (as total internal reflection hands them on) from inside every
     surface of the OBB frame, a cut of 65,536 c5_grid4096 rays against
     all 4096 spheres (the chunked staging), 65,536 rays that graze 1000
     spheres (graze_dense_inputs) and 65,536 rays in warps whose lanes are
     blocked from a light by the first sphere on some lanes only
     (partial_block_inputs): equal bit for bit
 15. the pallas forward paths for 3 frames each (c3 depth 0, the OBB world
     at depth 0 and 1): dense_hit launched once per depth-0 frame and 3
     times per depth-1 frame, a finite image within 1/255 of the plain
     versions' on >= 99.9% of pixels
 16. their frame and training step timed as in phases 5 and 7, and kernel
     7 beside its plain version and its bound at c3 and the OBB world (in
     turns with the earlier build where it is present)
 17. their training paths for 3 steps each (the OBB world also with respect
     to the boxes' positions and angles): launches, finite non-zero
     gradients that agree with the plain versions'

 18. engine 'xla' against kernel 7's 'pallas' at full size (c1, c2, c3 and
     the OBB world at depth 0 and 1): no kernel launched, 'auto' equal to
     'xla' bit for bit, >= 99.9% of pixels within 1/255 of 'pallas', and
     each engine's frame device time
 19. c4_mirror: 3 frames (kernels A, B and the shade once a frame, no
     overflow, an image within 1/255 of the plain versions' on >= 99.9% of
     pixels), frame timing, 3 training steps (kernels A, B, 4 and 5 once a
     step, gradients within 1e-3 * max|g| of the plain versions'), step
     timing, with peak device memory
 20. c1, c2 and the OBB world at depth 0 and 1 on engine 'auto': frame and
     training step timed as in phases 5 and 7, with peak device memory; no
     kernel launched
 21. engine 'autodiff' (autograd through the chunked object scan) against
     the analytic backward of 'xla': per leaf within 1e-3 * max|g|, on the
     OBB world at depth 0 and 1 and on c4_mirror at 1024x1024 (AUTODIFF_HW),
     with each engine's peak device memory
 22. glass_stack_depth4 (bench.py:317-385): the OBB and glass world at
     1024x1024, depth 4 (31 casts a pixel), render(bounce='stack') and
     the tree on 'xla' (no launch) and 'pallas' (dense_hit 31 times a
     frame, 62 a forward+backward: the checkpointed steps recompute), each
     image within 1/255 of the others on >= 99.9% of pixels, frame and
     forward+backward (w.r.t. spheres.center, boxes.position,
     materials.diffuse) timed in 3 windows with device time and peak
     memory above the resident, stack gradients within 1e-3 * max|g| of
     the tree's
 23. glass4096_stack_culled (bench.py:403-441): 4096 glass spheres at
     1024x1024, depth 4, culled_pallas with suggest_stack_cull_config
     (headroom 2, Ks = N): 0 overflow, the launches a frame of kernel 2
     (cold and hot), B and 6 as the code counts them, the image within
     1/255 of the 'pallas' stack over all spheres on >= 99.9% of pixels,
     kernels 2 (cold and hot) and B bit for bit against their plain
     versions on a deep step's inputs (TIR rays included), cut as in phase
     10; the frame timed in 2 windows of 3, and one forward+backward
 24. the culled stack on a 1024-sphere glass grid (512x512, depth 2, a
     spec no list can overflow, kernel 6 running): image within 1/255 of
     the plain versions' and of 'pallas' on >= 99.9% of pixels, gradients
     within 1e-3 * max|g| of the plain versions' (reported against
     'pallas' and 'xla': the centers' gradient of refracting glass is
     singular at grazes; see the phase); render(mirror_only=True) on
     c4_mirror at 1024x1024, depth 3, against the tree
 25. c3_grid64_culled_xla (the c3 grid, 1024x1024, 64x64 tiles, depth 0,
     engine 'culled'): no kernel launched; 3 frames and 3 training steps
     with no overflow; the image within 1/255 of the plain dense engine
     'xla''s on >= 99.9 % of pixels and the gradients of mean(img^2)
     within 1e-3 * max|g| of its ('xla' rounds the sphere quadratic and
     the normal as 'culled' does; see XLA_ROW_BLOCK), and both against
     culled_pallas reported; frame and step timed as in phases 5 and 7
     with peak memory
 26. c5_grid4096_culled_xla (2048x2048, 32x32 tiles): as 25, kernel 6
     launched once for the primary mask and once per lit light a frame and
     a step (3), equal to its plain version on every one of those masks
 27. c4_mirror4096_xlachild (1024x1024, depth 1, 32x32 tiles): a 'culled'
     parent and 'culled' children with suggest_child_cull_config(
     hot_primary=False) (kernel 6 on each cast's primary and lit-light
     masks), as 25-26 (culled_pallas with its own child spec reported)
 28. c4_mirror4096_densechild: the same parent, children on 'xla', as 27
 29. the stack on 'culled': the 1024-sphere glass grid (XLA_STACK) at
     256x256, depth 4, spec of suggest_stack_cull_config with Ks = N:
     kernel 6 on every step's masks (equal to its plain version), 3 frames
     and 3 forward+backward steps with their launches, overflow reported,
     the image within 1/255 of the 'xla' stack's, the gradients against
     it and the image and gradients against the culled_pallas stack
     reported (the glass grid's centers' gradient is singular, see 24),
     frame and step timed
 30. the training extras, the reference's config 5 fit
     (scripts/c5_fit_acceptance.py, ported as scripts/c5_fit_torch.py) on
     c5's scene (4096 spheres): its soft multi-view step (3 views orbited
     0 and +-45 degrees, train/inverse.make_train_step with FitConfig.soft
     and a tuple of soft specs from suggest_soft_cull, headroom 2) at
     512x512 (16x16 tiles, bw 0.5, gamma 0.6) and 2048x2048 (32x32 tiles,
     bw 0.09, gamma 0.1): kernel 6 launched 3 times a step (one soft mask
     a view) and equal to its plain version on every mask, no overflow,
     3 windows of chained steps under set_sync_debug_mode("error"), the
     step's device time and its peak memory above the resident, kernel 6
     timed on a soft mask beside its plain version and its bound; on one
     view at 512x512, over the 4x4 middle tiles, the culled soft image and
     gradients against the dense soft pass and the plain compaction
 31. a checkpointed hard stage: the reference's final stage (engine
     'culled', suggest_cull_config(hot=False, headroom 2), 2048x2048):
     an uninterrupted fit, a fit saving every 2 steps and a fresh fit from
     the same directory that restores the saved step, runs only the rest
     and ends at the uninterrupted fit's parameters bit for bit (torch's
     deterministic algorithms on); then c3 'autodiff' with remat off and
     on: equal gradients, step time and peak memory reported
 32. the host surface at c3 (culled_pallas): the native encoder
     (native/libimageio.so) loads; a frame through save_png and the port's
     load_png equals to_uint8 of the tensor, and to_uint8_device equals
     to_uint8; native and Python encode and load_png timed at 1024x1024;
     utils/debug.checked_render clean, kernels A, B and 4 launched under
     it; utils/profiling.cost_analysis of a frame printed; cli fit
     --target --scene at 1024x1024 on culled_pallas, 3 Adam steps of the
     centers from a shifted scene JSON: the loss falls, kernels A, B, 4
     and 5 every step
 33. the live viewer (utils/viewer.py) at 1280x720 on culled_pallas and
     pallas, 30 frames each: published in order, the engine's kernels
     every frame, /frame.png decoded by the port's decoder equal to the
     render of the t it names (within 1/255 on >= 99.9 % of pixels if the
     cull spec was rebuilt); that render's kernel calls (kernels A, B and
     4 at the viewer's 8x8 cull tiles, kernel 7) each against its plain
     version on the same inputs, and /frame.png against the plain
     versions' image (within 1/255 on >= 99.9 % of pixels); FPS and
     encode ms a frame
 34. the tile-sharded layer: init_distributed over NCCL in a world of one
     process; render_sharded on the (1, 1) mesh equal to render bit for
     bit at c3 and c4_mirror4096 (child cull), gather_image over NCCL;
     render_tile over the coordinates of a (2, 2) mesh against the
     unsharded image (c3 bit for bit; c4_mirror4096 within 1/255 on >=
     99.9 % of pixels, each tile picking its own hot tiles); frames timed
     against the unsharded; 3 sharded SGD steps at c3 with kernels A, B, 4
     and 5 every step, gradients within 1e-3 * max|g| of the unsharded
     step's, steps timed against the unsharded; measure_scaling rows for
     one device (render and step)
Each path runs with the launch counts set to 0 just before and read just
after. The line before the last is a JSON object with one entry per kernel
launch name: its time, its plain version's, its bound (the least time the
card could take for the same work: the larger of the bytes it must move,
each input read once and each output written once, over 3.35 TB/s and its
float operations on this run's inputs over 67 TFLOP/s, both the H100 SXM's
data-sheet peaks; see BOUND_OPS) and, where one PyTorch call computes the
same function, that call's time; the redesigned kernels' rows also carry
the earlier build's time from the same run (earlier_ms, null without the
copy). The last line is {"ok": true, "device":
{...}}. Without a CUDA device it exits with code 1 and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

H = W = 1024
TILE = (64, 64)
FRAMES = 3
WINDOWS, WINDOW_FRAMES = 3, 10
# discrete outputs (winner ids, inside flags, slots, occlusion bits) may
# differ between a kernel and its plain version on at most this share of
# rays: both round every op the same way, but rsqrtf and the float64
# emulation of fmaf in the plain version can still flip a tangent graze
DISCRETE_SHARE = 1e-4
# on rays whose discrete outputs agree: t as the reference's own test of
# its kernels (rtol 5e-5, atol 1e-4); unit normals to 1e-3
T_RTOL, T_ATOL, N_ATOL = 5e-5, 1e-4, 1e-3
# shade: same chain in the same order; rsqrtf/expf/logf round differently
# from PyTorch's own kernels by a few ulp, amplified by shininess up to 64
SHADE_ATOL = 2e-5
# shade backward: the same chain again, walked backwards; the forward's few
# ulp reach the cotangents through val * shininess / cos_phi and the
# normalize VJPs, so a per-ray cotangent is held to 1e-4 of its output's
# largest magnitude; a ray may differ by more only where a strict gate sits
# on a tie (at most DISCRETE_SHARE of rays). The light cotangents are sums
# over 1,048,576 rays in another order (per block of 256 rays, then over
# blocks; one torch.sum in the plain version): 1e-3 of their largest.
BWD_RAY_TOL, BWD_LIGHT_TOL = 1e-4, 1e-3
# training step, kernels vs plain versions: per leaf, 1e-3 of max|g| (the
# survivor scatters run as float atomics in an order that changes per run)
GRAD_TOL = 1e-3
STEPS, STEP_LR = 3, 1e-7
FIT = dict(side=4, hw=128, tile=32, steps=20, lr=2e-2)
BWD_NAMES = ("g_mat", "g_lpos", "g_lamb", "g_ldiff", "g_lspec", "g_dirs",
             "g_p", "g_n")
# the 4096-object paths: builtin config -> (cull tile side, the kernels
# each of its frames launches)
PATHS_4096 = {
    "c5_grid4096": (32, ("primary_hit", "shadow_occlusion",
                         "shadow_occlusion_hot", "phong_fused",
                         "compact_mask")),
    "c4_mirror4096": (32, ("primary_hit", "primary_hit_ray",
                           "primary_hit_hot", "shadow_occlusion",
                           "shadow_occlusion_hot", "phong_fused",
                           "compact_mask")),
}
# kernel 2 against its plain version: the hottest and some cold tiles
CUT_HOT, CUT_COLD = 8, 24
# the dense engine's paths: name -> (scene, height, width, depth); the OBB
# world at the time and size of the reference's animated_obb_720p row
OBB_TIME, OBB_HW = 1.2, (720, 1280)
DENSE_PATHS = {"c3_grid64": ("c3", 1024, 1024, 0),
               "obb": ("obb", *OBB_HW, 0),
               "obb_depth1": ("obb", *OBB_HW, 1)}
OBB_TRAINABLE = ("spheres.center", "spheres.radius", "materials.diffuse",
                 "boxes.position", "boxes.angles")
# kernel 7 at 4096 spheres: a cut of this many c5_grid4096 rays
C5_CUT = 65536
# phase 21: the side of the c4_mirror image whose 'autodiff' tape is held
# (every chunk's (R, 64) temporaries stay alive for the backward): 4.17 GiB
# at 512x512 on the H100, so about 17 GiB at the full 1024x1024, which fits
AUTODIFF_HW = 1024
# an earlier version of the redesigned kernels' sources (EARLIER_SOURCES
# and common.cuh), put there by hand (the directory is git-ignored): where
# it is present, phases 5, 12 and 16 time it beside the current kernels, in
# turns
EARLIER_CSRC = Path(__file__).resolve().parent / "earlier_csrc"
EARLIER_SOURCES = ("primary_hit.cu", "dense_hit.cu", "shadow_occlusion.cu",
                   "compact_mask.cu")
EARLIER_FUNCTIONS = ("oglrt_primary_hit", "oglrt_primary_hit_ray",
                     "oglrt_dense_hit", "oglrt_compact_mask")
# the earlier kernel 3 (before the hot pairs): 8-column sphere rows, sphere
# occlusion and box-or-plane occlusion in two (T, L, P) outputs
EARLIER_SHADOW_SIGNATURE = [ctypes.c_void_p] * 3 + [ctypes.c_uint] + [
    ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
# the stack bounce engine (phases 22-24): the depth and size of the
# reference's glass rows (bench.py:317-441), the calls a timing window
# holds, the leaves of glass_stack_depth4's step (bench.py:355-363), the
# culled stack's gradient check and the mirror chain's depth
STACK_DEPTH, STACK_HW, STACK_TILE = 4, 1024, 32
STACK_FRAMES, STACK_STEPS = 3, 2
STACK_TRAINABLE = ("spheres.center", "boxes.position", "materials.diffuse")
GLASS_GRAD = dict(side=32, hw=512, depth=2)
MIRROR_DEPTH = 3
# the XLA culled engine 'culled' (phases 25-28): the reference's rows
# (bench.py:466-488) -> (builtin config, cull tile side, the children:
# None at depth 0, "culled" on the culled path with a child spec sized
# hot_primary=False, "dense" on 'xla'); and the culled stack on 'culled'
# (phase 29; the reference has no row for it): phase 24's 1024-sphere glass
# grid at depth 4, cut to 256x256 (each of its 31 casts tests 65,536 rays
# against dense lists of all 1024 spheres in plain PyTorch)
XLA_CELLS = {"c3_grid64_culled_xla": ("c3_grid64", 64, None),
             "c5_grid4096_culled_xla": ("c5_grid4096", 32, None),
             "c4_mirror4096_xlachild": ("c4_mirror4096", 32, "culled"),
             "c4_mirror4096_densechild": ("c4_mirror4096", 32, "dense")}
XLA_STACK = dict(side=32, hw=256, depth=4)
# 'culled' rounds the sphere quadratic as the reference's XLA engines do,
# every op once; culled_pallas as the Mosaic kernel, with fused
# multiply-adds. At tangent grazes on small, distant spheres the two take
# another t (and shade another normal) on 0.4-0.8 % of c5's and
# c4_mirror4096's pixels, so each 'culled' cell's image is held to the
# plain dense engine 'xla' (the same arithmetic, every ray against every
# sphere, in blocks of this many image rows) and reported against
# culled_pallas
XLA_ROW_BLOCK = 256
# and each gradient to the engine that computes it as 'culled' does: the
# spheres' to 'xla' (the same quadratic, normal and winner replay), the
# materials' to culled_pallas (the same survivor routing of the material
# rows: per tile, then into the table; 'xla' adds every ray's row into the
# table at once, and those float32 sums of millions of rays differ by
# 3.5e-3 of max|g| at c5); the other engine's reported
XLA_HELD_GRADS = {"spheres": "'xla'", "materials": "culled_pallas"}
# the training extras (phases 30-31), the reference's config 5 fit
# (scripts/c5_fit_acceptance.py): the soft step's cells, the first and last
# of its soft stages, as (res, tile side, bw, gamma, geo lr, photo lr, the
# steps counted, which warm the timing, the steps a timing window holds; a
# 2048x2048 step takes 7.3 s on the H100); the view, size and cut
# of middle tiles where the culled soft pass is held to the dense one and to
# the plain compaction; the culled pass keeps every sphere above the alpha
# cut, so it equals the dense pass to rounding (1.2e-7 on the image, 3e-6
# of max|g|, measured on the CPU)
SOFT_CELLS = ((512, 16, 0.50, 0.60, 1.2e-2, 3.0e-2, 2, 1),
              (2048, 32, 0.09, 0.10, 2.0e-3, 6.0e-3, 1, 1))
SOFT_CHECK_RES, SOFT_CHECK_SIDE = 512, 4
SOFT_DENSE_ATOL, SOFT_DENSE_GRAD_TOL = 1e-5, 1e-4
# the checkpointed hard stage: (steps uninterrupted, steps of the first run,
# checkpoint_every); the fresh fit resumes to the first number (a step
# takes 2.7 s at 2048x2048 under torch's deterministic algorithms)
CKPT_STEPS = (4, 2, 2)
# remat on 'autodiff': the same ops recomputed; the gathers' backward adds
# may run in another order on the card
REMAT_TOL = 1e-6
# the host surface and the sharded layer (phases 32-34): fit --target's
# starting scene (every center moved by this) and its Adam learning rate;
# the viewer's frame size (the CLI's default), frames and cull tile (the
# CLI's default); the mesh whose tiles one process renders in turn
FIT_TARGET_SHIFT, FIT_TARGET_LR = (0.15, -0.1, 0.0), 2e-2
VIEW_HW, VIEW_FRAMES, VIEW_TILE = (720, 1280), 30, 8
SHARD_MESH = (2, 2)
# H100 SXM data-sheet peaks: float32 outside the tensor cores, HBM3
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
# Float operations per unit of work, counted from each kernel's source
# (csrc/): + - * / sqrt min max as one, fma as two; compares, selects,
# loads and the special functions' extra steps are not counted. The units:
# "ray" per ray of the launch; "sphere", "box", "plane" per (ray, object)
# test of the closest hit; "light" per (ray, light) of a shadow or shade
# pass; "s_sphere", "s_box", "s_plane" per (ray, light, object) test of an
# occlusion pass. A sphere test of kernels A, 2 and 7 is charged its
# quadratic up to the discriminant ("sphere", "s_sphere"), and its square
# root, both roots and their min and max only where this run's data gives
# a discriminant >= 0 ("sphere_root", "s_sphere_root"): a miss needs no
# root. The occlusion of kernels 7 and B is charged the tests a segment
# needs, in table order (kernel B: the pair's survivor spheres, or on a hot
# pair every sphere of the scene, "s_hot_sphere"; its boxes; the planes) up
# to its first blocker, where the OR is decided. Kernel B's first launch
# takes the survivor spheres, boxes and planes, its hot launch the hot
# pairs' spheres; its sphere test takes r * r on a survivor row and finds
# it staged on a hot pair, and its loop-invariant 4 qa and 2 qa are not
# charged.
BOUND_OPS = {
    "primary_hit": dict(ray=19, sphere=10, sphere_root=8, box=40, plane=7),
    "primary_hit_ray": dict(ray=19, sphere=19, sphere_root=8, box=58,
                            plane=13),
    "primary_hit_hot": dict(ray=19, sphere=19, sphere_root=8, box=58,
                            plane=13),
    "shadow_occlusion": dict(light=8, s_sphere=20, s_box=58, s_plane=13),
    "shadow_occlusion_hot": dict(light=8, s_hot_sphere=19),
    "phong_fused": dict(ray=25, light=90),
    "phong_shade_bwd": dict(ray=60, light=270),
    "compact_mask": dict(mask=1),
    "dense_hit": dict(ray=31, sphere=19, sphere_root=8, box=58, plane=12,
                      light=10, s_sphere=19, s_sphere_root=8, s_box=58,
                      s_plane=12),
}
# (ray, object) pairs per chunk where the bound counts tests on the card
PAIR_CHUNK = 1 << 24


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"FAIL: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Capture:
    """Record the arguments each kernel wrapper is called with (detached
    from autograd), so that a kernel and its plain version can be compared
    on the main paths' own inputs: ``args`` keeps the last call of each
    wrapper (kernel 2's hot launch under ``primary_hit_hot``), ``calls``
    every call of ``compact_mask``, ``log`` every call of every wrapper and
    of ``culled._top_tiles`` (which picks the hot tiles) in order, as
    (name, args, kwargs)."""

    def __init__(self, culled, shade, accel):
        self.targets = [(culled, "primary_hit"), (culled, "primary_hit_ray"),
                        (culled, "shadow_occlusion"),
                        (shade, "phong_fused"), (shade, "phong_shade_bwd"),
                        (accel, "compact_mask"), (culled, "compact_mask"),
                        (culled, "_top_tiles")]
        self.args, self.kwargs = {}, {}
        self.calls, self.log = [], []

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n in self.targets]
        for (mod, name), fn in zip(self.targets, self.saved):
            def spy(*a, _fn=fn, _name=name, **kw):
                a_ = tuple(x.detach() if hasattr(x, "detach") else x
                           for x in a)
                self.log.append((_name, a_, kw))
                if _name == "compact_mask":
                    self.calls.append(a_)
                else:
                    key = ("primary_hit_hot" if kw.get("tile_ids") is not None
                           else _name)
                    self.args[key], self.kwargs[key] = a_, kw
                return _fn(*a, **kw)
            setattr(mod, name, spy)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.targets, self.saved):
            setattr(mod, name, fn)


def primary_hit_ray_plain(culled):
    """Kernel 2's plain version with the wrapper's signature."""
    def plain(dirs, origins, *a, tile_ids=None):
        return culled.primary_hit_plain(dirs, *a, origins=origins,
                                        tile_ids=tile_ids)
    return plain


class PlainVersions:
    """Route the renderer, forward and backward, through the plain PyTorch
    versions on the card."""

    def __init__(self, culled, shade, shading, accel):
        from openglraytracer_tpu_torch.ops import dense
        self.swaps = [(dense, "dense_hit", dense.dense_hit_plain),
                      (culled, "primary_hit", culled.primary_hit_plain),
                      (culled, "primary_hit_ray",
                       primary_hit_ray_plain(culled)),
                      (culled, "shadow_occlusion",
                       culled.shadow_occlusion_plain),
                      (shade, "phong_shade", shading.phong_core),
                      (shade, "phong_shade_bwd", shade.phong_shade_bwd_plain),
                      (accel, "compact_mask", accel.compact_mask_plain),
                      (culled, "compact_mask", accel.compact_mask_plain)]

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n, _ in self.swaps]
        for mod, name, fn in self.swaps:
            setattr(mod, name, fn)

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.swaps, self.saved):
            setattr(mod, name, fn)


def compare_primary(torch, k, p, what, name="primary_hit", exact=False):
    """Kernel A (2) outputs k vs plain p: (mismatch share, max abs err).
    exact: no discrete mismatch at all."""
    t_k, n_k, ins_k, mat_k, gid_k, slot_k = k
    t_p, n_p, ins_p, mat_p, gid_p, slot_p = p
    agree = ((ins_k == ins_p) & (mat_k == mat_p) & (gid_k == gid_p)
             & (slot_k == slot_p) & ((t_k < 1e4) == (t_p < 1e4)))
    share = 1.0 - float(agree.float().mean())
    live = agree & (t_p < 1e4)
    dt = (t_k - t_p).abs()[live]
    dn = (n_k - n_p).abs()[live]
    t_bad = int((dt > T_ATOL + T_RTOL * t_p.abs()[live]).sum())
    n_bad = int((dn > N_ATOL).sum())
    err = max(float(dt.max()) if dt.numel() else 0.0,
              float(dn.max()) if dn.numel() else 0.0)
    log(f"  {name} [{what}]: discrete mismatches {share:.2e} of "
        f"{t_k.numel()} rays, t/n out of tolerance {t_bad}/{n_bad}, "
        f"max |t|,|n| err {err:.3e}")
    check((share == 0.0 if exact else share <= DISCRETE_SHARE)
          and t_bad == 0 and n_bad == 0,
          f"{name} kernel disagrees with its plain version ({what})")
    return share, err


def compare_shadow(torch, k, p, what):
    """Kernel B's (R, L) occlusion k vs plain p: both round every op alike,
    so every bit must agree. Returns (mismatch share, max abs err)."""
    share = float((k != p).float().mean())
    log(f"  shadow_occlusion [{what}]: occlusion mismatches {share:.2e} of "
        f"{k.numel()} (ray, light) pairs; occluded share per light "
        f"{[round(float(x), 4) for x in p.float().mean(dim=0)]}")
    check(share == 0.0,
          f"shadow_occlusion kernel disagrees with its plain version ({what})")
    return share, float(share > 0.0)


def compare_shade(torch, k, p, what):
    err = float((k - p).abs().max())
    log(f"  phong_fused [{what}]: max |rgb| err {err:.3e} "
        f"(tolerance {SHADE_ATOL})")
    check(err <= SHADE_ATOL,
          f"phong_fused kernel disagrees with its plain version ({what})")
    return err


def compare_shade_bwd(torch, k, p, what):
    """Kernel 5 outputs k vs plain p: per output, the max abs error over
    max|output|; per ray, whether any of its cotangents (material row,
    direction, point, normal) differs by more than BWD_RAY_TOL of its
    output's largest magnitude. Returns the max abs error over outputs."""
    rel, bad, max_abs = {}, None, 0.0
    for name, a, b in zip(BWD_NAMES, k, p):
        scale = max(float(b.abs().max()), 1e-30)
        err = (a - b).abs()
        max_abs = max(max_abs, float(err.max()) if err.numel() else 0.0)
        rel[name] = float(err.max()) / scale if err.numel() else 0.0
        if name in ("g_lpos", "g_lamb", "g_ldiff", "g_lspec"):
            check(rel[name] <= BWD_LIGHT_TOL,
                  f"phong_shade_bwd {name} disagrees ({what})")
            continue
        ray_bad = (err > BWD_RAY_TOL * scale).reshape(err.shape[0], -1) \
            .any(dim=1)
        bad = ray_bad if bad is None else bad | ray_bad
    share = float(bad.float().mean())
    log(f"  phong_shade_bwd [{what}]: max |err| / max |output| "
        + ", ".join(f"{n} {v:.2e}" for n, v in rel.items())
        + f"; rays beyond {BWD_RAY_TOL:g} of scale: {share:.2e} of "
        f"{bad.numel()}")
    check(share <= DISCRETE_SHARE,
          f"phong_shade_bwd kernel disagrees with its plain version ({what})")
    return max_abs


def _roots(torch, d, c, rr, live, o=None):
    """Sphere tests of rays d (B, P, 3) from origins o (B, P, 3) against
    rows c (B or 1, K, 3), rr (B or 1, K) whose discriminant is >= 0, of
    the tests live (B or 1, P or 1, K) and the rays with d.d > 0. Without
    o the rows are shared-mode rows (c = o0 - centre, rr = qc)."""
    n_b, n_p, n_k = d.shape[0], d.shape[1], c.shape[1]
    step = max(1, PAIR_CHUNK // max(1, n_p * n_k))
    total = 0
    for b in range(0, n_b, step):
        def cut(x):
            return x if x.shape[0] == 1 else x[b:b + step]

        db = d[b:b + step, :, None, :]
        oc, q = cut(c)[:, None], cut(rr)[:, None]
        if o is not None:
            oc = o[b:b + step, :, None, :] - oc
            q = (oc * oc).sum(-1) - q
        qa = (db * db).sum(-1)
        qb = 2.0 * (db * oc).sum(-1)
        ok = (qb * qb - 4.0 * qa * q >= 0.0) & (qa > 1e-12)
        total += int((ok & cut(live)).sum())
    return total


def _dense_units(torch, args, outs):
    """Kernel 7's units of work on these inputs and its outputs (t and n
    give each shadow segment's start)."""
    from openglraytracer_tpu_torch.ops import dense

    o, d, sph, box, pln, lights = args
    t, n = outs[0], outs[1]
    r, n_l = o.shape[0], lights.shape[0]
    n_s, n_b, n_p = sph.shape[0], box.shape[0], pln.shape[0]
    n_obj = n_s + n_b + n_p
    u = dict(ray=r, sphere=r * n_s, box=r * n_b, plane=r * n_p,
             light=r * n_l, sphere_root=0, s_sphere=0, s_sphere_root=0,
             s_box=0, s_plane=0)
    c, rr = sph[None, :, :3], (sph[:, 3] * sph[:, 3])[None]
    every = torch.ones((1, 1, n_s), dtype=torch.bool, device=o.device)
    j = torch.arange(n_s, device=o.device)
    srow, brow, prow = sph.T[:, None, :], box.T[:, None, :], pln.T[:, None, :]
    step = max(1, PAIR_CHUNK // max(1, n_obj))
    for a in range(0, r, step):
        ob, db = o[a:a + step], d[a:a + step]
        u["sphere_root"] += _roots(torch, db[None], c, rr, every, ob[None])
        ts = torch.where(t[a:a + step] < 1e4, t[a:a + step], 0.0)[:, None]
        p = ob + ts * db
        s = p + 0.01 * n[a:a + step]
        sx, sy, sz = (s[:, k:k + 1] for k in range(3))
        for li in range(n_l):
            tl = lights[li] - p
            vx, vy, vz = (tl[:, k:k + 1] for k in range(3))
            qa = (tl * tl).sum(-1, keepdim=True)
            inv = 0.5 / qa.clamp(min=1e-12)
            t_s, ok_s, _, _ = dense._sphere_roots(srow, sx, sy, sz, vx, vy,
                                                  vz, qa, inv)
            blocked = [ok_s & (t_s < 1.0)]
            if n_b:
                t_b, ok_b, _, _, _ = dense._box_slab(brow, sx, sy, sz, vx,
                                                     vy, vz)
                blocked.append(ok_b & (t_b < 1.0))
            if n_p:
                t_p, nd = dense._plane_t(prow, sx, sy, sz, vx, vy, vz)
                blocked.append((nd.abs() > 1e-9) & (t_p > 0.0) & (t_p < 1.0))
            blk = torch.cat(blocked, dim=1)
            # the tests up to and including the first blocker, else all
            need = torch.where(blk.any(dim=1), blk.int().argmax(dim=1) + 1,
                               n_obj)
            u["s_sphere"] += int(need.clamp(max=n_s).sum())
            u["s_box"] += int((need - n_s).clamp(0, n_b).sum())
            u["s_plane"] += int((need - n_s - n_b).clamp(0, n_p).sum())
            u["s_sphere_root"] += _roots(
                torch, tl[None], c, rr, (j[None, :] < need[:, None])[None],
                s[None])
    return u


def _first_needed(torch, blk, count):
    """Tests up to and including the first blocker of blk (..., K) in row
    order, else all count of them."""
    if blk.shape[-1] == 0:
        return torch.zeros(blk.shape[:-1], dtype=torch.long,
                           device=blk.device)
    return torch.where(blk.any(dim=-1), blk.int().argmax(dim=-1) + 1, count)


def _shadow_units(torch, args, kwargs, launch):
    """Units of work of kernel B's launch ("shadow_occlusion", the first, or
    "shadow_occlusion_hot") on these inputs: per ray and lit light, the
    tests in table order up to and including the first blocker: the pair's
    survivor spheres (none where qa <= 1e-12), or every sphere of the scene
    on a hot pair (the hot launch's); then the pair's boxes; then the
    planes (the first launch's)."""
    so, hp, lights, light_on, ssph, sbox, pln, cnt, tile_p = args[:9]
    hot_ids = args[9] if len(args) > 9 else kwargs.get("hot_ids")
    spheres = args[10] if len(args) > 10 else kwargs.get("spheres")
    n_t = cnt.shape[0]
    so_t, hp_t = so.reshape(n_t, tile_p, 3), hp.reshape(n_t, tile_p, 3)
    u = dict(light=0, s_sphere=0, s_hot_sphere=0, s_box=0, s_plane=0)
    hot_launch = launch == "shadow_occlusion_hot"
    for li in (j for j, on in enumerate(light_on) if on):
        n_hot = hot_ids.shape[1] if hot_ids is not None else 0
        u["light"] += (n_hot if hot_launch else n_t) * tile_p
        is_hot = torch.zeros(n_t, dtype=torch.bool, device=so.device)
        groups = []
        if hot_ids is not None:
            ids = hot_ids[li].long()
            is_hot[ids] = True
            groups.append(("s_hot_sphere", ids, spheres[None],
                           torch.full_like(ids, spheres.shape[0])))
        cold = torch.nonzero(~is_hot).flatten()
        groups.append(("s_sphere", cold, ssph[:, li],
                       cnt[cold, li, 0].clamp(min=0)))
        for unit, tiles, rows, counts in groups:
            if hot_launch and unit == "s_sphere":
                continue
            k_rows = rows.shape[1]
            step = max(1, PAIR_CHUNK // max(1, tile_p * max(k_rows, 1)))
            j = torch.arange(k_rows, device=so.device)
            for a in range(0, tiles.numel(), step):
                t = tiles[a:a + step]
                s = so_t[t][..., None]                    # (B, P, 3, 1)
                tl = lights[li][None, None, :, None] - hp_t[t][..., None]
                qa = (tl * tl).sum(2)                     # (B, P, 1)
                qa_ok = qa[..., 0] > 1e-12
                c = rows if rows.shape[0] == 1 else rows[t]
                soc = s - c.transpose(1, 2)[:, None, :3]  # (B, P, 3, K)
                qb = 2.0 * (tl * soc).sum(2)
                qcs = (soc * soc).sum(2) - c[:, None, :, 3] ** 2
                f_end = qa + qb + qcs
                blk = torch.where(qcs < 0.0, f_end > 0.0,
                                  (f_end < 0.0) | ((qb * qb >= 4.0 * qa * qcs)
                                                   & (qb < 0.0)
                                                   & (-qb < 2.0 * qa)))
                n_ok = counts[a:a + step][:, None]
                blk = blk & (j < n_ok[..., None])
                need = torch.where(qa_ok, _first_needed(torch, blk, n_ok), 0)
                u[unit] += int(need.sum())
                if hot_launch:
                    continue
                open_ = ~(blk.any(dim=-1) & qa_ok)        # (B, P)
                # the pair's boxes, then the planes, where no sphere blocked
                bx = sbox[t, li]                          # (B, Kb, 24)
                nb = cnt[t, li, 1].clamp(max=bx.shape[1])[:, None]
                blk_b = _box_blocks(torch, bx, s[..., 0], tl[..., 0]) \
                    & (torch.arange(bx.shape[1], device=so.device)
                       < nb[..., None])
                u["s_box"] += int(torch.where(
                    open_, _first_needed(torch, blk_b, nb), 0).sum())
                open_ = open_ & ~blk_b.any(dim=-1)
                nd = tl[..., 0] @ pln[:, :3].T           # (B, P, n_pln)
                no = s[..., 0] @ pln[:, :3].T
                tp = (pln[:, 3] - no) / torch.where(
                    nd.abs() < 1e-12, torch.where(nd < 0, -1e-12, 1e-12), nd)
                blk_p = (nd.abs() > 1e-9) & (tp > 0.0) & (tp < 1.0)
                u["s_plane"] += int(torch.where(
                    open_, _first_needed(torch, blk_p, pln.shape[0]), 0).sum())
    return u


def _box_blocks(torch, bx, s, tl):
    """(B, P, Kb) box blocks of segments s + u tl (B, P, 3) against box rows
    (B, Kb, 24) [mins maxs pos rot(9) valid]."""
    rows = bx[:, None]                                   # (B, 1, Kb, 24)
    rot = rows[..., 9:18].unflatten(-1, (3, 3))          # (B, 1, Kb, 3, 3)
    w = s[:, :, None, :] - rows[..., 6:9]                # (B, P, Kb, 3)
    ro = (rot * w[..., :, None]).sum(-2)                 # R^T w
    rd = (rot * tl[:, :, None, :, None]).sum(-2)
    inv = 1.0 / torch.where(rd.abs() < 1e-12,
                            torch.where(rd < 0, -1e-12, 1e-12), rd)
    ta, tb = (rows[..., 0:3] - ro) * inv, (rows[..., 3:6] - ro) * inv
    t1 = torch.minimum(ta, tb).amax(-1)
    t2 = torch.maximum(ta, tb).amin(-1)
    ok = (t1 < t2) & (t2 > 0.0) & (rows[..., 18] > 0.5)
    t = torch.where(ok & (t1 < 0.0), t2, t1)
    return ok & (t > 0.0) & (t < 1.0)


def _work_units(torch, name, args, kwargs, outs):
    """Units of work of one kernel call on these inputs (see BOUND_OPS);
    survivor-list kernels count the tests their trip counts ask for, and
    the sphere roots those tests' data need."""
    def total(cnt, cap):
        return int(cnt.clamp(max=cap).sum())

    if name in ("primary_hit", "primary_hit_ray", "primary_hit_hot"):
        per_ray = name != "primary_hit"
        dirs, sph, box, pln, cnt, tile_p = (
            (args[0],) + tuple(args[2:7]) if per_ray else args[:6])
        r = cnt.shape[0] * tile_p
        d = dirs.reshape(-1, tile_p, 3)
        o = args[1].reshape(-1, tile_p, 3) if per_ray else None
        tile_ids = kwargs.get("tile_ids")
        if tile_ids is not None:
            d, o = d[tile_ids.long()], o[tile_ids.long()]
        k = torch.arange(sph.shape[1], device=sph.device)
        live = (k[None, :] < cnt[:, :1]) & (sph[..., 6] > 0.5)
        return dict(ray=r, sphere=total(cnt[:, 0], sph.shape[1]) * tile_p,
                    sphere_root=_roots(torch, d, sph[..., :3], sph[..., 3],
                                       live[:, None], o),
                    box=total(cnt[:, 1], box.shape[1]) * tile_p,
                    plane=r * pln.shape[0])
    if name in ("shadow_occlusion", "shadow_occlusion_hot"):
        units = _shadow_units(torch, args, kwargs, name)
        return {k: v for k, v in units.items() if k in BOUND_OPS[name]}
    if name in ("phong_fused", "phong_shade_bwd"):
        r, n_lights = args[0].shape[0], args[1].shape[0]
        return dict(ray=r, light=r * n_lights)
    if name == "compact_mask":
        return dict(mask=args[0].numel())
    if name == "dense_hit":
        return _dense_units(torch, args, outs)
    raise KeyError(name)


def _bytes_moved(torch, name, args, kwargs, outs):
    """Bytes one kernel call must move: each input it reads, read once, and
    each output written once. Of a padded survivor-list tensor (..., K,
    cols) only the rows the trip counts reach are read, min(cnt, K) per
    tile (per tile and lit light for the shadow rows); the hot launch reads
    its one global table as far as its longest count reaches, and the rays
    of its hot tiles only."""
    def nb(x):
        return x.numel() * x.element_size()

    def rows(tab, cnt):
        return (int(cnt.clamp(max=tab.shape[-2]).sum()) * tab.shape[-1]
                * tab.element_size())

    out_bytes = sum(nb(x) for x in outs if isinstance(x, torch.Tensor))
    if name == "primary_hit":
        dirs, sph, box, pln, cnt, _ = args
        return out_bytes + nb(dirs) + rows(sph, cnt[:, 0]) + rows(
            box, cnt[:, 1]) + nb(pln) + nb(cnt)
    if name in ("primary_hit_ray", "primary_hit_hot"):
        dirs, origins, sph, box, pln, cnt, tile_p = args[:7]
        tile_ids = kwargs.get("tile_ids")
        if tile_ids is None:
            return out_bytes + nb(dirs) + nb(origins) + rows(
                sph, cnt[:, 0]) + rows(box, cnt[:, 1]) + nb(pln) + nb(cnt)
        hot_rays = 2 * cnt.shape[0] * tile_p * 3 * dirs.element_size()
        return out_bytes + hot_rays + rows(sph, cnt[:, 0].max()) + rows(
            box, cnt[:, 1].max()) + nb(pln) + nb(cnt) + nb(tile_ids)
    if name == "shadow_occlusion":
        so, hp, lights, light_on, ssph, sbox, pln, cnt, _ = args[:9]
        lit = [j for j, on in enumerate(light_on) if on]
        return out_bytes + nb(so) + nb(hp) + nb(lights) + sum(
            rows(ssph[:, j], cnt[:, j, 0].clamp(min=0))
            + rows(sbox[:, j], cnt[:, j, 1]) for j in lit) + nb(pln) + nb(
                cnt)
    if name == "shadow_occlusion_hot":
        # the rays of the hot tiles, the global sphere table and the hot ids
        # once; the bits it sets are not counted
        so, hp, lights, light_on, _, _, _, _, tile_p = args[:9]
        hot_ids = args[9] if len(args) > 9 else kwargs["hot_ids"]
        spheres = args[10] if len(args) > 10 else kwargs["spheres"]
        lit = [j for j, on in enumerate(light_on) if on]
        tiles = int(torch.unique(hot_ids[lit]).numel())
        return (2 * tiles * tile_p * 3 * so.element_size() + nb(lights)
                + nb(spheres) + nb(hot_ids))
    # the other kernels read every element of every tensor argument
    return out_bytes + sum(nb(x) for x in list(args) + list(kwargs.values())
                           if isinstance(x, torch.Tensor))


def bound(torch, name, fn, args, kwargs=None):
    """The least time the card could take for one call of kernel ``name``
    on these inputs: (ms, "bytes" or "operations", bytes, operations). The
    bytes are those _bytes_moved counts; the operations are BOUND_OPS times
    this call's units of work."""
    kwargs = kwargs or {}
    outs = fn(*args, **kwargs)
    nbytes = _bytes_moved(torch, name, args, kwargs, outs)
    ops = sum(BOUND_OPS[name][u] * n
              for u, n in _work_units(torch, name, args, kwargs,
                                      outs).items())
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def earlier_library(kernels):
    """(library, nvcc's output) of the earlier kernels built from
    EARLIER_CSRC, or (None, "") where that copy is absent."""
    if not (EARLIER_CSRC / EARLIER_SOURCES[0]).exists():
        return None, ""
    path, build_log = kernels.build(EARLIER_CSRC, EARLIER_SOURCES)
    lib = kernels.load(path, EARLIER_FUNCTIONS)
    lib.oglrt_shadow_occlusion.argtypes = EARLIER_SHADOW_SIGNATURE
    lib.oglrt_shadow_occlusion.restype = ctypes.c_int
    return lib, build_log


def earlier_shadow(torch, accel, lib, args, kwargs=None):
    """Kernel B's function as the earlier build computed it, on the current
    wrapper's arguments: the earlier kernel over 8-column survivor rows into
    (T, L, P) sphere and box-or-plane occlusion ("cold"), the dense pass
    accel._segment_occluded over each light's hot tiles with the override
    masks ("hot"), and both with the per-light merge and the stack, as
    ops/culled.py ran them ("both", giving the (R, L) occlusion). The rows
    are converted here, once; returns a dict of callables of no
    arguments."""
    so, hp, lights, light_on, ssph, sbox, pln, cnt, tile_p = args[:9]
    kwargs = kwargs or {}
    hot_ids, spheres = (list(args[9:11]) + [None, None])[:2]
    hot_ids = kwargs.get("hot_ids", hot_ids)
    spheres = kwargs.get("spheres", spheres)
    dev = so.device
    n_t, n_l, ks = ssph.shape[:3]
    r = ssph[..., 3:4]
    rows8 = torch.cat([ssph[..., :3], torch.nan_to_num(r, nan=0.0),
                       (~r.isnan()).to(r.dtype), torch.zeros_like(
                           ssph[..., :3])], dim=-1).contiguous()
    cnt0 = cnt.clamp(min=0).contiguous()
    mask = sum(1 << li for li, on in enumerate(light_on) if on)
    occ_s = torch.empty((n_t, n_l, tile_p), dtype=torch.bool, device=dev)
    occ_o = torch.empty_like(occ_s)

    def cold():
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.oglrt_shadow_occlusion(
            so.data_ptr(), hp.data_ptr(), lights.data_ptr(), mask,
            rows8.data_ptr(), sbox.data_ptr(), pln.data_ptr(),
            cnt0.data_ptr(), n_t, tile_p, n_l, ks, sbox.shape[2],
            pln.shape[0], occ_s.data_ptr(), occ_o.data_ptr(), stream)
        check(err == 0, f"the earlier shadow kernel failed: CUDA error {err}")

    dense = dense_hot_pass(torch, accel, args, kwargs)

    def hot():
        out = {}
        for li, occ_h in dense().items():
            ids = hot_ids[li].long()
            is_hot = torch.zeros((n_t,), dtype=torch.bool,
                                 device=dev).index_fill(0, ids, True)
            out[li] = (is_hot, torch.zeros(
                (n_t, tile_p), dtype=torch.bool,
                device=dev).index_copy(0, ids, occ_h))
        return out

    def both():
        over = hot()
        cold()
        cols = []
        for li in range(n_l):
            col_s = occ_s[:, li]
            if li in over:
                is_hot, occ_full = over[li]
                col_s = torch.where(is_hot[:, None], occ_full, col_s)
            cols.append((col_s | occ_o[:, li]).reshape(-1))
        return torch.stack(cols, dim=-1)
    return dict(cold=cold, hot=hot, both=both)


def dense_hot_pass(torch, accel, args, kwargs=None):
    """A callable of no arguments giving, per lit light with hot tiles, the
    (M, P) occlusion of its hot tiles by every sphere of the scene through
    accel._segment_occluded: the plain version of kernel B's hot launch
    (the JAX package's dense pass), on the wrapper's arguments args."""
    so, hp, lights, light_on, _, _, _, cnt, tile_p = args[:9]
    kwargs = kwargs or {}
    hot_ids, spheres = (list(args[9:11]) + [None, None])[:2]
    hot_ids = kwargs.get("hot_ids", hot_ids)
    spheres = kwargs.get("spheres", spheres)
    n_t = cnt.shape[0]
    so_t, p_t = so.reshape(n_t, tile_p, 3), hp.reshape(n_t, tile_p, 3)
    lit = ([li for li, on in enumerate(light_on) if on]
           if hot_ids is not None else [])
    every = torch.ones((1, 0 if spheres is None else spheres.shape[0]),
                       dtype=torch.bool, device=so.device)

    def run():
        out = {}
        for li in lit:
            ids = hot_ids[li].long()
            c = spheres
            out[li] = accel._segment_occluded(
                so_t[ids], p_t[ids], lights[li], c[None, :, 0],
                c[None, :, 1], c[None, :, 2], c[None, :, 3], every)
        return out
    return run


def shadow_hot_only(kernels, culled, args):
    """A callable of no arguments that launches kernel B's hot launch alone
    on the wrapper's arguments args (into a fresh output), to time it."""
    def run():
        c_args = culled._shadow_c_args(*args)
        kernels.launch("oglrt_shadow_hot", args[0].device, *c_args)
        return c_args[-1]
    return run


@contextlib.contextmanager
def using_library(kernels, lib):
    """Route the kernel wrappers' launches to library lib."""
    saved = kernels.library
    kernels.library = lambda: lib
    try:
        yield
    finally:
        kernels.library = saved


def ptxas_lines(build_log: str) -> list:
    """Each kernel's registers, shared memory and spills (nvcc -Xptxas -v)."""
    return [line.strip() for line in build_log.splitlines()
            if any(k in line for k in ("registers", "spill",
                                       "Compiling entry"))]


def log_ptxas(build_log: str, what: str) -> None:
    for line in ptxas_lines(build_log):
        log(f"  {what}: {line}")


def in_turns(torch, cur, old, turns: int = 2):
    """Device ms per call of cur(), the mean of 2 * turns timings, and
    where old is not None, of old() timed in turns with it (old, cur, cur,
    old, ...): (ms, old's ms or None, every timing)."""
    c, o = [], []
    for _ in range(turns):
        if old is not None:
            o.append(device_ms(torch, old, ()))
        c += [device_ms(torch, cur, ()), device_ms(torch, cur, ())]
        if old is not None:
            o.append(device_ms(torch, old, ()))
    return (statistics.mean(c), statistics.mean(o) if o else None,
            dict(ms=c, earlier_ms=o))


def time_turns(torch, kernels, fn, args, earlier, turns: int = 2):
    """in_turns of fn(*args) and, where earlier is a library, the same
    call with the wrappers' launches routed to it."""
    def old():
        with using_library(kernels, earlier):
            return fn(*args)
    return in_turns(torch, lambda: fn(*args),
                    old if earlier is not None else None, turns)


def device_ms(torch, fn, args, reps: int = 10) -> float:
    """Device time per call: the calls are enqueued behind a spinning
    kernel that outlasts their enqueueing, so the events bracket
    back-to-back device work only, as long as the calls' launches fit in
    the stream's queue of pending launches (about a thousand); a plain
    version of thousands of small ops is paced by the host beyond that."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)                           # host time to enqueue one call
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # spin for about twice the enqueue time (cycles at <= 2 GHz)
    torch.cuda._sleep(int(2e9 * (2.0 * host_s * reps + 0.01)))
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_windows(torch, fn, warm: int = 3, windows: int = WINDOWS,
                  frames: int = WINDOW_FRAMES):
    """Per-call ms of `windows` windows of `frames` calls under
    set_sync_debug_mode('error'), and the calls' outputs."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    per_call, outs = [], []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.set_sync_debug_mode("error")
        try:
            start.record()
            for _ in range(frames):
                outs.append(fn())
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        end.synchronize()
        per_call.append(start.elapsed_time(end) / frames)
    return per_call, outs


def box_scene(torch, device):
    """Rotated OBBs, a sphere and a plane: the box paths of A and B."""
    import numpy as np
    from openglraytracer_tpu_torch.models.scene import (
        Boxes, Planes, Spheres, make_camera, make_lights, make_materials,
        make_scene)
    rng = np.random.default_rng(7)

    def t(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    boxes = Boxes(mins=t([[-0.6, -0.4, -0.5], [-1.0, -0.2, -0.3],
                          [-0.3, -0.3, -0.9]]),
                  maxs=t([[0.6, 0.4, 0.5], [1.0, 0.2, 0.3],
                          [0.3, 0.3, 0.9]]),
                  position=t([[-1.5, 0.0, 0.6], [1.4, 0.5, 0.4],
                              [0.0, 1.5, 1.0]]),
                  angles=t(rng.uniform(-60.0, 60.0, (3, 3))),
                  material_id=t([0, 1, 2], torch.int32))
    spheres = Spheres(center=t([[0.2, -0.8, 0.7]]), radius=t([0.6]),
                      material_id=t([1], torch.int32))
    planes = Planes(normal=t([[0.0, 0.0, 1.0]]), offset=t([-0.2]),
                    material_id=t([3], torch.int32))
    mats = make_materials([
        dict(diffuse=(0.8, 0.3, 0.2, 1.0), shininess=12.0),
        dict(diffuse=(0.2, 0.7, 0.3, 1.0), shininess=40.0),
        dict(diffuse=(0.3, 0.4, 0.9, 1.0), shininess=6.0),
        dict(diffuse=0.5, specular=0.2)], device=device)
    lights = make_lights([
        dict(position=(4.0, -5.0, 6.0), ambient=0.1, diffuse=1.0,
             specular=1.0),
        dict(position=(-5.0, 2.0, 4.0), ambient=0.05, diffuse=0.6,
             specular=0.6)], device=device)
    scene = make_scene(spheres=spheres, boxes=boxes, planes=planes,
                       materials=mats, lights=lights)
    cam = make_camera((0.0, -6.0, 2.5), angles=(-18.0, 0.0, 0.0),
                      aspect=1.0, device=device)
    return scene, cam


def train_scene(scene, trainable):
    """The scene with fresh leaf copies of the trainable columns."""
    from openglraytracer_tpu_torch.train.inverse import (apply_params,
                                                         extract_params)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in extract_params(scene, trainable).items()}
    return apply_params(scene, params), params


def run_4096(torch, dev, kernels, culled, shade, shading, accel, smi,
             earlier):
    """Phases 9-13: the 4096-object paths c5_grid4096 and c4_mirror4096.
    Returns (per-path launch counts, per-kernel (ms, plain ms), per-kernel
    max abs error, per-kernel (args, kwargs) of the timed call, the
    library call's ms, per-kernel earlier ms or None) for kernels 2 and 6,
    and kernel 3's numbers per shadow call of the paths' frames."""
    from openglraytracer_tpu_torch import kernel_cases
    from openglraytracer_tpu_torch.models.builders import BENCH_CONFIGS
    from openglraytracer_tpu_torch.train.inverse import (DEFAULT_TRAINABLE,
                                                         FitConfig,
                                                         make_train_step)
    from openglraytracer_tpu_torch.ops.render import render
    from openglraytracer_tpu_torch.utils.metrics import rays_per_frame

    paths = {}
    t0 = time.perf_counter()
    for cfg, (tile, path_kernels) in PATHS_4096.items():
        builder, h, w, depth = BENCH_CONFIGS[cfg]
        scene, cam = builder(device=dev)
        lights = shading.static_shadow_mask(scene)
        bmask = shading.static_bounce_mask(scene) if depth else (True, True)
        spec = accel.suggest_cull_config(scene, cam, h, w, (tile, tile),
                                         shadow_lights=lights)
        child = (accel.suggest_child_cull_config(scene, cam, h, w, spec,
                                                 shadow_lights=lights)
                 if depth else None)
        kw = dict(depth=depth, engine="culled_pallas", cull=spec,
                  child_cull=child,
                  shadow_lights=lights, bounce_mask=bmask)
        paths[cfg] = dict(scene=scene, cam=cam, h=h, w=w, depth=depth, kw=kw,
                          kernels=path_kernels, lights=lights, bmask=bmask)
        log(f"  {cfg}: {w}x{h}, depth {depth}, tile {tile}; cull spec {spec}"
            + (f"; child spec {child}" if child else "")
            + f"; shadow lights {lights}")
    c4m = paths["c4_mirror4096"]
    child = c4m["kw"]["child_cull"]
    hot_p = accel.cull_hot_p(child)
    log(f"  sizing {time.perf_counter() - t0:.1f} s")

    # ---- 9. kernel 6 against its plain version on the paths' own masks
    t0 = time.perf_counter()
    log("[9/34] compaction kernel (kernel 6) vs plain version, full size")
    caps = {}
    for cfg, pth in paths.items():
        with Capture(culled, shade, accel) as cap, torch.no_grad():
            render(pth["scene"], pth["cam"], pth["h"], pth["w"], **pth["kw"])
        caps[cfg] = cap
    errs, n_masks = {}, 0
    for cfg, cap in caps.items():
        for mask, k in cap.calls:
            if mask.shape[-1] < accel.MIN_N_FOR_KERNEL:
                continue
            ki, kv, kc = accel.compact_mask(mask, k)
            pi, pv, pc = accel.compact_mask_plain(mask, k)
            same = (torch.equal(kv, pv) and torch.equal(kc, pc)
                    and torch.equal(ki * kv, pi * pv)
                    and not bool(ki[~kv].any()))
            n_masks += 1
            log(f"  compact_mask [{cfg}] mask {tuple(mask.shape)}, K {k}: "
                f"{'equal' if same else 'DIFFERENT'}; survivors per row max "
                f"{int(pc.max())}, mean {float(pc.float().mean()):.1f}")
            check(same, f"compact_mask kernel disagrees with its plain "
                  f"version ({cfg}, {tuple(mask.shape)})")
    check(n_masks >= 6, f"expected the paths' wide masks, got {n_masks}")
    for mask, k in kernel_cases.ragged_masks(dev):
        kernels.LAUNCHES.clear()
        ki, kv, kc = accel.compact_mask(mask, k)
        check(kernels.LAUNCHES["compact_mask"] == 1, "kernel 6 not launched")
        pi, pv, pc = accel.compact_mask_plain(mask, k)
        same = (torch.equal(kv, pv) and torch.equal(kc, pc)
                and torch.equal(ki * kv, pi * pv)
                and not bool(ki[~kv].any()))
        log(f"  compact_mask [ragged] mask {tuple(mask.shape)}, K {k}, row "
            f"counts {pc.tolist()[:8]}: {'equal' if same else 'DIFFERENT'}")
        check(same, f"compact_mask kernel disagrees with its plain version "
              f"(ragged, {tuple(mask.shape)})")
    errs["compact_mask"] = 0.0
    log(f"  phase 9: {time.perf_counter() - t0:.1f} s")

    # ---- 10. kernel 3 on the paths' hot pairs and on the graze cases
    t0 = time.perf_counter()
    log("[10/34] kernel 3 (shadow occlusion) vs plain version, hot pairs "
        "included, bit for bit")
    shadow_in = {}
    for cfg, cap_ in caps.items():
        tops = []
        for name, a, kw in cap_.log:
            if name == "_top_tiles":
                tops.append(a)
            if name != "shadow_occlusion":
                continue
            level = f"{cfg} level {sum(1 for w in shadow_in if cfg in w)}"
            shadow_in[level] = a
            hot_ids, ks_cap = a[9], a[4].shape[2]
            check(hot_ids is not None, f"{level}: no hot shadow pairs")
            lit = [j for j, on in enumerate(a[3]) if on]
            # the counts each lit light's hot tiles were picked by
            counts = [c for c, _ in tops[-len(lit):]]
            truly = sum(int((c[hot_ids[j].long()] > ks_cap).sum())
                        for c, j in zip(counts, lit))
            log(f"  {level}: {a[0].shape[0]} rays, {len(lit)} lit lights, "
                f"hot ids {tuple(hot_ids.shape)} over {a[10].shape[0]} "
                f"spheres, Ks {ks_cap}; hot tiles whose survivors exceed Ks: "
                f"{truly}")
            check(truly >= 1, f"{level}: no truly hot shadow tile")
            errs.setdefault("shadow_occlusion", 0.0)
            errs["shadow_occlusion"] = max(errs["shadow_occlusion"],
                                           compare_shadow(
                torch, culled.shadow_occlusion(*a),
                culled.shadow_occlusion_plain(*a), level)[1])
            tops = []
    check(len(shadow_in) == 3,
          f"expected 3 shadow calls, got {len(shadow_in)}")
    for n_sph in (4096, 5000, 5120):
        g_args, g_kw = kernel_cases.shadow_graze_inputs(dev, n_sph)
        want = culled.shadow_occlusion_plain(*g_args, **g_kw)
        compare_shadow(torch, culled.shadow_occlusion(*g_args, **g_kw), want,
                       f"graze, {n_sph} spheres")
        w0 = want[:, 0].reshape(-1, 32)
        mixed = float((w0.any(dim=1) & ~w0.all(dim=1)).float().mean())
        log(f"  graze, {n_sph} spheres: {mixed:.3f} of the warps have both "
            f"blocked and open lanes for light 0")
        check(mixed > 0.0, "no warp is partially blocked")

    # ---- kernel 2 (cold and hot) against its plain version on a cut
    log(f"  kernel 2 vs plain version on c4_mirror4096's inputs: the "
        f"{CUT_HOT} hottest and {CUT_COLD} evenly spaced cold tiles")
    cap = caps["c4_mirror4096"]
    check(hot_p > 0, f"the c4_mirror4096 child spec has no hot budget: "
          f"{child}")
    a_c, a_h = cap.args["primary_hit_ray"], cap.args["primary_hit_hot"]
    ids_h = cap.kwargs["primary_hit_hot"]["tile_ids"].long()
    cnt_h = a_h[5]
    truly = (cnt_h > 0).any(dim=1)
    n_hot = int(truly.sum())
    log(f"  hot_p {hot_p}; truly hot tiles in the smoke frame: {n_hot}")
    check(n_hot >= 1, "no truly hot tile in the c4_mirror4096 smoke frame")
    tile_p = a_c[6]
    n_tiles = a_c[5].shape[0]

    def rays(x, ids):
        return x.reshape(n_tiles, tile_p, 3)[ids].reshape(-1, 3).contiguous()

    hb = torch.nonzero(truly).flatten()[:CUT_HOT]
    hot_set = torch.zeros(n_tiles, dtype=torch.bool, device=dev)
    hot_set[ids_h[truly]] = True
    cold = torch.nonzero(~hot_set & (a_c[5][:, 0] > 0)).flatten()
    if cold.numel() < CUT_COLD:
        cold = torch.nonzero(~hot_set).flatten()
    cold = cold[torch.linspace(0, cold.numel() - 1, CUT_COLD,
                               device=dev).long()]
    cut_c = (rays(a_c[0], cold), rays(a_c[1], cold), a_c[2][cold].contiguous(),
             a_c[3][cold].contiguous(), a_c[4], a_c[5][cold].contiguous(),
             tile_p)
    cut_h = (rays(a_h[0], ids_h[hb]), rays(a_h[1], ids_h[hb]), a_h[2], a_h[3],
             a_h[4], cnt_h[hb].contiguous(), tile_p)
    ids_cut = torch.arange(hb.numel(), dtype=torch.int32, device=dev)
    plain2 = primary_hit_ray_plain(culled)
    log(f"  cold cut: {cold.numel()} tiles, sphere rows "
        f"{tuple(cut_c[2].shape)}, counts {cut_c[5][:, 0].tolist()}")
    errs["primary_hit_ray"] = compare_primary(
        torch, culled.primary_hit_ray(*cut_c), plain2(*cut_c),
        "c4_mirror4096 cold cut", "primary_hit_ray")[1]
    log(f"  hot cut: {hb.numel()} tiles over the global table "
        f"{tuple(cut_h[2].shape)}")
    errs["primary_hit_hot"] = compare_primary(
        torch, culled.primary_hit_ray(*cut_h, tile_ids=ids_cut),
        plain2(*cut_h, tile_ids=ids_cut), "c4_mirror4096 hot cut",
        "primary_hit_hot")[1]
    # rays that split warps: tangent grazes (qd at 0 and an ulp either
    # side), spheres behind the origin, invalid rows, a slack block; tables
    # of four and five staged chunks
    for n_sph in (4096, 5120):
        g_args, g_kw = kernel_cases.graze_hot_inputs(dev, n_sph, CUT_HOT)
        want = plain2(*g_args, **g_kw)
        target, ahead = kernel_cases.graze_target(dev, n_sph,
                                                  CUT_HOT * g_args[6])
        own = want[4][:target.numel()] == target
        log(f"  graze cut, {n_sph} spheres: {int(own.sum())} of "
            f"{own.numel()} rays hit the sphere they graze")
        check(0 < int(own.sum()) < own.numel() and not bool(own[~ahead].any()),
              "the graze cut must split hits and misses, and miss behind")
        err = compare_primary(torch, culled.primary_hit_ray(*g_args, **g_kw),
                              want, f"graze, {n_sph} spheres",
                              "primary_hit_hot", exact=True)[1]
        errs["primary_hit_hot"] = max(errs["primary_hit_hot"], err)
    log(f"  phase 10: {time.perf_counter() - t0:.1f} s")

    # ---- 11. the forward paths
    t0 = time.perf_counter()
    log(f"[11/34] forward paths: {FRAMES} frames each, engine culled_pallas")
    launches = {}
    dense_pass = []     # calls of the dense hot-shadow pass: must be none
    seg = accel._segment_occluded

    def counted(*a):
        dense_pass.append(1)
        return seg(*a)
    for cfg, pth in paths.items():
        h, w = pth["h"], pth["w"]
        kernels.LAUNCHES.clear()
        accel._segment_occluded = culled._segment_occluded = counted
        try:
            with torch.no_grad():
                frames = [render(pth["scene"], pth["cam"], h, w,
                                 with_cull_stats=True, **pth["kw"])
                          for _ in range(FRAMES)]
        finally:
            accel._segment_occluded = culled._segment_occluded = seg
        torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        launches[f"render_{cfg}"] = got
        log(f"  {cfg}: launches over {FRAMES} frames: {got}; calls of the "
            f"dense hot-shadow pass: {len(dense_pass)}")
        check(not dense_pass, f"{cfg}: a frame ran accel._segment_occluded")
        check(all(got.get(k, 0) >= FRAMES for k in pth["kernels"]),
              f"{cfg}: every kernel of the path must launch on every frame")
        check(got.get("phong_shade_bwd", 0) == 0,
              "a forward frame must not run the backward")
        ovfs = [int(o) for _, o in frames]
        log(f"  {cfg}: cull_overflow_events per frame: {ovfs}")
        check(all(o == 0 for o in ovfs), f"cull overflow on {cfg}")
        img = frames[-1][0]
        check(tuple(img.shape) == (h, w, 3), f"image shape {img.shape}")
        check(bool(torch.isfinite(img).all()), f"{cfg}: non-finite image")
        check(all(torch.equal(f[0], img) for f in frames), "frames differ")
        with PlainVersions(culled, shade, shading, accel), torch.no_grad():
            img_plain = render(pth["scene"], pth["cam"], h, w, **pth["kw"])
        diff = (img - img_plain).abs().amax(dim=-1)
        share = float((diff <= 1.0 / 255.0).float().mean())
        log(f"  {cfg}: image vs plain versions on the card: {share:.6f} of "
            f"pixels within 1/255, max diff {float(diff.max()):.3e}; mean "
            f"{float(img.mean()):.5f}")
        check(share >= 0.999, f"{cfg}: image disagrees with the plain "
              "versions' image")
    log(f"  phase 11: {time.perf_counter() - t0:.1f} s")

    # ---- 12. timing
    t0 = time.perf_counter()
    log(f"[12/34] timing, forward and training step ({smi})")
    steps = {}
    for cfg, pth in paths.items():
        h, w = pth["h"], pth["w"]
        scene, cam = pth["scene"], pth["cam"]

        def frame(pth=pth, h=h, w=w):
            with torch.no_grad():
                return render(pth["scene"], pth["cam"], h, w,
                              with_cull_stats=True, **pth["kw"])

        fc = FitConfig(height=h, width=w, depth=pth["depth"],
                       engine="culled_pallas", cull=pth["kw"]["cull"],
                       child_cull=pth["kw"]["child_cull"],
                       trainable=DEFAULT_TRAINABLE)
        init_fn, step_fn = make_train_step(
            cam, fc, optimizer=lambda ps: torch.optim.SGD(ps, lr=STEP_LR))
        params, opt = init_fn(scene)
        target = torch.zeros((h, w, 3), device=dev)
        steps[cfg] = (init_fn, step_fn, target)

        def train_step(params=params, opt=opt, step_fn=step_fn,
                       target=target, scene=scene):
            return step_fn(params, opt, scene, target)

        n_rays = rays_per_frame(h, w, scene.lights.count, pth["depth"],
                                shadow_lights=pth["lights"],
                                bounce_mask=pth["bmask"])
        for what, fn, ovf_at in (("frame", frame, 1),
                                 ("training step", train_step, 3)):
            windows, outs = timed_windows(torch, fn)
            check(int(torch.stack([o[ovf_at] for o in outs]).sum()) == 0,
                  f"{cfg}: overflow while timing the {what}")
            med = statistics.median(windows)
            dev_ms = statistics.median(device_ms(torch, fn, (), reps=1)
                                       for _ in range(5))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"  {cfg} {what}: median {med:.4f} ms, min "
                f"{min(windows):.4f} ms over {WINDOWS} windows of "
                f"{WINDOW_FRAMES} ({[round(x, 4) for x in windows]}), "
                f"sync-free under set_sync_debug_mode('error'); device time "
                f"(one call behind a spin kernel, median of 5) {dev_ms:.4f} "
                f"ms; peak device memory {peak:.3f} GiB; {n_rays} "
                f"rays/frame -> {n_rays / (med / 1e3) / 1e6:.1f} Mrays/s "
                f"median")
    kernel_ms, timed, earlier_ms = {}, {}, {}
    mask, k = next(c for c in caps["c5_grid4096"].calls
                   if c[0].shape[-1] >= accel.MIN_N_FOR_KERNEL)
    full_h = (a_h, cap.kwargs["primary_hit_hot"])
    for name, fn, plain, args, kw in (
            ("compact_mask", accel.compact_mask, accel.compact_mask_plain,
             (mask, k), {}),
            ("primary_hit_ray", culled.primary_hit_ray, plain2, a_c, {}),
            ("primary_hit_hot", culled.primary_hit_ray, plain2, *full_h)):
        def call(f, kw=kw):
            return lambda *a: f(*a, **kw)
        # the earlier kernels 6 and 2 in turns with the current ones (kernel
        # 2's cold launch and kernel A share the hot launch's template)
        ms, old_ms, every = time_turns(torch, kernels, call(fn), args,
                                       earlier)
        t_plain = [device_ms(torch, call(plain), args, reps=1)
                   for _ in range(2)]
        kernel_ms[name] = (ms, statistics.mean(t_plain))
        timed[name] = (args, kw)
        cell = "c5_grid4096" if name == "compact_mask" else "c4_mirror4096"
        log(f"  {name}: kernel {ms:.4f} ms, plain version "
            f"{kernel_ms[name][1]:.4f} ms (device time per call on the "
            f"full-size inputs of {cell})"
            + (f"; earlier kernel {old_ms:.4f} ms, in turns {every}"
               if old_ms is not None else ""))
        earlier_ms[name] = old_ms
    # kernel B on the paths' own inputs, hot pairs included: the function
    # (both launches), its first launch and its hot launch, each in turns
    # with the earlier build's part of the same work (the earlier kernel,
    # the dense pass it left the hot tiles to, both with the merge)
    shadow_cells = {}
    for level, a in shadow_in.items():
        old = (earlier_shadow(torch, accel, earlier, a)
               if earlier is not None else {})

        def whole(a=a):
            return culled.shadow_occlusion(*a)

        def first(a=a):
            return culled.shadow_occlusion(*a[:9])
        if old:
            check(torch.equal(old["both"](), whole()),
                  f"{level}: the earlier build's occlusion differs")
        cell = {}
        for part, fn, plain in (
                ("function", whole, lambda a=a: culled.shadow_occlusion_plain(
                    *a)),
                ("shadow_occlusion", first,
                 lambda a=a: culled.shadow_occlusion_plain(*a[:9])),
                ("shadow_occlusion_hot", shadow_hot_only(kernels, culled, a),
                 dense_hot_pass(torch, accel, a))):
            ms, old_ms, every = in_turns(
                torch, fn, old.get({"function": "both",
                                    "shadow_occlusion": "cold",
                                    "shadow_occlusion_hot": "hot"}[part]))
            cell[part] = dict(ms=ms, earlier_ms=old_ms, plain_ms=device_ms(
                torch, plain, (), reps=1))
            if part != "function":
                b_ms, b_by, nbytes, ops = bound(torch, part,
                                                culled.shadow_occlusion, a)
                cell[part].update(bound_ms=b_ms, bound_by=b_by)
            log(f"  {part} [{level}]: kernel {ms:.4f} ms, plain version "
                f"{cell[part]['plain_ms']:.4f} ms"
                + (f"; bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB, "
                   f"{ops / 1e9:.3f} GFLOP), {100 * b_ms / ms:.0f}% of it"
                   if part != "function" else "")
                + (f"; earlier {old_ms:.4f} ms, in turns {every}"
                   if old_ms is not None else ""))
        shadow_cells[level] = cell
    c5_level = "c5_grid4096 level 0"
    hot_c5 = shadow_cells[c5_level]["shadow_occlusion_hot"]
    kernel_ms["shadow_occlusion_hot"] = (hot_c5["ms"], hot_c5["plain_ms"])
    earlier_ms["shadow_occlusion_hot"] = hot_c5["earlier_ms"]
    timed["shadow_occlusion_hot"] = (shadow_in[c5_level], {})
    # the library call: torch.topk, the core of compact_mask_plain, alone on
    # the same mask's keys (a yardstick; the port calls it only for masks
    # narrower than MIN_N_FOR_KERNEL)
    n_obj = mask.shape[-1]
    key = torch.where(mask, torch.arange(n_obj, 0, -1, dtype=torch.int32,
                                         device=dev)[None, :], 0)
    topk_ms = statistics.mean(
        device_ms(torch, lambda: torch.topk(key, min(k, n_obj), dim=-1), ())
        for _ in range(2))
    log(f"  compact_mask's library call, torch.topk on the same keys: "
        f"{topk_ms:.4f} ms")
    log(f"  phase 12: {time.perf_counter() - t0:.1f} s")

    # ---- 13. the training paths
    t0 = time.perf_counter()
    log(f"[13/34] training paths: {STEPS} SGD steps each at lr {STEP_LR:g} "
        f"of mean(img^2) w.r.t. {DEFAULT_TRAINABLE}")
    for cfg, pth in paths.items():
        init_fn, step_fn, target = steps[cfg]
        scene = pth["scene"]
        params, opt = init_fn(scene)
        kernels.LAUNCHES.clear()
        outs = [step_fn(params, opt, scene, target) for _ in range(STEPS)]
        torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        launches[f"train_step_{cfg}"] = got
        log(f"  {cfg}: launches over {STEPS} steps: {got}")
        check(all(got.get(k, 0) >= STEPS
                  for k in pth["kernels"] + ("phong_shade_bwd",)),
              f"{cfg}: every kernel of the path must launch on every step")
        ovfs = [int(o[3]) for o in outs]
        log(f"  {cfg}: losses {[float(o[2]) for o in outs]}; overflow "
            f"{ovfs}")
        check(all(o == 0 for o in ovfs), f"cull overflow training {cfg}")

        def one_step_grads():
            p, o = init_fn(scene)
            _, _, loss, _ = step_fn(p, o, scene, target)
            return float(loss), {k: v.grad for k, v in p.items()}

        loss_k, grads_k = one_step_grads()
        with PlainVersions(culled, shade, shading, accel):
            loss_p, grads_p = one_step_grads()
        log(f"  {cfg}: first step's loss: kernels {loss_k:.9g}, plain "
            f"versions {loss_p:.9g}")
        check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p),
              f"{cfg}: training loss disagrees with the plain versions'")
        for k in DEFAULT_TRAINABLE:
            gk, gp = grads_k[k], grads_p[k]
            scale = float(gp.abs().max())
            err = float((gk - gp).abs().max())
            log(f"  {cfg} grad {k}: max |g| {scale:.4e}, max |kernel - "
                f"plain| {err:.3e} ({err / max(scale, 1e-30):.2e} of max "
                f"|g|)")
            check(bool(torch.isfinite(gk).all()) and scale > 0.0,
                  f"{cfg}: gradient of {k} must be finite and non-zero")
            check(err <= GRAD_TOL * scale,
                  f"{cfg}: gradient of {k} disagrees with the plain "
                  "versions'")
    log(f"  phase 13: {time.perf_counter() - t0:.1f} s")
    return (launches, kernel_ms, errs, timed, topk_ms, earlier_ms,
            shadow_cells)


def compare_dense(torch, k, p, what):
    """Kernel 7 outputs k vs plain p: (mismatch share, max abs err). A ray
    agrees when its hit flag, winner, inside flag and, where it hit, every
    light's occlusion bit agree. Both round every op alike, so every ray
    must agree and t and n must be equal bit for bit."""
    t_k, n_k, ins_k, id_k, occ_k = k
    t_p, n_p, ins_p, id_p, occ_p = p
    hit_p = t_p < 1e4
    agree = ((t_k < 1e4) == hit_p) & (id_k == id_p) & (ins_k == ins_p) \
        & ((occ_k == occ_p) | ~hit_p[None, :]).all(dim=0)
    share = 1.0 - float(agree.float().mean())
    live = agree & hit_p
    dt = (t_k - t_p).abs()[live]
    dn = (n_k - n_p).abs()[live]
    t_bad = int((dt > T_ATOL + T_RTOL * t_p.abs()[live]).sum())
    n_bad = int((dn > N_ATOL).sum())
    err = max(float(dt.max()) if dt.numel() else 0.0,
              float(dn.max()) if dn.numel() else 0.0)
    occ_share = [round(float(o[hit_p].float().mean()), 4) for o in occ_p]
    log(f"  dense_hit [{what}]: discrete mismatches {share:.2e} of "
        f"{t_k.numel()} rays ({float(hit_p.float().mean()):.4f} hit; "
        f"occluded share per light where hit {occ_share}), t/n out of "
        f"tolerance {t_bad}/{n_bad}, max |t|,|n| err {err:.3e}")
    check(share == 0.0 and err == 0.0,
          f"dense_hit kernel disagrees with its plain version ({what})")
    return share, err


def run_dense(torch, dev, kernels, culled, shade, shading, accel, smi,
              earlier):
    """Phases 14-17: the dense engine 'pallas' (kernel 7) on c3_grid64 and
    the reference's animated OBB world. Returns (per-path launch counts,
    per-cell kernel 7 numbers, max abs error, the c3 inputs of kernel 7)."""
    from openglraytracer_tpu_torch import kernel_cases
    from openglraytracer_tpu_torch.models.animated import reference_frame
    from openglraytracer_tpu_torch.models.builders import (BENCH_CONFIGS,
                                                           sphere_grid_scene)
    from openglraytracer_tpu_torch.ops import dense
    from openglraytracer_tpu_torch.ops.raygen import generate_rays
    from openglraytracer_tpu_torch.ops.render import render
    from openglraytracer_tpu_torch.train.inverse import (DEFAULT_TRAINABLE,
                                                         FitConfig,
                                                         make_train_step)
    from openglraytracer_tpu_torch.utils.metrics import rays_per_frame

    scenes = {"c3": sphere_grid_scene(8, device=dev),
              "obb": reference_frame(OBB_TIME, device=dev)}
    paths = {}
    for cfg, (which, h, w, depth) in DENSE_PATHS.items():
        scene, cam = scenes[which]
        bmask = shading.static_bounce_mask(scene) if depth else (True, True)
        trainable = DEFAULT_TRAINABLE if which == "c3" else OBB_TRAINABLE
        paths[cfg] = dict(scene=scene, cam=cam, h=h, w=w, depth=depth,
                          trainable=trainable,
                          kw=dict(depth=depth, engine="pallas",
                                  bounce_mask=bmask),
                          launches=3 if depth else 1)
        log(f"  {cfg}: {w}x{h}, depth {depth}, engine pallas; "
            f"{scene.spheres.count} spheres, {scene.boxes.count} boxes, "
            f"{scene.planes.count} planes, {scene.lights.count} lights; "
            f"bounce mask {bmask}")

    # ---- 14. kernel 7 against its plain version on the paths' own inputs
    t0 = time.perf_counter()
    log("[14/34] dense kernel (kernel 7) vs plain version, full size")
    seen = []
    fn = dense.dense_hit

    def spy(*a):
        seen.append(tuple(x.detach() for x in a))
        return fn(*a)
    dense.dense_hit = spy
    try:
        with torch.no_grad():
            for cfg in ("c3_grid64", "obb_depth1"):
                pth = paths[cfg]
                render(pth["scene"], pth["cam"], pth["h"], pth["w"],
                       **pth["kw"])
    finally:
        dense.dense_hit = fn
    check(len(seen) == 4, f"expected 4 dense_hit calls, got {len(seen)}")
    inputs = {"c3 primary": seen[0], "obb primary": seen[1],
              "obb reflection children": seen[2],
              "obb refraction children": seen[3]}
    n_zero = int((seen[3][1] == 0).all(dim=-1).sum())
    log(f"  obb refraction children with zero direction (total internal "
        f"reflection): {n_zero} of {seen[3][1].shape[0]}")
    # zero-direction rays, as total internal reflection hands them to the
    # kernel (at depth >= 2 in this world: a ray must be inside the glass),
    # from just inside every surface the OBB frame's primary rays hit
    o1, d1 = seen[1][:2]
    t1, n1 = dense.dense_hit_plain(*seen[1])[:2]
    p1 = o1 + torch.where(t1 < 1e4, t1, 0.0)[:, None] * d1
    inputs["obb zero-direction rays"] = (
        (p1 - 1.0e-3 * n1).contiguous(), torch.zeros_like(d1),
        *seen[1][2:])
    c5_scene, c5_cam = BENCH_CONFIGS["c5_grid4096"][0](device=dev)
    o5, d5 = (x.reshape(-1, 3) for x in generate_rays(c5_cam, 2048, 2048))
    stride = o5.shape[0] // C5_CUT
    inputs["c5_grid4096 cut"] = (
        o5[::stride].contiguous(), d5[::stride].contiguous(),
        *dense._scene_tables(c5_scene))
    # rays that split warps: tangent grazes (disc at 0 and an ulp either
    # side) against a table of 4 staging chunks, and warps in which the
    # first sphere blocks a light's segment on some lanes only
    inputs["graze cut"] = kernel_cases.graze_dense_inputs(dev, 1000, C5_CUT)
    inputs["partially blocked warps"] = kernel_cases.partial_block_inputs(
        dev, C5_CUT)
    errs = {}
    for what, a in inputs.items():
        log(f"  {what}: {a[0].shape[0]} rays, tables sph "
            f"{tuple(a[2].shape)}, box {tuple(a[3].shape)}, plane "
            f"{tuple(a[4].shape)}, lights {tuple(a[5].shape)}")
        want = dense.dense_hit_plain(*a)
        errs[what] = compare_dense(torch, dense.dense_hit(*a), want,
                                   what)[1]
        if what == "graze cut":
            target, ahead = kernel_cases.graze_target(dev, 1000, C5_CUT)
            own = want[3] == target
            log(f"  graze cut: {int(own.sum())} of {C5_CUT} rays hit the "
                f"sphere they graze")
            check(0 < int(own.sum()) < C5_CUT
                  and not bool(own[~ahead].any()),
                  "the graze cut must split hits and misses, and miss behind")
        if what == "partially blocked warps":
            mixed = kernel_cases.mixed_warps(want[4], want[0] < 1e4)
            log(f"  partially blocked warps: {mixed:.3f} of the warps have "
                f"both blocked and lit lanes")
            check(mixed > 0.0, "no warp is partially blocked")
    log(f"  phase 14: {time.perf_counter() - t0:.1f} s")

    # ---- 15. the forward paths
    t0 = time.perf_counter()
    log(f"[15/34] forward paths: {FRAMES} frames each, engine pallas")
    launches = {}
    for cfg, pth in paths.items():
        h, w = pth["h"], pth["w"]
        kernels.LAUNCHES.clear()
        with torch.no_grad():
            frames = [render(pth["scene"], pth["cam"], h, w,
                             with_cull_stats=True, **pth["kw"])
                      for _ in range(FRAMES)]
        torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        launches[f"render_{cfg}_pallas"] = got
        log(f"  {cfg}: launches over {FRAMES} frames: {got}")
        check(got == {"dense_hit": FRAMES * pth["launches"]},
              f"{cfg}: dense_hit must launch {pth['launches']} time(s) per "
              "frame, and no other kernel")
        check(all(int(o) == 0 for _, o in frames), "overflow reported")
        img = frames[-1][0]
        check(tuple(img.shape) == (h, w, 3), f"image shape {img.shape}")
        check(bool(torch.isfinite(img).all()), f"{cfg}: non-finite image")
        check(all(torch.equal(f[0], img) for f in frames), "frames differ")
        with PlainVersions(culled, shade, shading, accel), torch.no_grad():
            img_plain = render(pth["scene"], pth["cam"], h, w, **pth["kw"])
        diff = (img - img_plain).abs().amax(dim=-1)
        share = float((diff <= 1.0 / 255.0).float().mean())
        log(f"  {cfg}: image vs plain versions on the card: {share:.6f} of "
            f"pixels within 1/255, max diff {float(diff.max()):.3e}; mean "
            f"{float(img.mean()):.5f}")
        check(share >= 0.999, f"{cfg}: image disagrees with the plain "
              "versions' image")
    log(f"  phase 15: {time.perf_counter() - t0:.1f} s")

    # ---- 16. timing
    t0 = time.perf_counter()
    log(f"[16/34] timing, forward and training step, engine pallas ({smi})")
    steps = {}
    for cfg, pth in paths.items():
        h, w, scene, cam = pth["h"], pth["w"], pth["scene"], pth["cam"]

        def frame(pth=pth, h=h, w=w):
            with torch.no_grad():
                return render(pth["scene"], pth["cam"], h, w,
                              with_cull_stats=True, **pth["kw"])

        fc = FitConfig(height=h, width=w, depth=pth["depth"],
                       engine="pallas", trainable=pth["trainable"])
        init_fn, step_fn = make_train_step(
            cam, fc, optimizer=lambda ps: torch.optim.SGD(ps, lr=STEP_LR))
        params, opt = init_fn(scene)
        target = torch.zeros((h, w, 3), device=dev)
        steps[cfg] = (init_fn, step_fn, target)

        def train_step(params=params, opt=opt, step_fn=step_fn,
                       target=target, scene=scene):
            return step_fn(params, opt, scene, target)

        # the dense engine casts every light's shadow ray
        n_rays = rays_per_frame(h, w, scene.lights.count, pth["depth"],
                                bounce_mask=pth["kw"]["bounce_mask"]
                                if pth["depth"] else None)
        for what, fn_, ovf_at in (("frame", frame, 1),
                                  ("training step", train_step, 3)):
            windows, outs = timed_windows(torch, fn_)
            check(int(torch.stack([o[ovf_at] for o in outs]).sum()) == 0,
                  f"{cfg}: overflow while timing the {what}")
            med = statistics.median(windows)
            dev_ms = statistics.median(device_ms(torch, fn_, (), reps=1)
                                       for _ in range(5))
            log(f"  {cfg} {what}: median {med:.4f} ms, min "
                f"{min(windows):.4f} ms over {WINDOWS} windows of "
                f"{WINDOW_FRAMES} ({[round(x, 4) for x in windows]}), "
                f"sync-free under set_sync_debug_mode('error'); device time "
                f"(one call behind a spin kernel, median of 5) {dev_ms:.4f} "
                f"ms; {n_rays} rays/frame -> "
                f"{n_rays / (med / 1e3) / 1e6:.1f} Mrays/s median")
    cells = {}
    for what in ("c3 primary", "obb primary", "obb reflection children",
                 "obb refraction children"):
        a = inputs[what]
        ms, old_ms, every = time_turns(torch, kernels, dense.dense_hit, a,
                                       earlier)
        t_plain = [device_ms(torch, dense.dense_hit_plain, a, reps=1)
                   for _ in range(2)]
        b_ms, b_by, nbytes, ops = bound(torch, "dense_hit", dense.dense_hit,
                                        a)
        cells[what] = dict(ms=ms, plain_ms=statistics.mean(t_plain),
                           bound_ms=b_ms, bound_by=b_by, earlier_ms=old_ms)
        log(f"  dense_hit [{what}]: kernel {ms:.4f} ms, plain version "
            f"{cells[what]['plain_ms']:.4f} ms; bound {b_ms:.4f} ms by "
            f"{b_by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP), "
            f"{100 * b_ms / ms:.0f}% of it"
            + (f"; earlier kernel {old_ms:.4f} ms, in turns {every}"
               if old_ms is not None else ""))
    log(f"  phase 16: {time.perf_counter() - t0:.1f} s")

    # ---- 17. the training paths
    t0 = time.perf_counter()
    log(f"[17/34] training paths, engine pallas: {STEPS} SGD steps each at "
        f"lr {STEP_LR:g} of mean(img^2)")
    for cfg, pth in paths.items():
        init_fn, step_fn, target = steps[cfg]
        scene = pth["scene"]
        params, opt = init_fn(scene)
        kernels.LAUNCHES.clear()
        outs = [step_fn(params, opt, scene, target) for _ in range(STEPS)]
        torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        launches[f"train_step_{cfg}_pallas"] = got
        log(f"  {cfg}: launches over {STEPS} steps: {got}; losses "
            f"{[float(o[2]) for o in outs]}")
        check(got == {"dense_hit": STEPS * pth["launches"]},
              f"{cfg}: dense_hit must launch {pth['launches']} time(s) per "
              "step, and no other kernel")

        def one_step_grads():
            p, o = init_fn(scene)
            _, _, loss, _ = step_fn(p, o, scene, target)
            return float(loss), {k: v.grad for k, v in p.items()}

        loss_k, grads_k = one_step_grads()
        with PlainVersions(culled, shade, shading, accel):
            loss_p, grads_p = one_step_grads()
        log(f"  {cfg}: first step's loss: kernels {loss_k:.9g}, plain "
            f"versions {loss_p:.9g}")
        check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p),
              f"{cfg}: training loss disagrees with the plain versions'")
        for k in pth["trainable"]:
            gk, gp = grads_k[k], grads_p[k]
            scale = float(gp.abs().max())
            err = float((gk - gp).abs().max())
            log(f"  {cfg} grad {k}: max |g| {scale:.4e}, max |kernel - "
                f"plain| {err:.3e} ({err / max(scale, 1e-30):.2e} of max "
                f"|g|)")
            check(bool(torch.isfinite(gk).all()) and scale > 0.0,
                  f"{cfg}: gradient of {k} must be finite and non-zero")
            check(err <= GRAD_TOL * scale,
                  f"{cfg}: gradient of {k} disagrees with the plain "
                  "versions'")
    log(f"  phase 17: {time.perf_counter() - t0:.1f} s")
    return launches, cells, max(errs.values()), inputs["c3 primary"]


def time_cell(torch, cell, what, fn, ovf_at, n_rays, warm: int = 3,
              windows: int = WINDOWS, frames: int = WINDOW_FRAMES,
              dev_reps: int = 5, allow_overflow: bool = False):
    """Time fn (a frame or a training step whose output's ovf_at-th item is
    the overflow count, which must be 0 unless allow_overflow) as phases 5
    and 7 do: `windows` windows of `frames` calls under
    set_sync_debug_mode('error'), its device time (one call behind a spin
    kernel, median of dev_reps) and its peak device memory, also above what
    was allocated before the call. Returns those numbers."""
    per_call, outs = timed_windows(torch, fn, warm, windows, frames)
    ovf = int(torch.stack([o[ovf_at] for o in outs]).sum())
    check(ovf == 0 or allow_overflow,
          f"{cell}: overflow while timing the {what}")
    if ovf:
        log(f"  {cell} {what}: {ovf} overflow events over the timed calls")
    del outs
    med = statistics.median(per_call)
    dev_ms = statistics.median(device_ms(torch, fn, (), reps=1)
                               for _ in range(dev_reps))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  {cell} {what}: median {med:.4f} ms, min {min(per_call):.4f} ms "
        f"over {windows} windows of {frames} "
        f"({[round(x, 4) for x in per_call]}), sync-free under "
        f"set_sync_debug_mode('error'); device time (one call behind a "
        f"spin kernel, median of {dev_reps}) {dev_ms:.4f} ms; peak device "
        f"memory {peak:.3f} GiB ({peak - base:.3f} above the "
        f"{base:.3f} GiB held before the call); {n_rays} rays/frame -> "
        f"{n_rays / (med / 1e3) / 1e6:.1f} Mrays/s median")
    return dict(median_ms=med, min_ms=min(per_call), device_ms=dev_ms,
                peak_gib=peak, call_gib=peak - base)


def compare_grads(torch, cell, grads, want, what, tol=GRAD_TOL):
    """Per leaf: finite, non-zero, and within tol * max|g| of want."""
    for k, gp in want.items():
        gk = grads[k]
        scale = float(gp.abs().max())
        err = float((gk - gp).abs().max())
        log(f"  {cell} grad {k}: max |g| {scale:.4e}, max |{what}| "
            f"{err:.3e} ({err / max(scale, 1e-30):.2e} of max |g|)")
        check(bool(torch.isfinite(gk).all()) and scale > 0.0,
              f"{cell}: gradient of {k} must be finite and non-zero")
        check(err <= tol * scale,
              f"{cell}: gradient of {k} disagrees ({what})")


def run_xla(torch, dev, kernels, culled, shade, shading, accel, smi):
    """Phases 18-21: the plain dense engine 'xla' ('auto') on c1, c2, c3
    and the OBB world against kernel 7's 'pallas'; c4_mirror (a culled
    parent, kernels A, B, 4 and 5, with dense 'xla' children); the
    reference's rows c1, c2 and animated_obb_720p on 'auto'; 'autodiff'
    against the analytic backward. Returns the per-path launch counts."""
    from openglraytracer_tpu_torch.models.animated import reference_frame
    from openglraytracer_tpu_torch.models.builders import BENCH_CONFIGS
    from openglraytracer_tpu_torch.ops.render import render
    from openglraytracer_tpu_torch.train.inverse import (DEFAULT_TRAINABLE,
                                                         FitConfig,
                                                         make_train_step)
    from openglraytracer_tpu_torch.utils.metrics import rays_per_frame

    def path(scene, cam, h, w, depth, trainable=DEFAULT_TRAINABLE):
        return dict(scene=scene, cam=cam, h=h, w=w, depth=depth,
                    trainable=trainable,
                    lights=shading.static_shadow_mask(scene),
                    bmask=(shading.static_bounce_mask(scene) if depth
                           else (True, True)))

    paths = {}
    for cfg in ("c1_sphere_plane", "c2_eight_spheres", "c3_grid64"):
        builder, h, w, depth = BENCH_CONFIGS[cfg]
        paths[cfg] = path(*builder(device=dev), h, w, depth)
    obb = reference_frame(OBB_TIME, device=dev)
    for depth in (0, 1):
        paths[f"animated_obb_720p_depth{depth}"] = path(
            *obb, *OBB_HW, depth, OBB_TRAINABLE)
    launches = {}

    def frame(pth, engine, **kw):
        with torch.no_grad():
            return render(pth["scene"], pth["cam"], pth["h"], pth["w"],
                          depth=pth["depth"], engine=engine,
                          shadow_lights=pth["lights"],
                          bounce_mask=pth["bmask"], with_cull_stats=True,
                          **kw)

    # ---- 18. 'xla' against kernel 7
    t0 = time.perf_counter()
    log("[18/34] engine 'xla' (plain PyTorch) against engine 'pallas' "
        "(kernel 7) and 'auto', full size")
    for cfg, pth in paths.items():
        kernels.LAUNCHES.clear()
        img_x = frame(pth, "xla")[0]
        torch.cuda.synchronize()
        got = dict(kernels.LAUNCHES)
        check(not got, f"{cfg}: an 'xla' frame launched kernels {got}")
        img_a = frame(pth, "auto")[0]
        img_p = frame(pth, "pallas")[0]
        check(bool(torch.isfinite(img_x).all()), f"{cfg}: non-finite image")
        check(torch.equal(img_a, img_x), f"{cfg}: 'auto' differs from 'xla'")
        diff = (img_x - img_p).abs().amax(dim=-1)
        share = float((diff <= 1.0 / 255.0).float().mean())
        ms = {e: statistics.median(device_ms(
            torch, lambda e=e: frame(pth, e), (), reps=1) for _ in range(3))
            for e in ("xla", "pallas")}
        log(f"  {cfg} ({pth['w']}x{pth['h']}, depth {pth['depth']}): 'xla' "
            f"launches none, 'auto' equal bit for bit; 'xla' vs 'pallas': "
            f"{share:.6f} of pixels within 1/255, max diff "
            f"{float(diff.max()):.3e}; frame device time 'xla' "
            f"{ms['xla']:.4f} ms, 'pallas' {ms['pallas']:.4f} ms")
        check(share >= 0.999, f"{cfg}: 'xla' disagrees with 'pallas'")
    log(f"  phase 18: {time.perf_counter() - t0:.1f} s")

    # ---- 19. c4_mirror: culled parent, dense 'xla' children
    t0 = time.perf_counter()
    builder, h, w, depth = BENCH_CONFIGS["c4_mirror"]
    c4m = path(*builder(device=dev), h, w, depth)
    spec = accel.suggest_cull_config(c4m["scene"], c4m["cam"], h, w,
                                     (64, 64), shadow_lights=c4m["lights"])
    c4_kernels = ("primary_hit", "shadow_occlusion", "phong_fused") + (
        ("shadow_occlusion_hot",) if accel.parse_cull_spec(spec)[3] else ())
    log(f"[19/34] c4_mirror {w}x{h}, depth {depth}: engine culled_pallas, "
        f"spec {spec}, no child spec (children on 'xla'); shadow lights "
        f"{c4m['lights']}, bounce mask {c4m['bmask']}; {FRAMES} frames")
    kernels.LAUNCHES.clear()
    frames = [frame(c4m, "culled_pallas", cull=spec) for _ in range(FRAMES)]
    torch.cuda.synchronize()
    got = dict(kernels.LAUNCHES)
    launches["render_c4_mirror"] = got
    log(f"  launches over {FRAMES} frames: {got}; overflow per frame "
        f"{[int(o) for _, o in frames]}")
    check(all(got.get(k, 0) == FRAMES for k in c4_kernels)
          and set(got) == set(c4_kernels),
          "c4_mirror: kernels A, B and the shade must launch once a frame")
    check(all(int(o) == 0 for _, o in frames), "c4_mirror: cull overflow")
    img = frames[-1][0]
    check(tuple(img.shape) == (h, w, 3) and bool(torch.isfinite(img).all())
          and all(torch.equal(f[0], img) for f in frames),
          "c4_mirror: the frames must be finite and equal")
    with PlainVersions(culled, shade, shading, accel):
        img_plain = frame(c4m, "culled_pallas", cull=spec)[0]
    diff = (img - img_plain).abs().amax(dim=-1)
    share = float((diff <= 1.0 / 255.0).float().mean())
    log(f"  image vs plain versions on the card: {share:.6f} of pixels "
        f"within 1/255, max diff {float(diff.max()):.3e}; mean "
        f"{float(img.mean()):.5f}")
    check(share >= 0.999, "c4_mirror: image disagrees with the plain "
          "versions'")
    del frames, img_plain
    n_rays = rays_per_frame(h, w, c4m["scene"].lights.count, depth,
                            shadow_lights=c4m["lights"],
                            bounce_mask=c4m["bmask"])
    time_cell(torch, "c4_mirror", "frame",
              lambda: frame(c4m, "culled_pallas", cull=spec), 1, n_rays)
    init_fn, step_fn = make_train_step(
        c4m["cam"], FitConfig(height=h, width=w, depth=depth,
                              engine="culled_pallas", cull=spec,
                              trainable=DEFAULT_TRAINABLE),
        optimizer=lambda ps: torch.optim.SGD(ps, lr=STEP_LR))
    target = torch.zeros((h, w, 3), device=dev)
    params, opt = init_fn(c4m["scene"])
    kernels.LAUNCHES.clear()
    outs = [step_fn(params, opt, c4m["scene"], target)
            for _ in range(STEPS)]
    torch.cuda.synchronize()
    got = dict(kernels.LAUNCHES)
    launches["train_step_c4_mirror"] = got
    log(f"  launches over {STEPS} training steps: {got}; losses "
        f"{[float(o[2]) for o in outs]}; overflow {[int(o[3]) for o in outs]}")
    check(all(got.get(k, 0) == STEPS
              for k in c4_kernels + ("phong_shade_bwd",)),
          "c4_mirror: kernels A, B, 4 and 5 must launch once a step")
    check(all(int(o[3]) == 0 for o in outs), "c4_mirror: overflow training")

    def one_step_grads():
        p, o = init_fn(c4m["scene"])
        _, _, loss, _ = step_fn(p, o, c4m["scene"], target)
        return float(loss), {k: v.grad for k, v in p.items()}

    loss_k, grads_k = one_step_grads()
    with PlainVersions(culled, shade, shading, accel):
        loss_p, grads_p = one_step_grads()
    log(f"  first step's loss: kernels {loss_k:.9g}, plain versions "
        f"{loss_p:.9g}")
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p),
          "c4_mirror: training loss disagrees with the plain versions'")
    compare_grads(torch, "c4_mirror", grads_k, grads_p, "kernel - plain")
    time_cell(torch, "c4_mirror", "training step",
              lambda: step_fn(params, opt, c4m["scene"], target), 3, n_rays)
    log(f"  phase 19: {time.perf_counter() - t0:.1f} s")

    # ---- 20. the reference's rows on 'auto'
    t0 = time.perf_counter()
    log(f"[20/34] engine 'auto': frame and training step timing ({smi})")
    for cfg in ("c1_sphere_plane", "c2_eight_spheres",
                "animated_obb_720p_depth0", "animated_obb_720p_depth1"):
        pth = paths[cfg]
        h, w = pth["h"], pth["w"]
        n_rays = rays_per_frame(h, w, pth["scene"].lights.count,
                                pth["depth"], shadow_lights=pth["lights"],
                                bounce_mask=pth["bmask"])
        kernels.LAUNCHES.clear()
        time_cell(torch, cfg, "frame", lambda pth=pth: frame(pth, "auto"), 1,
                  n_rays)
        init_fn, step_fn = make_train_step(
            pth["cam"], FitConfig(height=h, width=w, depth=pth["depth"],
                                  trainable=pth["trainable"]),
            optimizer=lambda ps: torch.optim.SGD(ps, lr=STEP_LR))
        params, opt = init_fn(pth["scene"])
        target = torch.zeros((h, w, 3), device=dev)
        time_cell(torch, cfg, "training step",
                  lambda f=step_fn, p=params, o=opt, s=pth["scene"],
                  t=target: f(p, o, s, t), 3, n_rays)
        torch.cuda.synchronize()
        launches[f"auto_{cfg}"] = dict(kernels.LAUNCHES)
        check(not kernels.LAUNCHES, f"{cfg}: engine 'auto' launched kernels")
    log(f"  phase 20: {time.perf_counter() - t0:.1f} s")

    # ---- 21. 'autodiff' against the analytic backward
    t0 = time.perf_counter()
    log("[21/34] engine 'autodiff' (autograd through the chunked scan) "
        "against 'xla' (the analytic backward): gradients of mean(img^2)")
    cells = {f"animated_obb_720p_depth{d}": paths[
        f"animated_obb_720p_depth{d}"] for d in (0, 1)}
    cells[f"c4_mirror_{AUTODIFF_HW}"] = path(c4m["scene"], c4m["cam"],
                                             AUTODIFF_HW, AUTODIFF_HW, 1)
    for cfg, pth in cells.items():
        grads, peaks = {}, {}
        for engine in ("autodiff", "xla"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            s, params = train_scene(pth["scene"], pth["trainable"])
            img = render(s, pth["cam"], pth["h"], pth["w"],
                         depth=pth["depth"], engine=engine,
                         shadow_lights=pth["lights"],
                         bounce_mask=pth["bmask"])
            torch.mean(torch.square(img)).backward()
            torch.cuda.synchronize()
            peaks[engine] = torch.cuda.max_memory_allocated() / 2 ** 30
            grads[engine] = {k: v.grad for k, v in params.items()}
            del img, s, params
        log(f"  {cfg} ({pth['w']}x{pth['h']}, depth {pth['depth']}): peak "
            f"device memory of forward and backward: 'autodiff' "
            f"{peaks['autodiff']:.3f} GiB, 'xla' {peaks['xla']:.3f} GiB")
        compare_grads(torch, cfg, grads["autodiff"], grads["xla"],
                      "autodiff - analytic")
    log(f"  phase 21: {time.perf_counter() - t0:.1f} s")
    return launches


def deep_step(torch, cap, steps, min_level: int = 3):
    """From a culled stack frame's Capture: the deepest step (level >=
    min_level; the last such step first) whose kernel 2 hot launch has a
    truly hot tile and whose rays include zero-direction TIR rays, or
    failing that the deepest with a truly hot tile. Returns (step index,
    level, cold (args, kw), hot (args, kw), kernel B (args, kw))."""
    calls = {"cold": [], "hot": [], "shadow": []}
    for name, a, kw in cap.log:
        if name == "primary_hit_ray":
            calls["hot" if kw.get("tile_ids") is not None
                  else "cold"].append((a, kw))
        elif name == "shadow_occlusion":
            calls["shadow"].append((a, kw))
    check(all(len(v) == len(steps) for v in calls.values()),
          f"one cold, hot and kernel B call a step: "
          f"{ {k: len(v) for k, v in calls.items()} } for {len(steps)} steps")
    best = None
    for i in reversed(range(len(steps))):
        if steps[i][1] < min_level:
            continue
        hot = calls["hot"][i][0][5][:, 0] > 0
        tir = bool(((calls["cold"][i][0][0] == 0.0).all(dim=-1)).any())
        if bool(hot.any()) and (tir or best is None):
            best = i
            if tir:
                break
    check(best is not None, "no deep step with a truly hot tile")
    return (best, steps[best][1], calls["cold"][best], calls["hot"][best],
            calls["shadow"][best])


def run_stack(torch, dev, kernels, culled, shade, shading, accel, smi):
    """Phases 22-24: the stack bounce engine. glass_stack_depth4 (the OBB
    and glass world, 1024x1024, depth 4, 'xla' and 'pallas', stack against
    tree); glass4096_stack_culled (4096 glass spheres, culled_pallas,
    every DFS step on kernels 2 (cold and hot), B and 6); the culled
    stack's gradients on a 1024-sphere glass grid and the mirror chain on
    c4_mirror. Returns (per-path launch counts, max abs errors of kernels 2
    cold and hot and B on a deep step)."""
    from openglraytracer_tpu_torch.models.animated import reference_frame
    from openglraytracer_tpu_torch.models.builders import (BENCH_CONFIGS,
                                                           glass_grid_scene)
    from openglraytracer_tpu_torch.ops.render import _dfs_schedule, render
    from openglraytracer_tpu_torch.utils.metrics import rays_per_frame

    launches, errs = {}, {}
    steps = _dfs_schedule(STACK_DEPTH)
    n_steps = len(steps)

    def counted(fn):
        kernels.LAUNCHES.clear()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(kernels.LAUNCHES)

    def share_within(a, b):
        diff = (a - b).abs().amax(dim=-1)
        return float((diff <= 1.0 / 255.0).float().mean()), float(diff.max())

    # ---- 22. glass_stack_depth4
    t0 = time.perf_counter()
    h = w = STACK_HW
    scene, cam = reference_frame(OBB_TIME, device=dev)
    sm = shading.static_shadow_mask(scene)
    bm = shading.static_bounce_mask(scene)
    check(bm == (True, True), f"the glass world's bounce mask is {bm}")
    n_rays = rays_per_frame(h, w, scene.lights.count, STACK_DEPTH,
                            shadow_lights=sm)
    log(f"[22/34] glass_stack_depth4: reference_frame({OBB_TIME}) at "
        f"{w}x{h}, depth {STACK_DEPTH} ({n_steps} casts a pixel), shadow "
        f"lights {sm}; engines 'xla' and 'pallas', stack against tree; "
        f"{n_rays} rays/frame ({smi})")

    def frame(engine, bounce):
        with torch.no_grad():
            return render(scene, cam, h, w, depth=STACK_DEPTH, engine=engine,
                          bounce=bounce, shadow_lights=sm, bounce_mask=bm,
                          with_cull_stats=True)

    def step(engine, bounce):
        s, params = train_scene(scene, STACK_TRAINABLE)
        img, ovf = render(s, cam, h, w, depth=STACK_DEPTH, engine=engine,
                          bounce=bounce, shadow_lights=sm, bounce_mask=bm,
                          with_cull_stats=True)
        torch.mean(torch.square(img)).backward()
        return {k: v.grad for k, v in params.items()}, ovf

    imgs = {}
    for engine in ("xla", "pallas"):
        for bounce in ("stack", "tree"):
            (img, ovf), got = counted(lambda: frame(engine, bounce))
            launches[f"glass_stack_depth4_{engine}_{bounce}"] = got
            want = {} if engine == "xla" else {"dense_hit": n_steps}
            log(f"  {engine} {bounce} frame: launches {got}, overflow "
                f"{int(ovf)}, mean {float(img.mean()):.5f}")
            check(got == want, f"{engine} {bounce}: launches {got}, want "
                  f"{want}")
            check(tuple(img.shape) == (h, w, 3)
                  and bool(torch.isfinite(img).all()) and int(ovf) == 0,
                  f"{engine} {bounce}: a finite {h}x{w} image, no overflow")
            imgs[engine, bounce] = img
    for a, b in ((("xla", "stack"), ("xla", "tree")),
                 (("pallas", "stack"), ("xla", "stack")),
                 (("pallas", "stack"), ("pallas", "tree"))):
        what = f"'{a[0]}' {a[1]} vs '{b[0]}' {b[1]}"
        share, mx = share_within(imgs[a], imgs[b])
        log(f"  {what}: {share:.6f} of pixels within 1/255, max diff "
            f"{mx:.3e}")
        check(share >= 0.999, f"{what} disagree")
    del imgs
    cells = {}
    for engine in ("xla", "pallas"):
        grads = {}
        for bounce in ("stack", "tree"):
            cell = f"glass_stack_depth4 {engine} {bounce}"
            cells[cell, "frame"] = time_cell(
                torch, cell, "frame", lambda: frame(engine, bounce), 1,
                n_rays, warm=1, windows=3, frames=STACK_FRAMES, dev_reps=3)
            (grads[bounce], _), got = counted(lambda: step(engine, bounce))
            launches[f"train_glass_stack_depth4_{engine}_{bounce}"] = got
            # the stack recomputes each checkpointed step in the backward
            want = {} if engine == "xla" else {
                "dense_hit": n_steps * (2 if bounce == "stack" else 1)}
            log(f"  {cell} forward+backward: launches {got}")
            check(got == want, f"{cell} step: launches {got}, want {want}")
            cells[cell, "step"] = time_cell(
                torch, cell, "forward+backward", lambda: step(engine, bounce),
                1, n_rays, warm=1, windows=3, frames=STACK_STEPS, dev_reps=3)
        compare_grads(torch, f"glass_stack_depth4 {engine}", grads["stack"],
                      grads["tree"], "stack - tree")
    for engine in ("xla", "pallas"):
        for what in ("frame", "step"):
            st = cells[f"glass_stack_depth4 {engine} stack", what]
            tr = cells[f"glass_stack_depth4 {engine} tree", what]
            log(f"  {engine} {what}, stack / tree: device "
                f"{st['device_ms']:.2f} / {tr['device_ms']:.2f} ms, memory "
                f"above the resident {st['call_gib']:.3f} / "
                f"{tr['call_gib']:.3f} GiB")
    log(f"  phase 22: {time.perf_counter() - t0:.1f} s")

    # ---- 23. glass4096_stack_culled
    t0 = time.perf_counter()
    scene, cam = glass_grid_scene(device=dev)
    sm = shading.static_shadow_mask(scene)
    bm = shading.static_bounce_mask(scene)
    n = int(scene.spheres.count)
    spec = accel.suggest_stack_cull_config(
        scene, cam, h, w, (STACK_TILE, STACK_TILE), headroom=2.0,
        shadow_lights=sm)
    log(f"  sized stack spec {spec} ({time.perf_counter() - t0:.1f} s)")
    # the shadow lists go dense (Ks = N), as the reference's row sets them
    spec = (spec[0], spec[1], n, 0, spec[4], spec[5]) + tuple(spec[6:])
    hot = accel.cull_hot_p(spec) > 0
    lit = sum(map(bool, sm))
    wide = int(n >= accel.MIN_N_FOR_KERNEL)
    # per step: kernel 2's cold launch, its hot launch over the global
    # table, one kernel B launch (hot_m 0), and kernel 6 on the bounce-cone
    # mask, on the hot tiles' winner mask and on each lit light's mask
    want = {"primary_hit_ray": n_steps, "shadow_occlusion": n_steps,
            "compact_mask": n_steps * wide * (1 + int(hot) + lit)}
    if hot:
        want["primary_hit_hot"] = n_steps
    n_rays = rays_per_frame(h, w, scene.lights.count, STACK_DEPTH,
                            shadow_lights=sm)
    log(f"[23/34] glass4096_stack_culled: glass_grid_scene() ({n} glass "
        f"spheres), {w}x{h}, depth {STACK_DEPTH}, engine culled_pallas, "
        f"bounce 'stack', spec {spec}, shadow lights {sm}; launches a frame "
        f"by the code: {want}; {n_rays} rays/frame")

    def cframe():
        with torch.no_grad():
            return render(scene, cam, h, w, depth=STACK_DEPTH,
                          engine="culled_pallas", bounce="stack", cull=spec,
                          shadow_lights=sm, bounce_mask=bm,
                          with_cull_stats=True)

    with Capture(culled, shade, accel) as cap:
        cframe()
    torch.cuda.synchronize()
    frames, got = counted(lambda: [cframe() for _ in range(FRAMES)])
    launches["glass4096_stack_culled"] = got
    ovfs = [int(o) for _, o in frames]
    log(f"  launches over {FRAMES} frames: {got}; overflow per frame {ovfs}")
    check(got == {k: v * FRAMES for k, v in want.items()},
          f"launches {got}, want {FRAMES} x {want}")
    check(all(o == 0 for o in ovfs), "glass4096_stack_culled overflowed")
    img = frames[-1][0]
    check(tuple(img.shape) == (h, w, 3) and bool(torch.isfinite(img).all())
          and all(torch.equal(f[0], img) for f in frames),
          "the frames must be finite, of the image's shape and equal")
    del frames
    with torch.no_grad():
        (ref, _), got_p = counted(lambda: render(
            scene, cam, h, w, depth=STACK_DEPTH, engine="pallas",
            bounce="stack", bounce_mask=bm, with_cull_stats=True))
    share, mx = share_within(img, ref)
    log(f"  image vs the 'pallas' stack over all {n} spheres (kernel 7, "
        f"launches {got_p}): {share:.6f} of pixels within 1/255, max diff "
        f"{mx:.3e}; mean {float(img.mean()):.5f}")
    check(share >= 0.999, "the culled stack disagrees with the 'pallas' "
          "stack")
    del img, ref
    # kernels 2 and B bit for bit on one deep step's inputs, cut to the
    # hottest and some cold tiles (the zero-direction TIR rays' tiles first)
    i, level, (a_c, kw_c), (a_h, kw_h), (a_b, kw_b) = deep_step(
        torch, cap, steps)
    tile_p = a_c[6]
    n_tiles = a_c[5].shape[0]
    ids_h = kw_h["tile_ids"].long()
    truly = a_h[5][:, 0] > 0
    zero_t = (a_c[0] == 0.0).all(dim=-1).reshape(n_tiles, tile_p)
    hot_set = torch.zeros(n_tiles, dtype=torch.bool, device=dev)
    hot_set[ids_h[truly]] = True
    cold_ok = ~hot_set & (a_c[5][:, 0] > 0)
    tir_tiles = torch.nonzero(cold_ok & zero_t.any(dim=1)).flatten()
    tir_tiles = tir_tiles[:CUT_COLD // 2]
    rest = torch.nonzero(cold_ok).flatten()
    rest = rest[torch.linspace(0, rest.numel() - 1,
                               CUT_COLD - tir_tiles.numel(),
                               device=dev).long()]
    cold = torch.unique(torch.cat([tir_tiles, rest]))
    tir_h = zero_t[ids_h].any(dim=1)
    hb = torch.cat([torch.nonzero(truly & tir_h).flatten(),
                    torch.nonzero(truly & ~tir_h).flatten()])[:CUT_HOT]
    n_tir = int(zero_t[cold].sum()) + int(zero_t[ids_h[hb]].sum())
    log(f"  deep step {i} (level {level}): {int(truly.sum())} truly hot "
        f"tiles of {ids_h.numel()}; {int(zero_t.sum())} zero-direction rays "
        f"in {int(zero_t.any(dim=1).sum())} tiles; cut: {cold.numel()} cold "
        f"tiles ({tir_tiles.numel()} with TIR rays), {hb.numel()} hot; "
        f"{n_tir} zero-direction rays in the cuts")
    check(n_tir > 0 or not bool(zero_t.any()),
          "the cuts leave out the step's zero-direction rays")

    def rays(x, ids):
        return x.reshape(n_tiles, tile_p, 3)[ids].reshape(-1, 3).contiguous()

    cut_c = (rays(a_c[0], cold), rays(a_c[1], cold),
             a_c[2][cold].contiguous(), a_c[3][cold].contiguous(), a_c[4],
             a_c[5][cold].contiguous(), tile_p)
    cut_h = (rays(a_h[0], ids_h[hb]), rays(a_h[1], ids_h[hb]), a_h[2],
             a_h[3], a_h[4], a_h[5][hb].contiguous(), tile_p)
    ids_cut = torch.arange(hb.numel(), dtype=torch.int32, device=dev)
    plain2 = primary_hit_ray_plain(culled)
    for what, args, kw, name in (
            ("cold", cut_c, {}, "primary_hit_ray"),
            ("hot", cut_h, {"tile_ids": ids_cut}, "primary_hit_hot")):
        got_k = culled.primary_hit_ray(*args, **kw)
        errs[name] = compare_primary(
            torch, got_k, plain2(*args, **kw),
            f"glass4096 level {level} {what} cut", name, exact=True)[1]
        zero = (args[0] == 0.0).all(dim=-1)
        check(not bool((got_k[0][zero] < 1e4).any()),
              f"a zero-direction ray hit in kernel 2's {what} launch")
    check(a_b[9] is None, "kernel B's hot launch is off (hot_m 0)")
    b_tiles = torch.unique(torch.cat([cold, ids_h[hb]]))
    t_of = b_tiles.repeat_interleave(tile_p) * tile_p + torch.arange(
        tile_p, device=dev).repeat(b_tiles.numel())
    cut_b = (a_b[0][t_of].contiguous(), a_b[1][t_of].contiguous(), a_b[2],
             a_b[3], a_b[4][b_tiles].contiguous(),
             a_b[5][b_tiles].contiguous(), a_b[6],
             a_b[7][b_tiles].contiguous(), tile_p) + tuple(a_b[9:])
    log(f"  kernel B cut: {b_tiles.numel()} tiles, survivor rows "
        f"{tuple(cut_b[4].shape)}, max count "
        f"{int(cut_b[7][..., 0].max())}")
    errs["shadow_occlusion"] = compare_shadow(
        torch, culled.shadow_occlusion(*cut_b, **kw_b),
        culled.shadow_occlusion_plain(*cut_b, **kw_b),
        f"glass4096 level {level} cut")[1]
    del cap
    time_cell(torch, "glass4096_stack_culled", "frame", cframe, 1, n_rays,
              warm=1, windows=2, frames=3, dev_reps=3)
    trainable = ("spheres.center", "materials.diffuse")

    def cstep():
        s, params = train_scene(scene, trainable)
        img, ovf = render(s, cam, h, w, depth=STACK_DEPTH,
                          engine="culled_pallas", bounce="stack", cull=spec,
                          shadow_lights=sm, bounce_mask=bm,
                          with_cull_stats=True)
        torch.mean(torch.square(img)).backward()
        return {k: v.grad for k, v in params.items()}, ovf

    (g, ovf), got = counted(cstep)
    launches["train_glass4096_stack_culled"] = got
    log(f"  one forward+backward step w.r.t. {trainable}: launches {got}, "
        f"overflow {int(ovf)}, finite gradients "
        f"{all(bool(torch.isfinite(x).all()) for x in g.values())}")
    check(int(ovf) == 0, "glass4096_stack_culled step overflowed")
    time_cell(torch, "glass4096_stack_culled", "forward+backward", cstep, 1,
              n_rays, warm=0, windows=2, frames=1, dev_reps=1)
    log(f"  phase 23: {time.perf_counter() - t0:.1f} s")

    # ---- 24. the culled stack's gradients and the mirror chain
    t0 = time.perf_counter()
    side, gh, gdepth = GLASS_GRAD["side"], GLASS_GRAD["hw"], \
        GLASS_GRAD["depth"]
    scene, cam = glass_grid_scene(side, device=dev)
    n = int(scene.spheres.count)
    spec = ((STACK_TILE, STACK_TILE), n, n, 0, 0, 0)
    sm = shading.static_shadow_mask(scene)
    bm = shading.static_bounce_mask(scene)
    log(f"[24/34] culled stack gradients: glass_grid_scene({side}) ({n} "
        f"spheres), {gh}x{gh}, depth {gdepth}, spec {spec} (no list can "
        f"overflow), culled_pallas against its plain versions, 'pallas' "
        f"and 'xla'; then render(mirror_only=True) on c4_mirror")

    def run(engine):
        s, params = train_scene(scene, trainable)
        img, ovf = render(s, cam, gh, gh, depth=gdepth, engine=engine,
                          bounce="stack", shadow_lights=sm, bounce_mask=bm,
                          with_cull_stats=True,
                          cull=spec if engine == "culled_pallas" else None)
        torch.mean(torch.square(img)).backward()
        check(int(ovf) == 0, f"{engine}: overflow")
        return img.detach(), {k: v.grad for k, v in params.items()}

    out = {}
    for engine in ("culled_pallas", "pallas", "xla"):
        out[engine], got = counted(lambda: run(engine))
        launches[f"train_glass{n}_stack_{engine}"] = got
        log(f"  {engine}: launches {got}, overflow 0")
    check(launches[f"train_glass{n}_stack_culled_pallas"].get(
        "compact_mask", 0) > 0, "kernel 6 did not run")
    with PlainVersions(culled, shade, shading, accel):
        out["plain"] = run("culled_pallas")
    # held to the same stack through the plain versions on the card, whose
    # discrete outputs are those of the kernels bit for bit, and, for the
    # image, to kernel 7's 'pallas', an independent engine; the gradients
    # against 'pallas' and 'xla' and the image against 'xla' are reported.
    # The centers' gradient of refracting glass is singular at grazes and
    # at the edge of total internal reflection: where kernels 2 and 7 round
    # one grazing ray apart (one pixel of 262,144 differs by 1.4e-2), it
    # moved the sum by 2.5e-3 max|g| on the H100; the JAX package's own
    # eager 'xla' and 'pallas' engines differ by 2.1 max|g| on a 256-sphere
    # grid. And 'xla''s sphere quadratic (the reference's, qb^2 - 4 qa qc,
    # each op rounded once) misses the float64 primary t by up to 2.3e-3
    # at the grid's 70-80 units, more than the 1e-3 bounce offset, so some
    # of its refraction children start outside their sphere and hit it
    # again; the kernels round as the Mosaic kernels do (0.2-0.8e-3).
    for other in ("plain", "pallas", "xla"):
        share, mx = share_within(out["culled_pallas"][0], out[other][0])
        held = other != "xla"
        log(f"  image: {share:.6f} of pixels within 1/255 of '{other}', max "
            f"diff {mx:.3e}" + ("" if held else " (reported, not held)"))
        check(share >= 0.999 or not held,
              f"the culled stack's image disagrees with '{other}'")
    compare_grads(torch, f"glass{n} stack", out["culled_pallas"][1],
                  out["plain"][1], "kernels - plain")
    for other in ("pallas", "xla"):
        for k, g in out[other][1].items():
            err = float((out["culled_pallas"][1][k] - g).abs().max())
            log(f"  glass{n} stack grad {k} against '{other}' (reported, "
                f"not held): {err / max(float(g.abs().max()), 1e-30):.2e} "
                f"of max |g|")
    del out
    builder, mh, mw, _ = BENCH_CONFIGS["c4_mirror"]
    scene, cam = builder(device=dev)
    sm = shading.static_shadow_mask(scene)
    bm = shading.static_bounce_mask(scene)
    mdepth = MIRROR_DEPTH

    def mframe(mirror_only):
        with torch.no_grad():
            return render(scene, cam, mh, mw, depth=mdepth, shadow_lights=sm,
                          bounce_mask=bm, mirror_only=mirror_only)
    chain, got = counted(lambda: mframe(True))
    tree, got_t = counted(lambda: mframe(False))
    share, mx = share_within(chain, tree)
    ms = {k: statistics.median(device_ms(torch, mframe, (k == "chain",),
                                         reps=1) for _ in range(3))
          for k in ("chain", "tree")}
    log(f"  c4_mirror {mw}x{mh}, depth {mdepth}: mirror_only chain "
        f"(launches {got}) vs the tree on 'xla' (launches {got_t}, bounce "
        f"mask {bm}): {share:.6f} of pixels within 1/255, max diff "
        f"{mx:.3e}; frame device time chain {ms['chain']:.4f} ms, tree "
        f"{ms['tree']:.4f} ms")
    check(not got and not got_t and share >= 0.999,
          "the mirror chain disagrees with the tree")
    log(f"  phase 24: {time.perf_counter() - t0:.1f} s")
    return launches, errs


def run_culled_xla(torch, dev, kernels, culled, shade, shading, accel, smi):
    """Phases 25-29: the XLA culled engine 'culled' (the narrow phase in
    plain PyTorch, kernel 6 on masks of 1024 objects or more) on the
    reference's rows c3_grid64_culled_xla, c5_grid4096_culled_xla,
    c4_mirror4096_xlachild and c4_mirror4096_densechild, and the culled
    stack on 'culled' (the 1024-sphere glass grid). Each cell: kernel 6
    against its plain version on every mask a frame hands it, 3 frames and
    3 training steps with their launches as the code counts them and no
    overflow, the image and the gradients held to the plain dense engine
    'xla' and reported against culled_pallas (see XLA_HELD), and the frame
    and step timed. Returns the per-path launch counts."""
    from openglraytracer_tpu_torch.models.builders import (BENCH_CONFIGS,
                                                           glass_grid_scene)
    from openglraytracer_tpu_torch.ops.render import _dfs_schedule, render
    from openglraytracer_tpu_torch.train.inverse import (DEFAULT_TRAINABLE,
                                                         FitConfig,
                                                         make_train_step)
    from openglraytracer_tpu_torch.utils.metrics import rays_per_frame

    launches = {}

    def counted(fn):
        kernels.LAUNCHES.clear()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(kernels.LAUNCHES)

    def share_within(a, b):
        diff = (a - b).abs().amax(dim=-1)
        return (float((diff <= 1.0 / 255.0).float().mean()),
                int((diff > 1.0 / 255.0).sum()), float(diff.max()))

    def frames_checked(cell, frame, want, key):
        """FRAMES frames, the first with its kernel 6 masks captured and
        each held to the plain version; the launches against FRAMES x
        want. Returns the last image and the overflow per frame."""
        with Capture(culled, shade, accel) as cap:
            frames, got = counted(lambda: [frame() for _ in range(FRAMES)])
        n_wide = 0
        for mask, k in cap.calls[:len(cap.calls) // FRAMES]:
            if mask.shape[-1] < accel.MIN_N_FOR_KERNEL:
                continue
            n_wide += 1
            ki, kv, kc = accel.compact_mask(mask, k)
            pi, pv, pc = accel.compact_mask_plain(mask, k)
            check(torch.equal(kv, pv) and torch.equal(kc, pc)
                  and torch.equal(ki * kv, pi * pv)
                  and not bool(ki[~kv].any()),
                  f"{cell}: kernel 6 disagrees with its plain version on "
                  f"a {tuple(mask.shape)} mask")
        del cap
        launches[key] = got
        ovfs = [int(o) for _, o in frames]
        log(f"  launches over {FRAMES} frames: {got}; kernel 6 equal to its "
            f"plain version on all {n_wide} masks of 1024 objects or more "
            f"the first frame compacts; overflow per frame {ovfs}")
        check(got == {k: v * FRAMES for k, v in want.items()}
              and n_wide == want.get("compact_mask", 0),
              f"{cell}: launches {got}, want {FRAMES} x {want}")
        img = frames[-1][0]
        check(bool(torch.isfinite(img).all())
              and all(torch.equal(f[0], img) for f in frames),
              f"{cell}: the frames must be finite and equal")
        return img, ovfs

    def grads_of(scene, render_fn, trainable=DEFAULT_TRAINABLE):
        """The image and the gradients of mean(img^2) (the training step's
        loss against its zero target) from one forward through
        render_fn(scene) -> img."""
        s, params = train_scene(scene, trainable)
        img = render_fn(s)
        torch.mean(torch.square(img)).backward()
        return img.detach(), {k: v.grad for k, v in params.items()}

    def held_and_reported(cell, img, grads, dense, kernels_, hold_grads=True):
        """The image within 1/255 of the dense engine's on >= 99.9 % of
        pixels, and against the kernel engine's reported. With hold_grads,
        each gradient within GRAD_TOL * max|g| of the engine that computes
        it as 'culled' does (XLA_HELD_GRADS), and against the other
        reported; else all reported. dense, kernels_: (name, image,
        gradients)."""
        for (name, ref, _), hold in ((dense, True), (kernels_, False)):
            share, n_out, mx = share_within(img, ref)
            log(f"  image vs {name}: {share:.6f} of pixels within 1/255 "
                f"({n_out} outside), max diff {mx:.3e}"
                + ("" if hold else " (reported)"))
            check(share >= 0.999 or not hold,
                  f"{cell}: the image disagrees with {name}")
        for k in grads:
            held = XLA_HELD_GRADS.get(k.split(".")[0]) if hold_grads else None
            for name, _, ref_g in (dense, kernels_):
                if name == held:
                    compare_grads(torch, cell, {k: grads[k]}, {k: ref_g[k]},
                                  f"'culled' - {name}")
                else:
                    g = ref_g[k]
                    err = float((grads[k] - g).abs().max())
                    log(f"  {cell} grad {k} against {name} (reported): "
                        f"{err / max(float(g.abs().max()), 1e-30):.2e} of "
                        f"max |g|")

    dense_refs = {}
    for i, (cell, (cfg, tile, children)) in enumerate(XLA_CELLS.items()):
        t0 = time.perf_counter()
        builder, h, w, depth = BENCH_CONFIGS[cfg]
        scene, cam = builder(device=dev)
        lights = shading.static_shadow_mask(scene)
        bmask = shading.static_bounce_mask(scene) if depth else (True, True)
        lit = sum(map(bool, lights))
        spec = accel.suggest_cull_config(scene, cam, h, w, (tile, tile),
                                         shadow_lights=lights)
        child = ref_child = None
        if children == "culled":
            child = accel.suggest_child_cull_config(
                scene, cam, h, w, spec, shadow_lights=lights,
                hot_primary=False)
            ref_child = accel.suggest_child_cull_config(
                scene, cam, h, w, spec, shadow_lights=lights)
        # kernel 6 a frame, by the code: each culled cast (the parent, and
        # with culled children each live bounce branch) compacts its primary
        # mask and one shadow mask per lit light, where N >= 1024
        casts = 1 + (sum(bmask) if children == "culled" else 0)
        wide = int(scene.spheres.count) >= accel.MIN_N_FOR_KERNEL
        want = {"compact_mask": casts * (1 + lit)} if wide else {}
        kw = dict(depth=depth, shadow_lights=lights, bounce_mask=bmask)
        n_rays = rays_per_frame(h, w, scene.lights.count, depth,
                                shadow_lights=lights, bounce_mask=bmask)
        log(f"[{25 + i}/34] {cell}: {cfg} {w}x{h}, depth {depth}, engine "
            f"'culled', spec {spec}"
            + (f", child spec {child} (hot_primary=False; culled_pallas's "
               f"{ref_child})" if child else "")
            + (", children on 'xla'" if children == "dense" else "")
            + f"; kernel 6 a frame and a step by the code: {want}; sizing "
            f"{time.perf_counter() - t0:.1f} s ({smi})")

        def frame(engine="culled", cc=child):
            with torch.no_grad():
                return render(scene, cam, h, w, engine=engine, cull=spec,
                              child_cull=cc, with_cull_stats=True, **kw)

        def trace(engine, cc):
            return lambda s: render(s, cam, h, w, engine=engine, cull=spec,
                                    child_cull=cc, **kw)

        img, ovfs = frames_checked(cell, frame, want, f"render_{cell}")
        check(tuple(img.shape) == (h, w, 3) and all(o == 0 for o in ovfs),
              f"{cell}: image shape {tuple(img.shape)}, overflow {ovfs}")
        if cfg not in dense_refs:    # both c4_mirror4096 rows share one
            t1 = time.perf_counter()
            dense_refs[cfg] = grads_of(scene, lambda s: render(
                s, cam, h, w, engine="xla", row_block=min(h, XLA_ROW_BLOCK),
                **kw))
            log(f"  the plain dense engine 'xla' (every ray against all "
                f"{int(scene.spheres.count)} spheres, {XLA_ROW_BLOCK} rows a "
                f"block): image and gradients in "
                f"{time.perf_counter() - t1:.1f} s")
        img_g, grads = grads_of(scene, trace("culled", child))
        check(torch.equal(img_g, img), f"{cell}: the step's image differs")
        held_and_reported(
            cell, img, grads, ("'xla'", *dense_refs[cfg]),
            ("culled_pallas", *grads_of(scene, trace("culled_pallas",
                                                     ref_child))))
        del img, img_g, grads
        # fewer timed calls where a frame takes 0.1 s (c5) or a second (the
        # depth-1 rows, warm from the frames and steps before)
        timing = (dict(warm=0, windows=2, frames=1, dev_reps=1) if depth
                  else dict(warm=1, windows=2, frames=3, dev_reps=3)
                  if h * w > H * W else {})
        time_cell(torch, cell, "frame", frame, 1, n_rays, **timing)

        target = torch.zeros((h, w, 3), device=dev)
        init_fn, step_fn = make_train_step(
            cam, FitConfig(height=h, width=w, depth=depth, engine="culled",
                           cull=spec, child_cull=child,
                           trainable=DEFAULT_TRAINABLE),
            optimizer=lambda ps: torch.optim.SGD(ps, lr=STEP_LR))
        params, opt = init_fn(scene)
        outs, got = counted(lambda: [step_fn(params, opt, scene, target)
                                     for _ in range(STEPS)])
        launches[f"train_step_{cell}"] = got
        log(f"  launches over {STEPS} training steps: {got}; losses "
            f"{[float(o[2]) for o in outs]}; overflow "
            f"{[int(o[3]) for o in outs]}")
        check(got == {k: v * STEPS for k, v in want.items()},
              f"{cell}: step launches {got}, want {STEPS} x {want}")
        check(all(int(o[3]) == 0 for o in outs), f"{cell}: overflow "
              "training")
        del outs
        time_cell(torch, cell, "training step",
                  lambda: step_fn(params, opt, scene, target), 3, n_rays,
                  **timing)
        del params, opt
        log(f"  phase {25 + i}: {time.perf_counter() - t0:.1f} s")
    del dense_refs

    # ---- 29. the stack on 'culled'
    t0 = time.perf_counter()
    side, hw, depth = XLA_STACK["side"], XLA_STACK["hw"], XLA_STACK["depth"]
    scene, cam = glass_grid_scene(side, device=dev)
    n = int(scene.spheres.count)
    sm = shading.static_shadow_mask(scene)
    bm = shading.static_bounce_mask(scene)
    spec = accel.suggest_stack_cull_config(
        scene, cam, hw, hw, (STACK_TILE, STACK_TILE), headroom=2.0,
        shadow_lights=sm)
    # the shadow lists go dense (Ks = N), as phase 23's and the reference's
    # glass4096_stack_culled row set them
    spec = (spec[0], spec[1], n, 0, spec[4], spec[5]) + tuple(spec[6:])
    n_steps = len(_dfs_schedule(depth))
    want = {"compact_mask": n_steps * (1 + sum(map(bool, sm)))}
    n_rays = rays_per_frame(hw, hw, scene.lights.count, depth,
                            shadow_lights=sm)
    trainable = ("spheres.center", "materials.diffuse")
    log(f"[29/34] the stack on 'culled': glass_grid_scene({side}) ({n} "
        f"glass spheres), {hw}x{hw}, depth {depth} ({n_steps} casts a "
        f"pixel), bounce mask {bm}, spec {spec}; kernel 6 a frame by the "
        f"code: {want}, twice that a forward+backward (each step is "
        f"recomputed); {n_rays} rays/frame ({smi})")

    def sframe(engine="culled"):
        with torch.no_grad():
            return render(scene, cam, hw, hw, depth=depth, engine=engine,
                          bounce="stack", cull=spec, shadow_lights=sm,
                          bounce_mask=bm, with_cull_stats=True)

    def strace(engine):
        return lambda s: render(s, cam, hw, hw, depth=depth, engine=engine,
                                bounce="stack", shadow_lights=sm,
                                bounce_mask=bm,
                                cull=spec if engine.startswith("culled")
                                else None)

    def sstep():
        s, params = train_scene(scene, trainable)
        img, ovf = render(s, cam, hw, hw, depth=depth, engine="culled",
                          bounce="stack", cull=spec, shadow_lights=sm,
                          bounce_mask=bm, with_cull_stats=True)
        torch.mean(torch.square(img)).backward()
        return {k: v.grad for k, v in params.items()}, ovf

    img, ovfs = frames_checked("culled stack", sframe, want,
                               "glass1024_stack_culled_xla")
    log(f"  overflow per frame {ovfs} (reported: the 'culled' stack has no "
        f"hot-primary pass)")
    # held to the 'xla' stack (the same arithmetic, every sphere); the
    # gradients only reported: the glass grid's centers' gradient is
    # singular at grazes and at the edge of total internal reflection
    # (phase 24, PERF.md)
    img_g, grads = grads_of(scene, strace("culled"), trainable)
    check(torch.equal(img_g, img), "culled stack: the step's image differs")
    held_and_reported("culled stack", img, grads,
                      ("the 'xla' stack", *grads_of(scene, strace("xla"),
                                                    trainable)),
                      ("the culled_pallas stack", *grads_of(
                          scene, strace("culled_pallas"), trainable)),
                      hold_grads=False)
    del img, img_g, grads
    time_cell(torch, "glass1024_stack_culled_xla", "frame", sframe, 1, n_rays,
              warm=0, windows=2, frames=1, dev_reps=1, allow_overflow=True)
    outs, got = counted(lambda: [sstep() for _ in range(STEPS)])
    launches["train_glass1024_stack_culled_xla"] = got
    log(f"  launches over {STEPS} forward+backward steps: {got}; overflow "
        f"{[int(o[1]) for o in outs]} (reported)")
    check(got == {k: 2 * v * STEPS for k, v in want.items()},
          f"culled stack step: launches {got}, want {2 * STEPS} x {want}")
    check(all(all(bool(torch.isfinite(g).all()) for g in o[0].values())
              for o in outs), "culled stack: non-finite gradients")
    del outs
    time_cell(torch, "glass1024_stack_culled_xla", "forward+backward", sstep,
              1, n_rays, warm=0, windows=2, frames=1, dev_reps=1,
              allow_overflow=True)
    log(f"  phase 29: {time.perf_counter() - t0:.1f} s")
    return launches


def _c5_fit_script():
    """scripts/c5_fit_torch.py as a module: its curriculum constants, its
    orbited cameras and its optimizer."""
    import importlib.util
    path = Path(__file__).resolve().parent / "scripts" / "c5_fit_torch.py"
    spec = importlib.util.spec_from_file_location("c5_fit_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _perturbed(torch, scene, dev):
    """The c5 fit's starting scene: centers, radii and diffuse colors
    perturbed with noise from a torch.Generator seeded with 0, as
    scripts/c5_fit_torch.py perturbs them."""
    gen = torch.Generator().manual_seed(0)
    sph, mats = scene.spheres, scene.materials

    def noise(x):
        return torch.randn(x.shape, generator=gen).to(dev)
    return scene._replace(
        spheres=sph._replace(
            center=sph.center + 0.1 * noise(sph.center),
            radius=torch.clamp(sph.radius + 0.05 * noise(sph.radius),
                               min=0.1)),
        materials=mats._replace(diffuse=torch.clamp(
            mats.diffuse + 0.3 * noise(mats.diffuse), 0.0, 1.0)))


def run_training_extras(torch, dev, kernels, culled, shade, shading, accel,
                        smi, lib_dir):
    """Phases 30-31: the reference's config 5 fit (BASELINE.json config 5,
    scripts/c5_fit_acceptance.py) at full width, 4096 spheres. 30: the soft
    multi-view step (three orbited views) at 512x512 and 2048x2048, kernel
    6 launched as counted and equal to its plain version on every mask,
    timed with its device time and memory; on one view at 512x512 the
    culled soft forward and its gradients against the dense soft pass and
    the plain compaction. 31: the hard stage's engine and spec at
    2048x2048, a checkpointed fit resumed by a fresh fit equal to an
    uninterrupted one bit for bit; and c3 'autodiff' with remat on and
    off. Returns (the per-path launch counts, kernel 6's soft cells)."""
    import shutil
    from openglraytracer_tpu_torch.models.builders import (BENCH_CONFIGS,
                                                           sphere_grid_scene)
    from openglraytracer_tpu_torch.ops.soft import (soft_render,
                                                    suggest_soft_cull)
    from openglraytracer_tpu_torch.ops.render import render
    from openglraytracer_tpu_torch.train.inverse import (DEFAULT_TRAINABLE,
                                                         FitConfig, fit,
                                                         get_path,
                                                         make_train_step)
    c5fit = _c5_fit_script()
    launches, cells = {}, {}
    scene_true, cam = sphere_grid_scene(64, seed=1, device=dev)
    scene_init = _perturbed(torch, scene_true, dev)
    cams = tuple(c5fit.orbit_camera(cam, v) for v in c5fit.SOFT_VIEWS)
    trainable = c5fit.TRAINABLE
    # the camera inverse's LU and the rays' arithmetic run on the card: on
    # the CPU's camera matrices both equal the CPU's (which equal the
    # reference's, tests/test_torch_scene.py) bit for bit; end to end the
    # rays also take the card's float32 tan, sin and cos, an ulp off the
    # CPU's at places, which a far camera magnifies (reported)
    from openglraytracer_tpu_torch.ops import raygen
    from openglraytracer_tpu_torch.ops.transforms import inv4
    ray_err = 0.0
    for c in cams:
        on_cpu = c._replace(**{k: v.cpu() for k, v in c._asdict().items()})
        mats = raygen.camera_matrices(on_cpu)
        want = raygen.generate_rays(on_cpu, 512, 512)[1]
        proj, view = mats[0], mats[1]
        pv = proj[:, 0:1] * view[0:1, :]
        for k in range(1, 4):
            pv = pv + proj[:, k:k + 1] * view[k:k + 1, :]
        check(torch.equal(inv4(pv.to(dev)).cpu(), mats[2]),
              "the camera inverse on the card differs from the CPU's")
        real = raygen.camera_matrices
        raygen.camera_matrices = lambda cam_: tuple(m.to(dev) for m in mats)
        try:
            same = raygen.generate_rays(c, 512, 512)[1].cpu()
        finally:
            raygen.camera_matrices = real
        check(torch.equal(same, want), "the card's ray arithmetic differs "
              "from the CPU's on the same camera matrices")
        got = raygen.generate_rays(c, 512, 512)[1].cpu()
        ray_err = max(ray_err, float((got - want).abs().max()))
    log(f"  on the CPU's camera matrices the card's camera inverse and rays "
        f"of the {len(cams)} views at 512x512 equal the CPU's bit for bit; "
        f"end to end, with the card's trig, {ray_err:.3e} off (reported)")

    # ---- 30. the soft multi-view step
    for res, tile, bw, gamma, geo_lr, photo_lr, n_steps, frames in SOFT_CELLS:
        t0 = time.perf_counter()
        cell = f"c5_soft_{res}"
        culls = tuple(suggest_soft_cull(scene_true, c, res, res,
                                        (tile, tile), bw, headroom=2.0)
                      for c in cams)
        with torch.no_grad():
            target = torch.stack([
                soft_render(scene_true, c, res, res, bw=bw, gamma=gamma,
                            cull=cu) for c, cu in zip(cams, culls)])
        cfg = FitConfig(height=res, width=res, trainable=trainable,
                        soft=(bw, gamma), cull=culls)
        init_fn, step_fn = make_train_step(
            cams, cfg, optimizer=c5fit.make_optimizer(100, geo_lr, photo_lr))
        params, opt = init_fn(scene_init)
        want = {"compact_mask": len(cams)}
        log(f"[30/34] {cell}: sphere_grid_scene(64), {res}x{res}, "
            f"{tile}x{tile} tiles, bw {bw}, gamma {gamma}, views "
            f"{c5fit.SOFT_VIEWS}, soft specs {culls} "
            f"(suggest_soft_cull, headroom 2); kernel 6 a step by the code: "
            f"{want}; setup {time.perf_counter() - t0:.1f} s ({smi})")
        with Capture(culled, shade, accel) as cap:
            kernels.LAUNCHES.clear()
            outs = [step_fn(params, opt, scene_init, target)
                    for _ in range(n_steps)]
            torch.cuda.synchronize()
            got = dict(kernels.LAUNCHES)
        launches[f"train_step_{cell}"] = got
        ovfs = [int(o[3]) for o in outs]
        losses = [float(o[2]) for o in outs]
        log(f"  launches over {n_steps} steps: {got}; losses {losses}; "
            f"overflow {ovfs}")
        check(got == {k: v * n_steps for k, v in want.items()},
              f"{cell}: launches {got}, want {n_steps} x {want}")
        check(all(o == 0 for o in ovfs), f"{cell}: soft cull overflow")
        check(all(v == v and abs(v) < float("inf") for v in losses),
              f"{cell}: non-finite loss")
        masks = cap.calls[:len(cams)]
        for mask, k in masks:
            ki, kv, kc = accel.compact_mask(mask, k)
            pi, pv, pc = accel.compact_mask_plain(mask, k)
            check(torch.equal(kv, pv) and torch.equal(kc, pc)
                  and torch.equal(ki * kv, pi * pv)
                  and not bool(ki[~kv].any()),
                  f"{cell}: kernel 6 disagrees with its plain version on a "
                  f"{tuple(mask.shape)} mask")
        log(f"  kernel 6 equal to its plain version on the first step's "
            f"{len(masks)} masks {[tuple(m.shape) for m, _ in masks]}")
        del outs, cap
        timing = time_cell(torch, cell, "soft step (3 views)",
                           lambda: step_fn(params, opt, scene_init, target),
                           3, len(cams) * res * res, warm=0, windows=3,
                           frames=frames, dev_reps=1)
        mask, k = masks[0]
        with torch.no_grad():
            ms = in_turns(torch, lambda: accel.compact_mask(mask, k),
                          None)[0]
            plain_ms = device_ms(torch, accel.compact_mask_plain, (mask, k))
            b_ms, b_by, _, _ = bound(torch, "compact_mask",
                                     accel.compact_mask, (mask, k))
        cells[cell] = dict(mask=list(mask.shape), k=k, ms=ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           launches_per_step=want["compact_mask"],
                           step_device_ms=timing["device_ms"],
                           step_median_ms=timing["median_ms"],
                           step_peak_gib_above=timing["call_gib"])
        log(f"  kernel 6 on the soft {tuple(mask.shape)} mask: {ms:.4f} ms, "
            f"plain version {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}")
        del params, opt, masks, mask
        if res == SOFT_CHECK_RES:
            soft_culled_vs_dense(torch, scene_init, cams[0], culls[0], bw,
                                 gamma, trainable, culled, shade, shading,
                                 accel, cell)
        log(f"  phase 30 ({cell}): {time.perf_counter() - t0:.1f} s")

    # ---- 31. the checkpointed hard stage, and remat
    t0 = time.perf_counter()
    res, _, geo_lr, photo_lr = c5fit.HARD_STAGE
    cull = accel.suggest_cull_config(scene_true, cam, res, res, (32, 32),
                                     headroom=2.0, hot=False)
    with torch.no_grad():
        target = render(scene_true, cam, res, res, engine="culled",
                        cull=cull)
    ckdir = lib_dir / "ckpt_phase31"
    shutil.rmtree(ckdir, ignore_errors=True)
    n_all, n_first, every = CKPT_STEPS
    log(f"[31/34] checkpointed hard stage: sphere_grid_scene(64), "
        f"{res}x{res}, engine 'culled', spec {cull} (hot=False, headroom "
        f"2); {n_all} steps uninterrupted, then {n_first} steps saving "
        f"every {every} and a fresh fit to {n_all} from {ckdir.name}/; "
        f"torch deterministic algorithms on ({smi})")

    def run(steps, ckpt=None):
        cfg = FitConfig(height=res, width=res, steps=steps,
                        trainable=trainable, engine="culled", cull=cull,
                        checkpoint_dir=ckpt, checkpoint_every=every,
                        log_every=1)
        kernels.LAUNCHES.clear()
        fitted, losses = fit(scene_init, target, cam, cfg,
                             optimizer=c5fit.make_optimizer(
                                 n_all, geo_lr, photo_lr))
        torch.cuda.synchronize()
        return fitted, losses, dict(kernels.LAUNCHES)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t1 = time.perf_counter()
        fit_u, loss_u, got_u = run(n_all)
        u_s = time.perf_counter() - t1
        fit_a, loss_a, _ = run(n_first, str(ckdir))
        saved = sorted(p.name for p in ckdir.iterdir())
        fit_b, loss_b, got_b = run(n_all, str(ckdir))
    finally:
        torch.use_deterministic_algorithms(False)
    launches["fit_c5_culled_uninterrupted"] = got_u
    launches["fit_c5_culled_resumed"] = got_b
    log(f"  uninterrupted: {n_all} steps in {u_s:.1f} s, losses "
        f"{[(s, round(v, 8)) for s, v in loss_u]}, launches {got_u}")
    log(f"  first run: losses {[(s, round(v, 8)) for s, v in loss_a]}; "
        f"saved {saved}")
    log(f"  resumed: logged steps {[s for s, _ in loss_b]}, losses "
        f"{[(s, round(v, 8)) for s, v in loss_b]}, launches {got_b}")
    check(saved == [f"ckpt_{s:09d}.pt" for s in range(every, n_first + 1,
                                                       every)],
          f"checkpoints saved {saved}")
    check([s for s, _ in loss_b] == list(range(n_first, n_all)),
          "the resumed fit must restore the saved step and run only the "
          "remainder")
    check(got_b == {"compact_mask": got_u["compact_mask"] * (n_all - n_first)
                    // n_all},
          f"resumed launches {got_b} against {got_u} over {n_all} steps")
    for k in trainable:
        a, b = get_path(fit_b, k), get_path(fit_u, k)
        log(f"  {k}: resumed vs uninterrupted max |diff| "
            f"{float((a - b).abs().max()):.3e}")
        check(torch.equal(a, b), f"the resumed fit's {k} differs from the "
              "uninterrupted fit's")
    log(f"  the resumed fit's parameters equal the uninterrupted fit's bit "
        f"for bit; its losses {[round(v, 8) for _, v in loss_b]} against "
        f"{[round(v, 8) for s, v in loss_u if s >= n_first]}")
    shutil.rmtree(ckdir, ignore_errors=True)
    del target, fit_u, fit_a, fit_b

    # remat on c3 'autodiff'
    builder, h, w, _ = BENCH_CONFIGS["c3_grid64"]
    scene, c3cam = builder(device=dev)
    zero = torch.zeros((h, w, 3), device=dev)
    grads, timings = {}, {}
    for remat in (False, True):
        cfg = FitConfig(height=h, width=w, engine="autodiff", remat=remat,
                        trainable=DEFAULT_TRAINABLE)
        init_fn, step_fn = make_train_step(
            c3cam, cfg, optimizer=lambda ps: torch.optim.SGD(ps, lr=STEP_LR))
        params, opt = init_fn(scene)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step_fn(params, opt, scene, zero)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        grads[remat] = {k: v.grad.clone() for k, v in params.items()}
        timings[remat] = time_cell(
            torch, "c3_grid64 autodiff", f"step, remat={remat}",
            lambda: step_fn(params, opt, scene, zero), 3, h * w, warm=1,
            windows=2, frames=2, dev_reps=1)
        del params, opt
    for k in grads[False]:
        a, b = grads[True][k], grads[False][k]
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        log(f"  grad {k}: remat on vs off max |diff| {err:.3e} "
            f"({err / max(scale, 1e-30):.2e} of max |g|), equal "
            f"{torch.equal(a, b)}")
        check(err <= REMAT_TOL * scale, f"remat changes the gradient of {k}")
    off, on = timings[False], timings[True]
    log(f"  remat: peak above the resident {off['call_gib']:.3f} -> "
        f"{on['call_gib']:.3f} GiB, step device time {off['device_ms']:.4f}"
        f" -> {on['device_ms']:.4f} ms")
    check(on["call_gib"] < off["call_gib"],
          "remat must lower the 'autodiff' step's peak memory")
    log(f"  phase 31: {time.perf_counter() - t0:.1f} s")
    return launches, cells


def soft_culled_vs_dense(torch, scene, cam, cull, bw, gamma, trainable,
                         culled, shade, shading, accel, cell):
    """One view's soft forward and gradients (of mean(img^2)) over the
    SOFT_CHECK_SIDE x SOFT_CHECK_SIDE tiles at the middle of the image: the culled pass
    (kernel 6) against the dense pass over every sphere (within
    SOFT_DENSE_ATOL and SOFT_DENSE_GRAD_TOL * max|g|: culling drops only
    spheres below the sigmoid's reach) and against the plain compaction
    (the image bit for bit, the gradients within GRAD_TOL * max|g|: the
    survivor gathers' backward adds in an order that changes per run)."""
    from openglraytracer_tpu_torch.ops.accel import tile_image
    from openglraytracer_tpu_torch.ops.raygen import generate_rays
    from openglraytracer_tpu_torch.ops.soft import soft_render_rays
    (th, tw), _ = cull
    o, d = generate_rays(cam, SOFT_CHECK_RES, SOFT_CHECK_RES)
    o, d = (tile_image(x, th, tw) for x in (o, d))
    # the side x side tiles at the middle of the image, still tile-major
    n, side = SOFT_CHECK_RES // tw, SOFT_CHECK_SIDE
    ids = torch.tensor([(n // 2 - side // 2 + r) * n + n // 2 - side // 2 + c
                        for r in range(side) for c in range(side)],
                       device=o.device)
    o, d = o[ids].reshape(-1, 3), d[ids].reshape(-1, 3)

    def one(c):
        s, params = train_scene(scene, trainable)
        img = soft_render_rays(s, o, d, bw=bw, gamma=gamma, cull=c)
        torch.mean(torch.square(img)).backward()
        return img.detach(), {kk: v.grad for kk, v in params.items()}

    kernels_img, kernels_g = one(cull)
    dense_img, dense_g = one(None)
    with PlainVersions(culled, shade, shading, accel):
        plain_img, plain_g = one(cull)
    err = float((kernels_img - dense_img).abs().max())
    log(f"  {cell} one view, {SOFT_CHECK_SIDE ** 2} middle tiles ({o.shape[0]} rays): "
        f"culled vs dense image max |diff| {err:.3e} (atol "
        f"{SOFT_DENSE_ATOL}); vs the plain compaction equal "
        f"{torch.equal(kernels_img, plain_img)}")
    check(err <= SOFT_DENSE_ATOL, f"{cell}: culled soft image vs dense")
    check(torch.equal(kernels_img, plain_img),
          f"{cell}: the soft image differs with the plain compaction")
    compare_grads(torch, cell, kernels_g, dense_g, "culled - dense",
                  tol=SOFT_DENSE_GRAD_TOL)
    compare_grads(torch, cell, kernels_g, plain_g,
                  "kernel 6 - plain compaction")


def _best_ms(fn, reps: int = 5) -> float:
    """Best host wall ms of reps calls of fn (host-side work: the PNG
    encoders and decoder)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def _fit_losses(printed: str) -> tuple[float, float]:
    """(first, final) of the 'fit: ...' line that cli fit prints."""
    line = next(x for x in printed.splitlines() if x.startswith("fit:"))
    return tuple(float(line.split(w)[1].split(",")[0])
                 for w in (" first ", " final "))


def run_host(torch, dev, kernels, shading, accel, lib_dir):
    """Phase 32, the host surface at c3 (1024x1024, culled_pallas): the
    native encoder loads; a render through save_png and load_png equals
    to_uint8 of the tensor; to_uint8_device equals to_uint8; the PNG
    encoders' and decoder's times; checked_render clean with kernels A, B
    and 4 launched under it; cost_analysis of a frame; cli fit --target
    --scene for 3 steps with a falling loss. Returns the per-path launch
    counts."""
    import contextlib
    import io

    import numpy as np

    from openglraytracer_tpu_torch import cli
    from openglraytracer_tpu_torch.models.builders import sphere_grid_scene
    from openglraytracer_tpu_torch.models.scene import save_scene
    from openglraytracer_tpu_torch.ops.render import render
    from openglraytracer_tpu_torch.utils import image, native_imageio
    from openglraytracer_tpu_torch.utils.debug import checked_render
    from openglraytracer_tpu_torch.utils.profiling import cost_analysis

    t_phase = time.perf_counter()
    fwd = ("primary_hit", "shadow_occlusion", "phong_fused")
    log(f"[32/34] host surface: c3_grid64 {W}x{H}, culled_pallas, tile "
        f"{TILE[0]}")
    try:
        native_imageio._load()
    except OSError as e:
        check(False, f"the native encoder native/libimageio.so does not "
              f"load: {e}")
    log("  native encoder loaded (native/libimageio.so)")
    scene, cam = sphere_grid_scene(8, device=dev)
    lights = shading.static_shadow_mask(scene)
    spec = accel.suggest_cull_config(scene, cam, H, W, TILE,
                                     shadow_lights=lights)
    kw = dict(engine="culled_pallas", cull=spec, shadow_lights=lights)
    with torch.no_grad():
        img = render(scene, cam, H, W, **kw)
    want8 = image.to_uint8(img)
    check(np.array_equal(image.to_uint8_device(img).cpu().numpy(), want8),
          "to_uint8_device differs from to_uint8")
    png = lib_dir / "phase32_c3.png"
    image.save_png(img, str(png))
    check(np.array_equal(image.load_png(str(png)),
                         want8[::-1].astype(np.float32) / 255.0),
          "save_png then load_png differs from to_uint8 of the render")
    check(png.read_bytes() == native_imageio.encode_png(want8),
          "save_png did not write the native encoder's bytes")
    enc_native = _best_ms(lambda: native_imageio.encode_png(want8))
    enc_py = _best_ms(lambda: image.encode_png_py(want8))
    dec = _best_ms(lambda: image.load_png(str(png)))
    log(f"  save_png -> load_png equals to_uint8 of the frame; "
        f"to_uint8_device equals to_uint8; PNG of {W}x{H} "
        f"({png.stat().st_size} bytes), best of 5 on the host: native "
        f"encode {enc_native:.3f} ms, Python encode {enc_py:.3f} ms, "
        f"load_png {dec:.3f} ms")

    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    err, cimg = checked_render(scene, cam, H, W, **kw)
    torch.cuda.synchronize()
    checked_s = time.perf_counter() - t0
    launches = {"checked_render_c3_grid64": {k: kernels.LAUNCHES[k]
                                             for k in fwd}}
    log(f"  checked_render: {err.get() or 'no NaN'}; launches "
        f"{launches['checked_render_c3_grid64']}; {checked_s:.2f} s")
    check(err.get() is None, f"checked_render at c3: {err.get()}")
    check(all(n >= 1 for n in launches["checked_render_c3_grid64"].values()),
          "kernels A, B and 4 must launch under checked_render")
    check(torch.equal(cimg, img), "the checked render differs from render")
    kernels.LAUNCHES.clear()
    with torch.no_grad():
        cost = cost_analysis(render, scene, cam, H, W, **kw)
    log(f"  cost_analysis of a c3 frame (aten ops outside the kernels): "
        f"{json.dumps(cost)}")

    init = lib_dir / "phase32_init.json"
    sph = scene.spheres
    shift = torch.tensor(FIT_TARGET_SHIFT, device=dev)
    save_scene(scene._replace(spheres=sph._replace(center=sph.center
                                                    + shift)),
               str(init), camera=cam)
    out = io.StringIO()
    kernels.LAUNCHES.clear()
    with contextlib.redirect_stdout(out):
        cli.main(["fit", "--target", str(png), "--scene", str(init),
                  "--engine", "culled_pallas", "--cull-tile", str(TILE[0]),
                  "--steps", "3", "--lr", str(FIT_TARGET_LR), "--trainable",
                  "spheres.center", "--device", "cuda"])
    torch.cuda.synchronize()
    launches["fit_target_c3_grid64"] = {k: kernels.LAUNCHES[k]
                                        for k in fwd + ("phong_shade_bwd",)}
    first, final = _fit_losses(out.getvalue())
    for line in out.getvalue().splitlines():
        log(f"  cli fit: {line}")
    log(f"  fit --target --scene, 3 Adam steps at {W}x{H}: loss {first:.6e} "
        f"-> {final:.6e}; launches {launches['fit_target_c3_grid64']}")
    check(final < first, "fit --target --scene: the loss must fall")
    check(all(n >= 3 for n in launches["fit_target_c3_grid64"].values()),
          "fit --target must launch kernels A, B, 4 and 5 every step")
    log(f"  phase 32: {time.perf_counter() - t_phase:.1f} s")
    return launches


def run_viewer(torch, dev, kernels, culled, shade, shading, accel, smi):
    """Phase 33, the live viewer at the CLI's 1280x720 on culled_pallas and
    pallas: VIEW_FRAMES frames published in order, the engine's kernels
    launched every frame, /frame.png decoded by the port's load_png equal
    to the render of the t it names, FPS and encode ms a frame. The
    viewer's 8x8 cull tiles give kernels A, B and 4 shapes that no other
    phase does, so the render of that t is also captured and each kernel
    call of it held against its plain version on the same inputs, and the
    frame against the image of the plain versions. Returns (the per-path
    launch counts, each compared kernel's max abs error)."""
    import threading
    import urllib.request

    import numpy as np

    from openglraytracer_tpu_torch.models.animated import reference_frame
    from openglraytracer_tpu_torch.ops import dense
    from openglraytracer_tpu_torch.ops.render import render
    from openglraytracer_tpu_torch.utils.image import decode_png, to_uint8
    from openglraytracer_tpu_torch.utils.viewer import FrameStreamer, serve

    t_phase = time.perf_counter()
    vh, vw = VIEW_HW
    log(f"[33/34] live viewer: {vw}x{vh}, {VIEW_FRAMES} frames per engine, "
        f"cull tile {VIEW_TILE} ({smi})")
    launches, errs = {}, {}
    for engine, kern in (("culled_pallas", ("primary_hit",
                                            "shadow_occlusion",
                                            "phong_fused")),
                         ("pallas", ("dense_hit",))):
        kernels.LAUNCHES.clear()
        streamer = FrameStreamer(vh, vw, engine=engine, cull_tile=VIEW_TILE,
                                 max_frames=VIEW_FRAMES, device=dev)
        server = serve(streamer, port=0, host="127.0.0.1")
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        seen, last, fetched = [], 0, None
        t0 = time.perf_counter()
        streamer.start()
        try:
            while not streamer.done:
                n, _ = streamer.wait_frame(last, timeout=120)
                if n > last:
                    seen.append(n)
                    last = n
                if fetched is None and n >= VIEW_FRAMES // 2:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/frame.png",
                            timeout=60) as r:
                        fetched = (r.read(), float(r.headers["X-Frame-Time"]))
            wall = time.perf_counter() - t0
        finally:
            streamer.stop()
            server.shutdown()
            server.server_close()
        torch.cuda.synchronize()
        name = f"view_{engine}_{vw}x{vh}"
        launches[name] = {k: kernels.LAUNCHES[k] for k in kern}
        enc_ms = 1e3 * streamer.encode_s / max(streamer.frame_no, 1)
        log(f"  {engine}: {streamer.frame_no} frames in {wall:.3f} s "
            f"(start-up and sizing included) -> {streamer.frame_no / wall:.2f}"
            f" FPS; last 2 s window {streamer.fps:.2f} FPS; PNG encode "
            f"{enc_ms:.3f} ms a frame (worker time); cull rebuilds "
            f"{streamer.rebuilds}; launches {launches[name]}")
        check(streamer.error is None, f"viewer ({engine}) failed: "
              f"{streamer.error!r}")
        check(streamer.frame_no == VIEW_FRAMES and seen == sorted(seen),
              f"viewer ({engine}): frames not all published in order")
        check(all(launches[name][k] >= VIEW_FRAMES for k in kern),
              f"viewer ({engine}): a kernel missed a frame")
        check(fetched is not None, "no /frame.png fetched")
        scene, cam = reference_frame(fetched[1], device=dev)
        rkw = dict(engine=engine, cull=streamer._cull,
                   shadow_lights=streamer._shadow_lights,
                   bounce_mask=streamer._bounce_mask)
        dense_calls, dense_fn = [], dense.dense_hit

        def dense_spy(*a):
            dense_calls.append(tuple(x.detach() for x in a))
            return dense_fn(*a)
        dense.dense_hit = dense_spy
        try:
            with Capture(culled, shade, accel) as cap, torch.no_grad():
                want = to_uint8(render(scene, cam, vh, vw, **rkw))
        finally:
            dense.dense_hit = dense_fn
        got = decode_png(fetched[0])
        same = np.array_equal(got, want)
        share = float((np.abs(got.astype(np.int16) - want).max(-1)
                       <= 1).mean())
        log(f"  /frame.png at t={fetched[1]!r}: "
            f"{'equal to' if same else 'DIFFERENT from'} the render of its "
            f"t ({share:.6f} of pixels within 1/255)")
        check(same or (streamer.rebuilds > 0 and share >= 0.999),
              f"viewer ({engine}): /frame.png is not the render of its t")
        # every kernel call of that render against its plain version on
        # the same inputs (launches here are not the path's: read above)
        what = f"view {engine} {vw}x{vh}"
        compared = collections.Counter()
        for name, a, kw in cap.log + [("dense_hit", a, {})
                                      for a in dense_calls]:
            if name == "primary_hit":
                e = compare_primary(torch, culled.primary_hit(*a, **kw),
                                    culled.primary_hit_plain(*a, **kw),
                                    what)[1]
            elif name == "shadow_occlusion":
                e = compare_shadow(torch, culled.shadow_occlusion(*a, **kw),
                                   culled.shadow_occlusion_plain(*a, **kw),
                                   what)[1]
            elif name == "phong_fused":
                e = compare_shade(torch, shade.phong_fused(*a, **kw),
                                  shading.phong_core(*a, **kw), what)
            elif name == "dense_hit":
                e = compare_dense(torch, dense.dense_hit(*a),
                                  dense.dense_hit_plain(*a), what)[1]
            else:
                continue
            compared[name] += 1
            errs[name] = max(errs.get(name, 0.0), e)
        check(all(compared[k] >= 1 for k in kern),
              f"viewer ({engine}): a kernel of the frame was not compared "
              f"with its plain version ({dict(compared)})")
        with PlainVersions(culled, shade, shading, accel), torch.no_grad():
            plain = to_uint8(render(scene, cam, vh, vw, **rkw))
        d = np.abs(got.astype(np.int16) - plain).max(-1)
        p_same, p_share = float((d == 0).mean()), float((d <= 1).mean())
        log(f"  /frame.png against the plain versions' image of its t: "
            f"{p_same:.6f} of pixels equal, {p_share:.6f} within 1/255, max "
            f"{int(d.max())}/255")
        check(p_share >= 0.999, f"viewer ({engine}): /frame.png is not the "
              f"plain versions' image of its t")
    log(f"  phase 33: {time.perf_counter() - t_phase:.1f} s")
    return launches, errs


def run_sharded(torch, dev, kernels, shading, accel, smi):
    """Phase 34, the tile-sharded layer in an NCCL world of one process:
    render_sharded on the (1, 1) mesh equal to render bit for bit at c3 and
    c4_mirror4096 (and gather_image over NCCL); render_tile over the
    coordinates of a SHARD_MESH mesh against the unsharded image; frames
    and steps timed against the unsharded; 3 sharded SGD steps at c3 with
    kernels A, B, 4 and 5 every step and gradients within GRAD_TOL of the
    unsharded step's; one measure_scaling row. Returns the per-path launch
    counts."""
    import socket

    import numpy as np
    import torch.distributed as dist

    from openglraytracer_tpu_torch.models.builders import BENCH_CONFIGS
    from openglraytracer_tpu_torch.ops.render import render
    from openglraytracer_tpu_torch.parallel.distributed import (
        gather_image, init_distributed)
    from openglraytracer_tpu_torch.parallel.mesh import make_mesh, tile_slice
    from openglraytracer_tpu_torch.parallel.scaling import (format_table,
                                                            measure_scaling)
    from openglraytracer_tpu_torch.parallel.sharded import (render_sharded,
                                                            render_tile)
    from openglraytracer_tpu_torch.train.inverse import (DEFAULT_TRAINABLE,
                                                         FitConfig,
                                                         make_train_step)

    t_phase = time.perf_counter()
    all4 = ("primary_hit", "shadow_occlusion", "phong_fused",
            "phong_shade_bwd")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=1, process_id=0, device="cuda")
    mesh = make_mesh()
    log(f"[34/34] sharded: torch.distributed {dist.get_backend()}, world "
        f"{dist.get_world_size()}, mesh {mesh.shape} at {mesh.coord} "
        f"({smi})")
    check(dist.get_backend() == "nccl" and mesh.shape == (1, 1)
          and mesh.group is not None, "expected an NCCL world of one rank")
    launches = {}
    try:
        c3 = None
        for name, tile in (("c3_grid64", TILE[0]), ("c4_mirror4096", 32)):
            builder, h, w, depth = BENCH_CONFIGS[name]
            scene, cam = builder(device=dev)
            lights = shading.static_shadow_mask(scene)
            bmask = (shading.static_bounce_mask(scene) if depth
                     else (True, True))
            spec = accel.suggest_cull_config(scene, cam, h, w, (tile, tile),
                                             shadow_lights=lights)
            child = (accel.suggest_child_cull_config(
                scene, cam, h, w, spec, shadow_lights=lights)
                if depth else None)
            kw = dict(depth=depth, engine="culled_pallas", cull=spec,
                      child_cull=child, shadow_lights=lights,
                      bounce_mask=bmask)
            if c3 is None:
                c3 = (scene, cam, spec)
            with torch.no_grad():
                want, want_ovf = render(scene, cam, h, w,
                                        with_cull_stats=True, **kw)
                kernels.LAUNCHES.clear()
                got, ovf = render_sharded(scene, cam, h, w, mesh=mesh,
                                          with_cull_stats=True, **kw)
                torch.cuda.synchronize()
                launches[f"render_sharded_{name}"] = dict(kernels.LAUNCHES)
                same = torch.equal(got, want) and int(ovf) == int(want_ovf)
                gathered = gather_image(got, mesh)
                log(f"  {name} ({w}x{h}, depth {depth}, spec {spec}): "
                    f"render_sharded on (1, 1) "
                    f"{'equals' if same else 'DIFFERS from'} render bit for "
                    f"bit, overflow {int(ovf)}; launches "
                    f"{launches[f'render_sharded_{name}']}")
                check(same, f"render_sharded on (1, 1) differs from render "
                      f"({name})")
                check(np.array_equal(gathered, want.cpu().numpy()),
                      f"gather_image over NCCL differs ({name})")
                img = torch.empty_like(want)
                ovf_sum = 0
                for i in range(SHARD_MESH[0]):
                    for j in range(SHARD_MESH[1]):
                        t_, o_ = render_tile(scene, cam, h, w,
                                             mesh_shape=SHARD_MESH,
                                             coord=(i, j), **kw)
                        rows, cols = tile_slice(SHARD_MESH, h, w, (i, j))
                        img[rows, cols] = t_
                        ovf_sum += int(o_)
                diff = (img - want).abs().amax(-1)
                share = float((diff <= 1.0 / 255.0).float().mean())
                equal = torch.equal(img, want)
                log(f"  render_tile over {SHARD_MESH}: "
                    f"{'equal bit for bit to' if equal else 'differs from'} "
                    f"the unsharded image ({share:.6f} of pixels within "
                    f"1/255, max {float(diff.max()):.3e}); overflow summed "
                    f"{ovf_sum}")
                if name == "c3_grid64":
                    check(equal, "the c3 tiles differ from the unsharded "
                          "image")
                else:
                    check(share >= 0.999, f"the {name} tiles differ from "
                          "the unsharded image")

            def frame_u(scene=scene, cam=cam, h=h, w=w, kw=kw):
                with torch.no_grad():
                    return render(scene, cam, h, w, with_cull_stats=True,
                                  **kw)

            def frame_s(scene=scene, cam=cam, h=h, w=w, kw=kw):
                with torch.no_grad():
                    return render_sharded(scene, cam, h, w, mesh=mesh,
                                          with_cull_stats=True, **kw)
            for label, fn in (("unsharded", frame_u), ("sharded", frame_s),
                              ("unsharded", frame_u), ("sharded", frame_s)):
                windows, _ = timed_windows(torch, fn, warm=2, windows=3,
                                           frames=5)
                dev_ms = statistics.median(device_ms(torch, fn, (), reps=1)
                                           for _ in range(3))
                log(f"  {name} frame, {label}: median "
                    f"{statistics.median(windows):.4f} ms, min "
                    f"{min(windows):.4f} ms (3 windows of 5); device "
                    f"{dev_ms:.4f} ms")

        scene, cam, spec = c3
        zero = torch.zeros((H, W, 3), device=dev)
        cfg = FitConfig(height=H, width=W, engine="culled_pallas", cull=spec,
                        trainable=DEFAULT_TRAINABLE)

        def sgd(ps):
            return torch.optim.SGD(ps, lr=STEP_LR)
        init_s, step_s = make_train_step(cam, cfg, mesh=mesh, optimizer=sgd)
        init_u, step_u = make_train_step(cam, cfg, optimizer=sgd)
        params, opt = init_s(scene)
        kernels.LAUNCHES.clear()
        outs = [step_s(params, opt, scene, zero) for _ in range(STEPS)]
        torch.cuda.synchronize()
        launches["train_step_sharded_c3_grid64"] = {
            k: kernels.LAUNCHES[k] for k in all4}
        log(f"  sharded training step at c3, {STEPS} SGD steps: losses "
            f"{[float(o[2]) for o in outs]}, overflow "
            f"{[int(o[3]) for o in outs]}; launches "
            f"{launches['train_step_sharded_c3_grid64']}")
        check(all(n >= STEPS for n in
                  launches["train_step_sharded_c3_grid64"].values()),
              "kernels A, B, 4 and 5 must launch on every sharded step")

        def one_step(init, step):
            p, o = init(scene)
            _, _, loss, _ = step(p, o, scene, zero)
            return float(loss), {k: v.grad for k, v in p.items()}
        loss_s, g_s = one_step(init_s, step_s)
        loss_u, g_u = one_step(init_u, step_u)
        log(f"  first step's loss: sharded {loss_s:.9g}, unsharded "
            f"{loss_u:.9g}")
        check(abs(loss_s - loss_u) <= 1e-5 * abs(loss_u),
              "the sharded loss differs from the unsharded")
        for k in DEFAULT_TRAINABLE:
            scale = float(g_u[k].abs().max())
            e = float((g_s[k] - g_u[k]).abs().max())
            log(f"  grad {k}: max |g| {scale:.4e}, max |sharded - "
                f"unsharded| {e:.3e} ({e / max(scale, 1e-30):.2e} of max|g|)")
            check(scale > 0 and e <= GRAD_TOL * scale,
                  f"sharded gradient of {k} differs from the unsharded")

        params_u, opt_u = init_u(scene)
        for label, fn in (("unsharded", lambda: step_u(params_u, opt_u,
                                                       scene, zero)),
                          ("sharded", lambda: step_s(params, opt, scene,
                                                     zero))) * 2:
            windows, _ = timed_windows(torch, fn, warm=2, windows=3,
                                       frames=5)
            dev_ms = statistics.median(device_ms(torch, fn, (), reps=1)
                                       for _ in range(3))
            log(f"  c3 training step, {label}: median "
                f"{statistics.median(windows):.4f} ms, min "
                f"{min(windows):.4f} ms (3 windows of 5); device "
                f"{dev_ms:.4f} ms")
        for mode in ("render", "step"):
            rows = measure_scaling(scene, cam, H, W, mode=mode,
                                   engine="culled_pallas", cull=spec,
                                   device_counts=[1])
            log(f"  measure_scaling ({mode}, c3 culled_pallas): "
                f"{json.dumps(rows)}")
            for line in format_table(rows).splitlines():
                log(f"    {line}")
    finally:
        dist.destroy_process_group()
    log(f"  phase 34: {time.perf_counter() - t_phase:.1f} s")
    return launches


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1

    from openglraytracer_tpu_torch import kernels
    from openglraytracer_tpu_torch.models.builders import sphere_grid_scene
    from openglraytracer_tpu_torch.ops import accel, culled, shade, shading
    from openglraytracer_tpu_torch.ops.accel import (parse_cull_spec,
                                                     suggest_cull_config,
                                                     tile_image)
    from openglraytracer_tpu_torch.ops.geometry import _box_recompute
    from openglraytracer_tpu_torch.ops.raygen import generate_rays
    from openglraytracer_tpu_torch.ops.render import render
    from openglraytracer_tpu_torch.ops.transforms import euler_rotation_3x3b
    from openglraytracer_tpu_torch.train.inverse import (DEFAULT_TRAINABLE,
                                                         FitConfig, fit,
                                                         make_train_step)
    from openglraytracer_tpu_torch.utils.image import save_png
    from openglraytracer_tpu_torch.utils.metrics import rays_per_frame

    dev = torch.device("cuda", 0)
    fwd_kernels = ("primary_hit", "shadow_occlusion", "phong_fused")
    all_kernels = fwd_kernels + ("phong_shade_bwd",)

    # ---- 1. device
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[1/34] device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    log(smi)

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path, build_log = kernels.build()
    kernels.library()
    log(f"[2/34] build: {time.perf_counter() - t0:.1f} s -> {lib_path.parent}")
    log_ptxas(build_log, "ptxas")
    earlier, earlier_log = earlier_library(kernels)
    if earlier is None:
        log(f"  no earlier kernels at {EARLIER_CSRC}: the redesigned "
            "kernels are timed alone")
    else:
        log(f"  earlier kernels built from {EARLIER_CSRC} "
            f"({', '.join(EARLIER_SOURCES)}): "
            f"{time.perf_counter() - t0:.1f} s")
        log_ptxas(earlier_log, "earlier ptxas")

    # ---- 3. kernels vs plain versions at the c3 shapes
    log("[3/34] kernels vs plain versions")
    scene, cam = sphere_grid_scene(8, device=dev)
    shadow_lights = shading.static_shadow_mask(scene)
    spec = suggest_cull_config(scene, cam, H, W, TILE,
                               shadow_lights=shadow_lights)
    log(f"  c3 cull spec {spec}, shadow lights {shadow_lights}")
    zero_target = torch.zeros((H, W, 3), device=dev)
    with Capture(culled, shade, accel) as cap, torch.no_grad():
        render(scene, cam, H, W, engine="culled_pallas", cull=spec,
               shadow_lights=shadow_lights)
    c3_args = dict(cap.args)
    with Capture(culled, shade, accel) as cap:
        s, _ = train_scene(scene, DEFAULT_TRAINABLE)
        img = render(s, cam, H, W, engine="culled_pallas", cull=spec,
                     shadow_lights=shadow_lights)
        torch.mean(torch.square(img - zero_target)).backward()
    c3_args["phong_shade_bwd"] = cap.args["phong_shade_bwd"]
    a = c3_args["primary_hit"]
    log(f"  c3 shapes: dirs {tuple(a[0].shape)}, sphere rows "
        f"{tuple(a[1].shape)}, box rows {tuple(a[2].shape)}, planes "
        f"{tuple(a[3].shape)}; shadow rows "
        f"{tuple(c3_args['shadow_occlusion'][4].shape)}; shade backward "
        f"cotangent {tuple(c3_args['phong_shade_bwd'][9].shape)}")
    errs = {}
    errs["primary_hit"] = compare_primary(
        torch, culled.primary_hit(*a), culled.primary_hit_plain(*a), "c3")[1]
    b = c3_args["shadow_occlusion"]
    errs["shadow_occlusion"] = compare_shadow(
        torch, culled.shadow_occlusion(*b),
        culled.shadow_occlusion_plain(*b), "c3")[1]
    s = c3_args["phong_fused"]
    errs["phong_fused"] = compare_shade(
        torch, shade.phong_fused(*s), shading.phong_core(*s), "c3")
    g = c3_args["phong_shade_bwd"]
    errs["phong_shade_bwd"] = compare_shade_bwd(
        torch, shade.phong_shade_bwd(*g), shade.phong_shade_bwd_plain(*g),
        "c3")

    bscene, bcam = box_scene(torch, dev)
    bspec = suggest_cull_config(bscene, bcam, 256, 256, (16, 16))
    with Capture(culled, shade, accel) as cap:
        bs, _ = train_scene(bscene, ("boxes.position", "boxes.angles",
                                     "spheres.center", "materials.diffuse"))
        bimg = render(bs, bcam, 256, 256, engine="culled_pallas", cull=bspec)
        torch.mean(torch.square(bimg)).backward()
    a, b, s, g = (cap.args[k] for k in all_kernels)
    check(a[2].shape[1] > 0 and b[5].shape[2] > 0,
          "the box scene must reach the box paths")
    log(f"  box scene spec {bspec}")
    compare_primary(torch, culled.primary_hit(*a),
                    culled.primary_hit_plain(*a), "boxes")
    compare_shadow(torch, culled.shadow_occlusion(*b),
                   culled.shadow_occlusion_plain(*b), "boxes")
    compare_shade(torch, shade.phong_fused(*s), shading.phong_core(*s),
                  "boxes")
    compare_shade_bwd(torch, shade.phong_shade_bwd(*g),
                      shade.phong_shade_bwd_plain(*g), "boxes")
    # the backward's box replay against kernel A's own hits: the face pick
    # must agree (a wrong face moves the normal by order 1)
    (th, tw), kp, ks, hot_m, kb, ksb = parse_cull_spec(bspec)
    bo, bd = (tile_image(x, th, tw).reshape(-1, 3)
              for x in generate_rays(bcam, 256, 256))
    hit, _, _ = culled.culled_geometry(bscene, bo, bd, th * tw, kp, ks,
                                       None, hot_m, kb, ksb)
    n_sph, boxes = bscene.spheres.count, bscene.boxes
    is_box = hit.hit & (hit.obj_id >= n_sph) \
        & (hit.obj_id < n_sph + boxes.count)
    bid = (hit.obj_id - n_sph).clamp(0, boxes.count - 1).long()
    t_r, _, n_r = _box_recompute(
        boxes.mins[bid], boxes.maxs[bid], boxes.position[bid],
        euler_rotation_3x3b(boxes.angles)[bid], bo, bd, hit.inside)
    dt = float(((t_r - hit.t).abs() / hit.t.abs().clamp(min=1.0))[is_box]
               .max())
    dn = float((n_r - hit.n).abs()[is_box].max())
    log(f"  box replay vs kernel A on {int(is_box.sum())} box winners: max "
        f"rel |t| err {dt:.3e}, max |n| err {dn:.3e}")
    check(dt <= 1e-5 and dn <= 1e-5,
          "the backward's box replay disagrees with kernel A")
    # kernel B with hot shadow tiles beside the boxes' survivor rows
    with Capture(culled, shade, accel) as cap, torch.no_grad():
        culled.culled_geometry(bscene, bo, bd, th * tw, kp, ks, None, 2, kb,
                               ksb)
    b = cap.args["shadow_occlusion"]
    check(b[9] is not None and b[5].shape[2] > 0,
          "the box scene with hot_m 2 must have hot pairs and box rows")
    compare_shadow(torch, culled.shadow_occlusion(*b),
                   culled.shadow_occlusion_plain(*b), "boxes, hot_m 2")

    # ---- 4. the forward path
    log(f"[4/34] forward path: render c3_grid64 {W}x{H}, depth 0, engine "
        f"culled_pallas, tile {TILE[0]}, {FRAMES} frames")
    kernels.LAUNCHES.clear()
    with torch.no_grad():
        frames = [render(scene, cam, H, W, engine="culled_pallas", cull=spec,
                         shadow_lights=shadow_lights, with_cull_stats=True)
                  for _ in range(FRAMES)]
    torch.cuda.synchronize()
    fwd_launches = {k: kernels.LAUNCHES[k] for k in all_kernels}
    log(f"  launches over {FRAMES} frames: {fwd_launches}")
    check(all(fwd_launches[k] >= FRAMES for k in fwd_kernels),
          "every forward kernel must launch on every frame")
    check(fwd_launches["phong_shade_bwd"] == 0,
          "a forward frame must not run the backward")
    ovfs = [int(ovf) for _, ovf in frames]
    log(f"  cull_overflow_events per frame: {ovfs}")
    check(all(o == 0 for o in ovfs), "cull overflow on the main path")
    img = frames[-1][0]
    check(tuple(img.shape) == (H, W, 3), f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "image has non-finite values")
    check(all(torch.equal(f[0], img) for f in frames), "frames differ")
    with PlainVersions(culled, shade, shading, accel), torch.no_grad():
        img_plain = render(scene, cam, H, W, engine="culled_pallas", cull=spec,
                           shadow_lights=shadow_lights)
    diff = (img - img_plain).abs().amax(dim=-1)
    share = float((diff <= 1.0 / 255.0).float().mean())
    log(f"  image vs plain versions on the card: {share:.6f} of pixels "
        f"within 1/255, max diff {float(diff.max()):.3e}; mean "
        f"{float(img.mean()):.5f}")
    check(share >= 0.999, "image disagrees with the plain versions' image")
    # a small input against the CPU (the plain versions in PyTorch's CPU
    # kernels): rsqrt/exp/log round differently there, hence 1e-4
    sc, cc = sphere_grid_scene(8, device="cpu")
    small_spec = suggest_cull_config(sc, cc, 64, 64, (16, 16))
    with torch.no_grad():
        small_cpu = render(sc, cc, 64, 64, engine="culled_pallas",
                           cull=small_spec)
        small_gpu = render(scene, cam, 64, 64, engine="culled_pallas",
                           cull=small_spec).cpu()
    small_err = float((small_cpu - small_gpu).abs().max())
    log(f"  64x64 render, card vs CPU: max diff {small_err:.3e}")
    check(small_err <= 1e-4, "small render disagrees with the CPU's")
    png = lib_path.parent / "c3_grid64.png"
    save_png(img, str(png))
    log(f"  wrote {png}")

    # ---- 5. forward timing
    log(f"[5/34] forward timing ({name}; {smi})")

    def frame():
        with torch.no_grad():
            return render(scene, cam, H, W, engine="culled_pallas", cull=spec,
                          shadow_lights=shadow_lights, with_cull_stats=True)

    windows, outs = timed_windows(torch, frame)
    check(int(torch.stack([o[1] for o in outs]).sum()) == 0,
          "overflow while timing")
    n_rays = rays_per_frame(H, W, scene.lights.count, 0,
                            shadow_lights=shadow_lights)
    med, best = statistics.median(windows), min(windows)
    # one frame at a time: its ~500 launches fit in the stream's queue of
    # pending launches, ten frames would not and the host would pace them
    frame_dev = statistics.median(device_ms(torch, frame, (), reps=1)
                                  for _ in range(5))
    log(f"  frame (raygen -> image), sync-free under "
        f"set_sync_debug_mode('error'): median {med:.4f} ms, min "
        f"{best:.4f} ms over {WINDOWS} windows of {WINDOW_FRAMES} "
        f"({[round(w, 4) for w in windows]}); {n_rays} rays/frame -> "
        f"{n_rays / (med / 1e3) / 1e6:.1f} Mrays/s median")
    log(f"  frame device time (one frame enqueued behind a spin kernel, "
        f"median of 5): {frame_dev:.4f} ms")

    plain_fns = {"primary_hit": culled.primary_hit_plain,
                 "shadow_occlusion": culled.shadow_occlusion_plain,
                 "phong_fused": shading.phong_core,
                 "phong_shade_bwd": shade.phong_shade_bwd_plain}
    wrappers = {"primary_hit": culled.primary_hit,
                "shadow_occlusion": culled.shadow_occlusion,
                "phong_fused": shade.phong_fused,
                "phong_shade_bwd": shade.phong_shade_bwd}
    kernel_ms, c3_earlier_ms = {}, {}

    def time_kernel(k):
        args = c3_args[k]
        t_plain = [device_ms(torch, plain_fns[k], args)]
        # kernel A shares its template with the redesigned hot launch, and
        # kernel B is redesigned: the earlier ones in turns with them
        if k == "shadow_occlusion" and earlier is not None:
            ms, old_ms, every = in_turns(
                torch, lambda: wrappers[k](*args),
                earlier_shadow(torch, accel, earlier, args)["both"],
                turns=1)
        else:
            ms, old_ms, every = time_turns(
                torch, kernels, wrappers[k], args,
                earlier if k == "primary_hit" else None, turns=1)
        c3_earlier_ms[k] = old_ms
        t_plain.append(device_ms(torch, plain_fns[k], args))
        kernel_ms[k] = (ms, statistics.mean(t_plain))
        log(f"  {k}: kernel {kernel_ms[k][0]:.4f} ms, plain version "
            f"{kernel_ms[k][1]:.4f} ms (device time per call at c3)"
            + (f"; earlier kernel {old_ms:.4f} ms, in turns {every}"
               if old_ms is not None else ""))

    with torch.no_grad():
        for k in fwd_kernels:
            time_kernel(k)

    # ---- 6. the training path
    log(f"[6/34] training path: c3_grid64 {W}x{H}, {STEPS} SGD steps at lr "
        f"{STEP_LR:g} of mean(img^2) w.r.t. {DEFAULT_TRAINABLE}")
    cfg = FitConfig(height=H, width=W, engine="culled_pallas", cull=spec,
                    trainable=DEFAULT_TRAINABLE)
    init_fn, step_fn = make_train_step(
        cam, cfg, optimizer=lambda ps: torch.optim.SGD(ps, lr=STEP_LR))
    params, opt = init_fn(scene)
    kernels.LAUNCHES.clear()
    step_out = [step_fn(params, opt, scene, zero_target)
                for _ in range(STEPS)]
    torch.cuda.synchronize()
    train_launches = {k: kernels.LAUNCHES[k] for k in all_kernels}
    log(f"  launches over {STEPS} steps: {train_launches}")
    check(all(n >= STEPS for n in train_launches.values()),
          "every kernel must launch on every training step")
    ovfs = [int(o[3]) for o in step_out]
    losses = [float(o[2]) for o in step_out]
    log(f"  losses {losses}; cull_overflow_events per step: {ovfs}")
    check(all(o == 0 for o in ovfs), "cull overflow on the training path")

    def one_step_grads():
        p, o = init_fn(scene)
        _, _, loss, _ = step_fn(p, o, scene, zero_target)
        return float(loss), {k: v.grad for k, v in p.items()}

    loss_k, grads_k = one_step_grads()
    with PlainVersions(culled, shade, shading, accel):
        loss_p, grads_p = one_step_grads()
    log(f"  first step's loss: kernels {loss_k:.9g}, plain versions "
        f"{loss_p:.9g}")
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p),
          "training loss disagrees with the plain versions'")
    for k in DEFAULT_TRAINABLE:
        gk, gp = grads_k[k], grads_p[k]
        scale = float(gp.abs().max())
        err = float((gk - gp).abs().max())
        log(f"  grad {k}: max |g| {scale:.4e}, max |kernel - plain| "
            f"{err:.3e} ({err / max(scale, 1e-30):.2e} of max |g|)")
        check(bool(torch.isfinite(gk).all()) and scale > 0.0,
              f"gradient of {k} must be finite and non-zero")
        check(err <= GRAD_TOL * scale,
              f"gradient of {k} disagrees with the plain versions'")

    # ---- 7. training timing
    log(f"[7/34] training timing ({name}; {smi})")

    def train_step():
        return step_fn(params, opt, scene, zero_target)

    windows, outs = timed_windows(torch, train_step)
    check(int(torch.stack([o[3] for o in outs]).sum()) == 0,
          "overflow while timing the training step")
    med, best = statistics.median(windows), min(windows)
    step_dev = statistics.median(device_ms(torch, train_step, (), reps=1)
                                 for _ in range(5))
    log(f"  training step (forward, backward, SGD; each step's params feed "
        f"the next), sync-free under set_sync_debug_mode('error'): median "
        f"{med:.4f} ms, min {best:.4f} ms over {WINDOWS} windows of "
        f"{WINDOW_FRAMES} ({[round(w, 4) for w in windows]}); fwd_bwd "
        f"{n_rays / (med / 1e3) / 1e6:.1f} Mrays/s median at {n_rays} "
        f"rays/frame")
    log(f"  training step device time (one step behind a spin kernel, "
        f"median of 5): {step_dev:.4f} ms")
    time_kernel("phong_shade_bwd")

    # ---- 8. a short fit
    log(f"[8/34] fit: sphere_grid_scene({FIT['side']}, seed=1) at "
        f"{FIT['hw']}x{FIT['hw']}, {FIT['steps']} Adam steps, lr "
        f"{FIT['lr']}")
    hw, t = FIT["hw"], FIT["tile"]
    ftrue, fcam = sphere_grid_scene(FIT["side"], seed=1, device=dev)
    fspec = suggest_cull_config(ftrue, fcam, hw, hw, (t, t), headroom=2.0)
    with torch.no_grad():
        ftarget = render(ftrue, fcam, hw, hw, engine="culled_pallas",
                         cull=fspec)
    gen = torch.Generator().manual_seed(0)
    sph = ftrue.spheres
    finit = ftrue._replace(spheres=sph._replace(
        center=sph.center + 0.3 * torch.randn(sph.center.shape,
                                              generator=gen).to(dev)))
    _, flosses = fit(finit, ftarget, fcam, FitConfig(
        height=hw, width=hw, steps=FIT["steps"], learning_rate=FIT["lr"],
        log_every=5, engine="culled_pallas", cull=fspec))
    log(f"  losses {[(st, round(v, 6)) for st, v in flosses]}")
    check(flosses[-1][1] < flosses[0][1], "the fit's loss must fall")

    (launches_4096, kernel_ms_4096, errs_4096, timed, topk_ms,
     earlier_4096, shadow_cells) = run_4096(torch, dev, kernels, culled,
                                            shade, shading, accel, smi,
                                            earlier)
    kernel_ms.update(kernel_ms_4096)
    errs["shadow_occlusion"] = max(errs["shadow_occlusion"],
                                   errs_4096.pop("shadow_occlusion"))
    errs["shadow_occlusion_hot"] = errs["shadow_occlusion"]
    errs.update(errs_4096)
    launches_dense, dense_cells, errs["dense_hit"], dense_c3 = run_dense(
        torch, dev, kernels, culled, shade, shading, accel, smi, earlier)
    launches_xla = run_xla(torch, dev, kernels, culled, shade, shading, accel,
                           smi)
    launches_stack, errs_stack = run_stack(torch, dev, kernels, culled,
                                           shade, shading, accel, smi)
    launches_xla_culled = run_culled_xla(torch, dev, kernels, culled, shade,
                                         shading, accel, smi)
    launches_extras, soft_cells = run_training_extras(
        torch, dev, kernels, culled, shade, shading, accel, smi,
        lib_path.parent)
    launches_host = run_host(torch, dev, kernels, shading, accel,
                             lib_path.parent)
    launches_view, errs_view = run_viewer(torch, dev, kernels, culled, shade,
                                          shading, accel, smi)
    launches_sharded = run_sharded(torch, dev, kernels, shading, accel, smi)
    for k, v in (*errs_stack.items(), *errs_view.items()):
        errs[k] = max(errs[k], v)
    c3_dense = dense_cells["c3 primary"]
    kernel_ms["dense_hit"] = (c3_dense["ms"], c3_dense["plain_ms"])
    # the redesigned kernels' earlier time, from the same call (None
    # without the earlier copy)
    earlier_ms = {"primary_hit_hot": earlier_4096["primary_hit_hot"],
                  "compact_mask": earlier_4096["compact_mask"],
                  "shadow_occlusion": c3_earlier_ms["shadow_occlusion"],
                  "shadow_occlusion_hot":
                      earlier_4096["shadow_occlusion_hot"],
                  "dense_hit": c3_dense["earlier_ms"]}

    from openglraytracer_tpu_torch.ops import dense
    sources = {"primary_hit": ("csrc/primary_hit.cu",
                               "openglraytracer_tpu/ops/pallas_culled.py:150"),
               "shadow_occlusion": (
                   "csrc/shadow_occlusion.cu",
                   "openglraytracer_tpu/ops/pallas_culled.py:351"),
               "shadow_occlusion_hot": (
                   "csrc/shadow_occlusion.cu",
                   "openglraytracer_tpu/ops/pallas_culled.py:351"),
               "phong_fused": ("csrc/phong_shade.cu",
                               "openglraytracer_tpu/ops/pallas_shade.py:45"),
               "phong_shade_bwd": (
                   "csrc/phong_shade_bwd.cu",
                   "openglraytracer_tpu/ops/pallas_shade.py:111"),
               "primary_hit_ray": (
                   "csrc/primary_hit.cu",
                   "openglraytracer_tpu/ops/pallas_culled.py:150"),
               "primary_hit_hot": (
                   "csrc/primary_hit.cu",
                   "openglraytracer_tpu/ops/pallas_culled.py:150"),
               "compact_mask": (
                   "csrc/compact_mask.cu",
                   "openglraytracer_tpu/ops/pallas_compact.py:52"),
               "dense_hit": (
                   "csrc/dense_hit.cu",
                   "openglraytracer_tpu/ops/pallas_render.py:115")}
    # the inputs each row's ms was timed on, for its bound
    timed_calls = {k: (wrappers[k], c3_args[k], {}) for k in all_kernels}
    timed_calls["primary_hit_ray"] = (culled.primary_hit_ray,
                                      *timed["primary_hit_ray"])
    timed_calls["primary_hit_hot"] = (culled.primary_hit_ray,
                                      *timed["primary_hit_hot"])
    timed_calls["compact_mask"] = (accel.compact_mask,
                                   *timed["compact_mask"])
    timed_calls["shadow_occlusion_hot"] = (culled.shadow_occlusion,
                                           *timed["shadow_occlusion_hot"])
    timed_calls["dense_hit"] = (dense.dense_hit, dense_c3, {})
    library_ms = {"compact_mask": topk_ms}
    path_launches = {"render_c3_grid64": fwd_launches,
                     "train_step_c3_grid64": train_launches, **launches_4096,
                     **launches_dense, **launches_xla, **launches_stack,
                     **launches_xla_culled, **launches_extras,
                     **launches_host, **launches_view, **launches_sharded}
    kernels.LAUNCHES.clear()    # the bound's calls below count nowhere
    rows = []
    for k in all_kernels + ("primary_hit_ray", "primary_hit_hot",
                            "shadow_occlusion_hot", "compact_mask",
                            "dense_hit"):
        src, replaces = sources[k]
        # launches: the count from the path the kernel was ported for (the
        # c3 forward frames for the forward kernels, the c3 training steps
        # for the backward, the c4_mirror4096 frames for kernels 2 and 6,
        # the c5_grid4096 frames for kernel B's hot launch, the c3 pallas
        # frames for kernel 7); every path's count under "paths"
        main = (train_launches if k == "phong_shade_bwd" else
                launches_4096["render_c4_mirror4096"] if k in (
                    "primary_hit_ray", "primary_hit_hot", "compact_mask")
                else launches_4096["render_c5_grid4096"]
                if k == "shadow_occlusion_hot"
                else launches_dense["render_c3_grid64_pallas"]
                if k == "dense_hit" else fwd_launches)
        fn, args, kw = timed_calls[k]
        with torch.no_grad():
            b_ms, b_by, nbytes, ops = bound(torch, k, fn, args, kw)
        row = {"name": k, "route": "cuda",
               "source": f"openglraytracer_tpu_torch/{src}",
               "replaces": replaces, "launches": main.get(k, 0),
               "paths": {pn: pl.get(k, 0)
                         for pn, pl in path_launches.items()},
               "max_abs_err": errs[k], "ms": kernel_ms[k][0],
               "plain_ms": kernel_ms[k][1], "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": library_ms.get(k)}
        if k in earlier_ms:
            row["earlier_ms"] = earlier_ms[k]
        if k == "dense_hit":
            row["cells"] = dense_cells
        if k == "shadow_occlusion":
            row["cells"] = {lv: {**c["shadow_occlusion"],
                                 "function": c["function"]}
                            for lv, c in shadow_cells.items()}
        if k == "shadow_occlusion_hot":
            row["cells"] = {lv: c[k] for lv, c in shadow_cells.items()}
        if k == "compact_mask":
            row["cells"] = soft_cells
        rows.append(row)
        log(f"  {k}: {row['ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
            f"({100 * b_ms / row['ms']:.0f}% of it; {nbytes / 1e6:.1f} MB "
            f"-> {nbytes / PEAK_BYTES * 1e3:.4f} ms, {ops / 1e9:.3f} GFLOP "
            f"-> {ops / PEAK_FLOPS * 1e3:.4f} ms)")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
