"""PyTorch port: the program's own spans and counters (utils/profiling.py).

Under a torch.profiler session on the CPU, a frame and a training step on
the culled_pallas path (the kernels' plain versions) record every layer
span, nested under their entry span and sharing its unit; each span is
one of the profiler's events, opened within 50 us of it; a new session
starts a new record; the narrow phase's trip counters equal a hand count
from the frame's CullAux. With no session,
span is one shared null context that never opens a range. Imports no jax:
the tests marked ``cuda`` run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""

import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openglraytracer_tpu_torch.models import animated as t_animated
from openglraytracer_tpu_torch.models import builders as tb
from openglraytracer_tpu_torch.ops import culled
from openglraytracer_tpu_torch.ops.accel import (_top_tiles, parse_cull_spec,
                                                 suggest_cull_config,
                                                 tile_image)
from openglraytracer_tpu_torch.ops.raygen import generate_rays
from openglraytracer_tpu_torch.ops.render import render
from openglraytracer_tpu_torch.ops.shading import static_shadow_mask
from openglraytracer_tpu_torch.train import inverse
from openglraytracer_tpu_torch.utils import profiling
from openglraytracer_tpu_torch.utils.image import to_uint8_device

H = W = 32
TILE = (16, 16)

# (layer, name) of every span a culled_pallas frame at depth 0 records
FRAME = {("entry", "render"), ("raygen", "generate_rays"),
         ("raygen", "tile_order"), ("raygen", "untile"),
         ("broad_phase", "tile_cones"), ("broad_phase", "_dense_compact"),
         ("broad_phase", "shadow_tile_cones"),
         ("narrow_phase", "culled_geometry"), ("narrow_phase", "pack_rows"),
         ("narrow_phase", "kernel_a"), ("narrow_phase", "kernel_b"),
         ("shade", "culled_material_rows"), ("shade", "phong_fused")}
QUANTIZE = {("quantize", "to_uint8_device")}
STEP = FRAME | {("entry", "step"), ("optimizer", "zero_grad"),
                ("optimizer", "step"), ("backward", "autograd"),
                ("backward", "winner_backward"),
                ("backward", "phong_shade_bwd"),
                ("backward", "scatter_winner_rows"),
                ("backward", "scatter_material_rows")}


def _session(device="cpu"):
    acts = [ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _grid(device="cpu", side=2, h=H, w=W, tile=TILE):
    scene, cam = tb.sphere_grid_scene(side, seed=7, device=device)
    spec = suggest_cull_config(scene, cam, h, w, tile, headroom=2.0)
    return scene, cam, spec


def _frame(scene, cam, spec, h=H, w=W, lights=None):
    """One frame as the benchmark's render loop makes it: with the light
    mask given (read before the frame) it waits for nothing, and the image
    is quantized on the device."""
    with torch.no_grad():
        img, _ = render(scene, cam, h, w, engine="culled_pallas", cull=spec,
                        shadow_lights=lights, with_cull_stats=True)
        return to_uint8_device(img)


def _train_step(scene, cam, spec):
    cfg = inverse.FitConfig(height=H, width=W, engine="culled_pallas",
                            cull=spec)
    init_fn, step_fn = inverse.make_train_step(
        cam, cfg, optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-3))
    params, opt = init_fn(scene)
    with torch.no_grad():
        target = render(scene, cam, H, W, engine="culled_pallas", cull=spec)
    return step_fn, params, opt, target


def _entry_of(rec, i):
    """Index of the outermost entry span above span i (or i itself)."""
    found = None
    while i is not None:
        if rec.spans[i].layer == "entry":
            found = i
        i = rec.spans[i].parent
    return found


def _names(rec):
    return {(s.layer, s.name) for s in rec.spans}


def test_a_frame_and_a_step_record_every_layer_span():
    scene, cam, spec = _grid()
    step_fn, params, opt, target = _train_step(scene, cam, spec)
    with _session():
        for _ in range(2):
            _frame(scene, cam, spec)
    rec = profiling.record()
    assert _names(rec) == FRAME | QUANTIZE
    entries = [i for i, s in enumerate(rec.spans)
               if s.layer == "entry" and s.parent is None]
    assert [rec.spans[i].unit for i in entries] == [0, 1]
    for i, s in enumerate(rec.spans):
        assert s.end_ns >= s.start_ns and s.thread == threading.get_ident()
        if (s.layer, s.name) in QUANTIZE:
            # the caller's quantize follows its frame, outside render
            assert s.parent is None and s.start_ns > rec.spans[
                entries[s.unit]].end_ns
            continue
        top = _entry_of(rec, i)
        assert top in entries and rec.spans[top].unit == s.unit
        parent = rec.spans[s.parent] if s.parent is not None else None
        if parent is not None:
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns

    with _session():
        for _ in range(2):
            params, opt, loss, _ = step_fn(params, opt, scene, target)
    rec = profiling.record()
    assert _names(rec) == STEP
    steps = [i for i, s in enumerate(rec.spans) if s.name == "step"
             and s.layer == "entry"]
    assert [rec.spans[i].unit for i in steps] == [0, 1]
    for i, s in enumerate(rec.spans):
        # on the CPU autograd runs the backward on the caller's thread
        assert _entry_of(rec, i) in steps
        assert s.unit == rec.spans[_entry_of(rec, i)].unit
    # the render inside a step shares the step's unit
    assert all(rec.spans[i].unit == rec.spans[_entry_of(rec, i)].unit
               for i, s in enumerate(rec.spans) if s.name == "render")


def _worst_start_gap(rec, prof, device_type=None):
    """The largest gap, in ns, between a span's start in the record and
    its event's in the profiler's trace (the n-th span of a name against
    the n-th event of that name)."""
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiling.SPAN_PREFIX) and (
                device_type is None or e.device_type() == device_type):
            events.setdefault(e.name(), []).append(e.start_ns())
    seen, worst = {}, 0
    for s in rec.spans:
        name = f"{profiling.SPAN_PREFIX}{s.layer}/{s.name}"
        assert name in events, name
        k = seen[name] = seen.get(name, -1) + 1
        starts = sorted(events[name])
        assert len(starts) > k, name
        worst = max(worst, abs(s.start_ns - starts[k]))
    return worst


def _traced_frame(scene, cam, spec, device="cpu", h=H, w=W):
    """(record, profiler) of one frame. The session's first range (its
    clock's first reading is late by up to a millisecond) is a warm-up
    range of the caller's, as the benchmark's window range is. On the
    card the frame runs in sync debug mode 'error': a wait for the device
    inside it raises."""
    cuda = device != "cpu"
    lights = static_shadow_mask(scene)
    with _session(device) as prof:
        with torch.profiler.record_function("warm-up"):
            pass
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            _frame(scene, cam, spec, h, w, lights)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
    return profiling.record(), prof


def test_spans_are_profiler_events_opened_within_50us():
    scene, cam, spec = _grid()
    _frame(scene, cam, spec)
    gaps = []
    for _ in range(3):      # a busy host may preempt between the two reads
        rec, prof = _traced_frame(scene, cam, spec)
        assert _names(rec) == FRAME | QUANTIZE
        gaps.append(_worst_start_gap(rec, prof))
        if gaps[-1] <= 50_000:
            break
    assert min(gaps) <= 50_000, gaps


def test_off_span_is_one_null_context_and_opens_no_range(monkeypatch):
    scene, cam, spec = _grid()

    def no_range(*args, **kwargs):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert profiling.span("raygen", "generate_rays") is profiling.OFF
    assert profiling.span("entry", "render") is profiling.OFF
    assert profiling.count("primary_trips", torch.ones(3)) is None
    assert profiling.count("shadow_trips", torch.ones(3)) is None
    _frame(scene, cam, spec)
    step_fn, params, opt, target = _train_step(scene, cam, spec)
    step_fn(params, opt, scene, target)


def test_a_new_session_starts_a_new_record():
    scene, cam, spec = _grid()
    with _session():
        _frame(scene, cam, spec)
        _frame(scene, cam, spec)
    first = profiling.record()
    assert {s.unit for s in first.spans} == {0, 1}
    with _session():
        _frame(scene, cam, spec)
    second = profiling.record()
    assert {s.unit for s in second.spans} == {0}
    assert min(s.start_ns for s in second.spans) > \
        max(s.end_ns for s in first.spans)
    # an untraced frame between two sessions ends the record as well
    with _session():
        _frame(scene, cam, spec)
    _frame(scene, cam, spec)
    with _session():
        profiling.count("narrow_tiles", 5)
    rec = profiling.record()
    assert rec.spans == [] and rec.counters["narrow_tiles"].value == 5


def _hand_trips(scene, aux, spec):
    """Kernel A's and kernel B's trip counts summed over the tiles (and
    lights), from the frame's CullAux: counts capped at the lists' widths,
    a hot shadow tile scanning every sphere."""
    _, kp, ks, hot_m, kb, ksb = parse_cull_spec(spec)
    n_sph, n_box = scene.spheres.count, scene.boxes.count
    primary = int(torch.clamp(aux.p_count, max=aux.p_idx.shape[-1]).sum()
                  + torch.clamp(aux.b_count, max=aux.b_idx.shape[-1]).sum())
    ks_eff = min(ks, n_sph)
    ksb_eff = min(ksb, n_box) if ksb > 0 else n_box
    shadow = 0
    for li in range(aux.s_count.shape[0]):
        s = torch.clamp(aux.s_count[li], max=ks_eff)
        if hot_m:
            s[_top_tiles(aux.s_count[li], hot_m)] = n_sph
        shadow += int(s.sum()) + int(torch.clamp(aux.sb_count[li],
                                                 max=ksb_eff).sum())
    return primary, shadow


@pytest.mark.parametrize("world", ["grid", "grid_hot", "obb"])
def test_trip_counters_equal_a_hand_count(world):
    if world == "obb":
        scene, cam = t_animated.reference_frame(2.3, device="cpu")
        spec = suggest_cull_config(scene, cam, H, W, TILE, headroom=2.0)
    else:
        scene, cam, spec = _grid(side=3)
        if world == "grid_hot":
            (th, tw), kp, ks, _, kb, ksb = parse_cull_spec(spec)
            spec = ((th, tw), kp, max(ks - 2, 1), 2, kb, ksb)
    (th, tw), kp, ks, hot_m, kb, ksb = parse_cull_spec(spec)
    origins, dirs = generate_rays(cam, H, W)
    o = tile_image(origins, th, tw).reshape(-1, 3)
    d = tile_image(dirs, th, tw).reshape(-1, 3)
    with _session():
        with profiling.span("entry", "render"):
            _, _, aux = culled.culled_geometry(
                scene, o, d, th * tw, kp, ks, static_shadow_mask(scene),
                hot_m, kb, ksb)
    rec = profiling.record()
    primary, shadow = _hand_trips(scene, aux, spec)
    assert primary > 0 and shadow > 0
    if world == "obb":
        assert int(aux.b_count.sum()) > 0
    assert rec.counters["primary_trips"] == profiling.Counter(0, primary)
    assert rec.counters["shadow_trips"] == profiling.Counter(0, shadow)
    assert rec.counters["narrow_tiles"] == profiling.Counter(
        0, (H // th) * (W // tw))


def test_device_counters_keep_the_last_unit_and_hosts_add():
    with _session():
        for unit in range(3):
            with profiling.span("entry", "render"):
                profiling.count("trips", torch.full((4,), unit + 1))
                profiling.count("trips", torch.ones(2, dtype=torch.int32))
                profiling.count("tiles", 2)
                profiling.count("tiles", 3)
    rec = profiling.record()
    assert rec.counters["trips"] == profiling.Counter(2, 4 * 3 + 2)
    assert rec.counters["tiles"] == profiling.Counter(2, 5)


def test_a_thread_keeps_its_own_parents_and_no_update_is_lost():
    """Spans on another thread (as autograd's device thread runs the
    backward) have no parent on the caller's thread; many threads record
    at once and lose no span or count."""
    n_threads, n_spans = 12, 150
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _session():
            with profiling.span("entry", "step"):
                def work():
                    for _ in range(n_spans):
                        with profiling.span("backward", "outer"):
                            with profiling.span("backward", "inner"):
                                profiling.count("calls", 1)

                threads = [threading.Thread(target=work)
                           for _ in range(n_threads)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
                assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rec = profiling.record()
    main = threading.get_ident()
    assert len(rec.spans) == 1 + 2 * n_threads * n_spans
    assert rec.counters["calls"] == profiling.Counter(0, n_threads * n_spans)
    for s in rec.spans:
        if s.name == "outer":
            assert s.parent is None and s.thread != main
        elif s.name == "inner":
            parent = rec.spans[s.parent]
            assert parent.name == "outer" and parent.thread == s.thread


@pytest.mark.cuda
def test_span_clock_and_no_sync_on_the_card():
    """One traced c3 frame on the card: every span's start within 50 us of
    its event in the device trace, and tracing adds no wait for the
    device inside the frame (a counter keeps its tensor)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    h = w = 1024
    scene, cam, spec = _grid("cuda", side=8, h=h, w=w, tile=(64, 64))
    for _ in range(2):
        _frame(scene, cam, spec, h, w)
    torch.cuda.synchronize()
    rec, prof = _traced_frame(scene, cam, spec, "cuda", h, w)
    assert _names(rec) == FRAME | QUANTIZE
    worst = _worst_start_gap(rec, prof, torch.autograd.DeviceType.CPU)
    print(f"spans {len(rec.spans)}, worst start gap {worst / 1e3:.1f} us")
    assert worst <= 50_000
    assert rec.counters["primary_trips"].value > 0
