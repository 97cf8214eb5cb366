"""Share of the generate_rays calls of the window's last frame or step
that replayed a CUDA graph (ops/raygen.py): the program counters
raygen_graph_replays over raygen_calls of that unit. 1.0 where every ray
grid came from its graph; 0.0 where the unit's calls replayed none."""

from benchmark import program_trace


def read(trace):
    prog = program_trace.read(trace)
    if prog is None:
        return None
    calls = prog.counters.get("raygen_calls")
    if calls is None or calls.value <= 0:
        return None
    replays = prog.counters.get("raygen_graph_replays")
    if replays is None or replays.unit != calls.unit:
        return 0.0
    return replays.value / calls.value
