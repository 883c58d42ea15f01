"""The share, in percent, of the decode iterations in the traced slice
that ran as a CUDA-graph replay: the ``replays`` of the program's
``model.decode_replay`` spans over the ``iters`` of its
``engine.decode.launch`` spans.  Nothing where the slice holds no replay
span (a program that replays no decode step, or a run on the CPU)."""

from qlm_bench import program_trace


def read(run, qualifier=None):
    pt = program_trace.read(run)
    if pt is None:
        return None
    replays = pt["counts"].get("model.decode_replay", {}).get("replays", 0)
    iters = pt["counts"].get("engine.decode.launch", {}).get("iters", 0)
    if not replays or not iters:
        return None
    return 100.0 * replays / iters
