"""Host ms inside the engine's ``engine.decode.launch`` spans (the model
call of a decode round, or a burst's n calls, up to their return) per
decode iteration (the spans' ``iters``), over the traced slice."""

from qlm_bench import program_trace


def read(run, qualifier=None):
    pt = program_trace.read(run)
    if pt is None:
        return None
    iters = pt["counts"].get("engine.decode.launch", {}).get("iters", 0)
    if not iters:
        return None
    return 1e3 * pt["host_s"]["engine.decode.launch"] / iters
