"""Device ms of the kernels, copies and memsets launched under the
engine's ``engine.decode.*`` spans (prepare, launch, wait, commit) per
decode iteration (the launch spans' ``iters``), over the traced slice;
nothing where the trace holds no launch to join a kernel to."""

from qlm_bench import program_trace


def read(run, qualifier=None):
    pt = program_trace.read(run)
    if pt is None:
        return None
    iters = pt["counts"].get("engine.decode.launch", {}).get("iters", 0)
    t = program_trace.under(pt["device_by_chain"],
                            lambda name: name.startswith("engine.decode."))
    if not iters or not t:
        return None
    return 1e3 * t / iters
