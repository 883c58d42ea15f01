"""The share, in percent, of the MoE layers' device time that routes,
dispatches and combines: device time of what was launched under
``moe.route``, ``moe.dispatch`` and ``moe.combine`` over that under any
``moe.*`` span (``moe.experts``, the expert products, the rest), over
the traced slice."""

from qlm_bench import program_trace

MOVES = ("moe.route", "moe.dispatch", "moe.combine")


def read(run, qualifier=None):
    pt = program_trace.read(run)
    if pt is None:
        return None
    every = program_trace.under(pt["device_by_chain"],
                                lambda name: name.startswith("moe."))
    if not every:
        return None
    moves = program_trace.under(pt["device_by_chain"],
                                lambda name: name in MOVES)
    return 100.0 * moves / every
