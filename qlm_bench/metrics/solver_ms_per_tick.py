"""Host ms in the controller's ``qlm.predict_violation`` (the RWT
estimator's check) and ``qlm.reschedule`` (the solver) spans, inside
``qlm.submit`` and ``qlm.tick``, per ``qlm.tick`` span, over the traced
slice."""

from qlm_bench import program_trace

SOLVER = ("qlm.predict_violation", "qlm.reschedule")
CALLERS = ("qlm.submit", "qlm.tick")


def read(run, qualifier=None):
    pt = program_trace.read(run)
    if pt is None or not pt["n"].get("qlm.tick"):
        return None
    t = sum(d for chain, d in pt["host_by_chain"].items()
            if chain[0] in SOLVER and any(c in CALLERS for c in chain[1:]))
    return 1e3 * t / pt["n"]["qlm.tick"]
