"""The share, in percent, of the traced slice in which the card idled
while the host was inside an ``engine.*.launch`` span (a chunk round's
or a decode round's model call, up to its return): the idle gaps that
began there, whole.  The rest of ``device_idle_share`` is idle between
model calls."""

from qlm_bench import program_trace


def _launch(name):
    return name.startswith("engine.") and name.endswith(".launch")


def read(run, qualifier=None):
    pt = program_trace.read(run)
    if pt is None or run.trace is None or run.trace["window_s"] <= 0:
        return None
    t = program_trace.under(pt["idle_by_chain"], _launch)
    if t is None:
        return None
    return 100.0 * t / run.trace["window_s"]
