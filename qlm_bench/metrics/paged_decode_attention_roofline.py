"""The paged decode kernel's share, in percent, of its roofline over the
traced slice: the sum of each launch's least time (``counting.
decode_least_s`` on the live contexts of its round) over the kernel's
device time in the trace (``decode_mma_kernel``)."""

from qlm_bench import trace


def read(run, qualifier=None):
    if run.trace is None or run.ledger is None:
        return None
    t = trace.kernel_seconds(run.trace["kernel_s"], "decode_mma_kernel")
    if t <= 0 or run.ledger.decode_least_s <= 0:
        return None
    return 100.0 * run.ledger.decode_least_s / t
