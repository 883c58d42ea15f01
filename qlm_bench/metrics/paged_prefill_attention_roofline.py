"""The paged prefill kernel's share, in percent, of its roofline over the
traced slice: the sum of each launch's least time (``counting.
prefill_least_s`` on the valid rows and cached prefixes of its round)
over the kernel's device time in the trace (``prefill_mma_kernel``)."""

from qlm_bench import trace


def read(run, qualifier=None):
    if run.trace is None or run.ledger is None:
        return None
    t = trace.kernel_seconds(run.trace["kernel_s"], "prefill_mma_kernel")
    if t <= 0 or run.ledger.prefill_least_s <= 0:
        return None
    return 100.0 * run.ledger.prefill_least_s / t
