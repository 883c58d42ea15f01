"""The 99th percentile, in ms, of every output-token gap in the window.
The harness observes each request's token count after each agent round;
a gap is the time between two observations of one request divided by
the tokens that arrived in it, and every such token takes that gap.  The
observation that brings the first token opens the count and is no gap,
so a stall shows in every request it holds up.  With a qualifier (a
configuration's name) it is the same number, read as a per-layer one."""

import numpy as np


def read(run, qualifier=None):
    ws, we = run.window
    gaps, weights = [], []
    for s in run.seen:
        for (t0, n0), (t1, n1) in zip(s.obs, s.obs[1:]):
            if n0 >= 1 and ws <= t1 <= we and n1 > n0:
                gaps.append((t1 - t0) / (n1 - n0))
                weights.append(n1 - n0)
    if not gaps:
        return None
    return 1e3 * float(np.percentile(np.repeat(gaps, weights), 99))
