"""The 90th percentile, in s, of the time to first token of the judged
interactive requests (due in the window, deadline within it), from the
scheduled arrival; one with no first token by the window's end counts as
the window's end minus its due time.  With a qualifier (a
configuration's name) it is the same number, read as a per-layer one."""

import numpy as np


def read(run, qualifier=None):
    ws, we = run.window
    ttft = []
    for s in run.seen:
        if s.cls != "interactive" or not ws <= s.due <= we \
                or s.due + s.ttft_s > we:
            continue
        ft = s.first_token
        got = ft is not None and ft <= we and not s.dropped
        ttft.append((ft if got else we) - s.due)
    if not ttft:
        return None
    return float(np.percentile(ttft, 90))
