"""The 90th percentile, in s, of the judged interactive requests' wait
in the queue (the requests ``interactive_ttft_p90_s`` judges): from the
scheduled arrival to the engine's first admission of the request
(``Request.admit_time``, on the engine's clock); one not admitted by the
window's end counts the window's end.  Nothing where the program does
not stamp admissions.  With a qualifier (a configuration's name) it is
the same number, read as a per-layer one."""

import numpy as np


def read(run, qualifier=None):
    ws, we = run.window
    wait = []
    for s in run.seen:
        if s.cls != "interactive" or not ws <= s.due <= we \
                or s.due + s.ttft_s > we:
            continue
        if not hasattr(s.req, "admit_time"):
            return None
        at = s.req.admit_time
        wait.append((at if at is not None and at <= we else we) - s.due)
    if not wait:
        return None
    return float(np.percentile(wait, 90))
