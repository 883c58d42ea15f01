"""The share, in percent, of the traced slice in which no kernel, copy or
memset ran on the card (nothing where no device ran at all)."""


def read(run, qualifier=None):
    if run.trace is None or run.trace["window_s"] <= 0 \
            or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
