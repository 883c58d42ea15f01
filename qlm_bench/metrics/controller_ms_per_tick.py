"""Host ms in the controller (``QLMController.submit`` and ``tick``,
timed by the harness around each call) per tick, over the window."""


def read(run, qualifier=None):
    if not run.ticks:
        return None
    return 1e3 * run.controller_s / run.ticks
