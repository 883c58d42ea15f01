"""The share, in percent, of the judged requests whose first token came
by their deadline.  Judged: due in the window, with the deadline (due
time + the class's limit) at or before the window's end.  A refused,
failed, shed or dropped request is a miss."""


def read(run, qualifier=None):
    ws, we = run.window
    judged = [s for s in run.seen
              if ws <= s.due <= we and s.due + s.ttft_s <= we]
    if not judged:
        return None
    met = sum(1 for s in judged
              if not s.dropped and s.first_token is not None
              and s.first_token <= s.due + s.ttft_s)
    return 100.0 * met / len(judged)
