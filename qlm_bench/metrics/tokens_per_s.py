"""Tokens served per second of the window: the prompt tokens the engine
prefilled, or served from its prefix cache, in the window, and the output
tokens that arrived in it.  The harness observes each request's prefill
position and output count after every agent round (``Seen.pre`` /
``Seen.obs``) and counts what moved inside the window."""


def read(run, qualifier=None):
    ws, we = run.window
    tokens = 0.0
    for s in run.seen:
        tokens += sum(b - a for a, b in s.prompt_spans(ws, we))
        prev = 0
        for t, n in s.obs:
            if ws <= t <= we:
                tokens += n - prev
            prev = n
    return tokens / run.seconds
