"""The engine's synchronised decode time per decode iteration, in ms
(``EngineStats.decode_time / decode_iterations``, over the window): a
burst's iterations share one timed region."""


def read(run, qualifier=None):
    its = run.delta("decode_iterations")
    if not its:
        return None
    return 1e3 * run.delta("decode_time") / its
