"""The model FLOPs of the tokens that ``tokens_per_s`` counts, per second
of the window, as a percent of one H100's bf16 peak (989 TFLOP/s): each
prompt position at its own context (the last with the unembedding),
each later output token at its context with the unembedding; a mixture
counts its router and top-k experts, a windowed layer the keys of its
window (``counting.token_flops`` over the family's attention layers)."""

from qlm_bench import counting


def read(run, qualifier=None):
    ws, we = run.window
    model, layers = run.model, run.layers
    flops = 0.0
    for s in run.seen:
        for a, b in s.prompt_spans(ws, we):
            flops += counting.prompt_flops(model, layers, a, b,
                                           b == s.prompt_len)
        prev = 0
        for t, n in s.obs:
            if ws <= t <= we:
                for j in range(max(prev + 1, 2), n + 1):
                    flops += counting.token_flops(model, layers,
                                                  s.prompt_len + j - 1, True)
            prev = n
    return 100.0 * flops / (run.seconds * counting.PEAK_BF16_FLOPS)
