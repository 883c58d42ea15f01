"""A run with its timed path broken underneath comes out not correct:
once for each fault a serving cell can have.  (Its cells run on one card:
there is no exchange between cards to leave out.)"""
import dataclasses

import pytest
import torch

from qlm_bench.tests.small import run_small


def _wrap_decode(eng, fn):
    model = eng.model
    eng.model = dataclasses.replace(
        model, decode_step_paged=fn(model.decode_step_paged))


def _state_unchanged(eng):
    """The decode step returns the cache as it found it: its k/v writes
    go to a copy."""
    def fn(step):
        def decode(params, cache, tokens, lengths, table):
            logits, _ = step(params, {k: v.clone() for k, v in cache.items()},
                             tokens, lengths, table)
            return logits, cache
        return decode
    _wrap_decode(eng, fn)


def _half_batch(eng):
    """Half of the batch left out: the even slots (slot 0, which a light
    load fills first, among them) get the mean of the odd slots' logits."""
    def fn(step):
        def decode(params, cache, tokens, lengths, table):
            logits, cache = step(params, cache, tokens, lengths, table)
            logits = logits.clone()
            logits[0::2] = logits[1::2].mean(0, keepdim=True)
            return logits, cache
        return decode
    _wrap_decode(eng, fn)


def _token_altered(eng):
    """One token a decode step replaced by the next id, where it is
    produced: the slot it falls on goes round the batch."""
    calls = [0]

    def fn(step):
        def decode(params, cache, tokens, lengths, table):
            logits, cache = step(params, cache, tokens, lengths, table)
            row = calls[0] % logits.shape[0]
            calls[0] += 1
            logits = logits.clone()
            top = logits[row].argmax()
            logits[row, (top + 1) % 500] = logits[row, top] + 1.0
            return logits, cache
        return decode
    _wrap_decode(eng, fn)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("cell", ["granite-3-2b.mixed-slo",
                                  "dbrx-132b-8of40.mixed-slo"])
def test_a_broken_step_is_not_correct(cell, fault):
    torch.manual_seed(0)
    out = run_small(cell, hooks=fault)
    assert out["checks"]["requests_compared"]["value"] >= 1
    assert not out["correct"], out["checks"]
