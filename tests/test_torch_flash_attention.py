"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX reference on the CPU: ``flash_attention_plain`` and the
autograd Function's forward (which runs the plain version on CPU tensors)
against the Pallas kernel in interpret mode (``ops.flash_attention``) and
its oracle ``ref.flash_attention_ref``, on the JAX tests' cases (causal
MHA / GQA / MQA, ragged and non-tile lengths, windows 8, 17 and 64); and
the Function's gradients against ``jax.grad`` of the oracle.

Tolerance: float32 atol = rtol = 1e-5 (the two frameworks sum the dot
products and the softmax in another order); bfloat16 atol = rtol = 2e-2
(both compute in f32 from the same bf16 inputs and round the output to
bf16, one ulp of which is 2^-8 near 1), as the JAX tests allow.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(2)
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (B, H, KVH, Lq, Lkv, D, JAX tile): tests/test_kernels.py's causal cases
CAUSAL = {"MHA square": (1, 4, 4, 64, 64, 32, 32),
          "GQA L=100 (padded tiles)": (2, 8, 2, 100, 100, 64, 32),
          "MQA Lq=33 on Lkv=65": (1, 4, 1, 33, 65, 16, 16)}
WINDOW = (2, 4, 2, 80, 80, 32, 16)


def _inputs(seed, B, H, KVH, Lq, Lkv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Lq, D)).astype(np.float32),
            rng.standard_normal((B, KVH, Lkv, D)).astype(np.float32),
            rng.standard_normal((B, KVH, Lkv, D)).astype(np.float32))


def _cases():
    for name, shape in CAUSAL.items():
        for dtype in ("float32", "bfloat16"):
            yield pytest.param(shape, None, dtype, id=f"{name}-{dtype}")
    for window in (8, 17, 64):
        yield pytest.param(WINDOW, window, "float32", id=f"window {window}")


def _jax(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


def _torch(x, dtype):
    return torch.tensor(x).to(TORCH_DTYPES[dtype])


def _close(out, want, dtype):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("shape,window,dtype", _cases())
def test_forward_matches_jax_kernel_and_oracle(shape, window, dtype):
    *dims, tile = shape
    q, k, v = _inputs(0, *dims)
    jq, jk, jv = (_jax(x, dtype) for x in (q, k, v))
    tq, tk, tv = (_torch(x, dtype) for x in (q, k, v))
    want_ref = ref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    want_kernel = ops.flash_attention(jq, jk, jv, causal=True, window=window,
                                      block_q=tile, block_k=tile)
    plain = fa.flash_attention_plain(tq, tk, tv, causal=True, window=window)
    before = fa.launches
    out = fa.flash_attention(tq, tk, tv, causal=True, window=window)
    assert fa.launches == before          # the plain version does not count
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert torch.equal(out, plain)        # the Function runs it on the CPU
    _close(plain, want_ref, dtype)
    _close(plain, want_kernel, dtype)


@pytest.mark.parametrize("shape,window",
                         [pytest.param(s, None, id=n)
                          for n, s in CAUSAL.items()]
                         + [pytest.param(WINDOW, w, id=f"window {w}")
                            for w in (8, 17, 64)])
def test_gradients_match_jax_grad_of_the_oracle(shape, window):
    *dims, _ = shape
    q, k, v = _inputs(1, *dims)
    cot = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        out = ref.flash_attention_ref(q, k, v, causal=True, window=window)
        return jnp.sum(out * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                                for x in (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=True, window=window)
    (out * torch.tensor(cot)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-5)


def test_recompute_under_checkpoint_gives_the_same_gradients():
    """Under remat the backward reruns the forward: the Function's
    gradients depend only on the saved q, k, v."""
    q, k, v = _inputs(3, 2, 8, 2, 48, 48, 16)
    grads = []
    for remat in (False, True):
        ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]

        def f(q, k, v):
            return fa.flash_attention(q * 1.5, k, v, causal=True, window=20)

        out = checkpoint(f, *ts, use_reentrant=False) if remat else f(*ts)
        out.square().sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_non_causal_and_window_masks():
    """The flags the training path does not use still follow the
    reference's contract."""
    q, k, v = _inputs(4, 1, 4, 2, 40, 56, 16)
    for causal, window in ((False, None), (False, 9), (True, 9)):
        want = ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       window=window)
        got = fa.flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                       torch.tensor(v), causal=causal,
                                       window=window)
        _close(got, want, "float32")


def test_row_with_no_visible_key_gives_zero():
    """Only Lq > Lkv under a window leaves a row empty; the port writes 0
    there, as its other kernels do (the jnp oracle would average v)."""
    q, k, v = (torch.tensor(x) for x in _inputs(5, 1, 2, 1, 20, 8, 16))
    out = fa.flash_attention(q, k, v, causal=True, window=4)
    assert torch.count_nonzero(out[:, :, 11:]) == 0
    assert torch.count_nonzero(out[:, :, :11]) == out[:, :, :11].numel()


def test_mixed_devices_raise():
    q, k, v = (torch.tensor(x) for x in _inputs(6, 1, 2, 1, 8, 8, 16))
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        fa.flash_attention(q, k.to("meta"), v)
