"""The arithmetic of the SSD scan kernel, modelled in plain torch on the CPU
and held against the JAX reference: the Pallas ``ssd_scan`` in interpret
mode (zero state) and ``repro.models.ssm.ssd_chunked`` with an initial
state.

The CUDA kernel (``csrc/ssd_scan.cu``, ``ssd_mma_kernel``) splits P into
slices of 16 columns, one CTA each, and runs four products per chunk on
the tensor cores.  ``ssd_scheme`` below repeats its decomposition:

  * each slice of P computed on its own, with its own slice of the state
    (at the kernel's 16 columns and at 8, which gives the same result);
  * the cumsum of dt * A in log2 units, in the kernel's order (two or
    four rows a lane, then a Kogge-Stone scan over the 32 lanes), the
    exponents as exp2;
  * C.B^T: for bf16 inputs exact products of bf16 values summed in f32
    (bf16 m16n8k16), for f32 inputs 3xTF32;
  * C.h, att.x and the state update B^T (w x): the operand that is not a
    bf16 input (h, att, w x) split into a TF32 high part and residual as
    ``split_tf32`` splits it, bit for bit, and multiplied by the exact
    bf16 operand in two TF32 products; for f32 inputs 3xTF32.

Tolerance: atol = rtol = 1e-4 against the f32 reference on the same
(bf16-valued, for the bf16 scheme) inputs: the splits keep f32 accuracy
(each product's error about 2^-21 relative), and the rest is f32
summation in another order; the JAX kernel tests allow 5e-4.  A single
TF32 product in place of the split misses 1e-4 (checked below), which is
why the kernel splits.  At mamba2's widths and a 2048-token prefill
the model and the plain f32 version each differ from an f64 evaluation
by a few f32 ulps of the largest value, and from each other by up to the
sum of the two (their rounding errors are independent); both are held to
32 ulps there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.models import ssm as jax_ssm
from repro_torch.kernels.ssd_scan import ssd_scan_plain

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
LOG2E = 1.4426950408889634

# (B, L, H, P, G, N, chunk): the JAX kernel tests' three shapes and the
# reduced mamba2 config's widths
SHAPES = {"(1,64,2,16,1,8,16)": (1, 64, 2, 16, 1, 8, 16),
          "(2,128,4,32,2,16,32)": (2, 128, 4, 32, 2, 16, 32),
          "groups (1,32,8,8,4,4,8)": (1, 32, 8, 8, 4, 4, 8),
          "reduced mamba2": (1, 48, 16, 32, 1, 16, 16)}


def split_tf32(x: torch.Tensor):
    """The kernel's split, bit for bit: hi = x's bits + 0x1000 with the low
    13 cleared (the TF32 value nearest x, ties away from zero) and lo = x -
    hi in f32, offset by half a TF32 ulp so that the mma's reading of its
    top 19 bits rounds it.  Returns (hi, lo) as the f32 values the mma
    multiplies."""
    def tf32(bits):
        return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32) \
            .view(np.float32)
    bits = x.numpy().astype(np.float32).view(np.uint32).astype(np.int64)
    hi = tf32(bits)
    lo = (x.numpy().astype(np.float32) - hi).view(np.uint32).astype(np.int64)
    return torch.from_numpy(hi), torch.from_numpy(tf32(lo))


def tf32_only(x: torch.Tensor) -> torch.Tensor:
    return split_tf32(x)[0]


def mm(a: torch.Tensor, b: torch.Tensor, exact: str) -> torch.Tensor:
    """a @ b as the kernel's mma steps take it: ``exact`` names the operand
    that is exact in TF32 (a bf16 input) and the other is split (two
    products), or "none" for 3xTF32 (hi.lo + lo.hi + hi.hi)."""
    if exact == "a":
        bh, bl = split_tf32(b)
        return a @ bl + a @ bh
    if exact == "b":
        ah, al = split_tf32(a)
        return al @ b + ah @ b
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def warp_cumsum(v: torch.Tensor):
    """The kernel's warp scan of one chunk, in its order: lane l sums rows
    R l .. R l + R - 1 in turn (R = 2 for chunks of up to 64 rows, 4 up to
    128), the 32 lane totals take a Kogge-Stone scan (offsets 1, 2, 4, 8,
    16), and each row adds its lane's inclusive total minus its own.
    Returns the inclusive cumsum and the chunk's total, lane 31's
    inclusive total (the rows past the chunk are 0)."""
    q = v.shape[0]
    R = 2 if q <= 64 else 4
    rows = torch.zeros(32 * R)
    rows[:q] = v
    rows = rows.reshape(32, R)
    pre = rows.clone()
    for r in range(1, R):
        pre[:, r] = pre[:, r - 1] + rows[:, r]
    run = pre[:, R - 1].clone()
    incl = run.clone()
    for o in (1, 2, 4, 8, 16):
        incl = torch.cat([incl[:o], incl[o:] + incl[:-o]])
    return (pre + (incl - run)[:, None]).reshape(-1)[:q], incl[31]


def ssd_scheme(x, dt, A, Bm, Cm, chunk, init, scheme, slice_p,
               split=True):
    """The kernel's arithmetic on (B, L, H, P) x, (B, L, H) dt, (H,) A,
    (B, L, G, N) B and C, chunks of ``chunk`` and an initial (B, H, N, P)
    state (or None), x / B / C already holding values of ``scheme``'s
    dtype; slices of ``slice_p`` columns of P each on their own.  Returns
    y (B, L, H, P) and the final state, f32.  ``split=False`` takes one
    TF32 product where the kernel splits (to show it would not do)."""
    bf16 = scheme == "bfloat16"

    def prod(a, b, exact):
        if not split:
            return tf32_only(a) @ tf32_only(b)
        return mm(a, b, exact if bf16 else "none")

    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.zeros(Bsz, L, H, P)
    final = torch.zeros(Bsz, H, N, P)
    for b in range(Bsz):
        for h in range(H):
            g = h // (H // G)
            a2 = torch.tensor(float(A[h]) * LOG2E, dtype=torch.float32)
            for p0 in range(0, P, slice_p):
                cols = slice(p0, min(p0 + slice_p, P))
                st = (torch.zeros(N, cols.stop - p0) if init is None
                      else init[b, h, :, cols].clone())
                for l0 in range(0, L, chunk):
                    rows = slice(l0, l0 + chunk)
                    xs, d = x[b, rows, h, cols], dt[b, rows, h]
                    Bc, Cc = Bm[b, rows, g], Cm[b, rows, g]
                    cum, total = warp_cumsum(d * a2)         # log2 units
                    if bf16 and split:
                        s = Cc @ Bc.T                        # exact products
                    else:
                        s = prod(Cc, Bc.T, "none")
                    i = torch.arange(chunk)
                    causal = i[None, :] <= i[:, None]
                    seg = torch.where(causal, cum[:, None] - cum[None, :],
                                      torch.zeros(()))
                    att = torch.where(causal, s * torch.exp2(seg) * d[None, :],
                                      torch.zeros(()))
                    ys = torch.exp2(cum)[:, None] * prod(Cc, st, "a") \
                        + prod(att, xs, "b")
                    y[b, rows, h, cols] = ys
                    w = d * torch.exp2(total - cum)
                    st = torch.exp2(total) * st \
                        + prod(Bc.T, w[:, None] * xs, "a")
                final[b, h, :, cols] = st
    return y, final


def _inputs(seed, B, L, H, P, G, N, chunk, scheme, dt_shift=0.0):
    """x, dt, A, Bm, Cm and an initial state (f32 numpy), x / B / C rounded
    to the scheme's dtype; dt = softplus(normal + dt_shift): the JAX
    test's at 0, the model's small dt at -3, under which a state survives
    a chunk."""
    rng = np.random.default_rng(seed)

    def rnd(shape):
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return (a.to(torch.bfloat16).float() if scheme == "bfloat16"
                else a).numpy()
    return (rnd((B, L, H, P)),
            np.log1p(np.exp(rng.standard_normal((B, L, H)) + dt_shift))
            .astype(np.float32),
            -np.exp(rng.standard_normal(H)).astype(np.float32),
            rnd((B, L, G, N)), rnd((B, L, G, N)),
            rng.standard_normal((B, H, N, P)).astype(np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scheme", ["bfloat16", "float32"])
@pytest.mark.parametrize("slice_p", [8, 16])
@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_scheme_matches_the_pallas_kernel(scheme, slice_p, shape):
    *arrays, _ = _inputs(0, *shape, scheme)
    chunk = shape[-1]
    y, _ = ssd_scheme(*map(torch.from_numpy, arrays), chunk, None, scheme,
                      slice_p)
    _close(y, ops.ssd_scan(*map(jnp.asarray, arrays), chunk=chunk,
                           interpret=True))


@pytest.mark.parametrize("scheme", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_scheme_with_a_state_matches_ssd_chunked(scheme, shape):
    *arrays, init = _inputs(1, *shape, scheme, dt_shift=-3.0)
    chunk = shape[-1]
    y, h = ssd_scheme(*map(torch.from_numpy, arrays), chunk,
                      torch.from_numpy(init), scheme, 16)
    want_y, want_h = jax_ssm.ssd_chunked(*map(jnp.asarray, arrays), chunk,
                                         jnp.asarray(init))
    _close(y, want_y)
    _close(h, want_h)


def test_scheme_is_as_accurate_as_the_plain_version_at_a_long_prefill():
    """f32 inputs at mamba2's state and chunk (N 128, chunk 64), L 2048, a
    state in: against an f64 evaluation of the plain version, the model
    and the plain f32 version both stay within 32 f32 ulps of the largest
    value (2^-19 of it), so what parts the two is f32 rounding on both
    sides, not a loss of accuracy."""
    B, L, H, P, G, N, chunk = 1, 2048, 2, 16, 1, 128, 64
    *arrays, init = map(torch.from_numpy,
                        _inputs(3, B, L, H, P, G, N, chunk, "float32",
                                dt_shift=-3.0))
    y, h = ssd_scheme(*arrays, chunk, init, "float32", 16)
    want_y, want_h = ssd_scan_plain(*(a.double() for a in arrays), chunk,
                                    init.double(), return_state=True)
    plain_y, plain_h = ssd_scan_plain(*arrays, chunk, init, return_state=True)
    for got, plain, want in ((y, plain_y, want_y), (h, plain_h, want_h)):
        ulps32 = 2.0 ** -19 * float(want.abs().max())
        assert float((got.double() - want).abs().max()) <= ulps32
        assert float((plain.double() - want).abs().max()) <= ulps32


def test_one_tf32_product_would_miss_the_tolerance():
    """Without the split (one TF32 product where the kernel runs two or
    three) the scan misses 1e-4: TF32 keeps 10 mantissa bits."""
    shape = SHAPES["reduced mamba2"]
    *arrays, init = _inputs(1, *shape, "float32", dt_shift=-3.0)
    y, h = ssd_scheme(*map(torch.from_numpy, arrays), shape[-1],
                      torch.from_numpy(init), "float32", 16, split=False)
    want_y, want_h = jax_ssm.ssd_chunked(*map(jnp.asarray, arrays), shape[-1],
                                         jnp.asarray(init))
    assert not np.allclose(h.numpy(), np.asarray(want_h), **TOL)


def test_split_keeps_f32_accuracy():
    """hi has TF32's 10 explicit mantissa bits (the low 13 bits 0), and
    hi + lo as the mma reads them is x within 2^-21 relative."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(4096)
                         .astype(np.float32) * 10.0 ** np.random
                         .default_rng(3).uniform(-6, 6, 4096)
                         .astype(np.float32))
    hi, lo = split_tf32(x)
    assert not (hi.numpy().view(np.uint32) & 0x1FFF).any()
    assert not (lo.numpy().view(np.uint32) & 0x1FFF).any()
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs())
    assert float(rel.max()) <= 2.0 ** -21
    assert float(((hi.double() - x.double()).abs() / x.double().abs())
                 .max()) > 2.0 ** -14      # TF32 alone is coarse
