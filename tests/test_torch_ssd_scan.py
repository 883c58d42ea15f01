"""The port's SSD scan (``repro_torch.kernels.ssd_scan``) against the JAX
reference on the CPU, where the wrapper runs ``ssd_scan_plain``:

  * the Pallas kernel in interpret mode (``ops.ssd_scan``, zero initial
    state) on the JAX tests' three shapes and the reduced mamba2 shape;
  * the per-token recurrence ``ssd_recurrent_reference``, for y and the
    final state;
  * the reference's ``ssm.ssd_chunked`` with a nonzero ``init_state``, for
    y and the final state;

and the wrapper's own rules: rows with dt = 0 (the model's padding to a
chunk multiple) leave the state alone, ``L % chunk != 0`` and mixed
devices raise.

Tolerance: atol = rtol = 5e-4, as the JAX kernel test allows (both compute
in f32; the two frameworks sum the products in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.models import ssm as jax_ssm
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import ssm as port_ssm

torch.set_num_threads(2)
TOL = dict(atol=5e-4, rtol=5e-4)

# (B, L, H, P, G, N, chunk): tests/test_kernels.py's three, then the
# reduced mamba2 config's widths (16 heads of 32, N 16, chunk 16)
SHAPES = {"(1,64,2,16,1,8,16)": (1, 64, 2, 16, 1, 8, 16),
          "(2,128,4,32,2,16,32)": (2, 128, 4, 32, 2, 16, 32),
          "groups (1,32,8,8,4,4,8)": (1, 32, 8, 8, 4, 4, 8),
          "reduced mamba2": (1, 48, 16, 32, 1, 16, 16)}


def _inputs(seed, B, L, H, P, G, N, chunk, dt_shift=0.0):
    """x, dt, A, Bm, Cm and an initial state; dt = softplus(normal +
    dt_shift): the JAX test's dt at 0, the model's small dt (its dt_bias
    puts dt near 1e-3 .. 1e-1) at -3, under which a state survives a
    chunk."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, L, H, P)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((B, L, H)) + dt_shift))
            .astype(np.float32),
            -np.exp(rng.standard_normal(H)).astype(np.float32),
            rng.standard_normal((B, L, G, N)).astype(np.float32),
            rng.standard_normal((B, L, G, N)).astype(np.float32),
            rng.standard_normal((B, H, N, P)).astype(np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_matches_the_pallas_kernel_and_the_recurrence(shape):
    *arrays, _ = _inputs(0, *shape)
    chunk = shape[-1]
    y = ss.ssd_scan(*map(torch.tensor, arrays), chunk)
    y2, h = ss.ssd_scan(*map(torch.tensor, arrays), chunk,
                        return_state=True)
    assert torch.equal(y, y2) and h.dtype == torch.float32
    _close(y, ops.ssd_scan(*map(jnp.asarray, arrays), chunk=chunk,
                           interpret=True))
    want_y, want_h = jax_ssm.ssd_recurrent_reference(*map(jnp.asarray,
                                                          arrays))
    _close(y, want_y)
    _close(h, want_h)


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_initial_and_final_state_match_ssd_chunked(shape):
    *arrays, init = _inputs(1, *shape, dt_shift=-3.0)
    chunk = shape[-1]
    y, h = ss.ssd_scan(*map(torch.tensor, arrays), chunk,
                       torch.tensor(init), return_state=True)
    y0 = ss.ssd_scan(*map(torch.tensor, arrays), chunk)
    # the initial state reaches y past the first chunk: it is carried
    # across a chunk boundary, as every chunk's state is
    assert float((y - y0)[:, chunk:].abs().max()) > 1e-2
    want_y, want_h = jax_ssm.ssd_chunked(*map(jnp.asarray, arrays), chunk,
                                         jnp.asarray(init))
    _close(y, want_y)
    _close(h, want_h)
    # and the port's own recurrence, the model's oracle
    rec_y, rec_h = port_ssm.ssd_recurrent_reference(
        *map(torch.tensor, arrays), torch.tensor(init))
    torch.testing.assert_close(y, rec_y, **TOL)
    torch.testing.assert_close(h, rec_h, **TOL)


def test_rows_with_zero_dt_leave_the_state_alone():
    """The model pads a prompt to a chunk multiple after the conv with dt
    = 0 rows: whatever x, B and C hold there, the final state equals the
    exact-length recurrence's."""
    B, L, H, P, G, N, chunk = SHAPES["reduced mamba2"]
    x, dt, A, Bm, Cm, init = map(torch.tensor, _inputs(2, *SHAPES[
        "reduced mamba2"]))
    n = 37                                      # 11 padded rows
    dt_pad = dt.clone()
    dt_pad[:, n:] = 0
    _, h = ss.ssd_scan(x, dt_pad, A, Bm, Cm, chunk, init, return_state=True)
    _, want = port_ssm.ssd_recurrent_reference(
        x[:, :n], dt[:, :n], A, Bm[:, :n], Cm[:, :n], init)
    torch.testing.assert_close(h, want, **TOL)


def test_refusals():
    x, dt, A, Bm, Cm, init = map(torch.tensor,
                                 _inputs(3, 1, 40, 2, 8, 1, 4, 16))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ss.ssd_scan(x, dt, A, Bm, Cm, 16)
    with pytest.raises(ValueError, match="shape mismatch"):
        ss.ssd_scan(x, dt[:, :, :1], A, Bm, Cm, 8)
    with pytest.raises(ValueError, match="init_state"):
        ss.ssd_scan(x, dt, A, Bm, Cm, 8, init[:, :1])
    # a tensor off the CPU never reaches the plain version
    with pytest.raises(ValueError, match="one CUDA device"):
        ss.ssd_scan(x, dt, A.to("meta"), Bm, Cm, 8)
