import os

# Tests run on the single real CPU device (the 512-device override is ONLY
# for the dry-run, set inside repro.launch.dryrun before jax import).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "pallas: Pallas-kernel parity tests (interpret mode off-TPU) — "
        "select with `-m pallas`, skip with `-m 'not pallas'`")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the PyTorch port's CUDA "
        "kernels); skips without one")
    # QLINT_INVARIANTS=1 turns the whole suite into an invariant suite:
    # every BlockManager state transition and every engine round boundary
    # (in ANY test, however the engine was constructed) runs
    # repro.analysis.invariants checks.  QLINT_INVARIANTS_SAMPLE=N keeps
    # it cheap on long property tests.
    from repro.analysis.invariants import install_test_hooks, \
        invariants_enabled
    if invariants_enabled():
        install_test_hooks()


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.key(0)
