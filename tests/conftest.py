"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests must see the
real single CPU device; only dryrun subprocesses force 512 devices."""
import jax
import pytest


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
