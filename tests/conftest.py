"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharding is tested on virtual CPU devices.  A run that selects only the
``gpu`` marker (``pytest -m gpu``, as ``chip_smoke.py`` does in its own
process on the card) keeps the platform JAX already has; those tests skip
in a fixture when there is no GPU.
"""

import os

import pytest


def pytest_configure(config):
    if config.option.markexpr == "gpu":
        return
    # XLA flags must be in the environment before the CPU client is created.
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")


def require_corpus():
    from snappy_tpu.testing import corpus

    if corpus.corpus_root() is None:
        pytest.skip("reference corpus not available")


@pytest.fixture
def corpus_root():
    from snappy_tpu.testing import corpus

    require_corpus()
    return corpus.corpus_root()
