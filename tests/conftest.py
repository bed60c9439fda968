"""Test harness: force an 8-device virtual CPU mesh so all sharding logic is
exercised without accelerator hardware.

The platform is pinned through jax.config as well as the environment, so
it holds even where jax was imported before this file runs.  Tests that
need the GPU carry the `gpu` marker and skip inside the test when no GPU
is visible; on a GPU host run them with
`TPZ_TEST_GPU=1 python -m pytest tests -m gpu`.
"""

import os

ON_GPU_RUN = os.environ.get("TPZ_TEST_GPU") == "1"

flags = os.environ.get("XLA_FLAGS", "")
if not ON_GPU_RUN and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
if not ON_GPU_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"  # for any subprocesses

import jax

if not ON_GPU_RUN:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one); run with "
        "TPZ_TEST_GPU=1 python -m pytest tests -m gpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided here, at test
    time, never while the module is imported)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; run with TPZ_TEST_GPU=1 on a GPU host")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0x7A91)


def corpus_samples(rng, sizes=(0, 1, 2, 7, 64, 255, 1000, 4096, 65536)):
    """A spread of adversarial inputs: empty, tiny, runs, random, text-like."""
    out = []
    for n in sizes:
        out.append(bytes(rng.integers(0, 256, n, dtype=np.uint8)))
    out.append(b"a" * 1000)
    out.append(b"abcabcabcabc" * 100)
    out.append(bytes(range(256)) * 16)
    out.append(b"the quick brown fox jumps over the lazy dog " * 64)
    # low-entropy biased bytes (compressible, exercises entropy models)
    out.append(bytes(rng.choice([0, 1, 2, 255], size=8192,
                                p=[0.7, 0.15, 0.1, 0.05]).astype(np.uint8)))
    return out


@pytest.fixture(scope="session")
def samples(rng):
    return corpus_samples(rng)
