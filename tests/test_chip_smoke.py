"""chip_smoke.py and bench.py without a GPU, the smoke's phases at a tiny
size on virtual CPU devices, and the compile-cache rule."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke
from tpuzip.runtime import compile_cache

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(script, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_exits_nonzero_without_gpu(script):
    r = _run(ROOT / script, ROOT)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout and "{" not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the checkout, the script cannot run the program."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path / "chip_smoke.py", tmp_path,
             {"PYTHONPATH": "", "PYTHONSAFEPATH": "1"})
    assert r.returncode != 0 and '"ok"' not in r.stdout


@pytest.fixture(scope="module")
def tiny_corpus():
    return chip_smoke.make_corpus(n_blocks=12, block_size=1024,
                                  short_tail=100)


def test_make_corpus_is_seeded_and_mixed(tiny_corpus):
    import numpy as np

    assert tiny_corpus == chip_smoke.make_corpus(n_blocks=12,
                                                 block_size=1024,
                                                 short_tail=100)
    assert len(tiny_corpus) == 12 * 1024 - 100
    rows = np.frombuffer(tiny_corpus[: 11 * 1024], np.uint8).reshape(11, -1)
    distinct = [len(set(r.tolist())) for r in rows]
    assert max(distinct) > 200 and min(distinct) < 100  # random and text


@pytest.mark.parametrize("ndev", [1, 4])
@pytest.mark.parametrize("phase", ["phase_ari", "phase_lz4"])
def test_smoke_phase_tiny(tiny_corpus, phase, ndev):
    getattr(chip_smoke, phase)(jax.devices()[:ndev], tiny_corpus,
                               block_size=1024)


def test_smoke_phase_four_cards_tiny(tiny_corpus):
    sizes = chip_smoke.phase_four_cards(jax.devices()[:4], tiny_corpus,
                                        block_size=1024)
    assert set(sizes) == {"ari", "lz4"}


@pytest.mark.parametrize("env_value", ["/somewhere/jax-cache", None])
def test_compile_cache_rule(env_value):
    env = {} if env_value is None else {
        "JAX_COMPILATION_CACHE_DIR": env_value}
    want = env_value or str(ROOT / ".jax_cache")
    assert compile_cache.cache_dir(env) == want
