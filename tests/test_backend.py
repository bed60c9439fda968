"""The backend table (tpuzip/dist/backend.py): one implementation per
(platform, stage), an error for any platform it does not name, and the
runner following it."""

import numpy as np
import pytest

from tpuzip.dist import backend

EXPECTED = {
    ("cpu", "ari_encode"): "host",
    ("cpu", "ari_decode"): "host",
    ("cpu", "bwt_forward"): "host",
    ("cpu", "mtf"): "host",
    ("cpu", "dc_encode"): "host",
    ("cpu", "dc_decode"): "host",
    ("cpu", "bin_encode"): "host",
    ("gpu", "ari_encode"): "cuda",
    ("gpu", "ari_decode"): "cuda",
    ("gpu", "bwt_forward"): "xla",
    ("gpu", "mtf"): "host",
    ("gpu", "dc_encode"): "host",
    ("gpu", "dc_decode"): "host",
    ("gpu", "bin_encode"): "host",
}


@pytest.mark.parametrize("platform,stage", sorted(EXPECTED))
def test_backend_table_entry(platform, stage):
    assert backend.impl(stage, platform) == EXPECTED[platform, stage]


def test_backend_table_is_complete():
    assert set(backend.TABLE) == {p for p, _ in EXPECTED}
    for row in backend.TABLE.values():
        assert set(row) == set(backend.STAGES)
        assert set(row.values()) <= {backend.HOST, backend.CUDA, backend.XLA}


@pytest.mark.parametrize("platform", ["rocm", "metal", ""])
def test_unknown_platform_raises(platform):
    with pytest.raises(backend.UnsupportedPlatformError):
        backend.impl("ari_encode", platform or "none")


def test_unknown_stage_raises():
    with pytest.raises(KeyError):
        backend.impl("huffman", "cpu")


def test_current_platform_is_cpu_here():
    assert backend.platform() == "cpu"
    assert backend.impl("ari_encode") == "host"


def test_using_switches_and_restores():
    before = dict(backend.TABLE["cpu"])
    with backend.using(ari_encode="xla", bwt_forward="xla"):
        assert backend.impl("ari_encode") == "xla"
        assert backend.impl("bwt_forward") == "xla"
    assert backend.TABLE["cpu"] == before
    # host-only stages and implementations a stage lacks cannot be chosen
    for bad in ({"mtf": "xla"}, {"bwt_forward": "cuda"}):
        with pytest.raises(ValueError):
            with backend.using(**bad):
                pass
    assert backend.TABLE["cpu"] == before


def test_runner_follows_the_table():
    """With the ari stages switched to the XLA coder, compress/decompress
    take the device wrapper's path over the 8-device mesh — slicing,
    sharding and container bytes included — and the containers equal the
    host coder's."""
    from tpuzip.dist import runner

    rng = np.random.default_rng(5)
    data = bytes(rng.integers(0, 64, 8 * 1024 - 100, dtype=np.uint8))
    want = runner.compress(data, codec="ari", block_size=1024)
    with backend.using(ari_encode="xla", ari_decode="xla"):
        got = runner.compress(data, codec="ari", block_size=1024)
        assert got == want
        assert runner.decompress(got) == data
        dev, olens, orig = runner.decompress(got, to_device=True)
    assert orig == len(data) and len(dev.sharding.device_set) == 8
    assert np.asarray(dev).reshape(-1)[: len(data)].tobytes() == data


@pytest.mark.parametrize("codec", ["bwt", "bwtdc"])
def test_runner_xla_stages_match_host(codec):
    """The XLA BWT forward stage writes the same containers as the host
    one."""
    from tpuzip.dist import runner

    data = (b"the quick brown fox jumps over the lazy dog " * 200)[:6000]
    want = runner.compress(data, codec=codec, block_size=2048)
    with backend.using(bwt_forward="xla"):
        got = runner.compress(data, codec=codec, block_size=2048)
        assert got == want
        assert runner.decompress(got) == data
