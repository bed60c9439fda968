"""Round-2 pipeline paths: fast BWT, segmented big blocks, planned LZ4 and
deflate decodes, container knobs."""

import numpy as np
import pytest

import jax.numpy as jnp

from tpuzip.codecs import bwt as jbwt
from tpuzip.dist import runner
from tpuzip.oracle import bwt as obwt


def _mixed(rng, n):
    text = (open("/root/repo/SURVEY.md", "rb").read() * 40)[: n // 2]
    return (text + bytes(rng.integers(0, 256, n - len(text),
                                      dtype=np.uint8)))[:n]


def test_bwt_encode_batch_fast_vs_oracle(rng):
    N = 1024
    blocks = np.zeros((6, N), np.uint8)
    lens = np.array([N, N, 700, N, 3, N], np.int32)
    blocks[0] = np.frombuffer(
        open("/root/repo/SURVEY.md", "rb").read()[:N], np.uint8)
    blocks[1] = rng.integers(0, 256, N, dtype=np.uint8)
    blocks[2, :700] = np.frombuffer((b"banana" * 120)[:700], np.uint8)
    blocks[3] = np.frombuffer(b"ab" * (N // 2), np.uint8)  # periodic ties
    blocks[4, :3] = (65, 66, 65)
    blocks[5] = 0                                          # max ties
    # the public entry (routes to the implementation the backend table names) AND
    # the XLA device formulation must both match the oracle
    for fwd in (lambda b_, l: jbwt.encode_batch_fast(b_, l),
                lambda b_, l: jbwt._encode_batch_fast(
                    b_, l, bool((np.asarray(l) == b_.shape[1]).all()))):
        L, orgs = fwd(jnp.array(blocks), jnp.array(lens))
        L, orgs = np.asarray(L), np.asarray(orgs)
        for i in range(6):
            expL, expo = obwt.encode_block(blocks[i, : lens[i]].tobytes())
            assert L[i, : lens[i]].tobytes() == expL, i
            assert orgs[i] == expo, i


@pytest.mark.parametrize("r", [0, 2, 4])
def test_bwt_decode_fast_walkers(r, rng):
    N = 1024
    blocks = rng.integers(0, 8, (4, N), dtype=np.uint8)
    lens = np.array([N, N, 513, N], np.int32)
    L, orgs = jbwt.encode_batch_fast(jnp.array(blocks), jnp.array(lens))
    out = np.asarray(jbwt.decode_batch_fast(L, orgs, jnp.array(lens),
                                            walkers_log2=r))
    for i in range(4):
        assert out[i, : lens[i]].tobytes() == \
            blocks[i, : lens[i]].tobytes(), (r, i)


def test_segmented_bwt_container(rng):
    data = _mixed(rng, (2 << 20) + 12345)
    c = runner.compress(data, codec="bwt", block_size=2 << 20)
    assert c[5] & 8  # segmented flag
    assert runner.decompress(c) == data


def test_segmented_bwt_corrupt_detected(rng):
    data = _mixed(rng, 2 << 20)
    c = bytearray(runner.compress(data, codec="bwt", block_size=2 << 20))
    c[len(c) // 2] ^= 0xFF
    with pytest.raises(Exception):
        runner.decompress(bytes(c))


def test_lz4_planned_decode_matches(rng):
    from tpuzip.codecs import lz4 as jlz4
    from tpuzip.oracle import lz4 as olz4
    from tpuzip.runtime import native

    if not native.available():
        pytest.skip("native lib unavailable")
    N = 1 << 14
    blocks = np.zeros((3, N), np.uint8)
    blocks[0] = np.frombuffer(_mixed(rng, N), np.uint8)
    blocks[1] = rng.integers(0, 256, N, dtype=np.uint8)
    blocks[2] = np.frombuffer((b"aaaaabaaaaab" * (N // 12 + 1))[:N], np.uint8)
    cap = jlz4.encode_cap(N)
    comp = np.zeros((3, cap), np.uint8)
    cl = np.zeros(3, np.int64)
    for i in range(3):
        c = olz4.compress_block(blocks[i].tobytes())
        comp[i, : len(c)] = np.frombuffer(c, np.uint8)
        cl[i] = len(c)
    out, olens, errs = jlz4.decode_batch_planned(comp, cl, N)
    assert int(np.asarray(errs).sum()) == 0
    assert (np.asarray(olens) == N).all()
    assert (np.asarray(out) == blocks).all()


def test_lz4_wplanned_decode_matches(rng):
    from tpuzip.codecs import lz4 as jlz4
    from tpuzip.oracle import lz4 as olz4
    from tpuzip.runtime import native

    if not native.available():
        pytest.skip("native lib unavailable")
    N = 1 << 14
    blocks = np.zeros((5, N), np.uint8)
    lens = np.array([N, N, N, N - 3, 37], np.int32)  # ragged tails too
    blocks[0] = np.frombuffer(_mixed(rng, N), np.uint8)
    blocks[1] = rng.integers(0, 256, N, dtype=np.uint8)
    blocks[2] = np.frombuffer((b"aaaaabaaaaab" * (N // 12 + 1))[:N],
                              np.uint8)
    blocks[3, : N - 3] = np.frombuffer(
        (b"hello world! " * (N // 13 + 1))[: N - 3], np.uint8)
    blocks[4, :37] = np.frombuffer(b"x" * 37, np.uint8)
    cap = jlz4.encode_cap(N)  # deliberately NOT 4-aligned (65873-style)
    comp = np.zeros((5, cap), np.uint8)
    cl = np.zeros(5, np.int64)
    for i in range(5):
        c = olz4.compress_block(blocks[i, : lens[i]].tobytes())
        comp[i, : len(c)] = np.frombuffer(c, np.uint8)
        cl[i] = len(c)
    out, olens, errs = jlz4.decode_batch_wplanned(comp, cl, N)
    out = np.asarray(out)
    assert int(np.asarray(errs).sum()) == 0
    assert (np.asarray(olens) == lens).all()
    for i in range(5):
        assert out[i, : lens[i]].tobytes() == \
            blocks[i, : lens[i]].tobytes(), i
        assert not out[i, lens[i]:].any(), i


def test_lz4_wplanned_corrupt_and_overflow(rng):
    from tpuzip.codecs import lz4 as jlz4
    from tpuzip.oracle import lz4 as olz4
    from tpuzip.runtime import native

    if not native.available():
        pytest.skip("native lib unavailable")
    N = 4096
    good = rng.integers(0, 64, N, dtype=np.uint8)
    c = olz4.compress_block(good.tobytes())
    comp = np.zeros((2, jlz4.encode_cap(N)), np.uint8)
    comp[0, : len(c)] = np.frombuffer(c, np.uint8)
    comp[1, :3] = (0xFF, 0xFF, 0xFF)  # corrupt
    out, olens, errs = jlz4.decode_batch_wplanned(
        comp, np.array([len(c), 3], np.int64), N)
    errs = np.asarray(errs)
    assert errs[0] == 0 and errs[1] == 1
    assert np.asarray(out)[0].tobytes() == good.tobytes()
    # a tiny explicit patch budget raises OverflowError (fallback
    # trigger); short matches make nearly every word a boundary word
    c2 = olz4.compress_block((b"hello world! " * (N // 13 + 1))[:N])
    with pytest.raises(OverflowError):
        native.lz4_decode_wplan(c2, N, patch_cap=8)


def test_lz4_planned_corrupt_block_isolated(rng):
    from tpuzip.codecs import lz4 as jlz4
    from tpuzip.oracle import lz4 as olz4
    from tpuzip.runtime import native

    if not native.available():
        pytest.skip("native lib unavailable")
    N = 4096
    good = rng.integers(0, 64, N, dtype=np.uint8)
    c = olz4.compress_block(good.tobytes())
    comp = np.zeros((2, jlz4.encode_cap(N)), np.uint8)
    comp[0, : len(c)] = np.frombuffer(c, np.uint8)
    comp[1, :3] = (0xFF, 0xFF, 0xFF)  # corrupt
    out, olens, errs = jlz4.decode_batch_planned(
        comp, np.array([len(c), 3], np.int64), N)
    errs = np.asarray(errs)
    assert errs[0] == 0 and errs[1] == 1
    assert np.asarray(out)[0].tobytes() == good.tobytes()


def test_deflate_planned_decode(rng):
    from tpuzip.codecs import deflate as jdef
    from tpuzip.runtime import native

    if not native.available():
        pytest.skip("native lib unavailable")
    data = _mixed(rng, 100000)
    c = runner.compress(data, codec="deflate", block_size=1 << 14)
    assert runner.decompress(c) == data
    # plan parity vs stock zlib streams
    import zlib

    z = zlib.compress(data, 9)[2:-4]
    p, lits = native.inflate_plan(z, len(data) + 64)
    assert lits[p].tobytes() == data


def test_native_inflate_vs_zlib_levels(rng):
    import zlib

    from tpuzip.runtime import native

    if not native.available():
        pytest.skip("native lib unavailable")
    data = _mixed(rng, 150000)
    for lvl in (0, 1, 6, 9):
        z = zlib.compress(data, lvl)[2:-4]
        assert native.inflate(z, len(data) + 64) == data
    with pytest.raises(ValueError):
        native.inflate(b"\x04\x00", 64)  # reserved block type 3... btype bits


def test_container_ari_params_recorded(rng):
    from tpuzip.core.config import Config

    data = _mixed(rng, 60000)
    cfg = Config()
    cfg.codec.ari.increment = 24
    cfg.codec.ari.threshold = 1 << 12
    c1 = runner.compress(data, codec="ari", block_size=1 << 13)
    c2 = runner.compress(data, codec="ari", block_size=1 << 13, config=cfg)
    assert c2[5] & 4 and not (c1[5] & 4)
    assert c1 != c2
    assert runner.decompress(c1) == data
    assert runner.decompress(c2) == data


def test_metrics_phases_populated(rng):
    from tpuzip.utils.metrics import RunMetrics

    data = _mixed(rng, 40000)
    m = RunMetrics()
    c = runner.compress(data, codec="lz4", metrics=m)
    assert {"chunk", "encode", "assemble", "checksum"} <= set(m.phases)
    m2 = RunMetrics()
    assert runner.decompress(c, metrics=m2) == data
    assert "decode" in m2.phases and "verify" in m2.phases
    assert m2.phases["decode"].seconds > 0
