"""The XLA formulations of MTF and DC decode, and the host C++ bin/apm
coder, against the oracle — at the sizes the retired device-kernel tests
used, so the stages the backend table can still pick stay covered."""

import pathlib

import numpy as np

import jax
import jax.numpy as jnp

from tpuzip.codecs import bin_apm, dc as jdc, mtf as jmtf
from tpuzip.oracle import bwt as obwt, dc as odc, mtf as omtf
from tpuzip.runtime import native

SURVEY = pathlib.Path(__file__).resolve().parent.parent / "SURVEY.md"


def _mtf(rows, decode=False):
    fn = jmtf.decode_batch if decode else jmtf.encode_batch
    lens = jnp.full(rows.shape[0], rows.shape[1], jnp.int32)
    return np.asarray(jax.jit(fn)(jnp.array(rows), lens))


def test_xla_mtf_encode_vs_oracle(rng):
    blocks = rng.integers(0, 256, (5, 512), dtype=np.uint8)
    enc = _mtf(blocks)
    for i in range(5):
        assert enc[i].tobytes() == omtf.encode(blocks[i].tobytes()), i


def test_xla_mtf_decode_round_trip(rng):
    blocks = rng.integers(0, 256, (3, 256), dtype=np.uint8)
    dec = _mtf(_mtf(blocks), decode=True)
    assert np.array_equal(dec, blocks)


def test_xla_mtf_many_lanes(rng):
    B, N = 128, 256
    blocks = np.tile(np.frombuffer(b"abracadabra abba " * 16, np.uint8)[:N],
                     (B, 1)).copy()
    blocks[1::2] = rng.integers(0, 256, ((B + 1) // 2, N), dtype=np.uint8)
    enc = _mtf(blocks)
    for i in (0, 1, 64, 127):
        assert enc[i].tobytes() == omtf.encode(blocks[i].tobytes()), i


def _dc_rows(cases):
    comps = [odc.encode(c) for c in cases]
    cap = max(len(c) for c in comps) + 8
    rows = np.zeros((len(cases), cap), np.uint8)
    lens = np.zeros(len(cases), np.int32)
    for i, c in enumerate(comps):
        rows[i, : len(c)] = np.frombuffer(c, np.uint8)
        lens[i] = len(c)
    return rows, lens


def _dc_decode(rows, lens, n):
    ms = int(lens.max()) - jdc.HDR
    out, olens, errs = jax.jit(jdc.decode_batch, static_argnums=(2, 3))(
        jnp.array(rows), jnp.array(lens), n, ms)
    return np.asarray(out), np.asarray(olens), np.asarray(errs)


def test_xla_dc_decode_vs_oracle(rng):
    N = 2048
    cases = [
        obwt.encode_block(SURVEY.read_bytes()[:N])[0],          # runs
        bytes(rng.integers(0, 256, N, dtype=np.uint8)),
        b"a" * N,
        (b"ababab" * 400)[:N],
        b"z" * 17,                                               # ragged
    ]
    rows, lens = _dc_rows(cases)
    out, olens, errs = _dc_decode(rows, lens, N)
    for i, c in enumerate(cases):
        assert errs[i] == 0 and olens[i] == len(c), i
        assert out[i, : len(c)].tobytes() == c, i
    bad = rows.copy()
    bad[0, jdc.HDR + 2] ^= 0x80   # corrupt stream flags its own block only
    _, _, err2 = _dc_decode(bad, lens, N)
    assert err2[0] == 1 and err2[1] == 0 and err2[2] == 0


def test_xla_dc_decode_flags_a_bad_first_occurrence_table(rng):
    n = 512
    cases = [(b"abracadabra banana " * 40)[:n],
             rng.integers(0, 3, n, dtype=np.uint8).tobytes(), bytes(n),
             rng.integers(0, 256, n, dtype=np.uint8).tobytes()]
    rows, lens = _dc_rows(cases)
    out, _, errs = _dc_decode(rows, lens, n)
    assert not errs.any()
    for i, c in enumerate(cases):
        assert out[i, :n].tobytes() == c, i
    bad = rows.copy()
    bad[2, 4] = 0xFF  # clobber block 2's first-occurrence table
    _, _, errs = _dc_decode(bad, lens, n)
    assert errs[2] != 0 and errs[[0, 1, 3]].sum() == 0


def test_host_bin_coder_vs_xla_oracle_chain(rng):
    """The threaded C++ bin/apm coder writes the streams of the XLA bit
    coder (codecs/bin_apm.py, itself pinned to the oracle models)."""
    nbytes = 32
    data = np.zeros((3, nbytes), np.uint8)
    data[0] = rng.integers(0, 256, nbytes)
    data[1] = np.packbits((rng.random(8 * nbytes) < 0.05).astype(np.uint8))
    data[2, :9] = 0xFF
    lens = np.array([nbytes, nbytes, 9], np.int32)
    for use_apm in (False, True):
        comp, clens = native.bin_encode_batch_native(data, lens,
                                                     use_apm=use_apm)
        for i in range(3):
            bits = np.unpackbits(data[i])
            want, wlen = bin_apm.encode_bits(
                jnp.array(bits), jnp.int32(8 * int(lens[i])),
                use_apm=use_apm)
            assert comp[i, : clens[i]].tobytes() == \
                np.asarray(want)[: int(wlen)].tobytes(), (use_apm, i)
