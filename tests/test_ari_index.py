"""The fast-decode chunk index (codecs/ari_index.py): packing, parsing,
the per-chunk deltas every encoder writes, and the window prepack of the
bin/apm lane decoder."""

import numpy as np
import pytest

import jax.numpy as jnp

from tpuzip.codecs import ari_index as ai
from tpuzip.oracle import ari as oari


def _encode_with_deltas(data: bytes, n_pad: int,
                        increment=8, threshold=1 << 13):
    model = oari.TableModel(256, increment, threshold)
    enc = oari.RangeEncoder()
    counts = np.zeros(n_pad, np.int32)
    for t, b_ in enumerate(data):
        lo, hi = model.get_range(b_)
        before = len(enc.out)
        enc.encode(lo, hi, model.get_denominator())
        counts[t] = len(enc.out) - before
        model.update(b_)
    stream = enc.finish()
    nc = n_pad // ai.CHUNK_STEPS
    return stream, counts.reshape(nc, ai.CHUNK_STEPS).sum(1)


def test_chunk_index_roundtrip():
    d = np.array([0, 1, 254, 255, 256, 100, 255, 0], np.int32)
    blob = ai.pack_chunk_index(d)
    assert (ai.parse_chunk_index(blob, len(d)) == d).all()
    with pytest.raises(ValueError):
        ai.parse_chunk_index(blob + b"\x01", len(d))
    with pytest.raises(ValueError):
        ai.parse_chunk_index(blob[:-1], len(d))


def test_build_windows(rng):
    CAP, L, NC, W = 600, 128, 5, 16
    comp = rng.integers(0, 256, (CAP, L), dtype=np.uint8)
    starts = np.sort(rng.integers(0, CAP, (NC, L)), axis=0).astype(np.int32)
    win = np.asarray(ai.build_windows(jnp.array(comp), jnp.array(starts), W))
    cpad = np.vstack([comp, np.zeros((8, L), np.uint8)]).astype(np.uint32)
    for k in range(NC):
        for l in (0, 127):
            for j in (0, W - 1):
                p = min(int(starts[k, l]) + 4 * j, CAP)
                exp = ((cpad[p, l] << 24) | (cpad[p + 1, l] << 16)
                       | (cpad[p + 2, l] << 8) | cpad[p + 3, l])
                assert win[k * W + j, l] == exp


def test_native_build_windows_matches_xla(rng):
    """The threaded C++ window build (production prepack) equals the XLA
    formulation word for word."""
    from tpuzip.runtime import native

    B, CAP, NC, W = 5, 700, 6, 16
    streams = rng.integers(0, 256, (B, CAP), dtype=np.uint8)
    deltas = rng.integers(0, 60, (B, NC)).astype(np.int32)
    got = native.ari_build_windows(streams, deltas, W)
    starts = 4 + np.cumsum(deltas, axis=1) - deltas
    want = np.asarray(ai.build_windows(jnp.array(streams.T),
                                       jnp.array(starts.T), W))
    assert np.array_equal(got, want.T)


def test_encode_indexed_deltas_match_oracle(rng):
    """The XLA encode path's chunk index equals the oracle's renorm
    trace."""
    from tpuzip.codecs import ari as jari

    N = 1024
    data = bytes(rng.integers(0, 256, N, dtype=np.uint8))
    _, exp_deltas = _encode_with_deltas(data, N)
    comp, clen, counts = jari.encode_with_counts(
        jnp.array(np.frombuffer(data, np.uint8)), jnp.int32(N))
    got = np.asarray(ai.chunk_deltas(counts[None]))[0]
    assert (got == exp_deltas).all()


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 200])
def test_chunk_deltas_pads_the_last_chunk(n):
    counts = np.arange(n, dtype=np.int32)[None] % 5
    got = ai.chunk_deltas(counts)
    assert got.shape == (1, ai.num_chunks(n))
    for c in range(ai.num_chunks(n)):
        assert got[0, c] == counts[0, 64 * c : 64 * c + 64].sum()
