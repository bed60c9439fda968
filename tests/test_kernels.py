"""Device coders: the ari GPU wrapper (tpuzip.kernels.ari_cuda) and the
chunk-indexed bin/apm lane decoder (codecs/bin_apm.py).

The CUDA coder has no interpret mode.  On the CPU the wrapper — knobs,
output shapes, padding, zero-length and short blocks, sharding over the
mesh — is driven with the plain XLA coder passed in explicitly; the tests
marked `gpu` compare the CUDA coder with the host C++ coder on the card
(`TPZ_TEST_GPU=1 python -m pytest tests -m gpu`)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpuzip.codecs import ari_index
from tpuzip.kernels import ari_cuda
from tpuzip.oracle import ari as oari
from tpuzip.runtime import native


def _blocks(rng, b, n):
    rows = np.zeros((b, n), np.uint8)
    rows[0] = rng.integers(0, 256, n)                       # random
    rows[1] = rng.integers(0, 4, n)                         # skewed
    rows[2] = 7                                             # constant
    rows[3] = np.frombuffer((b"ari wrapper contract " * n)[:n], np.uint8)
    rows[4:] = rng.integers(0, 256, (b - 4, n))
    lens = np.full(b, n, np.int32)
    lens[-2] = 0                                            # empty block
    lens[-1] = n // 3 + 1                                   # short last
    rows[-1, lens[-1]:] = 0
    rows[-2] = 0
    return rows, lens


@pytest.mark.parametrize("n", [256, 300])
def test_ari_wrapper_encode_layout_xla_coder(rng, n):
    """Streams (B, 2n+64) zero past each length, lengths (B,), chunk index
    (B, ceil(n/64)) with the last chunk padded — equal to the oracle and
    to the host C++ coder."""
    rows, lens = _blocks(rng, 6, n)
    comp, clens, deltas = ari_cuda.encode(rows, lens,
                                          coder=ari_cuda.xla_encode)
    comp, clens, deltas = map(np.asarray, (comp, clens, deltas))
    assert comp.shape == (6, 2 * n + 64) and comp.dtype == np.uint8
    assert clens.shape == (6,) and clens.dtype == np.int32
    assert deltas.shape == (6, ari_index.num_chunks(n))
    hcomp, hclens, hdeltas = native.ari_encode_indexed_batch(
        rows, lens, ari_index.num_chunks(n))
    assert np.array_equal(clens, hclens) and np.array_equal(deltas, hdeltas)
    for i in range(6):
        want = oari.encode_bytes(rows[i, : lens[i]].tobytes())
        assert comp[i, : clens[i]].tobytes() == want, i
        assert not comp[i, clens[i]:].any(), i


def test_ari_wrapper_zero_length_and_short_last_block(rng):
    rows, lens = _blocks(rng, 6, 256)
    comp, clens, deltas = ari_cuda.encode(rows, lens,
                                          coder=ari_cuda.xla_encode)
    assert int(clens[-2]) == 4 and not np.asarray(deltas)[-2].any()
    nshort = ari_index.num_chunks(int(lens[-1]))
    assert not np.asarray(deltas)[-1, nshort:].any()
    out = np.asarray(ari_cuda.decode(comp, clens, lens, n=256,
                                     coder=ari_cuda.xla_decode))
    assert out.shape == (6, 256)
    assert np.array_equal(out, rows)   # zero past every block's count


@pytest.mark.parametrize("knobs", [(8, 1 << 13), (16, 1 << 10), (3, 300)])
def test_ari_wrapper_decode_round_trip_xla_coder(rng, knobs):
    """Host-encoded streams decode through the wrapper at the default and
    non-default knobs, across many model halvings."""
    inc, thr = knobs
    rows, lens = _blocks(rng, 5, 512)
    hcomp, hclens, _ = native.ari_encode_indexed_batch(
        rows, lens, 8, increment=inc, threshold=thr)
    w = int(hclens.max())
    out = ari_cuda.decode(hcomp[:, :w], hclens, lens, n=512, increment=inc,
                          threshold=thr, coder=ari_cuda.xla_decode)
    assert np.array_equal(np.asarray(out), rows)


def test_ari_wrapper_widens_narrow_rows():
    out = ari_cuda.decode(np.zeros((2, 1), np.uint8), np.zeros(2),
                          np.zeros(2), n=8, coder=ari_cuda.xla_decode)
    assert np.asarray(out).shape == (2, 8) and not np.asarray(out).any()


def test_ari_wrapper_over_mesh_xla_coder(rng):
    """Under a 4-device dp mesh every device codes its own rows; the
    result equals the unsharded call."""
    from tpuzip.dist import mesh as meshlib

    mesh = meshlib.make_mesh(4)
    rows, lens = _blocks(rng, 8, 256)
    one = ari_cuda.encode(rows, lens, coder=ari_cuda.xla_encode)
    four = ari_cuda.encode(rows, lens, coder=ari_cuda.xla_encode, mesh=mesh)
    for a, b in zip(one, four):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    out = ari_cuda.decode(one[0], one[1], lens, n=256,
                          coder=ari_cuda.xla_decode, mesh=mesh)
    assert len(out.sharding.device_set) == 4
    assert np.array_equal(np.asarray(out), rows)


@pytest.mark.parametrize("target,path", [
    ("all", "tpuzip.runtime.native"), ("cuda", "tpuzip.kernels.ari_cuda")])
def test_library_paths_match_make_targets(target, path):
    """The loaders open the file their make target builds."""
    import importlib
    import pathlib
    import re

    makefile = pathlib.Path(native._CSRC, "Makefile").read_text()
    built = re.search(rf"^{target}: (\S+)$", makefile, re.M).group(1)
    lib = pathlib.Path(importlib.import_module(path)._LIB_PATH)
    assert lib.name == built and lib.parent == pathlib.Path(native._CSRC)


@pytest.mark.gpu
def test_cuda_coder_matches_host_at_smoke_shape(gpu):
    """4096 x 64 KiB: CUDA streams, lengths and chunk indexes equal the
    host C++ coder's, and the CUDA decoder inverts them."""
    import chip_smoke

    corpus = chip_smoke.make_corpus()
    rows, lens = chip_smoke.blk.chunk_padded(corpus, 1 << 16, 1)
    comp, clens, deltas = map(np.asarray, ari_cuda.encode(rows, lens))
    hcomp, hclens, hdeltas = native.ari_encode_indexed_batch(
        rows, lens, 1024)
    w = int(hclens.max())
    assert np.array_equal(clens, hclens) and np.array_equal(deltas, hdeltas)
    assert np.array_equal(comp[:, :w], hcomp[:, :w])
    out = ari_cuda.decode(comp[:, :w], clens, lens, n=1 << 16)
    assert np.array_equal(np.asarray(out), rows)


@pytest.mark.gpu
@pytest.mark.parametrize("knobs", [(8, 1 << 13), (16, 1 << 10)])
def test_cuda_coder_odd_batch_matches_host(gpu, rng, knobs):
    """A batch that does not fill the last CUDA block, ragged and empty
    rows, non-default knobs."""
    inc, thr = knobs
    rows, lens = _blocks(rng, 41, 3000)
    comp, clens, deltas = ari_cuda.encode(rows, lens, increment=inc,
                                          threshold=thr)
    hcomp, hclens, hdeltas = native.ari_encode_indexed_batch(
        rows, lens, ari_index.num_chunks(3000), increment=inc,
        threshold=thr)
    assert np.array_equal(np.asarray(clens), hclens)
    assert np.array_equal(np.asarray(deltas), hdeltas)
    w = int(hclens.max())
    assert np.array_equal(np.asarray(comp)[:, :w], hcomp[:, :w])
    out = ari_cuda.decode(comp, clens, lens, n=3000, increment=inc,
                          threshold=thr)
    assert np.array_equal(np.asarray(out), rows)


def test_bin_decode_reference_round_trip(rng):
    """The bin/apm lane decoder (`bin_decode_reference`, the to_device
    path) inverts the host C++ encoder bit-exactly through the chunk-index
    window prepack."""
    from tpuzip.codecs import bin_apm as jbin

    nbytes, lanes = jbin.CHUNK // 8, 128
    data = np.zeros((lanes, nbytes), np.uint8)
    for l in range(lanes):
        p = [0.5, 0.05, 0.95][l % 3]
        bits = (rng.random(8 * nbytes) < p).astype(np.uint8)
        data[l] = np.packbits(bits)
    lens = np.full(lanes, nbytes, np.int32)
    lens[5] = 13  # ragged lane
    data[5, 13:] = 0
    for use_apm in (True,):  # apm exercises the full model incl. p0/gate
        comp, clens, deltas = native.bin_encode_indexed_batch(
            data, lens, use_apm=use_apm)
        w = jbin.bin_window_words(int(deltas.max()))
        dt = jnp.array(deltas.T.astype(np.int32))
        starts = 4 + jnp.cumsum(dt, axis=0) - dt
        wins = ari_index.build_windows(jnp.transpose(jnp.array(comp)),
                                       starts, w)
        cu = comp[:, :4].astype(np.uint32)
        code0 = jnp.array((cu[:, 0] << 24) | (cu[:, 1] << 16)
                          | (cu[:, 2] << 8) | cu[:, 3])
        out = np.asarray(jbin.bin_decode_reference(
            wins, code0, jnp.array(8 * lens), w=w, use_apm=use_apm))
        for l in (0, 1, 2, 5, 127):
            nb = 8 * int(lens[l])
            want = np.unpackbits(data[l])[:nb]
            assert out[:nb, l].tolist() == want.tolist(), (use_apm, l)
