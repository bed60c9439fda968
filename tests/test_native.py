import zlib

import numpy as np
import pytest

from tpuzip.oracle import ari as oari, lz4 as olz4, rle as orle
from tpuzip.oracle.xxh32 import xxh32 as oxxh32
from tpuzip.runtime import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native runtime not built")


def test_native_checksums(samples):
    for s in samples:
        assert native.adler32(s) == zlib.adler32(s)
        assert native.xxh32(s) == oxxh32(s)


def test_native_lz4_bit_exact(samples):
    for s in samples:
        comp = native.lz4_compress(s)
        assert comp == olz4.compress_block(s)  # identical greedy policy
        assert native.lz4_decompress(comp, len(s) + 64) == s


def test_native_rle_bit_exact(samples):
    for s in samples:
        comp = native.rle_encode(s)
        assert comp == orle.encode(s)
        assert native.rle_decode(comp, len(s) + 64) == s


def test_native_ari_bit_exact(samples):
    for s in samples:
        if len(s) > 20000:
            continue
        comp = native.ari_encode(s)
        assert comp == oari.encode_bytes(s)
        assert native.ari_decode(comp, len(s)) == s


@pytest.mark.parametrize("knobs", [(16, 1 << 10), (8, 512), (24, 4096),
                                   (1, 300)])
def test_native_ari_step_vs_oracle_across_halving(rng, knobs):
    """The coder loop the GPU kernel shares (csrc/ari_model.h) against the
    oracle at non-default knobs, crossing many model halvings: streams,
    chunk indexes and the decode round trip."""
    inc, thr = knobs
    n = 2048
    rows = np.zeros((3, n), np.uint8)
    rows[0] = rng.integers(0, 256, n)
    rows[1] = rng.integers(0, 5, n)
    rows[2, :777] = rng.integers(0, 256, 777)
    lens = np.array([n, n, 777], np.int32)
    comp, clens, deltas = native.ari_encode_indexed_batch(
        rows, lens, n // 64, increment=inc, threshold=thr)
    for i in range(3):
        data = rows[i, : lens[i]].tobytes()
        model = oari.TableModel(256, inc, thr)
        enc = oari.RangeEncoder()
        want_d = np.zeros(n // 64, np.int64)
        for t, b in enumerate(data):
            lo, hi = model.get_range(b)
            before = len(enc.out)
            enc.encode(lo, hi, model.get_denominator())
            want_d[t // 64] += len(enc.out) - before
            model.update(b)
        assert comp[i, : clens[i]].tobytes() == enc.finish(), i
        assert np.array_equal(deltas[i], want_d), i
    out = native.ari_decode_batch_native(comp, clens, lens, n,
                                         increment=inc, threshold=thr)
    assert np.array_equal(out, rows)


def test_native_payload_pack_roundtrip(rng):
    B, CAP = 16, 100
    comp = rng.integers(0, 256, (B, CAP), dtype=np.uint8)
    lens = rng.integers(0, CAP + 1, B).astype(np.int32)
    stream = native.pack_payloads(comp, lens)
    expect = b"".join(comp[i, : lens[i]].tobytes() for i in range(B))
    assert stream == expect
    back = native.unpack_payloads(stream, lens, CAP)
    for i in range(B):
        assert back[i, : lens[i]].tobytes() == comp[i, : lens[i]].tobytes()


def test_native_lz4_batch_threaded(rng):
    """Threaded batch host stages agree with the scalar entry points and
    system liblz4 (blocks are independent; csrc fans out across cores)."""
    from tpuzip.oracle import liblz4

    B, n = 16, 4096
    rows = np.zeros((B, n), np.uint8)
    lens = np.zeros(B, np.int32)
    for i in range(B):
        s = (b"threaded batch block %d " % i) * (40 + i) + bytes(
            rng.integers(0, 256, 64, dtype=np.uint8))
        lens[i] = min(len(s), n)
        rows[i, : lens[i]] = np.frombuffer(s[:n], np.uint8)
    comp, clens = native.lz4_compress_batch(rows, lens)
    for i in range(B):
        blob = comp[i, : clens[i]].tobytes()
        assert blob == native.lz4_compress(rows[i, : lens[i]].tobytes())
        if liblz4.available():
            assert liblz4.decompress_block(blob, int(lens[i])) == \
                rows[i, : lens[i]].tobytes()
    # threaded wplan parse == scalar wplan parse, per block
    out_cap = int(lens.max())
    cpad = comp[:, : (int(clens.max()) + 3) & ~3]
    wplans, patches, st, used = native.lz4_decode_wplan_batch(
        cpad, clens.astype(np.int32), out_cap)
    for i in (0, B // 2, B - 1):
        wp, pt, n1 = native.lz4_decode_wplan(
            cpad[i, : clens[i]].tobytes(), out_cap)
        assert st[i] == n1 == lens[i]
        assert (wplans[i, : len(wp)] == wp).all()
        assert (patches[i, : len(pt)] == pt).all()
    # corrupt one stream: per-block status isolates it (strict=False)
    bad = cpad.copy()
    bad[3, : clens[3]] = 0xFF
    _, _, st2, _ = native.lz4_decode_wplan_batch(
        bad, clens.astype(np.int32), out_cap, strict=False)
    assert st2[3] < 0 and st2[0] == lens[0]


def test_native_deflate_inflate_batch_threaded(rng):
    import zlib

    B, n = 8, 4096
    rows = np.zeros((B, n), np.uint8)
    lens = np.full(B, n, np.int32)
    lens[B - 1] = 0  # empty row must decode to an empty block
    text = (b"the quick brown deflate batch corpus " * 1000)[: n * B]
    rows[: B - 1] = np.frombuffer(text[: n * (B - 1)],
                                  np.uint8).reshape(B - 1, n)
    comp, clens = native.deflate_batch_native(rows[: B - 1], lens[: B - 1])
    for i in range(B - 1):
        blob = comp[i, : clens[i]].tobytes()
        assert zlib.decompress(blob, -15) == rows[i].tobytes()
    # threaded inflate + inflate-plan round the batch back, incl. a
    # zero-length row
    cfull = np.zeros((B, comp.shape[1]), np.uint8)
    cfull[: B - 1] = comp
    cl = np.zeros(B, np.int32)
    cl[: B - 1] = clens
    dec, dlens = native.inflate_batch_native(cfull, cl, n)
    assert (dlens[: B - 1] == n).all() and dlens[B - 1] == 0
    assert (dec[: B - 1] == rows[: B - 1]).all()
    plans, lits, olens, nlits = native.inflate_plan_batch(cfull, cl, n)
    assert (olens[: B - 1] == n).all() and olens[B - 1] == 0
    i = 2
    got = lits[i][plans[i, : olens[i]]]
    assert got.tobytes() == rows[i].tobytes()


def test_native_bwt_inverse_batch(rng):
    """Threaded C++ inverse BWT == oracle decode_block, ragged batch."""
    from tpuzip.oracle import bwt as obwt

    B, cap = 7, 4096
    rows = np.zeros((B, cap), np.uint8)
    lens = np.zeros(B, np.int32)
    orgs = np.zeros(B, np.int32)
    raws = []
    for i in range(B):
        raw = (b"banana bwt %d " % i) * (20 + 5 * i) + bytes(
            rng.integers(0, 256, 40, dtype=np.uint8))
        raw = raw[: cap - 31 * i]
        L, org = obwt.encode_block(raw)
        raws.append(raw)
        lens[i] = len(L)
        orgs[i] = org
        rows[i, : len(L)] = np.frombuffer(L, np.uint8)
    out = native.bwt_inverse_batch(rows, lens, orgs)
    for i in range(B):
        assert out[i, : lens[i]].tobytes() == raws[i]


def test_native_bwt_forward_batch(rng):
    """Threaded C++ rotation sort (mkq + SA-IS fallback) == oracle,
    including periodic ties and bail-path (long-run) blocks."""
    from tpuzip.oracle import bwt as obwt

    cases = [b"", b"a", b"aaaa", b"abab", b"banana", b"mississippi",
             bytes(rng.integers(0, 256, 3000, dtype=np.uint8)),
             (b"the quick brown fox " * 200)[:3000],
             b"aabaab" * 500, bytes([7]) * 2048,
             b"ba" + bytes([0]) * 2000 + b"ab"]
    cap = max(len(c) for c in cases)
    rows = np.zeros((len(cases), cap), np.uint8)
    lens = np.zeros(len(cases), np.int32)
    for i, raw in enumerate(cases):
        lens[i] = len(raw)
        rows[i, : len(raw)] = np.frombuffer(raw, np.uint8)
    L, orgs = native.bwt_forward_batch(rows, lens)
    for i, raw in enumerate(cases):
        expL, expo = obwt.encode_block(raw)
        assert L[i, : lens[i]].tobytes() == expL, i
        assert int(orgs[i]) == expo, i


def test_native_rle_batch_threaded(rng):
    """Threaded batch RLE == oracle per block; corrupt row isolates."""
    B, n = 10, 2048
    rows = np.zeros((B, n), np.uint8)
    lens = np.zeros(B, np.int32)
    for i in range(B):
        s = (bytes([i]) * (i * 97) + b"mix " * 60
             + bytes(rng.integers(0, 4, 300, dtype=np.uint8)))[:n]
        lens[i] = len(s)
        rows[i, : len(s)] = np.frombuffer(s, np.uint8)
    comp, clens = native.rle_encode_batch(rows, lens)
    for i in range(B):
        blob = comp[i, : clens[i]].tobytes()
        assert blob == orle.encode(rows[i, : lens[i]].tobytes())
    dec, dlens = native.rle_decode_batch(comp, clens.astype(np.int32), n)
    assert (dlens == lens).all()
    assert all(dec[i, : lens[i]].tobytes() == rows[i, : lens[i]].tobytes()
               for i in range(B))
    # truncated row -> negative status for that row only
    bad = clens.astype(np.int32).copy()
    bad[4] = max(int(bad[4]) - 1, 1)
    _, st = native.rle_decode_batch(comp, bad, n)
    assert st[0] == lens[0]


def test_native_lz4_chained_encoder(rng):
    """Chained-match LZ4 (max_chain>1): same block format (liblz4-
    decodable, our decoder round-trips), output never larger than the
    single-probe reference policy, and strictly smaller on hash-colliding
    repetitive data."""
    from tpuzip.oracle import liblz4

    # repetitive text with interleaved patterns -> chain search wins
    s = (b"abcdefgh01234567" * 40 + b"abcdefgh99999999" * 40) * 8 \
        + bytes(rng.integers(0, 256, 500, dtype=np.uint8))
    n = len(s)
    rows = np.frombuffer(s, np.uint8).reshape(1, n)
    lens = np.array([n], np.int32)
    c1, l1 = native.lz4_compress_batch(rows, lens, max_chain=1)
    c64, l64 = native.lz4_compress_batch(rows, lens, max_chain=64)
    assert l64[0] <= l1[0]
    blob = c64[0, : l64[0]].tobytes()
    if liblz4.available():
        assert liblz4.decompress_block(blob, n) == s
    assert native.lz4_decompress(blob, n + 64) == s
    # max_chain=1 stays bit-identical to the reference greedy policy
    assert c1[0, : l1[0]].tobytes() == olz4.compress_block(s)


def test_native_mtf_dc_batch_oracle_parity(rng):
    """Threaded C++ MTF/DC (adapter host stages) == oracle, both ways,
    ragged batch; corrupt DC isolates with a negative status."""
    from tpuzip.oracle import dc as odc, mtf as omtf
    from tpuzip.runtime import native

    if not native.available():
        pytest.skip("native runtime not built")
    chunks = [
        b"abracadabra banana mississippi " * 40,
        bytes(rng.integers(0, 4, 3000, dtype=np.uint8)),
        b"\x00" * 500 + b"\x01" * 300,
        b"x",
    ]
    cap = max(len(c) for c in chunks)
    rows = np.zeros((len(chunks), cap), np.uint8)
    lens = np.zeros(len(chunks), np.int32)
    for i, c in enumerate(chunks):
        rows[i, : len(c)] = np.frombuffer(c, np.uint8)
        lens[i] = len(c)
    enc = native.mtf_batch(rows, lens)
    for i, c in enumerate(chunks):
        assert enc[i, : len(c)].tobytes() == omtf.encode(c), i
    dec = native.mtf_batch(enc, lens, decode=True)
    for i, c in enumerate(chunks):
        assert dec[i, : len(c)].tobytes() == c, i

    comp, cl = native.dc_encode_batch(rows, lens)
    for i, c in enumerate(chunks):
        assert comp[i, : cl[i]].tobytes() == odc.encode(c), i
    out, got = native.dc_decode_batch(comp, cl.astype(np.int32), cap)
    for i, c in enumerate(chunks):
        assert got[i] == len(c) and out[i, : len(c)].tobytes() == c, i
    bad = comp.copy()
    bad[1, 5] ^= 0xFF  # corrupt block 1's first-occurrence table
    _, got_bad = native.dc_decode_batch(bad, cl.astype(np.int32), cap)
    assert got_bad[1] < 0 and got_bad[0] == len(chunks[0])


def test_native_lz4_run_based_wplan_stress(rng):
    """Round-4 run-based wplan parse: adversarial corpora exercising the
    new paths — offsets 2..7 (pattern stamping), long matches >= 24
    (run-contiguity binary search), overlapping matches, incompressible
    tails, ragged lengths.  Every plan granularity must reconstruct the
    input bit-exactly through the oracle plan executor, and the full
    decoder must agree with the oracle."""
    from tpuzip.oracle import lz4 as olz4

    corpora = [
        b"ab" * 3000 + b"xyz",                       # off=2 runs
        b"abcde" * 1200,                             # off=5 runs
        b"A" * 5000,                                 # off=1 / RLE
        (b"longmatchseed-0123456789" * 6 + b"|") * 40,  # matches >= 24
        bytes(rng.integers(0, 256, 4096, dtype=np.uint8)),  # incompressible
        (b"the quick brown fox " * 50
         + bytes(rng.integers(0, 256, 333, dtype=np.uint8))) * 4,
        b"",                                         # empty block
        b"tiny",
        b"abcdefg" * 999 + b"Z" * 7,                 # ragged, off=7
    ]
    out_cap = max(len(c) for c in corpora)
    for data in corpora:
        comp = native.lz4_compress(data)
        # full decoder (shortcut fast path) vs oracle
        assert native.lz4_decompress(comp, len(data)) == data
        assert olz4.decompress_block(comp, len(data)) == data
        # every plan width reconstructs via positive (comp-addressed) and
        # negative (patch) entries
        for width, fn in ((4, native.lz4_decode_wplan),
                          (8, native.lz4_decode_wplan8),
                          (16, native.lz4_decode_wplan16)):
            wp, pt, nd = fn(comp, out_cap)
            assert nd == len(data)
            out = bytearray()
            for w_i, a in enumerate(wp):
                if a >= 0:
                    out += comp[a:a + width]
                else:
                    p = -int(a) - 1
                    out += pt[p:p + width].tobytes()
            assert bytes(out[: len(data)]) == data
            # ragged tail bytes inside the final patch entry are zeroed
            if len(data) % width and len(wp):
                assert all(b == 0 for b in out[len(data):])
