"""DEFLATE — XLA formulation (RFC 1951; reference parity src/flate.rs).

Work split follows where the bytes/s live (SURVEY §7 "hard parts"):

Decode
  - host: bit-level *header* parse per deflate block (tiny, sequential,
    irregular) + canonical-Huffman 15-bit LUT build (numpy, vectorized);
  - device: the hot symbol loop — one `lax.while_loop` step per symbol,
    LUT gather on a pre-expanded bit array, chunked periodic-gather match
    copies (same trick as the LZ4 decoder: match regions are periodic in
    the distance, so every byte gathers from the pre-match region).

Encode (new work — upstream has no deflate encoder)
  - device stage 1: parallel LZ77 — 3-byte-window hash candidates via one
    stable sort, greedy sequence resolution, symbol histograms;
  - host stage 2: package-merge length-limited Huffman + dynamic header
    field list (a few hundred (value, nbits) pairs);
  - device stage 3: every input position emits its (up to 4) bit fields;
    one prefix-sum bit-pack produces the complete block bitstream,
    header included.  Output is accepted by stock zlib (tests).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from tpuzip.core.bitio import bit_reverse, pack_bits_lsb
from tpuzip.oracle import deflate as od

LUT_BITS = 15
CH = 32
MIN_MATCH = 3
MAX_MATCH = 258
WINDOW = 32768
HASH_LOG = 15
HDR_FIELDS = 512            # static slot count for dynamic-header bit fields

LEN_EXTRA = np.array([e for e, _ in od.LENGTH_TABLE], np.int32)
LEN_BASE = np.array([b for _, b in od.LENGTH_TABLE], np.int32)
DIST_EXTRA = np.array([e for e, _ in od.DIST_TABLE], np.int32)
DIST_BASE = np.array([b for _, b in od.DIST_TABLE], np.int32)


# ---------------------------------------------------------------------------
# Host: canonical-Huffman LUT build (decode side)
# ---------------------------------------------------------------------------

def build_lut(lengths: list[int]) -> np.ndarray:
    """code lengths -> (2^15,) i32 LUT: entry = (nbits << 10) | symbol.

    The stream is read LSB-first, so a code of length l owns every index
    whose low l bits equal the bit-reversed code."""
    lut = np.zeros(1 << LUT_BITS, np.int32)
    codes = od.canonical_codes(list(lengths))
    for sym, l in enumerate(lengths):
        if l == 0:
            continue
        code = codes[sym]
        rev = int(f"{code:0{l}b}"[::-1], 2)
        step = 1 << l
        lut[rev::step] = (l << 10) | sym
    return lut


# ---------------------------------------------------------------------------
# Device: symbol-loop decode kernel for one deflate block
# ---------------------------------------------------------------------------

def _peek(bits, bp, n, cap_bits):
    idx = bp + jnp.arange(n, dtype=jnp.int32)
    b = bits[jnp.clip(idx, 0, cap_bits - 1)].astype(jnp.int32)
    return (b << jnp.arange(n, dtype=jnp.int32)).sum()


def decode_block_kernel(bits: jnp.ndarray, start_bit: jnp.ndarray,
                        lut_lit: jnp.ndarray, lut_dist: jnp.ndarray,
                        out: jnp.ndarray, out_start: jnp.ndarray):
    """Decode one Huffman-coded deflate block's symbol section.

    bits: (CAPB,) u8 (bit-expanded stream); out: (OCAP,) u8 carried buffer.
    Returns (out, out_end, bit_end, err)."""
    cap_bits = bits.shape[0]
    ocap = out.shape[0]
    len_eb = jnp.array(LEN_EXTRA)
    len_base = jnp.array(LEN_BASE)
    dist_eb = jnp.array(DIST_EXTRA)
    dist_base = jnp.array(DIST_BASE)

    # vmap-critical like the LZ4 loop: no cond/switch ever carries `out`
    # (they lower to select under vmap, copying the batch buffer per
    # iteration) — all effects are masked writes and zero-trip chunk loops.
    def step(st):
        bp, op, out, done, err = st
        peek = _peek(bits, bp, LUT_BITS, cap_bits)
        e = lut_lit[peek]
        nb = e >> 10
        sym = e & 0x3FF
        bad = (nb == 0) | (bp + nb > cap_bits)
        bp = bp + nb
        is_lit = (~bad) & (sym < 256)
        is_eob = bad | (sym == 256)
        is_match = (~bad) & (sym > 256)

        # literal: masked single-byte write (dead write into the slack slot
        # ocap-1 when not a literal — valid streams never address it)
        lit_dst = jnp.where(is_lit, jnp.clip(op, 0, ocap - 1), ocap - 1)
        out = out.at[lit_dst].set(jnp.where(is_lit, sym, 0).astype(jnp.uint8))
        op = op + is_lit.astype(jnp.int32)

        # match: all field reads masked; zero-trip copy loop when inactive
        li = jnp.clip(sym - 257, 0, 28)
        eb = jnp.where(is_match, len_eb[li], 0)
        extra = _peek(bits, bp, 5, cap_bits) & ((1 << eb) - 1)
        bp = bp + eb
        mlen = jnp.where(is_match, len_base[li] + extra, 0)
        dpeek = _peek(bits, bp, LUT_BITS, cap_bits)
        de = lut_dist[dpeek]
        dnb = jnp.where(is_match, de >> 10, 0)
        dsym = jnp.clip(de & 0x3FF, 0, 29)
        bad_d = is_match & (de >> 10 == 0)
        bp = bp + dnb
        deb = jnp.where(is_match, dist_eb[dsym], 0)
        dextra = _peek(bits, bp, 13, cap_bits) & ((1 << deb) - 1)
        bp = bp + deb
        dist = dist_base[dsym] + dextra
        start = op - dist
        bad2 = bad_d | (is_match & ((start < 0) | (op + mlen > ocap - CH)))
        do = is_match & ~bad2
        mlen = jnp.where(do, mlen, 0)
        safe = jnp.maximum(dist, 1)
        nch = (mlen + CH - 1) // CH

        def mb(k, o):
            m = k * CH + jnp.arange(CH, dtype=jnp.int32)
            v = o[jnp.clip(start + m % safe, 0, ocap - 1)]
            return lax.dynamic_update_slice(
                o, v, (jnp.clip(op + k * CH, 0, ocap - CH),))

        out = lax.fori_loop(0, nch, mb, out, unroll=False)
        op = op + mlen
        berr = bad2.astype(jnp.int32)
        done = is_eob | (berr == 1)
        return bp, op, out, done, err | bad.astype(jnp.int32) | berr

    def cond(st):
        _, _, _, done, _ = st
        return ~done

    bp, op, out, _, err = lax.while_loop(
        cond, step,
        (jnp.asarray(start_bit, jnp.int32), jnp.asarray(out_start, jnp.int32),
         out, jnp.bool_(False), jnp.int32(0)))
    return out, op, bp, err


def inflate(data: bytes, out_n: int) -> bytes:
    """Host-orchestrated inflate: header parse + LUT build on host, symbol
    loops on device.  Validated against streams from zlib at all levels."""
    ocap = out_n + CH + MAX_MATCH
    out = jnp.zeros(ocap, jnp.uint8)
    bits_np = np.unpackbits(
        np.frombuffer(data, np.uint8), bitorder="little")
    bits = jnp.array(bits_np)
    cap_bits = bits_np.size
    br = od.BitReader(data)
    out_start = 0
    while True:
        final = br.bits(1)
        btype = br.bits(2)
        if btype == 0:
            br.align_byte()
            ln = data[br.pos] | (data[br.pos + 1] << 8)
            nln = data[br.pos + 2] | (data[br.pos + 3] << 8)
            if ln != (~nln & 0xFFFF):
                raise ValueError("stored block LEN/NLEN mismatch")
            br.pos += 4
            chunk = np.frombuffer(data[br.pos : br.pos + ln], np.uint8)
            out = out.at[out_start : out_start + ln].set(chunk)
            br.pos += ln
            out_start += ln
        elif btype in (1, 2):
            if btype == 1:
                lit_l = od.fixed_lit_lengths()
                dist_l = od.fixed_dist_lengths()
            else:
                lit_dec, dist_dec = od._read_dynamic_header(br)
                lit_l = _decoder_lengths(lit_dec, 288)
                dist_l = _decoder_lengths(dist_dec, 30)
            start_bit = br.pos * 8 - br.bitcnt
            out, op, bp, err = decode_block_kernel(
                bits, jnp.int32(start_bit), jnp.array(build_lut(lit_l)),
                jnp.array(build_lut(dist_l)), out, jnp.int32(out_start))
            if int(err):
                raise ValueError("corrupt DEFLATE symbol stream")
            out_start = int(op)
            # resync the host bit reader to the device's final position
            bp = int(bp)
            br.pos = (bp + 7) // 8
            br.bitcnt = br.pos * 8 - bp
            br.bitbuf = (data[br.pos - 1] >> (8 - br.bitcnt)) if br.bitcnt else 0
        else:
            raise ValueError("reserved DEFLATE block type 3")
        if final:
            break
    if out_start > out_n:
        raise ValueError("output larger than declared size")
    return np.asarray(out)[:out_start].tobytes()


def _decoder_lengths(dec: od.HuffmanDecoder, n: int) -> list[int]:
    lengths = [0] * n
    idx = 0
    for l in range(1, od.MAX_BITS + 1):
        for _ in range(dec.count[l]):
            lengths[dec.symbols[idx]] = l
            idx += 1
    return lengths


# ---------------------------------------------------------------------------
# Encode stage 1 (device): parallel LZ77 parse + histograms
# ---------------------------------------------------------------------------

def _candidates3(block: jnp.ndarray, length: jnp.ndarray):
    n = block.shape[0]
    d = block.astype(jnp.uint32)
    nxt = lambda k: jnp.concatenate([d[k:], jnp.zeros(k, jnp.uint32)])
    seq = d | (nxt(1) << 8) | (nxt(2) << 16)
    h = (((seq * jnp.uint32(2654435761)) >> (32 - HASH_LOG))).astype(jnp.int32)
    order = jnp.argsort(h, stable=True)
    h_s = h[order]
    prev_pos = jnp.concatenate(
        [jnp.array([-1], jnp.int32), order[:-1].astype(jnp.int32)])
    same = jnp.concatenate([jnp.array([False]), h_s[1:] == h_s[:-1]])
    cand = jnp.zeros(n, jnp.int32).at[order].set(
        jnp.where(same, prev_pos, -1))
    idx = jnp.arange(n, dtype=jnp.int32)
    ok = ((cand >= 0) & (idx - cand <= WINDOW)
          & (seq[jnp.clip(cand, 0, n - 1)] == seq)
          & (idx + MIN_MATCH <= length) & (cand < idx))
    return jnp.where(ok, cand, -1)


def lz77_stage(block: jnp.ndarray, length: jnp.ndarray):
    """Greedy parse -> per-position token info + histograms.

    Returns (is_head (N,) bool, is_lit (N,) bool, mlen (N,), dist (N,),
             lit_hist (286,), dist_hist (30,))."""
    n = block.shape[0]
    length = jnp.asarray(length, jnp.int32)
    cand = _candidates3(block, length)
    dpad = jnp.concatenate([block, jnp.zeros(64, jnp.uint8)])

    max_seqs = n // MIN_MATCH + 2
    z = jnp.zeros(max_seqs, jnp.int32)

    # literal skip-ahead (suffix-min of candidate positions) + masked-write
    # greedy loop: no lax.cond may carry the record arrays (vmap would turn
    # it into a full-array select per iteration).
    idxs = jnp.arange(n, dtype=jnp.int32)
    match_at = jnp.where(cand >= 0, idxs, n)
    nxt_match = lax.associative_scan(jnp.minimum, match_at, reverse=True)

    def body(st):
        i, s, heads, mls, dss = st
        c = cand[jnp.clip(i, 0, n - 1)]
        has = c >= 0
        ml = extend_masked(i, jnp.maximum(c, 0), has)
        heads = heads.at[s].set(i)          # dead write when ~has: slot is
        mls = mls.at[s].set(ml)             # reused by the next live match
        dss = dss.at[s].set(i - c)
        s = s + has.astype(jnp.int32)
        jump = nxt_match[jnp.clip(i + 1, 0, n - 1)]
        jump = jnp.where(i + 1 >= n, n, jump)
        i = jnp.where(has, i + ml, jnp.maximum(jump, i + 1))
        return (i, s, heads, mls, dss)

    def cond(st):
        i, s = st[0], st[1]
        return (i + MIN_MATCH <= length) & (s < max_seqs)

    def extend_masked(i, c, go):
        def cond_(st):
            m, open_ = st
            return open_ & (m < MAX_MATCH)

        def body_(st):
            m, _ = st
            a = lax.dynamic_slice(dpad, (jnp.clip(i + m, 0, n),), (64,))
            b = lax.dynamic_slice(dpad, (jnp.clip(c + m, 0, n),), (64,))
            pos = i + m + jnp.arange(64, dtype=jnp.int32)
            neq = (a != b) | (pos >= length) | (m + jnp.arange(64) >= MAX_MATCH)
            anybad = neq.any()
            first = jnp.argmax(neq).astype(jnp.int32)
            return m + jnp.where(anybad, first, 64), ~anybad

        m, _ = lax.while_loop(cond_, body_, (jnp.int32(MIN_MATCH), go))
        return jnp.clip(m, 0, jnp.maximum(
            jnp.minimum(MAX_MATCH, length - i), 0))

    i, s, heads, mls, dss = lax.while_loop(
        cond, body, (jnp.int32(0), jnp.int32(0), z, z, z))
    num = s

    # fill per-position arrays from the sequence records
    sid = jnp.arange(max_seqs, dtype=jnp.int32)
    svalid = sid < num
    scat = jnp.where(svalid, heads, n)
    head_at = jnp.full(n, -1, jnp.int32).at[scat].max(sid, mode="drop")
    is_head = head_at >= 0
    cover = lax.cummax(head_at)          # most recent head at/before pos
    cs = jnp.clip(cover, 0, max_seqs - 1)
    inside = (cover >= 0) & (jnp.arange(n) < heads[cs] + mls[cs])
    idx = jnp.arange(n, dtype=jnp.int32)
    valid = idx < length
    is_lit = valid & ~inside
    mlen = jnp.where(is_head, mls[cs], 0)
    dist = jnp.where(is_head, dss[cs], 0)

    # histograms
    lit_hist = jnp.zeros(286, jnp.int32).at[
        jnp.where(is_lit, block.astype(jnp.int32), 286)].add(1, mode="drop")
    lcode = _len_code(mlen)
    lit_hist = lit_hist.at[jnp.where(is_head, lcode, 286)].add(1, mode="drop")
    lit_hist = lit_hist.at[256].add(1)   # EOB
    dcode = _dist_code(dist)
    dist_hist = jnp.zeros(30, jnp.int32).at[
        jnp.where(is_head, dcode, 30)].add(1, mode="drop")
    return is_head, is_lit, mlen, dist, lit_hist, dist_hist


def _len_code(mlen: jnp.ndarray) -> jnp.ndarray:
    # base table is monotone and base[28]=258, so searchsorted alone is
    # correct: 258 -> index 28 -> code 285, 228..257 -> 27 -> code 284.
    base = jnp.array(LEN_BASE)
    i = jnp.sum((mlen[..., None] >= base).astype(jnp.int32), axis=-1) - 1
    return 257 + jnp.clip(i, 0, 28)


def _dist_code(dist: jnp.ndarray) -> jnp.ndarray:
    base = jnp.array(DIST_BASE)
    i = jnp.sum((dist[..., None] >= base).astype(jnp.int32), axis=-1) - 1
    return jnp.clip(i, 0, 29)


# ---------------------------------------------------------------------------
# Encode stage 3 (device): full-block bit pack
# ---------------------------------------------------------------------------

def pack_stage(block, is_head, is_lit, mlen, dist,
               lit_codes, lit_bits, dist_codes, dist_bits,
               hdr_vals, hdr_bits, cap_bits: int):
    """Emit the complete deflate block: header fields + 4 fields per input
    position + EOB, one parallel bit-pack.  Codes arrive pre-bit-reversed."""
    n = block.shape[0]
    len_eb = jnp.array(LEN_EXTRA)
    len_base = jnp.array(LEN_BASE)
    dist_eb = jnp.array(DIST_EXTRA)
    dist_base = jnp.array(DIST_BASE)

    sym = block.astype(jnp.int32)
    lcode = _len_code(mlen)
    li = jnp.clip(lcode - 257, 0, 28)
    dcode = _dist_code(dist)

    f0_v = jnp.where(is_lit, lit_codes[sym], lit_codes[jnp.clip(lcode, 0, 285)])
    f0_n = jnp.where(is_lit, lit_bits[sym],
                     jnp.where(is_head, lit_bits[jnp.clip(lcode, 0, 285)], 0))
    f1_v = jnp.where(is_head, mlen - len_base[li], 0)
    f1_n = jnp.where(is_head, len_eb[li], 0)
    f2_v = jnp.where(is_head, dist_codes[dcode], 0)
    f2_n = jnp.where(is_head, dist_bits[dcode], 0)
    f3_v = jnp.where(is_head, dist - dist_base[dcode], 0)
    f3_n = jnp.where(is_head, dist_eb[dcode], 0)

    vals = jnp.stack([f0_v, f1_v, f2_v, f3_v], axis=1).reshape(-1)
    nbts = jnp.stack([f0_n, f1_n, f2_n, f3_n], axis=1).reshape(-1)

    eob_v = lit_codes[256][None]
    eob_n = lit_bits[256][None]
    all_vals = jnp.concatenate([hdr_vals, vals, eob_v]).astype(jnp.uint32)
    all_bits = jnp.concatenate([hdr_bits, nbts, eob_n]).astype(jnp.int32)
    return pack_bits_lsb(all_vals, all_bits, cap_bits, LUT_BITS)


# ---------------------------------------------------------------------------
# Host stage 2 + orchestration
# ---------------------------------------------------------------------------

def _header_fields(lit_lengths: list[int], dist_lengths: list[int],
                   final: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Dynamic-header bit fields as (values, nbits) arrays (HDR_FIELDS slots).
    Huffman-coded fields are pre-bit-reversed for the LSB-first packer."""
    bw = _FieldCollector()
    bw.bits(1 if final else 0, 1)
    bw.bits(2, 2)
    hlit = len(lit_lengths)
    while hlit > 257 and lit_lengths[hlit - 1] == 0:
        hlit -= 1
    hdist = len(dist_lengths)
    while hdist > 1 and dist_lengths[hdist - 1] == 0:
        hdist -= 1
    seq = list(lit_lengths[:hlit]) + list(dist_lengths[:hdist])
    cl_tokens = od._rle_code_lengths(seq)
    cl_freq: dict[int, int] = {}
    for s, _, _ in cl_tokens:
        cl_freq[s] = cl_freq.get(s, 0) + 1
    cl_map = od.package_merge(cl_freq, od.MAX_CL_BITS)
    cl_lengths = [0] * 19
    if len(cl_map) == 1:
        ((s, _),) = cl_map.items()
        cl_lengths[s] = 1
    else:
        for s, l in cl_map.items():
            cl_lengths[s] = l
    cl_codes = od.canonical_codes(cl_lengths)
    hclen = 19
    while hclen > 4 and cl_lengths[od.CLCL_ORDER[hclen - 1]] == 0:
        hclen -= 1
    bw.bits(hlit - 257, 5)
    bw.bits(hdist - 1, 5)
    bw.bits(hclen - 4, 4)
    for i in range(hclen):
        bw.bits(cl_lengths[od.CLCL_ORDER[i]], 3)
    for s, eb, ev in cl_tokens:
        bw.huff(cl_codes[s], cl_lengths[s])
        if eb:
            bw.bits(ev, eb)
    return bw.arrays(HDR_FIELDS)


class _FieldCollector:
    def __init__(self) -> None:
        self.vals: list[int] = []
        self.nb: list[int] = []

    def bits(self, v: int, n: int) -> None:
        self.vals.append(v)
        self.nb.append(n)

    def huff(self, code: int, n: int) -> None:
        rev = int(f"{code:0{n}b}"[::-1], 2) if n else 0
        self.bits(rev, n)

    def arrays(self, slots: int) -> tuple[np.ndarray, np.ndarray]:
        assert len(self.vals) <= slots, "header overflow"
        v = np.zeros(slots, np.uint32)
        b = np.zeros(slots, np.int32)
        v[: len(self.vals)] = self.vals
        b[: len(self.nb)] = self.nb
        return v, b


_lz77_stage_jit = jax.jit(lz77_stage)
_pack_stage_jit = jax.jit(pack_stage, static_argnames=("cap_bits",))


def deflate(data: bytes, n_static: int | None = None) -> bytes:
    """Compress to a single dynamic-Huffman deflate block (device hot paths,
    host table build).  Output accepted by stock zlib (wbits=-15)."""
    n = n_static or max(len(data), 32)
    arr = np.zeros(n, np.uint8)
    arr[: len(data)] = np.frombuffer(data, np.uint8)
    block = jnp.array(arr)
    length = jnp.int32(len(data))
    is_head, is_lit, mlen, dist, lit_hist, dist_hist = _lz77_stage_jit(
        block, length)

    lit_freq = {i: int(f) for i, f in enumerate(np.asarray(lit_hist)) if f}
    dist_freq = {i: int(f) for i, f in enumerate(np.asarray(dist_hist)) if f}
    lit_map = od.package_merge(lit_freq, od.MAX_BITS)
    lit_lengths = [0] * 286
    for s, l in lit_map.items():
        lit_lengths[s] = l
    if len(lit_map) == 1:
        # zlib requires a COMPLETE lit/len code set: pad with a dummy symbol
        only = next(iter(lit_map))
        lit_lengths[only] = 1
        lit_lengths[0 if only != 0 else 1] = 1
    dist_lengths = [0] * 30
    if not dist_freq:
        dist_lengths[0] = 1
    elif len(dist_freq) == 1:
        dist_lengths[next(iter(dist_freq))] = 1
    else:
        for s, l in od.package_merge(dist_freq, od.MAX_BITS).items():
            dist_lengths[s] = l

    lit_codes_np = np.array(od.canonical_codes(lit_lengths), np.uint32)
    dist_codes_np = np.array(od.canonical_codes(dist_lengths), np.uint32)
    lit_b = jnp.array(lit_lengths, jnp.int32)
    dist_b = jnp.array(dist_lengths, jnp.int32)
    lit_c = bit_reverse(jnp.array(lit_codes_np), lit_b, od.MAX_BITS)
    dist_c = bit_reverse(jnp.array(dist_codes_np), dist_b, od.MAX_BITS)

    hdr_v, hdr_b = _header_fields(lit_lengths, dist_lengths)
    cap_bits = ((16 * n + 16384) // 8) * 8
    out_bytes, total_bits = _pack_stage_jit(
        block, is_head, is_lit, mlen, dist, lit_c, lit_b, dist_c, dist_b,
        jnp.array(hdr_v), jnp.array(hdr_b), cap_bits)
    nbytes = (int(total_bits) + 7) // 8
    return np.asarray(out_bytes)[:nbytes].tobytes()


# ---------------------------------------------------------------------------
# Batched deflate: vmapped device stages around the host table loop
# ---------------------------------------------------------------------------

_lz77_stage_vmap = jax.jit(jax.vmap(lz77_stage))


@functools.lru_cache(maxsize=None)
def _get_pack_vmap(cap_bits: int):
    return jax.jit(jax.vmap(functools.partial(pack_stage, cap_bits=cap_bits)))


def deflate_batch(blocks, lengths):
    """(B, N) u8 + (B,) i32 -> (comp (B, CAP) u8, comp_lens (B,) i32).

    Stage 1 (device, vmapped): parallel LZ77 parse + histograms for every
    block at once.  Stage 2 (host, per block): package-merge Huffman + header
    fields — a few hundred ints each.  Stage 3 (device, vmapped): full-block
    parallel bit-pack.  Each row is an independent, stock-zlib-decodable
    deflate stream."""
    b, n = blocks.shape
    is_head, is_lit, mlen, dist, lit_hist, dist_hist = _lz77_stage_vmap(
        blocks, lengths)
    lit_hist_np = np.asarray(lit_hist)
    dist_hist_np = np.asarray(dist_hist)

    lit_bits_np = np.zeros((b, 286), np.int32)
    dist_bits_np = np.zeros((b, 30), np.int32)
    lit_codes_np = np.zeros((b, 286), np.uint32)
    dist_codes_np = np.zeros((b, 30), np.uint32)
    hdr_v = np.zeros((b, HDR_FIELDS), np.uint32)
    hdr_b = np.zeros((b, HDR_FIELDS), np.int32)
    for i in range(b):
        lit_freq = {s: int(f) for s, f in enumerate(lit_hist_np[i]) if f}
        dist_freq = {s: int(f) for s, f in enumerate(dist_hist_np[i]) if f}
        lit_lengths = [0] * 286
        lm = od.package_merge(lit_freq, od.MAX_BITS)
        for s, l in lm.items():
            lit_lengths[s] = l
        if len(lm) == 1:
            only = next(iter(lm))
            lit_lengths[only] = 1
            lit_lengths[0 if only != 0 else 1] = 1
        dist_lengths = [0] * 30
        if not dist_freq:
            dist_lengths[0] = 1
        elif len(dist_freq) == 1:
            dist_lengths[next(iter(dist_freq))] = 1
        else:
            for s, l in od.package_merge(dist_freq, od.MAX_BITS).items():
                dist_lengths[s] = l
        lit_bits_np[i] = lit_lengths
        dist_bits_np[i] = dist_lengths
        lit_codes_np[i] = od.canonical_codes(lit_lengths)
        dist_codes_np[i] = od.canonical_codes(dist_lengths)
        hdr_v[i], hdr_b[i] = _header_fields(lit_lengths, dist_lengths)

    lit_b_j = jnp.array(lit_bits_np)
    dist_b_j = jnp.array(dist_bits_np)
    lit_c_j = bit_reverse(jnp.array(lit_codes_np), lit_b_j, od.MAX_BITS)
    dist_c_j = bit_reverse(jnp.array(dist_codes_np), dist_b_j, od.MAX_BITS)
    cap_bits = ((16 * n + 16384) // 8) * 8
    out_bytes, total_bits = _get_pack_vmap(cap_bits)(
        blocks, is_head, is_lit, mlen, dist, lit_c_j, lit_b_j, dist_c_j,
        dist_b_j, jnp.array(hdr_v), jnp.array(hdr_b))
    comp_lens = (total_bits + 7) // 8
    return out_bytes, comp_lens.astype(jnp.int32)


_decode_kernel_vmap = jax.jit(jax.vmap(decode_block_kernel))


def inflate_batch(comp_rows, comp_lens, out_n: int):
    """Inverse of deflate_batch.

    Fast path: every stream is a single dynamic/fixed deflate block (what
    deflate_batch emits) — headers+LUTs parse on host per block, then ONE
    vmapped device symbol loop decodes all blocks in lock-step (the kernel
    is vmap-safe: no cond/switch carries the output buffer).  Streams with
    stored blocks or multiple deflate blocks fall back to per-block
    inflate().
    """
    b = comp_rows.shape[0]
    rows = np.asarray(comp_rows)
    cl = np.asarray(comp_lens)

    ocap = out_n + CH + MAX_MATCH
    cap_bits = rows.shape[1] * 8
    luts_lit = np.zeros((b, 1 << LUT_BITS), np.int32)
    luts_dist = np.zeros((b, 1 << LUT_BITS), np.int32)
    start_bits = np.zeros(b, np.int32)
    simple = True
    for i in range(b):
        data = rows[i, : int(cl[i])].tobytes()
        if not data:
            simple = False
            break
        br = od.BitReader(data)
        final = br.bits(1)
        btype = br.bits(2)
        if not final or btype not in (1, 2):
            simple = False
            break
        if btype == 1:
            lit_l = od.fixed_lit_lengths()
            dist_l = od.fixed_dist_lengths()
        else:
            try:
                lit_dec, dist_dec = od._read_dynamic_header(br)
            except ValueError:
                simple = False
                break
            lit_l = _decoder_lengths(lit_dec, 288)
            dist_l = _decoder_lengths(dist_dec, 30)
        luts_lit[i] = build_lut(lit_l)
        luts_dist[i] = build_lut(dist_l)
        start_bits[i] = br.pos * 8 - br.bitcnt

    if simple:
        # expand bits ON DEVICE from the (possibly already device-resident)
        # comp rows — an 8x-larger host bit array would otherwise cross the
        # host->device link and dominate decode time
        jrows = jnp.asarray(comp_rows)
        bits = jnp.reshape(
            (jrows[:, :, None] >> jnp.arange(8, dtype=jnp.uint8)[None, None])
            & 1, (b, -1))
        out0 = jnp.zeros((b, ocap), jnp.uint8)
        out, op, bp, err = _decode_kernel_vmap(
            bits, jnp.array(start_bits), jnp.array(luts_lit),
            jnp.array(luts_dist), out0, jnp.zeros(b, jnp.int32))
        if int(np.asarray(err).sum()):
            raise ValueError("corrupt DEFLATE symbol stream in batch")
        return np.asarray(out)[:, :out_n], np.asarray(op).astype(np.int32)

    outs = np.zeros((b, out_n), np.uint8)
    lens = np.zeros(b, np.int32)
    for i in range(b):
        data = rows[i, : int(cl[i])].tobytes()
        out = inflate(data, out_n)
        outs[i, : len(out)] = np.frombuffer(out, np.uint8)
        lens[i] = len(out)
    return outs, lens


def inflate_batch_planned(comp_rows, comp_lens, out_n: int):
    """Host-parse/device-copy-plan inflate (mirrors lz4.decode_batch_
    planned): the C++ parser does the bit-serial Huffman walk and emits a
    literal array + per-byte source indices; the device executes the whole
    batch as one bulk gather.  Returns (out (B, out_n) u8, olens)."""
    from tpuzip.runtime import native

    rows = np.asarray(comp_rows)
    cl = np.asarray(comp_lens)
    b = rows.shape[0]
    # threaded C++ batch Huffman parse (csrc tpz_inflate_plan_batch):
    # 612 MB/s at 4 threads vs ~170 single-thread
    plans, lits, ol64, _nl = native.inflate_plan_batch(
        rows, cl.astype(np.int32), out_n)
    olens = ol64.astype(np.int32)
    jl = jnp.asarray(olens)
    out = jnp.take_along_axis(jnp.asarray(lits), jnp.asarray(plans), axis=1)
    mask = jnp.arange(out_n, dtype=jnp.int32)[None, :] < jl[:, None]
    return np.asarray(jnp.where(mask, out, 0).astype(jnp.uint8)), olens
