"""LZ4 block codec — XLA formulation.

Format: the public LZ4 block spec, bit-compatible with tpuzip.oracle.lz4 and
system liblz4 (reference parity: rust-compress src/lz4.rs).

Decode — the reference's byte-serial token loop is restructured so the only
sequential axis is the *sequence* loop (`lax.while_loop`); inside a sequence
every copy is a vectorized chunk op:
  - literals: 32-byte chunked dynamic-slice copies (over-copy is safe — the
    next sequence's writes land exactly at the tail and overwrite it);
  - matches: the match region is periodic with period `offset`, so byte m is
    `out[start + (m % offset)]` — a gather from the PRE-match region for all
    m at once.  No byte-to-byte dependency even for overlapping matches.

Encode — the reference's greedy single-probe hash table becomes:
  1. parallel hash of every 4-byte window + nearest-earlier-same-hash
     candidate via one stable sort (denser than the reference's table, so
     matches found are a superset — compressed size tracks or beats it);
  2. a sequence-level greedy resolution loop (64-byte chunked match
     extension);
  3. fully parallel serialization: per-sequence sizes -> prefix-sum offsets
     -> every output byte classifies itself (token / ext / literal / offset)
     and computes its value independently.

Batched variants vmap over blocks — the DP axis sharded by tpuzip.dist.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

HASH_LOG = 15
HASH_MUL = jnp.uint32(2654435761)
MIN_MATCH = 4
MF_LIMIT = 12
LAST_LITERALS = 5
CH = 32        # decode copy chunk
ECH = 64       # encode match-extension compare chunk
SLACK = 64     # buffer padding so chunked ops never clamp


def encode_cap(n: int) -> int:
    return n + n // 255 + 16 + SLACK


def decode_cap(n: int) -> int:
    return n + SLACK


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode(comp: jnp.ndarray, comp_len: jnp.ndarray, out_n: int
           ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """comp: (CAP,) u8 zero-padded (CAP >= comp_len + SLACK).
    Returns (out (out_n + SLACK,) u8, out_len i32, err i32).

    vmap-critical: NO lax.cond ever carries the output buffer (under vmap a
    cond lowers to select, copying the whole batch buffer per iteration).
    All conditionality is scalar state + zero-trip chunk loops.
    """
    cap = comp.shape[0]
    ocap = out_n + SLACK
    comp_len = jnp.asarray(comp_len, jnp.int32)
    comp32 = comp.astype(jnp.int32)

    def read_ext_if(take, in_pos, base, nib_val):
        """0xFF-chained extension bytes; zero iterations when ``take`` is
        false (scalar-only loop state — cheap select under vmap)."""
        def cond(st):
            _, _, go = st
            return go

        def body(st):
            pos, acc, _ = st
            b = comp32[jnp.clip(pos, 0, cap - 1)]
            return (pos + 1, acc + b, b == 255)

        pos, acc, _ = lax.while_loop(cond, body, (in_pos, base, take))
        return pos, jnp.where(take, acc, nib_val)

    def seq_step(st):
        in_pos, out_pos, out, err = st
        token = comp32[jnp.clip(in_pos, 0, cap - 1)]
        in_pos = in_pos + 1
        nib = token >> 4
        in_pos, lit_len = read_ext_if(nib == 15, in_pos, jnp.int32(15), nib)

        # literal copy, 32B chunks (over-copy overwritten by later writes)
        nchunks = (lit_len + CH - 1) // CH

        def lit_body(k, o):
            src = lax.dynamic_slice(
                comp, (jnp.clip(in_pos + k * CH, 0, cap - CH),), (CH,))
            return lax.dynamic_update_slice(
                o, src, (jnp.clip(out_pos + k * CH, 0, ocap - CH),))

        out = lax.fori_loop(0, nchunks, lit_body, out, unroll=False)
        in_pos = in_pos + lit_len
        out_pos = out_pos + lit_len

        # match section (masked out entirely on the final literal-only seq)
        active = in_pos < comp_len
        offset = jnp.where(
            active,
            comp32[jnp.clip(in_pos, 0, cap - 1)]
            | (comp32[jnp.clip(in_pos + 1, 0, cap - 1)] << 8), 1)
        in_pos = in_pos + jnp.where(active, 2, 0)
        mnib = token & 0xF
        in_pos, mlen = read_ext_if(active & (mnib == 15), in_pos,
                                   jnp.int32(MIN_MATCH + 15),
                                   mnib + MIN_MATCH)
        start = out_pos - offset
        bad = active & ((offset == 0) | (start < 0))
        do = active & ~bad
        mlen = jnp.where(do, mlen, 0)
        safe_off = jnp.maximum(offset, 1)
        # match bytes m gather from out[start + (m % offset)] — always in
        # the pre-match region, so all chunks are independent.
        mchunks = (mlen + CH - 1) // CH    # 0 when masked -> loop skipped

        def m_body(k, o):
            m = k * CH + jnp.arange(CH, dtype=jnp.int32)
            idx = start + m % safe_off
            vals = o[jnp.clip(idx, 0, ocap - 1)]
            return lax.dynamic_update_slice(
                o, vals, (jnp.clip(out_pos + k * CH, 0, ocap - CH),))

        out = lax.fori_loop(0, mchunks, m_body, out, unroll=False)
        out_pos = out_pos + mlen
        err = err | bad.astype(jnp.int32) | (out_pos > out_n).astype(jnp.int32)
        return in_pos, out_pos, out, err

    def cond(st):
        in_pos, _, _, err = st
        return (in_pos < comp_len) & (err == 0)

    out0 = jnp.zeros(ocap, dtype=jnp.uint8)
    _, out_len, out, err = lax.while_loop(
        cond, seq_step, (jnp.int32(0), jnp.int32(0), out0, jnp.int32(0)))
    return out, out_len, err


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def _candidates(block: jnp.ndarray, length: jnp.ndarray,
                hash_log: int = HASH_LOG):
    """For every position: nearest earlier position with the same 4-byte
    window (exact), or -1.  One stable sort, no sequential table."""
    n = block.shape[0]
    d = block.astype(jnp.uint32)
    nxt = lambda k: jnp.concatenate([d[k:], jnp.zeros(k, jnp.uint32)])
    seq = d | (nxt(1) << 8) | (nxt(2) << 16) | (nxt(3) << 24)
    h = ((seq * HASH_MUL) >> (32 - hash_log)).astype(jnp.int32)
    order = jnp.argsort(h, stable=True)          # pos ascending within hash
    h_sorted = h[order]
    prev_pos = jnp.concatenate([jnp.array([-1], jnp.int32), order[:-1].astype(jnp.int32)])
    same = jnp.concatenate([jnp.array([False]), h_sorted[1:] == h_sorted[:-1]])
    cand_sorted = jnp.where(same, prev_pos, -1)
    cand = jnp.zeros(n, jnp.int32).at[order].set(cand_sorted)
    idx = jnp.arange(n, dtype=jnp.int32)
    ok = (
        (cand >= 0)
        & (idx - cand <= 0xFFFF)
        & (seq[jnp.clip(cand, 0, n - 1)] == seq)   # exact 4-byte verify
        & (idx < length - MF_LIMIT)
        & (cand < idx)
    )
    return jnp.where(ok, cand, -1)


def encode(block: jnp.ndarray, length: jnp.ndarray,
           cap: int | None = None,
           hash_log: int = HASH_LOG) -> tuple[jnp.ndarray, jnp.ndarray]:
    """block: (N,) u8 zero-padded; returns (out (cap,) u8, out_len i32).

    hash_log sizes the candidate hash (collisions hide matches; the sort
    formulation still verifies 4 bytes exactly, so any value round-trips)."""
    n = block.shape[0]
    cap = cap or encode_cap(n)
    length = jnp.asarray(length, jnp.int32)
    cand = _candidates(block, length, hash_log)
    max_seqs = n // 4 + 2
    limit = length - LAST_LITERALS  # matches may not extend past here

    # literal skip-ahead: next position at/after i with a match candidate
    # (suffix-min), so the greedy loop never steps byte-by-byte through
    # literal runs — iterations ~ #sequences, not #positions.
    idxs = jnp.arange(n, dtype=jnp.int32)
    match_pos = jnp.where(cand >= 0, idxs, n)
    nxt_match = lax.associative_scan(jnp.minimum, match_pos, reverse=True)

    dpad = jnp.concatenate([block, jnp.zeros(ECH, jnp.uint8)])

    def extend(i, c, go):
        """total match length (>= 4): chunked first-mismatch search.
        ``go`` false -> zero iterations (lane masked, scalar state only)."""
        def cond(st):
            m, open_ = st
            return open_ & (i + m < limit)

        def body(st):
            m, _ = st
            a = lax.dynamic_slice(dpad, (jnp.clip(i + m, 0, n),), (ECH,))
            b = lax.dynamic_slice(dpad, (jnp.clip(c + m, 0, n),), (ECH,))
            pos = i + m + jnp.arange(ECH, dtype=jnp.int32)
            neq = (a != b) | (pos >= limit)
            anybad = neq.any()
            firstbad = jnp.argmax(neq).astype(jnp.int32)
            return m + jnp.where(anybad, firstbad, ECH), ~anybad

        m, _ = lax.while_loop(cond, body, (jnp.int32(MIN_MATCH), go))
        return jnp.clip(m, 0, jnp.maximum(limit - i, 0))

    # vmap-critical: no cond carries the record arrays; masked lanes write
    # garbage into slot s, which the next live write (or the final literal
    # sequence) overwrites, because s only advances on a real match.
    def body(st):
        i, anchor, s, lit_starts, lit_lens, offs, mlens = st
        c = cand[jnp.clip(i, 0, n - 1)]
        has = (c >= 0) & (i < length - MF_LIMIT)
        mlen = extend(i, jnp.maximum(c, 0), has)
        lit_starts = lit_starts.at[s].set(anchor)
        lit_lens = lit_lens.at[s].set(i - anchor)
        offs = offs.at[s].set(i - c)
        mlens = mlens.at[s].set(mlen)
        s = s + has.astype(jnp.int32)
        # advance: past the match, or jump to the next candidate position
        jump = nxt_match[jnp.clip(i + 1, 0, n - 1)]
        jump = jnp.where(i + 1 >= n, n, jump)
        i_next = jnp.where(has, i + mlen, jnp.maximum(jump, i + 1))
        anchor = jnp.where(has, i + mlen, anchor)
        return (i_next, anchor, s, lit_starts, lit_lens, offs, mlens)

    def cond(st):
        i, s = st[0], st[2]
        return (i < length - MF_LIMIT) & (s < max_seqs - 1)

    z = jnp.zeros(max_seqs, jnp.int32)
    st = (jnp.int32(0), jnp.int32(0), jnp.int32(0), z, z, z, z)
    i, anchor, s, lit_starts, lit_lens, offs, mlens = lax.while_loop(
        cond, body, st)
    # final literals-only sequence
    lit_starts = lit_starts.at[s].set(anchor)
    lit_lens = lit_lens.at[s].set(length - anchor)
    offs = offs.at[s].set(0)
    mlens = mlens.at[s].set(0)
    num_seqs = s + 1

    return _serialize(block, lit_starts, lit_lens, offs, mlens, num_seqs, cap)


def _ext_count(l: jnp.ndarray) -> jnp.ndarray:
    """number of 0xFF-chain extension bytes for a nibble-15 length field."""
    return jnp.where(l < 15, 0, (l - 15) // 255 + 1)


def _serialize(block, lit_starts, lit_lens, offsets, mlens, num_seqs, cap):
    """Every output byte classifies itself against per-sequence field
    boundaries and computes its value — fully parallel."""
    n = block.shape[0]
    max_seqs = lit_lens.shape[0]
    sid = jnp.arange(max_seqs, dtype=jnp.int32)
    valid = sid < num_seqs
    has_m = mlens > 0
    a = _ext_count(lit_lens)                       # literal ext byte count
    ml = jnp.maximum(mlens - MIN_MATCH, 0)
    b = jnp.where(has_m, _ext_count(ml), 0)        # match ext byte count
    sizes = jnp.where(
        valid, 1 + a + lit_lens + jnp.where(has_m, 2 + b, 0), 0)
    soffs = jnp.cumsum(sizes) - sizes              # exclusive
    total = soffs[-1] + sizes[-1]

    # covering sequence per output position
    p = jnp.arange(cap, dtype=jnp.int32)
    starts_scatter = jnp.where(valid & (sizes > 0), soffs, cap)
    seq_at = jnp.full(cap, -1, jnp.int32).at[starts_scatter].max(
        sid, mode="drop")
    cover = lax.cummax(seq_at)
    cs = jnp.clip(cover, 0, max_seqs - 1)
    rel = p - soffs[cs]

    l_len = lit_lens[cs]
    l_start = lit_starts[cs]
    a_s = a[cs]
    b_s = b[cs]
    off_s = offsets[cs]
    ml_s = ml[cs]

    # field boundaries
    lit0 = 1 + a_s
    off0 = lit0 + l_len
    ext2_0 = off0 + 2

    token = (jnp.minimum(l_len, 15) << 4) | jnp.where(
        has_m[cs], jnp.minimum(ml_s, 15), 0)
    e1 = rel - 1
    ext1_val = jnp.where(e1 < a_s - 1, 255, (l_len - 15) - 255 * (a_s - 1))
    lit_val = block[jnp.clip(l_start + (rel - lit0), 0, n - 1)].astype(jnp.int32)
    off_val = jnp.where(rel == off0, off_s & 0xFF, (off_s >> 8) & 0xFF)
    e2 = rel - ext2_0
    ext2_val = jnp.where(e2 < b_s - 1, 255, (ml_s - 15) - 255 * (b_s - 1))

    val = jnp.where(
        rel == 0, token,
        jnp.where(rel < lit0, ext1_val,
                  jnp.where(rel < off0, lit_val,
                            jnp.where(rel < ext2_0, off_val, ext2_val))))
    val = jnp.where((p < total) & (cover >= 0), val, 0)
    return val.astype(jnp.uint8), total


def encode_batch(blocks, lengths, hash_log: int = HASH_LOG):
    return jax.vmap(
        lambda b, l: encode(b, l, hash_log=hash_log))(blocks, lengths)


decode_batch = jax.vmap(decode, in_axes=(0, 0, None))


@functools.partial(jax.jit, static_argnames=())
def _gather_plan(comp, plans, olens):
    # flat 1-D i32-table gather rather than the batched take_along_axis
    # u8 form
    b, cap = comp.shape
    n = plans.shape[1]
    row = (jnp.arange(b, dtype=jnp.int32) * cap)[:, None]
    tab = comp.reshape(-1).astype(jnp.int32)
    out = jnp.take(tab, (plans + row).reshape(-1)).reshape(b, n)
    mask = jnp.arange(n, dtype=jnp.int32)[None, :] < olens[:, None]
    return jnp.where(mask, out, 0).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=())
def _gather_wplan(comp, patches, wplans, olens):
    """Word-plan decode executor: one address per output WORD (see csrc
    tpz_lz4_decode_wplan) — fetch the pair of adjacent i32 words of the
    virtual table [comp row | patch row] covering bytes addr..addr+3 and
    shift-combine.  ONE 2-wide row gather per 4 output bytes."""
    b, cap = comp.shape
    nw = wplans.shape[1]
    vt = jnp.concatenate([comp, patches], axis=1)
    wv = vt.shape[1] // 4
    vtw = jax.lax.bitcast_convert_type(
        vt.reshape(b, wv, 4), jnp.uint32)                   # little-endian
    pair = jnp.stack([vtw, jnp.roll(vtw, -1, axis=1)], axis=-1)
    addr = jnp.where(wplans >= 0, wplans, cap + (-wplans - 1))
    a0 = (addr >> 2) + (jnp.arange(b, dtype=jnp.int32) * wv)[:, None]
    pp = jnp.take(pair.reshape(-1, 2), a0.reshape(-1), axis=0)
    w0, w1 = pp[:, 0], pp[:, 1]
    sh = ((addr & 3) << 3).reshape(-1).astype(jnp.uint32)
    word = jnp.where(sh == 0, w0,
                     (w0 >> sh) | (w1 << ((32 - sh) & 31)))
    out = jax.lax.bitcast_convert_type(
        word.reshape(b, nw, 1), jnp.uint8).reshape(b, nw * 4)
    mask = jnp.arange(nw * 4, dtype=jnp.int32)[None, :] < olens[:, None]
    return jnp.where(mask, out, 0).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=())
def _gather_wplan8(comp, patches, wplans, olens):
    """Dword-plan decode executor: one address per output DOUBLE word —
    fetch the three adjacent u32 words of the virtual table
    [comp row | patch row] covering bytes addr..addr+11 and funnel-shift
    two output words.  HALF the gather rows of _gather_wplan per output
    byte."""
    b, cap = comp.shape
    nw = wplans.shape[1]
    vt = jnp.concatenate([comp, patches], axis=1)
    wv = vt.shape[1] // 4
    vtw = jax.lax.bitcast_convert_type(
        vt.reshape(b, wv, 4), jnp.uint32)                   # little-endian
    trip = jnp.stack([vtw, jnp.roll(vtw, -1, axis=1),
                      jnp.roll(vtw, -2, axis=1)], axis=-1)  # (b, wv, 3)
    addr = jnp.where(wplans >= 0, wplans, cap + (-wplans - 1))
    a0 = (addr >> 2) + (jnp.arange(b, dtype=jnp.int32) * wv)[:, None]
    ppp = jnp.take(trip.reshape(-1, 3), a0.reshape(-1), axis=0)
    w0, w1, w2 = ppp[:, 0], ppp[:, 1], ppp[:, 2]
    sh = ((addr & 3) << 3).reshape(-1).astype(jnp.uint32)
    inv = (32 - sh) & 31
    o0 = jnp.where(sh == 0, w0, (w0 >> sh) | (w1 << inv))
    o1 = jnp.where(sh == 0, w1, (w1 >> sh) | (w2 << inv))
    out = jax.lax.bitcast_convert_type(
        jnp.stack([o0, o1], axis=-1).reshape(b, nw, 2, 1),
        jnp.uint8).reshape(b, nw * 8)
    mask = jnp.arange(nw * 8, dtype=jnp.int32)[None, :] < olens[:, None]
    return jnp.where(mask, out, 0).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=())
def _gather_wplan16(comp, patches, wplans, olens):
    """Quad-word-plan decode executor: one address per SIXTEEN output
    bytes — fetch the five adjacent u32 words of the virtual table
    [comp row | patch row] covering bytes addr..addr+19 and funnel-shift
    four output words.  QUARTER the gather rows of _gather_wplan per
    output byte."""
    b, cap = comp.shape
    nw = wplans.shape[1]
    vt = jnp.concatenate([comp, patches], axis=1)
    wv = vt.shape[1] // 4
    vtw = jax.lax.bitcast_convert_type(
        vt.reshape(b, wv, 4), jnp.uint32)                   # little-endian
    quint = jnp.stack([vtw] + [jnp.roll(vtw, -k, axis=1)
                               for k in range(1, 5)], axis=-1)  # (b, wv, 5)
    addr = jnp.where(wplans >= 0, wplans, cap + (-wplans - 1))
    a0 = (addr >> 2) + (jnp.arange(b, dtype=jnp.int32) * wv)[:, None]
    q = jnp.take(quint.reshape(-1, 5), a0.reshape(-1), axis=0)
    sh = ((addr & 3) << 3).reshape(-1).astype(jnp.uint32)
    inv = (32 - sh) & 31
    outs = [jnp.where(sh == 0, q[:, k],
                      (q[:, k] >> sh) | (q[:, k + 1] << inv))
            for k in range(4)]
    out = jax.lax.bitcast_convert_type(
        jnp.stack(outs, axis=-1).reshape(b, nw, 4, 1),
        jnp.uint8).reshape(b, nw * 16)
    mask = jnp.arange(nw * 16, dtype=jnp.int32)[None, :] < olens[:, None]
    return jnp.where(mask, out, 0).astype(jnp.uint8)


def decode_batch_wplanned16(comp_np, clens_np, out_n: int):
    """Quad-word-plan variant of decode_batch_wplanned: one gather row per
    SIXTEEN output bytes (csrc tpz_lz4_decode_wplan16_batch).  Falls back
    to the word plan when out_n isn't 16-aligned, to the byte plan on
    patch overflow."""
    import numpy as np

    from tpuzip.runtime import native

    comp_np = np.asarray(comp_np)
    clens_np = np.asarray(clens_np)
    if out_n % 16:
        return decode_batch_wplanned(comp_np, clens_np, out_n)
    if comp_np.shape[1] % 4:
        comp_np = np.pad(comp_np, ((0, 0), (0, 4 - comp_np.shape[1] % 4)))
    wplans, patches, st, _used = native.lz4_decode_wplan16_batch(
        comp_np, clens_np.astype(np.int32), out_n, strict=False)
    if (st == -2).any():
        return decode_batch_planned(comp_np, clens_np, out_n)
    errs = (st == -1).astype(np.int32)
    olens = np.where(st > 0, st, 0).astype(np.int32)
    out = _gather_wplan16(jnp.asarray(comp_np), jnp.asarray(patches),
                          jnp.asarray(wplans), jnp.asarray(olens))
    return out, jnp.asarray(olens), jnp.asarray(errs)


def decode_batch_wplanned8(comp_np, clens_np, out_n: int):
    """Dword-plan variant of decode_batch_wplanned: one gather row per
    EIGHT output bytes (csrc tpz_lz4_decode_wplan8_batch).  Falls back to
    the word plan when out_n isn't 8-aligned, to the byte plan on patch
    overflow."""
    import numpy as np

    from tpuzip.runtime import native

    comp_np = np.asarray(comp_np)
    clens_np = np.asarray(clens_np)
    if out_n % 8:
        return decode_batch_wplanned(comp_np, clens_np, out_n)
    if comp_np.shape[1] % 4:
        comp_np = np.pad(comp_np, ((0, 0), (0, 4 - comp_np.shape[1] % 4)))
    wplans, patches, st, _used = native.lz4_decode_wplan8_batch(
        comp_np, clens_np.astype(np.int32), out_n, strict=False)
    if (st == -2).any():
        return decode_batch_planned(comp_np, clens_np, out_n)
    errs = (st == -1).astype(np.int32)
    olens = np.where(st > 0, st, 0).astype(np.int32)
    out = _gather_wplan8(jnp.asarray(comp_np), jnp.asarray(patches),
                         jnp.asarray(wplans), jnp.asarray(olens))
    return out, jnp.asarray(olens), jnp.asarray(errs)


def decode_batch_planned(comp_np, clens_np, out_n: int):
    """Host-parse/device-copy-plan decode (VERDICT r1 item 3; SURVEY.md
    :175-179 hot loop, re-architected): the C++ parser resolves every
    output byte to its source LITERAL position in the compressed stream at
    host memory speed (csrc tpz_lz4_decode_plan), and the device executes
    the whole block batch as ONE bulk gather — no sequential token loop on
    the device at all.

    Returns (out (B, out_n) u8 device, olens (B,) i32, errs (B,) i32)."""
    import numpy as np

    from tpuzip.runtime import native

    comp_np = np.asarray(comp_np)
    clens_np = np.asarray(clens_np)
    B = comp_np.shape[0]
    plans = np.zeros((B, out_n), np.int32)
    olens = np.zeros(B, np.int32)
    errs = np.zeros(B, np.int32)
    for i in range(B):
        cl = int(clens_np[i])
        if cl == 0:
            continue
        try:
            p = native.lz4_decode_plan(comp_np[i, :cl].tobytes(), out_n)
            plans[i, : len(p)] = p
            olens[i] = len(p)
        except ValueError:
            errs[i] = 1
    out = _gather_plan(jnp.asarray(comp_np), jnp.asarray(plans),
                       jnp.asarray(olens))
    return out, jnp.asarray(olens), jnp.asarray(errs)


def decode_batch_wplanned(comp_np, clens_np, out_n: int):
    """Word-plan variant of decode_batch_planned: one gather element per
    TWO output bytes instead of one per byte (csrc emits per-word
    addresses + a boundary patch buffer).  Falls back to the byte plan
    when a block's patch budget overflows (pathological token streams).

    Returns (out (B, out_n) u8 device, olens (B,) i32, errs (B,) i32)."""
    import numpy as np

    from tpuzip.runtime import native

    comp_np = np.asarray(comp_np)
    clens_np = np.asarray(clens_np)
    B = comp_np.shape[0]
    if out_n % 4:
        return decode_batch_planned(comp_np, clens_np, out_n)
    if comp_np.shape[1] % 4:  # virtual-table word packing needs 4-aligned rows
        comp_np = np.pad(comp_np, ((0, 0), (0, 4 - comp_np.shape[1] % 4)))
    # threaded C++ batch parse (csrc tpz_lz4_decode_wplan_batch): all B
    # token streams fan out across cores — 614 MB/s at 4 threads vs 85
    # single-thread (the parse is embarrassingly parallel over blocks)
    wplans, patches, st, _used = native.lz4_decode_wplan_batch(
        comp_np, clens_np.astype(np.int32), out_n, strict=False)
    if (st == -2).any():  # patch budget overflow: byte-plan fallback
        return decode_batch_planned(comp_np, clens_np, out_n)
    errs = (st == -1).astype(np.int32)
    olens = np.where(st > 0, st, 0).astype(np.int32)
    out = _gather_wplan(jnp.asarray(comp_np), jnp.asarray(patches),
                        jnp.asarray(wplans), jnp.asarray(olens))
    return out, jnp.asarray(olens), jnp.asarray(errs)
