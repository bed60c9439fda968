"""lz4p — parallel-decodable LZ sequences (tpz-native format).

The LZ4 *bitstream* interleaves tokens, so decode position discovery is
inherently serial.  lz4p keeps LZ4's parse (same candidate search and greedy
resolution, same matches) but serializes COLUMNAR, which is the parallel-first
redesign the BASELINE north star calls "decode ... with speculative token
expansion" (cf. ACEAPEX, PAPERS.md):

  [num_seqs u32 LE][orig_len u32 LE]
  [lit_lens u16 LE x S][mlens u16 LE x S][offsets u16 LE x S]
  [literal bytes, concatenated]

Decode has NO sequential loop:
  1. per-sequence output positions = prefix sums of (lit_len + mlen);
  2. literals land via the cover/fill gather (fully parallel);
  3. matches resolve in ROUNDS: every unresolved output byte pulls from
     `src = match_start - offset + (p - match_start) % offset` (periodic, so
     self-overlap resolves against bytes before the match); a byte becomes
     resolved once its source is.  Rounds = reference-DAG depth (1 for
     literals-only, ~tens for text), each round two full-array gathers.

Ratio cost vs LZ4: 6 bytes per sequence (3 u16 columns) vs ~3 — the price
of random-access decode.  Requires block_size <= 65536 (u16 columns).

This formulation needs ~15 full-array gather passes (cover/fill +
log-depth root chase), so its device decode is gather-bound; its speed on
the H100 is not yet measured.  It is also the random-access container
format.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from tpuzip.codecs import lz4 as jlz4
from tpuzip.core.bitio import exclusive_cumsum

HDR = 8


def encode_cap(n: int) -> int:
    return HDR + 6 * (n // 4 + 2) + n + 64


def encode(block: jnp.ndarray, length: jnp.ndarray,
           cap: int | None = None) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Same parse as codecs.lz4; columnar serialization."""
    n = block.shape[0]
    assert n <= 1 << 16
    cap = cap or encode_cap(n)
    length = jnp.asarray(length, jnp.int32)
    # reuse the LZ4 greedy parse by running its encoder pipeline up to the
    # record arrays: call the internal stages
    cand = jlz4._candidates(block, length)
    max_seqs = n // 4 + 2
    limit = length - jlz4.LAST_LITERALS
    idxs = jnp.arange(n, dtype=jnp.int32)
    match_pos = jnp.where(cand >= 0, idxs, n)
    nxt_match = lax.associative_scan(jnp.minimum, match_pos, reverse=True)
    dpad = jnp.concatenate([block, jnp.zeros(jlz4.ECH, jnp.uint8)])

    def extend(i, c, go):
        def cond(st):
            m, open_ = st
            return open_ & (i + m < limit)

        def body(st):
            m, _ = st
            a = lax.dynamic_slice(dpad, (jnp.clip(i + m, 0, n),), (jlz4.ECH,))
            b = lax.dynamic_slice(dpad, (jnp.clip(c + m, 0, n),), (jlz4.ECH,))
            pos = i + m + jnp.arange(jlz4.ECH, dtype=jnp.int32)
            neq = (a != b) | (pos >= limit)
            anybad = neq.any()
            first = jnp.argmax(neq).astype(jnp.int32)
            return m + jnp.where(anybad, first, jlz4.ECH), ~anybad

        m, _ = lax.while_loop(cond, body, (jnp.int32(jlz4.MIN_MATCH), go))
        return jnp.clip(m, 0, jnp.maximum(limit - i, 0))

    def body(st):
        i, anchor, s, ls, ll, of, ml = st
        c = cand[jnp.clip(i, 0, n - 1)]
        has = (c >= 0) & (i < length - jlz4.MF_LIMIT)
        mlen = extend(i, jnp.maximum(c, 0), has)
        ls = ls.at[s].set(anchor)
        ll = ll.at[s].set(i - anchor)
        of = of.at[s].set(i - c)
        ml = ml.at[s].set(mlen)
        s = s + has.astype(jnp.int32)
        jump = nxt_match[jnp.clip(i + 1, 0, n - 1)]
        jump = jnp.where(i + 1 >= n, n, jump)
        i_next = jnp.where(has, i + mlen, jnp.maximum(jump, i + 1))
        anchor = jnp.where(has, i + mlen, anchor)
        return (i_next, anchor, s, ls, ll, of, ml)

    def cond(st):
        i, s = st[0], st[2]
        return (i < length - jlz4.MF_LIMIT) & (s < max_seqs - 1)

    z = jnp.zeros(max_seqs, jnp.int32)
    i, anchor, s, ls, ll, of, ml = lax.while_loop(
        cond, body, (jnp.int32(0), jnp.int32(0), jnp.int32(0), z, z, z, z))
    ls = ls.at[s].set(anchor)
    ll = ll.at[s].set(length - anchor)
    of = of.at[s].set(0)
    ml = ml.at[s].set(0)
    num = s + 1

    sid = jnp.arange(max_seqs, dtype=jnp.int32)
    valid = sid < num
    ll = jnp.where(valid, ll, 0)
    ml = jnp.where(valid, ml, 0)
    of = jnp.where(valid, of, 0)

    # columnar u16 LE serialization at dynamic offsets
    total_lit = ll.sum()
    out = jnp.zeros(cap, jnp.uint8)
    hdr = jnp.stack([(num >> (8 * k)) & 0xFF for k in range(4)]
                    + [(length >> (8 * k)) & 0xFF for k in range(4)]
                    ).astype(jnp.uint8)
    out = out.at[:HDR].set(hdr)

    def put_col(out, col, col_idx):
        base = HDR + 2 * col_idx * num
        pos = base + 2 * sid
        pos = jnp.where(valid, pos, cap)
        out = out.at[pos].set((col & 0xFF).astype(jnp.uint8), mode="drop")
        out = out.at[jnp.where(valid, pos + 1, cap)].set(
            ((col >> 8) & 0xFF).astype(jnp.uint8), mode="drop")
        return out

    out = put_col(out, ll, 0)
    out = put_col(out, ml, 1)
    out = put_col(out, of, 2)

    # literals blob: positions via cover/fill over the literal stream
    lit_offs = exclusive_cumsum(ll)
    lit_base = HDR + 6 * num
    p = jnp.arange(n, dtype=jnp.int32)          # literal-stream positions
    scat = jnp.where(valid & (ll > 0), lit_offs, n)
    seq_at = jnp.full(n, -1, jnp.int32).at[scat].max(sid, mode="drop")
    cover = lax.cummax(seq_at)
    cs = jnp.clip(cover, 0, max_seqs - 1)
    src = ls[cs] + (p - lit_offs[cs])
    lit_bytes = block[jnp.clip(src, 0, n - 1)]
    dst = jnp.where((p < total_lit) & (cover >= 0), lit_base + p, cap)
    out = out.at[dst].set(lit_bytes, mode="drop")
    return out, lit_base + total_lit


def decode(comp: jnp.ndarray, comp_len: jnp.ndarray, out_n: int
           ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Round-based parallel decode: no scan over sequences or bytes."""
    cap = comp.shape[0]
    c32 = comp.astype(jnp.int32)
    num = (c32[0] | (c32[1] << 8) | (c32[2] << 16) | (c32[3] << 24))
    length = (c32[4] | (c32[5] << 8) | (c32[6] << 16) | (c32[7] << 24))
    length = jnp.minimum(length, out_n)
    max_seqs = out_n // 4 + 2
    num = jnp.minimum(num, max_seqs)
    sid = jnp.arange(max_seqs, dtype=jnp.int32)
    valid = sid < num

    def get_col(col_idx):
        base = HDR + 2 * col_idx * num
        pos = jnp.clip(base + 2 * sid, 0, cap - 2)
        v = c32[pos] | (c32[pos + 1] << 8)
        return jnp.where(valid, v, 0)

    ll = get_col(0)
    ml = get_col(1)
    of = get_col(2)
    lit_base = HDR + 6 * num

    seq_sizes = ll + ml
    out_offs = exclusive_cumsum(seq_sizes)      # output start per seq
    lit_offs = exclusive_cumsum(ll)
    total = out_offs[-1] + seq_sizes[-1]
    err = (total != length).astype(jnp.int32)

    # classify every output position
    p = jnp.arange(out_n, dtype=jnp.int32)
    scat = jnp.where(valid & (seq_sizes > 0), out_offs, out_n)
    seq_at = jnp.full(out_n, -1, jnp.int32).at[scat].max(sid, mode="drop")
    cover = lax.cummax(seq_at)
    cs = jnp.clip(cover, 0, max_seqs - 1)
    rel = p - out_offs[cs]
    is_lit = rel < ll[cs]
    in_range = (p < length) & (cover >= 0)

    lit_src = jnp.clip(lit_base + lit_offs[cs] + rel, 0, cap - 1)
    out0 = jnp.where(is_lit & in_range, comp[lit_src], 0)

    # match sources: periodic within the match, always before match start
    m_start = out_offs[cs] + ll[cs]
    offv = jnp.maximum(of[cs], 1)
    src = m_start - offv + (p - m_start) % offv
    src = jnp.clip(src, 0, out_n - 1)
    bad_match = (~is_lit) & in_range & ((of[cs] == 0) | (m_start - of[cs] < 0))
    err = err | bad_match.any().astype(jnp.int32)

    resolved0 = is_lit | ~in_range

    # pointer doubling: every match byte's value equals the value of its
    # LITERAL ancestor in the copy graph; chase roots in log(depth) rounds
    # (each round squares the jump), then one value gather.
    root0 = jnp.where(resolved0, p, src)

    def cond(st):
        root, rounds = st
        return (~resolved0[root].all()) & (rounds < 20)  # 2^20 >> any depth

    def body(st):
        root, rounds = st
        return jnp.where(resolved0[root], root, root[root]), rounds + 1

    root, _ = lax.while_loop(cond, body, (root0, jnp.int32(0)))
    err = err | (~resolved0[root].all()).astype(jnp.int32)
    out = jnp.where(resolved0, out0, out0[root])
    out = jnp.where(p < length, out, 0).astype(jnp.uint8)
    return out, length, err


encode_batch = jax.vmap(encode, in_axes=(0, 0))
decode_batch = jax.vmap(decode, in_axes=(0, 0, None))
