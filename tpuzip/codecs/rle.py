"""RLE codec — XLA formulation.

Format: tpuzip.oracle.rle (pair-then-count; reference parity src/rle.rs).

Encode is fully parallel: run/segment decomposition via compare-shift +
cumsum, per-segment 1-or-3-byte chunks packed with prefix-sum offsets.
Long runs are split into <=256-byte segments (format-legal: the decoder
resets pairing after each counted run, so back-to-back same-byte segments
decode correctly); this keeps the per-segment emission a static 3 bytes.

Decode is a `lax.scan` over compressed bytes (count bytes are data-dependent
— inherently serial, tiny state) followed by a parallel run-fill expansion
(scatter run starts -> cummax -> gather), vectorized across blocks by vmap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpuzip.core.bitio import exclusive_cumsum, pack_bytes_varlen

SEG = 256  # max segment length: 2-byte pair + single count byte (<=254)


def encode_cap(n: int) -> int:
    return 2 * n + 8  # worst case: alternating pairs -> 3 bytes per 2 input


def encode(block: jnp.ndarray, length: jnp.ndarray,
           cap: int | None = None) -> tuple[jnp.ndarray, jnp.ndarray]:
    n = block.shape[0]
    cap = cap or encode_cap(n)
    length = jnp.asarray(length, jnp.int32)
    idx = jnp.arange(n, dtype=jnp.int32)
    valid = idx < length
    d = block.astype(jnp.int32)
    prev = jnp.concatenate([jnp.array([-1], jnp.int32), d[:-1]])
    run_head = valid & ((idx == 0) | (d != prev))
    # position within run: idx - (last run-head position at or before idx)
    head_pos = jnp.where(run_head, idx, -1)
    run_start = jax.lax.cummax(head_pos)
    pos_in_run = idx - run_start
    seg_head = valid & (pos_in_run % SEG == 0)
    # segment lengths: distance to next segment head (or end of data)
    seg_ids = jnp.cumsum(seg_head.astype(jnp.int32)) - 1  # id per position
    num_segs = jnp.maximum(seg_ids[-1] + 1, 0)
    seg_start = jnp.where(seg_head, idx, n + 1)
    # gather per-segment starts into a dense (n,) segment table (<= n segs)
    starts = jnp.full(n + 1, n + 1, jnp.int32).at[
        jnp.where(seg_head, seg_ids, n)].min(seg_start, mode="drop")
    starts = starts[:n]
    seg_valid = jnp.arange(n) < num_segs
    nxt = jnp.concatenate([starts[1:], jnp.array([n + 1], jnp.int32)])
    # next segment start, else data end
    seg_end = jnp.where(seg_valid, jnp.minimum(jnp.where(
        nxt <= n, nxt, length), length), 0)
    seg_len = jnp.where(seg_valid, seg_end - starts, 0)
    seg_byte = block[jnp.clip(starts, 0, n - 1)]
    single = seg_len == 1
    chunk = jnp.stack([
        seg_byte,
        seg_byte,
        jnp.clip(seg_len - 2, 0, 255).astype(jnp.uint8),
    ], axis=1)
    lens = jnp.where(seg_valid, jnp.where(single, 1, 3), 0)
    out, total = pack_bytes_varlen(chunk, lens.astype(jnp.int32), cap)
    return out, total


def decode(comp: jnp.ndarray, comp_len: jnp.ndarray,
           out_n: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Scan classifier + parallel run-fill. Handles multi-count-byte runs
    (oracle encodes unsplit runs with chained 255 count bytes)."""
    m = comp.shape[0]
    comp_len = jnp.asarray(comp_len, jnp.int32)

    # state: (prev_byte, run_val, expect_count: 0/1, chain: chaining 255s)
    def step(state, x):
        b, i = x
        prev, run_val, expect, chain = state
        is_valid = i < comp_len
        is_count = is_valid & ((expect == 1) | (chain == 1))
        pair = (~is_count) & is_valid & (b == prev)
        new_expect = jnp.where(pair, 1, 0)
        new_chain = jnp.where(is_count & (b == 255), 1, 0)
        new_run_val = jnp.where(pair, b.astype(jnp.int32), run_val)
        # after a count chain ends, pairing restarts fresh (prev = -1)
        new_prev = jnp.where(is_count, -1,
                             jnp.where(is_valid, b.astype(jnp.int32), prev))
        # a literal emits 1 byte; a count byte emits b copies of the run value
        emit = jnp.where(is_count, b.astype(jnp.int32),
                         jnp.where(is_valid, 1, 0))
        val = jnp.where(is_count, run_val, b.astype(jnp.int32))
        return (new_prev, new_run_val, new_expect, new_chain), (emit, val)

    xs = (comp.astype(jnp.int32), jnp.arange(m, dtype=jnp.int32))
    init = (jnp.int32(-1), jnp.int32(-1), jnp.int32(0), jnp.int32(0))
    _, (emits, vals) = jax.lax.scan(step, init, xs)

    # parallel expansion: token t covers output [offs[t], offs[t]+emits[t])
    offs = exclusive_cumsum(emits)
    total = offs[-1] + emits[-1]
    starts_scatter = jnp.where(emits > 0, offs, out_n)
    token_at = jnp.full(out_n, -1, jnp.int32).at[starts_scatter].max(
        jnp.arange(m, dtype=jnp.int32), mode="drop")
    token_id = jax.lax.cummax(token_at)
    out = vals[jnp.clip(token_id, 0, m - 1)].astype(jnp.uint8)
    out = jnp.where(jnp.arange(out_n) < total, out, 0)
    return out, total


encode_batch = jax.vmap(encode, in_axes=(0, 0))
decode_batch = jax.vmap(decode, in_axes=(0, 0, None))
