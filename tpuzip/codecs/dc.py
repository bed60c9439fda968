"""Distance coding — XLA formulation (format: tpuzip.oracle.dc; reference
parity src/bwt/dc.rs).

Encode is parallel: run decomposition (compare-shift), per-symbol first
occurrences (scatter-min), next-head distances via one stable sort by
(symbol, head), varint emission through the prefix-sum byte packer.

Decode is a scan over runs: at most one outstanding scheduled head exists
per symbol, so the scheduler state is a dense (256,) position table — the
"min over scheduled" of the reference's walk becomes a vectorized min.
Output expansion is the usual parallel run-fill.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from tpuzip.core.bitio import (pack_bytes_varlen,
                               pack_bytes_varlen_sorted)

VARINT_MAX = 5  # u32 varints
HDR = 4 + 256 * 4


def encode_cap(n: int) -> int:
    return HDR + VARINT_MAX * n + 8


def _varint_bytes(v: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """v (T,) i32 -> (bytes (T, VARINT_MAX) u8, lens (T,))  LEB128."""
    v = v.astype(jnp.uint32)
    parts = []
    for k in range(VARINT_MAX):
        parts.append((v >> (7 * k)) & 0x7F)
    parts = jnp.stack(parts, axis=1)  # (T, 5)
    nbits = 32 - jnp.sum(jnp.cumsum(
        jnp.flip(parts, axis=1) != 0, axis=1) == 0, axis=1) * 7
    lens = jnp.maximum((nbits + 6) // 7, 1).astype(jnp.int32)
    k = jnp.arange(VARINT_MAX)[None, :]
    cont = k < (lens[:, None] - 1)
    out = jnp.where(cont, parts | 0x80, parts).astype(jnp.uint8)
    return out, lens


def encode(block: jnp.ndarray, length: jnp.ndarray,
           cap: int | None = None) -> tuple[jnp.ndarray, jnp.ndarray]:
    n = block.shape[0]
    cap = cap or encode_cap(n)
    length = jnp.asarray(length, jnp.int32)
    idx = jnp.arange(n, dtype=jnp.int32)
    valid = idx < length
    d = block.astype(jnp.int32)
    prev = jnp.concatenate([jnp.array([-1], jnp.int32), d[:-1]])
    head = valid & ((idx == 0) | (d != prev))
    run_id = jnp.cumsum(head.astype(jnp.int32)) - 1
    num_runs = jnp.maximum(run_id[-1] + 1, 0)

    # per-run tables by SORT-COMPACTION, not scatter (docs/DESIGN.md).
    # run_id is strictly increasing on heads, so compaction keys are
    # unique where valid; ties only among the masked tail.
    rid_key = jnp.where(head, run_id, n)
    _, run_start, run_sym = lax.sort(
        (rid_key, idx, d), num_keys=1, is_stable=True)
    r_valid = jnp.arange(n) < num_runs
    nxt_start = jnp.concatenate([run_start[1:], jnp.array([0], jnp.int32)])
    run_end = jnp.where(jnp.arange(n) == num_runs - 1, length, nxt_start)
    run_end = jnp.where(r_valid, run_end, 0)

    # next head of the same symbol: stable sort runs by (sym, start)
    key_sym = jnp.where(r_valid, run_sym, 257)
    _, _, perm = lax.sort(
        (key_sym, jnp.where(r_valid, run_start, n + 1),
         jnp.arange(n, dtype=jnp.int32)), num_keys=2, is_stable=True)
    sym_sorted = key_sym[perm]
    start_sorted = jnp.where(r_valid[perm], run_start[perm], 0)
    nxt_same = jnp.concatenate([start_sorted[1:], jnp.array([-1], jnp.int32)])
    same_sym = jnp.concatenate([sym_sorted[1:] == sym_sorted[:-1],
                                jnp.array([False])])
    next_head_sorted = jnp.where(same_sym, nxt_same, -1)
    # first occurrence per symbol: within a sym group the sort above is
    # start-ascending, so the group head IS the min head position — read
    # the dense 256-table with a binary search instead of a scatter-min
    qpos = jnp.searchsorted(sym_sorted, jnp.arange(256, dtype=jnp.int32))
    qpos = jnp.minimum(qpos, n - 1)
    first = jnp.where(sym_sorted[qpos] == jnp.arange(256),
                      start_sorted[qpos], length)
    # un-permute via sort (perm is a permutation: unique keys)
    _, next_head = lax.sort((perm, next_head_sorted), num_keys=1,
                            is_stable=False)

    dists = jnp.where(next_head >= 0, next_head - (run_end - 1), 0)
    dists = jnp.where(r_valid, dists, 0)

    vb, vl = _varint_bytes(dists)
    vl = jnp.where(r_valid, vl, 0)

    # header: [length u32 LE][first[256] u32 LE]
    hdr_vals = jnp.concatenate([length[None], first])
    hdr = jnp.stack([(hdr_vals >> (8 * k)) & 0xFF for k in range(4)],
                    axis=1).reshape(-1).astype(jnp.uint8)
    body, body_len = pack_bytes_varlen_sorted(vb, vl, cap - HDR)
    out = jnp.zeros(cap, jnp.uint8).at[:HDR].set(hdr)
    out = lax.dynamic_update_slice(out, body, (HDR,))[:cap]
    # re-zero past the body (dynamic_update_slice wrote the whole buffer)
    pos = jnp.arange(cap)
    out = jnp.where(pos < HDR + body_len, out, 0)
    return out, HDR + body_len


def _parse_varints(comp32: jnp.ndarray, comp_len: jnp.ndarray,
                   max_steps: int) -> jnp.ndarray:
    """Parallel LEB128 parse of the whole distance stream: the encoding is
    self-delimiting (high bit = continuation), so varint STARTS are the
    body head plus every byte following a terminator — all boundaries and
    values fall out of shifted-array arithmetic with no sequential walk.
    Returns vals (max_steps,) i32, the k-th varint of the body."""
    cap = comp32.shape[0]
    pos = jnp.arange(cap, dtype=jnp.int32)
    in_body = (pos >= HDR) & (pos < comp_len)
    b = jnp.where(in_body, comp32, 0)
    term = (b < 0x80) & in_body
    prev_term = jnp.concatenate([jnp.array([False]), term[:-1]])
    is_start = in_body & ((pos == HDR) | prev_term)
    ordinal = jnp.cumsum(is_start.astype(jnp.int32)) - 1

    val = jnp.zeros(cap, jnp.int32)
    include = jnp.ones(cap, jnp.bool_)
    for k in range(VARINT_MAX):
        bk = jnp.roll(b, -k) if k else b
        inb = jnp.roll(in_body, -k) if k else in_body
        val = val | jnp.where(include & inb,
                              (bk & 0x7F) << (7 * k), 0)
        include = include & (bk >= 0x80)
    # compact run-ordered values with a stable sort rather than a scatter
    key = jnp.where(is_start, ordinal, jnp.int32(cap + 1))
    _, vals_sorted = lax.sort([key, val], num_keys=1, is_stable=True)
    return lax.slice(vals_sorted, (0,), (max_steps,))


def decode(comp: jnp.ndarray, comp_len: jnp.ndarray, out_n: int,
           max_steps: int | None = None
           ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """-> (out (out_n,) u8, out_len i32, err i32).

    The run scan consumes pre-parsed varints as scan inputs — no
    data-dependent gathers inside the loop (measured 9 in-loop gathers
    per step in the v1 formulation, the dominant cost) — and updates the
    (256,) scheduler table via one-hot masks instead of dynamic scatter.
    `max_steps` bounds the scan length: every run consumes at least one
    distance byte, so callers may pass max(comp_len) - HDR."""
    cap = comp.shape[0]
    T = out_n if max_steps is None else min(max_steps, out_n)
    comp32 = comp.astype(jnp.int32)
    length = (comp32[0] | (comp32[1] << 8) | (comp32[2] << 16)
              | (comp32[3] << 24))
    length = jnp.minimum(length, out_n)
    sym4 = 4 + jnp.arange(256) * 4
    first = (comp32[sym4] | (comp32[sym4 + 1] << 8)
             | (comp32[sym4 + 2] << 16) | (comp32[sym4 + 3] << 24))
    INF = jnp.int32(0x7FFFFFFF)
    sched0 = jnp.where(first < length, first, INF)
    vals = _parse_varints(comp32, comp_len, T)

    def step(state, d):
        pos, sched, err = state
        active = pos < length
        # current run's symbol: the one scheduled exactly at pos
        hit = sched == pos                       # at most one True
        any_hit = hit.any()
        cleared = jnp.where(hit, INF, sched)
        nxt = jnp.minimum(jnp.min(cleared), length)
        run_end = nxt - 1
        target = run_end + d
        bad = active & ((~any_hit) | ((d > 0) & ((target >= length)
                                                 | (target < nxt))))
        resched = jnp.where(hit & (d > 0) & ~bad, target, cleared)
        s = jnp.argmax(hit).astype(jnp.int32)
        out_run = (jnp.where(active, pos, 0),
                   jnp.where(active, nxt - pos, 0),
                   jnp.where(active, s, 0))
        sched = jnp.where(active, resched, sched)
        pos = jnp.where(active, nxt, pos)
        err = err | bad.astype(jnp.int32)
        return (pos, sched, err), out_run

    init = (jnp.int32(0), sched0, jnp.int32(0))
    (pos_end, _, err), (starts, lens_, syms) = lax.scan(step, init, vals)
    # max_steps must cover every run: an unfinished walk is an error
    err = err | (pos_end < length).astype(jnp.int32)
    out = _run_fill(starts, lens_, syms, length, out_n)
    return out, length, err


def _run_fill(starts, lens_, syms, length, out_n: int) -> jnp.ndarray:
    """Expand run triples (start, len, sym) to bytes in parallel.

    The symbol rides INSIDE the scattered value ((run_idx << 8) | sym;
    run_idx is monotone in start, so scatter-max + cummax propagates the
    latest run) — no (out_n,) gather afterwards, only a T-element scatter
    and two vector passes."""
    T = starts.shape[0]
    scat = jnp.where(lens_ > 0, starts, out_n)
    if T < (1 << 23):
        packed = (jnp.arange(T, dtype=jnp.int32) << 8) | syms
        acc = jnp.full(out_n, -1, jnp.int32).at[scat].max(packed,
                                                          mode="drop")
        filled = lax.cummax(acc)
        out = (filled & 0xFF).astype(jnp.uint8)
    else:  # giant blocks: run_idx << 8 would overflow i32 — gather form
        run_at = jnp.full(out_n, -1, jnp.int32).at[scat].max(
            jnp.arange(T, dtype=jnp.int32), mode="drop")
        run_of = lax.cummax(run_at)
        out = syms[jnp.clip(run_of, 0, T - 1)].astype(jnp.uint8)
    return jnp.where(jnp.arange(out_n) < length, out, 0)


encode_batch = jax.vmap(encode, in_axes=(0, 0))


def decode_batch(comp, comp_lens, out_n: int, max_steps: int | None = None):
    return jax.vmap(lambda c, l: decode(c, l, out_n, max_steps))(
        comp, comp_lens)
