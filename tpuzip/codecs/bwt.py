"""Burrows–Wheeler transform — XLA formulation.

Format/semantics: tpuzip.oracle.bwt (cyclic-rotation BWT + origin; reference
parity src/bwt/mod.rs).

Forward: prefix doubling — ceil(log2 N) rounds of `lax.sort` over
(rank, rank-at-offset-k, index) triples.  This is the same algorithm the
oracle runs (numpy lexsort), so suffix arrays — and therefore L columns and
origins — agree exactly, including tied ranks on periodic inputs (stable
final sort breaks ties by index in both).

Inverse: counting sort (one stable sort) gives the LF "next" permutation;
the sequential n-step walk of the reference becomes log2(N) rounds of
pointer-doubling composition (orbit fill), fully parallel.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import lax


def encode_block(block: jnp.ndarray, length: jnp.ndarray
                 ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """-> (L (N,) u8, origin i32). Invalid lanes (>= length) sort last."""
    n = block.shape[0]
    length = jnp.asarray(length, jnp.int32)
    idx = jnp.arange(n, dtype=jnp.int32)
    valid = idx < length
    big = jnp.int32(n + 1)
    rank = jnp.where(valid, block.astype(jnp.int32), big)
    safe_len = jnp.maximum(length, 1)

    rounds = max(int(math.ceil(math.log2(max(n, 2)))), 1)
    k = jnp.int32(1)
    for _ in range(rounds):
        second = jnp.where(valid, rank[(idx + k) % safe_len], big)
        _, _, order = lax.sort((rank, second, idx), num_keys=2, is_stable=True)
        key_r = rank[order]
        key_s = second[order]
        changed = jnp.concatenate([
            jnp.array([1], jnp.int32),
            ((key_r[1:] != key_r[:-1]) | (key_s[1:] != key_s[:-1])
             ).astype(jnp.int32)])
        ranks_sorted = jnp.cumsum(changed) - 1
        rank = jnp.zeros(n, jnp.int32).at[order].set(ranks_sorted)
        rank = jnp.where(valid, rank, big)
        k = k * 2

    # stable argsort of final ranks = suffix array (ties broken by index)
    _, sa = lax.sort((rank, idx), num_keys=1, is_stable=True)
    prev = (sa - 1) % safe_len
    L = jnp.where(jnp.arange(n) < length, block[prev], 0).astype(jnp.uint8)
    origin = jnp.where(length > 0, sa_zero_pos(sa, n), 0)
    return L, origin


def sa_zero_pos(sa: jnp.ndarray, n: int) -> jnp.ndarray:
    return jnp.argmax((sa == 0).astype(jnp.int32)).astype(jnp.int32)


def decode_block(L: jnp.ndarray, origin: jnp.ndarray, length: jnp.ndarray
                 ) -> jnp.ndarray:
    """Inverse BWT: stable counting sort -> orbit fill by pointer doubling."""
    n = L.shape[0]
    length = jnp.asarray(length, jnp.int32)
    idx = jnp.arange(n, dtype=jnp.int32)
    valid = idx < length
    key = jnp.where(valid, L.astype(jnp.int32), jnp.int32(256))
    _, order = lax.sort((key, idx), num_keys=1, is_stable=True)
    # orbit of `origin` under `order`: pos[t] = order^(t+1)(origin)
    pos = jnp.full(n, 0, jnp.int32).at[0].set(order[jnp.clip(origin, 0, n - 1)])
    step = order
    filled = 1
    rounds = max(int(math.ceil(math.log2(max(n, 2)))), 1)
    for _ in range(rounds):
        if filled >= n:
            break
        shifted = step[pos]                      # applies order^filled
        take_idx = jnp.arange(n, dtype=jnp.int32)
        write_pos = take_idx + filled
        pos = pos.at[jnp.where((take_idx < filled) & (write_pos < n),
                               write_pos, n)].set(shifted, mode="drop")
        step = step[step]
        filled *= 2
    out = jnp.where(valid, L[jnp.clip(pos, 0, n - 1)], 0)
    return out.astype(jnp.uint8)


encode_batch = jax.vmap(encode_block, in_axes=(0, 0))
decode_batch = jax.vmap(decode_block, in_axes=(0, 0, 0))


# ---------------------------------------------------------------------------
# Batched fast paths.  lax.sort has a large fixed cost per call, so the
# whole block batch sorts in ONE row-wise lax.sort per doubling round
# instead of a vmapped per-block sort; the first round ranks by SIX cyclic
# bytes as two
# 3-byte keys (h=6 head start); a while_loop exits as soon as every row's
# ranks are unique (text resolves long before log2(N) rounds), and the
# resolving round's sort order doubles as the suffix array.
# ---------------------------------------------------------------------------

import functools

# Rank-combination width for the packed (full-row, n<=64K) doubling sort:
# ranks fetched per round at k..(PACKED_WAY-1)k, context ×PACKED_WAY per
# round.  Trace-time constant; not yet measured on the H100.
PACKED_WAY = 8


def encode_batch_fast(blocks: jnp.ndarray, lengths: jnp.ndarray):
    """(B, N) u8 + (B,) i32 -> (L (B, N) u8, origins (B,) i32).

    Same cyclic-rotation BWT as encode_block (oracle parity) — identical
    suffix arrays including periodic ties (stable sorts, index tiebreak).

    The backend table (tpuzip.dist.backend, stage "bwt_forward") picks the
    threaded C++ rotation sort (mkq fast path + SA-IS fallback) or the
    batched lax.sort doubling formulation below; under a jit trace only
    the latter applies.  Both are bit-exact vs the oracle incl. periodic
    ties."""
    import numpy as np

    from tpuzip.dist import backend

    if not isinstance(blocks, jax.core.Tracer) \
            and backend.impl("bwt_forward") == backend.HOST:
        from tpuzip.runtime import native

        L, origins = native.bwt_forward_batch(
            np.asarray(jax.device_get(blocks)),
            np.asarray(jax.device_get(lengths), np.int32))
        return jnp.asarray(L), jnp.asarray(origins)
    all_full = bool((np.asarray(lengths) == blocks.shape[1]).all())
    return _encode_batch_fast(blocks, lengths, all_full)


@functools.partial(jax.jit, static_argnames=("all_full",))
def _encode_batch_fast(blocks: jnp.ndarray, lengths: jnp.ndarray,
                       all_full: bool = False):
    b, n = blocks.shape
    lengths = jnp.asarray(lengths, jnp.int32)
    idx = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None], (b, n))
    valid = idx < lengths[:, None]
    big = jnp.int32(n + 1)
    safe_len = jnp.maximum(lengths, 1)[:, None]
    d = blocks.astype(jnp.int32)

    # initial rank: SIX cyclic bytes as two 3-byte keys (a full 4-byte
    # pack would overflow i32 sign for leading bytes >= 128); h=6 start
    def cyc(k):
        if all_full:  # cyclic shift == roll; avoids a 45M-elem/s gather
            return jnp.roll(d, -k, axis=1)
        return jnp.take_along_axis(d, (idx + k) % safe_len, axis=1)

    # packed mode (round 3): when every row is full and n <= 65536, dense
    # ranks fit 16 bits, so rank PAIRS pack into single u32 sort keys —
    # the doubling sort drops from (4 keys + idx) to (2 keys + idx)
    # operands and every permutation-inversion/final sort becomes a
    # single-key sort ((value << 16) | payload).  lax.sort cost scales
    # with operand count, which is the measured bottleneck (244M keys/s).
    packed = all_full and n <= (1 << 16)
    assert PACKED_WAY in (4, 8, 16) and PACKED_WAY % 2 == 0

    def inv_perm(order_, vals):
        """rank[p] = vals at sorted position of p (permutation inversion
        via sort rather than scatter)."""
        if packed:
            pk = (order_.astype(jnp.uint32) << 16) | vals.astype(jnp.uint32)
            return lax.sort(pk, dimension=1).astype(
                jnp.int32) & jnp.int32(0xFFFF)
        _, out = lax.sort([order_, vals], dimension=1, num_keys=1,
                          is_stable=True)
        return out

    if packed:
        # initial rank: SIXTEEN cyclic bytes as four u32 keys (u32 packing
        # has no sign pitfall) — h=16 start, one fewer doubling round
        h0 = 16
        keys = [(cyc(4 * j).astype(jnp.uint32) << 24)
                | (cyc(4 * j + 1).astype(jnp.uint32) << 16)
                | (cyc(4 * j + 2).astype(jnp.uint32) << 8)
                | cyc(4 * j + 3).astype(jnp.uint32) for j in range(4)]
    else:
        h0 = 12 if all_full else 6
        keys = [(cyc(3 * j) << 16) | (cyc(3 * j + 1) << 8) | cyc(3 * j + 2)
                for j in range(h0 // 3)]
        keys = [jnp.where(valid, kk, jnp.int32(0x7FFFFFFF)) for kk in keys]
    # Full-row mode sorts the PRECEDING byte along as a u8 payload (see
    # the L-carry note below); the roll is only cyclic-correct when every
    # row is full, so ragged batches keep the final gather instead.
    prevb = jnp.roll(blocks, 1, axis=1) if all_full else None
    if all_full:
        *ks, order, lsort0 = lax.sort(keys + [idx, prevb], dimension=1,
                                      num_keys=len(keys), is_stable=True)
    else:
        *ks, order = lax.sort(keys + [idx], dimension=1,
                              num_keys=len(keys), is_stable=True)
        # dead carry: the ragged path never reads the L payload (it keeps
        # the final gather), but the while_loop state arity must match the
        # full-row variant — XLA DCEs the zeros buffer, so no HBM traffic
        lsort0 = jnp.zeros((b, n), jnp.uint8)
    diff = (ks[0][:, 1:] != ks[0][:, :-1])
    for kk in ks[1:]:
        diff = diff | (kk[:, 1:] != kk[:, :-1])
    changed = jnp.concatenate(
        [jnp.ones((b, 1), jnp.int32), diff.astype(jnp.int32)], axis=1)
    ranks_sorted = jnp.cumsum(changed, axis=1) - 1
    rank0 = inv_perm(order, ranks_sorted)
    rank0 = jnp.where(valid, rank0, big)

    def unique_done(rank):
        # ranks are dense 0..m-1 per row; all-unique <=> max rank ==
        # (valid count - 1) in every nonempty row
        mx = jnp.max(jnp.where(rank == big, -1, rank), axis=1)
        cnt = jnp.minimum(lengths, n)
        return jnp.all((mx + 1) == cnt)

    # The rank-at-offset fetch and the permutation inversion are
    # formulated as a roll and a sort rather than gathers and scatters.
    # The roll is exact only when every row is full (cyclic index
    # (i+k) mod len == mod n); ragged batches keep the gather.

    def second_at(rank, k):
        if all_full:
            return jnp.where(valid, jnp.roll(rank, -k, axis=1), big)
        return jnp.where(
            valid, jnp.take_along_axis(rank, (idx + k) % safe_len, axis=1),
            big)

    def cond(state):
        rank, k, done = state
        return (~done) & (k < n)

    # Rank-combination width per round: rolls are ~free when every row is
    # full, so fetch ranks at k, 2k, .., (way-1)k and sort `way` keys —
    # context grows way× per round (log_way rounds) for one extra sort
    # operand per extra way.  Packed mode pairs 16-bit ranks into u32
    # keys, so PACKED_WAY ranks cost PACKED_WAY/2 sort operands; sort
    # volume per context-bit is ~flat in way, but wider rounds mean fewer
    # per-round fixed passes (diff/cumsum/inv_perm/unique_done).
    # Ragged batches pay a gather per way, so they stay at doubling.
    way = (PACKED_WAY if packed else 4) if all_full else 2

    # Full-row mode carries L through the sorts: the BWT output byte for
    # sorted row i is input[sa[i]-1], so sorting the PRECEDING byte along
    # as a u8 payload makes the resolving sort emit L directly — killing
    # the final (B, N) take_along_axis (the gather unit is the slowest
    # path on this target; the extra payload rides the sort's fixed-cost
    # stages instead).  Chip: 52.6 -> 106.1 MB/s at (128, 64 KiB).
    def body(state):
        rank, k, _, _, _ = state
        ranks_at = [rank] + [second_at(rank, k * j)
                             for j in range(1, way)]
        if packed:  # u32 keys carry 16-bit rank PAIRS
            ranks_at = [
                (ranks_at[2 * i].astype(jnp.uint32) << 16)
                | ranks_at[2 * i + 1].astype(jnp.uint32)
                for i in range(way // 2)]
        if all_full:
            *kr, order, lsort = lax.sort(
                ranks_at + [idx, prevb], dimension=1,
                num_keys=len(ranks_at), is_stable=True)
        else:
            *kr, order = lax.sort(ranks_at + [idx], dimension=1,
                                  num_keys=len(ranks_at), is_stable=True)
            lsort = state[4]
        diff = (kr[0][:, 1:] != kr[0][:, :-1])
        for kk in kr[1:]:
            diff = diff | (kk[:, 1:] != kk[:, :-1])
        changed = jnp.concatenate(
            [jnp.ones((b, 1), jnp.int32), diff.astype(jnp.int32)], axis=1)
        rs = jnp.cumsum(changed, axis=1) - 1
        # invert the permutation with a second sort (faster than scatter)
        nr = inv_perm(order, rs)
        nr = jnp.where(valid, nr, big)
        return nr, k * way, unique_done(nr), order, lsort

    def cond(state):  # noqa: F811 — shadows the 3-tuple variant above
        rank, k, done, _, _ = state
        return (~done) & (k < n)

    rank, _, resolved, last_order, last_lsort = lax.while_loop(
        cond, body,
        (rank0, jnp.int32(h0), unique_done(rank0), order, lsort0))
    # when the loop exited resolved, the resolving round's sort order IS
    # the suffix array (sorted by now-unique ranks, idx-stable) and its
    # carried payload IS L; only the periodic-tie exit (k >= n) still
    # pays the final sort
    if packed:
        # periodic-tie exit: single-key sort of (rank << 16) | idx — the
        # low bits ARE the stable index tiebreak
        def tie_sort(args):
            pk = (args[0].astype(jnp.uint32) << 16) \
                | idx.astype(jnp.uint32)
            pks, lt = lax.sort([pk, prevb], dimension=1, num_keys=1,
                               is_stable=True)
            return pks.astype(jnp.int32) & jnp.int32(0xFFFF), lt

        sa, L = lax.cond(resolved, lambda args: (args[1], args[2]),
                         tie_sort, (rank, last_order, last_lsort))
    elif all_full:  # unpacked ranks (n > 64K) but full rows: L still
        # rides the sorts as a payload
        def tie_sort_full(args):
            _, sa_t, lt = lax.sort([args[0], idx, prevb], dimension=1,
                                   num_keys=1, is_stable=True)
            return sa_t, lt

        sa, L = lax.cond(resolved, lambda args: (args[1], args[2]),
                         tie_sort_full, (rank, last_order, last_lsort))
    else:
        sa = lax.cond(
            resolved,
            lambda args: args[1],
            lambda args: lax.sort([args[0], idx], dimension=1, num_keys=1,
                                  is_stable=True)[1],
            (rank, last_order))
        prev = (sa - 1) % safe_len
        L = jnp.where(valid, jnp.take_along_axis(d, prev, axis=1), 0
                      ).astype(jnp.uint8)
    origins = jnp.argmax((sa == 0).astype(jnp.int32), axis=1
                         ).astype(jnp.int32)
    origins = jnp.where(lengths > 0, origins, 0)
    return L, origins


def _walk_rounds(b: int, n: int) -> int:
    """Cost model for the multi-walker inverse: r pointer-doubling rounds
    (each a full (B,N) gather, ~22 ns/elem) buy a 2^r-wide walk whose scan
    costs ~13 us/iteration.  The constants are not yet measured on the
    H100."""
    best_r, best_c = 0, float("inf")
    for r in range(0, 7):
        c = r * (b * n) * 22e-9 + (n / (1 << r)) * 13e-6
        if c < best_c:
            best_r, best_c = r, c
    return best_r


@functools.partial(jax.jit, static_argnames=("walkers_log2",))
def decode_batch_fast(L: jnp.ndarray, origins: jnp.ndarray,
                      lengths: jnp.ndarray, walkers_log2: int = 0):
    """Inverse BWT for a batch: counting sort -> K=2^r parallel walkers per
    block, each emitting every K-th output byte (r doubling rounds build
    the stride-K pointer table; K entry points come from K single steps).
    Replaces the O(N log N) full pointer-doubling orbit fill."""
    b, n = L.shape
    lengths = jnp.asarray(lengths, jnp.int32)
    idx = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None], (b, n))
    valid = idx < lengths[:, None]
    key = jnp.where(valid, L.astype(jnp.int32), jnp.int32(256))
    _, order = lax.sort([key, idx], dimension=1, num_keys=1, is_stable=True)

    K = 1 << walkers_log2
    iters = (n + K - 1) // K
    # entry points: p_w = order^(w+1)(origin), w = 0..K-1
    o0 = jnp.take_along_axis(
        order, jnp.clip(origins, 0, n - 1)[:, None], axis=1)  # (B,1)
    entries = [o0]
    for _ in range(K - 1):
        entries.append(jnp.take_along_axis(order, entries[-1], axis=1))
    p0 = jnp.concatenate(entries, axis=1)                      # (B,K)
    # stride-K pointer table
    step = order
    for _ in range(walkers_log2):
        step = jnp.take_along_axis(step, step, axis=1)

    def body(p, _):
        return jnp.take_along_axis(step, p, axis=1), p

    _, ps = lax.scan(body, p0, None, length=iters)             # (iters,B,K)
    pos = jnp.transpose(ps, (1, 0, 2)).reshape(b, iters * K)[:, :n]
    out = jnp.take_along_axis(L, jnp.clip(pos, 0, n - 1), axis=1)
    return jnp.where(valid, out, 0).astype(jnp.uint8)


def decode_batch_auto(L: jnp.ndarray, origins: jnp.ndarray,
                      lengths: jnp.ndarray, use_extra_memory: bool = True):
    """Inverse BWT for a batch, production path.

    The LF walk is one data-dependent load per output byte; the threaded
    C++ walk serves it on the host the output lands on anyway, and the
    device multi-walker formulation serves it under a jit trace.

    use_extra_memory=False (the reference Decoder's low-memory knob)
    declines the host inversion's 4n-byte aux table and keeps the walk in
    the device formulation's O(B*n) working set instead — same bytes,
    different space/speed point."""
    b, n = L.shape
    import numpy as _np

    if use_extra_memory and not isinstance(L, jax.core.Tracer):
        from tpuzip.runtime import native

        out = native.bwt_inverse_batch(
            _np.asarray(jax.device_get(L)),
            _np.asarray(jax.device_get(lengths), _np.int32),
            _np.asarray(jax.device_get(origins), _np.int32))
        return jnp.asarray(out)
    return decode_batch_fast(L, origins, lengths,
                             walkers_log2=_walk_rounds(b, n))
