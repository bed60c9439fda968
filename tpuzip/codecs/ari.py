"""Adaptive arithmetic (ari) codec — XLA formulation.

Format: tpuzip.oracle.ari — carryless Subbotin 32-bit range coder + adaptive
order-0 table model (reference parity src/entropy/ari/{mod,table}.rs).

The coder was *designed* for this mapping (SURVEY §7 item 4): all state is
u32, renormalization emits at most MAX_RENORM=4 bytes per symbol with a
monotone emit condition, so one `lax.scan` step per input byte carries
``(low, range, code, in_pos, freq[256], total)`` and produces a fixed-shape
(4,) byte slot + count.  Output compaction is a prefix-sum byte pack.
Batch width across blocks (vmap / shard_map) is where throughput comes from;
the per-block scan replays the oracle bit-exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from tpuzip.core.bitio import pack_bytes_varlen

TOP = jnp.uint32(1 << 24)
BOT = jnp.uint32(1 << 16)
MAX_RENORM = 4


def encode_cap(n: int) -> int:
    # <= 13 bits/symbol with default model (total<=2^13, min freq 1) + tail
    return 2 * n + 64


def _renorm_encode(low, rng):
    """Unrolled carryless renormalization; returns new state + 4 byte slots
    (contiguous valid prefix) + emit count."""
    out_bytes = []
    emits = []
    for _ in range(MAX_RENORM):
        settled = ((low ^ (low + rng)) < TOP)
        force = (~settled) & (rng < BOT)
        rng = jnp.where(force, (-low) & (BOT - jnp.uint32(1)), rng)
        emit = settled | force
        out_bytes.append((low >> 24).astype(jnp.uint8))
        emits.append(emit)
        low = jnp.where(emit, low << 8, low)
        rng = jnp.where(emit, rng << 8, rng)
    return low, rng, jnp.stack(out_bytes), jnp.stack(emits)


def encode(block: jnp.ndarray, length: jnp.ndarray,
           increment: int = 8, threshold: int = 1 << 13,
           cap: int | None = None) -> tuple[jnp.ndarray, jnp.ndarray]:
    """block (N,) u8 -> (out (cap,) u8, out_len i32). Bit-exact vs oracle."""
    out, out_len, _ = encode_with_counts(block, length, increment,
                                         threshold, cap)
    return out, out_len


def encode_with_counts(block: jnp.ndarray, length: jnp.ndarray,
                       increment: int = 8, threshold: int = 1 << 13,
                       cap: int | None = None):
    """encode + per-symbol renorm byte counts (N,) i32 — the raw material
    of the fast-decode chunk index (kernels/range_decoder.py)."""
    n = block.shape[0]
    cap = cap or encode_cap(n)
    length = jnp.asarray(length, jnp.int32)
    inc = jnp.int32(increment)

    def step(state, x):
        low, rng, freq, total = state
        sym, i = x
        valid = i < length
        cum = jnp.cumsum(freq)
        cum_lo = (cum[sym] - freq[sym]).astype(jnp.uint32)
        f = freq[sym].astype(jnp.uint32)
        r = rng // total.astype(jnp.uint32)
        new_low = low + r * cum_lo
        new_rng = r * f
        new_low, new_rng, bytes4, emits4 = _renorm_encode(new_low, new_rng)
        # model update + halving downscale
        new_freq = freq.at[sym].add(inc)
        new_total = total + inc
        do_scale = new_total >= threshold
        scaled = (new_freq + 1) >> 1
        new_freq = jnp.where(do_scale, scaled, new_freq)
        new_total = jnp.where(do_scale, scaled.sum(), new_total)
        # masked lanes leave all state untouched
        low = jnp.where(valid, new_low, low)
        rng = jnp.where(valid, new_rng, rng)
        freq = jnp.where(valid, new_freq, freq)
        total = jnp.where(valid, new_total, total)
        emits4 = emits4 & valid
        return (low, rng, freq, total), (bytes4, emits4)

    init = (jnp.uint32(0), jnp.uint32(0xFFFFFFFF),
            jnp.ones(256, jnp.int32), jnp.int32(256))
    xs = (block.astype(jnp.int32), jnp.arange(n, dtype=jnp.int32))
    (low, rng, _, _), (bytes4, emits4) = lax.scan(step, init, xs)

    # finish(): 4 tail bytes of low
    tail = jnp.stack([(low >> 24).astype(jnp.uint8),
                      (low >> 16).astype(jnp.uint8),
                      (low >> 8).astype(jnp.uint8),
                      low.astype(jnp.uint8)])
    chunks = jnp.concatenate([bytes4, tail[None, :]], axis=0)
    counts = emits4.sum(axis=1).astype(jnp.int32)
    lens = jnp.concatenate([counts, jnp.array([4], jnp.int32)])
    out, out_len = pack_bytes_varlen(chunks, lens, cap)
    return out, out_len, counts


def decode(comp: jnp.ndarray, num_bytes: jnp.ndarray, out_n: int,
           increment: int = 8, threshold: int = 1 << 13
           ) -> jnp.ndarray:
    """comp (CAP,) u8 -> out (out_n,) u8 with the first num_bytes decoded
    symbols valid (mirrors oracle.decode_bytes)."""
    cap = comp.shape[0]
    num_bytes = jnp.asarray(num_bytes, jnp.int32)
    inc = jnp.int32(increment)
    comp_u32 = comp.astype(jnp.uint32)

    code0 = (comp_u32[0] << 24) | (comp_u32[1] << 16) | \
            (comp_u32[2] << 8) | comp_u32[3]

    def step(state, i):
        low, rng, code, in_pos, freq, total = state
        valid = i < num_bytes
        r = rng // total.astype(jnp.uint32)
        v = jnp.minimum((code - low) // r,
                        total.astype(jnp.uint32) - 1).astype(jnp.int32)
        cum = jnp.cumsum(freq)
        sym = jnp.sum((cum <= v).astype(jnp.int32))
        cum_lo = (cum[sym] - freq[sym]).astype(jnp.uint32)
        f = freq[sym].astype(jnp.uint32)
        new_low = low + r * cum_lo
        new_rng = r * f
        new_code = code
        new_pos = in_pos
        for _ in range(MAX_RENORM):
            settled = ((new_low ^ (new_low + new_rng)) < TOP)
            force = (~settled) & (new_rng < BOT)
            new_rng = jnp.where(force, (-new_low) & (BOT - jnp.uint32(1)),
                                new_rng)
            pull = settled | force
            nxt = comp_u32[jnp.clip(new_pos, 0, cap - 1)]
            new_code = jnp.where(pull, (new_code << 8) | nxt, new_code)
            new_pos = jnp.where(pull, new_pos + 1, new_pos)
            new_low = jnp.where(pull, new_low << 8, new_low)
            new_rng = jnp.where(pull, new_rng << 8, new_rng)
        # model update
        new_freq = freq.at[sym].add(inc)
        new_total = total + inc
        do_scale = new_total >= threshold
        scaled = (new_freq + 1) >> 1
        new_freq = jnp.where(do_scale, scaled, new_freq)
        new_total = jnp.where(do_scale, scaled.sum(), new_total)

        low = jnp.where(valid, new_low, low)
        rng = jnp.where(valid, new_rng, rng)
        code = jnp.where(valid, new_code, code)
        in_pos = jnp.where(valid, new_pos, in_pos)
        freq = jnp.where(valid, new_freq, freq)
        total = jnp.where(valid, new_total, total)
        return (low, rng, code, in_pos, freq, total), sym.astype(jnp.uint8)

    init = (jnp.uint32(0), jnp.uint32(0xFFFFFFFF), code0, jnp.int32(4),
            jnp.ones(256, jnp.int32), jnp.int32(256))
    _, syms = lax.scan(step, init, jnp.arange(out_n, dtype=jnp.int32))
    return jnp.where(jnp.arange(out_n) < num_bytes, syms, 0)


encode_batch = jax.vmap(encode, in_axes=(0, 0))
encode_batch_with_counts = jax.vmap(encode_with_counts, in_axes=(0, 0))
decode_batch = jax.vmap(decode, in_axes=(0, 0, None))
