"""Parallel bit/byte packing — prefix-sum offset resolution.

The parallel reformulation of every serial "append to the output stream" loop in
the reference: per-token emission sizes -> exclusive ``cumsum`` -> scatter
into a fixed-capacity output buffer (mode='drop' discards masked lanes).
This is the PivCo-Huffman / LZ4-accelerator pattern from PAPERS.md.

All functions are jit/vmap-friendly: static capacities, dynamic lengths.
"""

from __future__ import annotations

import jax.numpy as jnp


def exclusive_cumsum(x: jnp.ndarray) -> jnp.ndarray:
    c = jnp.cumsum(x)
    return jnp.concatenate([jnp.zeros(1, dtype=c.dtype), c[:-1]])


def pack_bytes_varlen_sorted(chunks: jnp.ndarray, lens: jnp.ndarray,
                             cap: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """pack_bytes_varlen via sort-compaction instead of scatter.

    Identical contract; a batched row sort replaces the scatter
    (docs/DESIGN.md).  Valid bytes get
    unique contiguous destination keys 0..total-1, so the stable sort IS
    the compaction; masked bytes all key to `cap` and fall off the slice."""
    import jax

    t, k = chunks.shape
    offs = exclusive_cumsum(lens.astype(jnp.int32))
    col = jnp.arange(k, dtype=jnp.int32)[None, :]
    mask = col < lens[:, None]
    key = jnp.where(mask, offs[:, None] + col, cap).reshape(-1)
    _, b_sorted = jax.lax.sort(
        [key, chunks.reshape(-1).astype(jnp.int32)], num_keys=1,
        is_stable=False)  # keys unique where valid; ties all masked
    total = offs[-1] + lens[-1]
    npad = max(cap - t * k, 0)
    body = jnp.concatenate(
        [b_sorted, jnp.zeros(npad, jnp.int32)])[:cap] if npad else \
        b_sorted[:cap]
    out = jnp.where(jnp.arange(cap) < total, body, 0).astype(jnp.uint8)
    return out, total


def pack_bytes_varlen(chunks: jnp.ndarray, lens: jnp.ndarray,
                      cap: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Concatenate T variable-length byte chunks in parallel.

    chunks: (T, K) u8 — chunk t occupies chunks[t, :lens[t]]
    lens:   (T,) i32
    -> (out (cap,) u8, total i32)
    """
    t, k = chunks.shape
    offs = exclusive_cumsum(lens.astype(jnp.int32))
    col = jnp.arange(k, dtype=jnp.int32)[None, :]
    pos = offs[:, None] + col
    mask = col < lens[:, None]
    pos = jnp.where(mask, pos, cap)  # out-of-range -> dropped
    out = jnp.zeros(cap, dtype=jnp.uint8).at[pos.reshape(-1)].set(
        chunks.reshape(-1), mode="drop")
    return out, offs[-1] + lens[-1]


def bit_reverse(values: jnp.ndarray, nbits: jnp.ndarray,
                max_bits: int) -> jnp.ndarray:
    """Reverse the low ``nbits`` bits of each value (Huffman codes are packed
    MSB-first inside DEFLATE's LSB-first bit stream)."""
    v = values.astype(jnp.uint32)
    r = jnp.zeros_like(v)
    for _ in range(max_bits):
        r = (r << 1) | (v & 1)
        v = v >> 1
    # r now holds the max_bits-wide reversal; shift down to the code width
    return r >> (max_bits - nbits.astype(jnp.uint32))


def pack_bits_lsb(values: jnp.ndarray, nbits: jnp.ndarray, cap_bits: int,
                  max_bits: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pack T bit fields LSB-first into a byte array (RFC 1951 §3.1.1).

    values: (T,) u32 (low nbits[t] bits are the payload, LSB emitted first)
    nbits:  (T,) i32 (0 allowed — field is skipped)
    cap_bits: static output capacity in bits (multiple of 8)
    -> (bytes (cap_bits//8,) u8, total_bits i32)
    """
    assert cap_bits % 8 == 0
    t = values.shape[0]
    offs = exclusive_cumsum(nbits.astype(jnp.int32))
    k = jnp.arange(max_bits, dtype=jnp.int32)[None, :]
    bits = (values.astype(jnp.uint32)[:, None] >> k.astype(jnp.uint32)) & 1
    pos = offs[:, None] + k
    mask = k < nbits[:, None]
    pos = jnp.where(mask, pos, cap_bits)
    bitarr = jnp.zeros(cap_bits, dtype=jnp.uint8).at[pos.reshape(-1)].set(
        bits.reshape(-1).astype(jnp.uint8), mode="drop")
    weights = (1 << jnp.arange(8, dtype=jnp.uint32))
    out = (bitarr.reshape(-1, 8).astype(jnp.uint32) * weights[None, :]).sum(
        axis=1).astype(jnp.uint8)
    return out, offs[-1] + nbits[-1]


def unpack_bits_lsb(data: jnp.ndarray) -> jnp.ndarray:
    """(N,) u8 -> (N*8,) u8 of bits, LSB-first per byte."""
    k = jnp.arange(8, dtype=jnp.uint8)[None, :]
    return ((data[:, None] >> k) & 1).reshape(-1)
