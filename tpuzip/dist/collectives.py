"""Collective building blocks over the device mesh.

The reference has no communication backend at all; these are the
device-side equivalents (SURVEY §5): XLA collectives over the device
interconnect (NCCL between GPUs).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from tpuzip.core.bitio import exclusive_cumsum


def broadcast_from_zero(mesh: Mesh, x: jnp.ndarray) -> jnp.ndarray:
    """Broadcast device 0's value to every device over the dp axis (the
    'shared Huffman/BWT tables over the interconnect' primitive)."""

    def body(x):
        i = lax.axis_index("dp")
        masked = jnp.where(i == 0, x, jnp.zeros_like(x))
        return lax.psum(masked, axis_name="dp")

    return shard_map(body, mesh=mesh, in_specs=P("dp", None),
                     out_specs=P("dp", None))(x)


def ragged_ordered_gather(mesh: Mesh, comp: jnp.ndarray, lens: jnp.ndarray,
                          cap_total: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Compact per-block payloads into one ordered byte stream.

    comp: (B, CAP) u8 sharded over dp; lens: (B,) i32 sharded over dp.
    Every device packs its local blocks contiguously (prefix-sum pack),
    block sizes are all-gathered to compute global offsets, and payloads are
    placed at their submission-order offsets (all_gather over the interconnect + local
    scatter).  Returns (stream (cap_total,) u8 replicated, total i32).
    """
    b, cap = comp.shape

    def body(comp, lens):
        # local pack
        lens = lens.reshape(-1)
        all_lens = lax.all_gather(lens, "dp")          # (ndp, b_local)
        my = lax.axis_index("dp")
        flat = all_lens.reshape(-1)
        offs = exclusive_cumsum(flat.astype(jnp.int32))
        total = offs[-1] + flat[-1]
        b_local = lens.shape[0]
        my_offs = lax.dynamic_slice(offs, (my * b_local,), (b_local,))
        # scatter local payload bytes to global offsets
        col = jnp.arange(cap, dtype=jnp.int32)[None, :]
        pos = my_offs[:, None] + col
        mask = col < lens[:, None]
        pos = jnp.where(mask, pos, cap_total)
        local = jnp.zeros(cap_total, jnp.uint8).at[pos.reshape(-1)].set(
            comp.reshape(-1), mode="drop")
        # combine across devices (disjoint writes -> sum == union)
        stream = lax.psum(local.astype(jnp.int32), "dp").astype(jnp.uint8)
        return stream[None], total.reshape(1, 1)

    stream, total = shard_map(
        body, mesh=mesh, in_specs=(P("dp", None), P("dp")),
        out_specs=(P("dp", None), P("dp", None)))(comp, lens)
    return stream[0], total[0, 0]


def sharded_adler32(mesh: Mesh, blocks: jnp.ndarray, lengths: jnp.ndarray
                    ) -> jnp.ndarray:
    """Adler-32 with the byte axis sharded over sp: each sp shard computes
    partial (sum, weighted-sum) terms; a psum over sp combines them.
    Demonstrates the intra-block ('sequence parallel') axis with a real
    cross-device collective."""
    B, N = blocks.shape
    MOD = 65521

    def body(blk, ln):
        # blk: (B/dp, N/sp), ln: (B/dp, 1) replicated over sp
        j = lax.axis_index("sp")
        nsp = lax.axis_size("sp")
        ln = ln.reshape(-1)
        shard_n = blk.shape[1]
        base = j * shard_n
        idx = base + jnp.arange(shard_n, dtype=jnp.int32)[None, :]
        data = jnp.where(idx < ln[:, None], blk.astype(jnp.uint32), 0)
        csum = data.sum(axis=1) % MOD
        # weight = (ln - i) mod MOD; products reduced per 4096-chunk
        w = ((ln[:, None] - idx) % MOD).astype(jnp.uint32)
        # 256-element chunks keep (255 * 65520 * 256) < 2^32 pre-mod
        nchunks = max(shard_n // 256, 1)
        dd = data.reshape(data.shape[0], nchunks, -1)
        ww = w.reshape(data.shape[0], nchunks, -1)
        wsum = ((dd * ww).sum(axis=2) % MOD).sum(axis=1) % MOD
        csum_all = lax.psum(csum, "sp")
        wsum_all = lax.psum(wsum, "sp")
        s1 = (1 + csum_all) % MOD
        s2 = ((ln % MOD).astype(jnp.uint32) + wsum_all) % MOD
        return (((s2 << 16) | s1).astype(jnp.uint32))[:, None]

    out = shard_map(body, mesh=mesh,
                    in_specs=(P("dp", "sp"), P("dp", None)),
                    out_specs=P("dp", None))(blocks, lengths[:, None])
    return out[:, 0]
