"""Move-to-front — XLA formulation (reference parity src/bwt/mtf.rs).

State is the *rank permutation* ``rank_of[sym]`` (256,), updated wholly
vectorized per step: symbols cheaper than the hit get +1, the hit goes to 0.
One `lax.scan` step per byte, O(256) vector work — vmapped across blocks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def encode(block: jnp.ndarray, length: jnp.ndarray) -> jnp.ndarray:
    n = block.shape[0]
    length = jnp.asarray(length, jnp.int32)

    def step(rank_of, x):
        sym, i = x
        valid = i < length
        r = rank_of[sym]
        new_rank = jnp.where(rank_of < r, rank_of + 1, rank_of).at[sym].set(0)
        rank_of = jnp.where(valid, new_rank, rank_of)
        return rank_of, jnp.where(valid, r, 0).astype(jnp.uint8)

    xs = (block.astype(jnp.int32), jnp.arange(n, dtype=jnp.int32))
    _, out = lax.scan(step, jnp.arange(256, dtype=jnp.int32), xs)
    return out


def decode(block: jnp.ndarray, length: jnp.ndarray) -> jnp.ndarray:
    n = block.shape[0]
    length = jnp.asarray(length, jnp.int32)

    def step(rank_of, x):
        r, i = x
        valid = i < length
        # symbol whose rank is r (ranks form a permutation)
        sym = jnp.argmax(rank_of == r).astype(jnp.int32)
        new_rank = jnp.where(rank_of < r, rank_of + 1, rank_of).at[sym].set(0)
        rank_of = jnp.where(valid, new_rank, rank_of)
        return rank_of, jnp.where(valid, sym, 0).astype(jnp.uint8)

    xs = (block.astype(jnp.int32), jnp.arange(n, dtype=jnp.int32))
    _, out = lax.scan(step, jnp.arange(256, dtype=jnp.int32), xs)
    return out


encode_batch = jax.vmap(encode, in_axes=(0, 0))
decode_batch = jax.vmap(decode, in_axes=(0, 0))
