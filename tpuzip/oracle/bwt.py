"""Burrows–Wheeler transform (block-wise) with streaming block framing.

Reference parity: rust-compress ``src/bwt/mod.rs`` (ALPHABET_SIZE=0x100,
compute_suffixes + TransformIterator forward, compute_inversion_table +
InverseIterator LF-walk inverse, Encoder/Decoder block framing).

Semantics: the classic **cyclic-rotation BWT** — sort all n rotations of the
block, output the last column plus ``origin`` (the sorted position of
rotation 0).  The inverse is the standard counting-sort "next array" walk,
which is exactly the reference's inversion-table scheme.

Forward sort here uses prefix doubling over cyclic ranks (O(n log n) with
``numpy.lexsort``) — the same algorithm the device path expresses with
``jax.lax.sort`` rounds, so both sides produce identical suffix arrays.

Block framing (defined here; mount was empty so the upstream field order is
unverifiable): per block ``[n: u32 LE][origin: u32 LE][L: n bytes]``.
"""

from __future__ import annotations

import struct

import numpy as np

ALPHABET_SIZE = 0x100
DEFAULT_BLOCK = 1 << 20


def rotation_sort(data: np.ndarray) -> np.ndarray:
    """Indices of cyclic rotations in lexicographic order (prefix doubling)."""
    n = len(data)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rank = data.astype(np.int64)
    k = 1
    idx = np.arange(n, dtype=np.int64)
    while k < n:
        # cyclic second key
        second = rank[(idx + k) % n]
        order = np.lexsort((second, rank))
        key_r = rank[order]
        key_s = second[order]
        new_rank = np.empty(n, dtype=np.int64)
        changed = np.ones(n, dtype=bool)
        changed[1:] = (key_r[1:] != key_r[:-1]) | (key_s[1:] != key_s[:-1])
        new_rank[order] = np.cumsum(changed) - 1
        rank = new_rank
        if rank.max() == n - 1:
            break
        k <<= 1
    return np.argsort(rank, kind="stable").astype(np.int64)


def encode_block(block: bytes) -> tuple[bytes, int]:
    """-> (last column L, origin)."""
    data = np.frombuffer(block, dtype=np.uint8)
    n = len(data)
    if n == 0:
        return b"", 0
    sa = rotation_sort(data)
    L = data[(sa - 1) % n]
    origin = int(np.nonzero(sa == 0)[0][0])
    return L.tobytes(), origin


def decode_block(last_col: bytes, origin: int) -> bytes:
    """Inverse BWT via counting sort + next-array walk (reference scheme)."""
    L = np.frombuffer(last_col, dtype=np.uint8)
    n = len(L)
    if n == 0:
        return b""
    # next[i]: the row in sorted order that follows row i's rotation.
    # Stable-sort positions of L gives, for each first-column slot, its source
    # row in L — the classic inversion table.
    order = np.argsort(L, kind="stable").astype(np.int64)
    out = np.empty(n, dtype=np.uint8)
    p = order[origin]
    for i in range(n):
        out[i] = L[p]
        p = order[p]
    return out.tobytes()


def decode_block_fast(last_col: bytes, origin: int) -> bytes:
    """Vectorized inverse: materialize the walk via repeated gather doubling."""
    L = np.frombuffer(last_col, dtype=np.uint8)
    n = len(L)
    if n == 0:
        return b""
    order = np.argsort(L, kind="stable").astype(np.int64)
    # pointer-doubling: pos[i] = order applied i+1 times to origin
    pos = np.empty(n, dtype=np.int64)
    pos[0] = order[origin]
    step = order.copy()
    filled = 1
    while filled < n:
        take = min(filled, n - filled)
        pos[filled : filled + take] = step[pos[:take]]
        step = step[step] if filled * 2 < n else step
        filled += take
    return L[pos].tobytes()


def encode(data: bytes, block_size: int = DEFAULT_BLOCK) -> bytes:
    out = bytearray()
    for ofs in range(0, max(len(data), 1), block_size):
        block = data[ofs : ofs + block_size]
        if not block and ofs > 0:
            break
        L, origin = encode_block(block)
        out += struct.pack("<II", len(L), origin)
        out += L
    return bytes(out)


def decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        n, origin = struct.unpack_from("<II", data, i)
        i += 8
        L = data[i : i + n]
        if len(L) != n:
            raise ValueError("truncated BWT block")
        i += n
        out += decode_block(L, origin)
    return bytes(out)
