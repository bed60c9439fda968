"""Block segmentation — the load-bearing scaling axis.

The reference scales input length by block segmentation (BWT block-size knob,
LZ4 frame max-block-size); this build turns that into the data-parallel
axis: a corpus becomes a ``(num_blocks, block_size)`` u8 array + a lengths
vector, sharded over the device mesh.  Fixed shapes keep XLA happy; lengths
carry the ragged truth.
"""

from __future__ import annotations

import numpy as np


def chunk(data: bytes, block_size: int) -> tuple[np.ndarray, np.ndarray]:
    """bytes -> (blocks (B, block_size) u8 zero-padded, lengths (B,) i32).

    Empty input yields a single empty block so downstream shapes stay static.
    """
    n = len(data)
    num_blocks = max((n + block_size - 1) // block_size, 1)
    blocks = np.zeros((num_blocks, block_size), dtype=np.uint8)
    lengths = np.zeros(num_blocks, dtype=np.int32)
    arr = np.frombuffer(data, dtype=np.uint8)
    for b in range(num_blocks):
        piece = arr[b * block_size : (b + 1) * block_size]
        blocks[b, : len(piece)] = piece
        lengths[b] = len(piece)
    return blocks, lengths


def unchunk(blocks: np.ndarray, lengths: np.ndarray) -> bytes:
    """Inverse of :func:`chunk` (accepts device or host arrays)."""
    blocks = np.asarray(blocks)
    lengths = np.asarray(lengths)
    return b"".join(
        blocks[b, : int(lengths[b])].tobytes() for b in range(blocks.shape[0])
    )


def pad_to_multiple(num_blocks: int, multiple: int) -> int:
    return ((num_blocks + multiple - 1) // multiple) * multiple


def chunk_padded(data: bytes, block_size: int, multiple: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Like :func:`chunk` but pads the batch dim to a multiple (mesh width);
    padding blocks have length 0 and are dropped by :func:`unchunk`."""
    blocks, lengths = chunk(data, block_size)
    b = blocks.shape[0]
    target = pad_to_multiple(b, multiple)
    if target != b:
        blocks = np.concatenate(
            [blocks, np.zeros((target - b, block_size), np.uint8)], axis=0)
        lengths = np.concatenate([lengths, np.zeros(target - b, np.int32)])
    return blocks, lengths
