"""The fast-decode chunk index of the staged entropy containers.

Every staged ari payload (and every staged bin/apm payload) carries, next
to its stream, the number of stream bytes the coder emitted per chunk of
symbols (CHUNK_STEPS symbols for ari, bin_apm.CHUNK bits for bin/apm).  A
decoder that starts mid-stream positions itself from these deltas; the
bin/apm device decoder builds its per-chunk stream windows from them
(`build_windows`).  Encoders that write the index: the host C++ coder, the
CUDA coder (kernels/ari_cuda.py) and the XLA scan (codecs/ari.py) — all
byte-identical.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

CHUNK_STEPS = 64  # symbols per ari index entry


def num_chunks(n: int, chunk: int = CHUNK_STEPS) -> int:
    return (n + chunk - 1) // chunk


def chunk_deltas(counts, chunk: int = CHUNK_STEPS):
    """Per-symbol renorm byte counts (B, N) -> per-chunk deltas (B, NC) i32,
    the last chunk zero-padded.  Works on numpy and jax arrays."""
    xp = jnp if isinstance(counts, jax.Array) else np
    b, n = counts.shape
    pad = (-n) % chunk
    counts = xp.pad(counts.astype(xp.int32), ((0, 0), (0, pad)))
    return counts.reshape(b, -1, chunk).sum(axis=2).astype(xp.int32)


def pack_chunk_index(deltas: np.ndarray) -> bytes:
    """u8 stream with 255-escape (255, lo, hi) for deltas >= 255."""
    deltas = np.asarray(deltas)
    if deltas.size == 0:
        return b""
    if deltas.max(initial=0) < 255:  # overwhelmingly common: pure u8 cast
        return deltas.astype(np.uint8).tobytes()
    out = bytearray()
    for d in deltas:
        d = int(d)
        if d < 255:
            out.append(d)
        else:
            out += bytes((255, d & 0xFF, d >> 8))
    return bytes(out)


def parse_chunk_index(blob: bytes, nc: int,
                      max_delta: int | None = None) -> np.ndarray:
    if max_delta is None:
        # a chunk can consume at most 4 bytes/symbol + the 4 finish bytes
        max_delta = 4 * CHUNK_STEPS + 4
    if len(blob) == nc and (nc == 0 or b"\xff" not in blob):
        return np.frombuffer(blob, np.uint8).astype(np.int32)
    deltas = np.zeros(nc, np.int32)
    i = 0
    for k in range(nc):
        if i >= len(blob):
            raise ValueError("chunk index truncated")
        d = blob[i]
        i += 1
        if d == 255:
            if i + 2 > len(blob):
                raise ValueError("chunk index truncated")
            d = blob[i] | (blob[i + 1] << 8)
            i += 2
            # anything past the codec's per-chunk bound is corruption
            if d > max_delta:
                raise ValueError(f"chunk delta {d} exceeds {max_delta}")
        deltas[k] = d
    if i != len(blob):
        raise ValueError("chunk index has trailing bytes")
    return deltas


@functools.partial(jax.jit, static_argnames=("w",))
def build_windows(comp: jnp.ndarray, starts: jnp.ndarray, w: int):
    """comp (CAP, L) u8 (zero-padded streams, one per column), starts
    (NC, L) i32 byte positions -> (NC*w, L) u32 windows where window word j
    of chunk k holds stream bytes starts[k]+4j .. +4j+3 big-endian.  The
    threaded C++ `native.ari_build_windows` builds the same words."""
    cap, lanes = comp.shape
    c = jnp.concatenate([comp, jnp.zeros((4, lanes), jnp.uint8)], axis=0)
    cu = c.astype(jnp.uint32)
    sliding = ((cu[:-3] << 24) | (cu[1:-2] << 16)
               | (cu[2:-1] << 8) | cu[3:])                  # (cap+1, L)
    nc = starts.shape[0]
    idx = starts[:, None, :] + 4 * jnp.arange(w, dtype=jnp.int32)[None, :,
                                                                  None]
    idx = jnp.clip(idx, 0, cap).reshape(nc * w, lanes)
    return jnp.take_along_axis(sliding, idx, axis=0)
