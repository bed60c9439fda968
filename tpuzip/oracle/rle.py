"""Run-length encoding — byte-run scheme.

Reference parity: rust-compress ``src/rle.rs`` (repeated-byte pair triggers a
run-count byte).  The exact upstream escape scheme could not be verified
against the mount (empty at survey time — SURVEY.md provenance note), so this
module *defines* the format the device codecs implement:

  - bytes are copied verbatim;
  - whenever two consecutive equal bytes have been emitted, a count byte N
    follows giving the number of ADDITIONAL repeats (beyond the pair);
  - count bytes of 255 are followed by another count byte (unbounded runs).

This is self-delimiting and single-pass in both directions.
"""

from __future__ import annotations

import numpy as np


def encode(data: bytes) -> bytes:
    out = bytearray()
    n = len(data)
    i = 0
    while i < n:
        b = data[i]
        run = 1
        while i + run < n and data[i + run] == b:
            run += 1
        if run == 1:
            out.append(b)
            i += 1
        else:
            out.append(b)
            out.append(b)
            rem = run - 2
            while rem >= 255:
                out.append(255)
                rem -= 255
            out.append(rem)
            i += run
    return bytes(out)


def decode(data: bytes) -> bytes:
    out = bytearray()
    n = len(data)
    i = 0
    prev = -1
    while i < n:
        b = data[i]
        i += 1
        out.append(b)
        if b == prev:
            # count byte(s) follow
            extra = 0
            while True:
                c = data[i]
                i += 1
                extra += c
                if c != 255:
                    break
            out += bytes([b]) * extra
            prev = -1  # the pair + run is consumed; restart pairing
        else:
            prev = b
    return bytes(out)


def runs_of(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """(values, lengths) run decomposition — handy for the vectorized codec."""
    arr = np.frombuffer(data, dtype=np.uint8)
    if arr.size == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    change = np.flatnonzero(np.diff(arr)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [arr.size]])
    return arr[starts], ends - starts
