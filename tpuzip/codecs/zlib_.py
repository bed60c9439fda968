"""zlib container (RFC 1950) over the deflate codec.

Reference parity: rust-compress src/zlib.rs (header parse, Adler-32 check).
The Adler-32 runs on device (core.checksum); header assembly is 2 bytes.
"""

from __future__ import annotations

import struct

import numpy as np

import jax.numpy as jnp

from tpuzip.codecs import deflate as jdeflate
from tpuzip.core.checksum import adler32


def compress(data: bytes, n_static: int | None = None) -> bytes:
    cmf = 0x78
    flg = 0
    rem = (cmf * 256 + flg) % 31
    if rem:
        flg += 31 - rem
    body = jdeflate.deflate(data, n_static=n_static)
    n = max(len(data), 1)
    arr = np.zeros(n, np.uint8)
    arr[: len(data)] = np.frombuffer(data, np.uint8)
    a32 = int(adler32(jnp.array(arr), jnp.int32(len(data))))
    return bytes([cmf, flg]) + body + struct.pack(">I", a32)


def decompress(data: bytes, out_n: int) -> bytes:
    if len(data) < 6:
        raise ValueError("zlib stream too short")
    cmf, flg = data[0], data[1]
    if cmf & 0x0F != 8:
        raise ValueError("unsupported compression method (CM != 8)")
    if (cmf * 256 + flg) % 31 != 0:
        raise ValueError("zlib header FCHECK failed")
    if flg & 0x20:
        raise ValueError("FDICT preset dictionaries unsupported")
    out = jdeflate.inflate(data[2:-4], out_n)
    (expect,) = struct.unpack(">I", data[-4:])
    n = max(len(out), 1)
    arr = np.zeros(n, np.uint8)
    arr[: len(out)] = np.frombuffer(out, np.uint8)
    actual = int(adler32(jnp.array(arr), jnp.int32(len(out))))
    if expect != actual:
        raise ValueError(f"Adler-32 mismatch: {expect:#x} != {actual:#x}")
    return out
