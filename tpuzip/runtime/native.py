"""ctypes bindings to the C++ host runtime (csrc/libtpz_host.so).

The library is built from the tracked sources by `make -C csrc` on first
use in every process, so a library older than its sources is rebuilt; a
failed build raises NativeBuildError with make's output.  The threaded
host stages here serve container framing and every codec stage the
backend table (tpuzip.dist.backend) assigns to the host.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import sys

import numpy as np

_CSRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                     "csrc"))
_LIB_PATH = os.path.join(_CSRC, "libtpz_host.so")
_lib = None


class NativeBuildError(RuntimeError):
    """`make -C csrc` failed; the message carries its output."""


def run_make(target: str = "all") -> None:
    """Run `make -C csrc <target>` under a lock shared by every process of
    this checkout (test workers build concurrently)."""
    with open(os.path.join(_CSRC, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        r = subprocess.run(["make", "-C", _CSRC, target,
                            f"PYTHON={sys.executable}"],
                           capture_output=True, text=True)
    if r.returncode != 0:
        raise NativeBuildError(
            f"make -C csrc {target} failed (exit {r.returncode}):\n"
            f"{r.stdout[-4000:]}{r.stderr[-8000:]}")


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    run_make()
    lib = ctypes.CDLL(_LIB_PATH)
    i64, u32, u8p, i32p = (ctypes.c_int64, ctypes.c_uint32,
                           ctypes.POINTER(ctypes.c_uint8),
                           ctypes.POINTER(ctypes.c_int32))
    lib.tpz_adler32.restype = u32
    lib.tpz_adler32.argtypes = [u8p, i64, u32]
    lib.tpz_xxh32.restype = u32
    lib.tpz_xxh32.argtypes = [u8p, i64, u32]
    lib.tpz_xxh32_stripes.restype = None
    lib.tpz_xxh32_stripes.argtypes = [ctypes.POINTER(ctypes.c_uint32),
                                      u8p, i64]
    for name in ("tpz_lz4_decompress", "tpz_rle_encode", "tpz_rle_decode"):
        fn = getattr(lib, name)
        fn.restype = i64
        fn.argtypes = [u8p, i64, u8p, i64]
    lib.tpz_lz4_compress.restype = i64
    lib.tpz_lz4_compress.argtypes = [u8p, i64, u8p, i64, ctypes.c_int]
    lib.tpz_ari_encode.restype = i64
    lib.tpz_ari_encode.argtypes = [u8p, i64, u8p, i64, u32, u32]
    lib.tpz_ari_decode.restype = i64
    lib.tpz_ari_decode.argtypes = [u8p, i64, u8p, i64, u32, u32]
    lib.tpz_lz4_decode_plan.restype = i64
    lib.tpz_lz4_decode_plan.argtypes = [u8p, i64, i32p, i64]
    lib.tpz_lz4_decode_wplan.restype = i64
    lib.tpz_lz4_decode_wplan.argtypes = [u8p, i64, i32p, u8p, i64, i64,
                                         ctypes.POINTER(ctypes.c_int64)]
    for nm in ("tpz_lz4_decode_wplan8", "tpz_lz4_decode_wplan16"):
        getattr(lib, nm).restype = i64
        getattr(lib, nm).argtypes = lib.tpz_lz4_decode_wplan.argtypes
    lib.tpz_deflate_fragment.restype = i64
    lib.tpz_deflate_fragment.argtypes = [u8p, i64, u8p, i64, ctypes.c_int,
                                         ctypes.c_int]
    lib.tpz_deflate_fragment_batch.restype = None
    lib.tpz_deflate_fragment_batch.argtypes = [u8p, i64, i64, i32p, u8p,
                                               i64,
                                               ctypes.POINTER(
                                                   ctypes.c_int64),
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int]
    lib.tpz_inflate.restype = i64
    lib.tpz_inflate.argtypes = [u8p, i64, u8p, i64]
    lib.tpz_inflate_plan.restype = i64
    lib.tpz_inflate_plan.argtypes = [u8p, i64, i32p, u8p, i64,
                                     ctypes.POINTER(ctypes.c_int64)]
    lib.tpz_deflate.restype = i64
    lib.tpz_deflate.argtypes = [u8p, i64, u8p, i64, ctypes.c_int,
                                ctypes.c_int]
    i64p, c_int = ctypes.POINTER(ctypes.c_int64), ctypes.c_int
    lib.tpz_lz4_compress_batch.restype = None
    lib.tpz_lz4_compress_batch.argtypes = [u8p, i64, i64, i32p, u8p, i64,
                                           i64p, c_int, c_int]
    lib.tpz_lz4_decode_wplan_batch.restype = None
    lib.tpz_lz4_decode_wplan_batch.argtypes = [u8p, i64, i64, i32p, i32p,
                                               i64, u8p, i64, i64, i64p,
                                               i64p, c_int]
    lib.tpz_lz4_compress_chained.restype = i64
    lib.tpz_lz4_compress_chained.argtypes = [u8p, i64, u8p, i64, c_int,
                                             c_int]
    lib.tpz_lz4_compress_chained_batch.restype = None
    lib.tpz_lz4_compress_chained_batch.argtypes = [u8p, i64, i64, i32p,
                                                   u8p, i64, i64p, c_int,
                                                   c_int, c_int]
    lib.tpz_lz4_decode_wplan8_batch.restype = None
    lib.tpz_lz4_decode_wplan8_batch.argtypes = [u8p, i64, i64, i32p, i32p,
                                                i64, u8p, i64, i64, i64p,
                                                i64p, c_int]
    lib.tpz_lz4p_encode_batch.restype = None
    lib.tpz_lz4p_encode_batch.argtypes = [u8p, i64, i64, i32p, u8p, i64,
                                          i64p, c_int, c_int]
    lib.tpz_lz4p_decode_batch.restype = None
    lib.tpz_lz4p_decode_batch.argtypes = [u8p, i64, i64, i32p, u8p, i64,
                                          i64p, c_int]
    lib.tpz_lz4_decompress_batch.restype = None
    lib.tpz_lz4_decompress_batch.argtypes = [u8p, i64, i64, i32p, u8p, i64,
                                             i64p, c_int]
    lib.tpz_lz4_decode_wplan16_batch.restype = None
    lib.tpz_lz4_decode_wplan16_batch.argtypes = [u8p, i64, i64, i32p, i32p,
                                                 i64, u8p, i64, i64, i64p,
                                                 i64p, c_int]
    lib.tpz_ari_encode_indexed_batch.restype = None
    lib.tpz_ari_encode_indexed_batch.argtypes = [u8p, i64, i64, i32p, u8p,
                                                 i64, i64p, i32p, i64, u32,
                                                 u32, c_int]
    lib.tpz_ari_decode_batch.restype = None
    lib.tpz_ari_decode_batch.argtypes = [u8p, i64, i64, i32p, u8p, i64,
                                         i32p, u32, u32, c_int]
    lib.tpz_bin_encode_batch.restype = None
    lib.tpz_bin_encode_batch.argtypes = [u8p, i64, i64, i32p, u8p, i64,
                                         i64p, c_int, c_int, c_int, c_int,
                                         c_int]
    lib.tpz_bin_encode_indexed_batch.restype = None
    lib.tpz_bin_encode_indexed_batch.argtypes = [u8p, i64, i64, i32p, u8p,
                                                 i64, i64p, i32p, i64,
                                                 c_int, c_int, c_int,
                                                 c_int, c_int]
    lib.tpz_bin_decode_batch.restype = None
    lib.tpz_bin_decode_batch.argtypes = [u8p, i64, i64, i32p, u8p, i64,
                                         i32p, c_int, c_int, c_int, c_int,
                                         c_int]
    lib.tpz_mtf_batch.restype = None
    lib.tpz_mtf_batch.argtypes = [u8p, i64, i64, i32p, u8p, c_int, c_int]
    lib.tpz_dc_encode_batch.restype = None
    lib.tpz_dc_encode_batch.argtypes = [u8p, i64, i64, i32p, u8p, i64,
                                        i64p, c_int]
    lib.tpz_dc_decode_batch.restype = None
    lib.tpz_dc_decode_batch.argtypes = [u8p, i64, i64, i32p, u8p, i64,
                                        i64p, c_int]
    lib.tpz_rle_encode_batch.restype = None
    lib.tpz_rle_encode_batch.argtypes = [u8p, i64, i64, i32p, u8p, i64,
                                         i64p, c_int]
    lib.tpz_rle_decode_batch.restype = None
    lib.tpz_rle_decode_batch.argtypes = [u8p, i64, i64, i32p, u8p, i64,
                                         i64p, c_int]
    lib.tpz_deflate_batch.restype = None
    lib.tpz_deflate_batch.argtypes = [u8p, i64, i64, i32p, u8p, i64, i64p,
                                      c_int, c_int, c_int]
    lib.tpz_inflate_batch.restype = None
    lib.tpz_inflate_batch.argtypes = [u8p, i64, i64, i32p, u8p, i64, i64p,
                                      c_int]
    lib.tpz_inflate_plan_batch.restype = None
    lib.tpz_inflate_plan_batch.argtypes = [u8p, i64, i64, i32p, i32p, u8p,
                                           i64, i64p, i64p, c_int]
    lib.tpz_bwt_forward_batch.restype = None
    lib.tpz_bwt_forward_batch.argtypes = [u8p, i64, i64, i32p, u8p, i32p,
                                          c_int]
    lib.tpz_bwt_inverse_batch.restype = None
    lib.tpz_bwt_inverse_batch.argtypes = [u8p, i64, i64, i32p, i32p, u8p,
                                          c_int]
    lib.tpz_ari_build_windows.restype = None
    lib.tpz_ari_build_windows.argtypes = [u8p, i64, i64, i32p, i64, c_int,
                                          ctypes.POINTER(ctypes.c_uint32),
                                          c_int]
    lib.tpz_pack_payloads.restype = i64
    lib.tpz_pack_payloads.argtypes = [u8p, i64, i64, i32p, u8p, i64]
    lib.tpz_unpack_payloads.restype = i64
    lib.tpz_unpack_payloads.argtypes = [u8p, i64, i32p, i64, u8p, i64]
    _lib = lib
    return lib


def available() -> bool:
    """True once the library is built and loaded (a failed build raises)."""
    return get_lib() is not None


def _contig(arr, dtype) -> np.ndarray:
    """C-contiguous array of the given dtype.  np.ascontiguousarray and
    same-dtype .astype take a pathological per-element route for large
    strided u8 slices (31 MB/s vs 3 GB/s for .copy()); route through
    .copy() on the matching-dtype path."""
    a = np.asarray(arr)
    if a.dtype != np.dtype(dtype):
        a = a.astype(dtype)        # rare, small arrays in practice
    elif not a.flags.c_contiguous:
        a = a.copy()
    return a


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def adler32(data: bytes, start: int = 1) -> int:
    lib = get_lib()
    arr = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    return int(lib.tpz_adler32(_u8(arr), len(data), start))


def xxh32(data: bytes, seed: int = 0) -> int:
    lib = get_lib()
    arr = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    return int(lib.tpz_xxh32(_u8(arr), len(data), seed))


def xxh32_stripes(v: np.ndarray, data: bytes, nstripes: int) -> None:
    """Bulk 16-byte-stripe update for streaming xxh32: v is the (4,) u32
    lane state, updated in place (tail/total bookkeeping stays with the
    caller — core.checksum.Xxh32Stream)."""
    lib = get_lib()
    arr = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    lib.tpz_xxh32_stripes(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), _u8(arr),
        nstripes)


def _run2(name: str, data: bytes, cap: int, *extra) -> bytes:
    lib = get_lib()
    src = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    dst = np.zeros(cap, np.uint8)
    n = getattr(lib, name)(_u8(src), len(data), _u8(dst), cap, *extra)
    if n < 0:
        raise ValueError(f"{name} failed")
    return dst[:n].tobytes()


def lz4_compress(data: bytes, hash_log: int = 16) -> bytes:
    return _run2("tpz_lz4_compress", data,
                 len(data) + len(data) // 255 + 64, hash_log)


def lz4_decompress(data: bytes, out_cap: int) -> bytes:
    return _run2("tpz_lz4_decompress", data, out_cap)


def lz4_decode_plan(data: bytes, out_cap: int) -> np.ndarray:
    """Parse an LZ4 block at host speed into the per-byte copy plan:
    plan[i] = compressed-stream literal position that output byte i copies
    from (matches resolved transitively).  Returns plan[:out_len] i32."""
    lib = get_lib()
    src = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    plan = np.zeros(max(out_cap, 1), np.int32)
    n = lib.tpz_lz4_decode_plan(_u8(src), len(data), _i32(plan), out_cap)
    if n < 0:
        raise ValueError("tpz_lz4_decode_plan failed (corrupt stream)")
    return plan[:n]


def lz4_decode_wplan(data: bytes, out_cap: int,
                     patch_cap: int | None = None):
    """Word-granular LZ4 copy plan (half the device gather elements of
    lz4_decode_plan): one i32 per output word — a compressed-stream byte
    address for contiguous words, or -(patch_offset+1) for boundary words
    materialized into the returned patch buffer.  Returns
    (wplan i32[ceil(out_len/4)], patch u8[patch_used], out_len).
    Raises ValueError on corrupt streams; OverflowError when the patch
    budget is exceeded (caller falls back to the byte plan)."""
    lib = get_lib()
    src = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    if patch_cap is None:
        # every word patched in the worst case (dense token boundaries on
        # short-match text); the full budget keeps the word path available
        # there — the device gather count is halved regardless
        patch_cap = out_cap + 64
    patch_cap = (patch_cap + 3) & ~3
    wplan = np.zeros(max((out_cap + 3) // 4, 1), np.int32)
    patch = np.zeros(max(patch_cap, 4), np.uint8)
    used = ctypes.c_int64(0)
    n = lib.tpz_lz4_decode_wplan(_u8(src), len(data), _i32(wplan),
                                 _u8(patch), out_cap, patch_cap,
                                 ctypes.byref(used))
    if n == -2:
        raise OverflowError("tpz_lz4_decode_wplan patch budget exceeded")
    if n < 0:
        raise ValueError("tpz_lz4_decode_wplan failed (corrupt stream)")
    return wplan[: (n + 3) // 4], patch[: used.value], n


def _wplan_wide(fname: str, width: int, data: bytes, out_cap: int,
                patch_cap: int | None):
    """Shared scalar driver for the dword (8B) / quad (16B) plan builders —
    same contract as lz4_decode_wplan at a wider window granularity."""
    lib = get_lib()
    src = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    if patch_cap is None:
        patch_cap = out_cap + width + 64
    patch_cap = (patch_cap + width - 1) & ~(width - 1)
    wplan = np.zeros(max((out_cap + width - 1) // width, 1), np.int32)
    patch = np.zeros(max(patch_cap, width), np.uint8)
    used = ctypes.c_int64(0)
    n = getattr(lib, fname)(_u8(src), len(data), _i32(wplan), _u8(patch),
                            out_cap, patch_cap, ctypes.byref(used))
    if n == -2:
        raise OverflowError(f"{fname} patch budget exceeded")
    if n < 0:
        raise ValueError(f"{fname} failed (corrupt stream)")
    return wplan[: (n + width - 1) // width], patch[: used.value], n


def lz4_decode_wplan8(data: bytes, out_cap: int,
                      patch_cap: int | None = None):
    """Scalar dword-granular (8-byte) LZ4 copy plan; see
    lz4_decode_wplan8_batch for the threaded production entry point."""
    return _wplan_wide("tpz_lz4_decode_wplan8", 8, data, out_cap, patch_cap)


def lz4_decode_wplan16(data: bytes, out_cap: int,
                       patch_cap: int | None = None):
    """Scalar quad-granular (16-byte) LZ4 copy plan; see
    lz4_decode_wplan16_batch for the threaded production entry point."""
    return _wplan_wide("tpz_lz4_decode_wplan16", 16, data, out_cap,
                       patch_cap)


def _i64(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def lz4_compress_batch(blocks: np.ndarray, lengths: np.ndarray,
                       nthreads: int = 0, max_chain: int = 1,
                       hash_log: int = 16):
    """Compress B block rows in parallel across cores.  blocks: (B, n) u8,
    lengths: (B,) valid bytes per row.  Returns (comp (B, dcap) u8,
    clens (B,) i64).  max_chain=1 is the reference-identical single-probe
    greedy; >1 searches a bounded hash chain for denser matches (same
    format, strictly smaller-or-equal output).  Raises on any per-block
    failure."""
    lib = get_lib()
    blocks = _contig(blocks, np.uint8)
    b, n = blocks.shape
    lens = _contig(lengths, np.int32)
    dcap = n + n // 255 + 64
    dst = np.zeros((b, dcap), np.uint8)
    out = np.zeros(b, np.int64)
    if max_chain > 1:
        lib.tpz_lz4_compress_chained_batch(_u8(blocks), b, n, _i32(lens),
                                           _u8(dst), dcap, _i64(out),
                                           max_chain, hash_log, nthreads)
    else:
        lib.tpz_lz4_compress_batch(_u8(blocks), b, n, _i32(lens), _u8(dst),
                                   dcap, _i64(out), hash_log, nthreads)
    if (out < 0).any():
        raise ValueError("lz4_compress_batch failed")
    return dst, out


def lz4_decode_wplan_batch(comp: np.ndarray, clens: np.ndarray,
                           out_cap: int, patch_cap: int | None = None,
                           nthreads: int = 0, strict: bool = True):
    """Parse B compressed rows into word-granular copy plans in parallel.
    comp: (B, scap) u8 rows, clens: (B,) stream bytes per row.  Returns
    (wplans (B, nw) i32, patches (B, pcap) u8, out_lens (B,) i64,
    patch_used (B,) i64).  strict=True raises ValueError on corrupt
    streams / OverflowError on patch-budget overflow; strict=False leaves
    the per-block status codes (-1 corrupt, -2 overflow) in out_lens for
    the caller's corruption-isolation machinery."""
    lib = get_lib()
    comp = _contig(comp, np.uint8)
    b, scap = comp.shape
    lens = _contig(clens, np.int32)
    if patch_cap is None:
        patch_cap = out_cap + 64
    patch_cap = (patch_cap + 3) & ~3
    nw = max((out_cap + 3) // 4, 1)
    wplans = np.zeros((b, nw), np.int32)
    patches = np.zeros((b, patch_cap), np.uint8)
    out = np.zeros(b, np.int64)
    used = np.zeros(b, np.int64)
    lib.tpz_lz4_decode_wplan_batch(_u8(comp), b, scap, _i32(lens),
                                   _i32(wplans), nw, _u8(patches),
                                   patch_cap, out_cap, _i64(out),
                                   _i64(used), nthreads)
    if strict:
        if (out == -2).any():
            raise OverflowError(
                "lz4_decode_wplan_batch patch budget exceeded")
        if (out < 0).any():
            raise ValueError(
                "lz4_decode_wplan_batch failed (corrupt stream)")
    return wplans, patches, out, used


def lz4_decode_wplan8_batch(comp: np.ndarray, clens: np.ndarray,
                            out_cap: int, patch_cap: int | None = None,
                            nthreads: int = 0, strict: bool = True):
    """Dword-granular (8-byte) LZ4 copy plans in parallel: half the device
    gather rows of lz4_decode_wplan_batch.  Same contract/statuses."""
    lib = get_lib()
    comp = _contig(comp, np.uint8)
    b, scap = comp.shape
    lens = _contig(clens, np.int32)
    if patch_cap is None:
        patch_cap = out_cap + 64
    patch_cap = (patch_cap + 7) & ~7
    nw = max((out_cap + 7) // 8, 1)
    wplans = np.zeros((b, nw), np.int32)
    patches = np.zeros((b, patch_cap), np.uint8)
    out = np.zeros(b, np.int64)
    used = np.zeros(b, np.int64)
    lib.tpz_lz4_decode_wplan8_batch(_u8(comp), b, scap, _i32(lens),
                                    _i32(wplans), nw, _u8(patches),
                                    patch_cap, out_cap, _i64(out),
                                    _i64(used), nthreads)
    if strict:
        if (out == -2).any():
            raise OverflowError("wplan8 patch budget exceeded")
        if (out < 0).any():
            raise ValueError("wplan8 failed (corrupt stream)")
    return wplans, patches, out, used


def lz4p_encode_batch(blocks: np.ndarray, lengths: np.ndarray,
                      nthreads: int = 0, hash_log: int = 16):
    """Threaded columnar-LZ encode (codecs/lz4p format; greedy
    single-probe parse).  Returns (comp (B, dcap) u8, clens (B,) i64)."""
    lib = get_lib()
    blocks = _contig(blocks, np.uint8)
    b, n = blocks.shape
    lens = _contig(lengths, np.int32)
    dcap = 8 + 6 * (n // 4 + 2) + n + 64
    dst = np.zeros((b, dcap), np.uint8)
    out = np.zeros(b, np.int64)
    lib.tpz_lz4p_encode_batch(_u8(blocks), b, n, _i32(lens), _u8(dst),
                              dcap, _i64(out), hash_log, nthreads)
    if (out < 0).any():
        raise ValueError("lz4p_encode_batch failed")
    return dst, out


def lz4p_decode_batch_native(comp: np.ndarray, clens: np.ndarray,
                             out_cap: int, nthreads: int = 0):
    """Threaded columnar-LZ decode.  Returns (out (B, out_cap) u8,
    stat (B,) i64 — decoded length, negative on corrupt streams)."""
    lib = get_lib()
    comp = _contig(comp, np.uint8)
    b, scap = comp.shape
    lens = _contig(clens, np.int32)
    dst = np.zeros((b, out_cap), np.uint8)
    out = np.zeros(b, np.int64)
    lib.tpz_lz4p_decode_batch(_u8(comp), b, scap, _i32(lens), _u8(dst),
                              out_cap, _i64(out), nthreads)
    return dst, out


def lz4_decompress_batch(comp: np.ndarray, clens: np.ndarray,
                         out_cap: int, nthreads: int = 0):
    """Threaded full LZ4 decode over B rows.  Returns (out (B, out_cap)
    u8, stat (B,) i64 — decoded length, negative on corrupt streams)."""
    lib = get_lib()
    comp = _contig(comp, np.uint8)
    b, scap = comp.shape
    lens = _contig(clens, np.int32)
    dst = np.zeros((b, out_cap), np.uint8)
    out = np.zeros(b, np.int64)
    lib.tpz_lz4_decompress_batch(_u8(comp), b, scap, _i32(lens), _u8(dst),
                                 out_cap, _i64(out), nthreads)
    return dst, out


def lz4_decode_wplan16_batch(comp: np.ndarray, clens: np.ndarray,
                             out_cap: int, patch_cap: int | None = None,
                             nthreads: int = 0, strict: bool = True):
    """Quad-word (16-byte) LZ4 copy plans in parallel: quarter the device
    gather rows of lz4_decode_wplan_batch.  Same contract/statuses."""
    lib = get_lib()
    comp = _contig(comp, np.uint8)
    b, scap = comp.shape
    lens = _contig(clens, np.int32)
    if patch_cap is None:
        # the run-based parse patches consecutive windows as one span, so
        # patch bytes are bounded by 16*ceil(out/16) <= out+15 (the old
        # byte-plan builder could double them); the tighter budget halves
        # the device virtual table — the wplan16 gather was table-size
        # bound at 2*out (342 vs 369 MB/s for wplan8 despite half the rows)
        patch_cap = out_cap + 80
    patch_cap = (patch_cap + 15) & ~15
    nw = max((out_cap + 15) // 16, 1)
    wplans = np.zeros((b, nw), np.int32)
    patches = np.zeros((b, patch_cap), np.uint8)
    out = np.zeros(b, np.int64)
    used = np.zeros(b, np.int64)
    lib.tpz_lz4_decode_wplan16_batch(_u8(comp), b, scap, _i32(lens),
                                     _i32(wplans), nw, _u8(patches),
                                     patch_cap, out_cap, _i64(out),
                                     _i64(used), nthreads)
    if strict:
        if (out == -2).any():
            raise OverflowError("wplan16 patch budget exceeded")
        if (out < 0).any():
            raise ValueError("wplan16 failed (corrupt stream)")
    return wplans, patches, out, used


def rle_encode_batch(blocks: np.ndarray, lengths: np.ndarray,
                     nthreads: int = 0):
    """RLE-encode B block rows in parallel.  Returns (comp (B, dcap) u8,
    clens (B,) i64)."""
    lib = get_lib()
    blocks = _contig(blocks, np.uint8)
    b, n = blocks.shape
    lens = _contig(lengths, np.int32)
    dcap = 2 * n + 16
    dst = np.zeros((b, dcap), np.uint8)
    out = np.zeros(b, np.int64)
    lib.tpz_rle_encode_batch(_u8(blocks), b, n, _i32(lens), _u8(dst), dcap,
                             _i64(out), nthreads)
    if (out < 0).any():
        raise ValueError("rle_encode_batch failed")
    return dst, out


def rle_decode_batch(comp: np.ndarray, clens: np.ndarray, out_cap: int,
                     nthreads: int = 0):
    """RLE-decode B compressed rows in parallel.  Returns
    (out (B, out_cap) u8, out_lens (B,) i64 — negative = corrupt row,
    left to the caller's corruption-isolation machinery)."""
    lib = get_lib()
    comp = _contig(comp, np.uint8)
    b, scap = comp.shape
    lens = _contig(clens, np.int32)
    dst = np.zeros((b, out_cap), np.uint8)
    out = np.zeros(b, np.int64)
    lib.tpz_rle_decode_batch(_u8(comp), b, scap, _i32(lens), _u8(dst),
                             out_cap, _i64(out), nthreads)
    return dst, out


def deflate_batch_native(blocks: np.ndarray, lengths: np.ndarray,
                         max_chain: int = 64, nthreads: int = 0,
                         mode: str = "dynamic"):
    """Deflate B block rows in parallel across cores.  Returns
    (comp (B, dcap) u8, clens (B,) i64)."""
    lib = get_lib()
    blocks = _contig(blocks, np.uint8)
    b, n = blocks.shape
    lens = _contig(lengths, np.int32)
    dcap = 2 * n + 4096
    dst = np.zeros((b, dcap), np.uint8)
    out = np.zeros(b, np.int64)
    lib.tpz_deflate_batch(_u8(blocks), b, n, _i32(lens), _u8(dst), dcap,
                          _i64(out), max_chain, DEFLATE_MODES[mode],
                          nthreads)
    if (out < 0).any():
        raise ValueError("deflate_batch_native failed")
    return dst, out


def inflate_batch_native(comp: np.ndarray, clens: np.ndarray, out_cap: int,
                         nthreads: int = 0):
    """Inflate B compressed rows in parallel.  Returns
    (out (B, out_cap) u8, out_lens (B,) i64)."""
    lib = get_lib()
    comp = _contig(comp, np.uint8)
    b, scap = comp.shape
    lens = _contig(clens, np.int32)
    dst = np.zeros((b, out_cap), np.uint8)
    out = np.zeros(b, np.int64)
    lib.tpz_inflate_batch(_u8(comp), b, scap, _i32(lens), _u8(dst),
                          out_cap, _i64(out), nthreads)
    if (out < 0).any():
        raise ValueError("inflate_batch_native failed (corrupt stream)")
    return dst, out


def inflate_plan_batch(comp: np.ndarray, clens: np.ndarray, out_cap: int,
                       nthreads: int = 0):
    """Huffman-parse B deflate rows into copy plans in parallel.  Returns
    (plans (B, out_cap) i32, lits (B, out_cap) u8, out_lens, nlits)."""
    lib = get_lib()
    comp = _contig(comp, np.uint8)
    b, scap = comp.shape
    lens = _contig(clens, np.int32)
    plans = np.zeros((b, out_cap), np.int32)
    lits = np.zeros((b, out_cap), np.uint8)
    out = np.zeros(b, np.int64)
    nlits = np.zeros(b, np.int64)
    lib.tpz_inflate_plan_batch(_u8(comp), b, scap, _i32(lens), _i32(plans),
                               _u8(lits), out_cap, _i64(out), _i64(nlits),
                               nthreads)
    if (out < 0).any():
        raise ValueError("inflate_plan_batch failed (corrupt stream)")
    return plans, lits, out, nlits


def ari_encode_indexed_batch(blocks: np.ndarray, lengths: np.ndarray,
                             nc: int, increment: int = 8,
                             threshold: int = 1 << 13, nthreads: int = 0):
    """Threaded adaptive-ari encode with the fast-decode chunk index
    (bit-exact streams AND deltas vs the CUDA coder / XLA scan).
    Returns (comp (B, dcap) u8, clens (B,) i64, deltas (B, nc) i32)."""
    lib = get_lib()
    blocks = np.asarray(blocks)
    lens = _contig(lengths, np.int32)
    if (blocks.dtype == np.uint8 and blocks.ndim == 2
            and blocks.strides[1] == 1
            and blocks.strides[0] >= blocks.shape[1]):
        # row-contiguous view (e.g. the bwtdc DC buffer sliced to the
        # bucketed ari width): pass the parent row stride straight to the
        # C++ side instead of materializing a 100+ MB contiguous copy
        cap = blocks.strides[0]
    else:
        blocks = _contig(blocks, np.uint8)
        cap = blocks.shape[1]
    b = blocks.shape[0]
    # size the output by the real symbol counts, not the row capacity
    dcap = 2 * int(lens.max(initial=1)) + 64
    dst = np.zeros((b, dcap), np.uint8)
    out = np.zeros(b, np.int64)
    deltas = np.zeros((b, nc), np.int32)
    lib.tpz_ari_encode_indexed_batch(
        _u8(blocks), b, cap, _i32(lens), _u8(dst), dcap, _i64(out),
        deltas.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), nc,
        increment, threshold, nthreads)
    if (out < 0).any():
        raise ValueError("ari_encode_indexed_batch failed")
    return dst, out, deltas


def ari_decode_batch_native(comp: np.ndarray, clens: np.ndarray,
                            num_syms: np.ndarray, out_cap: int,
                            increment: int = 8, threshold: int = 1 << 13,
                            nthreads: int = 0) -> np.ndarray:
    """Threaded adaptive-ari decode (sequential per block; the chunk
    index is a device-side acceleration and is not needed here)."""
    lib = get_lib()
    comp = _contig(comp, np.uint8)
    b, cap = comp.shape
    lens = _contig(clens, np.int32)
    ns = _contig(num_syms, np.int32)
    dst = np.zeros((b, out_cap), np.uint8)
    lib.tpz_ari_decode_batch(_u8(comp), b, cap, _i32(lens), _u8(dst),
                             out_cap, _i32(ns), increment, threshold,
                             nthreads)
    return dst


def bin_encode_batch_native(blocks: np.ndarray, lengths: np.ndarray,
                            bits: int = 12, rate: int = 5,
                            use_apm: bool = False, apm_rate: int = 5,
                            nthreads: int = 0):
    """Threaded byte-level bin/apm encode (MSB-first bits; bit-exact vs
    codecs.bin_apm).  Returns (comp, clens)."""
    lib = get_lib()
    blocks = _contig(blocks, np.uint8)
    b, cap = blocks.shape
    lens = _contig(lengths, np.int32)
    dcap = 4 * cap + 64
    dst = np.zeros((b, dcap), np.uint8)
    out = np.zeros(b, np.int64)
    lib.tpz_bin_encode_batch(_u8(blocks), b, cap, _i32(lens), _u8(dst),
                             dcap, _i64(out), bits, rate,
                             1 if use_apm else 0, apm_rate, nthreads)
    if (out < 0).any():
        raise ValueError("bin_encode_batch failed")
    return dst, out


def bin_encode_indexed_batch(blocks: np.ndarray, lengths: np.ndarray,
                             bits: int = 12, rate: int = 5,
                             use_apm: bool = False, apm_rate: int = 5,
                             nthreads: int = 0):
    """bin_encode_batch + the per-256-bit-chunk consumed-byte index the
    chunk-indexed lane decoder needs.  Returns (comp, clens, deltas
    (B, NC))."""
    lib = get_lib()
    blocks = _contig(blocks, np.uint8)
    b, cap = blocks.shape
    lens = _contig(lengths, np.int32)
    dcap = 4 * cap + 64
    nc = max((8 * cap + 255) // 256, 1)
    dst = np.zeros((b, dcap), np.uint8)
    out = np.zeros(b, np.int64)
    deltas = np.zeros((b, nc), np.int32)
    lib.tpz_bin_encode_indexed_batch(
        _u8(blocks), b, cap, _i32(lens), _u8(dst), dcap, _i64(out),
        _i32(deltas), nc, bits, rate, 1 if use_apm else 0, apm_rate,
        nthreads)
    if (out < 0).any():
        raise ValueError("bin_encode_indexed_batch failed")
    return dst, out, deltas


def bin_decode_batch_native(comp: np.ndarray, clens: np.ndarray,
                            num_bytes: np.ndarray, out_cap: int,
                            bits: int = 12, rate: int = 5,
                            use_apm: bool = False, apm_rate: int = 5,
                            nthreads: int = 0) -> np.ndarray:
    lib = get_lib()
    comp = _contig(comp, np.uint8)
    b, cap = comp.shape
    lens = _contig(clens, np.int32)
    nb = _contig(num_bytes, np.int32)
    dst = np.zeros((b, out_cap), np.uint8)
    lib.tpz_bin_decode_batch(_u8(comp), b, cap, _i32(lens), _u8(dst),
                             out_cap, _i32(nb), bits, rate,
                             1 if use_apm else 0, apm_rate, nthreads)
    return dst


def mtf_batch(blocks: np.ndarray, lengths: np.ndarray,
              decode: bool = False, nthreads: int = 0) -> np.ndarray:
    """Threaded move-to-front over B block rows (bit-exact vs
    tpuzip.oracle.mtf both directions)."""
    lib = get_lib()
    blocks = _contig(blocks, np.uint8)
    b, cap = blocks.shape
    lens = _contig(lengths, np.int32)
    dst = np.zeros((b, cap), np.uint8)
    lib.tpz_mtf_batch(_u8(blocks), b, cap, _i32(lens), _u8(dst),
                      1 if decode else 0, nthreads)
    return dst


def dc_encode_batch(blocks: np.ndarray, lengths: np.ndarray,
                    nthreads: int = 0):
    """Threaded distance-coding encode (oracle.dc format).  Returns
    (comp (B, dcap) u8, clens (B,) i64)."""
    lib = get_lib()
    blocks = _contig(blocks, np.uint8)
    b, cap = blocks.shape
    lens = _contig(lengths, np.int32)
    dcap = 4 + 256 * 4 + 5 * cap + 16
    dst = np.zeros((b, dcap), np.uint8)
    out = np.zeros(b, np.int64)
    lib.tpz_dc_encode_batch(_u8(blocks), b, cap, _i32(lens), _u8(dst),
                            dcap, _i64(out), nthreads)
    if (out < 0).any():
        raise ValueError("dc_encode_batch failed")
    return dst, out


def dc_decode_batch(comp: np.ndarray, clens: np.ndarray, out_cap: int,
                    nthreads: int = 0):
    """Threaded distance-coding decode.  Returns (out (B, out_cap) u8,
    stat (B,) i64 — decoded length, or negative on corrupt streams)."""
    lib = get_lib()
    comp = _contig(comp, np.uint8)
    b, cap = comp.shape
    lens = _contig(clens, np.int32)
    dst = np.zeros((b, out_cap), np.uint8)
    out = np.zeros(b, np.int64)
    lib.tpz_dc_decode_batch(_u8(comp), b, cap, _i32(lens), _u8(dst),
                            out_cap, _i64(out), nthreads)
    return dst, out


def bwt_forward_batch(blocks: np.ndarray, lengths: np.ndarray,
                      nthreads: int = 0):
    """Forward BWT for B block rows in parallel (SA-IS rotation sort,
    oracle tie rule).  blocks: (B, cap) u8, lengths: (B,) i32.
    Returns (L (B, cap) u8, origins (B,) i32)."""
    lib = get_lib()
    blocks = _contig(blocks, np.uint8)
    b, cap = blocks.shape
    lens = _contig(lengths, np.int32)
    L = np.zeros((b, cap), np.uint8)
    origins = np.zeros(b, np.int32)
    lib.tpz_bwt_forward_batch(_u8(blocks), b, cap, _i32(lens), _u8(L),
                              _i32(origins), nthreads)
    return L, origins


def bwt_inverse_batch(L: np.ndarray, lengths: np.ndarray,
                      origins: np.ndarray, nthreads: int = 0) -> np.ndarray:
    """Inverse BWT for B block rows in parallel (counting-sort inversion
    table + LF walk, same scheme as oracle.bwt.decode_block).  L: (B, cap)
    u8 rows, lengths/origins: (B,) i32.  Returns (B, cap) u8."""
    lib = get_lib()
    L = _contig(L, np.uint8)
    b, cap = L.shape
    lens = _contig(lengths, np.int32)
    orgs = _contig(origins, np.int32)
    out = np.zeros((b, cap), np.uint8)
    lib.tpz_bwt_inverse_batch(_u8(L), b, cap, _i32(lens), _i32(orgs),
                              _u8(out), nthreads)
    return out


def ari_build_windows(streams: np.ndarray, deltas: np.ndarray, w: int,
                      nthreads: int = 0) -> np.ndarray:
    """Build the chunk-indexed lane decoder's per-chunk windows at host
    memcpy speed.  streams: (B, cap) u8 rows (zero-padded), deltas:
    (B, NC) i32 per-chunk consumed bytes.  Returns (B, NC*w) u32
    big-endian-packed window words (lane-major; the device transposes to
    the decoder's (NC*w, lanes) layout).  Matches
    codecs.ari_index.build_windows bit for bit."""
    lib = get_lib()
    streams = _contig(streams, np.uint8)
    deltas = _contig(deltas, np.int32)
    b, cap = streams.shape
    nc = deltas.shape[1]
    out = np.zeros((b, nc * w), np.uint32)
    lib.tpz_ari_build_windows(
        _u8(streams), b, cap, _i32(deltas), nc, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), nthreads)
    return out


DEFLATE_MODES = {"dynamic": 0, "fixed": 1, "stored": 2}


def deflate(data: bytes, max_chain: int = 64,
            mode: str = "dynamic") -> bytes:
    """RFC 1951 encoder (greedy hash-chain LZ77 + package-merge dynamic
    Huffman, or fixed/stored block types); streams accepted by stock
    zlib.  Production host encode for the deflate container — the device
    bulk stages are the XLA formulation."""
    return _run2("tpz_deflate", data, 2 * len(data) + 4096, max_chain,
                 DEFLATE_MODES[mode])


def deflate_fragment(data: bytes, max_chain: int = 64,
                     mode: str = "dynamic") -> bytes:
    """Non-final deflate fragment ending byte-aligned (an empty BFINAL=0
    stored block — Z_SYNC_FLUSH): fragments from independent calls splice
    into one stock-zlib-accepted stream (the ZlibWriter batching path)."""
    return _run2("tpz_deflate_fragment", data, 2 * len(data) + 4096,
                 max_chain, DEFLATE_MODES[mode])


def deflate_fragment_batch(blocks: np.ndarray, lengths: np.ndarray,
                           max_chain: int = 64, nthreads: int = 0,
                           mode: str = "dynamic"):
    """Threaded batch of byte-aligned non-final deflate fragments.
    Returns (comp (B, dcap) u8, clens (B,) i64)."""
    lib = get_lib()
    blocks = _contig(blocks, np.uint8)
    b, n = blocks.shape
    lens = _contig(lengths, np.int32)
    dcap = 2 * n + 4096
    dst = np.zeros((b, dcap), np.uint8)
    out = np.zeros(b, np.int64)
    lib.tpz_deflate_fragment_batch(_u8(blocks), b, n, _i32(lens), _u8(dst),
                                   dcap, _i64(out), max_chain,
                                   DEFLATE_MODES[mode], nthreads)
    if (out < 0).any():
        raise ValueError("deflate_fragment_batch failed")
    return dst, out


def inflate(data: bytes, out_cap: int) -> bytes:
    """RFC 1951 inflate at host speed (production decode for the deflate
    container; the device symbol loop is the XLA formulation)."""
    return _run2("tpz_inflate", data, out_cap)


def inflate_plan(data: bytes, out_cap: int):
    """Host bit-serial Huffman -> (plan i32[:out_len], lits u8[:nlit]):
    out[i] = lits[plan[i]].  The device materializes the output with one
    bulk gather (codecs.deflate.inflate_batch_planned)."""
    lib = get_lib()
    src = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    plan = np.zeros(max(out_cap, 1), np.int32)
    lits = np.zeros(max(out_cap, 1), np.uint8)
    nl = ctypes.c_int64(0)
    n = lib.tpz_inflate_plan(_u8(src), len(data), _i32(plan), _u8(lits),
                             out_cap, ctypes.byref(nl))
    if n < 0:
        raise ValueError("tpz_inflate_plan failed (corrupt stream)")
    return plan[:n], lits[: nl.value]


def rle_encode(data: bytes) -> bytes:
    return _run2("tpz_rle_encode", data, 2 * len(data) + 16)


def rle_decode(data: bytes, out_cap: int) -> bytes:
    return _run2("tpz_rle_decode", data, out_cap)


def ari_encode(data: bytes, increment: int = 8,
               threshold: int = 1 << 13) -> bytes:
    return _run2("tpz_ari_encode", data, 2 * len(data) + 64,
                 increment, threshold)


def ari_decode(data: bytes, num_syms: int, increment: int = 8,
               threshold: int = 1 << 13) -> bytes:
    lib = get_lib()
    src = np.frombuffer(data, np.uint8) if data else np.zeros(1, np.uint8)
    dst = np.zeros(max(num_syms, 1), np.uint8)
    n = lib.tpz_ari_decode(_u8(src), len(data), _u8(dst), num_syms,
                           increment, threshold)
    if n < 0:
        raise ValueError("ari decode failed")
    return dst[:num_syms].tobytes()


def pack_payloads(comp: np.ndarray, lens: np.ndarray) -> bytes:
    lib = get_lib()
    comp = _contig(comp, np.uint8)
    lens = _contig(lens, np.int32)
    cap = int(lens.astype(np.int64).sum())
    dst = np.zeros(max(cap, 1), np.uint8)
    n = lib.tpz_pack_payloads(_u8(comp), comp.shape[0], comp.shape[1],
                              _i32(lens), _u8(dst), cap)
    if n < 0:
        raise ValueError("pack_payloads overflow")
    return dst[:n].tobytes()


def unpack_payloads(stream: bytes, lens: np.ndarray, cap: int) -> np.ndarray:
    lib = get_lib()
    lens = _contig(lens, np.int32)
    b = lens.shape[0]
    src = np.frombuffer(stream, np.uint8) if stream else np.zeros(1, np.uint8)
    comp = np.zeros((b, cap), np.uint8)
    n = lib.tpz_unpack_payloads(_u8(src), len(stream), _i32(lens), b,
                                _u8(comp), cap)
    if n < 0:
        raise ValueError("unpack_payloads failed")
    return comp
