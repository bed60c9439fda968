"""The ari coder on the GPU: a CUDA kernel (csrc/ari_cuda.cu) called
through `jax.ffi`.

Each ari stream is a serial recurrence (a lookup in a private adaptive
table, a u32 division, a renormalisation of variable length), so a stream
belongs to one thread of the card, its model in shared memory, and the
streams of a batch run in parallel.  The kernel runs the host coder's loop
(csrc/ari_model.h): streams, lengths and chunk indexes are byte-identical
to the threaded C++ coder and to `tpuzip.oracle.ari`.

`encode` and `decode` hold what surrounds the coder — knobs, output shapes,
padding, sharding over the mesh's dp axis — and take the coder as an
argument, so the CPU tests drive them with the plain XLA coder
(`xla_encode` / `xla_decode`, the scans of codecs/ari.py).

The shared library is built from the tracked sources at first use
(`make -C csrc cuda`, inside `load()`, whose time callers report as
set-up).
"""

from __future__ import annotations

import ctypes
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from tpuzip.codecs import ari as jari
from tpuzip.codecs import ari_index

_CSRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                     "csrc"))
_LIB_PATH = os.path.join(_CSRC, "libtpz_cuda.so")
_loaded: dict = {}


class CudaBuildError(RuntimeError):
    """`make -C csrc cuda` failed; the message carries nvcc's output."""


def load() -> None:
    """Build (if its sources changed) and load the CUDA library, and
    register its FFI targets, once per process."""
    if "lib" in _loaded:
        return
    from tpuzip.runtime.native import run_make

    try:
        run_make("cuda")
    except RuntimeError as e:
        raise CudaBuildError(str(e)) from None
    lib = ctypes.CDLL(_LIB_PATH)
    for name, sym in (("tpz_ari_encode", "TpzAriEncode"),
                      ("tpz_ari_decode", "TpzAriDecode")):
        jax.ffi.register_ffi_target(
            name, jax.ffi.pycapsule(getattr(lib, sym)), platform="CUDA")
    _loaded["lib"] = lib


def _attrs(increment: int, threshold: int):
    return dict(increment=np.uint32(increment),
                threshold=np.uint32(threshold))


def cuda_encode(blocks, lengths, increment: int, threshold: int):
    """(B, N) u8 blocks + (B,) i32 lengths -> (streams (B, encode_cap(N))
    u8 zero-padded, stream lengths (B,) i32 (-1: did not fit), chunk
    index (B, NC) i32)."""
    load()
    b, n = blocks.shape
    out = (jax.ShapeDtypeStruct((b, jari.encode_cap(n)), jnp.uint8),
           jax.ShapeDtypeStruct((b,), jnp.int32),
           jax.ShapeDtypeStruct((b, ari_index.num_chunks(n)), jnp.int32))
    return jax.ffi.ffi_call("tpz_ari_encode", out)(
        blocks, lengths.astype(jnp.int32),
        **_attrs(increment, threshold))


def cuda_decode(streams, slens, nsyms, n: int, increment: int,
                threshold: int):
    """(B, W) u8 streams (bytes past slens read as 0) + (B,) i32 stream
    lengths + (B,) i32 symbol counts -> (B, n) u8 symbols, zero past each
    block's count."""
    load()
    out = jax.ShapeDtypeStruct((streams.shape[0], n), jnp.uint8)
    return jax.ffi.ffi_call("tpz_ari_decode", out)(
        streams, slens.astype(jnp.int32), nsyms.astype(jnp.int32),
        **_attrs(increment, threshold))


def xla_encode(blocks, lengths, increment: int, threshold: int):
    """The plain version of cuda_encode: codecs/ari.py's scan, vmapped."""
    comp, clens, counts = jax.vmap(
        lambda bb, ll: jari.encode_with_counts(
            bb, ll, increment=increment, threshold=threshold))(
        blocks, lengths)
    return comp, clens, ari_index.chunk_deltas(counts)


def xla_decode(streams, slens, nsyms, n: int, increment: int,
               threshold: int):
    """The plain version of cuda_decode (reads the zero-padded rows and
    ignores slens)."""
    del slens
    return jax.vmap(lambda c, l: jari.decode(
        c, l, n, increment=increment, threshold=threshold))(streams, nsyms)


def _over_mesh(fn, mesh, in_specs, out_specs):
    if mesh is None:
        return fn
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def encode(blocks, lengths, *, increment: int = 8, threshold: int = 1 << 13,
           coder=None, mesh=None):
    """ari-encode a (B, N) batch with its chunk index, by `coder` (default
    the CUDA kernel).  With `mesh`, each device of the dp axis codes its own
    rows (B divisible by dp).  Returns (streams (B, 2N+64) u8, stream
    lengths (B,) i32, deltas (B, ceil(N/64)) i32)."""
    return _encode(jnp.asarray(blocks, jnp.uint8),
                   jnp.asarray(lengths, jnp.int32), increment, threshold,
                   coder or cuda_encode, mesh)


def decode(streams, slens, nsyms, *, n: int, increment: int = 8,
           threshold: int = 1 << 13, coder=None, mesh=None):
    """Decode (B, W) zero-padded ari streams to (B, n) u8 symbols (zero
    past each block's symbol count), by `coder` (default the CUDA kernel).
    Rows narrower than the 4 code bytes are widened.  With `mesh`, each
    device of the dp axis decodes its own rows."""
    streams = jnp.asarray(streams, jnp.uint8)
    if streams.shape[1] < 4:
        streams = jnp.pad(streams, ((0, 0), (0, 4 - streams.shape[1])))
    return _decode(streams, jnp.asarray(slens, jnp.int32),
                   jnp.asarray(nsyms, jnp.int32), n, increment, threshold,
                   coder or cuda_decode, mesh)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _encode(blocks, lengths, increment, threshold, coder, mesh):
    fn = functools.partial(coder, increment=increment, threshold=threshold)
    fn = _over_mesh(fn, mesh, (P("dp", None), P("dp")),
                    (P("dp", None), P("dp"), P("dp", None)))
    return fn(blocks, lengths)


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6, 7))
def _decode(streams, slens, nsyms, n, increment, threshold, coder, mesh):
    fn = functools.partial(coder, n=n, increment=increment,
                           threshold=threshold)
    fn = _over_mesh(fn, mesh, (P("dp", None), P("dp"), P("dp")),
                    P("dp", None))
    return fn(streams, slens, nsyms)
