"""Device codec layer — jit/vmap-friendly encode()/decode() over jnp arrays.

Every codec follows the same contract:

  encode(block (N,) u8, length i32) -> (out (CAP,) u8, out_len i32)
  decode(comp (CAP,) u8, comp_len i32, out_n static) -> (out (N,) u8, len i32)

Batched variants vmap over a leading block axis — the data-parallel axis that
``tpuzip.dist`` shards over the device mesh.  Formats are bit-compatible with
``tpuzip.oracle`` (and hence with system zlib/liblz4 where a public spec
exists).
"""
