"""Pure-CPU (NumPy/stdlib) reference implementations of every codec.

This layer is the *bit-exactness contract*: the formats here are the formats
the device codecs must produce/consume.  Where a public spec exists (LZ4 block
and frame format, DEFLATE RFC 1951, zlib RFC 1950, Adler-32) the oracle is
validated against system ``zlib``/``liblz4``; for the spec-less codecs of the
reference family (BWT framing, MTF, DC, RLE, ari) the oracle *defines* the
format and the device path is validated against it.

Reference parity map (rust-compress, layout per SURVEY.md — line numbers
approximate, mount unavailable at survey time):

- ``adler``   ↔ src/checksum/adler.rs
- ``lz4``     ↔ src/lz4.rs
- ``deflate`` ↔ src/flate.rs   (upstream is decode-only; our encoder is new)
- ``zlib_``   ↔ src/zlib.rs
- ``bwt``     ↔ src/bwt/mod.rs
- ``mtf``     ↔ src/bwt/mtf.rs
- ``dc``      ↔ src/bwt/dc.rs
- ``rle``     ↔ src/rle.rs
- ``ari``     ↔ src/entropy/ari/{mod,table,bin,apm}.rs
"""
