"""tpuzip — a lossless compression framework in JAX.

A from-scratch JAX/XLA re-expression of the codec family of
``rusty-shell/rust-compress`` (LZ4, DEFLATE/zlib, BWT+MTF/DC, RLE, adaptive
arithmetic coding, Adler-32), built for an accelerator:

- each codec operates on *batches of independent blocks* (the data-parallel
  axis of lossless compression), processed in parallel on the device;
- sequential coder state machines (range coder, LZ token scans, MTF) run as
  ``lax.scan`` or one CUDA thread *inside* a block, ``vmap``/``shard_map``
  *across* blocks;
- multi-device / multi-host scaling via ``jax.sharding.Mesh`` with XLA
  collectives (table broadcast over the device interconnect, ordered ragged gather of compressed
  payloads);
- a pure-CPU ``oracle`` package provides the bit-exactness contract
  (validated against system ``zlib`` and ``liblz4``).

See SURVEY.md for the layer map of the reference and the build plan.
"""

__version__ = "0.1.0"

from tpuzip.core.config import CodecConfig, Config  # noqa: F401


def compress(data: bytes, codec: str = "lz4", block_size: int = 1 << 16):
    """One-call corpus compression through the sharded pipeline (tpz)."""
    from tpuzip.dist import runner

    return runner.compress(data, codec=codec, block_size=block_size)


def decompress(container: bytes) -> bytes:
    from tpuzip.dist import runner

    if container[:4] == runner.MAGIC_CORPUS:
        return runner.decompress_corpus(container)
    return runner.decompress(container)


def compress_corpus(data: bytes, codec: str = "lz4",
                    block_size: int = 1 << 16, superbatch: int = 8 << 20,
                    pipeline: int = 2, **kw) -> bytes:
    """Pipelined large-corpus compression: superbatches flow through a
    `pipeline`-deep worker pool so one batch's host stages (threaded C++
    encode/parse, container assembly) overlap the next one's device
    stages.  See dist.runner.compress_corpus."""
    from tpuzip.dist import runner

    return runner.compress_corpus(data, codec=codec, block_size=block_size,
                                  superbatch=superbatch, pipeline=pipeline,
                                  **kw)


def decompress_corpus(blob: bytes, pipeline: int = 2) -> bytes:
    from tpuzip.dist import runner

    return runner.decompress_corpus(blob, pipeline=pipeline)


def compress_from_device(blocks, lengths, codec: str = "lz4", **kw) -> bytes:
    """Compress device-resident (B, n) u8 blocks into a tpz container —
    data leaves the device compressed, never raw.  The inbound half is
    ``runner.decompress(..., to_device=True)``."""
    from tpuzip.dist import runner

    return runner.compress_from_device(blocks, lengths, codec=codec, **kw)


def open(file, mode: str = "rb", format: str = "lz4f", **kw):  # noqa: A001
    """Streaming reader/writer over a binary file object (tpuzip.io)."""
    from tpuzip import io as tio

    if format == "lz4f":
        return tio.Lz4FrameWriter(file, **kw) if "w" in mode \
            else tio.Lz4FrameReader(file)
    if format == "zlib":
        return tio.ZlibWriter(file, **kw) if "w" in mode \
            else tio.ZlibReader(file)
    if format in tio.STREAM_CODECS:
        return tio.CodecWriter(file, format, **kw) if "w" in mode \
            else tio.CodecReader(file, format)
    raise ValueError(f"unknown streaming format {format!r}")
