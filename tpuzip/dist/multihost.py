"""Multi-host execution (BASELINE config 5: enwik9 across N>=2 hosts).

The reference has no distributed machinery at all; this is the device-side
equivalent: `jax.distributed.initialize` + a global ('host','chip'->'dp')
mesh, corpus scatter by block ranges, per-host device encode, and an
ordered gather of ragged compressed payloads over DCN via
`multihost_utils.process_allgather`.

The tests exercise it through its single-process path and through
several CPU processes on one host (tests/test_multihost_mp.py); a
multi-host run needs only coordinator_address wiring.
"""

from __future__ import annotations

import numpy as np

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the multi-host runtime (no-op for single-process runs)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(sp: int = 1):
    """Mesh over every device in the job (all hosts), dp-major."""
    from jax.sharding import Mesh

    devices = np.array(jax.devices())
    n = devices.size
    assert n % sp == 0
    return Mesh(devices.reshape(n // sp, sp), axis_names=("dp", "sp"))


def host_block_range(num_blocks: int) -> tuple[int, int]:
    """Contiguous block range owned by this process (host-sharded corpus)."""
    p = jax.process_index()
    np_ = jax.process_count()
    per = -(-num_blocks // np_)
    start = min(p * per, num_blocks)
    return start, min(start + per, num_blocks)


def allgather_ragged_rows(local_vals: np.ndarray) -> np.ndarray:
    """Ordered gather of ragged per-host 1-D arrays over DCN.

    Every host contributes a (possibly different-length) array; the result
    is the process-order concatenation, identical on every host.  Shapes
    are padded to the max host count first — `process_allgather` needs
    equal shapes across hosts."""
    local_vals = np.asarray(local_vals)
    if jax.process_count() == 1:
        return local_vals
    from jax.experimental import multihost_utils

    counts = multihost_utils.process_allgather(np.int64(local_vals.size))
    max_count = max(int(counts.max()), 1)
    pad = np.zeros(max_count, local_vals.dtype)
    pad[: local_vals.size] = local_vals
    vals_all = multihost_utils.process_allgather(pad)
    return np.concatenate(
        [vals_all[p, : int(counts[p])] for p in range(jax.process_count())])


def gather_ragged_payloads(local_payload: bytes,
                           local_sizes: np.ndarray) -> tuple[bytes, np.ndarray]:
    """Ordered gather of per-host compressed byte blobs over DCN.

    Every host contributes (payload bytes, per-block sizes); the result is
    the submission-order concatenation on every host.  Single-process: the
    identity.  Per-host block counts may be ragged; local device counts must
    be homogeneous across hosts (a jax `process_allgather` requirement)."""
    local_sizes = np.asarray(local_sizes, np.int64)
    if jax.process_count() == 1:
        return local_payload, local_sizes
    sizes = allgather_ragged_rows(local_sizes)
    blob = allgather_ragged_rows(
        np.frombuffer(local_payload, np.uint8)).tobytes()
    return blob, sizes


def compress_corpus_multihost(data: bytes, codec: str = "lz4",
                              block_size: int = 1 << 16,
                              block_checksums: bool = False,
                              config=None, metrics=None) -> bytes:
    """Each host encodes its block range; host 0's view of the gathered
    container is returned (identical on every host).

    The merged container is indistinguishable from a single-host
    ``runner.compress`` container: the local containers' flags byte (staged
    payload bit 2, segmented-bwt bit 8), the per-block checksum table
    (bit 1) and the ari knob trailer (bit 4) are all propagated — every
    host runs the identical codec/config, which is asserted via an
    allgather of the flags bytes."""
    import struct

    from tpuzip.core import blocks as blk
    from tpuzip.dist import mesh as meshlib, runner

    # chunk WITHOUT global padding: the merged container carries the true
    # block count (runner.decompress pads to its own mesh), and each host
    # pads its local range independently (padding truncated before gather).
    blocks, lengths = blk.chunk(data, block_size)
    B = blocks.shape[0]
    lo, hi = host_block_range(B)
    # local encode of the owned range (padded to local device count)
    local_devices = jax.local_devices()
    local_mesh = meshlib.make_mesh(len(local_devices), devices=local_devices)
    if metrics is None:
        from tpuzip.utils.metrics import RunMetrics

        metrics = RunMetrics()
    local_data = blk.unchunk(blocks[lo:hi], lengths[lo:hi])
    with metrics.phase("local_encode", bytes_in=len(local_data),
                       blocks=hi - lo):
        local_container = runner.compress(local_data, codec=codec,
                                          block_size=block_size,
                                          mesh=local_mesh,
                                          block_checksums=block_checksums,
                                          config=config)
    # parse the local header: 4 magic + 1 codec + 1 flags + IIQI(20) = 26
    # bytes, then the u32 length table, then (flags&1) the u32 checksum
    # table, then (flags&4) the 6-byte <HI> ari inc/thr trailer, then the
    # payload.  runner.compress wrote it, so no validation needed here.
    flags = local_container[5]
    (_, local_b) = struct.unpack_from("<II", local_container, 6)
    off = 26 + 4 * local_b
    local_sizes = np.frombuffer(
        local_container, np.uint32, local_b, 26).astype(np.int64)
    local_bsums = np.zeros(0, np.uint32)
    if flags & 1:
        local_bsums = np.frombuffer(local_container, np.uint32, local_b, off)
        off += 4 * local_b
    trailer = b""
    if flags & 4:
        trailer = bytes(local_container[off : off + 6])
        off += 6
    # every host must have produced the same flags/trailer (identical
    # codec + config everywhere) or the merged header would lie about some
    # hosts' payload format — fail loudly rather than corrupt.
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        marks = multihost_utils.process_allgather(
            np.frombuffer(bytes([flags]) + trailer.ljust(6, b"\0"),
                          np.uint8))
        if not (marks == marks[0]).all():
            raise ValueError(
                "compress_corpus_multihost: hosts produced differing "
                "container flags/params — codec config must be identical "
                f"on every host (got {marks.tolist()})")
    # the local runner pads its block range to the local device count;
    # padding blocks (and their payload bytes) must NOT leak into the merged
    # stream — keep only the hi-lo real blocks (padding sits at the tail).
    real = hi - lo
    local_sizes = local_sizes[:real]
    payload_len = int(local_sizes.sum())
    with metrics.phase("dcn_gather", bytes_in=payload_len, blocks=real):
        payload, sizes = gather_ragged_payloads(
            local_container[off : off + payload_len], local_sizes)
        if flags & 1:
            bsums = allgather_ragged_rows(local_bsums[:real])
    hdr = bytearray(runner.MAGIC)
    hdr.append(runner.CODECS[codec])
    hdr.append(flags)
    hdr += struct.pack("<IIQI", block_size, len(sizes), len(data),
                       runner.corpus_adler32(data))
    for s in sizes:
        hdr += struct.pack("<I", int(s))
    if flags & 1:
        for s in bsums:
            hdr += struct.pack("<I", int(s))
    hdr += trailer
    return bytes(hdr) + payload


def decompress_corpus_multihost(container: bytes, config=None,
                                to_device: bool = False):
    """Decode side of config 5: every host decodes ITS contiguous block
    range of one tpz container on its local devices.

    Returns ``(local_bytes_or_blocks, lo_block, hi_block)``.  The corpus
    Adler-32 cannot be checked host-locally, so per-host checksums are
    combined IN ORDER over DCN (oracle.adler.combine == zlib's
    adler32_combine) and verified against the header on every host;
    per-block checksum tables (flag 1) still verify locally."""
    import struct
    import zlib

    from jax.sharding import Mesh

    from tpuzip.dist import mesh as meshlib, runner
    from tpuzip.oracle import adler as oadler
    from tpuzip.runtime.errors import ChecksumError

    if container[:4] != runner.MAGIC:
        raise ValueError("bad tpz magic")
    flags = container[5]
    block_size, B, orig_len, a32 = struct.unpack_from("<IIQI", container, 6)
    off = 26
    clens = np.frombuffer(container, np.uint32, B, off).astype(np.int64)
    off += 4 * B
    bsums = None
    if flags & 1:
        bsums = np.frombuffer(container, np.uint32, B, off)
        off += 4 * B
    trailer = b""
    if flags & 4:
        trailer = bytes(container[off : off + 6])
        off += 6
    starts = off + np.concatenate([[0], np.cumsum(clens)])
    lo, hi = host_block_range(B)
    olens = np.minimum(
        orig_len - np.arange(B, dtype=np.int64) * block_size, block_size)
    olens = np.maximum(olens, 0)
    local_orig = int(olens[lo:hi].sum())

    # rebuild a self-contained sub-container for the local range; the
    # corpus checksum field is zeroed (verified globally below)
    hdr = bytearray(runner.MAGIC)
    hdr.append(container[4])
    hdr.append(flags)
    hdr += struct.pack("<IIQI", block_size, hi - lo, local_orig, 0)
    for i in range(lo, hi):
        hdr += struct.pack("<I", int(clens[i]))
    if bsums is not None:
        for i in range(lo, hi):
            hdr += struct.pack("<I", int(bsums[i]))
    hdr += trailer

    local_err = None
    out = None
    try:
        # fail-loud truncation check (a taxonomy error, not a downstream
        # shape error); inside the try so the collective below is still
        # entered uniformly by every host
        if int(starts[hi]) > len(container):
            from tpuzip.runtime.errors import BlockLengthError

            raise BlockLengthError(
                f"truncated container: host block range [{lo},{hi}) needs "
                f"payload through byte {int(starts[hi])}, container has "
                f"{len(container)}")
        local_container = bytes(hdr) + container[starts[lo] : starts[hi]]
        local_devices = jax.local_devices()
        local_mesh = meshlib.make_mesh(len(local_devices),
                                       devices=local_devices)
        out = runner.decompress(local_container, mesh=local_mesh,
                                config=config, to_device=to_device)
    except Exception as e:
        # a host that raises BEFORE the global-checksum allgather would
        # deadlock every peer inside the collective — record the failure
        # and route it THROUGH the collective as a sentinel instead
        local_err = e
    if to_device:
        if local_err is not None:
            raise local_err  # no collective pending on the device path
        blocks, out_olens, _ = out
        local_bytes = None
        local_sum = None  # device path: caller owns verification timing
    else:
        local_bytes = out if local_err is None else b""
        local_sum = zlib.adler32(local_bytes) if local_err is None else -1

    # ordered global checksum: allgather per-host rows and fold with the
    # combine identity; a host-local failure rides the allgather as an
    # ok=0 sentinel so every peer raises a taxonomy error instead of
    # hanging.  Every gathered component stays < 2^31: without
    # jax_enable_x64 the allgather silently downcasts int64 -> int32, so
    # a raw adler >= 2^31 would arrive negative on every peer (it did:
    # sum 2557003930 gathered as -1737963366 and tripped a false
    # RemoteDecodeError) — the adler travels as its two u16 halves and
    # the length as (lo30, hi) limbs
    if local_sum is not None:
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            from tpuzip.runtime.errors import RemoteDecodeError

            ok = 0 if local_err is not None else 1
            nloc = len(local_bytes)
            rows = multihost_utils.process_allgather(
                np.array([ok, local_sum & 0xFFFF, local_sum >> 16,
                          nloc & 0x3FFFFFFF, nloc >> 30], np.int32))
            bad = [p for p in range(jax.process_count())
                   if int(rows[p, 0]) == 0]
            if bad:
                if local_err is not None:
                    raise local_err
                raise RemoteDecodeError(bad)
            total = 1
            for p in range(jax.process_count()):
                psum = int(rows[p, 1]) | (int(rows[p, 2]) << 16)
                plen = int(rows[p, 3]) | (int(rows[p, 4]) << 30)
                total = oadler.combine(total, psum, plen)
        else:
            if local_err is not None:
                raise local_err
            total = oadler.combine(1, local_sum, len(local_bytes))
        if a32 and total != a32:
            raise ChecksumError(
                f"corpus Adler-32 mismatch after distributed decode: "
                f"{total:#x} != {a32:#x}")
    if to_device:
        return (blocks, out_olens, local_orig), lo, hi
    return local_bytes, lo, hi
