"""Checkpoint/resume for long corpus jobs (SURVEY §5).

Blocks are stateless and deterministic, so resume = re-run the missing block
ranges; the result is bitwise-identical to an uninterrupted run.  The
manifest records completed batches and their compressed sizes; payloads are
appended to per-batch part files, concatenated at finalize.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field


@dataclass
class Manifest:
    path: str
    codec: str = ""
    block_size: int = 0
    total_blocks: int = 0
    orig_len: int = 0
    # batch_start -> list of per-block compressed lengths
    completed: dict[int, list[int]] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str) -> "Manifest":
        with open(path) as f:
            d = json.load(f)
        m = cls(path=path, codec=d["codec"], block_size=d["block_size"],
                total_blocks=d["total_blocks"], orig_len=d["orig_len"])
        m.completed = {int(k): v for k, v in d["completed"].items()}
        return m

    def save(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "codec": self.codec, "block_size": self.block_size,
                "total_blocks": self.total_blocks, "orig_len": self.orig_len,
                "completed": {str(k): v for k, v in self.completed.items()},
            }, f)
        os.replace(tmp, self.path)

    def missing_batches(self, batch_blocks: int) -> list[int]:
        return [s for s in range(0, self.total_blocks, batch_blocks)
                if s not in self.completed]

    def is_complete(self, batch_blocks: int) -> bool:
        return not self.missing_batches(batch_blocks)


def run_job(data: bytes, workdir: str | None = None, codec: str = "lz4",
            block_size: int = 1 << 16, batch_blocks: int = 64,
            mesh=None, fail_batches: set[int] | None = None,
            config=None) -> bytes:
    """Resumable compression job.  ``fail_batches`` injects faults (the
    batch raises once, then succeeds on resume) — used by tests.

    Returns the finished tpz container (same bytes as dist.runner.compress
    modulo batching is invisible: per-block outputs are deterministic)."""
    import struct

    import numpy as np
    import jax
    import jax.numpy as jnp

    from tpuzip.core import blocks as blk
    from tpuzip.dist import mesh as meshlib
    from tpuzip.dist.runner import CODECS, MAGIC, _ENCODERS, corpus_adler32

    if workdir is None:
        workdir = getattr(config, "checkpoint_dir", None)
        if workdir is None:
            raise ValueError(
                "run_job needs a workdir (or Config.checkpoint_dir)")
    os.makedirs(workdir, exist_ok=True)
    mpath = os.path.join(workdir, "manifest.json")
    mesh = mesh or meshlib.make_mesh()
    ndp = mesh.shape["dp"]
    blocks, lengths = blk.chunk_padded(data, block_size, ndp)
    B = blocks.shape[0]

    if os.path.exists(mpath):
        man = Manifest.load(mpath)
        assert (man.codec, man.block_size, man.total_blocks) == \
            (codec, block_size, B), "manifest does not match job"
    else:
        man = Manifest(path=mpath, codec=codec, block_size=block_size,
                       total_blocks=B, orig_len=len(data))
        man.save()

    from tpuzip.runtime import native

    host_encoder = codec in ("lz4", "rle", "deflate")
    enc, _ = _ENCODERS[codec]
    enc_jit = jax.jit(enc)
    injected = set(fail_batches or ())

    for start in man.missing_batches(batch_blocks):
        if start in injected:
            injected.discard(start)
            raise RuntimeError(f"injected failure at batch {start}")
        end = min(start + batch_blocks, B)
        bb = blocks[start:end]
        ll = lengths[start:end]
        pad = (-len(bb)) % ndp
        if pad:
            bb = np.concatenate([bb, np.zeros((pad, block_size), np.uint8)])
            ll = np.concatenate([ll, np.zeros(pad, np.int32)])
        if host_encoder:
            # production threaded host encoders (same ones runner.compress
            # uses); per-block outputs stay deterministic, so resume
            # remains bitwise-identical
            if codec == "lz4":
                comp_np, clens_np = native.lz4_compress_batch(bb, ll)
            elif codec == "rle":
                comp_np, clens_np = native.rle_encode_batch(bb, ll)
            else:
                comp_np, clens_np = native.deflate_batch_native(bb, ll)
            clens_np = clens_np[: end - start]
        else:
            comp, clens = enc_jit(jnp.array(bb), jnp.array(ll))
            comp_np = np.asarray(comp)
            clens_np = np.asarray(clens)[: end - start]
        with open(os.path.join(workdir, f"part_{start:08d}.bin"), "wb") as f:
            for i in range(end - start):
                f.write(comp_np[i, : int(clens_np[i])].tobytes())
        man.completed[start] = [int(x) for x in clens_np]
        man.save()

    # finalize: assemble the container in block order
    all_clens: list[int] = []
    for start in sorted(man.completed):
        all_clens.extend(man.completed[start])
    hdr = bytearray(MAGIC)
    hdr.append(CODECS[codec])
    hdr.append(0)
    hdr += struct.pack("<IIQI", block_size, B, len(data), corpus_adler32(data))
    for c in all_clens:
        hdr += struct.pack("<I", c)
    out = bytearray(hdr)
    for start in sorted(man.completed):
        with open(os.path.join(workdir, f"part_{start:08d}.bin"), "rb") as f:
            out += f.read()
    return bytes(out)
