"""Configuration tree for the framework.

The reference's "config surface" is Cargo feature flags plus constructor
parameters (BWT block size, ari model increments/thresholds, LZ4 frame block
size...).  Those knobs are preserved here as dataclass fields; mesh/runtime
knobs are new device-side configuration (SURVEY.md §5 'Config / flag system').
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Lz4Config:
    block_max: int = 1 << 20        # frame BD max block size (64K..4M)
    content_checksum: bool = True
    block_checksum: bool = False
    hash_log: int = 16              # encoder hash table = 2^hash_log entries
    device_encode: bool = False     # force the XLA batch encoder in the
    #                                 runner (default: C++ host encoder)
    max_chain: int = 1              # match-search chain depth: 1 = the
    #                                 reference-identical single-probe
    #                                 greedy; >1 = denser matches, smaller
    #                                 output (same format)


@dataclasses.dataclass
class AriConfig:
    increment: int = 8              # table model frequency increment
    threshold: int = 1 << 13        # downscale-halving threshold
    bin_bits: int = 12              # bin/apm model probability precision
    #                                 (codecs "bin"/"apm"; recorded in the
    #                                 container's flag-4 trailer)
    bin_rate: int = 5               # bin/apm model adaptation shift


@dataclasses.dataclass
class BwtConfig:
    block_size: int = 1 << 20       # reference Encoder block-size knob
    use_extra_memory: bool = True   # reference Decoder knob (fast inverse)


@dataclasses.dataclass
class DeflateConfig:
    mode: str = "dynamic"           # stored | fixed | dynamic
    max_chain: int = 128            # LZ77 hash-chain search depth


@dataclasses.dataclass
class CodecConfig:
    lz4: Lz4Config = dataclasses.field(default_factory=Lz4Config)
    ari: AriConfig = dataclasses.field(default_factory=AriConfig)
    bwt: BwtConfig = dataclasses.field(default_factory=BwtConfig)
    deflate: DeflateConfig = dataclasses.field(default_factory=DeflateConfig)


@dataclasses.dataclass
class MeshConfig:
    """Device mesh shape for the DP-over-blocks pipeline.  (Host count is
    owned by jax.distributed initialization, not config.)"""
    chips_per_host: int = 0         # 0 = all local devices (mesh width)
    block_size: int = 1 << 16       # bytes per independent block (DP grain)
    blocks_per_chip: int = 8        # batch width per device per superbatch
    #                                 step (sizes compress_corpus batches
    #                                 when superbatch is not given)


@dataclasses.dataclass
class Config:
    codec: CodecConfig = dataclasses.field(default_factory=CodecConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    checkpoint_dir: Optional[str] = None
    log_level: str = "info"
