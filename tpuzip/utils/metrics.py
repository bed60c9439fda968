"""Structured per-phase metrics and logging (SURVEY §5 observability).

The reference has no logging at all; production jobs need bytes in/out,
ratio, GB/s per device, blocks/s, and per-phase timings.
"""

from __future__ import annotations

import json
import logging
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

log = logging.getLogger("tpuzip")


def setup_logging(level: str = "info") -> None:
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")


@dataclass
class PhaseMetrics:
    name: str
    seconds: float = 0.0
    bytes_in: int = 0
    bytes_out: int = 0
    blocks: int = 0

    @property
    def gbps(self) -> float:
        return self.bytes_in / self.seconds / 1e9 if self.seconds else 0.0


@dataclass
class RunMetrics:
    phases: dict[str, PhaseMetrics] = field(default_factory=dict)

    @contextmanager
    def phase(self, name: str, bytes_in: int = 0, bytes_out: int = 0,
              blocks: int = 0):
        pm = self.phases.setdefault(name, PhaseMetrics(name))
        t0 = time.perf_counter()
        try:
            yield pm
        finally:
            pm.seconds += time.perf_counter() - t0
            pm.bytes_in += bytes_in
            pm.bytes_out += bytes_out
            pm.blocks += blocks
            log.info("phase %s: %.3fs %.3f GB/s (%d blocks)",
                     name, pm.seconds, pm.gbps, pm.blocks)

    def report(self) -> str:
        return json.dumps({
            n: {"s": round(p.seconds, 4), "in": p.bytes_in,
                "out": p.bytes_out, "GBps": round(p.gbps, 4),
                "blocks": p.blocks}
            for n, p in self.phases.items()})


@contextmanager
def device_timer():
    """Wall-time a device computation (caller must block_until_ready)."""
    t = {}
    t0 = time.perf_counter()
    try:
        yield t
    finally:
        t["seconds"] = time.perf_counter() - t0


def trace(fn, *args, dir: str = "/tmp/tpuzip-trace"):
    """Capture a jax.profiler trace for one call (TensorBoard/Perfetto)."""
    import jax

    with jax.profiler.trace(dir):
        out = fn(*args)
        jax.block_until_ready(out)
    return out
