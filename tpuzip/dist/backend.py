"""Which implementation serves each platform-dependent pipeline stage.

The runner and the codecs ask this one table instead of testing the
platform where they stand.  A platform the table does not name is an
error: nothing degrades to another implementation by catching a failure.

Implementations:
  host  the threaded C++ host runtime (tpuzip.runtime.native)
  cuda  the CUDA kernel called through jax.ffi (tpuzip.kernels.ari_cuda)
  xla   the jitted XLA formulation in tpuzip.codecs
"""

from __future__ import annotations

import contextlib

import jax

HOST, CUDA, XLA = "host", "cuda", "xla"

TABLE: dict[str, dict[str, str]] = {
    "cpu": {
        "ari_encode": HOST,
        "ari_decode": HOST,
        "bwt_forward": HOST,
        "mtf": HOST,
        "dc_encode": HOST,
        "dc_decode": HOST,
        "bin_encode": HOST,
    },
    "gpu": {
        "ari_encode": CUDA,
        "ari_decode": CUDA,
        "bwt_forward": XLA,
        "mtf": HOST,
        "dc_encode": HOST,
        "dc_decode": HOST,
        "bin_encode": HOST,
    },
}
STAGES = tuple(TABLE["cpu"])
# The stages with more than one implementation, and what `using` may
# switch them to (measurements compare them; the table holds the measured
# choice).  mtf, dc_* and bin_encode are served by the host on every
# platform.
CHOICES = {"ari_encode": (HOST, CUDA, XLA), "ari_decode": (HOST, CUDA, XLA),
           "bwt_forward": (HOST, XLA)}


class UnsupportedPlatformError(RuntimeError):
    """The backend table has no row for this platform."""


def platform() -> str:
    """The platform of the default device (what `jax.devices()` serves)."""
    return jax.devices()[0].platform


def impl(stage: str, platform_name: str | None = None) -> str:
    """The implementation of `stage` on `platform_name` (default: the
    current platform)."""
    name = platform_name or platform()
    row = TABLE.get(name)
    if row is None:
        raise UnsupportedPlatformError(
            f"no backend for platform {name!r}; tpuzip runs on "
            f"{sorted(TABLE)}")
    if stage not in row:
        raise KeyError(f"unknown pipeline stage {stage!r}")
    return row[stage]


@contextlib.contextmanager
def using(**stages: str):
    """Serve the given stages of the current platform by other
    implementations inside the block, e.g. ``using(ari_encode="xla")``
    to time compress() with the plain XLA coder.  The switch is
    process-wide, so every thread sees it while the block runs."""
    row = TABLE[platform()]
    for stage, choice in stages.items():
        if choice not in CHOICES.get(stage, ()):
            raise ValueError(f"{stage} has no {choice!r} implementation")
    saved = dict(row)
    row.update(stages)
    try:
        yield
    finally:
        row.clear()
        row.update(saved)
