"""Distributed execution: mesh construction, sharded codec pipelines,
collective utilities, and the multi-host runner.

The reference is single-threaded; this layer is new device-side
machinery (SURVEY §2 parallelism checklist): data parallelism over
independent blocks (`dp` axis), an intra-block "sequence parallel" axis
(`sp`) for width-parallel stages (checksums, histograms), XLA collectives
over the device interconnect for table broadcast and size exchange, an
ordered ragged gather for compressed payloads, and the backend table
(`backend.py`) that picks each stage's implementation per platform.
"""
