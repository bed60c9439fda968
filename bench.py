"""Benchmark of tpuzip on one NVIDIA GPU: prints ONE JSON line.

On the seeded 4096 x 64 KiB corpus of chip_smoke.py it times

  ari   the CUDA coder (encode, decode; device arrays in and out) and
        compress / decompress end to end;
  lz4   compress (threaded host encoder) / decompress to host,
        compress_from_device (XLA device encoder) and
        decompress(to_device=True);
  bwt   the forward transform at 128 x 64 KiB, XLA sort formulation
        and threaded host C++ (the backend table's "bwt_forward" choice).

Each time is the best of three warm calls ending in block_until_ready;
first calls, which compile, are reported apart as set-up.  The record
names the device as JAX reports it and the card's name and power limit.
Exits non-zero, printing no record, without a GPU.

    python bench.py
"""

import json
import sys
import time

import jax
import numpy as np

from chip_smoke import BLOCK_SIZE, _device_batch, _timed, card_info, \
    make_corpus
from tpuzip.dist import mesh as meshlib, runner
from tpuzip.runtime import compile_cache, native


def main() -> int:
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench: no GPU visible — JAX's default platform is "
              f"{devices[0].platform!r}; nothing was measured",
              file=sys.stderr)
        return 2
    compile_cache.enable()
    card = card_info()
    setup = {}
    t0 = time.perf_counter()
    native.available()
    from tpuzip.codecs import bwt as jbwt
    from tpuzip.kernels import ari_cuda

    ari_cuda.load()
    setup["build_s"] = time.perf_counter() - t0
    corpus = make_corpus()
    mb = len(corpus) / 1e6
    mesh = meshlib.make_mesh(devices=devices[:1])
    rows, lens, jb, jl = _device_batch(corpus, BLOCK_SIZE, mesh)
    detail = {}

    def rate(name, fn, nbytes_mb=mb):
        first, best = _timed(fn)
        setup[name + "_first_call_s"] = first
        detail[name + "_MBps"] = nbytes_mb / best
        return best

    # ari
    rate("ari_cuda_encode", lambda: ari_cuda.encode(jb, jl))
    comp, clens, _ = ari_cuda.encode(jb, jl)
    rate("ari_cuda_decode", lambda: ari_cuda.decode(
        comp, clens, jl, n=BLOCK_SIZE))
    c_ari = runner.compress(corpus, codec="ari", mesh=mesh,
                            block_size=BLOCK_SIZE)
    rate("ari_compress", lambda: runner.compress(
        corpus, codec="ari", mesh=mesh, block_size=BLOCK_SIZE))
    rate("ari_decompress", lambda: runner.decompress(c_ari, mesh=mesh))
    detail["ari_ratio"] = len(c_ari) / len(corpus)

    # lz4
    c_lz4 = runner.compress(corpus, codec="lz4", mesh=mesh,
                            block_size=BLOCK_SIZE)
    rate("lz4_compress", lambda: runner.compress(
        corpus, codec="lz4", mesh=mesh, block_size=BLOCK_SIZE))
    rate("lz4_decompress", lambda: runner.decompress(c_lz4, mesh=mesh))
    rate("lz4_compress_from_device", lambda: runner.compress_from_device(
        jb, lens, codec="lz4", mesh=mesh))
    rate("lz4_decompress_to_device", lambda: runner.decompress(
        c_lz4, mesh=mesh, to_device=True)[0])
    detail["lz4_ratio"] = len(c_lz4) / len(corpus)

    # bwt forward, both implementations
    b128, l128 = jb[:128], jl[:128]
    mb128 = 128 * BLOCK_SIZE / 1e6
    rate("bwt_forward_xla", lambda: jbwt._encode_batch_fast(
        b128, l128, True), mb128)
    r128, n128 = rows[:128], np.asarray(lens[:128])
    rate("bwt_forward_host", lambda: native.bwt_forward_batch(r128, n128),
         mb128)
    xl, xo = jbwt._encode_batch_fast(b128, l128, True)
    hl, ho = native.bwt_forward_batch(r128, n128)
    if not (np.array_equal(np.asarray(xl), hl)
            and np.array_equal(np.asarray(xo), ho)):
        raise AssertionError("bwt forward: XLA != host C++")

    enc, dec = detail["ari_compress_MBps"], detail["ari_decompress_MBps"]
    print(json.dumps({
        "metric": "ari_compress+decompress_throughput",
        "value": 2.0 / (1.0 / enc + 1.0 / dec),
        "unit": "MB/s",
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
        "card": card,
        "corpus_bytes": len(corpus),
        "detail": detail,
        "setup": setup,
    }, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
