"""Smoke run of tpuzip's main path on NVIDIA GPUs, through the public API.

    python chip_smoke.py               # one card: phases ari, lz4, kernel-vs-xla
    python chip_smoke.py --four-cards  # the four-card path and its one-card
                                       # comparison, nothing else

The corpus is generated from a seed: 4096 blocks of 64 KiB (256 MiB, the
last block short), blocks of word-salad text and blocks of random bytes
interleaved, so compressible and incompressible blocks both occur.  Every
check is byte-exact.  Any failed check raises, and the process exits
non-zero; it also exits non-zero, before any work, when JAX's default
device is not a GPU.  The last line of standard output is the JSON result
`{"ok": true, "device": {...}}`; the card's name and power limit are
printed before it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from tpuzip.core import blocks as blk
from tpuzip.dist import backend, mesh as meshlib, runner
from tpuzip.oracle import ari as oari, liblz4, lz4 as olz4
from tpuzip.runtime import compile_cache, native

BLOCK_SIZE = 1 << 16
N_BLOCKS = 4096
SHORT_TAIL = 1000  # the last block is this many bytes short
SEED = 20261016
ORACLE_SAMPLE = 8
KNOBS = ((8, 1 << 13), (16, 1 << 10))  # ari (increment, threshold)

_WORDS = (b"the of and to in is that for it as with was on be by this are "
          b"from at or an have not which but all were when there can been "
          b"block stream entropy coder range model table symbol device "
          b"compress decompress corpus index chunk window buffer kernel "
          b"archive checkpoint tensor batch shard mesh card memory").split()


def log(*parts) -> None:
    print(*parts, flush=True)


def check(ok, what: str) -> None:
    if not ok:
        raise AssertionError(f"check failed: {what}")
    log(f"  ok  {what}")


def make_corpus(n_blocks: int = N_BLOCKS, block_size: int = BLOCK_SIZE,
                seed: int = SEED, short_tail: int = SHORT_TAIL) -> bytes:
    """Seeded corpus of n_blocks blocks: every third block random bytes,
    the others windows of a Zipf-weighted word salad."""
    rng = np.random.default_rng(seed)
    words = [w + b" " for w in _WORDS] + [w + b"\n" for w in _WORDS[:8]]
    table = np.frombuffer(b"".join(words), np.uint8)
    wlen = np.array([len(w) for w in words])
    woff = np.cumsum(wlen) - wlen
    p = 1.0 / np.arange(1, len(words) + 1)
    pool_bytes = min(16 << 20, 2 * n_blocks * block_size)
    pick = rng.choice(len(words), size=pool_bytes // 6 + 1, p=p / p.sum())
    lens = wlen[pick]
    owner = np.repeat(np.arange(pick.size), lens)
    pos = np.arange(owner.size) - np.repeat(np.cumsum(lens) - lens, lens)
    pool = table[woff[pick][owner] + pos]
    rows = np.empty((n_blocks, block_size), np.uint8)
    for i in range(n_blocks):
        if i % 3 == 2:
            rows[i] = rng.integers(0, 256, block_size, dtype=np.uint8)
        else:
            o = int(rng.integers(0, pool.size - block_size))
            rows[i] = pool[o : o + block_size]
    total = max(n_blocks * block_size - short_tail, 1)
    return rows.reshape(-1)[:total].tobytes()


def card_info() -> str:
    """`name, power.limit` of every visible card, as nvidia-smi reports
    them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip()


def _device_batch(corpus: bytes, block_size: int, mesh):
    rows, lens = blk.chunk_padded(corpus, block_size, mesh.shape["dp"])
    jb = jax.device_put(rows, meshlib.block_sharding(mesh))
    jl = jax.device_put(lens, meshlib.length_sharding(mesh))
    return rows, lens, jb, jl


def _payloads(container: bytes) -> list[bytes]:
    """Per-block payloads of a tpz container (header layout: runner)."""
    flags = container[5]
    nb = int.from_bytes(container[10:14], "little")
    clens = np.frombuffer(container, np.uint32, nb, 26).astype(np.int64)
    off = 26 + 4 * nb + (4 * nb if flags & 1 else 0) + (6 if flags & 4
                                                        else 0)
    starts = off + np.concatenate([[0], np.cumsum(clens)])
    return [container[starts[i] : starts[i + 1]] for i in range(nb)]


def _oracle_deltas(data: bytes, increment: int, threshold: int) -> list:
    """Chunk index of the oracle coder: renorm bytes per 64 symbols."""
    model = oari.TableModel(256, increment, threshold)
    enc = oari.RangeEncoder()
    deltas = [0] * ((len(data) + 63) // 64)
    for t, b in enumerate(data):
        lo, hi = model.get_range(b)
        before = len(enc.out)
        enc.encode(lo, hi, model.get_denominator())
        deltas[t // 64] += len(enc.out) - before
        model.update(b)
    return deltas


def _sample(n: int) -> list[int]:
    """Text blocks, random blocks (i % 3 == 2) and the short last block."""
    pick = [0, 1, 2, 5, 8, n // 2 - n // 2 % 3 + 2, n - 2, n - 1]
    return sorted({i for i in pick if 0 <= i < n})[:ORACLE_SAMPLE]


def phase_ari(devices, corpus: bytes, block_size: int = BLOCK_SIZE) -> dict:
    """compress / decompress / compress_from_device / to_device for codec
    ari, and the device coder against the host C++ coder and the oracle."""
    log(f"phase ari: {len(corpus)} bytes, block {block_size}, "
        f"{len(devices)} device(s)")
    mesh = meshlib.make_mesh(devices=devices)
    t0 = time.perf_counter()
    c = runner.compress(corpus, codec="ari", block_size=block_size,
                        mesh=mesh)
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = runner.decompress(c, mesh=mesh)
    t_d = time.perf_counter() - t0
    check(back == corpus, "ari: decompress(compress(corpus)) == corpus")
    rows, lens, jb, jl = _device_batch(corpus, block_size, mesh)
    c_dev = runner.compress_from_device(jb, lens, codec="ari", mesh=mesh)
    check(c_dev == c, "ari: compress_from_device container == compress "
                      "container")
    dev, olens, orig = runner.decompress(c, mesh=mesh, to_device=True)
    check(orig == len(corpus) and bool(jnp.array_equal(dev, jb)),
          "ari: decompress(to_device=True) == input blocks on device")
    nc = (block_size + 63) // 64
    for inc, thr in KNOBS:
        comp, clens, deltas = runner._ari_encode_indexed(
            jb, jl, increment=inc, threshold=thr, mesh=mesh)
        hcomp, hclens, hdeltas = native.ari_encode_indexed_batch(
            rows, lens, nc, increment=inc, threshold=thr)
        w = int(hclens.max())
        check(np.array_equal(clens, hclens)
              and np.array_equal(deltas, hdeltas)
              and np.array_equal(comp[:, :w], hcomp[:, :w]),
              f"ari({inc}, {thr}): device streams, lengths and chunk "
              f"indexes == host C++ on all {rows.shape[0]} blocks")
        for i in _sample(rows.shape[0]):
            data = rows[i, : lens[i]].tobytes()
            want = oari.encode_bytes(data, increment=inc, threshold=thr)
            ok = (comp[i, : clens[i]].tobytes() == want and list(
                deltas[i, : (len(data) + 63) // 64]) == _oracle_deltas(
                    data, inc, thr))
            check(ok, f"ari({inc}, {thr}): block {i} ({len(data)} bytes) "
                      f"== oracle stream and chunk index")
        syms = runner._ari_decode_streams(comp, clens, lens, block_size, inc,
                                          thr, mesh=mesh)
        check(np.array_equal(np.asarray(syms), rows),
              f"ari({inc}, {thr}): device decode == input")
    return {"compress_s": t_c, "decompress_s": t_d,
            "ratio": len(c) / max(len(corpus), 1)}


def phase_lz4(devices, corpus: bytes, block_size: int = BLOCK_SIZE) -> dict:
    """compress (host encoder), compress_from_device (XLA device encoder),
    decompress to host and to device; sampled blocks against system liblz4
    (or the oracle where liblz4 is missing)."""
    log(f"phase lz4: {len(corpus)} bytes, block {block_size}, "
        f"{len(devices)} device(s)")
    mesh = meshlib.make_mesh(devices=devices)
    t0 = time.perf_counter()
    c = runner.compress(corpus, codec="lz4", block_size=block_size,
                        mesh=mesh)
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = runner.decompress(c, mesh=mesh)
    t_d = time.perf_counter() - t0
    check(back == corpus, "lz4: decompress(compress(corpus)) == corpus")
    rows, lens, jb, _ = _device_batch(corpus, block_size, mesh)
    t0 = time.perf_counter()
    c_dev = runner.compress_from_device(jb, lens, codec="lz4", mesh=mesh)
    t_cd = time.perf_counter() - t0
    check(runner.decompress(c_dev, mesh=mesh) == corpus,
          "lz4: decompress(compress_from_device) == corpus")
    log(f"  lz4: device-encoded container "
        f"{'==' if c_dev == c else '!='} host-encoded container "
        f"({len(c_dev)} vs {len(c)} bytes)")
    for cont, who in ((c, "host encoder"), (c_dev, "device encoder")):
        dev, _, orig = runner.decompress(cont, mesh=mesh, to_device=True)
        check(orig == len(corpus) and bool(jnp.array_equal(dev, jb)),
              f"lz4 ({who}): decompress(to_device=True) == input blocks")
        pays = _payloads(cont)
        ref = "liblz4" if liblz4.available() else "oracle"
        for i in _sample(rows.shape[0]):
            n = int(lens[i])
            got = (liblz4.decompress_block(pays[i], n) if ref == "liblz4"
                   else olz4.decompress_block(pays[i]))
            check(got == rows[i, :n].tobytes(),
                  f"lz4 ({who}): block {i} decodes with {ref}")
    return {"compress_s": t_c, "decompress_s": t_d,
            "compress_from_device_s": t_cd,
            "ratio": len(c) / max(len(corpus), 1)}


def _timed(fn, reps: int = 3) -> tuple[float, float]:
    """(first call incl. compilation, best of `reps` warm calls) seconds;
    every call ends in block_until_ready."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return first, best


def phase_kernel_vs_xla(devices, corpus: bytes, card: str,
                        block_size: int = BLOCK_SIZE) -> dict:
    """The ari coder three ways at the corpus size: the CUDA kernel, the
    plain XLA scan (codecs/ari.py, vmapped and jitted) and the threaded
    host C++ coder; then compress / decompress end to end with each."""
    from tpuzip.kernels import ari_cuda

    log(f"phase kernel-vs-xla on {card}")
    mesh = meshlib.make_mesh(devices=devices)
    rows, lens, jb, jl = _device_batch(corpus, block_size, mesh)
    mb = len(corpus) / 1e6
    res = {}

    def report(name, first, best):
        res[name] = {"s": best, "MBps": mb / best, "first_call_s": first}
        log(f"  {name:<24} {best * 1e3:10.2f} ms  {mb / best:10.1f} MB/s  "
            f"(first call {first:.2f} s)  [{card}]")

    enc = lambda coder: ari_cuda.encode(jb, jl, coder=coder)  # noqa: E731
    report("cuda_encode", *_timed(lambda: enc(ari_cuda.cuda_encode)))
    comp, clens, _ = enc(ari_cuda.cuda_encode)
    dec = lambda coder: ari_cuda.decode(  # noqa: E731
        comp, clens, jl, n=block_size, coder=coder)
    report("cuda_decode", *_timed(lambda: dec(ari_cuda.cuda_decode)))
    report("xla_encode", *_timed(lambda: enc(ari_cuda.xla_encode), reps=1))
    xcomp, xclens, _ = enc(ari_cuda.xla_encode)
    check(bool(jnp.array_equal(xclens, clens))
          and bool(jnp.array_equal(xcomp, comp)),
          "ari: XLA streams == CUDA streams")
    report("xla_decode", *_timed(lambda: dec(ari_cuda.xla_decode), reps=1))
    check(bool(jnp.array_equal(dec(ari_cuda.xla_decode), jb)),
          "ari: XLA decode == input")
    nc = (block_size + 63) // 64
    report("host_encode", *_timed(
        lambda: native.ari_encode_indexed_batch(rows, lens, nc)))
    hcomp, hclens, _ = native.ari_encode_indexed_batch(rows, lens, nc)
    report("host_decode", *_timed(lambda: native.ari_decode_batch_native(
        hcomp, hclens, lens, block_size)))
    # end to end: compress / decompress(codec="ari") with each coder
    c = runner.compress(corpus, codec="ari", block_size=block_size,
                        mesh=mesh)
    for impl in ("cuda", "xla", "host"):
        with backend.using(ari_encode=impl, ari_decode=impl):
            report(f"compress_ari_e2e_{impl}", *_timed(
                lambda: runner.compress(corpus, codec="ari",
                                        block_size=block_size, mesh=mesh),
                reps=2))
            report(f"decompress_ari_e2e_{impl}", *_timed(
                lambda: runner.decompress(c, mesh=mesh), reps=2))
    return res


def phase_four_cards(devices, corpus: bytes,
                     block_size: int = BLOCK_SIZE) -> dict:
    """ari and lz4 over a dp mesh of four cards, block checksums on: every
    container byte-identical to the one-card container of this process,
    to_device output sharded over dp, and the sp-axis Adler-32."""
    from tpuzip.core.checksum import adler32_batch
    from tpuzip.dist import collectives

    log(f"phase four-cards: {len(devices)} devices")
    mesh4 = meshlib.make_mesh(devices=devices)
    mesh1 = meshlib.make_mesh(devices=devices[:1])
    rows, lens, jb, jl = _device_batch(corpus, block_size, mesh4)
    sizes = {}
    for codec in ("ari", "lz4"):
        c1 = runner.compress(corpus, codec=codec, block_size=block_size,
                             mesh=mesh1, block_checksums=True)
        c4 = runner.compress(corpus, codec=codec, block_size=block_size,
                             mesh=mesh4, block_checksums=True)
        check(c4 == c1, f"{codec}: 4-card container == 1-card container")
        check(runner.decompress(c4, mesh=mesh4) == corpus,
              f"{codec}: 4-card decompress == corpus")
        dev, _, _ = runner.decompress(c4, mesh=mesh4, to_device=True)
        check(bool(jnp.array_equal(dev, jb)),
              f"{codec}: 4-card to_device == input blocks")
        check(dev.sharding.is_equivalent_to(meshlib.block_sharding(mesh4), 2),
              f"{codec}: to_device output sharded over dp "
              f"({len(dev.sharding.device_set)} devices)")
        d1 = runner.compress_from_device(jb, lens, codec=codec, mesh=mesh1,
                                         block_checksums=True)
        d4 = runner.compress_from_device(jb, lens, codec=codec, mesh=mesh4,
                                         block_checksums=True)
        check(d4 == d1, f"{codec}: 4-card compress_from_device == 1-card")
        sizes[codec] = len(c4)
    mesh_sp = meshlib.make_mesh(devices=devices, sp=2)
    jb_sp = jax.device_put(rows, meshlib.block_sharding(mesh_sp))
    got = collectives.sharded_adler32(
        mesh_sp, jb_sp, jax.device_put(lens, meshlib.length_sharding(mesh_sp)))
    check(bool(jnp.array_equal(got, adler32_batch(jb, jl))),
          "sharded_adler32 over ('dp', 'sp') == per-block Adler-32")
    return sizes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card path and its comparison")
    args = ap.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU visible — JAX's default platform is "
              f"{devices[0].platform!r}; nothing was run", file=sys.stderr)
        return 2
    card = card_info()
    log(f"card: {card}")
    log(f"jax {jax.__version__}: {devices}")
    log(f"compile cache: {compile_cache.enable()}")
    t0 = time.perf_counter()
    native.available()
    from tpuzip.kernels import ari_cuda

    ari_cuda.load()
    log(f"set-up: native libraries built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    corpus = make_corpus()
    log(f"set-up: corpus {len(corpus)} bytes in "
        f"{time.perf_counter() - t0:.1f} s")

    if args.four_cards:
        if len(devices) < 4:
            print(f"chip_smoke: --four-cards needs 4 GPUs, found "
                  f"{len(devices)}", file=sys.stderr)
            return 2
        used = devices[:4]
        out = {"four_cards": phase_four_cards(used, corpus)}
    else:
        used = devices[:1]
        out = {"ari": phase_ari(used, corpus),
               "lz4": phase_lz4(used, corpus),
               "kernel_vs_xla": phase_kernel_vs_xla(used, corpus, card)}
    log("results: " + json.dumps(out, default=float))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": used[0].platform, "kind": used[0].device_kind,
        "count": len(used)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
