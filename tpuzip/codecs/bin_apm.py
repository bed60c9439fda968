"""Binary adaptive model + APM/SSE coder — XLA formulation.

Reference parity: src/entropy/ari/bin.rs (shift-update bit model) and
src/entropy/ari/apm.rs (Bit cell + Gate secondary estimation).  Formats are
bit-exact vs tpuzip.oracle.ari.BinaryModel / ApmGate driven through the
carryless range coder.

One `lax.scan` step per bit; the APM variant carries the 33-cell SSE table
in the scan state and refines the primary model's probability through
linear interpolation, exactly as the oracle does.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from tpuzip.core.bitio import pack_bytes_varlen

TOP = jnp.uint32(1 << 24)
BOT = jnp.uint32(1 << 16)
APM_BITS = 12
APM_SLOTS = 33


def encode_cap(n_bits: int) -> int:
    return n_bits // 2 + 64


def _renorm_enc(low, rng):
    bytes_, emits = [], []
    for _ in range(4):
        settled = ((low ^ (low + rng)) < TOP)
        force = (~settled) & (rng < BOT)
        rng = jnp.where(force, (~low + jnp.uint32(1)) & (BOT - jnp.uint32(1)),
                        rng)
        emit = settled | force
        bytes_.append((low >> 24).astype(jnp.uint8))
        emits.append(emit)
        low = jnp.where(emit, low << 8, low)
        rng = jnp.where(emit, rng << 8, rng)
    return low, rng, jnp.stack(bytes_), jnp.stack(emits)


def _bin_update(p0, bit, bits, rate):
    up = p0 + (((1 << bits) - p0) >> rate)
    dn = p0 - (p0 >> rate)
    p0 = jnp.where(bit == 0, up, dn)
    return jnp.clip(p0, 1, (1 << bits) - 1)


def encode_bits(bits_in: jnp.ndarray, length: jnp.ndarray,
                model_bits: int = 12, rate: int = 5,
                use_apm: bool = False, apm_rate: int = 5,
                cap: int | None = None):
    """bits_in: (N,) u8 of 0/1. Bit-exact vs the oracle BinaryModel coder
    (and oracle ApmGate coder when use_apm)."""
    n = bits_in.shape[0]
    cap = cap or encode_cap(n)
    length = jnp.asarray(length, jnp.int32)
    gate0 = jnp.clip(
        (jnp.arange(APM_SLOTS, dtype=jnp.int32) * (1 << APM_BITS))
        // (APM_SLOTS - 1), 1, (1 << APM_BITS) - 1)

    def step(state, x):
        low, rng, p0, gate = state
        bit, i = x
        valid = i < length
        if use_apm:
            scaled = p0 * (APM_SLOTS - 1)
            idx = jnp.minimum(scaled >> APM_BITS, APM_SLOTS - 2)
            frac = scaled & ((1 << APM_BITS) - 1)
            last = jnp.where(frac < (1 << (APM_BITS - 1)), idx, idx + 1)
            a = gate[idx]
            b = gate[idx + 1]
            pp = (a * ((1 << APM_BITS) - frac) + b * frac) >> APM_BITS
            pp = jnp.clip(pp, 1, (1 << APM_BITS) - 1)
            denom, cl, ch = (1 << APM_BITS), jnp.where(bit == 0, 0, pp), \
                jnp.where(bit == 0, pp, 1 << APM_BITS)
        else:
            denom = 1 << model_bits
            cl = jnp.where(bit == 0, 0, p0)
            ch = jnp.where(bit == 0, p0, denom)
        r = rng // jnp.uint32(denom)
        nlow = low + r * cl.astype(jnp.uint32)
        nrng = r * (ch - cl).astype(jnp.uint32)
        nlow, nrng, b4, e4 = _renorm_enc(nlow, nrng)
        np0 = _bin_update(p0, bit, model_bits if not use_apm else model_bits,
                          rate)
        if use_apm:
            cell = gate[last]
            ncell = _bin_update(cell, bit, APM_BITS, apm_rate)
            ngate = gate.at[last].set(ncell)
            gate = jnp.where(valid, ngate, gate)
        low = jnp.where(valid, nlow, low)
        rng = jnp.where(valid, nrng, rng)
        p0 = jnp.where(valid, np0, p0)
        return (low, rng, p0, gate), (b4, e4 & valid)

    init = (jnp.uint32(0), jnp.uint32(0xFFFFFFFF),
            jnp.int32(1 << (model_bits - 1)), gate0)
    xs = (bits_in.astype(jnp.int32), jnp.arange(n, dtype=jnp.int32))
    (low, _, _, _), (b4, e4) = lax.scan(step, init, xs)
    tail = jnp.stack([(low >> (24 - 8 * k)).astype(jnp.uint8)
                      for k in range(4)])
    chunks = jnp.concatenate([b4, tail[None]], axis=0)
    counts = e4.sum(axis=1).astype(jnp.int32)
    lens = jnp.concatenate([counts, jnp.array([4], jnp.int32)])
    return pack_bytes_varlen(chunks, lens, cap)


def decode_bits(comp: jnp.ndarray, num_bits: jnp.ndarray, out_n: int,
                model_bits: int = 12, rate: int = 5,
                use_apm: bool = False, apm_rate: int = 5) -> jnp.ndarray:
    cap = comp.shape[0]
    num_bits = jnp.asarray(num_bits, jnp.int32)
    comp32 = comp.astype(jnp.uint32)
    code0 = (comp32[0] << 24) | (comp32[1] << 16) | (comp32[2] << 8) | comp32[3]
    gate0 = jnp.clip(
        (jnp.arange(APM_SLOTS, dtype=jnp.int32) * (1 << APM_BITS))
        // (APM_SLOTS - 1), 1, (1 << APM_BITS) - 1)

    def step(state, i):
        low, rng, code, pos, p0, gate = state
        valid = i < num_bits
        if use_apm:
            scaled = p0 * (APM_SLOTS - 1)
            idx = jnp.minimum(scaled >> APM_BITS, APM_SLOTS - 2)
            frac = scaled & ((1 << APM_BITS) - 1)
            last = jnp.where(frac < (1 << (APM_BITS - 1)), idx, idx + 1)
            a = gate[idx]
            b = gate[idx + 1]
            pp = jnp.clip((a * ((1 << APM_BITS) - frac) + b * frac)
                          >> APM_BITS, 1, (1 << APM_BITS) - 1)
            denom = 1 << APM_BITS
            split = pp
        else:
            denom = 1 << model_bits
            split = p0
        r = rng // jnp.uint32(denom)
        v = jnp.minimum((code - low) // r, jnp.uint32(denom - 1))
        bit = (v >= split.astype(jnp.uint32)).astype(jnp.int32)
        cl = jnp.where(bit == 0, 0, split)
        ch = jnp.where(bit == 0, split, denom)
        nlow = low + r * cl.astype(jnp.uint32)
        nrng = r * (ch - cl).astype(jnp.uint32)
        ncode, npos = code, pos
        for _ in range(4):
            settled = ((nlow ^ (nlow + nrng)) < TOP)
            force = (~settled) & (nrng < BOT)
            nrng = jnp.where(force,
                             (~nlow + jnp.uint32(1)) & (BOT - jnp.uint32(1)),
                             nrng)
            pull = settled | force
            nxt = comp32[jnp.clip(npos, 0, cap - 1)]
            ncode = jnp.where(pull, (ncode << 8) | nxt, ncode)
            npos = jnp.where(pull, npos + 1, npos)
            nlow = jnp.where(pull, nlow << 8, nlow)
            nrng = jnp.where(pull, nrng << 8, nrng)
        np0 = _bin_update(p0, bit, model_bits, rate)
        if use_apm:
            cell = gate[last]
            ngate = gate.at[last].set(_bin_update(cell, bit, APM_BITS,
                                                  apm_rate))
            gate = jnp.where(valid, ngate, gate)
        low = jnp.where(valid, nlow, low)
        rng = jnp.where(valid, nrng, rng)
        code = jnp.where(valid, ncode, code)
        pos = jnp.where(valid, npos, pos)
        p0 = jnp.where(valid, np0, p0)
        return (low, rng, code, pos, p0, gate), jnp.where(
            valid, bit, 0).astype(jnp.uint8)

    init = (jnp.uint32(0), jnp.uint32(0xFFFFFFFF), code0, jnp.int32(4),
            jnp.int32(1 << (model_bits - 1)), gate0)
    _, bits = lax.scan(step, init, jnp.arange(out_n, dtype=jnp.int32))
    return bits


# ---------------------------------------------------------------------------
# Byte-level batch codec surface (runner codecs "bin"/"apm"): bytes are
# coded MSB-first through the binary model, one adaptive model per block.
# In the reference all ari models (table/bin/apm) drive the same range
# coder and the user picks one (SURVEY.md:136-139); this is the bin/apm
# pick for whole byte blocks.
# ---------------------------------------------------------------------------

def bytes_to_bits(blocks: jnp.ndarray) -> jnp.ndarray:
    """(B, n) u8 -> (B, 8n) u8 of 0/1, MSB-first within each byte."""
    b, n = blocks.shape
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    bits = (blocks[:, :, None] >> shifts[None, None, :]) & jnp.uint8(1)
    return bits.reshape(b, 8 * n)


def bits_to_bytes(bits: jnp.ndarray) -> jnp.ndarray:
    """(B, 8n) u8 of 0/1 -> (B, n) u8, MSB-first."""
    b, n8 = bits.shape
    w = (jnp.uint8(1) << jnp.arange(7, -1, -1, dtype=jnp.uint8))
    return (bits.reshape(b, n8 // 8, 8) * w[None, None, :]).sum(
        axis=2).astype(jnp.uint8)


def encode_batch(blocks: jnp.ndarray, lengths: jnp.ndarray,
                 model_bits: int = 12, rate: int = 5,
                 use_apm: bool = False):
    """(B, n) u8 byte blocks -> (comp (B, cap) u8, clens (B,) i32).

    XLA scan formulation (vmapped encode_bits); the runner encodes with
    the threaded host C++ coder, which writes identical streams."""
    bits = bytes_to_bits(blocks)
    bit_lens = (jnp.asarray(lengths, jnp.int32) * 8)
    fn = functools.partial(encode_bits, model_bits=model_bits, rate=rate,
                           use_apm=use_apm)
    return jax.vmap(fn)(bits, bit_lens)


def decode_batch(comp: jnp.ndarray, lengths: jnp.ndarray, out_n: int,
                 model_bits: int = 12, rate: int = 5,
                 use_apm: bool = False):
    """(B, cap) u8 streams + per-block BYTE lengths -> (B, out_n) u8."""
    fn = functools.partial(decode_bits, model_bits=model_bits, rate=rate,
                           use_apm=use_apm)
    bits = jax.vmap(fn, in_axes=(0, 0, None))(
        comp, jnp.asarray(lengths, jnp.int32) * 8, 8 * out_n)
    return bits_to_bytes(bits)


# ---------------------------------------------------------------------------
# Chunk-indexed lane decoder (the to_device decode of staged bin/apm
# containers).  The encoder records the stream bytes consumed per CHUNK
# bits (codecs/ari_index.py), so every block's stream is pre-cut into
# per-chunk windows of u32 words and the lanes (blocks) advance one bit
# per scan step with no per-lane gathers into the stream.
# ---------------------------------------------------------------------------

CHUNK = 256                        # bits per chunk-index entry
GATE_ROWS = (APM_SLOTS + 1) // 2   # APM cells, two u16 halves per i32 row


def bin_window_words(max_delta: int) -> int:
    """Window words per CHUNK-bit chunk.  A bit can emit up to 4 renorm
    bytes, so the worst chunk consumes 4*CHUNK+4 bytes; size from the
    largest delta of the batch instead."""
    need = (max_delta + 8 + 3) // 4
    for w in (16, 32, 64, 136, 264):
        if w >= need:
            return w
    raise ValueError(f"bin chunk delta {max_delta} exceeds 4*CHUNK+4")


def _gate_init_packed(lanes: int):
    p_r = lax.broadcasted_iota(jnp.int32, (GATE_ROWS, lanes), 0)

    def _init(s):
        return jnp.clip((s * (1 << APM_BITS)) // (APM_SLOTS - 1),
                        1, (1 << APM_BITS) - 1)

    return _init(2 * p_r) | (_init(2 * p_r + 1) << 16)


def _bin_decode_step(low, rng, code, p0, gate, posB, active, win_i, iotaW,
                     iota_rows, *, model_bits: int, rate: int,
                     use_apm: bool, apm_rate: int):
    """One decode step over the lane axis; mirrors the encoder's model
    math bit for bit.  State (lanes,), gate (GATE_ROWS, lanes) with APM
    cells 2p / 2p+1 in the lo / hi u16 halves of row p, window
    (w, lanes) i32 bit patterns; posB is the byte position inside the
    current chunk's window."""
    if use_apm:
        gt = gate
        scaled = p0 * (APM_SLOTS - 1)
        idx = jnp.minimum(scaled >> APM_BITS, APM_SLOTS - 2)
        frac = scaled & ((1 << APM_BITS) - 1)
        last = jnp.where(frac < (1 << (APM_BITS - 1)), idx, idx + 1)
        q = idx >> 1
        acc0 = jnp.sum(jnp.where(iota_rows == q[None, :], gt, 0), axis=0)
        acc1 = jnp.sum(jnp.where(iota_rows == (q + 1)[None, :], gt, 0),
                       axis=0)
        even = (idx & 1) == 0
        a = jnp.where(even, acc0 & 0xFFFF, acc0 >> 16)
        b = jnp.where(even, acc0 >> 16, acc1 & 0xFFFF)
        pp = (a * ((1 << APM_BITS) - frac) + b * frac) >> APM_BITS
        split = jnp.clip(pp, 1, (1 << APM_BITS) - 1)
        denom_bits = APM_BITS
    else:
        split = p0
        denom_bits = model_bits
    r = rng >> denom_bits
    v = jnp.minimum((code - low) // r, jnp.uint32((1 << denom_bits) - 1))
    bit = (v >= split.astype(jnp.uint32)).astype(jnp.int32)
    cl = jnp.where(bit == 0, 0, split).astype(jnp.uint32)
    width = jnp.where(bit == 0, split,
                      (1 << denom_bits) - split).astype(jnp.uint32)
    low2 = low + r * cl
    rng2 = r * width
    # the next 4 stream bytes: two window words + byte alignment
    widx = posB >> 2
    w0 = jnp.sum(jnp.where(iotaW == widx[None, :], win_i, 0),
                 axis=0).astype(jnp.uint32)
    w1 = jnp.sum(jnp.where(iotaW == (widx + 1)[None, :], win_i, 0),
                 axis=0).astype(jnp.uint32)
    b_ = posB & 3
    wrd = jnp.where(
        b_ == 0, w0,
        jnp.where(b_ == 1, (w0 << 8) | (w1 >> 24),
                  jnp.where(b_ == 2, (w0 << 16) | (w1 >> 16),
                            (w0 << 24) | (w1 >> 8))))
    pulled = jnp.zeros_like(posB)
    for rd_ in range(4):
        settled = ((low2 ^ (low2 + rng2)) < TOP)
        force = (~settled) & (rng2 < BOT)
        rng2 = jnp.where(force, (~low2 + 1) & (BOT - 1), rng2)
        pull = (settled | force) & active
        byte = wrd >> 24
        for kk in range(1, rd_ + 1):
            byte = jnp.where(pulled == kk, (wrd >> (24 - 8 * kk)), byte)
        byte = byte & jnp.uint32(0xFF)
        code = jnp.where(pull, (code << 8) | byte, code)
        low2 = jnp.where(pull, low2 << 8, low2)
        rng2 = jnp.where(pull, rng2 << 8, rng2)
        pulled = pulled + pull.astype(jnp.int32)
    posB = posB + jnp.where(active, pulled, 0)
    np0 = _bin_update(p0, bit, model_bits, rate)
    p0 = jnp.where(active, np0, p0)
    if use_apm:
        cell = jnp.where(last == idx, a, b)
        ncell = _bin_update(cell, bit, APM_BITS, apm_rate)
        lp = last >> 1
        lodd = (last & 1) == 1
        packed_new = jnp.where(
            lodd,
            (gt & 0xFFFF) | (ncell[None, :] << 16),
            (gt & ~jnp.int32(0xFFFF)) | ncell[None, :])
        rowsel = iota_rows == lp[None, :]
        gate = jnp.where(rowsel & active[None, :], packed_new, gt)
    low = jnp.where(active, low2, low)
    rng = jnp.where(active, rng2, rng)
    return low, rng, code, p0, gate, posB, bit


@functools.partial(jax.jit, static_argnames=(
    "w", "model_bits", "rate", "use_apm", "apm_rate"))
def bin_decode_reference(windows: jnp.ndarray, code0: jnp.ndarray,
                         lens: jnp.ndarray, w: int,
                         model_bits: int = 12, rate: int = 5,
                         use_apm: bool = False, apm_rate: int = 5):
    """windows: (NC*w, lanes) u32 per-chunk stream windows; code0 (lanes,)
    u32 = first 4 stream bytes big-endian; lens (lanes,) i32 BIT counts.
    Returns (NC*CHUNK, lanes) u8 bits, time-major (nested lax.scan: chunks
    outside, the CHUNK bits of one window inside)."""
    total_rows, lanes = windows.shape
    assert total_rows % w == 0
    nc = total_rows // w
    iotaW = lax.broadcasted_iota(jnp.int32, (w, lanes), 0)
    iota_rows = lax.broadcasted_iota(jnp.int32, (GATE_ROWS, lanes), 0)
    win_chunks = windows.reshape(nc, w, lanes).astype(jnp.int32)
    lens = lens.astype(jnp.int32)

    def chunk_body(carry, xs):
        low, rng, code, p0, gate = carry
        win_i, k = xs

        def step_body(c2, j):
            low, rng, code, p0, gate, posB = c2
            active = (k * CHUNK + j) < lens
            low, rng, code, p0, gate, posB, bit = _bin_decode_step(
                low, rng, code, p0, gate, posB, active, win_i, iotaW,
                iota_rows, model_bits=model_bits, rate=rate,
                use_apm=use_apm, apm_rate=apm_rate)
            return (low, rng, code, p0, gate, posB), bit.astype(jnp.uint8)

        (low, rng, code, p0, gate, _), bits = lax.scan(
            step_body,
            (low, rng, code, p0, gate, jnp.zeros((lanes,), jnp.int32)),
            jnp.arange(CHUNK, dtype=jnp.int32))
        return (low, rng, code, p0, gate), bits

    init = (jnp.zeros((lanes,), jnp.uint32),
            jnp.full((lanes,), 0xFFFFFFFF, jnp.uint32),
            code0.astype(jnp.uint32),
            jnp.full((lanes,), 1 << (model_bits - 1), jnp.int32),
            _gate_init_packed(lanes))
    _, bits = lax.scan(chunk_body, init,
                       (win_chunks, jnp.arange(nc, dtype=jnp.int32)))
    return bits.reshape(nc * CHUNK, lanes)
