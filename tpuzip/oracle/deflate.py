"""DEFLATE (RFC 1951) — pure-Python reference decoder and encoder.

Reference parity: rust-compress ``src/flate.rs`` (bit reader, canonical
Huffman table build, stored/fixed/dynamic block decode, 32 KiB LZ77 window).
Upstream is **decoder-only**; the encoder here is new work (BASELINE config 3
requires stream-compatible *output* on enwik8), validated by feeding its
streams to the stock ``zlib`` inflater.

Decoder validated against streams produced by ``zlib.compress`` at all levels.
"""

from __future__ import annotations

# Order in which code-length-code lengths are stored in a dynamic header.
CLCL_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]

# Length codes 257..285: (extra bits, base length)
LENGTH_TABLE = [
    (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 9), (0, 10),
    (1, 11), (1, 13), (1, 15), (1, 17), (2, 19), (2, 23), (2, 27), (2, 31),
    (3, 35), (3, 43), (3, 51), (3, 59), (4, 67), (4, 83), (4, 99), (4, 115),
    (5, 131), (5, 163), (5, 195), (5, 227), (0, 258),
]
# Distance codes 0..29: (extra bits, base distance)
DIST_TABLE = [
    (0, 1), (0, 2), (0, 3), (0, 4), (1, 5), (1, 7), (2, 9), (2, 13),
    (3, 17), (3, 25), (4, 33), (4, 49), (5, 65), (5, 97), (6, 129), (6, 193),
    (7, 257), (7, 385), (8, 513), (8, 769), (9, 1025), (9, 1537),
    (10, 2049), (10, 3073), (11, 4097), (11, 6145), (12, 8193), (12, 12289),
    (13, 16385), (13, 24577),
]

MAX_BITS = 15
MAX_CL_BITS = 7
WINDOW = 32768
MIN_MATCH = 3
MAX_MATCH = 258


def length_to_code(length: int) -> tuple[int, int, int]:
    """length (3..258) -> (symbol 257..285, extra-bit count, extra-bit value)."""
    for i in range(len(LENGTH_TABLE) - 1, -1, -1):
        eb, base = LENGTH_TABLE[i]
        if length >= base and (i == 28 or length < LENGTH_TABLE[i + 1][1]):
            if i == 28 and length != 258:
                continue
            return 257 + i, eb, length - base
    raise ValueError(f"bad length {length}")


def dist_to_code(dist: int) -> tuple[int, int, int]:
    """distance (1..32768) -> (symbol 0..29, extra-bit count, extra-bit value)."""
    for i in range(len(DIST_TABLE) - 1, -1, -1):
        eb, base = DIST_TABLE[i]
        if dist >= base:
            return i, eb, dist - base
    raise ValueError(f"bad distance {dist}")


# ---------------------------------------------------------------------------
# Bit IO (LSB-first, per RFC 1951 §3.1.1)
# ---------------------------------------------------------------------------

class BitReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0       # byte position
        self.bitbuf = 0
        self.bitcnt = 0

    def bits(self, n: int) -> int:
        while self.bitcnt < n:
            if self.pos >= len(self.data):
                raise ValueError("truncated DEFLATE stream")
            self.bitbuf |= self.data[self.pos] << self.bitcnt
            self.pos += 1
            self.bitcnt += 8
        val = self.bitbuf & ((1 << n) - 1)
        self.bitbuf >>= n
        self.bitcnt -= n
        return val

    def align_byte(self) -> None:
        self.bitbuf = 0
        self.bitcnt = 0

    def bytes_consumed(self) -> int:
        return self.pos - (self.bitcnt // 8)


class BitWriter:
    def __init__(self) -> None:
        self.out = bytearray()
        self.bitbuf = 0
        self.bitcnt = 0

    def bits(self, value: int, n: int) -> None:
        """LSB-first write (used for extra bits, headers)."""
        self.bitbuf |= (value & ((1 << n) - 1)) << self.bitcnt
        self.bitcnt += n
        while self.bitcnt >= 8:
            self.out.append(self.bitbuf & 0xFF)
            self.bitbuf >>= 8
            self.bitcnt -= 8

    def huff(self, code: int, n: int) -> None:
        """Huffman codes are packed most-significant-bit first."""
        rev = 0
        for _ in range(n):
            rev = (rev << 1) | (code & 1)
            code >>= 1
        self.bits(rev, n)

    def align_byte(self) -> None:
        if self.bitcnt:
            self.out.append(self.bitbuf & 0xFF)
            self.bitbuf = 0
            self.bitcnt = 0

    def finish(self) -> bytes:
        self.align_byte()
        return bytes(self.out)


# ---------------------------------------------------------------------------
# Canonical Huffman (decode side): count/first-code tables, puff-style
# ---------------------------------------------------------------------------

class HuffmanDecoder:
    def __init__(self, lengths: list[int]) -> None:
        self.count = [0] * (MAX_BITS + 1)
        for l in lengths:
            if l:
                self.count[l] += 1
        # validate: over-subscribed / incomplete sets are format errors
        # (single-code "incomplete" sets are tolerated like zlib does for dists)
        left = 1
        for l in range(1, MAX_BITS + 1):
            left <<= 1
            left -= self.count[l]
            if left < 0:
                raise ValueError("over-subscribed Huffman code set")
        self.incomplete = left > 0
        # symbols sorted by (length, symbol) — canonical order
        offs = [0] * (MAX_BITS + 2)
        for l in range(1, MAX_BITS + 1):
            offs[l + 1] = offs[l] + self.count[l]
        self.symbols = [0] * offs[MAX_BITS + 1]
        for sym, l in enumerate(lengths):
            if l:
                self.symbols[offs[l]] = sym
                offs[l] += 1

    def decode(self, br: BitReader) -> int:
        code = 0
        first = 0
        index = 0
        for l in range(1, MAX_BITS + 1):
            code |= br.bits(1)
            cnt = self.count[l]
            if code - first < cnt:
                return self.symbols[index + (code - first)]
            index += cnt
            first = (first + cnt) << 1
            code <<= 1
        raise ValueError("invalid Huffman code")


def fixed_lit_lengths() -> list[int]:
    return [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8


def fixed_dist_lengths() -> list[int]:
    return [5] * 30


# ---------------------------------------------------------------------------
# Inflate
# ---------------------------------------------------------------------------

def decompress(data: bytes) -> bytes:
    out, _ = decompress_ex(data)
    return out


def decompress_ex(data: bytes) -> tuple[bytes, int]:
    """Inflate; returns (output, compressed bytes consumed)."""
    br = BitReader(data)
    out = bytearray()
    while True:
        final = br.bits(1)
        btype = br.bits(2)
        if btype == 0:  # stored
            br.align_byte()
            if br.pos + 4 > len(data):
                raise ValueError("truncated stored block header")
            ln = data[br.pos] | (data[br.pos + 1] << 8)
            nln = data[br.pos + 2] | (data[br.pos + 3] << 8)
            if ln != (~nln & 0xFFFF):
                raise ValueError("stored block LEN/NLEN mismatch")
            br.pos += 4
            out += data[br.pos : br.pos + ln]
            br.pos += ln
        elif btype in (1, 2):
            if btype == 1:
                lit = HuffmanDecoder(fixed_lit_lengths())
                dist = HuffmanDecoder(fixed_dist_lengths())
            else:
                lit, dist = _read_dynamic_header(br)
            _inflate_block(br, lit, dist, out)
        else:
            raise ValueError("reserved DEFLATE block type 3")
        if final:
            break
    return bytes(out), br.bytes_consumed()


def _read_dynamic_header(br: BitReader) -> tuple[HuffmanDecoder, HuffmanDecoder]:
    hlit = br.bits(5) + 257
    hdist = br.bits(5) + 1
    hclen = br.bits(4) + 4
    cl_lengths = [0] * 19
    for i in range(hclen):
        cl_lengths[CLCL_ORDER[i]] = br.bits(3)
    cl = HuffmanDecoder(cl_lengths)
    lengths: list[int] = []
    while len(lengths) < hlit + hdist:
        sym = cl.decode(br)
        if sym < 16:
            lengths.append(sym)
        elif sym == 16:
            if not lengths:
                raise ValueError("repeat code with no previous length")
            lengths += [lengths[-1]] * (3 + br.bits(2))
        elif sym == 17:
            lengths += [0] * (3 + br.bits(3))
        else:
            lengths += [0] * (11 + br.bits(7))
    if len(lengths) != hlit + hdist:
        raise ValueError("code length overflow in dynamic header")
    return HuffmanDecoder(lengths[:hlit]), HuffmanDecoder(lengths[hlit:])


def _inflate_block(br: BitReader, lit: HuffmanDecoder, dist: HuffmanDecoder,
                   out: bytearray) -> None:
    while True:
        sym = lit.decode(br)
        if sym < 256:
            out.append(sym)
        elif sym == 256:
            return
        else:
            if sym > 285:
                raise ValueError("bad length symbol")
            eb, base = LENGTH_TABLE[sym - 257]
            length = base + (br.bits(eb) if eb else 0)
            dsym = dist.decode(br)
            if dsym > 29:
                raise ValueError("bad distance symbol")
            deb, dbase = DIST_TABLE[dsym]
            d = dbase + (br.bits(deb) if deb else 0)
            if d > len(out):
                raise ValueError("distance beyond output start")
            start = len(out) - d
            for k in range(length):
                out.append(out[start + k])


# ---------------------------------------------------------------------------
# Length-limited Huffman (package-merge) — encode side
# ---------------------------------------------------------------------------

def package_merge(freqs: dict[int, int], limit: int) -> dict[int, int]:
    """Optimal length-limited code lengths via package-merge."""
    leaves = sorted((f, (s,)) for s, f in freqs.items() if f > 0)
    n = len(leaves)
    if n == 0:
        return {}
    if n == 1:
        return {leaves[0][1][0]: 1}
    if n > (1 << limit):
        raise ValueError("alphabet too large for length limit")
    current: list[tuple[int, tuple[int, ...]]] = list(leaves)
    for _ in range(limit - 1):
        packaged = [
            (current[i][0] + current[i + 1][0], current[i][1] + current[i + 1][1])
            for i in range(0, len(current) - 1, 2)
        ]
        current = sorted(leaves + packaged)
    lengths: dict[int, int] = {s: 0 for _, (s,) in leaves}
    for _, syms in current[: 2 * n - 2]:
        for s in syms:
            lengths[s] += 1
    return lengths


def canonical_codes(lengths: list[int]) -> list[int]:
    """RFC 1951 §3.2.2 canonical code assignment from code lengths."""
    max_len = max(lengths) if lengths else 0
    bl_count = [0] * (max_len + 1)
    for l in lengths:
        if l:
            bl_count[l] += 1
    code = 0
    next_code = [0] * (max_len + 2)
    for b in range(1, max_len + 1):
        code = (code + bl_count[b - 1]) << 1
        next_code[b] = code
    codes = [0] * len(lengths)
    for sym, l in enumerate(lengths):
        if l:
            codes[sym] = next_code[l]
            next_code[l] += 1
    return codes


# ---------------------------------------------------------------------------
# LZ77 match search (hash chains) — encode side
# ---------------------------------------------------------------------------

def lz77_parse(data: bytes, max_chain: int = 128,
               lazy: bool = True) -> list[tuple[int, int, int]]:
    """Greedy/lazy LZ77 parse.

    Returns tokens ``(literal, 0, byte)`` or ``(0, length, dist)`` — encoded
    as (is_literal, length, value).  Hash-chain search mirrors what the device
    encoder does with vectorized bounded-depth probes.
    """
    n = len(data)
    tokens: list[tuple[int, int, int]] = []
    if n < MIN_MATCH + 1:
        return [(1, 0, b) for b in data]
    HASH_BITS = 15
    head = [-1] * (1 << HASH_BITS)
    prev = [-1] * n

    def h3(i: int) -> int:
        return ((data[i] << 10) ^ (data[i + 1] << 5) ^ data[i + 2]) & ((1 << HASH_BITS) - 1)

    def insert(i: int) -> None:
        hh = h3(i)
        prev[i] = head[hh]
        head[hh] = i

    def best_match(i: int) -> tuple[int, int]:
        best_len, best_dist = 0, 0
        cand = head[h3(i)]
        chain = 0
        limit = min(MAX_MATCH, n - i)
        while cand >= 0 and chain < max_chain and i - cand <= WINDOW:
            if cand >= i:  # self/future entries (possible after lazy inserts)
                cand = prev[cand]
                continue
            # cheap filter: candidate must beat the current best at its tip
            if best_len < limit and data[cand + best_len] == data[i + best_len]:
                l = 0
                while l < limit and data[cand + l] == data[i + l]:
                    l += 1
                if l > best_len:
                    best_len, best_dist = l, i - cand
                    if l >= limit:
                        break
            cand = prev[cand]
            chain += 1
        return best_len, best_dist

    i = 0
    last_inserted = -1  # positions <= last_inserted are already in the chains

    def insert_upto(pos: int) -> None:
        nonlocal last_inserted
        for k in range(last_inserted + 1, min(pos + 1, n - MIN_MATCH + 1)):
            insert(k)
            last_inserted = k

    while i < n:
        if i + MIN_MATCH > n:
            tokens.append((1, 0, data[i]))
            i += 1
            continue
        insert_upto(i)
        mlen, mdist = best_match(i)
        if mlen >= MIN_MATCH and lazy and i + 1 + MIN_MATCH <= n:
            insert_upto(i + 1)
            nlen, _ = best_match(i + 1)
            if nlen > mlen:
                tokens.append((1, 0, data[i]))
                i += 1
                mlen, mdist = best_match(i)
        if mlen >= MIN_MATCH:
            tokens.append((0, mlen, mdist))
            insert_upto(i + mlen - 1)
            i += mlen
        else:
            tokens.append((1, 0, data[i]))
            i += 1
    return tokens


# ---------------------------------------------------------------------------
# Deflate (encoder)
# ---------------------------------------------------------------------------

def compress(data: bytes, mode: str = "dynamic", max_chain: int = 128) -> bytes:
    """Deflate ``data`` as a single final block.

    mode: 'stored' | 'fixed' | 'dynamic'.
    """
    bw = BitWriter()
    if mode == "stored":
        # possibly multiple stored blocks of <= 65535 bytes
        chunks = [data[i : i + 65535] for i in range(0, len(data), 65535)] or [b""]
        for ci, chunk in enumerate(chunks):
            final = 1 if ci == len(chunks) - 1 else 0
            bw.bits(final, 1)
            bw.bits(0, 2)
            bw.align_byte()
            ln = len(chunk)
            bw.out += bytes([ln & 0xFF, ln >> 8, (~ln) & 0xFF, ((~ln) >> 8) & 0xFF])
            bw.out += chunk
        return bw.finish()

    tokens = lz77_parse(data, max_chain=max_chain)
    bw.bits(1, 1)  # BFINAL
    if mode == "fixed":
        bw.bits(1, 2)
        lit_lengths = fixed_lit_lengths()
        dist_lengths = fixed_dist_lengths()
    else:
        bw.bits(2, 2)
        lit_lengths, dist_lengths = _dynamic_lengths(tokens)
        _write_dynamic_header(bw, lit_lengths, dist_lengths)
    lit_codes = canonical_codes(lit_lengths)
    dist_codes = canonical_codes(dist_lengths)
    for is_lit, length, value in tokens:
        if is_lit:
            bw.huff(lit_codes[value], lit_lengths[value])
        else:
            sym, eb, ev = length_to_code(length)
            bw.huff(lit_codes[sym], lit_lengths[sym])
            if eb:
                bw.bits(ev, eb)
            dsym, deb, dev = dist_to_code(value)
            bw.huff(dist_codes[dsym], dist_lengths[dsym])
            if deb:
                bw.bits(dev, deb)
    bw.huff(lit_codes[256], lit_lengths[256])
    return bw.finish()


def _dynamic_lengths(tokens) -> tuple[list[int], list[int]]:
    lit_freq: dict[int, int] = {256: 1}
    dist_freq: dict[int, int] = {}
    for is_lit, length, value in tokens:
        if is_lit:
            lit_freq[value] = lit_freq.get(value, 0) + 1
        else:
            sym, _, _ = length_to_code(length)
            lit_freq[sym] = lit_freq.get(sym, 0) + 1
            dsym, _, _ = dist_to_code(value)
            dist_freq[dsym] = dist_freq.get(dsym, 0) + 1
    lit_len_map = package_merge(lit_freq, MAX_BITS)
    lit_lengths = [0] * 286
    for s, l in lit_len_map.items():
        lit_lengths[s] = l
    dist_lengths = [0] * 30
    if not dist_freq:
        dist_lengths[0] = 1  # at least one dist code, like zlib emits
    else:
        dmap = package_merge(dist_freq, MAX_BITS)
        if len(dmap) == 1:
            ((s, _),) = dmap.items()
            dist_lengths[s] = 1
        else:
            for s, l in dmap.items():
                dist_lengths[s] = l
    return lit_lengths, dist_lengths


def _rle_code_lengths(lengths: list[int]) -> list[tuple[int, int, int]]:
    """Compress a code-length sequence with symbols 16/17/18 (RFC 3.2.7)."""
    out: list[tuple[int, int, int]] = []  # (symbol, extra bits, extra val)
    i = 0
    n = len(lengths)
    while i < n:
        l = lengths[i]
        run = 1
        while i + run < n and lengths[i + run] == l:
            run += 1
        if l == 0:
            r = run
            while r >= 11:
                take = min(r, 138)
                out.append((18, 7, take - 11))
                r -= take
            while r >= 3:
                take = min(r, 10)
                out.append((17, 3, take - 3))
                r -= take
            out += [(0, 0, 0)] * r
        else:
            out.append((l, 0, 0))
            r = run - 1
            while r >= 3:
                take = min(r, 6)
                out.append((16, 2, take - 3))
                r -= take
            out += [(l, 0, 0)] * r
        i += run
    return out


def _write_dynamic_header(bw: BitWriter, lit_lengths: list[int],
                          dist_lengths: list[int]) -> None:
    hlit = len(lit_lengths)
    while hlit > 257 and lit_lengths[hlit - 1] == 0:
        hlit -= 1
    hdist = len(dist_lengths)
    while hdist > 1 and dist_lengths[hdist - 1] == 0:
        hdist -= 1
    seq = lit_lengths[:hlit] + dist_lengths[:hdist]
    cl_tokens = _rle_code_lengths(seq)
    cl_freq: dict[int, int] = {}
    for sym, _, _ in cl_tokens:
        cl_freq[sym] = cl_freq.get(sym, 0) + 1
    cl_map = package_merge(cl_freq, MAX_CL_BITS)
    cl_lengths = [0] * 19
    if len(cl_map) == 1:
        ((s, _),) = cl_map.items()
        cl_lengths[s] = 1
    else:
        for s, l in cl_map.items():
            cl_lengths[s] = l
    cl_codes = canonical_codes(cl_lengths)
    hclen = 19
    while hclen > 4 and cl_lengths[CLCL_ORDER[hclen - 1]] == 0:
        hclen -= 1
    bw.bits(hlit - 257, 5)
    bw.bits(hdist - 1, 5)
    bw.bits(hclen - 4, 4)
    for i in range(hclen):
        bw.bits(cl_lengths[CLCL_ORDER[i]], 3)
    for sym, eb, ev in cl_tokens:
        bw.huff(cl_codes[sym], cl_lengths[sym])
        if eb:
            bw.bits(ev, eb)
