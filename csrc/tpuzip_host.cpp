// tpuzip host runtime — native C++ implementations of the host-side paths:
// container framing, checksums, and the threaded host stage of every codec
// (LZ4 block, RLE, DEFLATE, BWT, MTF, DC, the ari and bin/apm coders).
// These mirror tpuzip.oracle formats bit-exactly; the backend table
// (tpuzip/dist/backend.py) says which stages they serve on each platform.
//
// Build: make -C csrc   (produces libtpz_host.so; loaded via ctypes;
// tpuzip.runtime.native runs it at first use)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "ari_model.h"

namespace {

// Work-stealing parallel-for over independent blocks: host codec stages
// (LZ4 parse/compress, deflate, inflate-plan) are embarrassingly parallel,
// so batch entry points fan out across cores (atomic counter, no locks).
template <typename F>
void parallel_blocks(int64_t b, int nthreads, F fn) {
  if (nthreads <= 0)
    nthreads = (int)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;
  if (nthreads > b) nthreads = (int)b;
  if (nthreads <= 1) {
    for (int64_t i = 0; i < b; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve((size_t)nthreads);
  for (int t = 0; t < nthreads; ++t)
    pool.emplace_back([&]() {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= b) return;
        fn(i);
      }
    });
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- adler32
uint32_t tpz_adler32(const uint8_t* data, int64_t n, uint32_t start) {
  const uint32_t MOD = 65521;
  uint32_t s1 = start & 0xFFFF, s2 = (start >> 16) & 0xFFFF;
  int64_t i = 0;
  while (i < n) {
    int64_t end = i + 5552 < n ? i + 5552 : n;
    for (; i < end; ++i) {
      s1 += data[i];
      s2 += s1;
    }
    s1 %= MOD;
    s2 %= MOD;
  }
  return (s2 << 16) | s1;
}

// ---------------------------------------------------------------- xxh32
static inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Bulk 16-byte-stripe update for STREAMING xxh32 (the L4 frame writers'
// content checksum): v[0..3] is the caller-owned lane state; tail/total
// bookkeeping stays in Python (oracle.xxh32.Xxh32State semantics).
void tpz_xxh32_stripes(uint32_t* v, const uint8_t* p, int64_t nstripes) {
  const uint32_t P1 = 2654435761u, P2 = 2246822519u;
  uint32_t v1 = v[0], v2 = v[1], v3 = v[2], v4 = v[3];
  for (int64_t s = 0; s < nstripes; ++s) {
    uint32_t lane;
#define ROUND(vv)                     \
  memcpy(&lane, p, 4);                \
  vv = rotl32(vv + lane * P2, 13) * P1; \
  p += 4;
    ROUND(v1) ROUND(v2) ROUND(v3) ROUND(v4)
#undef ROUND
  }
  v[0] = v1;
  v[1] = v2;
  v[2] = v3;
  v[3] = v4;
}

uint32_t tpz_xxh32(const uint8_t* p, int64_t n, uint32_t seed) {
  const uint32_t P1 = 2654435761u, P2 = 2246822519u, P3 = 3266489917u,
                 P4 = 668265263u, P5 = 374761393u;
  const uint8_t* end = p + n;
  uint32_t h;
  if (n >= 16) {
    uint32_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 16;
    do {
      uint32_t lane;
#define ROUND(v)                 \
  memcpy(&lane, p, 4);           \
  v = rotl32(v + lane * P2, 13) * P1; \
  p += 4;
      ROUND(v1) ROUND(v2) ROUND(v3) ROUND(v4)
#undef ROUND
    } while (p <= limit);
    h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
  } else {
    h = seed + P5;
  }
  h += (uint32_t)n;
  while (p + 4 <= end) {
    uint32_t lane;
    memcpy(&lane, p, 4);
    h = rotl32(h + lane * P3, 17) * P4;
    p += 4;
  }
  while (p < end) h = rotl32(h + (*p++) * P5, 11) * P1;
  h ^= h >> 15;
  h *= P2;
  h ^= h >> 13;
  h *= P3;
  h ^= h >> 16;
  return h;
}


// first-mismatch match extension: 8 bytes per step + ctz, byte-identical
// to the scalar loop (pure length computation, no policy change)
static inline int64_t match_extend(const uint8_t* a, const uint8_t* b,
                                   int64_t limit) {
  int64_t m = 0;
  while (m + 8 <= limit) {
    uint64_t x, y;
    memcpy(&x, a + m, 8);
    memcpy(&y, b + m, 8);
    uint64_t d = x ^ y;
    if (d) return m + (__builtin_ctzll(d) >> 3);
    m += 8;
  }
  while (m < limit && a[m] == b[m]) ++m;
  return m;
}


// overlap-aware fast match copy (byte-identical to the naive loop):
// 16/8-byte wildcopy when the offset allows, memset for offset-1 runs,
// pattern replication for offsets 2..7; the wildcopy may scribble into
// [o+mlen, o+mlen+16) inside the buffer, which later writes overwrite —
// callers pass the writable capacity
static inline void match_copy(uint8_t* dst, int64_t o, int64_t off,
                              int64_t mlen, int64_t cap) {
  int64_t s = o - off;
  if (off >= 16 && o + mlen + 16 <= cap) {
    for (int64_t k = 0; k < mlen; k += 16)
      memcpy(dst + o + k, dst + s + k, 16);
  } else if (off >= 8) {
    int64_t k = 0;
    if (o + mlen + 8 <= cap) {
      for (; k < mlen; k += 8) memcpy(dst + o + k, dst + s + k, 8);
    } else {
      for (; k + 8 <= mlen; k += 8) memcpy(dst + o + k, dst + s + k, 8);
      for (; k < mlen; ++k) dst[o + k] = dst[s + k];
    }
  } else if (off == 1) {
    memset(dst + o, dst[s], (size_t)mlen);
  } else if (o + mlen + 16 <= cap) {
    // off in [2,7]: replicate the period into a 32-byte pattern buffer,
    // then stamp it at a stride that is a multiple of the period so the
    // phase stays aligned (stride in [12,16] bytes; <=15 scribble bytes)
    uint8_t pat[32];
    memcpy(pat, dst + s, (size_t)off);
    int64_t d = off;
    while (d < 16) {
      memcpy(pat + d, pat, (size_t)d);
      d *= 2;
    }
    int64_t stride = (16 / off) * off;
    for (int64_t k = 0; k < mlen; k += stride)
      memcpy(dst + o + k, pat, 16);
  } else {
    for (int64_t k = 0; k < mlen; ++k) dst[o + k] = dst[s + k];
  }
}

// ---------------------------------------------------------------- LZ4 block
// Greedy single-probe hash encoder, same policy/format as tpuzip.oracle.lz4.
int64_t tpz_lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                         int64_t cap, int hash_log) {
  const int HASH_LOG = (hash_log >= 4 && hash_log <= 24) ? hash_log : 16;
  const int64_t MFLIMIT = 12, LASTLIT = 5;
  if (n == 0) {
    if (cap < 1) return -1;
    dst[0] = 0;
    return 1;
  }
  std::vector<int64_t> table((size_t)1 << HASH_LOG, -1);
  int64_t anchor = 0, i = 0, o = 0;
  int64_t limit = n - MFLIMIT > 0 ? n - MFLIMIT : 0;
  auto emit_len = [&](int64_t len) {
    int64_t rem = len - 15;
    while (rem >= 255) {
      dst[o++] = 255;
      rem -= 255;
    }
    dst[o++] = (uint8_t)rem;
  };
  while (i < limit) {
    uint32_t seq;
    memcpy(&seq, src + i, 4);
    uint32_t h = (seq * 2654435761u) >> (32 - HASH_LOG);
    int64_t cand = table[h];
    table[h] = i;
    if (cand >= 0 && i - cand <= 0xFFFF &&
        memcmp(src + cand, src + i, 4) == 0) {
      int64_t end = n - LASTLIT;
      int64_t ext = (i + 4 < end)
                        ? match_extend(src + i + 4, src + cand + 4,
                                       end - (i + 4))
                        : 0;
      int64_t m = i + 4 + ext;
      int64_t mlen = m - i, lit = i - anchor;
      int64_t ml = mlen - 4;
      // worst case: token + lit-ext + literals + offset + match-ext bytes
      if (o + lit + 16 + lit / 255 + ml / 255 + 1 > cap) return -1;
      dst[o++] = (uint8_t)(((lit < 15 ? lit : 15) << 4) |
                           (ml < 15 ? ml : 15));
      if (lit >= 15) emit_len(lit);
      memcpy(dst + o, src + anchor, (size_t)lit);
      o += lit;
      uint16_t off = (uint16_t)(i - cand);
      memcpy(dst + o, &off, 2);
      o += 2;
      if (ml >= 15) emit_len(ml);
      i = m;
      anchor = m;
    } else {
      ++i;
    }
  }
  int64_t lit = n - anchor;
  if (o + lit + 1 + lit / 255 + 1 > cap) return -1;
  dst[o++] = (uint8_t)((lit < 15 ? lit : 15) << 4);
  if (lit >= 15) emit_len(lit);
  memcpy(dst + o, src + anchor, (size_t)lit);
  o += lit;
  return o;
}

int64_t tpz_lz4_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                           int64_t cap) {
  int64_t i = 0, o = 0;
  while (i < n) {
    uint8_t token = src[i++];
    int64_t lit = token >> 4;
    // shortcut fast path (the liblz4 trick): short literal run + short
    // match with input/output margin — two fixed-size wildcopies instead
    // of variable-length memcpy dispatch per sequence.  Bytes written
    // past the decoded length (within cap) are scribble, same contract
    // as match_copy.
    if (lit < 15 && i + 16 <= n && o + 18 <= cap) {
      memcpy(dst + o, src + i, 16);
      i += lit;
      o += lit;
      uint16_t off;
      memcpy(&off, src + i, 2);
      i += 2;
      if (off == 0 || off > o) return -1;
      int64_t ml = token & 0xF;
      if (ml != 15 && off >= 8 && o + 18 <= cap) {
        int64_t s = o - off;
        memcpy(dst + o, dst + s, 8);
        memcpy(dst + o + 8, dst + s + 8, 8);
        memcpy(dst + o + 16, dst + s + 16, 2);
        o += ml + 4;
        continue;
      }
      int64_t mlen = ml + 4;
      if (ml == 15) {
        uint8_t b;
        do {
          if (i >= n) return -1;
          b = src[i++];
          mlen += b;
        } while (b == 255);
      }
      if (o + mlen > cap) return -1;
      match_copy(dst, o, off, mlen, cap);
      o += mlen;
      continue;
    }
    if (lit == 15) {
      uint8_t b;
      do {
        if (i >= n) return -1;
        b = src[i++];
        lit += b;
      } while (b == 255);
    }
    if (i + lit > n || o + lit > cap) return -1;
    memcpy(dst + o, src + i, (size_t)lit);
    i += lit;
    o += lit;
    if (i >= n) break;
    if (i + 2 > n) return -1;
    uint16_t off;
    memcpy(&off, src + i, 2);
    i += 2;
    if (off == 0 || off > o) return -1;
    int64_t mlen = (token & 0xF) + 4;
    if ((token & 0xF) == 15) {
      uint8_t b;
      do {
        if (i >= n) return -1;
        b = src[i++];
        mlen += b;
      } while (b == 255);
    }
    if (o + mlen > cap) return -1;
    match_copy(dst, o, off, mlen, cap);
    o += mlen;
  }
  return o;
}

// lz4p: parallel-decodable columnar LZ (tpz-native; codecs/lz4p.py is the
// format owner).  Same greedy single-probe parse as tpz_lz4_compress,
// serialized as [S u32][orig u32][lit_lens u16 xS][mlens u16 xS]
// [offsets u16 xS][literals].  Decode is a sequential reconstruction at
// host speed (the device decoder resolves match rounds in parallel).
int64_t tpz_lz4p_encode(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap, int hash_log) {
  const int HASH_LOG = (hash_log >= 4 && hash_log <= 24) ? hash_log : 16;
  const int64_t MFLIMIT = 12, LASTLIT = 5;
  std::vector<uint16_t> lit_lens, mlens, offs;
  std::vector<int64_t> lit_starts;
  std::vector<int64_t> table((size_t)1 << HASH_LOG, -1);
  int64_t anchor = 0, i = 0;
  int64_t limit = n - MFLIMIT > 0 ? n - MFLIMIT : 0;
  auto push_seq = [&](int64_t lit0, int64_t lit, int64_t ml, int64_t off) {
    // u16 columns: split long runs into 65535-byte pieces with ml=0
    while (lit > 0xFFFF) {
      lit_starts.push_back(lit0);
      lit_lens.push_back(0xFFFF);
      mlens.push_back(0);
      offs.push_back(0);
      lit0 += 0xFFFF;
      lit -= 0xFFFF;
    }
    lit_starts.push_back(lit0);
    lit_lens.push_back((uint16_t)lit);
    while (ml > 0xFFFF) {
      mlens.push_back(0xFFFF);
      offs.push_back((uint16_t)off);
      lit_starts.push_back(lit0 + lit);
      lit_lens.push_back(0);
      ml -= 0xFFFF;
    }
    mlens.push_back((uint16_t)ml);
    offs.push_back((uint16_t)(ml ? off : 0));
  };
  while (i < limit) {
    uint32_t seq;
    memcpy(&seq, src + i, 4);
    uint32_t h = (seq * 2654435761u) >> (32 - HASH_LOG);
    int64_t cand = table[h];
    table[h] = i;
    if (cand >= 0 && i - cand <= 0xFFFF &&
        memcmp(src + cand, src + i, 4) == 0) {
      int64_t end = n - LASTLIT;
      int64_t ext = (i + 4 < end)
                        ? match_extend(src + i + 4, src + cand + 4,
                                       end - (i + 4))
                        : 0;
      int64_t m = i + 4 + ext;
      push_seq(anchor, i - anchor, m - i, i - cand);
      i = m;
      anchor = m;
    } else {
      ++i;
    }
  }
  if (n > anchor || lit_lens.empty())
    push_seq(anchor, n - anchor, 0, 0);
  int64_t S = (int64_t)lit_lens.size();
  int64_t total_lit = 0;
  for (uint16_t l : lit_lens) total_lit += l;
  int64_t need = 8 + 6 * S + total_lit;
  if (need > cap) return -1;
  uint32_t s32 = (uint32_t)S, o32 = (uint32_t)n;
  memcpy(dst, &s32, 4);
  memcpy(dst + 4, &o32, 4);
  uint8_t* p = dst + 8;
  memcpy(p, lit_lens.data(), (size_t)(2 * S));
  p += 2 * S;
  memcpy(p, mlens.data(), (size_t)(2 * S));
  p += 2 * S;
  memcpy(p, offs.data(), (size_t)(2 * S));
  p += 2 * S;
  for (int64_t t = 0; t < S; ++t) {
    memcpy(p, src + lit_starts[(size_t)t], lit_lens[(size_t)t]);
    p += lit_lens[(size_t)t];
  }
  return need;
}

int64_t tpz_lz4p_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap) {
  if (n == 0) return 0;  // padding/empty slot, not corruption
  if (n < 8) return -1;
  uint32_t S, on;
  memcpy(&S, src, 4);
  memcpy(&on, src + 4, 4);
  if ((int64_t)on > cap || 8 + 6 * (int64_t)S > n) return -1;
  const uint16_t* ll = (const uint16_t*)(src + 8);
  const uint16_t* ml = (const uint16_t*)(src + 8 + 2 * (int64_t)S);
  const uint16_t* of = (const uint16_t*)(src + 8 + 4 * (int64_t)S);
  const uint8_t* lit = src + 8 + 6 * (int64_t)S;
  const uint8_t* lit_end = src + n;
  int64_t o = 0;
  for (uint32_t t = 0; t < S; ++t) {
    int64_t l = ll[t];
    if (lit + l > lit_end || o + l > (int64_t)on) return -1;
    memcpy(dst + o, lit, (size_t)l);
    lit += l;
    o += l;
    int64_t m = ml[t];
    if (m) {
      int64_t off = of[t];
      if (off == 0 || off > o || o + m > (int64_t)on) return -1;
      match_copy(dst, o, off, m, (int64_t)on <= cap ? (int64_t)on : cap);
      o += m;
    }
  }
  if (o != (int64_t)on) return -1;
  return o;
}

void tpz_lz4p_encode_batch(const uint8_t* src, int64_t b, int64_t n,
                           const int32_t* lens, uint8_t* dst, int64_t dcap,
                           int64_t* out_lens, int hash_log, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    out_lens[i] = tpz_lz4p_encode(src + i * n, lens[i], dst + i * dcap,
                                  dcap, hash_log);
  });
}

void tpz_lz4p_decode_batch(const uint8_t* src, int64_t b, int64_t scap,
                           const int32_t* slens, uint8_t* dst, int64_t dcap,
                           int64_t* out_lens, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    out_lens[i] = tpz_lz4p_decode(src + i * scap, slens[i], dst + i * dcap,
                                  dcap);
  });
}

// Chained-match LZ4 encoder: same block format, greedy policy upgraded to
// best-of-chain (depth max_chain) — strictly denser matches than the
// single-probe reference policy, so compressed size only shrinks ("improve
// behind a flag"; max_chain=1 falls back to the reference-identical path).
int64_t tpz_lz4_compress_chained(const uint8_t* src, int64_t n, uint8_t* dst,
                                 int64_t cap, int max_chain, int hash_log) {
  if (max_chain <= 1) return tpz_lz4_compress(src, n, dst, cap, hash_log);
  const int HASH_LOG = (hash_log >= 4 && hash_log <= 24) ? hash_log : 16;
  const int64_t MFLIMIT = 12, LASTLIT = 5, WIN = 0xFFFF;
  if (n == 0) {
    if (cap < 1) return -1;
    dst[0] = 0;
    return 1;
  }
  std::vector<int32_t> head((size_t)1 << HASH_LOG, -1);
  std::vector<int32_t> prevc((size_t)n, -1);
  auto hash4 = [&](int64_t i) {
    uint32_t seq;
    memcpy(&seq, src + i, 4);
    return (seq * 2654435761u) >> (32 - HASH_LOG);
  };
  auto insert = [&](int64_t i) {
    if (i + 3 < n) {
      uint32_t h = hash4(i);
      prevc[(size_t)i] = head[h];
      head[h] = (int32_t)i;
    }
  };
  auto emit_len = [&](int64_t len, int64_t& o) {
    int64_t rem = len - 15;
    while (rem >= 255) {
      dst[o++] = 255;
      rem -= 255;
    }
    dst[o++] = (uint8_t)rem;
  };
  auto find_best = [&](int64_t i, int64_t lim, int64_t& bestpos) {
    int64_t best = 0;
    bestpos = -1;
    if (i + 3 < n) {
      int32_t c = head[hash4(i)];
      int chain = max_chain;
      while (c >= 0 && i - c <= WIN && chain-- > 0) {
        if (src[c + best] == src[i + best]) {  // cheap reject at cur best
          int64_t m = match_extend(src + c, src + i, lim - i);
          if (m > best) {
            best = m;
            bestpos = c;
            if (i + m >= lim) break;
          }
        }
        c = prevc[(size_t)c];
      }
    }
    return best;
  };
  int64_t anchor = 0, i = 0, o = 0;
  int64_t limit = n - MFLIMIT > 0 ? n - MFLIMIT : 0;
  int64_t lim = n - LASTLIT;
  while (i < limit) {
    int64_t bestpos;
    int64_t best = find_best(i, lim, bestpos);
    if (best < 4) {
      insert(i);
      ++i;
      continue;
    }
    // one-step lazy evaluation: defer when the next position holds a
    // strictly longer match (the deferred byte rides as a literal).
    // Each position is inserted exactly once — a double insert would
    // self-loop the chain and fabricate offset-0 matches.
    bool cur_inserted = false;
    while (i + 1 < limit) {
      insert(i);  // i becomes a distance-1 candidate for i+1 (runs)
      cur_inserted = true;
      int64_t bp2;
      int64_t b2 = find_best(i + 1, lim, bp2);
      if (b2 > best) {
        ++i;
        cur_inserted = false;
        best = b2;
        bestpos = bp2;
      } else {
        break;
      }
    }
    int64_t lit = i - anchor, ml = best - 4;
    if (o + lit + 16 + lit / 255 + ml / 255 + 1 > cap) return -1;
    dst[o++] = (uint8_t)(((lit < 15 ? lit : 15) << 4) |
                         (ml < 15 ? ml : 15));
    if (lit >= 15) emit_len(lit, o);
    memcpy(dst + o, src + anchor, (size_t)lit);
    o += lit;
    uint16_t off = (uint16_t)(i - bestpos);
    memcpy(dst + o, &off, 2);
    o += 2;
    if (ml >= 15) emit_len(ml, o);
    if (!cur_inserted) insert(i);
    for (int64_t e = i + best, k = i + 1; k < e; ++k) insert(k);
    i += best;
    anchor = i;
  }
  int64_t lit = n - anchor;
  if (o + lit + 1 + lit / 255 + 1 > cap) return -1;
  dst[o++] = (uint8_t)((lit < 15 ? lit : 15) << 4);
  if (lit >= 15) emit_len(lit, o);
  memcpy(dst + o, src + anchor, (size_t)lit);
  o += lit;
  return o;
}

void tpz_lz4_compress_chained_batch(const uint8_t* src, int64_t b,
                                    int64_t n, const int32_t* lens,
                                    uint8_t* dst, int64_t dcap,
                                    int64_t* out_lens, int max_chain,
                                    int hash_log, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    out_lens[i] = tpz_lz4_compress_chained(src + i * n, lens[i],
                                           dst + i * dcap, dcap, max_chain,
                                           hash_log);
  });
}

// LZ4 decode PLAN: parse the token stream at host speed and emit, for
// every output byte, the position of the compressed-stream LITERAL it
// ultimately copies from (matches resolved transitively, overlap included).
// The device then decodes with ONE bulk gather out[i] = comp[plan[i]] —
// the host-parse/device-copy-plan architecture (GPU-decoder style).
int64_t tpz_lz4_decode_plan(const uint8_t* src, int64_t n, int32_t* plan,
                            int64_t cap) {
  int64_t i = 0, o = 0;
  while (i < n) {
    uint8_t token = src[i++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (i >= n) return -1;
        b = src[i++];
        lit += b;
      } while (b == 255);
    }
    if (i + lit > n || o + lit > cap) return -1;
    for (int64_t k = 0; k < lit; ++k) plan[o + k] = (int32_t)(i + k);
    i += lit;
    o += lit;
    if (i >= n) break;
    if (i + 2 > n) return -1;
    uint16_t off;
    memcpy(&off, src + i, 2);
    i += 2;
    if (off == 0 || off > o) return -1;
    int64_t mlen = (token & 0xF) + 4;
    if ((token & 0xF) == 15) {
      uint8_t b;
      do {
        if (i >= n) return -1;
        b = src[i++];
        mlen += b;
      } while (b == 255);
    }
    if (o + mlen > cap) return -1;
    int64_t s = o - off;
    // transitive resolution: plan[s+k] is already a literal position
    // (overlapping matches read entries written earlier this iteration)
    for (int64_t k = 0; k < mlen; ++k) plan[o + k] = plan[s + k];
    o += mlen;
  }
  return o;
}

// -------------------------------------------------- run-based wplan parse
// The wplan builders used to materialize the full per-byte plan (4x the
// output in i32 writes, then a byte-addressed re-read — ~208 MB/s/thread).
// The round-4 parse instead full-decodes the block (fast: the shortcut
// decoder) while recording the output's RUN structure — each literal run
// is a contiguous comp slice; a match is contiguous iff its source range
// lies inside ONE earlier contiguous run (transitive contiguity resolved
// at run granularity, not per byte).  Plan emission then walks aligned
// W-byte windows against the run list: windows fully inside a contiguous
// run address the comp stream; everything else is an 8/16-byte memcpy
// from the decoded output into `patch`.  Window-level contiguity matches
// the byte plan's verdict exactly except for matches that splice bytes
// from TWO adjacent comp-contiguous runs — a measured-rare case that only
// moves a window from "addressed" to "patched" (the decode stays
// bit-identical; the device gather does not care which side serves it).

namespace {

struct LzRun {
  int64_t out_start;  // first output byte of this run
  int64_t comp_src;   // comp position of out_start when the run is a
                      // contiguous comp slice, else -1
};

// Full LZ4 block decode recording run structure.  dst must have >=16
// bytes of wildcopy slack beyond cap (callers decode into a thread-local
// scratch, never the user buffer).  Appends a {o, -1} sentinel.
int64_t lz4_decode_runs(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap, int64_t wcap,
                        std::vector<LzRun>& runs) {
  runs.clear();
  int64_t i = 0, o = 0;
  while (i < n) {
    uint8_t token = src[i++];
    int64_t lit = token >> 4;
    // shortcut fast path (same shape as tpz_lz4_decompress): a short
    // match (<24 bytes) never resolves contiguity, so its run entry is a
    // straight push — no search
    // guard: lit+match fit in cap (ml <= 18 here), and all wildcopies fit
    // in wcap (callers pass wcap >= cap + 32 >> the 19-byte match copy)
    if (lit < 15 && (token & 0xF) != 15 && i + 16 <= n &&
        o + lit + 18 <= cap) {
      if (lit > 0) runs.push_back({o, i});
      memcpy(dst + o, src + i, 16);
      i += lit;
      o += lit;
      uint16_t off;
      memcpy(&off, src + i, 2);
      i += 2;
      if (off == 0 || off > o) return -1;
      int64_t ml = (token & 0xF) + 4;
      runs.push_back({o, -1});
      if (off >= 8) {
        int64_t s = o - off;
        memcpy(dst + o, dst + s, 8);
        memcpy(dst + o + 8, dst + s + 8, 8);
        memcpy(dst + o + 16, dst + s + 16, 3);
      } else {
        match_copy(dst, o, off, ml, wcap);
      }
      o += ml;
      continue;
    }
    if (lit == 15) {
      uint8_t b;
      do {
        if (i >= n) return -1;
        b = src[i++];
        lit += b;
      } while (b == 255);
    }
    if (i + lit > n || o + lit > cap) return -1;
    if (lit > 0) {
      runs.push_back({o, i});
      if (i + lit + 16 <= n && o + lit + 16 <= wcap) {
        for (int64_t k = 0; k < lit; k += 16)
          memcpy(dst + o + k, src + i + k, 16);
      } else {
        memcpy(dst + o, src + i, (size_t)lit);
      }
      i += lit;
      o += lit;
    }
    if (i >= n) break;
    if (i + 2 > n) return -1;
    uint16_t off;
    memcpy(&off, src + i, 2);
    i += 2;
    if (off == 0 || off > o) return -1;
    int64_t mlen = (token & 0xF) + 4;
    if ((token & 0xF) == 15) {
      uint8_t b;
      do {
        if (i >= n) return -1;
        b = src[i++];
        mlen += b;
      } while (b == 255);
    }
    if (o + mlen > cap) return -1;
    int64_t s = o - off;
    int64_t csrc = -1;
    // Resolve transitive contiguity only for matches long enough to hold
    // aligned windows worth comp-addressing: the binary search's branch
    // misses cost more than patching the <=2 windows a short match spans
    // (the all-search variant measured 105 MB/s/thread vs 208 for the old
    // byte plan; the gate restores the win).
    if (mlen >= 24 && s + mlen <= o) {
      // last run with out_start <= s (runs is sorted, never empty here:
      // off <= o implies at least one literal run precedes)
      size_t lo = 0, hi = runs.size();
      while (hi - lo > 1) {
        size_t mid = (lo + hi) / 2;
        if (runs[mid].out_start <= s)
          lo = mid;
        else
          hi = mid;
      }
      int64_t rend = (lo + 1 < runs.size()) ? runs[lo + 1].out_start : o;
      if (runs[lo].comp_src >= 0 && s + mlen <= rend)
        csrc = runs[lo].comp_src + (s - runs[lo].out_start);
    }
    runs.push_back({o, csrc});
    match_copy(dst, o, off, mlen, wcap);
    o += mlen;
  }
  runs.push_back({o, -1});
  return o;
}

// Emit the W-byte-granular plan from the run structure, walking RUNS (not
// windows): each contiguous run's interior windows are an affine wplan
// fill, and every maximal span of patched windows is ONE bulk memcpy from
// the decoded output plus an affine negative-address fill — no per-window
// branching.  `out` needs W readable bytes past o (scratch slack);
// ragged-tail patch bytes past o are zeroed to preserve the old
// builders' contract.
int64_t wplan_from_runs(const uint8_t* out, int64_t o,
                        const std::vector<LzRun>& runs, int64_t W,
                        int32_t* wplan, uint8_t* patch, int64_t patch_cap,
                        int64_t* patch_used) {
  int64_t pu = 0;
  int64_t nwin = (o + W - 1) / W;
  int64_t w = 0;
  auto patch_span = [&](int64_t w_end) -> bool {  // patch windows [w,w_end)
    if (w_end <= w) return true;
    int64_t bytes = (w_end - w) * W;
    if (pu + bytes > patch_cap) return false;
    memcpy(patch + pu, out + w * W, (size_t)bytes);
    for (int64_t k = w; k < w_end; ++k)
      wplan[k] = (int32_t)(-((k - w) * W + pu + 1));
    pu += bytes;
    w = w_end;
    return true;
  };
  for (size_t r = 0; r + 1 < runs.size(); ++r) {
    if (runs[r].comp_src < 0) continue;
    int64_t a = runs[r].out_start, b = runs[r + 1].out_start;
    int64_t wlo = (a + W - 1) / W;  // windows [wlo, whi) fully inside
    int64_t whi = b / W;
    if (wlo < w) wlo = w;
    if (whi <= wlo) continue;
    if (!patch_span(wlo)) return -2;
    int64_t base = runs[r].comp_src - a;
    for (int64_t k = wlo; k < whi; ++k) wplan[k] = (int32_t)(base + k * W);
    w = whi;
  }
  if (!patch_span(nwin)) return -2;
  // only the final window can extend past o, and when it does (o % W != 0)
  // it is never a run interior, hence always the last patch entry
  if (o % W) memset(patch + pu - W + (o % W), 0, (size_t)(W - o % W));
  *patch_used = pu;
  return o;
}

int64_t wplan_generic(const uint8_t* src, int64_t n, int64_t W,
                      int32_t* wplan, uint8_t* patch, int64_t cap,
                      int64_t patch_cap, int64_t* patch_used) {
  thread_local std::vector<uint8_t> scratch;
  thread_local std::vector<LzRun> runs;
  if ((int64_t)scratch.size() < cap + 32) scratch.resize((size_t)cap + 32);
  int64_t o = lz4_decode_runs(src, n, scratch.data(), cap,
                              cap + 32, runs);
  if (o < 0) return o;
  return wplan_from_runs(scratch.data(), o, runs, W, wplan, patch,
                         patch_cap, patch_used);
}

}  // namespace

// LZ4 decode WORD plan: one i32 address per output *word* (4 bytes).
// Output words whose four source bytes are not contiguous in the
// compressed stream (run boundaries, overlapping matches, the ragged
// tail) are materialized into `patch` (4-byte aligned) and addressed as
// the negative entry -(patch_offset+1); the device reads them shift-free
// from a virtual table laid out as [comp row | patch row].  Returns the
// decoded length, -1 on corrupt stream, -2 when `patch` overflows
// (caller falls back to the byte plan).
int64_t tpz_lz4_decode_wplan(const uint8_t* src, int64_t n, int32_t* wplan,
                             uint8_t* patch, int64_t cap,
                             int64_t patch_cap, int64_t* patch_used) {
  return wplan_generic(src, n, 4, wplan, patch, cap, patch_cap, patch_used);
}

// LZ4 decode DWORD plan: one i32 address per output DOUBLE word (8 bytes),
// halving the device gather ROW count vs tpz_lz4_decode_wplan.  The device
// fetches three adjacent u32
// table words covering bytes addr..addr+11 and funnel-shifts two output
// words.  Same patch/status contract as tpz_lz4_decode_wplan.
int64_t tpz_lz4_decode_wplan8(const uint8_t* src, int64_t n, int32_t* wplan,
                              uint8_t* patch, int64_t cap,
                              int64_t patch_cap, int64_t* patch_used) {
  return wplan_generic(src, n, 8, wplan, patch, cap, patch_cap, patch_used);
}

// LZ4 decode QUAD-word plan: one i32 address per SIXTEEN output bytes —
// quarter the gather rows of tpz_lz4_decode_wplan.  The device fetches
// five adjacent u32 table words covering bytes addr..addr+19 and
// funnel-shifts four output words.  Non-contiguous quads go to `patch`
// (16-byte entries).  Same status contract.
int64_t tpz_lz4_decode_wplan16(const uint8_t* src, int64_t n,
                               int32_t* wplan, uint8_t* patch, int64_t cap,
                               int64_t patch_cap, int64_t* patch_used) {
  return wplan_generic(src, n, 16, wplan, patch, cap, patch_cap,
                       patch_used);
}

// Threaded full LZ4 host decode (production path when the output lands on
// the host anyway — same migration rule as rle/deflate/bwt-inverse; the
// device copy plans remain the decode-into-device-memory serving path and
// the device formulation's cross-check).
void tpz_lz4_decompress_batch(const uint8_t* src, int64_t b, int64_t scap,
                              const int32_t* slens, uint8_t* dst,
                              int64_t dcap, int64_t* out_lens,
                              int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    out_lens[i] = tpz_lz4_decompress(src + i * scap, slens[i],
                                     dst + i * dcap, dcap);
  });
}

void tpz_lz4_decode_wplan16_batch(const uint8_t* src, int64_t b,
                                  int64_t scap, const int32_t* slens,
                                  int32_t* wplans, int64_t nw,
                                  uint8_t* patches, int64_t patch_cap,
                                  int64_t out_cap, int64_t* out_lens,
                                  int64_t* patch_used, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    int64_t pu = 0;
    out_lens[i] = tpz_lz4_decode_wplan16(src + i * scap, slens[i],
                                         wplans + i * nw,
                                         patches + i * patch_cap, out_cap,
                                         patch_cap, &pu);
    patch_used[i] = pu;
  });
}

void tpz_lz4_decode_wplan8_batch(const uint8_t* src, int64_t b,
                                 int64_t scap, const int32_t* slens,
                                 int32_t* wplans, int64_t nw,
                                 uint8_t* patches, int64_t patch_cap,
                                 int64_t out_cap, int64_t* out_lens,
                                 int64_t* patch_used, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    int64_t pu = 0;
    out_lens[i] = tpz_lz4_decode_wplan8(src + i * scap, slens[i],
                                        wplans + i * nw,
                                        patches + i * patch_cap, out_cap,
                                        patch_cap, &pu);
    patch_used[i] = pu;
  });
}

// ---------------------------------------------------------------- inflate
// RFC 1951 inflate (production host path for the deflate/zlib containers;
// the device symbol-loop formulation in codecs/deflate.py is the device
// reference and cross-checks this).  Canonical Huffman decode, puff-style
// count/offset tables.
namespace {

struct BitRd {
  const uint8_t* p;
  int64_t n, pos = 0;
  uint32_t buf = 0;
  int cnt = 0;
  bool ok = true;
  uint32_t bits(int k) {
    while (cnt < k) {
      if (pos >= n) { ok = false; return 0; }
      buf |= (uint32_t)p[pos++] << cnt;
      cnt += 8;
    }
    uint32_t v = buf & ((1u << k) - 1);
    buf >>= k;
    cnt -= k;
    return v;
  }
  // peek k bits without consuming; zero-padded past the stream end (a
  // valid stream never decodes into the padding)
  uint32_t peek(int k) {
    while (cnt < k && pos < n) {
      buf |= (uint32_t)p[pos++] << cnt;
      cnt += 8;
    }
    return buf & ((1u << k) - 1);
  }
  void consume(int k) {
    buf >>= k;
    cnt -= k;
  }
};

struct Huf {
  // canonical decode tables: count[len], symbols sorted by (len, sym),
  // plus a 10-bit root lookup (zlib-style): fast[peeked bits] packs
  // (len << 12 | sym) for codes <= FAST_BITS long; longer codes take the
  // bit-by-bit canonical walk.
  static const int FAST_BITS = 10;
  int16_t count[16];
  int16_t sym[320];
  uint16_t fast[1 << FAST_BITS];
  bool build(const uint8_t* lengths, int n) {
    for (int i = 0; i < 16; ++i) count[i] = 0;
    for (int i = 0; i < n; ++i) count[lengths[i]]++;
    if (count[0] == n) return false;
    int left = 1;
    for (int l = 1; l < 16; ++l) {
      left = (left << 1) - count[l];
      if (left < 0) return false;  // oversubscribed
    }
    int16_t offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; ++l) offs[l + 1] = offs[l] + count[l];
    for (int i = 0; i < n; ++i)
      if (lengths[i]) sym[offs[lengths[i]]++] = (int16_t)i;
    // root table: canonical first-code arithmetic, indices are the next
    // FAST_BITS stream bits (LSB-first), so codes enter bit-reversed
    memset(fast, 0, sizeof(fast));
    int code = 0, index = 0;
    for (int l = 1; l <= FAST_BITS; ++l) {
      code <<= 1;
      for (int k = 0; k < count[l]; ++k, ++code, ++index) {
        // reverse the l-bit code
        uint32_t rev = 0, c = (uint32_t)code;
        for (int b = 0; b < l; ++b) {
          rev = (rev << 1) | (c & 1);
          c >>= 1;
        }
        uint16_t entry = (uint16_t)((l << 12) | (uint16_t)sym[index]);
        for (uint32_t j = rev; j < (1u << FAST_BITS); j += (1u << l))
          fast[j] = entry;
      }
    }
    return true;
  }
  int decode(BitRd& br) const {
    uint16_t e = fast[br.peek(FAST_BITS)];
    if (e) {
      int l = e >> 12;
      // peek() zero-pads at the stream end; a code longer than the bits
      // actually left must fail like bits() would
      if (br.cnt < l) { br.ok = false; return -1; }
      br.consume(l);
      return (int)(e & 0xFFF);
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l < 16; ++l) {
      code |= (int)br.bits(1);
      if (!br.ok) return -1;
      int c = count[l];
      if (code - first < c) return sym[index + (code - first)];
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    return -1;
  }
};

const int16_t kLenBase[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,35,
                              43,51,59,67,83,99,115,131,163,195,227,258};
const int16_t kLenEb[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,3,3,3,3,4,4,4,
                            4,5,5,5,5,0};
const int32_t kDistBase[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,193,
                               257,385,513,769,1025,1537,2049,3073,4097,
                               6145,8193,12289,16385,24577};
const int16_t kDistEb[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,7,7,8,8,9,9,
                             10,10,11,11,12,12,13,13};

}  // namespace

int64_t tpz_inflate(const uint8_t* src, int64_t n, uint8_t* dst,
                    int64_t cap) {
  BitRd br{src, n};
  int64_t o = 0;
  for (;;) {
    uint32_t fin = br.bits(1), btype = br.bits(2);
    if (!br.ok) return -1;
    if (btype == 0) {
      br.buf = 0; br.cnt = 0;  // align
      if (br.pos + 4 > n) return -1;
      uint32_t ln = src[br.pos] | (src[br.pos + 1] << 8);
      uint32_t nln = src[br.pos + 2] | (src[br.pos + 3] << 8);
      if (ln != (~nln & 0xFFFFu)) return -1;
      br.pos += 4;
      if (br.pos + (int64_t)ln > n || o + (int64_t)ln > cap) return -1;
      memcpy(dst + o, src + br.pos, ln);
      br.pos += ln;
      o += ln;
    } else if (btype == 1 || btype == 2) {
      Huf lit, dist;
      if (btype == 1) {
        uint8_t ll[288], dl[30];
        for (int i = 0; i < 144; ++i) ll[i] = 8;
        for (int i = 144; i < 256; ++i) ll[i] = 9;
        for (int i = 256; i < 280; ++i) ll[i] = 7;
        for (int i = 280; i < 288; ++i) ll[i] = 8;
        for (int i = 0; i < 30; ++i) dl[i] = 5;
        lit.build(ll, 288);
        dist.build(dl, 30);
      } else {
        static const int ord[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,
                                    2,14,1,15};
        int hlit = (int)br.bits(5) + 257;
        int hdist = (int)br.bits(5) + 1;
        int hclen = (int)br.bits(4) + 4;
        if (!br.ok || hlit > 286 || hdist > 30) return -1;
        uint8_t cl[19] = {0};
        for (int i = 0; i < hclen; ++i) cl[ord[i]] = (uint8_t)br.bits(3);
        Huf clh;
        if (!br.ok || !clh.build(cl, 19)) return -1;
        uint8_t lens[286 + 30] = {0};
        int i = 0;
        while (i < hlit + hdist) {
          int s = clh.decode(br);
          if (s < 0) return -1;
          if (s < 16) { lens[i++] = (uint8_t)s; continue; }
          int rep, val = 0;
          if (s == 16) {
            if (i == 0) return -1;
            val = lens[i - 1];
            rep = 3 + (int)br.bits(2);
          } else if (s == 17) rep = 3 + (int)br.bits(3);
          else rep = 11 + (int)br.bits(7);
          if (!br.ok || i + rep > hlit + hdist) return -1;
          while (rep--) lens[i++] = (uint8_t)val;
        }
        if (!lit.build(lens, hlit)) return -1;
        uint8_t dl2[30] = {0};
        memcpy(dl2, lens + hlit, hdist);
        bool dok = dist.build(dl2, 30);
        if (!dok) {
          // all-zero dist lengths: legal when no matches occur
          for (int k = 0; k < 16; ++k) dist.count[k] = 0;
        }
      }
      for (;;) {
        int s = lit.decode(br);
        if (s < 0) return -1;
        if (s < 256) {
          if (o >= cap) return -1;
          dst[o++] = (uint8_t)s;
        } else if (s == 256) {
          break;
        } else {
          s -= 257;
          if (s >= 29) return -1;
          int64_t mlen = kLenBase[s] + (int64_t)br.bits(kLenEb[s]);
          int ds = dist.decode(br);
          if (ds < 0 || ds >= 30) return -1;
          int64_t dd = kDistBase[ds] + (int64_t)br.bits(kDistEb[ds]);
          if (!br.ok || dd > o || o + mlen > cap) return -1;
          match_copy(dst, o, dd, mlen, cap);
          o += mlen;
        }
      }
    } else {
      return -1;
    }
    if (fin) break;
  }
  return o;
}

// inflate PLAN: host does the bit-serial Huffman work and emits (a) the
// literal byte sequence and (b) for every output byte the index of the
// literal it copies from (matches resolved transitively, as in
// tpz_lz4_decode_plan); the device materializes the output as one bulk
// gather.  Mirrors the LZ4 host-parse/device-copy-plan architecture.
int64_t tpz_inflate_plan(const uint8_t* src, int64_t n, int32_t* plan,
                         uint8_t* lits, int64_t cap, int64_t* nlit_out) {
  BitRd br{src, n};
  int64_t o = 0, nl = 0;
  for (;;) {
    uint32_t fin = br.bits(1), btype = br.bits(2);
    if (!br.ok) return -1;
    if (btype == 0) {
      br.buf = 0; br.cnt = 0;
      if (br.pos + 4 > n) return -1;
      uint32_t ln = src[br.pos] | (src[br.pos + 1] << 8);
      uint32_t nln = src[br.pos + 2] | (src[br.pos + 3] << 8);
      if (ln != (~nln & 0xFFFFu)) return -1;
      br.pos += 4;
      if (br.pos + (int64_t)ln > n || o + (int64_t)ln > cap) return -1;
      for (uint32_t k = 0; k < ln; ++k) {
        lits[nl] = src[br.pos + k];
        plan[o++] = (int32_t)nl++;
      }
      br.pos += ln;
    } else if (btype == 1 || btype == 2) {
      Huf lit, dist;
      if (btype == 1) {
        uint8_t ll[288], dl[30];
        for (int i = 0; i < 144; ++i) ll[i] = 8;
        for (int i = 144; i < 256; ++i) ll[i] = 9;
        for (int i = 256; i < 280; ++i) ll[i] = 7;
        for (int i = 280; i < 288; ++i) ll[i] = 8;
        for (int i = 0; i < 30; ++i) dl[i] = 5;
        lit.build(ll, 288);
        dist.build(dl, 30);
      } else {
        static const int ord[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,
                                    2,14,1,15};
        int hlit = (int)br.bits(5) + 257;
        int hdist = (int)br.bits(5) + 1;
        int hclen = (int)br.bits(4) + 4;
        if (!br.ok || hlit > 286 || hdist > 30) return -1;
        uint8_t cl[19] = {0};
        for (int i = 0; i < hclen; ++i) cl[ord[i]] = (uint8_t)br.bits(3);
        Huf clh;
        if (!br.ok || !clh.build(cl, 19)) return -1;
        uint8_t lens[286 + 30] = {0};
        int i = 0;
        while (i < hlit + hdist) {
          int s = clh.decode(br);
          if (s < 0) return -1;
          if (s < 16) { lens[i++] = (uint8_t)s; continue; }
          int rep, val = 0;
          if (s == 16) {
            if (i == 0) return -1;
            val = lens[i - 1];
            rep = 3 + (int)br.bits(2);
          } else if (s == 17) rep = 3 + (int)br.bits(3);
          else rep = 11 + (int)br.bits(7);
          if (!br.ok || i + rep > hlit + hdist) return -1;
          while (rep--) lens[i++] = (uint8_t)val;
        }
        if (!lit.build(lens, hlit)) return -1;
        uint8_t dl2[30] = {0};
        memcpy(dl2, lens + hlit, hdist);
        if (!dist.build(dl2, 30))
          for (int k = 0; k < 16; ++k) dist.count[k] = 0;
      }
      for (;;) {
        int s = lit.decode(br);
        if (s < 0) return -1;
        if (s < 256) {
          if (o >= cap) return -1;
          lits[nl] = (uint8_t)s;
          plan[o++] = (int32_t)nl++;
        } else if (s == 256) {
          break;
        } else {
          s -= 257;
          if (s >= 29) return -1;
          int64_t mlen = kLenBase[s] + (int64_t)br.bits(kLenEb[s]);
          int ds = dist.decode(br);
          if (ds < 0 || ds >= 30) return -1;
          int64_t dd = kDistBase[ds] + (int64_t)br.bits(kDistEb[ds]);
          if (!br.ok || dd > o || o + mlen > cap) return -1;
          for (int64_t k = 0; k < mlen; ++k) plan[o + k] = plan[o - dd + k];
          o += mlen;
        }
      }
    } else {
      return -1;
    }
    if (fin) break;
  }
  *nlit_out = nl;
  return o;
}

// ---------------------------------------------------------------- deflate
// RFC 1951 encoder (production host path; the device bulk stages in
// codecs/deflate.py are the device formulation).  Greedy hash-chain LZ77 +
// package-merge length-limited dynamic Huffman, one final block.
namespace {

struct BitWr {
  uint8_t* p;
  int64_t cap, pos = 0;
  uint64_t buf = 0;
  int cnt = 0;
  bool ok = true;
  void bits(uint32_t v, int k) {
    buf |= (uint64_t)v << cnt;
    cnt += k;
    while (cnt >= 8) {
      if (pos >= cap) { ok = false; cnt = 0; return; }
      p[pos++] = (uint8_t)buf;
      buf >>= 8;
      cnt -= 8;
    }
  }
  void flush() {
    if (!cnt) return;
    if (pos >= cap) { ok = false; cnt = 0; return; }
    p[pos++] = (uint8_t)buf; buf = 0; cnt = 0;
  }
};

// package-merge: optimal length-limited code lengths for freqs > 0
void package_merge(const int32_t* freq, int n, int maxbits,
                   uint8_t* lens) {
  struct Item { int64_t w; std::vector<int16_t> syms; };
  std::vector<int16_t> active;
  for (int s = 0; s < n; ++s) {
    lens[s] = 0;
    if (freq[s] > 0) active.push_back((int16_t)s);
  }
  if (active.empty()) return;
  if (active.size() == 1) { lens[active[0]] = 1; return; }
  std::vector<Item> prev;
  for (int level = 0; level < maxbits; ++level) {
    std::vector<Item> cur;
    for (int16_t s : active) cur.push_back({freq[s], {s}});
    for (size_t i = 0; i + 1 < prev.size(); i += 2) {
      Item m{prev[i].w + prev[i + 1].w, prev[i].syms};
      m.syms.insert(m.syms.end(), prev[i + 1].syms.begin(),
                    prev[i + 1].syms.end());
      cur.push_back(std::move(m));
    }
    std::sort(cur.begin(), cur.end(),
              [](const Item& a, const Item& b) { return a.w < b.w; });
    prev = std::move(cur);
  }
  size_t take = 2 * active.size() - 2;
  for (size_t i = 0; i < take && i < prev.size(); ++i)
    for (int16_t s : prev[i].syms) lens[s]++;
}

void canon_codes(const uint8_t* lens, int n, uint16_t* codes) {
  int cnt[16] = {0};
  for (int i = 0; i < n; ++i) cnt[lens[i]]++;
  cnt[0] = 0;
  uint32_t code = 0;
  uint32_t next[16] = {0};
  for (int l = 1; l < 16; ++l) {
    code = (code + cnt[l - 1]) << 1;
    next[l] = code;
  }
  for (int i = 0; i < n; ++i) {
    if (!lens[i]) { codes[i] = 0; continue; }
    uint32_t c = next[lens[i]]++;
    // bit-reverse to LSB-first emission order
    uint32_t r = 0;
    for (int k = 0; k < lens[i]; ++k) r |= ((c >> k) & 1) << (lens[i] - 1 - k);
    codes[i] = (uint16_t)r;
  }
}

int len_code_of(int l) {
  for (int i = 28; i >= 0; --i)
    if (l >= kLenBase[i]) return i;
  return 0;
}

int dist_code_of(int64_t d) {
  for (int i = 29; i >= 0; --i)
    if (d >= kDistBase[i]) return i;
  return 0;
}

}  // namespace

// mode: 0 = dynamic Huffman, 1 = fixed Huffman, 2 = stored blocks —
// the reference's block-type pick (RFC 1951 BTYPE), same LZ77 tokens for
// dynamic/fixed; stored skips LZ77 entirely.
// deflate_impl: the encoder body shared by tpz_deflate (final_flag=1:
// a complete stream, BFINAL set on the last block) and
// tpz_deflate_fragment (final_flag=0: every block BFINAL=0 and the
// output ends BYTE-ALIGNED via an empty stored block — Z_SYNC_FLUSH — so
// fragments from independent encoder calls splice into one stream, the
// L4 ZlibWriter's batching contract).
static int64_t deflate_impl(const uint8_t* src, int64_t n, uint8_t* dst,
                            int64_t cap, int max_chain, int mode,
                            int final_flag) {
  if (mode == 2) {
    // stored: <= 65535-byte blocks, byte-aligned LEN/NLEN + raw copy
    int64_t o = 0, i = 0;
    do {
      int64_t take = n - i > 65535 ? 65535 : n - i;
      if (o + 5 + take > cap) return -1;
      // BFINAL, BTYPE=00 (bits 1-2); already byte-aligned, so fragments
      // need no trailing sync block in stored mode
      dst[o++] = (final_flag && i + take >= n) ? 1 : 0;
      uint16_t ln = (uint16_t)take, nl = (uint16_t)~take;
      dst[o++] = (uint8_t)(ln & 0xFF);
      dst[o++] = (uint8_t)(ln >> 8);
      dst[o++] = (uint8_t)(nl & 0xFF);
      dst[o++] = (uint8_t)(nl >> 8);
      memcpy(dst + o, src + i, (size_t)take);
      o += take;
      i += take;
    } while (i < n);
    return o;
  }
  // ---- greedy hash-chain LZ77
  const int HB = 15, MINM = 3, MAXM = 258;
  const int64_t WIN = 32768;
  std::vector<int32_t> head(1 << HB, -1), prevc(n > 0 ? n : 1, -1);
  std::vector<int32_t> lit, mlens, mdists;
  lit.reserve(n + 1);
  mlens.reserve(n + 1);
  mdists.reserve(n + 1);
  auto hash3 = [&](int64_t i) {
    uint32_t v = src[i] | (src[i + 1] << 8) | ((uint32_t)src[i + 2] << 16);
    return (v * 2654435761u) >> (32 - HB);
  };
  auto insert = [&](int64_t i) {
    if (i + 2 < n) {
      uint32_t h = hash3(i);
      prevc[i] = head[h];
      head[h] = (int32_t)i;
    }
  };
  auto best_at = [&](int64_t i, int64_t& bestd) {
    int best = 0;
    bestd = 0;
    if (i + MINM <= n && i + 2 < n) {
      int32_t c = head[hash3(i)];
      int chain = max_chain;
      int lim = (int)std::min<int64_t>(MAXM, n - i);
      while (c >= 0 && i - c <= WIN && chain-- > 0) {
        int l = (int)match_extend(src + c, src + i, lim);
        if (l > best) {
          best = l;
          bestd = i - c;
          if (l >= lim) break;
        }
        c = prevc[c];
      }
    }
    return best;
  };
  int64_t i = 0;
  while (i < n) {
    int64_t bestd;
    int best = best_at(i, bestd);
    if (best >= MINM) {
      // one-step lazy evaluation (zlib levels >= 6 do the same): defer
      // when the next position matches strictly longer; each position
      // inserts into the chain exactly once
      bool cur_inserted = false;
      while (i + 1 + MINM <= n) {
        insert(i);
        cur_inserted = true;
        int64_t bd2;
        int b2 = best_at(i + 1, bd2);
        if (b2 > best) {
          lit.push_back(src[i]);
          mlens.push_back(0);
          mdists.push_back(0);
          ++i;
          cur_inserted = false;
          best = b2;
          bestd = bd2;
        } else {
          break;
        }
      }
      lit.push_back(-1);
      mlens.push_back(best);
      mdists.push_back((int32_t)bestd);
      if (!cur_inserted) insert(i);
      for (int64_t e = i + best, k = i + 1; k < e; ++k) insert(k);
      i += best;
    } else {
      lit.push_back(src[i]);
      mlens.push_back(0);
      mdists.push_back(0);
      insert(i);
      ++i;
    }
  }
  // ---- histograms
  uint8_t llen_f[288] = {0}, dlen_f[30] = {0};
  if (mode == 1) {
    // RFC 1951 fixed code lengths (canonical construction below yields
    // exactly the spec's fixed codes)
    for (int s = 0; s < 288; ++s)
      llen_f[s] = s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
    for (int s = 0; s < 30; ++s) dlen_f[s] = 5;
    uint16_t lcode[288], dcode[30];
    canon_codes(llen_f, 288, lcode);
    canon_codes(dlen_f, 30, dcode);
    BitWr bw{dst, cap};
    bw.bits(final_flag ? 1u : 0u, 1);  // BFINAL
    bw.bits(1, 2);  // fixed
    for (size_t t = 0; t < lit.size(); ++t) {
      if (lit[t] >= 0) {
        bw.bits(lcode[lit[t]], llen_f[lit[t]]);
      } else {
        int lc = len_code_of(mlens[t]);
        bw.bits(lcode[257 + lc], llen_f[257 + lc]);
        if (kLenEb[lc]) bw.bits((uint32_t)(mlens[t] - kLenBase[lc]),
                                kLenEb[lc]);
        int dc = dist_code_of(mdists[t]);
        bw.bits(dcode[dc], dlen_f[dc]);
        if (kDistEb[dc]) bw.bits((uint32_t)(mdists[t] - kDistBase[dc]),
                                 kDistEb[dc]);
      }
    }
    bw.bits(lcode[256], llen_f[256]);
    if (!final_flag) bw.bits(0, 3);  // sync-flush stored header
    bw.flush();
    if (!bw.ok) return -1;
    if (!final_flag) {
      if (bw.pos + 4 > cap) return -1;
      dst[bw.pos++] = 0x00;  // LEN = 0
      dst[bw.pos++] = 0x00;
      dst[bw.pos++] = 0xFF;  // NLEN
      dst[bw.pos++] = 0xFF;
    }
    return bw.pos;
  }
  int32_t lfreq[286] = {0}, dfreq[30] = {0};
  for (size_t t = 0; t < lit.size(); ++t) {
    if (lit[t] >= 0) {
      lfreq[lit[t]]++;
    } else {
      lfreq[257 + len_code_of(mlens[t])]++;
      dfreq[dist_code_of(mdists[t])]++;
    }
  }
  lfreq[256] = 1;  // EOB
  uint8_t llen[286] = {0}, dlen[30] = {0};
  package_merge(lfreq, 286, 15, llen);
  package_merge(dfreq, 30, 15, dlen);
  {
    // degenerate tables need >= 1 code (and dist table >= 1 length even
    // when unused, to keep common inflators happy)
    int nl = 0;
    for (int s = 0; s < 286; ++s) nl += llen[s] != 0;
    if (nl == 1)
      for (int s = 0; s < 286; ++s)
        if (llen[s]) { llen[s] = 1; llen[s ? 0 : 1] = 1; break; }
    int nd = 0;
    for (int s = 0; s < 30; ++s) nd += dlen[s] != 0;
    if (nd == 0) dlen[0] = 1;
    if (nd == 1)
      for (int s = 0; s < 30; ++s)
        if (dlen[s]) { dlen[s] = 1; break; }
  }
  uint16_t lcode[286], dcode[30];
  canon_codes(llen, 286, lcode);
  canon_codes(dlen, 30, dcode);

  // ---- dynamic header: code-length alphabet with 16/17/18 runs
  int hlit = 286, hdist = 30;
  while (hlit > 257 && llen[hlit - 1] == 0) --hlit;
  while (hdist > 1 && dlen[hdist - 1] == 0) --hdist;
  uint8_t all[316];
  int nall = 0;
  for (int s = 0; s < hlit; ++s) all[nall++] = llen[s];
  for (int s = 0; s < hdist; ++s) all[nall++] = dlen[s];
  // RLE the length sequence
  int clsym[350], clextra[350], clbits[350];
  int ncl = 0;
  int32_t clfreq[19] = {0};
  for (int s = 0; s < nall;) {
    int v = all[s], run = 1;
    while (s + run < nall && all[s + run] == v) ++run;
    const int run0 = run;
    if (v == 0) {
      while (run >= 3) {
        int take = run > 138 ? 138 : run;
        if (take >= 11) {
          clsym[ncl] = 18; clextra[ncl] = take - 11; clbits[ncl] = 7;
        } else {
          clsym[ncl] = 17; clextra[ncl] = take - 3; clbits[ncl] = 3;
        }
        clfreq[clsym[ncl]]++; ++ncl; run -= take;
      }
      while (run-- > 0) { clsym[ncl] = 0; clextra[ncl] = 0;
        clbits[ncl] = 0; clfreq[0]++; ++ncl; }
    } else {
      clsym[ncl] = v; clextra[ncl] = 0; clbits[ncl] = 0;
      clfreq[v]++; ++ncl; --run;
      while (run >= 3) {
        int take = run > 6 ? 6 : run;
        clsym[ncl] = 16; clextra[ncl] = take - 3; clbits[ncl] = 2;
        clfreq[16]++; ++ncl; run -= take;
      }
      while (run-- > 0) { clsym[ncl] = v; clextra[ncl] = 0;
        clbits[ncl] = 0; clfreq[v]++; ++ncl; }
    }
    s += run0;
  }
  uint8_t cllen[19] = {0};
  package_merge(clfreq, 19, 7, cllen);
  {
    int nc = 0;
    for (int s = 0; s < 19; ++s) nc += cllen[s] != 0;
    if (nc == 1)
      for (int s = 0; s < 19; ++s)
        if (cllen[s]) { cllen[s] = 1; cllen[s ? 0 : 1] = 1; break; }
  }
  uint16_t clcode[19];
  canon_codes(cllen, 19, clcode);
  static const int ord[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,2,14,
                              1,15};
  int hclen = 19;
  while (hclen > 4 && cllen[ord[hclen - 1]] == 0) --hclen;

  // ---- emit
  BitWr bw{dst, cap};
  bw.bits(final_flag ? 1u : 0u, 1);  // BFINAL
  bw.bits(2, 2);  // dynamic
  bw.bits((uint32_t)(hlit - 257), 5);
  bw.bits((uint32_t)(hdist - 1), 5);
  bw.bits((uint32_t)(hclen - 4), 4);
  for (int s = 0; s < hclen; ++s) bw.bits(cllen[ord[s]], 3);
  for (int t = 0; t < ncl; ++t) {
    bw.bits(clcode[clsym[t]], cllen[clsym[t]]);
    if (clbits[t]) bw.bits((uint32_t)clextra[t], clbits[t]);
  }
  for (size_t t = 0; t < lit.size(); ++t) {
    if (lit[t] >= 0) {
      bw.bits(lcode[lit[t]], llen[lit[t]]);
    } else {
      int lc = len_code_of(mlens[t]);
      bw.bits(lcode[257 + lc], llen[257 + lc]);
      if (kLenEb[lc]) bw.bits((uint32_t)(mlens[t] - kLenBase[lc]),
                              kLenEb[lc]);
      int dc = dist_code_of(mdists[t]);
      bw.bits(dcode[dc], dlen[dc]);
      if (kDistEb[dc]) bw.bits((uint32_t)(mdists[t] - kDistBase[dc]),
                               kDistEb[dc]);
    }
  }
  bw.bits(lcode[256], llen[256]);
  if (!final_flag) bw.bits(0, 3);  // sync-flush stored header
  bw.flush();
  if (!bw.ok) return -1;
  if (!final_flag) {
    if (bw.pos + 4 > cap) return -1;
    dst[bw.pos++] = 0x00;  // LEN = 0
    dst[bw.pos++] = 0x00;
    dst[bw.pos++] = 0xFF;  // NLEN
    dst[bw.pos++] = 0xFF;
  }
  return bw.pos;
}

int64_t tpz_deflate(const uint8_t* src, int64_t n, uint8_t* dst,
                    int64_t cap, int max_chain, int mode) {
  return deflate_impl(src, n, dst, cap, max_chain, mode, 1);
}

// Non-final deflate fragment ending byte-aligned (Z_SYNC_FLUSH): the L4
// ZlibWriter splices batches of these into one stock-zlib-accepted stream.
int64_t tpz_deflate_fragment(const uint8_t* src, int64_t n, uint8_t* dst,
                             int64_t cap, int max_chain, int mode) {
  return deflate_impl(src, n, dst, cap, max_chain, mode, 0);
}

void tpz_deflate_fragment_batch(const uint8_t* src, int64_t b, int64_t n,
                                const int32_t* lens, uint8_t* dst,
                                int64_t dcap, int64_t* out_lens,
                                int max_chain, int mode, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    out_lens[i] = tpz_deflate_fragment(src + i * n, lens[i], dst + i * dcap,
                                       dcap, max_chain, mode);
  });
}

// ---------------------------------------------------------------- MTF/DC
// Move-to-front (mtf.rs parity: rank in a recency list) and Binder-style
// distance coding (dc.rs parity; format pinned by tpuzip.oracle.dc) — host
// stages for the L4 streaming adapters, bit-exact vs the oracles.

int64_t tpz_mtf(const uint8_t* src, int64_t n, uint8_t* dst, int decode) {
  uint8_t sym[256];
  for (int s = 0; s < 256; ++s) sym[s] = (uint8_t)s;
  for (int64_t i = 0; i < n; ++i) {
    if (decode) {
      int rank = src[i];
      uint8_t s = sym[rank];
      dst[i] = s;
      if (rank) {
        memmove(sym + 1, sym, (size_t)rank);
        sym[0] = s;
      }
    } else {
      uint8_t s = src[i];
      int rank = 0;
      while (sym[rank] != s) ++rank;
      dst[i] = (uint8_t)rank;
      if (rank) {
        memmove(sym + 1, sym, (size_t)rank);
        sym[0] = s;
      }
    }
  }
  return n;
}

void tpz_mtf_batch(const uint8_t* src, int64_t b, int64_t cap,
                   const int32_t* lens, uint8_t* dst, int decode,
                   int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    tpz_mtf(src + i * cap, lens[i], dst + i * cap, decode);
  });
}

namespace {
void put_varint(uint8_t* dst, int64_t& o, uint32_t v) {
  while (v >= 0x80) {
    dst[o++] = (uint8_t)((v & 0x7F) | 0x80);
    v >>= 7;
  }
  dst[o++] = (uint8_t)v;
}
}  // namespace

int64_t tpz_dc_encode(const uint8_t* src, int64_t n, uint8_t* dst,
                      int64_t cap) {
  if (cap < 4 + 256 * 4) return -1;
  int64_t o = 0;
  uint32_t n32 = (uint32_t)n;
  memcpy(dst + o, &n32, 4);
  o += 4;
  // first-occurrence table (== n if absent) + per-symbol run-head lists
  uint32_t first[256];
  for (int s = 0; s < 256; ++s) first[s] = n32;
  // single pass: decompose runs, record heads, chain next-head per symbol
  std::vector<int64_t> heads;   // run head positions in run order
  std::vector<uint8_t> rsym;    // run symbol
  std::vector<int64_t> rend;    // run end (exclusive)
  for (int64_t i = 0; i < n;) {
    uint8_t s = src[i];
    int64_t j = i;
    while (j < n && src[j] == s) ++j;
    if (first[s] == n32) first[s] = (uint32_t)i;
    heads.push_back(i);
    rsym.push_back(s);
    rend.push_back(j);
    i = j;
  }
  memcpy(dst + o, first, 256 * 4);
  o += 256 * 4;
  // next run head of the same symbol: one backward pass
  std::vector<int64_t> nxt(heads.size(), -1);
  int64_t last_head[256];
  for (int s = 0; s < 256; ++s) last_head[s] = -1;
  for (int64_t r = (int64_t)heads.size() - 1; r >= 0; --r) {
    nxt[(size_t)r] = last_head[rsym[(size_t)r]];
    last_head[rsym[(size_t)r]] = heads[(size_t)r];
  }
  for (size_t r = 0; r < heads.size(); ++r) {
    if (o + 5 > cap) return -1;
    if (nxt[r] >= 0)
      put_varint(dst, o, (uint32_t)(nxt[r] - (rend[r] - 1)));
    else
      put_varint(dst, o, 0);
  }
  return o;
}

int64_t tpz_dc_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                      int64_t cap) {
  if (n < 4 + 256 * 4) return -1;
  uint32_t out_n;
  memcpy(&out_n, src, 4);
  if ((int64_t)out_n > cap) return -1;
  int64_t i = 4;
  // scheduled heads as a binary min-heap of (pos << 8 | sym): <= 256 live
  // entries (one per symbol), O(runs log 256) instead of the linear
  // 256-scan per run.  Distinct positions make the packed key a total
  // order; double-scheduling is caught by comparing against the popped
  // minimum (any duplicate position would pop adjacently).
  uint64_t heap[257];
  int hn = 0;
  auto push = [&](uint64_t v) {
    int k = hn++;
    heap[k] = v;
    while (k > 0) {
      int p = (k - 1) >> 1;
      if (heap[p] <= heap[k]) break;
      std::swap(heap[p], heap[k]);
      k = p;
    }
  };
  auto pop = [&]() {
    uint64_t top = heap[0];
    heap[0] = heap[--hn];
    int k = 0;
    for (;;) {
      int l = 2 * k + 1, r = l + 1, m = k;
      if (l < hn && heap[l] < heap[m]) m = l;
      if (r < hn && heap[r] < heap[m]) m = r;
      if (m == k) break;
      std::swap(heap[k], heap[m]);
      k = m;
    }
    return top;
  };
  for (int s = 0; s < 256; ++s) {
    uint32_t f;
    memcpy(&f, src + i, 4);
    i += 4;
    if (f < out_n) push(((uint64_t)f << 8) | (uint32_t)s);
  }
  int64_t pos = 0;
  while (pos < out_n) {
    if (hn == 0) return -2;
    uint64_t top = pop();
    int64_t hpos = (int64_t)(top >> 8);
    uint8_t s = (uint8_t)(top & 0xFF);
    if (hpos != pos) return -2;  // no run head scheduled here: corrupt
    if (hn && (int64_t)(heap[0] >> 8) == pos) return -2;  // double-sched
    int64_t nxt = hn ? (int64_t)(heap[0] >> 8) : (int64_t)out_n;
    memset(dst + pos, s, (size_t)(nxt - pos));
    int64_t run_end = nxt - 1;
    // read varint distance
    uint32_t d = 0;
    int shift = 0;
    while (true) {
      if (i >= n) return -2;
      uint8_t byte = src[i++];
      d |= (uint32_t)(byte & 0x7F) << shift;
      if (byte < 0x80) break;
      shift += 7;
      if (shift > 28) return -2;
    }
    if (d) {
      int64_t target = run_end + d;
      if (target >= out_n || target < nxt) return -2;
      push(((uint64_t)target << 8) | s);
    }
    pos = nxt;
  }
  return out_n;
}

void tpz_dc_encode_batch(const uint8_t* src, int64_t b, int64_t cap,
                         const int32_t* lens, uint8_t* dst, int64_t dcap,
                         int64_t* out_lens, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    out_lens[i] = tpz_dc_encode(src + i * cap, lens[i], dst + i * dcap,
                                dcap);
  });
}

void tpz_dc_decode_batch(const uint8_t* src, int64_t b, int64_t cap,
                         const int32_t* lens, uint8_t* dst, int64_t dcap,
                         int64_t* out_lens, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    out_lens[i] = tpz_dc_decode(src + i * cap, lens[i], dst + i * dcap,
                                dcap);
  });
}

// ---------------------------------------------------------------- RLE
int64_t tpz_rle_encode(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t cap) {
  int64_t i = 0, o = 0;
  while (i < n) {
    uint8_t b = src[i];
    int64_t run = 1;
    while (i + run < n && src[i + run] == b) ++run;
    if (run == 1) {
      if (o + 1 > cap) return -1;
      dst[o++] = b;
      ++i;
    } else {
      int64_t rem = run - 2;
      if (o + 2 + rem / 255 + 1 > cap) return -1;
      dst[o++] = b;
      dst[o++] = b;
      while (rem >= 255) {
        dst[o++] = 255;
        rem -= 255;
      }
      dst[o++] = (uint8_t)rem;
      i += run;
    }
  }
  return o;
}

int64_t tpz_rle_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t cap) {
  // a run trigger is an ADJACENT EQUAL PAIR in the stream (the second
  // byte of the pair re-arms only after its count bytes), so decode =
  // memcpy the literal stretch up to the next pair, then memset the run.
  // The pair search runs 7 positions per u64 step (zero-byte trick on
  // x ^ (x >> 8)).  Byte-identical to the sequential formulation.
  int64_t i = 0, o = 0;
  while (i < n) {
    int64_t k = i;
    for (;;) {
      if (k + 8 <= n) {
        uint64_t x;
        memcpy(&x, src + k, 8);
        uint64_t d = (x ^ (x >> 8)) | 0xFF00000000000000ull;
        uint64_t z = (d - 0x0101010101010101ull) & ~d &
                     0x8080808080808080ull;
        if (z) {
          k += (int64_t)(__builtin_ctzll(z) >> 3);
          break;
        }
        k += 7;
      } else {
        while (k + 1 < n && src[k] != src[k + 1]) ++k;
        if (k + 1 >= n) k = n;  // no pair: trailing literals only
        break;
      }
    }
    if (k == n) {  // copy the tail, done
      int64_t lit = n - i;
      if (o + lit > cap) return -1;
      memcpy(dst + o, src + i, (size_t)lit);
      return o + lit;
    }
    // literal stretch through BOTH pair bytes, then the count
    int64_t lit = k + 2 - i;
    if (o + lit > cap) return -1;
    memcpy(dst + o, src + i, (size_t)lit);
    o += lit;
    i = k + 2;
    int64_t extra = 0;
    uint8_t c;
    do {
      if (i >= n) return -1;
      c = src[i++];
      extra += c;
    } while (c == 255);
    if (o + extra > cap) return -1;
    memset(dst + o, src[k], (size_t)extra);
    o += extra;
  }
  return o;
}

// ------------------------------------------------- carryless range coder
// Same coder + order-0 table model as tpuzip.oracle.ari (bit-exact); the
// per-stream loops live in ari_model.h, shared with the CUDA coder.
static const uint32_t A_TOP = tpz::ARI_TOP, A_BOT = tpz::ARI_BOT;

int64_t tpz_ari_encode(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t cap, uint32_t increment, uint32_t threshold) {
  tpz::AriModel m;
  m.init(increment, threshold);
  return tpz::ari_encode_indexed(m, src, n, dst, cap, nullptr, 0);
}

int64_t tpz_ari_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t num_syms, uint32_t increment,
                       uint32_t threshold) {
  tpz::AriModel m;
  m.init(increment, threshold);
  tpz::ari_decode(m, src, n, dst, num_syms);
  return num_syms;
}

// ari encode with the fast-decode chunk index: deltas[c] = renorm bytes
// emitted while coding symbols [64c, 64c+64).  The GPU coder runs the same
// loop, so host- and GPU-encoded staged containers are interchangeable.
int64_t tpz_ari_encode_indexed(const uint8_t* src, int64_t n, uint8_t* dst,
                               int64_t cap, uint32_t increment,
                               uint32_t threshold, int32_t* deltas,
                               int64_t nc) {
  tpz::AriModel m;
  m.init(increment, threshold);
  return tpz::ari_encode_indexed(m, src, n, dst, cap, deltas, nc);
}

// ------------------------------------------------------------ bin/apm
// Byte-level binary adaptive coder (bin.rs/apm.rs parity): bits MSB-first
// through the shift-update model (optionally refined by the 33-cell APM
// gate), carryless renorm — bit-exact vs tpuzip.codecs.bin_apm.
namespace {
struct ApmGateC {
  int32_t cell[33];
  void init() {
    for (int i = 0; i < 33; ++i) {
      int32_t v = (int32_t)(((int64_t)i << 12) / 32);
      cell[i] = v < 1 ? 1 : (v > 4095 ? 4095 : v);
    }
  }
  int last = 0;
  int32_t pass(int32_t p0) {
    int32_t scaled = p0 * 32;
    int32_t idx = scaled >> 12;
    if (idx > 31) idx = 31;
    int32_t frac = scaled & 4095;
    last = frac < 2048 ? idx : idx + 1;
    int32_t p = (cell[idx] * (4096 - frac) + cell[idx + 1] * frac) >> 12;
    return p < 1 ? 1 : (p > 4095 ? 4095 : p);
  }
  void update(int bit, int rate) {
    int32_t p = cell[last];
    p = bit == 0 ? p + ((4096 - p) >> rate) : p - (p >> rate);
    cell[last] = p < 1 ? 1 : (p > 4095 ? 4095 : p);
  }
};

inline int32_t bin_upd(int32_t p0, int bit, int bits, int rate) {
  p0 = bit == 0 ? p0 + (((1 << bits) - p0) >> rate) : p0 - (p0 >> rate);
  int32_t hi = (1 << bits) - 1;
  return p0 < 1 ? 1 : (p0 > hi ? hi : p0);
}
}  // namespace

int64_t tpz_bin_encode(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t cap, int bits, int rate, int use_apm,
                       int apm_rate, int32_t* deltas) {
  // deltas (nullable): bytes emitted per 256-bit chunk - the fast-decode
  // chunk index the lane decoder needs (mirrors the ari coder's index so
  // host- and device-written bin containers stay interchangeable)
  uint32_t low = 0, range = 0xFFFFFFFFu;
  int32_t p0 = 1 << (bits - 1);
  ApmGateC gate;
  gate.init();
  int64_t o = 0, chunk_o = 0;
  for (int64_t i = 0; i < 8 * n; ++i) {
    if (deltas && i && (i & 255) == 0) {
      deltas[(i >> 8) - 1] = (int32_t)(o - chunk_o);
      chunk_o = o;
    }
    int bit = (src[i >> 3] >> (7 - (i & 7))) & 1;
    uint32_t denom_bits, split;
    if (use_apm) {
      split = (uint32_t)gate.pass(p0);
      denom_bits = 12;
    } else {
      split = (uint32_t)p0;
      denom_bits = (uint32_t)bits;
    }
    uint32_t r = range >> denom_bits;
    uint32_t cl = bit == 0 ? 0 : split;
    uint32_t w = bit == 0 ? split : (1u << denom_bits) - split;
    low += r * cl;
    range = r * w;
    for (;;) {
      if (((low ^ (low + range)) < A_TOP)) {
      } else if (range < A_BOT) {
        range = (uint32_t)(-(int64_t)low) & (A_BOT - 1);
      } else {
        break;
      }
      if (o >= cap) return -1;
      dst[o++] = (uint8_t)(low >> 24);
      low <<= 8;
      range <<= 8;
    }
    if (use_apm) gate.update(bit, apm_rate);
    p0 = bin_upd(p0, bit, bits, rate);
  }
  if (deltas && n > 0) deltas[(8 * n - 1) >> 8] = (int32_t)(o - chunk_o);
  for (int k = 0; k < 4; ++k) {
    if (o >= cap) return -1;
    dst[o++] = (uint8_t)(low >> 24);
    low <<= 8;
  }
  return o;
}

int64_t tpz_bin_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t num_bytes, int bits, int rate, int use_apm,
                       int apm_rate) {
  uint32_t low = 0, range = 0xFFFFFFFFu, code = 0;
  int32_t p0 = 1 << (bits - 1);
  ApmGateC gate;
  gate.init();
  int64_t i = 0;
  for (int k = 0; k < 4; ++k) code = (code << 8) | (i < n ? src[i++] : 0);
  for (int64_t t = 0; t < 8 * num_bytes; ++t) {
    uint32_t denom_bits, split;
    if (use_apm) {
      split = (uint32_t)gate.pass(p0);
      denom_bits = 12;
    } else {
      split = (uint32_t)p0;
      denom_bits = (uint32_t)bits;
    }
    uint32_t r = range >> denom_bits;
    uint32_t v = (code - low) / r;
    uint32_t dmax = (1u << denom_bits) - 1;
    if (v > dmax) v = dmax;
    int bit = v >= split ? 1 : 0;
    uint32_t cl = bit == 0 ? 0 : split;
    uint32_t w = bit == 0 ? split : (1u << denom_bits) - split;
    low += r * cl;
    range = r * w;
    for (;;) {
      if (((low ^ (low + range)) < A_TOP)) {
      } else if (range < A_BOT) {
        range = (uint32_t)(-(int64_t)low) & (A_BOT - 1);
      } else {
        break;
      }
      code = (code << 8) | (i < n ? src[i++] : 0);
      low <<= 8;
      range <<= 8;
    }
    if (use_apm) gate.update(bit, apm_rate);
    p0 = bin_upd(p0, bit, bits, rate);
    if (bit) dst[t >> 3] |= (uint8_t)(1 << (7 - (t & 7)));
  }
  return num_bytes;
}

// ------------------------------------------------- threaded batch stages
// Host codec stages over B independent blocks, fanned out across cores.
// Matrix layouts are row-major with fixed row capacities; per-block
// lengths/status are reported in the i64 out arrays (negative = error code
// of the scalar function).

void tpz_lz4_compress_batch(const uint8_t* src, int64_t b, int64_t n,
                            const int32_t* lens, uint8_t* dst, int64_t dcap,
                            int64_t* out_lens, int hash_log, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    out_lens[i] = tpz_lz4_compress(src + i * n, lens[i], dst + i * dcap,
                                   dcap, hash_log);
  });
}

void tpz_lz4_decode_wplan_batch(const uint8_t* src, int64_t b, int64_t scap,
                                const int32_t* slens, int32_t* wplans,
                                int64_t nw, uint8_t* patches,
                                int64_t patch_cap, int64_t out_cap,
                                int64_t* out_lens, int64_t* patch_used,
                                int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    int64_t pu = 0;
    out_lens[i] = tpz_lz4_decode_wplan(src + i * scap, slens[i],
                                       wplans + i * nw,
                                       patches + i * patch_cap, out_cap,
                                       patch_cap, &pu);
    patch_used[i] = pu;
  });
}

void tpz_rle_encode_batch(const uint8_t* src, int64_t b, int64_t n,
                          const int32_t* lens, uint8_t* dst, int64_t dcap,
                          int64_t* out_lens, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    out_lens[i] =
        tpz_rle_encode(src + i * n, lens[i], dst + i * dcap, dcap);
  });
}

void tpz_rle_decode_batch(const uint8_t* src, int64_t b, int64_t scap,
                          const int32_t* slens, uint8_t* dst, int64_t dcap,
                          int64_t* out_lens, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    out_lens[i] = slens[i] == 0 ? 0 :
        tpz_rle_decode(src + i * scap, slens[i], dst + i * dcap, dcap);
  });
}

void tpz_deflate_batch(const uint8_t* src, int64_t b, int64_t n,
                       const int32_t* lens, uint8_t* dst, int64_t dcap,
                       int64_t* out_lens, int max_chain, int mode,
                       int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    out_lens[i] = tpz_deflate(src + i * n, lens[i], dst + i * dcap, dcap,
                              max_chain, mode);
  });
}

void tpz_inflate_batch(const uint8_t* src, int64_t b, int64_t scap,
                       const int32_t* slens, uint8_t* dst, int64_t dcap,
                       int64_t* out_lens, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    out_lens[i] = slens[i] == 0 ? 0 :  // empty row = empty block
        tpz_inflate(src + i * scap, slens[i], dst + i * dcap, dcap);
  });
}

void tpz_inflate_plan_batch(const uint8_t* src, int64_t b, int64_t scap,
                            const int32_t* slens, int32_t* plans,
                            uint8_t* lits, int64_t out_cap,
                            int64_t* out_lens, int64_t* nlits,
                            int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    int64_t nl = 0;
    out_lens[i] = slens[i] == 0 ? 0 :  // empty row = empty block
        tpz_inflate_plan(src + i * scap, slens[i], plans + i * out_cap,
                         lits + i * out_cap, out_cap, &nl);
    nlits[i] = nl;
  });
}

// Build the chunk-indexed lane decoder's per-chunk stream windows at host
// memcpy speed (the bin/apm to_device decode; the XLA formulation is
// codecs/ari_index.build_windows).  For block row i, chunk k, word
// j: out word = big-endian u32 of stream bytes start_k+4j .. +3, with
// start_0 = 4 (after code0) and start_{k+1} = start_k + deltas[i,k].
// Output lane-major (B, NC*w) u32; the device transposes it and feeds the
// decoder.
void tpz_ari_build_windows(const uint8_t* streams, int64_t b, int64_t cap,
                           const int32_t* deltas, int64_t nc, int w,
                           uint32_t* out, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    const uint8_t* s = streams + i * cap;
    uint32_t* o = out + i * nc * (int64_t)w;
    int64_t start = 4;
    for (int64_t k = 0; k < nc; ++k) {
      for (int j = 0; j < w; ++j) {
        int64_t p = start + 4 * j;
        uint32_t v = 0;
        if (p + 3 < cap) {
          v = ((uint32_t)s[p] << 24) | ((uint32_t)s[p + 1] << 16) |
              ((uint32_t)s[p + 2] << 8) | s[p + 3];
        } else {
          for (int t = 0; t < 4 && p + t < cap; ++t)
            v |= (uint32_t)s[p + t] << (24 - 8 * t);
        }
        o[k * w + j] = v;
      }
      start += deltas[i * nc + k];
    }
  });
}

// ------------------------------------------------- BWT forward (SA-IS)
namespace {

// SA-IS (Nong/Zhang/Chan induced sorting), int32 indices.  s[0..n-1] over
// alphabet [0, K) with a unique minimal sentinel s[n-1] = 0.
void sais_core(const int32_t* s, int32_t* SA, int64_t n, int32_t K) {
  if (n == 1) {
    SA[0] = 0;
    return;
  }
  std::vector<uint8_t> t((size_t)n);
  t[(size_t)n - 1] = 1;
  for (int64_t i = n - 2; i >= 0; --i)
    t[(size_t)i] =
        s[i] < s[i + 1] || (s[i] == s[i + 1] && t[(size_t)i + 1]);
  auto is_lms = [&](int64_t i) {
    return i > 0 && t[(size_t)i] && !t[(size_t)i - 1];
  };
  std::vector<int32_t> bkt((size_t)K), cnt((size_t)K, 0);
  for (int64_t i = 0; i < n; ++i) cnt[s[i]]++;  // count once per level
  auto buckets = [&](bool end) {
    int32_t sum = 0;
    for (int32_t k = 0; k < K; ++k) {
      sum += cnt[k];
      bkt[k] = end ? sum : sum - cnt[k];
    }
  };
  auto induce = [&]() {
    buckets(false);
    for (int64_t i = 0; i < n; ++i) {
      int32_t j = SA[i] - 1;
      if (SA[i] > 0 && !t[(size_t)j]) SA[bkt[s[j]]++] = j;
    }
    buckets(true);
    for (int64_t i = n - 1; i >= 0; --i) {
      int32_t j = SA[i] - 1;
      if (SA[i] > 0 && t[(size_t)j]) SA[--bkt[s[j]]] = j;
    }
  };
  // stage 1: place LMS suffixes at bucket ends, induce-sort LMS substrings
  buckets(true);
  for (int64_t i = 0; i < n; ++i) SA[i] = -1;
  for (int64_t i = 1; i < n; ++i)
    if (is_lms(i)) SA[--bkt[s[i]]] = (int32_t)i;
  induce();
  // compact sorted LMS positions to the front
  int64_t n1 = 0;
  for (int64_t i = 0; i < n; ++i)
    if (SA[i] > 0 && is_lms(SA[i])) SA[n1++] = SA[i];
  // name LMS substrings in SA[n1..n)
  for (int64_t i = n1; i < n; ++i) SA[i] = -1;
  int32_t name = 0;
  int64_t prev = -1;
  for (int64_t i = 0; i < n1; ++i) {
    int64_t pos = SA[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (int64_t d = 0;; ++d) {
        if (pos + d >= n || prev + d >= n ||
            s[pos + d] != s[prev + d] ||
            t[(size_t)(pos + d)] != t[(size_t)(prev + d)]) {
          diff = true;
          break;
        }
        if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) break;
      }
    }
    if (diff) {
      ++name;
      prev = pos;
    }
    SA[n1 + pos / 2] = name - 1;
  }
  std::vector<int32_t> s1((size_t)n1);
  for (int64_t i = n - 1, j = n1 - 1; i >= n1; --i)
    if (SA[i] >= 0) s1[(size_t)j--] = SA[i];
  // stage 2: order the reduced string
  std::vector<int32_t> SA1((size_t)n1);
  if (name < n1) {
    sais_core(s1.data(), SA1.data(), n1, name);
  } else {
    for (int64_t i = 0; i < n1; ++i) SA1[(size_t)s1[i]] = (int32_t)i;
  }
  // stage 3: place LMS suffixes in final order, induce the rest
  std::vector<int32_t> lms;
  lms.reserve((size_t)n1);
  for (int64_t i = 1; i < n; ++i)
    if (is_lms(i)) lms.push_back((int32_t)i);
  for (int64_t i = 0; i < n; ++i) SA[i] = -1;
  buckets(true);
  for (int64_t i = n1 - 1; i >= 0; --i) {
    int32_t j = lms[(size_t)SA1[i]];
    SA[--bkt[s[j]]] = j;
  }
  induce();
}

void rotation_order_sais(const uint8_t* data, int64_t n, int32_t* rot);
void rotation_order(const uint8_t* data, int64_t n, int32_t* rot);

// Ternary radix quicksort (Bentley–Sedgewick) of rotation indices over the
// doubled buffer — the bzip2-style fast path.  Rotations equal through n
// chars are equal rotations: the group is ordered by ascending index (the
// oracle's stable-argsort tie rule).  `budget` counts partition work; when
// a pathological block (long average LCP: runs, near-periodic data)
// exhausts it, the caller falls back to SA-IS.
bool mkq_rotations(const uint8_t* s2, int32_t* a, int64_t m, int64_t depth,
                   int64_t n, int64_t* budget) {
  while (m > 1) {
    if (depth >= n) {  // equal rotations: index-ascending tie order
      std::sort(a, a + m);
      return true;
    }
    if ((*budget -= m) < 0) return false;
    if (m <= 12) {  // insertion sort on (rotation suffix, index)
      for (int64_t i = 1; i < m; ++i) {
        int32_t v = a[i];
        int64_t j = i;
        while (j > 0) {
          int c = memcmp(s2 + a[j - 1] + depth, s2 + v + depth,
                         (size_t)(n - depth));
          if (c < 0 || (c == 0 && a[j - 1] < v)) break;
          a[j] = a[j - 1];
          --j;
        }
        a[j] = v;
      }
      return true;
    }
    // median-of-3 pivot byte at this depth
    uint8_t x = s2[a[0] + depth], y = s2[a[m / 2] + depth],
            z = s2[a[m - 1] + depth];
    uint8_t piv = x < y ? (y < z ? y : (x < z ? z : x))
                        : (x < z ? x : (y < z ? z : y));
    int64_t lt = 0, gt = m, i = 0;
    while (i < gt) {
      uint8_t c = s2[a[i] + depth];
      if (c < piv) {
        std::swap(a[lt++], a[i++]);
      } else if (c > piv) {
        std::swap(a[i], a[--gt]);
      } else {
        ++i;
      }
    }
    if (!mkq_rotations(s2, a, lt, depth, n, budget)) return false;
    if (!mkq_rotations(s2, a + gt, m - gt, depth, n, budget)) return false;
    a += lt;
    m = gt - lt;
    ++depth;  // tail-recurse into the == group
  }
  return true;
}

// Cyclic-rotation order with the oracle's tie rule (equal rotations by
// ascending start index; tpuzip.oracle.bwt.rotation_sort).  Fast path:
// ternary radix quicksort over the doubled buffer (text LCPs are short);
// pathological blocks (work budget exceeded) fall back to SA-IS over
// data+data+sentinel with the KMP periodic reduction.
void rotation_order(const uint8_t* data, int64_t n, int32_t* rot) {
  if (n > 1) {
    // distinctness gate: mkq wins only on low-LCP data (ternary
    // partitioning costs ~8n PER byte-depth).  Sample 4-byte windows into
    // a tiny hash table; a high repeat fraction means deep LCPs -> go
    // straight to SA-IS instead of burning the mkq budget first.
    bool try_mkq = true;
    if (n >= 4096) {
      uint32_t seen[1024];
      memset(seen, 0, sizeof(seen));
      int64_t samples = 512, dup = 0;
      int64_t stride = (n - 4) / samples;
      if (stride < 1) stride = 1;
      for (int64_t k = 0; k < samples; ++k) {
        uint32_t w;
        memcpy(&w, data + k * stride, 4);
        uint32_t h = (w * 2654435761u) >> 22;  // 10-bit slot
        if (seen[h] == w + 1) {
          ++dup;
        } else {
          seen[h] = w + 1;
        }
      }
      try_mkq = dup < samples / 4;  // >25% repeated windows: high-LCP
    }
    if (try_mkq) {
      std::vector<uint8_t> s2((size_t)(2 * n));
      memcpy(s2.data(), data, (size_t)n);
      memcpy(s2.data() + n, data, (size_t)n);
      for (int64_t i = 0; i < n; ++i) rot[i] = (int32_t)i;
      // ~8 byte-depths of ternary partitioning (a full random-data sort
      // needs ~10-16n; high-LCP data exhausts this and falls back)
      int64_t budget = 64 * n;
      if (mkq_rotations(s2.data(), rot, n, 0, n, &budget)) return;
    }
  }
  rotation_order_sais(data, n, rot);
}

void rotation_order_sais(const uint8_t* data, int64_t n, int32_t* rot) {
  if (n <= 0) return;
  if (n == 1) {
    rot[0] = 0;
    return;
  }
  std::vector<int32_t> pi((size_t)n + 1);
  pi[0] = -1;
  for (int64_t i = 0; i < n; ++i) {
    int32_t k = pi[(size_t)i];
    while (k >= 0 && data[k] != data[i]) k = pi[(size_t)k];
    pi[(size_t)i + 1] = k + 1;
  }
  int64_t p = n - pi[(size_t)n];
  if (p < n && n % p == 0) {
    std::vector<int32_t> sub((size_t)p);
    rotation_order(data, p, sub.data());
    int64_t o = 0;
    for (int64_t j = 0; j < p; ++j)
      for (int64_t i = sub[(size_t)j]; i < n; i += p) rot[o++] = (int32_t)i;
    return;
  }
  int64_t m = 2 * n + 1;
  std::vector<int32_t> s((size_t)m);
  for (int64_t i = 0; i < 2 * n; ++i) s[(size_t)i] = data[i % n] + 1;
  s[(size_t)m - 1] = 0;
  std::vector<int32_t> SA((size_t)m);
  sais_core(s.data(), SA.data(), m, 257);
  int64_t o = 0;
  for (int64_t i = 0; i < m; ++i)
    if (SA[i] < n) rot[o++] = SA[i];
}

}  // namespace

// Threaded ari encode with the fast-decode chunk index, one block per task.
void tpz_ari_encode_indexed_batch(const uint8_t* src, int64_t b,
                                  int64_t cap, const int32_t* lens,
                                  uint8_t* dst, int64_t dcap,
                                  int64_t* out_lens, int32_t* deltas,
                                  int64_t nc, uint32_t increment,
                                  uint32_t threshold, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    out_lens[i] = tpz_ari_encode_indexed(src + i * cap, lens[i],
                                         dst + i * dcap, dcap, increment,
                                         threshold, deltas + i * nc, nc);
  });
}

void tpz_ari_decode_batch(const uint8_t* src, int64_t b, int64_t cap,
                          const int32_t* lens, uint8_t* dst, int64_t dcap,
                          const int32_t* num_syms, uint32_t increment,
                          uint32_t threshold, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    tpz_ari_decode(src + i * cap, lens[i], dst + i * dcap, num_syms[i],
                   increment, threshold);
  });
}

void tpz_bin_encode_batch(const uint8_t* src, int64_t b, int64_t cap,
                          const int32_t* lens, uint8_t* dst, int64_t dcap,
                          int64_t* out_lens, int bits, int rate,
                          int use_apm, int apm_rate, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    out_lens[i] = tpz_bin_encode(src + i * cap, lens[i], dst + i * dcap,
                                 dcap, bits, rate, use_apm, apm_rate,
                                 nullptr);
  });
}

void tpz_bin_encode_indexed_batch(const uint8_t* src, int64_t b,
                                  int64_t cap, const int32_t* lens,
                                  uint8_t* dst, int64_t dcap,
                                  int64_t* out_lens, int32_t* deltas,
                                  int64_t nc, int bits, int rate,
                                  int use_apm, int apm_rate,
                                  int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    out_lens[i] = tpz_bin_encode(src + i * cap, lens[i], dst + i * dcap,
                                 dcap, bits, rate, use_apm, apm_rate,
                                 deltas + i * nc);
  });
}

void tpz_bin_decode_batch(const uint8_t* src, int64_t b, int64_t cap,
                          const int32_t* lens, uint8_t* dst, int64_t dcap,
                          const int32_t* num_bytes, int bits, int rate,
                          int use_apm, int apm_rate, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    tpz_bin_decode(src + i * cap, lens[i], dst + i * dcap, num_bytes[i],
                   bits, rate, use_apm, apm_rate);
  });
}

// Forward BWT (threaded over blocks): rotation sort via SA-IS on the
// doubled string, one block per task.  Emits the last column and per-block
// origin, bit-exact vs tpuzip.oracle.bwt.encode_block (incl. periodic
// ties).
void tpz_bwt_forward_batch(const uint8_t* blocks, int64_t b, int64_t cap,
                           const int32_t* lens, uint8_t* L,
                           int32_t* origins, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    const uint8_t* d = blocks + i * cap;
    uint8_t* out = L + i * cap;
    int64_t n = lens[i];
    origins[i] = 0;
    if (n <= 0) return;
    std::vector<int32_t> rot((size_t)n);
    rotation_order(d, n, rot.data());
    for (int64_t k = 0; k < n; ++k) {
      int32_t r = rot[(size_t)k];
      out[k] = d[(r + n - 1) % n];
      if (r == 0) origins[i] = (int32_t)k;
    }
  });
}

// Inverse BWT at host speed (threaded over blocks).  The LF walk is one
// data-dependent load per output byte — latency-bound pointer chasing
// that the host serves where the output lands anyway.  Counting sort
// builds the
// same stable-argsort inversion table as tpuzip.oracle.bwt.decode_block.
void tpz_bwt_inverse_batch(const uint8_t* L, int64_t b, int64_t cap,
                           const int32_t* lens, const int32_t* origins,
                           uint8_t* out, int nthreads) {
  parallel_blocks(b, nthreads, [&](int64_t i) {
    const uint8_t* l = L + i * cap;
    uint8_t* o = out + i * cap;
    int64_t n = lens[i];
    if (n <= 0) return;
    std::vector<int32_t> order((size_t)n);
    int64_t cnt[256] = {0};
    for (int64_t k = 0; k < n; ++k) cnt[l[k]]++;
    int64_t offs[256];
    int64_t acc = 0;
    for (int s = 0; s < 256; ++s) {
      offs[s] = acc;
      acc += cnt[s];
    }
    for (int64_t k = 0; k < n; ++k)
      order[(size_t)offs[l[k]]++] = (int32_t)k;
    int32_t p = order[(size_t)origins[i]];
    for (int64_t k = 0; k < n; ++k) {
      o[k] = l[p];
      p = order[(size_t)p];
    }
  });
}

// ------------------------------------------------- container assembly
// Gather B ragged payload rows of a (B, cap) matrix into one stream.
int64_t tpz_pack_payloads(const uint8_t* comp, int64_t b, int64_t cap,
                          const int32_t* lens, uint8_t* dst,
                          int64_t dst_cap) {
  int64_t o = 0;
  for (int64_t i = 0; i < b; ++i) {
    int64_t l = lens[i];
    if (o + l > dst_cap) return -1;
    memcpy(dst + o, comp + i * cap, (size_t)l);
    o += l;
  }
  return o;
}

// Scatter a packed stream back into fixed rows.
int64_t tpz_unpack_payloads(const uint8_t* stream, int64_t stream_len,
                            const int32_t* lens, int64_t b, uint8_t* comp,
                            int64_t cap) {
  int64_t o = 0;
  for (int64_t i = 0; i < b; ++i) {
    int64_t l = lens[i];
    if (l > cap || o + l > stream_len) return -1;
    memcpy(comp + i * cap, stream + o, (size_t)l);
    o += l;
  }
  return o;
}

}  // extern "C"
