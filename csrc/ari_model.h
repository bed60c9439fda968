// Adaptive order-0 range coder (the ari codec), shared by the host runtime
// (tpuzip_host.cpp) and the CUDA coder (ari_cuda.cu), so the host tests of
// the C++ coder test the same per-stream loop the GPU runs.
//
// Format: tpuzip.oracle.ari, bit-exact — carryless Subbotin 32-bit range
// coder with an adaptive frequency table (increment per coded symbol,
// halving once the total reaches the threshold).  The encoder also records
// the fast-decode chunk index: deltas[c] = renorm bytes emitted while coding
// symbols [64c, 64c + 64).

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define TPZ_HD __host__ __device__ __forceinline__
#else
#define TPZ_HD inline
#endif

namespace tpz {

constexpr uint32_t ARI_TOP = 1u << 24;
constexpr uint32_t ARI_BOT = 1u << 16;
constexpr int64_t ARI_CHUNK = 64;  // symbols per chunk-index entry (2^6)

// Frequency table with a two-level cumulative structure: gsum[g] is the sum
// of freq[16g .. 16g+15], so cum_lo and the symbol search touch at most 32
// cells instead of scanning 256.  About 1.1 KB of state.
struct AriModel {
  uint32_t freq[256];
  uint32_t gsum[16];
  uint32_t total;
  uint32_t inc, thresh;

  TPZ_HD void init(uint32_t increment, uint32_t threshold) {
    for (int s = 0; s < 256; ++s) freq[s] = 1;
    for (int g = 0; g < 16; ++g) gsum[g] = 16;
    total = 256;
    inc = increment;
    thresh = threshold;
  }
  TPZ_HD uint32_t freq_of(int sym) const { return freq[sym]; }
  TPZ_HD uint32_t cum_lo(int sym) const {
    uint32_t acc = 0;
    for (int g = 0; g < (sym >> 4); ++g) acc += gsum[g];
    for (int s = sym & ~15; s < sym; ++s) acc += freq[s];
    return acc;
  }
  // largest sym with cum_lo(sym) <= v (v < total); cum_lo(sym) via *lo
  TPZ_HD int find(uint32_t v, uint32_t* lo) const {
    uint32_t acc = 0;
    int g = 0;
    while (g < 15 && acc + gsum[g] <= v) acc += gsum[g++];
    int s = g << 4;
    while (s < 255 && acc + freq[s] <= v) acc += freq[s++];
    *lo = acc;
    return s;
  }
  TPZ_HD void update(int sym) {
    freq[sym] += inc;
    gsum[sym >> 4] += inc;
    total += inc;
    if (total >= thresh) {
      total = 0;
      for (int g = 0; g < 16; ++g) {
        uint32_t gs = 0;
        for (int s = g << 4; s < ((g + 1) << 4); ++s) {
          freq[s] = (freq[s] + 1) >> 1;
          gs += freq[s];
        }
        gsum[g] = gs;
        total += gs;
      }
    }
  }
};

// Encode src[0..n) into dst (capacity cap) with a freshly initialised model.
// Returns the stream length (renorm bytes + the 4 finish bytes), or -1 when
// the stream does not fit.  deltas[0..nc) receives the chunk index (chunks
// past the input are 0); nc may be 0.
TPZ_HD int64_t ari_encode_indexed(AriModel& m, const uint8_t* src, int64_t n,
                                  uint8_t* dst, int64_t cap, int32_t* deltas,
                                  int64_t nc) {
  uint32_t low = 0, range = 0xFFFFFFFFu;
  int64_t o = 0;
  int32_t emitted = 0;  // renorm bytes of the current chunk
  for (int64_t i = 0; i < n; ++i) {
    int sym = src[i];
    uint32_t cumlo = m.cum_lo(sym);
    uint32_t r = range / m.total;
    low += r * cumlo;
    range = r * m.freq_of(sym);
    for (;;) {
      if ((low ^ (low + range)) < ARI_TOP) {
      } else if (range < ARI_BOT) {
        range = (0u - low) & (ARI_BOT - 1);
      } else {
        break;
      }
      if (o >= cap) return -1;
      dst[o++] = (uint8_t)(low >> 24);
      ++emitted;
      low <<= 8;
      range <<= 8;
    }
    m.update(sym);
    if ((i & (ARI_CHUNK - 1)) == ARI_CHUNK - 1 || i + 1 == n) {
      int64_t c = i >> 6;
      if (c < nc) deltas[c] = emitted;
      emitted = 0;
    }
  }
  for (int64_t c = (n + ARI_CHUNK - 1) / ARI_CHUNK; c < nc; ++c) deltas[c] = 0;
  for (int k = 0; k < 4; ++k) {
    if (o >= cap) return -1;
    dst[o++] = (uint8_t)(low >> 24);
    low <<= 8;
  }
  return o;
}

// Decode num_syms symbols of the stream src[0..n) into dst with a freshly
// initialised model.  Bytes past the stream read as 0.  A stream no encoder
// produced can drive the range below the total; decoding then stops and the
// rest of dst is left as it was.
TPZ_HD void ari_decode(AriModel& m, const uint8_t* src, int64_t n,
                       uint8_t* dst, int64_t num_syms) {
  uint32_t low = 0, range = 0xFFFFFFFFu, code = 0;
  int64_t i = 0;
  for (int k = 0; k < 4; ++k) code = (code << 8) | (i < n ? src[i++] : 0);
  for (int64_t t = 0; t < num_syms; ++t) {
    uint32_t r = range / m.total;
    if (r == 0) return;
    uint32_t v = (code - low) / r;
    if (v >= m.total) v = m.total - 1;
    uint32_t acc;
    int sym = m.find(v, &acc);
    dst[t] = (uint8_t)sym;
    low += r * acc;
    range = r * m.freq_of(sym);
    for (;;) {
      if ((low ^ (low + range)) < ARI_TOP) {
      } else if (range < ARI_BOT) {
        range = (0u - low) & (ARI_BOT - 1);
      } else {
        break;
      }
      code = (code << 8) | (i < n ? src[i++] : 0);
      low <<= 8;
      range <<= 8;
    }
    m.update(sym);
  }
}

}  // namespace tpz
