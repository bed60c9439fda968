// CUDA ari coder, called from JAX through the XLA FFI
// (tpuzip/kernels/ari_cuda.py).  Each stream is a serial recurrence, so a
// stream belongs to one thread, its AriModel (~1.1 KB) in shared memory;
// the streams of a batch run in parallel, kGroup threads per CUDA block.
// The per-stream loops are ari_model.h's, shared with the host coder, so
// the output is byte-identical to tpz_ari_encode_indexed / tpz_ari_decode.
//
// Build: make -C csrc cuda

#include <cuda_runtime.h>

#include <cstdint>

#include "ari_model.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

// Streams (threads) per CUDA block: at 4096 x 64 KiB on an H100, 2 was the
// fastest of 1..32 both ways, and one thread per stream beat one warp per
// stream (PERF.md, bring-up findings).
constexpr int kGroup = 2;
constexpr size_t kSmem = sizeof(tpz::AriModel) * kGroup;

unsigned grid_for(int64_t nblocks) {
  return (unsigned)((nblocks + kGroup - 1) / kGroup);
}

__device__ __forceinline__ int64_t clamp_len(int32_t v, int64_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : (int64_t)v);
}

__global__ void encode_kernel(const uint8_t* blocks, int64_t nblocks,
                              int64_t n, const int32_t* lens, uint8_t* comp,
                              int64_t cap, int32_t* clens, int32_t* deltas,
                              int64_t nc, uint32_t inc, uint32_t thr) {
  extern __shared__ tpz::AriModel models[];
  int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  tpz::AriModel& m = models[threadIdx.x];
  m.init(inc, thr);
  clens[b] = (int32_t)tpz::ari_encode_indexed(
      m, blocks + b * n, clamp_len(lens[b], n), comp + b * cap, cap,
      deltas + b * nc, nc);
}

__global__ void decode_kernel(const uint8_t* streams, int64_t nblocks,
                              int64_t w, const int32_t* slens,
                              const int32_t* nsyms, uint8_t* out, int64_t n,
                              uint32_t inc, uint32_t thr) {
  extern __shared__ tpz::AriModel models[];
  int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  tpz::AriModel& m = models[threadIdx.x];
  m.init(inc, thr);
  tpz::ari_decode(m, streams + b * w, clamp_len(slens[b], w), out + b * n,
                  clamp_len(nsyms[b], n));
}

ffi::Error last_error() {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  return ffi::Error::Success();
}

ffi::Error AriEncodeImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> blocks,
                         ffi::Buffer<ffi::S32> lens, uint32_t increment,
                         uint32_t threshold,
                         ffi::ResultBuffer<ffi::U8> comp,
                         ffi::ResultBuffer<ffi::S32> clens,
                         ffi::ResultBuffer<ffi::S32> deltas) {
  auto bd = blocks.dimensions();
  if (bd.size() != 2) return ffi::Error::InvalidArgument("blocks must be 2-D");
  int64_t nblocks = bd[0], n = bd[1];
  int64_t cap = comp->dimensions()[1], nc = deltas->dimensions()[1];
  if (nblocks == 0) return ffi::Error::Success();
  // zero padding past each stream, as the XLA coder leaves it
  cudaMemsetAsync(comp->typed_data(), 0, comp->size_bytes(), stream);
  encode_kernel<<<grid_for(nblocks), kGroup, kSmem, stream>>>(
      blocks.typed_data(), nblocks, n, lens.typed_data(), comp->typed_data(),
      cap, clens->typed_data(), deltas->typed_data(), nc, increment,
      threshold);
  return last_error();
}

ffi::Error AriDecodeImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> streams,
                         ffi::Buffer<ffi::S32> slens,
                         ffi::Buffer<ffi::S32> nsyms, uint32_t increment,
                         uint32_t threshold,
                         ffi::ResultBuffer<ffi::U8> out) {
  auto sd = streams.dimensions();
  if (sd.size() != 2) return ffi::Error::InvalidArgument("streams must be 2-D");
  int64_t nblocks = sd[0], w = sd[1];
  int64_t n = out->dimensions()[1];
  if (nblocks == 0) return ffi::Error::Success();
  // symbols past each block's count read as 0, as the XLA decoder leaves them
  cudaMemsetAsync(out->typed_data(), 0, out->size_bytes(), stream);
  decode_kernel<<<grid_for(nblocks), kGroup, kSmem, stream>>>(
      streams.typed_data(), nblocks, w, slens.typed_data(),
      nsyms.typed_data(), out->typed_data(), n, increment, threshold);
  return last_error();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    TpzAriEncode, AriEncodeImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U8>>()   // blocks (B, N)
        .Arg<ffi::Buffer<ffi::S32>>()  // lengths (B,)
        .Attr<uint32_t>("increment")
        .Attr<uint32_t>("threshold")
        .Ret<ffi::Buffer<ffi::U8>>()    // streams (B, cap)
        .Ret<ffi::Buffer<ffi::S32>>()   // stream lengths (B,)
        .Ret<ffi::Buffer<ffi::S32>>());  // chunk index (B, NC)

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    TpzAriDecode, AriDecodeImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U8>>()   // streams (B, W)
        .Arg<ffi::Buffer<ffi::S32>>()  // stream lengths (B,)
        .Arg<ffi::Buffer<ffi::S32>>()  // symbol counts (B,)
        .Attr<uint32_t>("increment")
        .Attr<uint32_t>("threshold")
        .Ret<ffi::Buffer<ffi::U8>>());  // symbols (B, N)
