// Marker classify + Rec.709 luma over three u8 channel planes.
//
// Replaces smh_tpu/ops/pallas_kernels.py::_classify_luma_kernel (entry
// classify_luma_pallas_planes). Per pixel: the marker predicate and the luma
// of classify.cuh (HSV in f32 with the oracle's order of operations and
// truncating casts; __f*_rn intrinsics keep both bit-exact with pixmath).
//
// What bounds it on an H100: bytes. It reads 3 and writes 2 bytes per pixel
// (~4 MB for the 1080p map ROI, ~16 MB at 4K) and does ~40 flops per pixel,
// far below the card's flop/byte balance. The design keeps to one pass: one
// thread per pixel, neighbouring threads on neighbouring bytes so every warp
// load and store coalesces, no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "classify.cuh"

namespace {

__global__ void classify_luma_kernel(const uint8_t* __restrict__ r8,
                                     const uint8_t* __restrict__ g8,
                                     const uint8_t* __restrict__ b8,
                                     uint8_t* __restrict__ marker,
                                     uint8_t* __restrict__ luma, int64_t n,
                                     smh::ClassifyParams p) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint8_t r = r8[i];
    const uint8_t g = g8[i];
    const uint8_t b = b8[i];
    marker[i] = smh::is_marker(r, g, b, p) ? 1 : 0;
    luma[i] = smh::luma8(r, g, b);
  }
}

}  // namespace

// params: the 14 ints of smh::classify_params (host memory).
extern "C" int smh_classify_luma(const void* r8, const void* g8, const void* b8,
                                 void* marker, void* luma, int64_t n,
                                 const void* params, void* stream) {
  const smh::ClassifyParams p = smh::classify_params(params);
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond ~64 blocks/SM
  classify_luma_kernel<<<(unsigned)blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(r8), static_cast<const uint8_t*>(g8),
      static_cast<const uint8_t*>(b8), static_cast<uint8_t*>(marker),
      static_cast<uint8_t*>(luma), n, p);
  return (int)cudaGetLastError();
}
