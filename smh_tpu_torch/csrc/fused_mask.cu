// Fused marker mask: classify -> L1 radius-1 dilate -> MSB-first bit-pack.
//
// Replaces smh_tpu/ops/pallas_kernels.py::_fused_mask_kernel and
// _fused_mask_kernel_hbm (entry fused_mask_bits_pallas). The output is the
// fused pass's lsd_bits plane: bits[y, j] holds pixels 8j..8j+7 of row y,
// MSB first, each the OR of the marker predicate over the pixel and its four
// L1 neighbours, with everything outside the plane unmarked. Pad bits (the
// columns >= W of a row's last byte) are ZERO, as in
// pack_bits(_dilate_l1_radius1_bool(marker)). The Pallas kernel differs
// there: its dilate's left tap reads the zero-padded column W as a neighbour
// of column W - 1, so it sets a pad bit wherever a marker touches the last
// column of a ragged row. This kernel never reads past column W - 1 for a
// pad bit; it skips them.
//
// What bounds it on an H100: bytes, then the classify arithmetic. It reads 3
// bytes and writes 1/8 byte per pixel (~2.4 MB at the 1080p map, ~9.7 MB at
// 4K). The marker mask never reaches device memory: it lives in shared
// memory for one tile. The design is the simple one: each 32x8-thread block
// classifies a (TH + 2) x (TW + 2) tile (TW = 256 pixels = one output byte
// per thread across a warp, TH = 8 rows) with a 1-px halo into shared
// memory, then each thread ORs the cross for its 8 pixels and stores one
// byte. The halo costs ~26% extra classify work; the TPU's band/DMA/MXU
// selector structure is not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "classify.cuh"

namespace {

constexpr int TB = 32;       // output bytes per tile row = threads in x (one warp)
constexpr int TH = 8;        // tile height = warps per block
constexpr int TW = TB * 8;   // tile width in pixels

__global__ void fused_mask_kernel(const uint8_t* __restrict__ r8,
                                  const uint8_t* __restrict__ g8,
                                  const uint8_t* __restrict__ b8,
                                  uint8_t* __restrict__ bits, int H, int W,
                                  int bpr, smh::ClassifyParams p) {
  __shared__ uint8_t m[TH + 2][TW + 2];

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TB + threadIdx.x;
  for (int k = tid; k < (TH + 2) * (TW + 2); k += TB * TH) {
    const int ty = k / (TW + 2);
    const int tx = k % (TW + 2);
    const int gy = y0 + ty - 1;
    const int gx = x0 + tx - 1;
    bool v = false;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int64_t off = (int64_t)gy * W + gx;
      v = smh::is_marker(r8[off], g8[off], b8[off], p);
    }
    m[ty][tx] = v ? 1 : 0;
  }
  __syncthreads();

  const int y = y0 + threadIdx.y;
  const int bx = blockIdx.x * TB + threadIdx.x;
  if (y >= H || bx >= bpr) return;
  const int ty = threadIdx.y + 1;
  unsigned byte = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (bx * 8 + k >= W) break;  // pad bits stay zero
    const int tx = threadIdx.x * 8 + k + 1;
    const unsigned d = m[ty][tx] | m[ty - 1][tx] | m[ty + 1][tx] |
                       m[ty][tx - 1] | m[ty][tx + 1];
    byte |= d << (7 - k);
  }
  bits[(int64_t)y * bpr + bx] = (uint8_t)byte;
}

}  // namespace

// r8, g8, b8: u8 [H, W] planes; bits: u8 [H, (W + 7) / 8]; params: the 14
// ints of smh::classify_params (host memory).
extern "C" int smh_fused_mask(const void* r8, const void* g8, const void* b8,
                              void* bits, int H, int W, const void* params,
                              void* stream) {
  const smh::ClassifyParams p = smh::classify_params(params);
  if (H <= 0 || W <= 0) return (int)cudaSuccess;
  const int bpr = (W + 7) / 8;
  const dim3 block(TB, TH);
  const dim3 grid((bpr + TB - 1) / TB, (H + TH - 1) / TH);
  fused_mask_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(r8), static_cast<const uint8_t*>(g8),
      static_cast<const uint8_t*>(b8), static_cast<uint8_t*>(bits), H, W, bpr,
      p);
  return (int)cudaGetLastError();
}
