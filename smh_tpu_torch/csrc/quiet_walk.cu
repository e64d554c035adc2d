// Minimap quiet mask + walk reductions over batched u8 channel planes.
//
// Replaces smh_tpu/ops/pallas_kernels.py::_quiet_walk_kernel_factory (entry
// _rect_pallas_batched / minimap_rect_pallas_planes). quiet[y, x] holds when
// every one of the 8 neighbours has a channel-summed absolute difference
// <= 7; the 1-px border is never quiet. The kernel reduces the quiet mask to
// exactly what the minimap walk reads, as 3-bit words:
//   colbits[b, x]: bit 0 = AND of quiet over rows [cy+1, cy+1+lv),
//                  bit 1 = AND over rows [cy-lv, cy), bit 2 = quiet[cy, x];
//   rowbits[b, y]: bit 0 = AND over columns [cx+1, cx+1+lh),
//                  bit 1 = AND over columns [cx-lh, cx), bit 2 = quiet[y, cx].
// The caller fills both arrays with 7 (the AND identity); the walks over
// these [B, W] / [B, H] vectors stay in PyTorch.
//
// What bounds it on an H100: bytes. The planes are read once from device
// memory (3 bytes per pixel, ~2.4 MB at 1080p, ~9.7 MB at 4K); the 8-neighbour
// SAD (~50 integer ops per pixel) runs from shared memory. The design: one
// 32x8 block per tile, the tile plus its 1-px halo staged in shared memory,
// one pixel per thread. Row partials reduce inside a warp (a warp is one tile
// row) and column partials through shared memory; each block then merges
// into the global words with atomicAnd. Blocks finish in any order, so the
// merge across row tiles is a BITWISE AND — a min() over the packed words
// would let one tile's set bit survive another tile's clear bit. There is no
// limit on the run lengths lv and lh.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;  // tile width = one warp
constexpr int TH = 8;   // tile height = warps per block

__global__ void quiet_walk_kernel(const uint8_t* __restrict__ p0,
                                  const uint8_t* __restrict__ p1,
                                  const uint8_t* __restrict__ p2,
                                  int* __restrict__ colbits,
                                  int* __restrict__ rowbits, int H, int W,
                                  int cy, int lv, int cx, int lh) {
  __shared__ uint8_t tile[3][TH + 2][TW + 2];
  __shared__ int colred[TH][TW];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int64_t base = (int64_t)b * H * W;
  const uint8_t* planes[3] = {p0 + base, p1 + base, p2 + base};

  const int tid = threadIdx.y * TW + threadIdx.x;
  for (int k = tid; k < (TH + 2) * (TW + 2); k += TW * TH) {
    const int ty = k / (TW + 2);
    const int tx = k % (TW + 2);
    const int gy = y0 + ty - 1;
    const int gx = x0 + tx - 1;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const int64_t off = (int64_t)gy * W + gx;
#pragma unroll
    for (int c = 0; c < 3; ++c) tile[c][ty][tx] = in ? planes[c][off] : 0;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  bool quiet = x >= 1 && x <= W - 2 && y >= 1 && y <= H - 2;
  if (quiet) {
    const int ty = threadIdx.y + 1;
    const int tx = threadIdx.x + 1;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy == 0 && dx == 0) continue;
        int sad = 0;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int d = (int)tile[c][ty][tx] - (int)tile[c][ty + dy][tx + dx];
          sad += d < 0 ? -d : d;
        }
        quiet = quiet && sad <= 7;
      }
    }
  }

  // This pixel's contribution to its column's and its row's 3-bit words:
  // a non-quiet pixel inside a range clears that range's bit.
  int cbit = 7;
  int rbit = 7;
  if (x < W && y < H && !quiet) {
    if (y >= cy + 1 && y < cy + 1 + lv) cbit &= ~1;
    if (y >= cy - lv && y < cy) cbit &= ~2;
    if (y == cy) cbit &= ~4;
    if (x >= cx + 1 && x < cx + 1 + lh) rbit &= ~1;
    if (x >= cx - lh && x < cx) rbit &= ~2;
    if (x == cx) rbit &= ~4;
  }

  // Row words: one warp is one tile row.
  rbit = __reduce_and_sync(0xffffffffu, (unsigned)rbit);
  if (threadIdx.x == 0 && y < H && rbit != 7)
    atomicAnd(&rowbits[(int64_t)b * H + y], rbit);

  // Column words: AND down the tile's rows through shared memory.
  colred[threadIdx.y][threadIdx.x] = cbit;
  __syncthreads();
  if (threadIdx.y == 0 && x < W) {
    int v = 7;
#pragma unroll
    for (int r = 0; r < TH; ++r) v &= colred[r][threadIdx.x];
    if (v != 7) atomicAnd(&colbits[(int64_t)b * W + x], v);
  }
}

}  // namespace

extern "C" int smh_quiet_walk(const void* p0, const void* p1, const void* p2,
                              void* colbits, void* rowbits, int B, int H, int W,
                              int cy, int lv, int cx, int lh, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const dim3 block(TW, TH);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  quiet_walk_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(p0), static_cast<const uint8_t*>(p1),
      static_cast<const uint8_t*>(p2), static_cast<int*>(colbits),
      static_cast<int*>(rowbits), H, W, cy, lv, cx, lh);
  return (int)cudaGetLastError();
}
