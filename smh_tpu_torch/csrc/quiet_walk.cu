// Minimap rect over batched u8 channel planes: the quiet mask, its run
// reductions and the four centre-out walks, in ONE launch that writes the
// i32 [B, 4] (left, top, right, bottom) rects.
//
// Replaces smh_tpu/ops/pallas_kernels.py::_quiet_walk_kernel_factory and the
// XLA walk tail of _rect_pallas_batched (entry minimap_rect_pallas_planes).
// quiet[y, x] holds when every one of the 8 neighbours has a channel-summed
// absolute difference <= 7; the 1-px border is never quiet. With
// cy = H/2, cx = W/2, lv = (H - cy)/2 - 1, lh = (W - cx)/2 - 1, the walks read
//   left   = 1 + the largest x in [3, cx) with quiet[cy, x] and quiet over
//            rows [cy+1, cy+1+lv) of column x, else 0;
//   right  = the smallest x in [cx+1, W-3] with quiet[cy, x] and quiet over
//            rows [cy-lv, cy), minus 1, else W-1;
//   top    = 1 + the largest y in [3, cy) with quiet[y, cx] and quiet over
//            columns [cx+1, cx+1+lh) of row y, else 0;
//   bottom = the smallest y in [cy+1, H-3] with quiet[y, cx] and quiet over
//            columns [cx-lh, cx), minus 1, else H-1;
// a run range that is not empty but starts below 3 or ends past dim-3
// qualifies nothing (the reference's walk bounds); an empty one passes. There
// is no limit on the run lengths lv and lh.
//
// What bounds it on an H100: bytes and launch latency. The function must read
// the three planes once (3 B/px: 2.43 MB at 822x986, 0.73 us at 3.35 TB/s;
// 9.73 MB, 2.90 us at 1644x1972), and at these sizes a launch and the
// blocks' fixed costs weigh more than that. The design before this one read
// one byte per thread from 32x8 tiles (33 % halo re-read) and left [B, W] /
// [B, H] words that ~55 PyTorch ops walked, host-enqueued one by one (~1.2 ms
// per call). This one:
//
//  * scratch + clearing: the caller passes one i32 scratch of B*(W+H+1)
//    words; the entry clears it with cudaMemsetAsync. The words store the
//    bits that are CLEARED (a non-quiet pixel inside a range) and blocks merge
//    them with atomicOr, so zero is the identity and block order cannot
//    matter:
//      col[b, x]: bit 0 = rows [cy+1, cy+1+lv), bit 1 = rows [cy-lv, cy),
//                 bit 2 = row cy;
//      row[b, y]: bit 0 = columns [cx+1, cx+1+lh), bit 1 = [cx-lh, cx),
//                 bit 2 = column cx.
//    The last B words count the finished blocks of each batch element.
//  * the quiet pass: 64x32 tiles (10 % halo instead of 33 %), 256 threads,
//    each owning a run of 4 pixels along a row; 416 blocks at 822x986 and
//    B=1 (3 per SM), 1612 at 1644x1972. A tile that meets neither the
//    centre rows [cy-lv, cy+lv] nor the centre columns can clear no bit and
//    reads nothing. Loads: the map rows are 986 and 1972 B long, so a row
//    start is only 2- or 4-byte aligned and TMA (16-byte strides) does not
//    apply without a padded pitch. The staged tile holds, per plane and row,
//    the 18 words that cover columns [x0-4, x0+68) at 4-byte alignment
//    relative to the tile; each word is built from the one or two ALIGNED
//    32-bit words of the flat plane that cover it, shifted with
//    __funnelshift_r (a warp asks for ~72 contiguous bytes per row whatever
//    the row's alignment). A thread's 4 pixels are then one word per plane:
//    its left and right neighbours come from __byte_perm of adjacent words,
//    and the 8-neighbour SADs of all 4 pixels run as byte-SIMD
//    (__vabsdiffu4, __vaddus4, __vmaxu4). The sum saturates at 255, which
//    keeps "<= 7" exact. Row words reduce across the 16 threads of a tile
//    row with shuffles, column words through shared-memory atomics, then
//    one global atomicOr per word.
//  * the walks on the card: the last block of each batch element to finish
//    (a per-element done counter after __threadfence, the classic
//    threadfence reduction) runs the four walks as block-wide index
//    reductions (__reduce_max/min_sync, then shared memory) over the
//    cleared-bit words, with the bound gates evaluated from H and W, and
//    writes out[b]. A second launch of B blocks would cost another launch
//    latency and another host launch call for ~1 us of work.
//
// Batch element b's planes start frame_stride bytes after element b-1's
// (the batched pass's planes are rows of one [B, padded] buffer), and its
// rect is out[b * out_stride .. + 4) (i32 elements).
//
// Contract: launches on the given stream, allocates nothing, returns
// cudaGetLastError() (or the memset's error).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 64;                    // tile width, pixels
constexpr int TH = 32;                    // tile height, rows
constexpr int RUN = 4;                    // pixels per thread along a row
constexpr int TPR = TW / RUN;             // threads per tile row (16)
constexpr int THREADS = 256;
constexpr int ROWS_PER_PASS = THREADS / TPR;  // 16
constexpr int SH = TH + 2;                // staged rows: the tile and its halo
constexpr int SWW = TW / 4 + 2;           // staged words per row: columns [x0-4, x0+TW+4)
constexpr int STAGE_ROWS = THREADS / SWW;  // plane rows staged per step (14)
constexpr int STAGE_STEPS = (3 * SH + STAGE_ROWS - 1) / STAGE_ROWS;  // 8
constexpr int WALK_UNROLL = 4;            // scratch words each thread loads at once
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool gate_zero(int lo, int hi, int dim) {
  // The walk's run-bound rule: a non-empty run outside [3, dim-3] qualifies
  // nothing (an empty run qualifies everything: it clears no bit).
  return hi > lo && (lo < 3 || hi - 1 > dim - 3);
}

// Bytewise channel-summed |c - n| of 4 pixels, saturated at 255.
__device__ __forceinline__ uint32_t sad3(const uint32_t* c, const uint32_t* n) {
  return __vaddus4(__vaddus4(__vabsdiffu4(c[0], n[0]), __vabsdiffu4(c[1], n[1])),
                   __vabsdiffu4(c[2], n[2]));
}

__global__ void __launch_bounds__(THREADS)
quiet_walk_kernel(const uint8_t* __restrict__ p0, const uint8_t* __restrict__ p1,
                  const uint8_t* __restrict__ p2, int* __restrict__ scratch,
                  int* __restrict__ out, int B, int H, int W, int64_t frame_stride, int64_t out_stride) {
  __shared__ uint32_t tile[3][SH][SWW];
  __shared__ int colacc[TW];
  __shared__ int red[4][THREADS / 32];
  __shared__ bool last;

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.x;
  const int cy = H / 2, cx = W / 2;
  const int lv = (H - cy) / 2 - 1;
  const int lh = (W - cx) / 2 - 1;
  int* colw = scratch + (int64_t)b * W;
  int* roww = scratch + (int64_t)B * W + (int64_t)b * H;
  unsigned* done = reinterpret_cast<unsigned*>(scratch + (int64_t)B * (W + H));

  // Rows / columns whose pixels can clear a bit.
  const int r_lo = min(cy - lv, cy), r_hi = max(cy + 1 + lv, cy + 1);
  const int c_lo = min(cx - lh, cx), c_hi = max(cx + 1 + lh, cx + 1);
  const bool needed = (y0 < r_hi && y0 + TH > r_lo) || (x0 < c_hi && x0 + TW > c_lo);

  if (needed) {
    if (tid < TW) colacc[tid] = 0;
    const int64_t base = (int64_t)b * frame_stride;
    const int j = tid % SWW;
    const int gx = x0 - 4 + 4 * j;  // map column of the staged word's byte 0
#pragma unroll
    for (int step = 0; step < STAGE_STEPS; ++step) {
      const int pr = tid / SWW + step * STAGE_ROWS;  // plane pr / SH, staged row pr % SH
      if (tid >= STAGE_ROWS * SWW || pr >= 3 * SH) continue;
      const int c = pr / SH;
      const int r = pr - c * SH;
      const int gy = y0 - 1 + r;
      // Bytes outside the map are only ever neighbours of border pixels,
      // which are never quiet: leave them 0 (or the next row's bytes).
      uint32_t v = 0;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const uint8_t* plane = c == 0 ? p0 : (c == 1 ? p1 : p2);
        const uint8_t* row = plane + base + (int64_t)gy * W;
        const uintptr_t a = reinterpret_cast<uintptr_t>(row + gx);
        const uint32_t* al = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
        const int sh = (int)(a & 3);
        // The second word only where it holds a byte of this row: every
        // read is an aligned word that holds a byte of the plane.
        const uint32_t hi =
            (sh != 0 && reinterpret_cast<const uint8_t*>(al + 1) < row + W) ? al[1] : 0u;
        v = __funnelshift_r(al[0], hi, 8 * sh);
      }
      tile[c][r][j] = v;
    }
    __syncthreads();

    const int tx = tid % TPR;
    const int ty = tid / TPR;
    int cbits[RUN] = {0, 0, 0, 0};
#pragma unroll
    for (int pass = 0; pass < TH / ROWS_PER_PASS; ++pass) {
      const int r = ty + pass * ROWS_PER_PASS;  // tile row; staged rows r .. r+2
      const int gy = y0 + r;
      uint32_t ctr[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) ctr[c] = tile[c][r + 1][tx + 1];
      uint32_t m = 0;  // bytewise max over the 8 neighbours' SADs
#pragma unroll
      for (int dr = 0; dr < 3; ++dr) {
        uint32_t lf[3], md[3], rt[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const uint32_t L = tile[c][r + dr][tx], M = tile[c][r + dr][tx + 1], R = tile[c][r + dr][tx + 2];
          lf[c] = __byte_perm(L, M, 0x6543);  // the pixels one column left
          md[c] = M;
          rt[c] = __byte_perm(M, R, 0x4321);  // one column right
        }
        m = __vmaxu4(m, sad3(ctr, lf));
        m = __vmaxu4(m, sad3(ctr, rt));
        if (dr != 1) m = __vmaxu4(m, sad3(ctr, md));
      }
      int rbits = 0;
#pragma unroll
      for (int i = 0; i < RUN; ++i) {
        const int gx = x0 + tx * RUN + i;
        if (gx >= W || gy >= H) continue;  // not a pixel of the map
        const bool quiet = ((m >> (8 * i)) & 0xf8u) == 0 && gx >= 1 && gx <= W - 2 && gy >= 1 && gy <= H - 2;
        if (quiet) continue;
        if (gy >= cy + 1 && gy < cy + 1 + lv) cbits[i] |= 1;
        if (gy >= cy - lv && gy < cy) cbits[i] |= 2;
        if (gy == cy) cbits[i] |= 4;
        if (gx >= cx + 1 && gx < cx + 1 + lh) rbits |= 1;
        if (gx >= cx - lh && gx < cx) rbits |= 2;
        if (gx == cx) rbits |= 4;
      }
      // A warp holds two tile rows of 16 threads each: OR within each half.
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) rbits |= __shfl_xor_sync(FULL, rbits, off);
      if (tx == 0 && rbits != 0 && gy < H) atomicOr(&roww[gy], rbits);
    }
#pragma unroll
    for (int i = 0; i < RUN; ++i)
      if (cbits[i] != 0) atomicOr(&colacc[tx * RUN + i], cbits[i]);
    __syncthreads();
    if (tid < TW && colacc[tid] != 0 && x0 + tid < W) atomicOr(&colw[x0 + tid], colacc[tid]);
  }

  // The last block of this batch element runs the walks.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(done + b, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  const bool down0 = gate_zero(cy + 1, cy + 1 + lv, H);
  const bool up0 = gate_zero(cy - lv, cy, H);
  const bool right0 = gate_zero(cx + 1, cx + 1 + lh, W);
  const bool left0 = gate_zero(cx - lh, cx, W);
  int left = 0, right = W - 1, top = 0, bottom = H - 1;
  for (int i0 = 0; i0 < max(W, H); i0 += WALK_UNROLL * THREADS) {
    int cv[WALK_UNROLL], rv[WALK_UNROLL];  // loaded together, then walked
#pragma unroll
    for (int u = 0; u < WALK_UNROLL; ++u) {
      const int i = i0 + u * THREADS + tid;
      cv[u] = i < W ? __ldcg(colw + i) : 4;
      rv[u] = i < H ? __ldcg(roww + i) : 4;
    }
#pragma unroll
    for (int u = 0; u < WALK_UNROLL; ++u) {
      const int i = i0 + u * THREADS + tid;
      if (!(cv[u] & 4)) {  // the centre row is quiet at column i
        if (i >= 3 && i < cx && !down0 && !(cv[u] & 1)) left = max(left, i + 1);
        if (i >= cx + 1 && i <= W - 3 && !up0 && !(cv[u] & 2)) right = min(right, i - 1);
      }
      if (!(rv[u] & 4)) {  // the centre column is quiet at row i
        if (i >= 3 && i < cy && !right0 && !(rv[u] & 1)) top = max(top, i + 1);
        if (i >= cy + 1 && i <= H - 3 && !left0 && !(rv[u] & 2)) bottom = min(bottom, i - 1);
      }
    }
  }
  left = __reduce_max_sync(FULL, left);
  top = __reduce_max_sync(FULL, top);
  right = __reduce_min_sync(FULL, right);
  bottom = __reduce_min_sync(FULL, bottom);
  const int warp = tid / 32;
  if (tid % 32 == 0) {
    red[0][warp] = left;
    red[1][warp] = top;
    red[2][warp] = right;
    red[3][warp] = bottom;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < THREADS / 32; ++w) {
      left = max(left, red[0][w]);
      top = max(top, red[1][w]);
      right = min(right, red[2][w]);
      bottom = min(bottom, red[3][w]);
    }
    int* o = out + (int64_t)b * out_stride;
    o[0] = left;
    o[1] = top;
    o[2] = right;
    o[3] = bottom;
  }
}

}  // namespace

extern "C" int smh_quiet_walk(const void* p0, const void* p1, const void* p2, void* scratch,
                              void* out, int B, int H, int W, int64_t frame_stride, int64_t out_stride,
                              void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if (B > 65535) return (int)cudaErrorInvalidValue;  // gridDim.z
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(scratch, 0, sizeof(int) * (size_t)B * ((size_t)W + H + 1), s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  quiet_walk_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const uint8_t*>(p0), static_cast<const uint8_t*>(p1),
      static_cast<const uint8_t*>(p2), static_cast<int*>(scratch), static_cast<int*>(out), B, H, W,
      frame_stride, out_stride);
  return (int)cudaGetLastError();
}
