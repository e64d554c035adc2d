// Marker classify + Rec.709 luma over three u8 channel planes.
//
// Replaces smh_tpu/ops/pallas_kernels.py::_classify_luma_kernel (entry
// classify_luma_pallas_planes). Per pixel: the marker predicate and the luma
// of classify.cuh, bit-exact with pixmath.
//
// What bounds it on an H100: not its bytes. It reads 3 and writes 2 bytes
// per pixel (4.05 MB at the 1080p map ROI, 1.21 us at 3.35 TB/s; 16.2 MB,
// 4.84 us at 4K), but the launch and the blocks' ramp cost more at these
// sizes, and where pixels pass the max-byte mask the classify's issue does
// (PERF.md splits the time). The design before this one, a thread a pixel
// with seven correctly rounded divisions and one-byte loads and stores,
// spent as long on a map with almost no marker-coloured pixel as on random
// planes. This one:
//
//  * classifies with classify.cuh: a table of k/255, the max-byte mask
//    (no division for a pixel whose max byte fails it: all but a few per
//    thousand of a real map) and one hue division past it, the pixels
//    past the mask classified warp-wide (marker_bits);
//  * gives each thread PX = 4 consecutive pixels (8 and 16 measured slower:
//    fewer blocks to build the grid from, more registers). It reads each
//    plane as aligned 32-bit words, PX / 4 of them plus one where the plane
//    does not start 4-byte aligned, and shifts them into place with
//    __funnelshift_r (the staging of quiet_walk.cu). Only words that hold a
//    byte of the plane are read. The main path's planes are views of one
//    flat buffer at k * H * W, so their starts differ in alignment; a
//    plane's shift is the same for every thread, so no warp diverges on it.
//  * writes marker and luma as one 4-byte store each into the fresh outputs
//    (the entry refuses outputs and an output stride not aligned to PX
//    bytes: the wrapper pads a batch's frames to PX), bytes one at a time
//    only in the last, partial group;
//  * launches a thread per group, no grid-stride loop: 792 blocks of 256 at
//    822x986, 6 a SM on all 132 SMs at once; each block first copies the
//    tables into its shared memory, under the latency of its plane loads.
//
// A batch of B frames is one launch: blockIdx.y selects the frame, whose
// planes start in_stride bytes and whose outputs start out_stride bytes
// after the previous frame's (the batched pass's planes are rows of one
// [B, padded] buffer). Only the base pointers move per frame; the per-frame
// call is the B = 1 case, built without the five pointer offsets (BATCH
// false: with them the per-frame call measured ~0.1 us slower).
//
// The tables themselves are built once per device by smh_classify_tables
// (one block, a thread an entry, from the 14 params).

#include <cuda_runtime.h>
#include <stdint.h>

#include "classify.cuh"

namespace {

constexpr int PX = 4;          // pixels per thread
constexpr int WORDS = PX / 4;  // aligned 32-bit words of a plane per thread
constexpr int THREADS = 256;

// 4 * N bytes of a thread's words into memory aligned to 4 * N bytes.
template <int N>
__device__ __forceinline__ void store_words(uint8_t* p, const uint32_t* w) {
  if constexpr (N == 1) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    static_assert(N == 4, "PX is 4, 8 or 16");
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Bytes [i0, i0 + 4 * WORDS) of a plane of n bytes as WORDS little-endian
// words (bytes at or past n read as 0).
__device__ __forceinline__ void load_words(const uint8_t* __restrict__ plane, int64_t i0, int64_t n,
                                           uint32_t* out) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(plane + i0);
  const uint32_t* al = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const int sh = (int)(a & 3);
  const uint8_t* end = plane + n;
  uint32_t w[WORDS + 1];
#pragma unroll
  for (int j = 0; j <= WORDS; ++j) {
    const bool holds = reinterpret_cast<const uint8_t*>(al + j) < end && (j < WORDS || sh != 0);
    w[j] = holds ? __ldg(al + j) : 0u;
  }
#pragma unroll
  for (int j = 0; j < WORDS; ++j) out[j] = __funnelshift_r(w[j], w[j + 1], 8 * sh);
}

template <bool BATCH>
__global__ void __launch_bounds__(THREADS, 6)
classify_luma_kernel(const uint8_t* __restrict__ r8, const uint8_t* __restrict__ g8,
                     const uint8_t* __restrict__ b8, uint8_t* __restrict__ marker,
                     uint8_t* __restrict__ luma, int64_t n, int64_t in_stride, int64_t out_stride,
                     const smh::ClassifyTables* __restrict__ tables) {
  __shared__ smh::ClassifyTables tab;
  __shared__ uint32_t scratch[THREADS / 32][32];
  const int64_t i0 = ((int64_t)blockIdx.x * THREADS + threadIdx.x) * PX;
  if constexpr (BATCH) {  // this block's frame
    r8 += blockIdx.y * in_stride;
    g8 += blockIdx.y * in_stride;
    b8 += blockIdx.y * in_stride;
    marker += blockIdx.y * out_stride;
    luma += blockIdx.y * out_stride;
  }
  smh::load_tables(tab, tables);  // first: its latency hides under the plane loads'
  const bool live = i0 < n;  // threads past n still take part in the warp's classify
  uint32_t rw[WORDS] = {}, gw[WORDS] = {}, bw[WORDS] = {}, mw[WORDS] = {}, lw[WORDS] = {};
  if (live) {
    load_words(r8, i0, n, rw);
    load_words(g8, i0, n, gw);
    load_words(b8, i0, n, bw);
  }
  __syncthreads();  // the tables

  uint32_t rgb[PX];
  uint32_t pass = 0;  // bit k: pixel k's max byte passed the mask
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int sh = 8 * (k & 3);
    const int r = (rw[k >> 2] >> sh) & 0xff, g = (gw[k >> 2] >> sh) & 0xff, b = (bw[k >> 2] >> sh) & 0xff;
    rgb[k] = r | g << 8 | b << 16;
    pass |= (uint32_t)(live && smh::passes_mask(smh::max3(r, g, b), tab)) << k;
    lw[k >> 2] |= smh::luma8(r, g, b) << sh;
  }
  const uint32_t marked = smh::marker_bits<PX>(rgb, pass, scratch[threadIdx.x >> 5], tab);
#pragma unroll
  for (int k = 0; k < PX; ++k) mw[k >> 2] |= ((marked >> k) & 1u) << (8 * (k & 3));
  if (!live) return;
  if (i0 + PX <= n) {
    store_words<WORDS>(marker + i0, mw);
    store_words<WORDS>(luma + i0, lw);
  } else {
    for (int k = 0; k < (int)(n - i0); ++k) {
      marker[i0 + k] = (uint8_t)(mw[k >> 2] >> (8 * (k & 3)));
      luma[i0 + k] = (uint8_t)(lw[k >> 2] >> (8 * (k & 3)));
    }
  }
}

// The classify tables, one thread an entry.
__global__ void __launch_bounds__(384) classify_tables_kernel(smh::ClassifyTables* __restrict__ t,
                                                              smh::ClassifyParams p) {
  if (threadIdx.x < smh::HUE_ENTRIES) smh::build_table_entry(t, p, threadIdx.x);
}

}  // namespace

// Bytes of the tables smh_classify_tables writes.
extern "C" int smh_classify_tables_bytes() { return (int)sizeof(smh::ClassifyTables); }

// tables: device memory of smh_classify_tables_bytes(), 16-byte aligned;
// params: the 14 ints of smh::classify_params (host memory). One block.
extern "C" int smh_classify_tables(void* tables, const void* params, void* stream) {
  classify_tables_kernel<<<1, 384, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<smh::ClassifyTables*>(tables), smh::classify_params(params));
  return (int)cudaGetLastError();
}

// B frames of n pixels each: frame f's planes start at r8/g8/b8 + f * in_stride
// and its outputs at marker/luma + f * out_stride (bytes). marker, luma and
// out_stride must be PX-byte aligned. tables: as written by
// smh_classify_tables.
extern "C" int smh_classify_luma(const void* r8, const void* g8, const void* b8,
                                 void* marker, void* luma, int64_t n, int B, int64_t in_stride,
                                 int64_t out_stride, const void* tables, void* stream) {
  if (n <= 0 || B <= 0) return (int)cudaSuccess;
  if (B > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
  if ((reinterpret_cast<uintptr_t>(marker) | reinterpret_cast<uintptr_t>(luma) | (uintptr_t)out_stride) % PX != 0)
    return (int)cudaErrorMisalignedAddress;
  const int64_t blocks = (n + (int64_t)THREADS * PX - 1) / ((int64_t)THREADS * PX);
  auto kernel = B > 1 ? classify_luma_kernel<true> : classify_luma_kernel<false>;
  kernel<<<dim3((unsigned)blocks, (unsigned)B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(r8), static_cast<const uint8_t*>(g8),
      static_cast<const uint8_t*>(b8), static_cast<uint8_t*>(marker),
      static_cast<uint8_t*>(luma), n, in_stride, out_stride,
      static_cast<const smh::ClassifyTables*>(tables));
  return (int)cudaGetLastError();
}
