// The dilated marker mask's bounding box and its sparse u32 words, from
// kernel 3's bit plane.
//
// Replaces a region of smh_tpu's jitted fused pass (XLA ops, not a Pallas
// kernel; smh_tpu/ops/pipeline.py::_pack_outputs :792): _mask_bbox (:326,
// with _first_true_count :313) and _sparse_words (:267), that is
// _pack_words32 (:203) and the "search" engine of _compact_words (:225),
// both over the dilated marker mask lsd_bool. The plain twin is
// smh_tpu_torch/ops/kernels.py::mask_bbox_sparse_plain; every output lane
// equals it. Per frame it writes i32 [7 + 2 budget]:
//
//   y0, y1, x0, x1  the bbox, end-exclusive (H, 0, W, 0 for an empty mask)
//   0, 0            the sparse transport's crop origin
//   nz              the TOTAL count of non-zero words (the ladder climbs on it)
//   idx[budget]     the first `budget` non-zero words' indices, in order
//   dat[budget]     and the words (u32 bits), both zero past min(nz, budget)
//
// that is the hostpack's lsd_meta and lsd_nz / lsd_sp_idx / lsd_sp_dat
// bytes. Word j of row i is bytes 4j .. 4j + 3 of the row (bytes past
// (W + 7) / 8 zero) as a little-endian u32, index i * nw + j with nw =
// ceil(((W + 7) / 8) / 4); pixel p of a word is bit 7 - p % 8 of its byte
// p / 8. Bits past column W are read as zero (kernel 3 writes them zero).
//
// What bounds it on an H100: not its bytes. It reads the bit plane once
// (101.6 KB at the 1080p map, 406 KB at 4K: 0.03 / 0.12 us at 3.35 TB/s)
// and writes 8 budget + 28 bytes. The launch, one pass of loads, the
// scans and a cluster barrier cost more. The design:
//
//  * a cluster of CLUSTER blocks per frame; block b takes a contiguous run
//    of tiles of THREADS words, a word a thread per tile (coalesced), so
//    the words lie in index order by (block, tile, thread); a thread issues
//    the loads of LOADS tiles before it uses any (a first design that
//    loaded a tile's word, balloted it, then loaded the next spent a load
//    latency per tile: 15.3-15.7 us for a 1644 x 1972 mask, 13 tiles a
//    block, on an H100, against 10.3-10.4 with the rows below);
//  * a word's row is k / nw by a corrected f32 reciprocal (row_of), not an
//    integer division by a runtime divisor;
//  * each thread keeps a bit per tile that held a non-zero word; each warp
//    ballots the tile's non-zero words into shared memory; warps scan those
//    counts tile by tile and warp 0 scans the tiles' totals: a word's rank
//    in the block is its tile's offset, its warp's, and the popcount of the
//    ballot below its lane;
//  * the bbox: a word's row, and the first and last pixel of the word
//    (__brev of its byte swap puts pixel p at bit p), min / max reduced over
//    the warp, then the block in shared memory;
//  * each block writes its count and bbox into every block's shared memory
//    (distributed shared memory) after the cluster's start, then one
//    cluster barrier; every block then knows its base and nz, writes its
//    words of rank < budget (only the non-zero words are loaded again) and
//    clears its share of the slots past min(nz, budget); block 0 writes the
//    bbox and nz. No block touches another's memory after the barrier.
//
// A batch is one launch, a cluster per frame: frame f's bits start at bits +
// f * stride bytes, its output at out + f (7 + 2 budget) i32s.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;       // blocks per frame: one thread block cluster
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TILES = 64;    // tiles of THREADS words a block takes: a bit each in a u64
constexpr int LOADS = 8;         // words a thread has in flight: the tiles' loads go out in groups
constexpr int64_t MAX_WORDS = (int64_t)CLUSTER * THREADS * MAX_TILES;
constexpr int META = 7;          // y0, y1, x0, x1, cy0, cx0, nz
constexpr unsigned FULL = 0xffffffffu;
static_assert(MAX_TILES <= 64, "a thread's tiles are the bits of a u64");
static_assert(MAX_WORDS <= (1 << 24), "a word's index is exact in f32 (row_of)");

struct Shared {
  uint32_t ballot[MAX_TILES][WARPS];  // the non-zero words of (tile, warp)
  int offset[MAX_TILES][WARPS];       // then the rank of its first in the tile
  int tile_offset[MAX_TILES];         // the rank of the tile's first in the block
  int total;                          // the block's non-zero words
  int box[4];                         // the block's y0, y1, x0, x1
  int part[5][CLUSTER];               // every block's total and box, written by that block
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Word k of the frame (k < n): the u32 of row i = k / nw, word j = k % nw.
// `aligned`: every word lies 4-byte aligned (one load); else its bytes past
// the row's end read as zero, a load each. All loads are issued before any
// is used.
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ bits, int i, int j, int bpr,
                                              bool aligned) {
  const uint8_t* p = bits + (int64_t)i * bpr + 4 * j;
  if (aligned) return __ldg(reinterpret_cast<const uint32_t*>(p));
  const int n = bpr - 4 * j;
  const uint32_t b0 = __ldg(p);
  const uint32_t b1 = n > 1 ? __ldg(p + 1) : 0u;
  const uint32_t b2 = n > 2 ? __ldg(p + 2) : 0u;
  const uint32_t b3 = n > 3 ? __ldg(p + 3) : 0u;
  return b0 | b1 << 8 | b2 << 16 | b3 << 24;
}

// k / nw for 0 <= k < 2^24 (exact in f32), inv = 1 / nw rounded: the f32
// quotient is within one of k / nw, and one correction either way makes it
// exact; a few instructions, where an integer division by a runtime nw
// takes ~20 a word.
__device__ __forceinline__ int row_of(int k, int nw, float inv) {
  int i = __float2int_rz(__int2float_rz(k) * inv);
  const int r = k - i * nw;
  return i + (r >= nw) - (r < 0);
}

// The word with its pixels at columns >= W cleared (kernel 3 writes them 0).
__device__ __forceinline__ uint32_t inside(uint32_t v, int j, int W) {
  const int valid = W - 32 * j;  // pixels of the word inside the plane
  if (valid >= 32) return v;
  const uint32_t keep = (1u << valid) - 1u;       // pixels 0 .. valid - 1
  return v & __byte_perm(__brev(keep), 0, 0x0123);  // in the word's bit order
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
    mask_words_kernel(const uint8_t* __restrict__ bits, int64_t stride, int H, int W, int bpr, int nw, int n,
                      int tiles, int budget, bool aligned, float inv_nw, int32_t* __restrict__ out) {
  __shared__ Shared s;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t frame = blockIdx.x / CLUSTER;
  bits += frame * stride;
  out += frame * (int64_t)(META + 2 * budget);
  const int t0 = rank * tiles;  // this block's first tile
  if (tid < 4) s.box[tid] = tid == 0 ? H : (tid == 2 ? W : 0);
  cluster_arrive();  // waited on before another block writes this block's memory

  // One pass of loads, LOADS tiles' words in flight at a time: the
  // non-zero words, their rows and pixels.
  uint64_t mine = 0;  // bit t: this thread's word of tile t is non-zero
  int y0 = H, y1 = 0, x0 = W, x1 = 0;
  for (int g = 0; g < tiles; g += LOADS) {
    uint32_t v[LOADS];
    int row[LOADS], col[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int k = (t0 + g + u) * THREADS + tid;
      row[u] = row_of(k, nw, inv_nw);
      col[u] = k - row[u] * nw;
      v[u] = (g + u < tiles && k < n) ? load_word(bits, row[u], col[u], bpr, aligned) : 0u;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int t = g + u;
      if (t >= tiles) break;  // block-uniform
      const uint32_t w = inside(v[u], col[u], W);
      const unsigned b = __ballot_sync(FULL, w != 0u);
      if (lane == 0) s.ballot[t][warp] = b;
      if (w != 0u) {
        mine |= 1ull << t;
        const uint32_t d = __brev(__byte_perm(w, 0, 0x0123));  // bit p = pixel p
        y0 = min(y0, row[u]);
        y1 = max(y1, row[u] + 1);
        x0 = min(x0, 32 * col[u] + __ffs(d) - 1);
        x1 = max(x1, 32 * col[u] + 32 - __clz(d));
      }
    }
  }
  y0 = __reduce_min_sync(FULL, y0);
  y1 = __reduce_max_sync(FULL, y1);
  x0 = __reduce_min_sync(FULL, x0);
  x1 = __reduce_max_sync(FULL, x1);
  __syncthreads();  // the ballots; the box's initial values
  if (lane == 0 && y0 < y1) {
    atomicMin(&s.box[0], y0);
    atomicMax(&s.box[1], y1);
    atomicMin(&s.box[2], x0);
    atomicMax(&s.box[3], x1);
  }
  // Warp w scans tiles w, w + WARPS, ...: each warp's offset in its tile.
  for (int t = warp; t < tiles; t += WARPS) {
    const int c = __popc(s.ballot[t][lane]);
    int inc = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += up;
    }
    s.offset[t][lane] = inc - c;
    if (lane == 31) s.tile_offset[t] = inc;  // the tile's total, for now
  }
  __syncthreads();
  if (warp == 0) {  // the tiles' offsets in the block
    int carry = 0;
    for (int t0w = 0; t0w < tiles; t0w += 32) {
      const int t = t0w + lane;
      const int c = t < tiles ? s.tile_offset[t] : 0;
      int inc = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += up;
      }
      if (t < tiles) s.tile_offset[t] = carry + inc - c;
      carry += __shfl_sync(FULL, inc, 31);
    }
    if (lane == 0) s.total = carry;
  }
  __syncthreads();

  // Every block's total and box into every block, then one barrier.
  cluster_wait();  // every block has started
  if (tid < 5 * CLUSTER) {
    const int q = tid / CLUSTER, dst = tid % CLUSTER;
    const int v = q == 0 ? s.total : s.box[q - 1];
    *cluster.map_shared_rank(&s.part[q][rank], dst) = v;
  }
  cluster.sync();

  int base = 0, nz = 0;
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r) {
    base += r < rank ? s.part[0][r] : 0;
    nz += s.part[0][r];
  }
  if (rank == 0 && tid < META) {
    int v = 0;
    if (tid == 6) {
      v = nz;
    } else if (tid < 4) {
      v = s.part[tid + 1][0];
      for (int r = 1; r < CLUSTER; ++r) {
        const int u = s.part[tid + 1][r];
        v = (tid & 1) ? max(v, u) : min(v, u);  // y1, x1 the largest; y0, x0 the smallest
      }
    }
    out[tid] = v;
  }
  int32_t* idx = out + META;
  int32_t* dat = idx + budget;
  const unsigned below = (1u << lane) - 1u;
  for (uint64_t m = mine; m != 0; m &= m - 1) {
    const int t = __ffsll((long long)m) - 1;
    const int at = base + s.tile_offset[t] + s.offset[t][warp] + __popc(s.ballot[t][warp] & below);
    if (at < budget) {
      const int k = (t0 + t) * THREADS + tid;
      const int i = row_of(k, nw, inv_nw), j = k - i * nw;
      idx[at] = k;
      dat[at] = (int32_t)inside(load_word(bits, i, j, bpr, aligned), j, W);
    }
  }
  for (int at = min(nz, budget) + rank * THREADS + tid; at < budget; at += CLUSTER * THREADS) {
    idx[at] = 0;
    dat[at] = 0;
  }
}

}  // namespace

// B frames: frame f's bit plane, H rows of (W + 7) / 8 bytes, at bits + f *
// stride (bytes); its output, i32 [7 + 2 budget], at out + f (7 + 2 budget).
extern "C" int smh_mask_words(const void* bits, int64_t stride, int H, int W, int B, int budget, void* out,
                              void* stream) {
  const int bpr = (W + 7) / 8;
  const int nw = (bpr + 3) / 4;
  const int64_t n = (int64_t)H * nw;
  if (H <= 0 || W <= 0 || B <= 0 || budget < 0 || n > MAX_WORDS || (int64_t)B * CLUSTER > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int tiles = (int)(((n + THREADS - 1) / THREADS + CLUSTER - 1) / CLUSTER);
  const bool aligned = bpr % 4 == 0 && stride % 4 == 0 && (reinterpret_cast<uintptr_t>(bits) & 3u) == 0;
  mask_words_kernel<<<B * CLUSTER, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), stride, H, W, bpr, nw, (int)n, tiles, budget, aligned, 1.0f / (float)nw,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
