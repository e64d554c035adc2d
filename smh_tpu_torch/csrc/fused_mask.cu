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
// column of a ragged row. This kernel masks every bit at x >= W to zero.
//
// What bounds it on an H100: not its bytes. It reads 3 bytes and writes 1/8
// byte per pixel (2.53 MB at the 1080p map: 0.76 us at 3.35 TB/s; 10.1 MB,
// 3.02 us at 4K). The launch, each block's chain of dependent phases (the
// plane loads, the classify, the dilate and the store, two barriers) and,
// where pixels pass the max-byte mask, the classify's issue cost more
// (PERF.md splits the time). The design before this one, ~10 dependent
// classify iterations per thread (each with a k / 258 and a k % 258 and
// seven correctly rounded divisions) into a byte-per-pixel tile, 26 % of
// it halo, then 40 shared byte reads per output byte, spent as long on a
// map with almost no marker-coloured pixel as on random planes. This one:
//
//  * classify once, pack with a ballot. A warp classifies 32 consecutive
//    pixels of a row, one lane a pixel (classify.cuh: table, max-byte mask,
//    one hue division past it, the pixels past the mask classified
//    warp-wide); every lane reaches __ballot_sync, lanes at x >= W vote 0,
//    and the ballot is one u32 marker word (bit i = pixel x0 + i). A lane
//    loads its items' bytes first, clamped into the plane so that no load
//    waits on a branch, and classifies them after.
//  * a shared tile of TH + 2 word rows, WPR words wide (TW = 32 * WPR
//    pixels): only the row halo is re-classified (2 rows in 18); the
//    1-pixel column halo comes from the neighbour words in the tile, and at
//    the tile's outer edges from the one pixel beyond, a tenth item of the
//    36 lanes tid < 2 * (TH + 2) (only those load it: each such load is a
//    sector of its own).
//  * dilate on words: m | m << 1 | m >> 1 with the neighbours' carry bits,
//    OR the rows above and below, then the bits at x >= W masked to 0.
//  * MSB-first bytes are __byte_perm(__brev(word), 0, 0x0123): one 4-byte
//    store where the output row keeps word alignment (124 B rows at 1080p),
//    bytes one at a time where it does not (247 B rows at 4K) and at a
//    row's last word.
//  * 16 x 128 tiles, 8 warps: (8, 52) = 416 blocks at 822x986, 3-4 a SM,
//    all resident at once (64 registers a thread). No integer division by
//    a variable: tile indices are shifts. The tables are copied into shared
//    memory first, under the latency of the plane loads.
//
// A batch of B frames is one launch: blockIdx.z selects the frame, whose
// planes start in_stride bytes and whose bit plane starts out_stride bytes
// after the previous frame's. Only the base pointers move per frame; the
// per-frame call is the B = 1 case, built without the offsets (BATCH false,
// as in classify_luma.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "classify.cuh"

namespace {

constexpr int WPR = 4;                    // marker words per tile row
constexpr int TW = 32 * WPR;              // tile width, pixels
constexpr int TH = 16;                    // tile height, rows
constexpr int SR = TH + 2;                // staged rows: the tile and its halo
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = SR * WPR / WARPS;   // marker words each warp classifies
constexpr unsigned FULL = 0xffffffffu;
static_assert((WPR & (WPR - 1)) == 0, "WPR is a power of two: tile indices are shifts");
static_assert(SR * WPR % WARPS == 0, "every warp classifies the same number of words");
static_assert(2 * SR <= THREADS && TH * WPR <= THREADS, "one pass for the edges and the output words");

template <bool BATCH>
__global__ void __launch_bounds__(THREADS, 4)
fused_mask_kernel(const uint8_t* __restrict__ r8, const uint8_t* __restrict__ g8,
                  const uint8_t* __restrict__ b8, uint8_t* __restrict__ bits, int H, int W,
                  int bpr, int64_t in_stride, int64_t out_stride,
                  const smh::ClassifyTables* __restrict__ tables) {
  __shared__ smh::ClassifyTables tab;
  __shared__ uint32_t m[SR][WPR];
  __shared__ uint32_t edge[2][SR];  // pixel x0 - 1 and x0 + TW of each staged row
  __shared__ uint32_t scratch[WARPS][32];

  smh::load_tables(tab, tables);  // first: its latency hides under the plane loads'
  if constexpr (BATCH) {  // this block's frame
    r8 += blockIdx.z * in_stride;
    g8 += blockIdx.z * in_stride;
    b8 += blockIdx.z * in_stride;
    bits += blockIdx.z * out_stride;
  }
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const unsigned warp = tid >> 5;

  // Load every byte this thread classifies (clamped into the plane, so no
  // load waits on a branch), then classify: item i < ITEMS is the lane's
  // pixel of marker word warp + WARPS * i; item ITEMS, on lanes tid < 2 * SR
  // only, the pixel one past an edge of staged row tid / 2.
  uint32_t rgb[ITEMS + 1];
  uint32_t in = 0;  // bit i: item i is a pixel of the plane
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const unsigned k = warp + WARPS * i;  // marker word: staged row k / WPR, word k % WPR
    const int gy = y0 - 1 + (int)(k / WPR);
    const int gx = x0 + 32 * (int)(k % WPR) + lane;
    in |= (uint32_t)(gy >= 0 && gy < H && gx < W) << i;
    const int64_t off = (int64_t)min(max(gy, 0), H - 1) * W + min(gx, W - 1);
    rgb[i] = __ldg(r8 + off) | __ldg(g8 + off) << 8 | __ldg(b8 + off) << 16;
  }
  rgb[ITEMS] = 0;
  if (tid < 2 * SR) {  // only these lanes: each of their loads is a sector of its own
    const int gy = y0 - 1 + (tid >> 1);
    const int gx = (tid & 1) ? x0 + TW : x0 - 1;
    in |= (uint32_t)(gy >= 0 && gy < H && gx >= 0 && gx < W) << ITEMS;
    const int64_t off = (int64_t)min(max(gy, 0), H - 1) * W + min(max(gx, 0), W - 1);
    rgb[ITEMS] = __ldg(r8 + off) | __ldg(g8 + off) << 8 | __ldg(b8 + off) << 16;
  }
  __syncthreads();  // the tables

  uint32_t pass = 0;  // bit i: item i is in the plane and passed the max-byte mask
#pragma unroll
  for (int i = 0; i <= ITEMS; ++i)
    pass |= (uint32_t)(((in >> i) & 1u) &&
                       smh::passes_mask(smh::max3(rgb[i] & 0xff, (rgb[i] >> 8) & 0xff, rgb[i] >> 16), tab))
            << i;
  const uint32_t marked = smh::marker_bits<ITEMS + 1>(rgb, pass, scratch[warp], tab);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const unsigned word = __ballot_sync(FULL, (marked >> i) & 1u);
    const unsigned k = warp + WARPS * i;
    if (lane == 0) m[k / WPR][k % WPR] = word;
  }
  if (tid < 2 * SR) edge[tid & 1][tid >> 1] = (marked >> ITEMS) & 1u;
  __syncthreads();

  if (tid >= TH * WPR) return;
  const int r = (unsigned)tid / WPR + 1;  // staged row of this output word
  const int j = (unsigned)tid % WPR;
  const int y = y0 + r - 1;
  const int xw = x0 + 32 * j;  // pixel of bit 0
  if (y >= H || xw >= W) return;
  const uint32_t c = m[r][j];
  const uint32_t left = j > 0 ? m[r][j - 1] >> 31 : edge[0][r];
  const uint32_t right = j < WPR - 1 ? m[r][j + 1] << 31 : edge[1][r] << 31;
  uint32_t d = c | m[r - 1][j] | m[r + 1][j] | (c << 1) | left | (c >> 1) | right;
  if (W - xw < 32) d &= (1u << (W - xw)) - 1u;  // pad bits stay zero
  const uint32_t out = __byte_perm(__brev(d), 0, 0x0123);  // byte 0 = pixels 0..7, MSB first

  const int nbytes = min(4, bpr - (xw >> 3));
  uint8_t* dst = bits + (int64_t)y * bpr + (xw >> 3);
  if (nbytes == 4 && (reinterpret_cast<uintptr_t>(dst) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(dst) = out;
  } else {
    for (int b = 0; b < nbytes; ++b) dst[b] = (uint8_t)(out >> (8 * b));
  }
}

}  // namespace

// B frames: frame f's u8 [H, W] planes start at r8/g8/b8 + f * in_stride and
// its bits, u8 [H, (W + 7) / 8], at bits + f * out_stride (bytes); tables: as
// written by smh_classify_tables (classify_luma.cu).
extern "C" int smh_fused_mask(const void* r8, const void* g8, const void* b8,
                              void* bits, int H, int W, int B, int64_t in_stride,
                              int64_t out_stride, const void* tables, void* stream) {
  if (H <= 0 || W <= 0 || B <= 0) return (int)cudaSuccess;
  if (B > 65535) return (int)cudaErrorInvalidValue;  // gridDim.z
  const int bpr = (W + 7) / 8;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  auto kernel = B > 1 ? fused_mask_kernel<true> : fused_mask_kernel<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(r8), static_cast<const uint8_t*>(g8),
      static_cast<const uint8_t*>(b8), static_cast<uint8_t*>(bits), H, W, bpr, in_stride,
      out_stride, static_cast<const smh::ClassifyTables*>(tables));
  return (int)cudaGetLastError();
}
