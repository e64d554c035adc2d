// The bottom-right quadrant's text preprocess, the scales binarize and
// their checksums, in one pass over the quadrant.
//
// Replaces a region of smh_tpu's jitted fused pass (XLA ops, not a Pallas
// kernel; smh_tpu/ops/pipeline.py::_analyze_flat_core): the whiteish-text
// isolation _ocr_preprocess_planes (:497) with its (2R+1)^2 box dilate
// _box_dilate_bool (:121), scales_bool = luma != 0 and its pack_bits
// (:137), the _weighted_checks (:340) of the scales bits and of ocr_img in
// _pack_outputs (:824), and the text mask ocr_img < OCR_BINARY_THRESHOLD
// (:833). The plain twin is smh_tpu_torch/ops/kernels.py::
// brq_preprocess_plain; every output byte equals it. Per pixel:
//
//   mono   = 2 (|r - g| + |r - b| + |g - b|), mn = min(r, g, b)
//   strict = mono <= MONO and mn >= BRIGHT; edge = mono <= EDGE_MONO and
//            mn >= EDGE_BRIGHT
//   near   = the box dilate of strict, cleared first at the columns
//            x > w - R and at the quadrant rows row0 + y > total_h - R (the
//            reference never looks there); nothing outside the planes is set
//   keep   = strict | (edge & near); ocr = keep ? 255 - luma : 255
//   text   = ocr < TEXT; sbool = luma != 0; the scales bits pack sbool MSB
//            first, pad bits zero
//   check  = sum and sum of (y + 1) (x + 7) v over the scales bit bytes and
//            over ocr, mod 2^32
//
// The planes are windows of the map's planes (rows `pitch` bytes apart):
// the quadrant is read in place, and the luma is kernel 1's, not
// recomputed. ocr and the scales bits go straight into the scalespack row
// (scales bits first, as scalespack_layout has them), so no copy joins them.
//
// What bounds it on an H100: not its bytes. It reads 4 and writes 3 1/8
// bytes per pixel (1.44 MB for the 411 x 493 quadrant of the 1080p map:
// 0.43 us at 3.35 TB/s; 5.77 MB, 1.72 us for 822 x 986 at 4K). The launch
// and each block's chain (the plane loads, the ballots, two barriers, the
// stores and the checksum atomics) cost more. The design keeps that chain
// short:
//
//  * a warp classifies 32 consecutive pixels of a row, a lane a pixel, and
//    ballots their strict (clipped), strict and edge bits into words: a
//    tile of TH + 2R staged word rows, WPR words wide; the R-pixel column
//    halo on each side of a staged row is one item of a thread each (8 a
//    row: R left, R right, the rest idle), balloted so that each row's
//    halo bits are one byte of the ballot, into a word each side (a first
//    design classified the neighbour words whole, with all but R lanes
//    idle: 17 items a warp against 11 and one);
//  * the box dilate runs on words: each staged row's word ORs its shifts
//    by 1 .. R with the neighbours' carry bits, then each output word ORs
//    the 2R + 1 rows around it;
//  * each output word is one warp again: a lane's keep bit, its luma
//    (loaded before the classify, under its latency), its ocr, text and
//    sbool bytes, the ballot of sbool into four MSB-first bytes, and the
//    checksums summed over the warp (__reduce_add_sync), the block, then
//    one atomicAdd per checksum and block into the frame's slots, which the
//    launcher zeroes first (u32 addition is order-free);
//  * 16 x 128 tiles, 8 warps: 104 blocks for the 1080p quadrant, 416 at 4K,
//    where at most 64 registers a thread keep 4 blocks on each SM, so they
//    all run at once (without the cap: 72 registers, 2 waves at 4K).
//
// A batch of B frames is one launch: blockIdx.z selects the frame, whose
// planes start `stride` (R, G, B), `lstride` (luma) bytes, and whose
// outputs `sstride` (scalespack) and `pstride` (text, sbool) bytes and 4
// u32s after the previous frame's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 3;                 // OCR_PREPROCESS_DILATE_RADIUS
constexpr int WPR = 4;               // output words per tile row
constexpr int TW = 32 * WPR;         // tile width, pixels
constexpr int TH = 16;               // tile height, rows
constexpr int SR = TH + 2 * R;       // staged rows: the tile and its row halo
constexpr int SW = WPR + 2;          // staged words a row: the tile's and its halo's, one each side
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = SR * WPR / WARPS;      // staged words a warp classifies
constexpr int OUT_ITEMS = TH * WPR / WARPS;  // output words a warp writes
constexpr int HALO_LANES = 8;                // a staged row's halo pixels: R left, R right, the rest idle
constexpr int HALO_THREADS = SR * HALO_LANES;
constexpr unsigned FULL = 0xffffffffu;
static_assert(R >= 1 && 2 * R <= HALO_LANES, "a row's column halo is one byte of a ballot");
static_assert(SR * WPR % WARPS == 0 && TH * WPR % WARPS == 0, "every warp takes the same number of words");
static_assert(SR * WPR <= THREADS && HALO_THREADS <= THREADS, "a thread a staged word in the dilate, a halo pixel");

struct Params {
  int mono, bright, edge_mono, edge_bright, text;
};

__global__ void __launch_bounds__(THREADS, 4)
    brq_preprocess_kernel(const uint8_t* __restrict__ r8, const uint8_t* __restrict__ g8,
                          const uint8_t* __restrict__ b8, int64_t pitch, int64_t stride,
                          const uint8_t* __restrict__ luma, int64_t lpitch, int64_t lstride,
                          uint8_t* __restrict__ spack, int64_t sstride, uint8_t* __restrict__ text,
                          uint8_t* __restrict__ sbool, int64_t pstride, uint32_t* __restrict__ check, int h,
                          int w, int clip_x, int clip_y, Params p) {
  __shared__ uint32_t clipped[SR][SW];  // strict, cleared past the clip
  __shared__ uint32_t strict[TH][WPR];
  __shared__ uint32_t edge[TH][WPR];
  __shared__ uint32_t hdil[SR][WPR];    // clipped, dilated along its row
  __shared__ uint32_t sums[4];

  const int64_t f = blockIdx.z;
  r8 += f * stride;
  g8 += f * stride;
  b8 += f * stride;
  luma += f * lstride;
  spack += f * sstride;
  text += f * pstride;
  sbool += f * pstride;
  check += 4 * f;
  const int bpr = (w + 7) >> 3;
  uint8_t* bits = spack;
  uint8_t* ocr = spack + (int64_t)h * bpr;

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid < 4) sums[tid] = 0u;

  // The luma of this warp's output pixels, first: its latency hides under
  // the classify's loads.
  uint32_t lum[OUT_ITEMS];
#pragma unroll
  for (int i = 0; i < OUT_ITEMS; ++i) {
    const int o = warp + WARPS * i;
    const int y = y0 + o / WPR;
    const int x = x0 + 32 * (o % WPR) + lane;
    lum[i] = (y < h && x < w) ? __ldg(luma + (int64_t)y * lpitch + x) : 0u;
  }

  // The staged words: staged row k / WPR (plane row y0 - R + k / WPR), word
  // k % WPR (pixels x0 + 32 (k % WPR) + lane); item ITEMS, on threads tid <
  // HALO_THREADS, halo pixel tid % 8 of staged row tid / 8.
  uint32_t rgb[ITEMS + 1];
  uint32_t in = 0;  // bit i: item i is a pixel of the plane this lane loaded
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int k = warp + WARPS * i;
    const int y = y0 - R + k / WPR;
    const int x = x0 + 32 * (k % WPR) + lane;
    in |= (uint32_t)(y >= 0 && y < h && x < w) << i;
    rgb[i] = 0u;
    if ((in >> i) & 1u) {
      const int64_t off = (int64_t)y * pitch + x;
      rgb[i] = __ldg(r8 + off) | (uint32_t)__ldg(g8 + off) << 8 | (uint32_t)__ldg(b8 + off) << 16;
    }
  }
  const int hq = tid % HALO_LANES;
  const int hy = y0 - R + tid / HALO_LANES;
  const int hx = hq < R ? x0 - R + hq : x0 + TW + hq - R;
  in |= (uint32_t)(tid < HALO_THREADS && hq < 2 * R && hy >= 0 && hy < h && hx >= 0 && hx < w) << ITEMS;
  rgb[ITEMS] = 0u;
  if ((in >> ITEMS) & 1u) {
    const int64_t off = (int64_t)hy * pitch + hx;
    rgb[ITEMS] = __ldg(r8 + off) | (uint32_t)__ldg(g8 + off) << 8 | (uint32_t)__ldg(b8 + off) << 16;
  }
  // strict and edge of item i, pixels outside the plane neither
  auto classify = [&](int i, bool& s, bool& e) {
    const int rr = rgb[i] & 0xff, gg = (rgb[i] >> 8) & 0xff, bb = rgb[i] >> 16;
    const int mono = 2 * (abs(rr - gg) + abs(rr - bb) + abs(gg - bb));
    const int mn = min(min(rr, gg), bb);
    const bool here = (in >> i) & 1u;
    s = here && mono <= p.mono && mn >= p.bright;
    e = here && mono <= p.edge_mono && mn >= p.edge_bright;
  };
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int k = warp + WARPS * i;
    const int r = k / WPR, j = k % WPR;
    const int y = y0 - R + r;
    bool s, e;
    classify(i, s, e);
    const unsigned cw = __ballot_sync(FULL, s && x0 + 32 * j + lane <= clip_x && y <= clip_y);
    if (lane == 0) clipped[r][j + 1] = cw;
    if (r >= R && r < R + TH) {  // warp-uniform: an output word
      const unsigned sw = __ballot_sync(FULL, s);
      const unsigned ew = __ballot_sync(FULL, e);
      if (lane == 0) {
        strict[r - R][j] = sw;
        edge[r - R][j] = ew;
      }
    }
  }
  if (warp < (HALO_THREADS + 31) / 32) {  // byte b of the ballot: staged row 4 warp + b's halo
    bool s, e;
    classify(ITEMS, s, e);
    const unsigned hb = __ballot_sync(FULL, s && hx <= clip_x && hy <= clip_y);
    const int r = 4 * warp + lane;
    if (lane < 4 && r < SR) {
      const uint32_t byte = (hb >> (HALO_LANES * lane)) & 0xffu;
      clipped[r][0] = (byte & ((1u << R) - 1u)) << (32 - R);  // pixels x0 - R .. x0 - 1
      clipped[r][SW - 1] = (byte >> R) & ((1u << R) - 1u);    // pixels x0 + TW .. x0 + TW + R - 1
    }
  }
  __syncthreads();

  // The dilate along the rows: bit i of word j is pixel x0 + 32 j + i.
  if (tid < SR * WPR) {
    const int r = tid / WPR, j = tid % WPR;
    const uint32_t c = clipped[r][j + 1], left = clipped[r][j], right = clipped[r][j + 2];
    uint32_t d = c;
#pragma unroll
    for (int s = 1; s <= R; ++s) d |= (c << s) | (left >> (32 - s)) | (c >> s) | (right << (32 - s));
    hdil[r][j] = d;
  }
  __syncthreads();

  // The outputs, a warp a word; the checksums' partial sums.
  uint32_t sum_b = 0u, wsum_b = 0u, sum_o = 0u, wsum_o = 0u;
#pragma unroll
  for (int i = 0; i < OUT_ITEMS; ++i) {
    const int o = warp + WARPS * i;
    const int r = o / WPR, j = o % WPR;
    const int y = y0 + r;
    const int xw = x0 + 32 * j;
    if (y >= h || xw >= w) continue;  // warp-uniform
    uint32_t near = 0u;
#pragma unroll
    for (int d = 0; d <= 2 * R; ++d) near |= hdil[r + d][j];
    const uint32_t keep = strict[r][j] | (edge[r][j] & near);
    const int x = xw + lane;
    const bool inside = x < w;
    const uint32_t v = ((keep >> lane) & 1u) ? 255u - lum[i] : 255u;
    const bool sb = lum[i] != 0u;
    if (inside) {
      const int64_t at = (int64_t)y * w + x;
      ocr[at] = (uint8_t)v;
      text[at] = (uint8_t)(v < (uint32_t)p.text);
      sbool[at] = (uint8_t)sb;
      sum_o += v;
      wsum_o += v * (uint32_t)(y + 1) * (uint32_t)(x + 7);
    }
    const uint32_t word = __ballot_sync(FULL, inside && sb);
    const uint32_t msb = __byte_perm(__brev(word), 0, 0x0123);  // byte 0 = pixels 0..7, MSB first
    const int col = (xw >> 3) + lane;
    if (lane < 4 && col < bpr) {
      const uint32_t byte = (msb >> (8 * lane)) & 0xffu;
      bits[(int64_t)y * bpr + col] = (uint8_t)byte;
      sum_b += byte;
      wsum_b += byte * (uint32_t)(y + 1) * (uint32_t)(col + 7);
    }
  }
  sum_b = __reduce_add_sync(FULL, sum_b);
  wsum_b = __reduce_add_sync(FULL, wsum_b);
  sum_o = __reduce_add_sync(FULL, sum_o);
  wsum_o = __reduce_add_sync(FULL, wsum_o);
  if (lane == 0) {
    atomicAdd(&sums[0], sum_b);
    atomicAdd(&sums[1], wsum_b);
    atomicAdd(&sums[2], sum_o);
    atomicAdd(&sums[3], wsum_o);
  }
  __syncthreads();
  if (tid < 4) atomicAdd(check + tid, sums[tid]);
}

}  // namespace

// B frames: frame f's quadrant planes, h x w bytes with rows `pitch`
// (`lpitch` for luma) bytes apart, start at r8/g8/b8 + f * stride and luma +
// f * lstride; its outputs at spack + f * sstride (the scales bits, h x
// (w + 7) / 8, then ocr, h x w), text / sbool + f * pstride (h x w) and
// check + 4 f (u32 [4], zeroed here first). The planes are rows row0 ..
// row0 + h of a quadrant total_h rows high.
extern "C" int smh_brq_preprocess(const void* r8, const void* g8, const void* b8, int64_t pitch, int64_t stride,
                                  const void* luma, int64_t lpitch, int64_t lstride, void* spack, int64_t sstride,
                                  void* text, void* sbool, int64_t pstride, void* check, int h, int w, int B,
                                  int row0, int total_h, int mono, int bright, int edge_mono, int edge_bright,
                                  int text_threshold, void* stream) {
  if (h <= 0 || w <= 0 || B <= 0 || B > 65535 || pitch < w || lpitch < w || row0 < 0 || row0 + h > total_h ||
      (h + TH - 1) / TH > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(check, 0, (size_t)B * 4 * sizeof(uint32_t), s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, B);
  brq_preprocess_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const uint8_t*>(r8), static_cast<const uint8_t*>(g8), static_cast<const uint8_t*>(b8), pitch,
      stride, static_cast<const uint8_t*>(luma), lpitch, lstride, static_cast<uint8_t*>(spack), sstride,
      static_cast<uint8_t*>(text), static_cast<uint8_t*>(sbool), pstride, static_cast<uint32_t*>(check), h, w,
      w - R, total_h - R - row0, Params{mono, bright, edge_mono, edge_bright, text_threshold});
  return (int)cudaGetLastError();
}
