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
//   mono   = 2 (|r - g| + |r - b| + |g - b|) = 4 (max - min), mn = min(r, g, b)
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
// (~0.95 us) and each block's chain (the plane loads, the bit words, two
// barriers, the stores, the checksum atomic) cost more, and at 4K and for a
// batch the loads' and stores' issue (PERF.md splits the time by
// ablation). Its first design (a lane a pixel, every plane byte its own
// load, one-byte stores, a memset of the checks before every launch) took
// 7.39-7.43 us (+0.78 the memset) at 411 x 493, 13.42-13.49 at 822 x 986
// and 21.67-22.11 for 8 quadrants of 411 x 493 on an H100 (PERF.md). This
// design:
//
//  * a lane takes a quad, 4 consecutive pixels of a row, and reads each
//    plane as the aligned 32-bit words that hold them, shifted into place
//    with __funnelshift_r (the shift is the same for every quad of a row,
//    so no warp diverges on it): 2 loads a plane where the first design
//    took 4 (the luma) to 12 (R, G, B);
//  * a warp classifies the 32 quads of a staged row (mono by max - min) and
//    ORs their nibbles over groups of 8 lanes into the row's four bit words
//    (three __shfl_xor_sync a word); the R-pixel column halo each side is
//    one quad of a thread of the last warps (the others classify one staged
//    row more); the box dilate runs on the words as before;
//  * a tile is 124 pixels wide, the quads of lanes 1 .. 31, and lane 0
//    holds the 4 pixels before it, so every lane but 0 can store the
//    aligned word that ends in its quad: its bytes before the quad come
//    from the lane below (__shfl_up_sync, __funnelshift_l by the output
//    row's misalignment). ocr, text and sbool go out one aligned 4-byte
//    store a lane; only words past either end of a row take bytes. Each
//    tile owns the pixels [x0 - s, x0 + 124 - s) of a row of an output
//    misaligned by s, and its checksums count the pixels [x0, x0 + 124);
//  * the checksums are summed over the warp (__dp4a over a quad's bytes),
//    the block, then added into the frame's four u64 slots of a scratch
//    that every launch leaves zeroed: one atomicAdd a checksum and block
//    adds 2^48 + the block's u32 partial, so the top 16 bits count the
//    blocks in, and the thread whose add finds every other block's there
//    writes the low 32 bits (the u32 sum, order-free) to `check` and
//    zeroes the slot. One round trip a block, no fence and no ticket; no
//    memset before the launch and no per-call argument: each slot is back
//    to zero at the end of every launch (a first cut of this design used
//    a ticket and an atomicExch: ~0.7-1 us more on an H100);
//  * 16 x 124 tiles of 8 warps: 416 blocks for the 4K quadrant; where
//    16-row tiles would not give every SM a block (the 1080p quadrant: 104
//    of 132), 8-row tiles, 208 blocks, each warp one output row and about
//    two staged rows: a shorter chain a warp, the halo read more often
//    (measured on an H100: 4.72 against 5.63 us at 411 x 493, 9.64 against
//    8.47 at 822 x 986). No register cap (a cap of 64 measured slower).
//
// A batch of B frames is one launch: blockIdx.z selects the frame, whose
// planes start `stride` (R, G, B), `lstride` (luma) bytes, and whose
// outputs `sstride` (scalespack) and `pstride` (text, sbool) bytes, 4 u32s
// (check) and SCRATCH u32s (scratch) after the previous frame's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 3;                 // OCR_PREPROCESS_DILATE_RADIUS
constexpr int QUADS = 32;            // quads of a staged row: a warp, a quad a lane
constexpr int TW = 4 * (QUADS - 1);  // tile width, pixels: lanes 1 .. 31 (lane 0 holds the 4 before)
constexpr int TH = 16;               // tile height, rows
constexpr int TH_SMALL = 8;          // where TH-row tiles would leave SMs idle
constexpr int WPR = QUADS / 8;       // bit words of a staged row, 8 quads a word
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SCRATCH = 8;           // u32 a frame: the four sums' u64 slots
constexpr int COUNT_SHIFT = 48;      // a slot: the blocks added (16 bits), their u32 partials' sum
constexpr unsigned FULL = 0xffffffffu;
static_assert(R >= 1 && R <= 4, "the column halo is one quad each side");

struct Params {
  int mono, bright, edge_mono, edge_bright, text;
};

// Pixels x .. x + 3 (x a multiple of 4) of a plane row as a little-endian
// word, pixels outside [0, w) zero: the aligned words that hold a byte of
// the quad's pixels inside the row, shifted into place.
__device__ __forceinline__ uint32_t load_quad(const uint8_t* __restrict__ row, int x, int w) {
  if (x < 0 || x >= w) return 0u;
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + x);
  const uint32_t* al = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const int sh = (int)(a & 3);
  const int n = min(w - x, 4);  // pixels of the quad inside the row
  const uint32_t lo = __ldg(al);
  const uint32_t hi = (sh != 0 && 4 - sh < n) ? __ldg(al + 1) : 0u;
  const uint32_t v = __funnelshift_r(lo, hi, 8 * sh);
  return n == 4 ? v : v & ((1u << (8 * n)) - 1u);
}

// strict and edge of a quad's 4 pixels (bit i: pixel i); zero pixels are
// neither (BRIGHT and EDGE_BRIGHT are positive).
__device__ __forceinline__ void classify_quad(uint32_t r, uint32_t g, uint32_t b, const Params& p, uint32_t& s,
                                              uint32_t& e) {
  s = 0u;
  e = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = (r >> (8 * i)) & 0xff, gg = (g >> (8 * i)) & 0xff, bb = (b >> (8 * i)) & 0xff;
    const int mn = min(min(rr, gg), bb);
    const int mono = 4 * (max(max(rr, gg), bb) - mn);
    s |= (uint32_t)(mono <= p.mono && mn >= p.bright) << i;
    e |= (uint32_t)(mono <= p.edge_mono && mn >= p.edge_bright) << i;
  }
}

// Bits i of the quad at x that lie at columns <= clip_x.
__device__ __forceinline__ uint32_t clip_bits(int x, int clip_x) {
  const int n = clip_x - x + 1;
  return n <= 0 ? 0u : (n >= 4 ? 0xfu : (1u << n) - 1u);
}

// The bit word of this lane's group of 8 lanes (bit 4 (lane % 8) + i: pixel
// i of that lane's quad), in every lane of the group.
__device__ __forceinline__ uint32_t group_word(uint32_t nibble, int lane) {
  uint32_t v = nibble << (4 * (lane & 7));
  v |= __shfl_xor_sync(FULL, v, 1);
  v |= __shfl_xor_sync(FULL, v, 2);
  v |= __shfl_xor_sync(FULL, v, 4);
  return v;
}

// One output row's share of this lane: `cur` holds pixels x .. x + 3. Every
// lane but 0 stores the aligned word whose last byte is pixel x + 3 - s (s:
// the row's misalignment), its first s bytes the top of the lane below's
// quad; bytes of pixels outside [0, w) are not stored. All lanes call it.
__device__ __forceinline__ void store_quad(uint8_t* row, int x, int w, uint32_t cur, int lane) {
  const uint32_t prev = __shfl_up_sync(FULL, cur, 1);
  if (lane == 0) return;
  const int s = (int)(reinterpret_cast<uintptr_t>(row) & 3);
  const uint32_t word = __funnelshift_l(prev, cur, 8 * s);
  const int p0 = x - s;  // the pixel of the word's byte 0
  uint8_t* at = row + p0;
  if (p0 >= 0 && p0 + 4 <= w) {
    *reinterpret_cast<uint32_t*>(at) = word;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (p0 + k >= 0 && p0 + k < w) at[k] = (uint8_t)(word >> (8 * k));
}

template <int ROWS>  // the tile's height: TH or TH_SMALL
__global__ void __launch_bounds__(THREADS)
    brq_preprocess_kernel(const uint8_t* __restrict__ r8, const uint8_t* __restrict__ g8,
                          const uint8_t* __restrict__ b8, int64_t pitch, int64_t stride,
                          const uint8_t* __restrict__ luma, int64_t lpitch, int64_t lstride,
                          uint8_t* __restrict__ spack, int64_t sstride, uint8_t* __restrict__ text,
                          uint8_t* __restrict__ sbool, int64_t pstride, uint32_t* __restrict__ check,
                          uint32_t* __restrict__ scratch, int h, int w, int clip_x, int clip_y, Params p) {
  constexpr int SR = ROWS + 2 * R;                         // staged rows: the tile and its row halo
  constexpr int IN_ITEMS = (SR + WARPS - 1) / WARPS;       // staged rows a warp classifies, at most
  constexpr int OUT_ITEMS = ROWS / WARPS;                  // output rows a warp writes
  constexpr int HALO_THREADS = 2 * SR;                     // a staged row's halo quads, left and right
  constexpr int HALO_WARPS = (HALO_THREADS + 31) / 32;
  constexpr int HALO_FIRST = (WARPS - HALO_WARPS) * 32;    // the last warps take them: they classify a row fewer
  static_assert(ROWS % WARPS == 0, "every warp writes the same number of rows");
  static_assert(SR - WARPS * (IN_ITEMS - 1) <= WARPS - HALO_WARPS, "the halo warps classify a staged row fewer");
  static_assert(SR * WPR <= THREADS, "a thread a staged word in the dilate");
  __shared__ uint32_t clipped[SR][WPR + 2];  // strict, cleared past the clip; words 0 and WPR + 1: the halo
  __shared__ uint32_t strict[ROWS][WPR];
  __shared__ uint32_t edge[ROWS][WPR];
  __shared__ uint32_t hdil[SR][WPR];  // clipped, dilated along its row
  __shared__ uint32_t part[WARPS][4];

  const int64_t f = blockIdx.z;
  r8 += f * stride;
  g8 += f * stride;
  b8 += f * stride;
  luma += f * lstride;
  spack += f * sstride;
  text += f * pstride;
  sbool += f * pstride;
  check += 4 * f;
  scratch += SCRATCH * f;
  const int bpr = (w + 7) >> 3;
  uint8_t* bits = spack;
  uint8_t* ocr = spack + (int64_t)h * bpr;

  const int x0 = blockIdx.x * TW;  // the tile's first own pixel
  const int X = x0 - 4;            // lane 0's quad: the staged words' pixel 0
  const int y0 = blockIdx.y * ROWS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int xq = X + 4 * lane;  // this lane's quad

  // Every load first: the staged rows' quads, the halo quad, and the luma
  // of the output rows.
  uint32_t rgb[IN_ITEMS][3];
#pragma unroll
  for (int i = 0; i < IN_ITEMS; ++i) {
    const int y = y0 - R + warp + WARPS * i;
    const bool in = warp + WARPS * i < SR && y >= 0 && y < h;  // warp-uniform
    const int64_t off = (int64_t)y * pitch;
    rgb[i][0] = in ? load_quad(r8 + off, xq, w) : 0u;
    rgb[i][1] = in ? load_quad(g8 + off, xq, w) : 0u;
    rgb[i][2] = in ? load_quad(b8 + off, xq, w) : 0u;
  }
  const int ht = tid - HALO_FIRST;  // halo quad ht: staged row ht / 2, left (even) or right (odd)
  const bool halo = ht >= 0 && ht < HALO_THREADS;
  const int hy = y0 - R + (ht >> 1);
  const int hx = (ht & 1) ? X + 4 * QUADS : X - 4;
  uint32_t hrgb[3] = {0u, 0u, 0u};
  if (halo && hy >= 0 && hy < h) {
    const int64_t off = (int64_t)hy * pitch;
    hrgb[0] = load_quad(r8 + off, hx, w);
    hrgb[1] = load_quad(g8 + off, hx, w);
    hrgb[2] = load_quad(b8 + off, hx, w);
  }
  uint32_t lum[OUT_ITEMS];
#pragma unroll
  for (int i = 0; i < OUT_ITEMS; ++i) {
    const int y = y0 + warp + WARPS * i;
    lum[i] = y < h ? load_quad(luma + (int64_t)y * lpitch, xq, w) : 0u;
  }

  // The staged rows' words: bit 32 j + i of a row is pixel X + 32 j + i.
#pragma unroll
  for (int i = 0; i < IN_ITEMS; ++i) {
    const int r = warp + WARPS * i;
    if (r >= SR) break;  // warp-uniform
    const int y = y0 - R + r;
    uint32_t s, e;
    classify_quad(rgb[i][0], rgb[i][1], rgb[i][2], p, s, e);
    const uint32_t cw = group_word(y <= clip_y ? s & clip_bits(xq, clip_x) : 0u, lane);
    if ((lane & 7) == 0) clipped[r][1 + (lane >> 3)] = cw;
    if (r >= R && r < R + ROWS) {  // warp-uniform: an output row
      const uint32_t sw = group_word(s, lane), ew = group_word(e, lane);
      if ((lane & 7) == 0) {
        strict[r - R][lane >> 3] = sw;
        edge[r - R][lane >> 3] = ew;
      }
    }
  }
  if (halo) {
    uint32_t s, e;
    classify_quad(hrgb[0], hrgb[1], hrgb[2], p, s, e);
    const uint32_t c = hy <= clip_y ? s & clip_bits(hx, clip_x) : 0u;
    if (ht & 1)
      clipped[ht >> 1][WPR + 1] = c & ((1u << R) - 1u);  // pixels X + 128 .. X + 127 + R
    else
      clipped[ht >> 1][0] = (c >> (4 - R)) << (32 - R);  // pixels X - R .. X - 1
  }
  __syncthreads();

  // The dilate along the rows, with the neighbour words' carry bits.
  if (tid < SR * WPR) {
    const int r = tid / WPR, j = tid % WPR;
    const uint32_t c = clipped[r][j + 1], left = clipped[r][j], right = clipped[r][j + 2];
    uint32_t d = c;
#pragma unroll
    for (int s = 1; s <= R; ++s) d |= (c << s) | (left >> (32 - s)) | (c >> s) | (right << (32 - s));
    hdil[r][j] = d;
  }
  __syncthreads();

  // The outputs, a warp an output row; the checksums' partial sums.
  const uint32_t text4 = (uint32_t)p.text * 0x01010101u;
  uint32_t sum_b = 0u, wsum_b = 0u, sum_o = 0u, wsum_o = 0u;
#pragma unroll
  for (int i = 0; i < OUT_ITEMS; ++i) {
    const int o = warp + WARPS * i;
    const int y = y0 + o;
    if (y >= h) break;  // warp-uniform
    const int j = lane >> 3;
    uint32_t near = 0u;
#pragma unroll
    for (int d = 0; d <= 2 * R; ++d) near |= hdil[o + d][j];
    const uint32_t keep = ((strict[o][j] | (edge[o][j] & near)) >> (4 * (lane & 7))) & 0xfu;
    const uint32_t l = lum[i];                                            // zero outside [0, w)
    const uint32_t m = ((keep * 0x00204081u) & 0x01010101u) * 0xffu;  // 0xff at the kept pixels
    const uint32_t v = ~(l & m);                                          // 255 - luma or 255
    const uint32_t t = __vcmpltu4(v, text4) & 0x01010101u;
    const uint32_t sb = __vcmpne4(l, 0u) & 0x01010101u;
    const int64_t at = (int64_t)y * w;
    store_quad(ocr + at, xq, w, v, lane);
    store_quad(text + at, xq, w, t, lane);
    store_quad(sbool + at, xq, w, sb, lane);
    if (lane > 0 && xq < w) {  // the tile's own pixels
      const int n = min(w - xq, 4);
      const uint32_t vv = n == 4 ? v : v & ((1u << (8 * n)) - 1u);
      const uint32_t s1 = __dp4a(vv, 0x01010101u, 0u), s2 = __dp4a(vv, 0x03020100u, 0u);
      sum_o += s1;
      wsum_o += (uint32_t)(y + 1) * ((uint32_t)(xq + 7) * s1 + s2);
    }
    // A scales bit byte: 8 pixels from a lane whose quad starts at a multiple
    // of 8 and the lane above; the byte is this tile's if the lane above is
    // (lane 31's quad is the next tile's lane 0; past the last tile, the
    // pixels above lane 31 lie past w).
    const uint32_t nib = (sb * 0x01020408u) >> 24;  // bit i: pixel xq + i
    const uint32_t next = __shfl_down_sync(FULL, nib, 1);
    const uint32_t up = lane < 31 ? next : 0u;
    if ((lane < 31 || blockIdx.x == gridDim.x - 1) && (xq & 7) == 0 && xq >= 0 && xq < w) {
      const uint32_t byte = __brev(nib | up << 4) >> 24;  // MSB first
      const int col = xq >> 3;
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
    part[warp][0] = sum_b;
    part[warp][1] = wsum_b;
    part[warp][2] = sum_o;
    part[warp][3] = wsum_o;
  }
  __syncthreads();
  if (tid < 4) {  // checksum tid: the block's partial into the frame's slot
    uint32_t v = 0u;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) v += part[k][tid];
    unsigned long long* slot = reinterpret_cast<unsigned long long*>(scratch) + tid;
    const unsigned long long old = atomicAdd(slot, (1ull << COUNT_SHIFT) | v);
    if ((old >> COUNT_SHIFT) == gridDim.x * gridDim.y - 1) {  // every other block's partial is in
      check[tid] = (uint32_t)(old + v);                       // the low 32 bits: the u32 sum
      *slot = 0ull;
    }
  }
}

}  // namespace

// B frames: frame f's quadrant planes, h x w bytes with rows `pitch`
// (`lpitch` for luma) bytes apart, start at r8/g8/b8 + f * stride and luma +
// f * lstride; its outputs at spack + f * sstride (the scales bits, h x
// (w + 7) / 8, then ocr, h x w), text / sbool + f * pstride (h x w) and
// check + 4 f (u32 [4]). scratch: SCRATCH B u32s, all zero, used by no
// launch that may run at the same time (the wrapper keeps one per device
// and stream); every launch leaves it zero. The planes are rows row0 .. row0 + h of a
// quadrant total_h rows high.
extern "C" int smh_brq_preprocess(const void* r8, const void* g8, const void* b8, int64_t pitch, int64_t stride,
                                  const void* luma, int64_t lpitch, int64_t lstride, void* spack, int64_t sstride,
                                  void* text, void* sbool, int64_t pstride, void* check, void* scratch, int h, int w,
                                  int B, int row0, int total_h, int mono, int bright, int edge_mono, int edge_bright,
                                  int text_threshold, void* stream) {
  const int64_t cols = (w + 3 + TW - 1) / TW;  // tiles own [x0 - s, x0 + TW - s): w + 3 pixels
  const int64_t rows = (h + TH_SMALL - 1) / TH_SMALL;
  if (h <= 0 || w <= 0 || B <= 0 || B > 65535 || pitch < w || lpitch < w || row0 < 0 || row0 + h > total_h ||
      rows > 65535 || cols * rows >= (1 << (64 - COUNT_SHIFT)) || bright < 1 || edge_bright < 1 ||
      text_threshold < 0 || text_threshold > 255)
    return (int)cudaErrorInvalidValue;
  // TH-row tiles where they fill the card; TH_SMALL-row tiles (twice the
  // blocks, a shorter chain a warp) where they would leave SMs idle.
  static int sm_counts[64];  // the SM count of each device, read once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int n_sm = dev < 64 ? sm_counts[dev] : 0;
  if (n_sm == 0) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) sm_counts[dev] = n_sm;
  }
  const bool small = cols * ((h + TH - 1) / TH) * B <= n_sm;
  const dim3 grid((unsigned)cols, (unsigned)(small ? rows : (h + TH - 1) / TH), B);
  auto kernel = small ? brq_preprocess_kernel<TH_SMALL> : brq_preprocess_kernel<TH>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(r8), static_cast<const uint8_t*>(g8), static_cast<const uint8_t*>(b8), pitch,
      stride, static_cast<const uint8_t*>(luma), lpitch, lstride, static_cast<uint8_t*>(spack), sstride,
      static_cast<uint8_t*>(text), static_cast<uint8_t*>(sbool), pstride, static_cast<uint32_t*>(check),
      static_cast<uint32_t*>(scratch), h, w, w - R, total_h - R - row0,
      Params{mono, bright, edge_mono, edge_bright, text_threshold});
  return (int)cudaGetLastError();
}
