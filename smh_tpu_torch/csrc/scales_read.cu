// The on-device scales read: text-row bands, glyph column runs, glyph
// classification against the templates, word grouping, and the scale-bar
// scan, into the fixed i16 record vector. One launch per call, one block
// per frame.
//
// Replaces smh_tpu/ops/scales_device.py::scales_records (:237; XLA ops, not
// a Pallas kernel): its band runs and vmap over bands (:273), the glyph
// windows and their resample (_classify_windows, :188), the word grouping
// lax.scan (:295) and the bar scan vmapped over word slots (:415), and the
// vmap over the frames of a batch (smh_tpu/ops/pipeline.py:1220). The
// plain twin is smh_tpu_torch/ops/scales_device.py::scales_records_plain;
// every lane of the record equals it, except the glyph scores (x1000),
// which may differ by 1: the 192-term sums and the template dots are the
// only sums taken in another order. Every other float operation rounds
// once as the plain version's does (__f*_rn intrinsics: no FMA
// contraction; __fsqrt_rn), in its order: the resample coordinate is
// (gy0 + (i + 0.5) * (h / 16)) - 0.5, each bilinear term (wv * wu) * val,
// summed corner by corner in map_coordinates' order. C division is used
// only on non-negative values, where it is torch's floor division.
//
// The phases of a block, each ended by a barrier:
//
//  0. templates into shared memory; the row and column bit sets cleared;
//  1. text's row bit set: every thread reads 16-byte aligned chunks of the
//     frame and marks the rows of nonzero bytes (the only pass over the
//     whole plane); warp 0 finds the first MAX_BANDS row runs and their
//     count (warp_runs: popcounts, a warp scan, then each lane extracts its
//     own runs);
//  2. per band, the same over the band's first min(height, WIN_H) rows into
//     a column bit set; warp b finds band b's first MAX_GPB column runs;
//  3. one warp per glyph slot: the WIN_H x WIN_W window as 64-bit row
//     words in shared memory (ballots), its row extent, pixel count and
//     gate, then for a glyph that passes the gate the 16 x 12 bilinear
//     resample (6 pixels a lane), mean removal, L2 normalisation, the dot
//     with each template (warp sums) and the argmax (first index on ties);
//  4. one thread per band: the word grouping (the scan's carries, slot by
//     slot) and the scatter into word slots with the MAX_WG cap and the
//     truncation flag;
//  5. one warp per word slot: the bar scan over scan_budget(W) rows below
//     the word, each row's right and left walks as ballots over 32 columns
//     at a time, stopping at the first row that holds a bar;
//  6. the record, one lane a thread.
//
// What bounds it: the bytes a call must move are the two planes once, the
// templates and the record (2 * H * W + T * 768 + 1,168 B per frame: 0.49
// us at 3.35 TB/s for the 822 x 986 BRQ of 4K), but one block reads its
// frame at one SM's rate, and the phases are a chain of dependent steps
// (runs, windows, words, bar rows), each a few L2 round trips: latency,
// not bytes, bounds it. A batch takes one block per frame, so B frames cost
// about what one does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The record layout and capacities of ops/scales_device.py.
constexpr int GLYPH_W = 12;
constexpr int GLYPH_H = 16;
constexpr int GLYPH_PX = GLYPH_H * GLYPH_W;
constexpr int MAX_BANDS = 6;
constexpr int MAX_GPB = 16;
constexpr int MAX_WPB = 4;
constexpr int MAX_WG = 6;
constexpr int WIN_H = 64;
constexpr int WIN_W = 48;
constexpr int MIN_GLYPH_PX = 8;
constexpr int MIN_GLYPH_H = 5;
constexpr int MAX_GLYPH_H = 48;
constexpr int MIN_SCALE_WIDTH = 10;
constexpr int BAR_H = 4;
constexpr int HDR_I16 = 8;
constexpr int FLAG_BAND_OVERFLOW = 1;
constexpr int WORD_I16 = 24;
constexpr int N_WORDS = MAX_BANDS * MAX_WPB;
constexpr int REC_I16 = HDR_I16 + N_WORDS * WORD_I16;
constexpr int N_SLOTS = MAX_BANDS * MAX_GPB;
constexpr int BIG = 1 << 14;  // the fill of an empty word's min-box, and the score clamp

// Capacities of the kernel's shared memory (the wrapper checks both).
constexpr int MAX_TEMPLATES = 32;
constexpr int MAX_DIM = 4096;  // rows and columns of a plane
constexpr int DIM_WORDS = MAX_DIM / 32;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int PX_PER_LANE = GLYPH_PX / 32;  // 6
static_assert(GLYPH_PX % 32 == 0, "a lane takes whole resample pixels");
static_assert(WIN_W <= 64 && WIN_H == 64, "a window row is one 64-bit word, its rows two per lane");

struct Shared {
  float tpl[MAX_TEMPLATES * GLYPH_PX];
  uint32_t rowbits[DIM_WORDS];
  uint32_t colbits[MAX_BANDS][DIM_WORDS];
  uint64_t win[WARPS][WIN_H];
  int n_bands;
  int b_start[MAX_BANDS], b_end[MAX_BANDS];
  int n_g[MAX_BANDS];
  int g_start[MAX_BANDS][MAX_GPB], g_end[MAX_BANDS][MAX_GPB];
  int band_bad[MAX_BANDS];
  // per glyph slot
  int gy0[N_SLOTS], gy1[N_SLOTS], ok[N_SLOTS], chr[N_SLOTS], score[N_SLOTS];
  // per word slot
  int w_n[N_WORDS], w_x0[N_WORDS], w_y0[N_WORDS], w_x1[N_WORDS], w_y1[N_WORDS], w_trunc[N_WORDS];
  int w_chars[N_WORDS][MAX_WG], w_scores[N_WORDS][MAX_WG];
  int bar_found[N_WORDS], bar_y[N_WORDS], bar_l[N_WORDS], bar_r[N_WORDS];
};

__device__ __forceinline__ void set_bit(uint32_t* bits, int i) {
  const uint32_t m = 1u << (i & 31);
  if (!(bits[i >> 5] & m)) atomicOr(&bits[i >> 5], m);  // a stale read only costs an atomic
}

// Marks, for each nonzero byte at offset o of a chunk, the row o / w.
struct MarkRows {
  uint32_t* bits;
  int w;
  // m: bit j set iff byte base + j (j < 16) is nonzero.
  __device__ void operator()(int64_t base, uint32_t m) const {
    int64_t r = base / w;
    int c = (int)(base - r * w);
    int j = 0;
    while (m) {
      const int take = min(16 - j, w - c);  // bytes j .. j + take - 1 lie in row r
      const uint32_t seg = ((1u << take) - 1u) << j;
      if (m & seg) set_bit(bits, (int)r);
      m &= ~seg;
      j += take;
      ++r;
      c = 0;
    }
  }
};

// Marks, for each nonzero byte at offset o of a chunk, the column o % w.
struct MarkCols {
  uint32_t* bits;
  int w;
  __device__ void operator()(int64_t base, uint32_t m) const {
    const int c0 = (int)(base % w);
    while (m) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      int c = c0 + j;
      while (c >= w) c -= w;
      set_bit(bits, c);
    }
  }
};

__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t v) {
  // bit k of the result: byte k of v is nonzero (k < 4)
  const uint32_t t = ((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v;
  const uint32_t hi = t & 0x80808080u;
  return ((hi >> 7) & 1u) | ((hi >> 14) & 2u) | ((hi >> 21) & 4u) | ((hi >> 28) & 8u);
}

// The block's threads visit the nonzero bytes of p[0, n) (p[o] for offsets
// relative to p), calling f(offset of a 16-byte chunk, its nonzero-byte
// bits): 16-byte aligned loads, four in flight per thread; the unaligned
// head and tail bytewise.
template <class F>
__device__ void for_nonzero(const uint8_t* __restrict__ p, int64_t n, const F& f) {
  if (n <= 0) return;
  int64_t head = (int64_t)((16u - (uint32_t)(reinterpret_cast<uintptr_t>(p) & 15u)) & 15u);
  if (head > n) head = n;
  const int64_t nvec = (n - head) / 16;
  const int64_t tail = head + nvec * 16;
  for (int64_t i = threadIdx.x; i < head; i += blockDim.x)
    if (p[i]) f(i, 1u);
  for (int64_t i = tail + threadIdx.x; i < n; i += blockDim.x)
    if (p[i]) f(i, 1u);
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  constexpr int U = 4;
  for (int64_t k0 = threadIdx.x; k0 < nvec; k0 += U * (int64_t)blockDim.x) {
    uint4 q[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t k = k0 + u * (int64_t)blockDim.x;
      q[u] = k < nvec ? __ldg(v + k) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if ((q[u].x | q[u].y | q[u].z | q[u].w) == 0u) continue;
      const uint32_t m = nonzero_bytes(q[u].x) | (nonzero_bytes(q[u].y) << 4) | (nonzero_bytes(q[u].z) << 8) |
                         (nonzero_bytes(q[u].w) << 12);
      f(head + 16 * (k0 + u * (int64_t)blockDim.x), m);
    }
  }
}

// One warp: the first max_runs runs of set bits among bits [0, n) (bit i in
// word i / 32, bits past n clear) as starts and exclusive ends, and their
// count; slots past the count get start n, end n + 1 (ops/scales_device.py
// _runs). Lane l takes a contiguous stretch of words; a warp scan of the
// start and end counts gives each lane the rank of its first run.
__device__ void warp_runs(const uint32_t* bits, int n, int max_runs, int* starts, int* ends, int* count) {
  const int lane = threadIdx.x & 31;
  const int nw = (n + 31) >> 5;
  const int per = (nw + 31) >> 5;
  const int w0 = min(lane * per, nw), w1 = min(w0 + per, nw);
  auto start_word = [&](int i) {
    const uint32_t b = bits[i];
    return b & ~((b << 1) | (i > 0 ? bits[i - 1] >> 31 : 0u));
  };
  auto end_word = [&](int i) {
    const uint32_t b = bits[i];
    return b & ~((b >> 1) | (i + 1 < nw ? bits[i + 1] << 31 : 0u));
  };
  int ns = 0, ne = 0;
  for (int i = w0; i < w1; ++i) {
    ns += __popc(start_word(i));
    ne += __popc(end_word(i));
  }
  int is = ns, ie = ne;  // inclusive scans
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int ts = __shfl_up_sync(FULL, is, d), te = __shfl_up_sync(FULL, ie, d);
    if (lane >= d) {
      is += ts;
      ie += te;
    }
  }
  const int total = __shfl_sync(FULL, is, 31);
  int rs = is - ns, re = ie - ne;
  for (int i = w0; i < w1 && (rs < max_runs || re < max_runs); ++i) {
    uint32_t s = start_word(i), e = end_word(i);
    for (; s && rs < max_runs; s &= s - 1) starts[rs++] = 32 * i + __ffs(s) - 1;
    for (; e && re < max_runs; e &= e - 1) ends[re++] = 32 * i + __ffs(e);
  }
  if (lane == 0) {
    for (int r = total; r < max_runs; ++r) {
      starts[r] = n;
      ends[r] = n + 1;
    }
    *count = total;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  // Butterfly: every lane adds the same two values at each level (in either
  // order, which is the same f32 sum), so all lanes end with one value.
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = __fadd_rn(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

// The band's rows and glyph slot j's column run, clamped as in _runs' use.
struct Band {
  int by0, bh_full, valid;
};

__device__ __forceinline__ Band band_of(const Shared& s, int b, int h) {
  Band r;
  r.by0 = min(s.b_start[b], h);
  r.bh_full = max(min(s.b_end[b], h) - r.by0, 0);
  r.valid = b < s.n_bands;
  return r;
}

__device__ __forceinline__ void glyph_cols(const Shared& s, int b, int j, int w, int& gx0, int& gw) {
  gx0 = min(s.g_start[b][j], w);
  gw = max(min(s.g_end[b][j], w) - gx0, 0);
}

// Phase 3 for glyph slot `slot`, by one warp.
__device__ void classify_slot(Shared& s, const uint8_t* __restrict__ text, int h, int w, int T, int slot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = slot / MAX_GPB, j = slot % MAX_GPB;
  const Band band = band_of(s, b, h);
  int gx0, gw;
  glyph_cols(s, b, j, w, gx0, gw);
  if (!(band.valid && j < s.n_g[b])) {  // an empty slot: no glyph
    if (lane == 0) s.ok[slot] = 0;
    return;
  }
  const int bh = min(band.bh_full, WIN_H);
  const int cw = min(gw, WIN_W);
  uint64_t* win = s.win[warp];
  // The window, masked to the band's rows and the run's columns (pixels
  // past h / w are never read: by0 + bh <= h and gx0 + gw <= w).
#pragma unroll 4
  for (int r = 0; r < WIN_H; ++r) {
    const uint8_t* row = text + (int64_t)(band.by0 + r) * w + gx0;
    const bool in = r < bh;
    const uint32_t lo = __ballot_sync(FULL, in && lane < cw && row[lane] != 0);
    const uint32_t hi = __ballot_sync(FULL, in && lane + 32 < cw && row[lane + 32] != 0);
    if (lane == 0) win[r] = (uint64_t)lo | ((uint64_t)hi << 32);
  }
  __syncwarp();
  const uint64_t r0 = win[lane], r1 = win[lane + 32];
  const uint64_t rows = (uint64_t)__ballot_sync(FULL, r0 != 0) | ((uint64_t)__ballot_sync(FULL, r1 != 0) << 32);
  const int gy0 = rows ? __ffsll((long long)rows) - 1 : WIN_H;
  const int gy1 = rows ? WIN_H - __clzll((long long)rows) : 0;
  const int gh = gy1 - gy0;
  const int count = warp_sum_int(__popcll(r0) + __popcll(r1));
  const bool ok = count >= MIN_GLYPH_PX && gh >= MIN_GLYPH_H && gh <= MAX_GLYPH_H && gw <= MAX_GLYPH_H;
  if (lane == 0) {
    s.gy0[slot] = gy0;
    s.gy1[slot] = gy1;
    s.ok[slot] = ok;
  }
  if (!ok) return;

  // Canonical 16 x 12 resample (map_coordinates, order 1, mode "nearest").
  const float qh = __fdiv_rn((float)gh, (float)GLYPH_H);
  const float qw = __fdiv_rn((float)gw, (float)GLYPH_W);
  auto val = [&](int r, int c) {
    r = min(max(r, 0), WIN_H - 1);
    c = min(max(c, 0), WIN_W - 1);
    return (float)((win[r] >> c) & 1u);
  };
  float feat[PX_PER_LANE];
  float sum = 0.f;
#pragma unroll
  for (int q = 0; q < PX_PER_LANE; ++q) {
    const int k = lane + 32 * q;
    const int i = k / GLYPH_W, jj = k % GLYPH_W;
    const float vi = __fsub_rn(__fadd_rn((float)gy0, __fmul_rn((float)i + 0.5f, qh)), 0.5f);
    const float uj = __fsub_rn(__fmul_rn((float)jj + 0.5f, qw), 0.5f);
    const float lv = floorf(vi), lu = floorf(uj);
    const float uwv = __fsub_rn(vi, lv), uwu = __fsub_rn(uj, lu);
    const float lwv = __fsub_rn(1.f, uwv), lwu = __fsub_rn(1.f, uwu);
    const int iv = (int)lv, iu = (int)lu;
    float t = __fmul_rn(__fmul_rn(lwv, lwu), val(iv, iu));
    t = __fadd_rn(t, __fmul_rn(__fmul_rn(lwv, uwu), val(iv, iu + 1)));
    t = __fadd_rn(t, __fmul_rn(__fmul_rn(uwv, lwu), val(iv + 1, iu)));
    t = __fadd_rn(t, __fmul_rn(__fmul_rn(uwv, uwu), val(iv + 1, iu + 1)));
    feat[q] = t;
    sum = __fadd_rn(sum, t);
  }
  const float mean = __fdiv_rn(warp_sum(sum), (float)GLYPH_PX);
  float sq = 0.f;
#pragma unroll
  for (int q = 0; q < PX_PER_LANE; ++q) {
    feat[q] = __fsub_rn(feat[q], mean);
    sq = __fadd_rn(sq, __fmul_rn(feat[q], feat[q]));
  }
  const float norm = __fsqrt_rn(warp_sum(sq));
  const bool unit = norm > 1e-6f;
#pragma unroll
  for (int q = 0; q < PX_PER_LANE; ++q) feat[q] = unit ? __fdiv_rn(feat[q], norm) : 0.f;
  float best = 0.f;
  int best_t = 0;
  for (int t = 0; t < T; ++t) {
    const float* row = s.tpl + t * GLYPH_PX + lane;
    float d = 0.f;
#pragma unroll
    for (int q = 0; q < PX_PER_LANE; ++q) d = __fadd_rn(d, __fmul_rn(feat[q], row[32 * q]));
    d = warp_sum(d);
    if (t == 0 || d > best) {  // the first index wins a tie
      best = d;
      best_t = t;
    }
  }
  if (lane == 0) {
    s.chr[slot] = best_t;
    s.score[slot] = (int)__fmul_rn(best, 1000.f);  // truncates toward zero
  }
}

// Phase 4 for band b, by one thread: the word grouping (smhocr's chaining
// rule) and the scatter of its glyphs into the band's MAX_WPB word slots.
__device__ void group_band(Shared& s, int b, int h, int w) {
  for (int k = 0; k < MAX_WPB; ++k) {
    const int o = b * MAX_WPB + k;
    s.w_n[o] = 0;
    s.w_x0[o] = BIG;
    s.w_y0[o] = BIG;
    s.w_x1[o] = 0;
    s.w_y1[o] = 0;
    s.w_trunc[o] = 0;
    for (int p = 0; p < MAX_WG; ++p) {
      s.w_chars[o][p] = -1;
      s.w_scores[o][p] = 0;
    }
  }
  const Band band = band_of(s, b, h);
  int wid = -1, px1 = 0, py0 = 0, py1 = 0, ph = 0;
  bool has_prev = false;
  for (int j = 0; j < MAX_GPB; ++j) {
    const int slot = b * MAX_GPB + j;
    if (!s.ok[slot]) continue;  // a dead slot leaves the carries as they are
    int x0, gw;
    glyph_cols(s, b, j, w, x0, gw);
    const int x1 = x0 + gw;
    const int y0 = band.by0 + s.gy0[slot], y1 = band.by0 + s.gy1[slot];
    const int hh = y1 - y0;
    const int gap = x0 - px1;
    const int v_overlap = min(y1, py1) - max(y0, py0);
    const int min_h = min(hh, ph);  // >= 0: ph is 0 or a live glyph's height
    const int gap_max = max((9 * min_h) / 10, 4);
    const bool same = has_prev && v_overlap > min_h / 2 && gap >= -2 && gap <= gap_max;
    wid = same ? wid : wid + 1;
    has_prev = true;
    px1 = x1;
    py0 = y0;
    py1 = y1;
    ph = hh;
    if (wid >= MAX_WPB) continue;  // the band overflowed its word slots
    const int o = b * MAX_WPB + wid;
    if (s.w_n[o] >= MAX_WG) {  // the glyph's place in its word is past the cap
      s.w_trunc[o] = 1;  // a suffix of the word is lost: the host never trusts it
      continue;
    }
    const int at = s.w_n[o]++;
    s.w_chars[o][at] = s.chr[slot];
    s.w_scores[o][at] = s.score[slot];
    s.w_x0[o] = min(s.w_x0[o], x0);
    s.w_y0[o] = min(s.w_y0[o], y0);
    s.w_x1[o] = max(s.w_x1[o], x1);
    s.w_y1[o] = max(s.w_y1[o], y1);
  }
  s.band_bad[b] = (band.valid && (band.bh_full > WIN_H || s.n_g[b] > MAX_GPB)) || wid + 1 > MAX_WPB;
}

__device__ __forceinline__ bool black4(const uint8_t* __restrict__ sb, int w, int y, int c) {
  const uint8_t* p = sb + (int64_t)y * w + c;
  return !(p[0] | p[w] | p[2 * w] | p[3 * w]);
}

// Phase 5 for word slot o, by one warp: the first of the budget rows below
// the word that holds a bar (src/vision/mpx_ratio.rs semantics, with the
// right-1 / left+1 steps and the column-0 sentinels).
__device__ void scan_word(Shared& s, const uint8_t* __restrict__ sb, int h, int w, int budget, int o) {
  const int lane = threadIdx.x & 31;
  int found = 0, by = 0, bl = 0, br = 0;
  const int y_bot = s.w_y1[o];
  if (s.w_n[o] > 0 && y_bot >= BAR_H) {
    const int x = (s.w_x0[o] + s.w_x1[o]) / 2;  // both >= 0
    const int xa = min(x, w - 1);
    // Rows past h - BAR_H hold no bar (and rows past h none at all).
    const int last = min(y_bot + budget, h - BAR_H + 1);
    for (int y = y_bot; y < last; ++y) {
      if (sb[(int64_t)y * w + xa]) continue;  // the anchor pixel is not black
      int rx = w;
      for (int c0 = x; c0 < w; c0 += 32) {
        const int c = c0 + lane;
        const uint32_t m = __ballot_sync(FULL, c < w && black4(sb, w, y, c));
        if (m) {
          rx = c0 + __ffs(m) - 1;
          break;
        }
      }
      if (rx >= w || rx == 0) continue;
      int lx = -1;
      for (int c0 = min(x, w) - 1; c0 >= 0; c0 -= 32) {
        const int c = c0 - lane;
        const uint32_t m = __ballot_sync(FULL, c >= 0 && black4(sb, w, y, c));
        if (m) {
          lx = c0 - (__ffs(m) - 1);
          break;
        }
      }
      if (lx <= 0) continue;  // none, or the column-0 sentinel
      if ((rx - 1) - (lx + 1) >= MIN_SCALE_WIDTH) {
        found = 1;
        by = y;
        bl = lx + 1;
        br = rx - 1;
        break;
      }
    }
  }
  if (lane == 0) {
    s.bar_found[o] = found;
    s.bar_y[o] = by;
    s.bar_l[o] = bl;
    s.bar_r[o] = br;
  }
}

__device__ __forceinline__ int record_lane(const Shared& s, int T, int lane) {
  if (lane < HDR_I16) {
    if (lane == 0) return min(s.n_bands, MAX_BANDS);
    if (lane == 1) return s.n_bands > MAX_BANDS ? FLAG_BAND_OVERFLOW : 0;
    if (lane == 2) return T;
    if (lane == 3) {
      int bits = 0;
      for (int b = 0; b < MAX_BANDS; ++b) bits |= s.band_bad[b] << b;
      return bits;
    }
    return 0;
  }
  const int o = (lane - HDR_I16) / WORD_I16, f = (lane - HDR_I16) % WORD_I16;
  const bool has = s.w_n[o] > 0;
  switch (f) {
    case 0: return s.w_n[o];
    case 1: return has ? s.w_x0[o] : 0;
    case 2: return has ? s.w_y0[o] : 0;
    case 3: return s.w_x1[o];
    case 4: return s.w_y1[o];
    case 5: return s.bar_found[o];
    case 6: return s.bar_y[o];
    case 7: return s.bar_l[o];
    case 8: return s.bar_r[o];
    case 9: return s.w_trunc[o];
    default: break;
  }
  if (f < 10 + MAX_WG) return s.w_chars[o][f - 10];
  if (f < 10 + 2 * MAX_WG) return min(max(s.w_scores[o][f - 10 - MAX_WG], -BIG), BIG);
  return 0;
}

__global__ void __launch_bounds__(THREADS) scales_read_kernel(const uint8_t* __restrict__ text, int64_t text_stride,
                                                              const uint8_t* __restrict__ sbool,
                                                              int64_t sbool_stride, const float* __restrict__ tpl,
                                                              int T, int h, int w, int budget,
                                                              int16_t* __restrict__ out) {
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  text += blockIdx.x * text_stride;
  sbool += blockIdx.x * sbool_stride;
  out += (int64_t)blockIdx.x * REC_I16;

  // 0. templates in, bit sets cleared
  for (int i = tid; i < T * GLYPH_PX; i += THREADS) s.tpl[i] = __ldg(tpl + i);
  const int hw = (h + 31) >> 5, ww = (w + 31) >> 5;
  for (int i = tid; i < hw; i += THREADS) s.rowbits[i] = 0u;
  for (int i = tid; i < MAX_BANDS * ww; i += THREADS) s.colbits[i / ww][i % ww] = 0u;
  __syncthreads();

  // 1. the text rows, then their runs: the bands
  for_nonzero(text, (int64_t)h * w, MarkRows{s.rowbits, w});
  __syncthreads();
  if (warp == 0) warp_runs(s.rowbits, h, MAX_BANDS, s.b_start, s.b_end, &s.n_bands);
  __syncthreads();

  // 2. each band's columns, then their runs: the glyph slots
  for (int b = 0; b < MAX_BANDS; ++b) {
    const Band band = band_of(s, b, h);
    const int rows = min(band.bh_full, WIN_H);
    for_nonzero(text + (int64_t)band.by0 * w, (int64_t)rows * w, MarkCols{s.colbits[b], w});
  }
  __syncthreads();
  if (warp < MAX_BANDS) warp_runs(s.colbits[warp], w, MAX_GPB, s.g_start[warp], s.g_end[warp], &s.n_g[warp]);
  __syncthreads();

  // 3. the glyph windows: gate, resample, classify
  for (int slot = warp; slot < N_SLOTS; slot += WARPS) classify_slot(s, text, h, w, T, slot);
  __syncthreads();

  // 4. words
  if (tid < MAX_BANDS) group_band(s, tid, h, w);
  __syncthreads();

  // 5. the bar scan
  for (int o = warp; o < N_WORDS; o += WARPS) scan_word(s, sbool, h, w, budget, o);
  __syncthreads();

  // 6. the record
  for (int i = tid; i < REC_I16; i += THREADS) out[i] = (int16_t)record_lane(s, T, i);
}

}  // namespace

// text, sbool: B frames of H x W bytes (nonzero = True), frame b at
// + b * stride bytes (stride >= H * W); tpl: f32 [T, 192]; out: i16
// [B, REC_I16]; budget: scan_budget(W).
extern "C" int smh_scales_read(const void* text, int64_t text_stride, const void* sbool, int64_t sbool_stride,
                               const void* tpl, int T, int H, int W, int B, int budget, void* out, void* stream) {
  if (T < 1 || T > MAX_TEMPLATES || H < 1 || W < 1 || H > MAX_DIM || W > MAX_DIM || B < 1 || budget < 0 ||
      text_stride < (int64_t)H * W || sbool_stride < (int64_t)H * W)
    return (int)cudaErrorInvalidValue;
  scales_read_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), text_stride, static_cast<const uint8_t*>(sbool), sbool_stride,
      static_cast<const float*>(tpl), T, H, W, budget, static_cast<int16_t*>(out));
  return (int)cudaGetLastError();
}
