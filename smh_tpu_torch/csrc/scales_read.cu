// The on-device scales read: text-row bands, glyph column runs, glyph
// classification against the templates, word grouping, and the scale-bar
// scan, into the fixed i16 record vector. One launch per call, a thread
// block cluster of CLUSTER blocks per frame.
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
// The phases, each opened by a top-level comment "// k." (the probe's
// ablations stop the kernel there):
//
//  0. the band blocks (ranks 0 .. MAX_BANDS - 1) start one bulk copy of the
//     templates into shared memory (cp.async.bulk on an mbarrier, waited on
//     only in phase 3); block 0 sets up the header's mbarrier; every block
//     clears its strip's row flags and arrives (relaxed) on the cluster
//     barrier;
//  1. the text rows: block r reads its strip of whole 32-row words of the
//     frame (16-byte loads, LOADS in flight per thread; the unaligned ends
//     a byte a thread, in the same round trip), flags the rows that hold a
//     nonzero byte (plain byte stores, no atomics) and packs its words of
//     the row bit set; once the cluster has started it writes them into
//     every other block's shared memory (distributed shared memory), and
//     after one cluster barrier every block holds the whole set and finds
//     the first MAX_BANDS row runs, the bands, itself (a warp scan);
//  2. block b < MAX_BANDS takes band b, and stages in one pass of loads
//     its first min(height, WIN_H) text rows and the scales plane's rows
//     from the band's first row to the last row the bar scan can read
//     (min(height, WIN_H) + budget + BAR_H - 1 rows: a word's bottom lies
//     in the band's window), both as bit rows in shared memory (1 =
//     nonzero text, 1 = black); warp 0 ORs the text rows into the column
//     bit set and finds the first MAX_GPB column runs: the glyph slots;
//  3. one warp per glyph slot, all 16 in one round: the WIN_H x WIN_W
//     window as 64-bit row words cut from the staged bit rows (two funnel
//     shifts a row), its row extent, pixel count and gate, then for a
//     glyph that passes the gate the 16 x 12 bilinear resample (6 pixels a
//     lane), mean removal, L2 normalisation, the dot with each template
//     (8 templates' warp sums interleaved) and the argmax (first index on
//     ties);
//  4. one warp, a lane a glyph slot: the band's word grouping (each live
//     glyph against the nearest live glyph before it, the scan's carry;
//     its word the count of word starts up to it) and the scatter into
//     its MAX_WPB word slots with the MAX_WG cap and the truncation flag;
//  5. the bar scan, from the staged black rows: every (word, row) pair at
//     once, a warp each: the anchor, the right and left walks as ballots
//     over 32 words (1,024 columns) at a time, and the row's key (row,
//     left, right) into a 64-bit atomicMin, so the smallest row that holds
//     a bar wins: the reference's speculative scan, equal to the
//     sequential first row;
//  6. the record: each band's block writes its band_bad into block 0 and
//     arrives on block 0's mbarrier, then writes its MAX_WPB word slots
//     (lanes no other block writes); block 0 waits for the MAX_BANDS
//     arrivals and writes the header. No other block waits.
//
// What bounds it: the bytes a call must move are the two planes once, the
// templates and the record (2 * H * W + T * 768 + 1,168 B per frame: 0.49
// us at 3.35 TB/s for the 822 x 986 BRQ of 4K). What the card cannot
// overlap is a chain of dependent steps: the launch, the row pass, the
// cluster barrier of the row bits' exchange, the band's staging pass, the
// two warp scans, the windows and their template dots, the word grouping,
// the bar rows, and block 0's wait for the band blocks. Latency, not bytes,
// bounds it, and each pass of loads runs at what one SM can have in flight.
// The design cuts the chain that a single block had: the row pass runs on
// CLUSTER SMs; the bands run side by side, a block each; the band's text
// and bar rows come in one pass; a window and a bar row read shared
// memory, never device memory; no bar row waits for the one above it; the
// word grouping is a warp's shuffles, not a thread's loop. A batch takes
// one cluster per frame, so B frames cost about what the slowest one does.

#include <atomic>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
constexpr int BIG = 1 << 14;  // the fill of an empty word's min-box, and the score clamp

// Capacities of the kernel's shared memory (the wrapper checks both).
constexpr int MAX_TEMPLATES = 32;
constexpr int MAX_DIM = 4096;  // rows and columns of a plane
constexpr int DIM_WORDS = MAX_DIM / 32;

constexpr int CLUSTER = 8;     // blocks per frame: one thread block cluster
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int LOADS = 4;       // 16-byte loads in flight per thread in the row pass
constexpr int GROUP = 2;       // words of a bit row one thread stages
constexpr int PAD_WORDS = 2;   // cleared words past each staged bit row: a window reads 3 words
constexpr int DOTS = 8;        // template dots whose warp sums interleave
constexpr unsigned FULL = 0xffffffffu;
constexpr int PX_PER_LANE = GLYPH_PX / 32;  // 6
static_assert(GLYPH_PX % 32 == 0, "a lane takes whole resample pixels");
static_assert(WIN_W <= 64 && WIN_H == 64, "a window row is one 64-bit word, its rows two per lane");
static_assert(CLUSTER >= MAX_BANDS && CLUSTER <= 16, "a block per band, at most the non-portable cluster size");
static_assert(WARPS >= MAX_GPB, "a warp per glyph slot");
static_assert(MAX_DIM < (1 << 13), "a bar key packs the row, left and right in 13 bits each");
constexpr int STRIP_ROWS = 32 * ((DIM_WORDS + CLUSTER - 1) / CLUSTER);  // the most rows a block's strip holds
constexpr int MAX_BUDGET = 128;  // scan_budget(MAX_DIM): the most rows below a word the bar scan reads

// Dynamic shared memory for `rows` staged bit rows of a w-column plane.
constexpr size_t staged_bytes(int64_t rows, int w) {
  return (size_t)rows * ((w + 31) / 32 + PAD_WORDS) * sizeof(uint32_t);
}
// The most any shape stages: a band's WIN_H text rows and its bar rows.
constexpr size_t MAX_SMEM = staged_bytes(2 * WIN_H + MAX_BUDGET + BAR_H - 1, MAX_DIM);
constexpr int MAX_DEVICES = 64;

struct Shared {
  alignas(16) float tpl[MAX_TEMPLATES * GLYPH_PX];
  unsigned long long tpl_bar;  // the templates' mbarrier
  uint32_t rowbits[DIM_WORDS];
  uint32_t colbits[DIM_WORDS];
  alignas(16) uint8_t rowflag[STRIP_ROWS];  // this block's strip: row r0 + i has a nonzero byte
  uint64_t win[WARPS][WIN_H];
  unsigned long long hdr_bar;  // block 0's: the band blocks' band_bad are in
  int n_bands;
  int b_start[MAX_BANDS], b_end[MAX_BANDS];
  int bad[MAX_BANDS];  // block 0's: band b's band_bad, written by block b
  // the band's glyph slots
  int n_g;
  int g_start[MAX_GPB], g_end[MAX_GPB];
  int gy0[MAX_GPB], gy1[MAX_GPB], ok[MAX_GPB], chr[MAX_GPB], score[MAX_GPB];
  // the band's word slots
  int w_n[MAX_WPB], w_x0[MAX_WPB], w_y0[MAX_WPB], w_x1[MAX_WPB], w_y1[MAX_WPB], w_trunc[MAX_WPB];
  int w_chars[MAX_WPB][MAX_WG], w_scores[MAX_WPB][MAX_WG];
  int band_bad;
  // the bar scan: (word, row) items from item0[o]
  int item0[MAX_WPB + 1];
  unsigned long long bar_key[MAX_WPB];
};
static_assert(sizeof(Shared) + MAX_SMEM <= 227 * 1024, "a block's shared memory on the H100");

// Per device: the kernel's dynamic shared memory limit is MAX_SMEM.
std::atomic<bool> smem_set[MAX_DEVICES];

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Orders nothing: it only tells the cluster that this block has started.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Waits for the phase `parity` of this block's mbarrier at `bar` to
// complete, with acquire at cluster scope: what the blocks that arrived
// wrote before their release-arrive is visible.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Arrives, with release at cluster scope, on the mbarrier at `bar` in
// block `rank`'s shared memory.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, int rank) {
  uint32_t at;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(at) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(at) : "memory");
}

// Phase 0 in a band's block: one thread starts the templates' bulk copy
// (the launcher takes only a 16-byte aligned source).
__device__ void start_templates(Shared& s, const float* __restrict__ tpl, int T) {
  const uint32_t bar = smem_addr(&s.tpl_bar);
  const uint32_t bytes = (uint32_t)T * GLYPH_PX * 4u;  // a multiple of 16
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
            smem_addr(s.tpl)),
        "l"(tpl), "r"(bytes), "r"(bar)
        : "memory");
  }
}

// The templates are in shared memory (a band's block; for the others a
// no-op). Every block that started the copy waits on it before it exits.
__device__ __forceinline__ void await_templates(Shared& s, int rank) {
  if (rank < MAX_BANDS) mbar_wait(smem_addr(&s.tpl_bar), 0);
}

// Flags, for each nonzero byte at offset o of a chunk, the row o / w (plain
// byte stores: every writer writes 1).
struct MarkRows {
  uint8_t* flags;
  int w;
  // m: bit j set iff byte base + j (j < 16) is nonzero.
  __device__ void operator()(int64_t base, uint32_t m) const {
    const int o = (int)base;  // a strip holds fewer than 2^31 bytes
    int r = o / w;
    int c = o - r * w;
    int j = 0;
    while (m) {
      const int take = min(16 - j, w - c);  // bytes j .. j + take - 1 lie in row r
      const uint32_t seg = ((1u << take) - 1u) << j;
      if (m & seg) flags[r] = 1;
      m &= ~seg;
      j += take;
      ++r;
      c = 0;
    }
  }
};

__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t v) {
  // bit k of the result: byte k of v is nonzero (k < 4)
  const uint32_t t = ((v & 0x7f7f7f7fu) + 0x7f7f7f7fu) | v;
  const uint32_t hi = t & 0x80808080u;
  return ((hi >> 7) & 1u) | ((hi >> 14) & 2u) | ((hi >> 21) & 4u) | ((hi >> 28) & 8u);
}

__device__ __forceinline__ uint32_t nonzero_mask(uint4 q) {
  return nonzero_bytes(q.x) | (nonzero_bytes(q.y) << 4) | (nonzero_bytes(q.z) << 8) | (nonzero_bytes(q.w) << 12);
}

// The block's threads visit the nonzero bytes of p[0, n) (p[o] for offsets
// relative to p), calling f(offset of a 16-byte chunk, its nonzero-byte
// bits): 16-byte aligned loads, LOADS in flight per thread; the unaligned
// head and tail (under 16 bytes each) a byte a thread, loaded beside the
// first loads so that no thread waits for two round trips.
template <class F>
__device__ void for_nonzero(const uint8_t* __restrict__ p, int64_t n, const F& f) {
  if (n <= 0) return;
  int64_t head = (int64_t)((16u - (uint32_t)(reinterpret_cast<uintptr_t>(p) & 15u)) & 15u);
  if (head > n) head = n;
  const int64_t nvec = (n - head) / 16;
  const int64_t tail = head + nvec * 16;
  const int t = threadIdx.x;  // blockDim.x >= 16: one head and one tail byte at most per thread
  const uint8_t hb = t < head ? __ldg(p + t) : (uint8_t)0, tb = tail + t < n ? __ldg(p + tail + t) : (uint8_t)0;
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  for (int64_t k0 = threadIdx.x; k0 < nvec; k0 += LOADS * (int64_t)blockDim.x) {
    uint4 q[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int64_t k = k0 + u * (int64_t)blockDim.x;
      q[u] = k < nvec ? __ldg(v + k) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      if ((q[u].x | q[u].y | q[u].z | q[u].w) == 0u) continue;
      f(head + 16 * (k0 + u * (int64_t)blockDim.x), nonzero_mask(q[u]));
    }
  }
  if (hb) f(t, 1u);
  if (tb) f(tail + t, 1u);
}

// The aligned 16-byte chunk at `at`, whose bytes outside [lo, hi) read as
// zero (and are not read): one 16-byte load when it lies inside, else 16
// predicated byte loads, all in flight with the caller's other loads.
__device__ __forceinline__ uint4 load_chunk(uintptr_t at, uintptr_t lo, uintptr_t hi) {
  if (at >= lo && at + 16 <= hi) return __ldg(reinterpret_cast<const uint4*>(at));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (at + j >= lo && at + j < hi) w[j >> 2] |= (uint32_t)__ldg(reinterpret_cast<const uint8_t*>(at + j)) << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One contiguous span of rows to stage: rows [0, rows) of p, w bytes each.
struct Span {
  const uint8_t* p;
  int rows;
};

// Stages two spans of rows as bit rows, their loads in one pass: word k <
// nk = ceil(w / 32) of row r of span `which` has bit j set iff byte 32 k +
// j of the row is nonzero (span 1: is zero, a black pixel), bits past the
// row clear; f(which, r, k, word) stores it. Each thread takes GROUP words
// of a row from the aligned 16-byte chunks that hold them, all its loads in
// flight at once (the chunks at a span's two ends bytewise).
template <class F>
__device__ void stage_rows(Span s0, Span s1, int w, const F& f) {
  const int nk = (w + 31) >> 5;
  const int ng = (nk + GROUP - 1) / GROUP;
  const int n0 = s0.rows * ng;
  constexpr int CHUNKS = 2 * GROUP + 1;
  for (int i = threadIdx.x; i < n0 + s1.rows * ng; i += blockDim.x) {
    const int which = i >= n0;
    const Span sp = which ? s1 : s0;
    const int item = i - which * n0;
    const int r = item / ng, k0 = (item - r * ng) * GROUP;
    const uintptr_t lo = reinterpret_cast<uintptr_t>(sp.p), hi = lo + (uintptr_t)sp.rows * (uintptr_t)w;
    const int len = min(32 * GROUP, w - 32 * k0);  // the group's bytes
    const uintptr_t a = lo + (uintptr_t)r * (uintptr_t)w + 32 * k0;
    const int sh = (int)(a & 15u);
    const uintptr_t base = a - sh;
    const int nchunks = (sh + len + 15) >> 4;
    uint4 q[CHUNKS];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) q[c] = c < nchunks ? load_chunk(base + 16 * c, lo, hi) : make_uint4(0u, 0u, 0u, 0u);
    uint32_t cm[CHUNKS + 1];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) cm[c] = nonzero_mask(q[c]);
    cm[CHUNKS] = 0u;
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      if (k0 + j >= nk) break;
      // bits sh + 32 j .. sh + 32 j + 31 of the chunks' masks: chunks 2j .. 2j + 2
      const uint64_t m = (uint64_t)cm[2 * j] | ((uint64_t)cm[2 * j + 1] << 16) | ((uint64_t)cm[2 * j + 2] << 32);
      uint32_t word = (uint32_t)(m >> sh);
      if (which) word = ~word;
      const int n = len - 32 * j;
      if (n < 32) word &= (1u << n) - 1u;
      f(which, r, k0 + j, word);
    }
  }
}

// Stores a staged word of the text rows (span 0) or of the black rows
// (span 1), sw words a row.
struct StoreWord {
  uint32_t* text;
  uint32_t* black;
  int sw;
  __device__ void operator()(int which, int r, int k, uint32_t word) const { (which ? black : text)[r * sw + k] = word; }
};

// Clears the PAD_WORDS words past each of `rows` staged rows.
__device__ __forceinline__ void clear_pads(uint32_t* bits, int rows, int nk, int sw) {
  for (int i = threadIdx.x; i < rows * PAD_WORDS; i += blockDim.x) bits[(i / PAD_WORDS) * sw + nk + i % PAD_WORDS] = 0u;
}

// One warp: the first max_runs runs of set bits among bits [0, n) (bit i in
// word i / 32, bits past n clear) as starts and exclusive ends, and their
// count; slots past the count get start n, end n + 1 (ops/scales_device.py
// _runs). Lane l takes word l of each 32 words (its neighbours' bits by
// shuffles); a warp scan of the start and end counts gives each lane the
// rank of its first run; the empty slots are filled a lane each.
__device__ void warp_runs(const uint32_t* bits, int n, int max_runs, int* starts, int* ends, int* count) {
  const int lane = threadIdx.x & 31;
  const int nw = (n + 31) >> 5;
  int base_s = 0, base_e = 0;  // runs that start and end in the words before this 32
  for (int c0 = 0; c0 < nw; c0 += 32) {
    const int i = c0 + lane;
    const uint32_t b = i < nw ? bits[i] : 0u;
    uint32_t prev = __shfl_up_sync(FULL, b, 1), next = __shfl_down_sync(FULL, b, 1);
    if (lane == 0) prev = c0 > 0 ? bits[c0 - 1] : 0u;
    if (lane == 31) next = i + 1 < nw ? bits[i + 1] : 0u;
    uint32_t st = b & ~((b << 1) | (prev >> 31)), en = b & ~((b >> 1) | (next << 31));
    const int ns = __popc(st), ne = __popc(en);
    int is = ns, ie = ne;  // inclusive scans
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int ts = __shfl_up_sync(FULL, is, d), te = __shfl_up_sync(FULL, ie, d);
      if (lane >= d) {
        is += ts;
        ie += te;
      }
    }
    int rs = base_s + is - ns, re = base_e + ie - ne;
    for (; st && rs < max_runs; st &= st - 1) starts[rs++] = 32 * i + __ffs(st) - 1;
    for (; en && re < max_runs; en &= en - 1) ends[re++] = 32 * i + __ffs(en);
    base_s += __shfl_sync(FULL, is, 31);
    base_e += __shfl_sync(FULL, ie, 31);
  }
  for (int r = base_s + lane; r < max_runs; r += 32) {
    starts[r] = n;
    ends[r] = n + 1;
  }
  if (lane == 0) *count = base_s;
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

// A band's rows, clamped as in _runs' use; valid: the band exists.
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

__device__ __forceinline__ void glyph_cols(const Shared& s, int j, int w, int& gx0, int& gw) {
  gx0 = min(s.g_start[j], w);
  gw = max(min(s.g_end[j], w) - gx0, 0);
}

// Phase 3 for glyph slot j of the band, by one warp, from the band's bit
// rows (sw words a row).
__device__ void classify_slot(Shared& s, const uint32_t* bits, int sw, const Band& band, int w, int T, int j) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int gx0, gw;
  glyph_cols(s, j, w, gx0, gw);
  if (!(band.valid && j < s.n_g)) {  // an empty slot: no glyph
    if (lane == 0) s.ok[j] = 0;
    return;
  }
  const int bh = min(band.bh_full, WIN_H);
  const int cw = min(gw, WIN_W);
  const uint64_t cmask = (1ull << cw) - 1ull;  // cw <= 48
  const int k0 = gx0 >> 5, sh = gx0 & 31;
  // The window, masked to the band's rows and the run's columns: row r's
  // bits gx0 .. gx0 + 63 from three words (k0 + 2 < sw: gx0 < w).
  auto window_row = [&](int r) -> uint64_t {
    if (r >= bh) return 0ull;
    const uint32_t* p = bits + r * sw + k0;
    uint64_t v = ((uint64_t)p[0] | ((uint64_t)p[1] << 32)) >> sh;
    if (sh) v |= (uint64_t)p[2] << (64 - sh);
    return v & cmask;
  };
  uint64_t* win = s.win[warp];
  const uint64_t r0 = window_row(lane), r1 = window_row(lane + 32);
  win[lane] = r0;
  win[lane + 32] = r1;
  __syncwarp();
  const uint64_t rows = (uint64_t)__ballot_sync(FULL, r0 != 0) | ((uint64_t)__ballot_sync(FULL, r1 != 0) << 32);
  const int gy0 = rows ? __ffsll((long long)rows) - 1 : WIN_H;
  const int gy1 = rows ? WIN_H - __clzll((long long)rows) : 0;
  const int gh = gy1 - gy0;
  const int count = warp_sum_int(__popcll(r0) + __popcll(r1));
  const bool ok = count >= MIN_GLYPH_PX && gh >= MIN_GLYPH_H && gh <= MAX_GLYPH_H && gw <= MAX_GLYPH_H;
  if (lane == 0) {
    s.gy0[j] = gy0;
    s.gy1[j] = gy1;
    s.ok[j] = ok;
  }
  if (!ok) return;

  // Canonical 16 x 12 resample (map_coordinates, order 1, mode "nearest").
  const float qh = __fmul_rn((float)gh, 1.f / GLYPH_H);  // == gh / 16 exactly: a power of two
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
  // DOTS templates at a time: each dot summed as one warp_sum would sum it,
  // their butterflies interleaved; the argmax in template order.
  float best = 0.f;
  int best_t = 0;
  for (int t0 = 0; t0 < T; t0 += DOTS) {
    float d[DOTS];
#pragma unroll
    for (int u = 0; u < DOTS; ++u) {
      const float* row = s.tpl + min(t0 + u, T - 1) * GLYPH_PX + lane;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < PX_PER_LANE; ++q) acc = __fadd_rn(acc, __fmul_rn(feat[q], row[32 * q]));
      d[u] = acc;
    }
#pragma unroll
    for (int dd = 16; dd > 0; dd >>= 1) {
#pragma unroll
      for (int u = 0; u < DOTS; ++u) d[u] = __fadd_rn(d[u], __shfl_xor_sync(FULL, d[u], dd));
    }
#pragma unroll
    for (int u = 0; u < DOTS; ++u) {
      const int t = t0 + u;
      if (t < T && (t == 0 || d[u] > best)) {  // the first index wins a tie
        best = d[u];
        best_t = t;
      }
    }
  }
  if (lane == 0) {
    s.chr[j] = best_t;
    s.score[j] = (int)__fmul_rn(best, 1000.f);  // truncates toward zero
  }
}

// Phase 4, by one warp, lane j on glyph slot j: the band's word grouping
// (smhocr's chaining rule) and the scatter of its glyphs into the MAX_WPB
// word slots; then the bar scan's (word, row) items. The scan's carries are
// the previous live glyph's box, so each live glyph decides "same word"
// against the nearest live lane below it, and its word is the count of
// word starts up to it: the scan's result, without its chain.
__device__ void group_band(Shared& s, const Band& band, int h, int w, int budget) {
  const int j = threadIdx.x & 31;
  const bool alive = band.valid && j < min(s.n_g, MAX_GPB) && s.ok[j];
  int x0 = 0, gw = 0, y0 = 0, y1 = 0;
  if (alive) {
    glyph_cols(s, j, w, x0, gw);
    y0 = band.by0 + s.gy0[j];
    y1 = band.by0 + s.gy1[j];
  }
  const int x1 = x0 + gw, hh = y1 - y0;
  const uint32_t live = __ballot_sync(FULL, alive);
  const uint32_t before = live & ((1u << j) - 1u);  // live glyphs left of j
  const int p = before ? 31 - __clz(before) : 0;
  const int px1 = __shfl_sync(FULL, x1, p), py0 = __shfl_sync(FULL, y0, p);
  const int py1 = __shfl_sync(FULL, y1, p), ph = __shfl_sync(FULL, hh, p);
  const int gap = x0 - px1;
  const int v_overlap = min(y1, py1) - max(y0, py0);
  const int min_h = min(hh, ph);  // >= 0
  const int gap_max = max((9 * min_h) / 10, 4);
  const bool same = before != 0u && v_overlap > min_h / 2 && gap >= -2 && gap <= gap_max;
  const uint32_t starts = __ballot_sync(FULL, alive && !same);
  const int wid = alive ? __popc(starts & ((2u << j) - 1u)) - 1 : -1;
  // the glyphs of j's word, in slot order; past the MAX_WG-th a suffix of
  // the word is lost: the truncation flag, and the host never trusts it
  const uint32_t word = __match_any_sync(FULL, wid) & live;
  const int at = __popc(word & ((1u << j) - 1u));
  const bool kept = alive && wid < MAX_WPB && at < MAX_WG;
  if (j < MAX_WPB * MAX_WG) {
    s.w_chars[j / MAX_WG][j % MAX_WG] = -1;
    s.w_scores[j / MAX_WG][j % MAX_WG] = 0;
  }
  if (j < MAX_WPB) {
    s.w_n[j] = 0;
    s.w_trunc[j] = 0;
    s.w_x0[j] = BIG;
    s.w_y0[j] = BIG;
    s.w_x1[j] = 0;
    s.w_y1[j] = 0;
  }
  __syncwarp();
  if (kept) {  // the column runs are disjoint and in order: x0 is the first kept glyph's, x1 the last's
    const int n = min(__popc(word), MAX_WG);
    s.w_chars[wid][at] = s.chr[j];
    s.w_scores[wid][at] = s.score[j];
    atomicMin(&s.w_y0[wid], y0);
    atomicMax(&s.w_y1[wid], y1);
    if (at == 0) {
      s.w_n[wid] = n;
      s.w_trunc[wid] = __popc(word) > MAX_WG;
      s.w_x0[wid] = x0;
    }
    if (at == n - 1) s.w_x1[wid] = x1;
  }
  if (j == 0) s.band_bad = (band.valid && (band.bh_full > WIN_H || s.n_g > MAX_GPB)) || __popc(starts) > MAX_WPB;
  __syncwarp();
  // Word o scans rows y_bot .. last - 1 (rows past h - BAR_H hold no bar),
  // each reading BAR_H rows: all below the band's first row, and above
  // by0 + min(height, WIN_H) + budget + BAR_H - 1 (y_bot <= by0 + WIN_H).
  int n = 0;
  if (j < MAX_WPB) {
    const int y_bot = s.w_y1[j];
    if (s.w_n[j] > 0 && y_bot >= BAR_H) {
      const int last = (int)min((int64_t)y_bot + budget, (int64_t)h - BAR_H + 1);
      n = max(last - y_bot, 0);
    }
    s.bar_key[j] = ~0ull;
  }
  int items = n;  // inclusive scan over the word lanes
#pragma unroll
  for (int d = 1; d < MAX_WPB; d <<= 1) {
    const int t = __shfl_up_sync(FULL, items, d);
    if (j >= d) items += t;
  }
  if (j < MAX_WPB) s.item0[j] = items - n;
  if (j == MAX_WPB - 1) s.item0[MAX_WPB] = items;
}

// Phase 5 for item i, by one warp: row y_bot + k below word o, from the
// staged black bit rows (row y at (y - by0) * sw). A row that holds a bar
// (src/vision/mpx_ratio.rs semantics, with the right-1 / left+1 steps and
// the column-0 sentinels) puts its key into the word's atomicMin.
__device__ void scan_item(Shared& s, const uint32_t* black, int by0, int sw, int w, int i) {
  const int lane = threadIdx.x & 31;
  int o = 0;
  while (o + 1 < MAX_WPB && s.item0[o + 1] <= i) ++o;
  const int k = i - s.item0[o];
  const int y = s.w_y1[o] + k;
  const int x = (s.w_x0[o] + s.w_x1[o]) / 2;  // both >= 0, x < w
  const int nk = (w + 31) >> 5;
  const uint32_t* row = black + (y - by0) * sw;
  if (!((row[x >> 5] >> (x & 31)) & 1u)) return;  // the anchor pixel is not black
  // a column holds the bar's black run: rows y .. y + BAR_H - 1 all black
  auto bar_word = [&](int kk) { return row[kk] & row[kk + sw] & row[kk + 2 * sw] & row[kk + 3 * sw]; };
  static_assert(BAR_H == 4, "bar_word ANDs four rows");
  int rx = w;
  for (int c0 = x >> 5; c0 < nk; c0 += 32) {
    const int kk = c0 + lane;
    uint32_t v = kk < nk ? bar_word(kk) : 0u;
    if (kk == (x >> 5)) v &= FULL << (x & 31);
    const uint32_t m = __ballot_sync(FULL, v != 0u);
    if (m) {
      const int l = __ffs(m) - 1;
      rx = 32 * (c0 + l) + __ffs(__shfl_sync(FULL, v, l)) - 1;
      break;
    }
  }
  if (rx >= w || rx == 0 || x == 0) return;  // x == 0: no column left of the anchor
  int lx = -1;
  const int kl = (x - 1) >> 5;
  for (int c0 = kl; c0 >= 0; c0 -= 32) {
    const int kk = c0 - lane;
    uint32_t v = kk >= 0 ? bar_word(kk) : 0u;
    if (kk == kl) v &= (2u << ((x - 1) & 31)) - 1u;  // columns <= x - 1
    const uint32_t m = __ballot_sync(FULL, v != 0u);
    if (m) {
      const int l = __ffs(m) - 1;
      lx = 32 * (c0 - l) + 31 - __clz(__shfl_sync(FULL, v, l));
      break;
    }
  }
  if (lx <= 0) return;  // none, or the column-0 sentinel
  if ((rx - 1) - (lx + 1) >= MIN_SCALE_WIDTH && lane == 0)
    atomicMin(&s.bar_key[o], ((unsigned long long)k << 26) | ((unsigned long long)lx << 13) | (unsigned long long)rx);
}

// Lane f of word slot o of the band, from the block's word arrays.
__device__ __forceinline__ int word_lane(const Shared& s, int o, int f) {
  const bool has = s.w_n[o] > 0;
  const unsigned long long key = s.bar_key[o];
  const bool found = has && s.w_y1[o] >= BAR_H && key != ~0ull;
  switch (f) {
    case 0: return s.w_n[o];
    case 1: return has ? s.w_x0[o] : 0;
    case 2: return has ? s.w_y0[o] : 0;
    case 3: return s.w_x1[o];
    case 4: return s.w_y1[o];
    case 5: return found;
    case 6: return found ? s.w_y1[o] + (int)(key >> 26) : 0;
    case 7: return found ? (int)((key >> 13) & 8191u) + 1 : 0;
    case 8: return found ? (int)(key & 8191u) - 1 : 0;
    case 9: return s.w_trunc[o];
    default: break;
  }
  if (f < 10 + MAX_WG) return s.w_chars[o][f - 10];
  if (f < 10 + 2 * MAX_WG) return min(max(s.w_scores[o][f - 10 - MAX_WG], -BIG), BIG);
  return 0;
}

// Header lane `lane` (block 0, after the last cluster barrier).
__device__ __forceinline__ int header_lane(const Shared& s, int T, int lane) {
  if (lane == 0) return min(s.n_bands, MAX_BANDS);
  if (lane == 1) return s.n_bands > MAX_BANDS ? FLAG_BAND_OVERFLOW : 0;
  if (lane == 2) return T;
  if (lane == 3) {
    int bits = 0;
    for (int b = 0; b < MAX_BANDS; ++b) bits |= s.bad[b] << b;
    return bits;
  }
  return 0;
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
    scales_read_kernel(const uint8_t* __restrict__ text, int64_t text_stride, const uint8_t* __restrict__ sbool,
                       int64_t sbool_stride, const float* __restrict__ tpl, int T, int h, int w, int budget,
                       int16_t* __restrict__ out) {
  __shared__ Shared s;
  extern __shared__ uint32_t bits[];  // staged bit rows, sw words a row: the band's text rows, then the black rows
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int64_t frame = blockIdx.x / CLUSTER;
  text += frame * text_stride;
  sbool += frame * sbool_stride;
  out += frame * REC_I16;
  const int nk = (w + 31) >> 5, sw = nk + PAD_WORDS;
  const int nrw = (h + 31) >> 5;
  const int wa = rank * nrw / CLUSTER, wb = (rank + 1) * nrw / CLUSTER;  // this block's row words
  const bool band_block = rank < MAX_BANDS;
  const int b = band_block ? rank : 0;
  uint32_t* black = bits + min(h, WIN_H) * sw;

  // 0. templates in, the header barrier, this block's row flags cleared
  if (band_block) start_templates(s, tpl, T);
  if (rank == 0 && tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(&s.hdr_bar)), "r"(MAX_BANDS) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < 8 * (wb - wa); i += THREADS) reinterpret_cast<uint32_t*>(s.rowflag)[i] = 0u;
  cluster_arrive();  // waited on before this block's memory is first written by another
  __syncthreads();

  // 1. the strip's text rows; the whole row bit set in every block; the bands
  const int r0 = min(32 * wa, h), r1 = min(32 * wb, h);
  for_nonzero(text + (int64_t)r0 * w, (int64_t)(r1 - r0) * w, MarkRows{s.rowflag, w});
  __syncthreads();
  uint32_t word = 0u;  // thread t < wb - wa: row word wa + t, from its 32 row flags
  if (tid < wb - wa) {
    const uint4* f = reinterpret_cast<const uint4*>(s.rowflag) + 2 * tid;
    word = nonzero_mask(f[0]) | (nonzero_mask(f[1]) << 16);
    s.rowbits[wa + tid] = word;
  }
  cluster_wait();  // every block has started
  if (tid < wb - wa)
    for (int dst = 0; dst < CLUSTER; ++dst)
      if (dst != rank) *cluster.map_shared_rank(s.rowbits + wa + tid, dst) = word;
  cluster.sync();  // every block's words are in every block; block 0's header barrier is initialised
  if (warp == 0) warp_runs(s.rowbits, h, MAX_BANDS, s.b_start, s.b_end, &s.n_bands);
  __syncthreads();
  const Band band = band_of(s, b, h);
  const bool live = band_block && band.valid;
  const Band lb{band.by0, band.bh_full, live};

  // 2. band b's first min(height, WIN_H) rows as bit rows, their columns, the
  //    glyph slots; in the same pass the scales plane's rows from the band's
  //    first row to the last row the bar scan can read, as black bit rows
  {
    const int rows = live ? min(band.bh_full, WIN_H) : 0;
    const int bar_rows = live ? (int)min((int64_t)h - band.by0, (int64_t)rows + budget + BAR_H - 1) : 0;
    stage_rows(Span{text + (int64_t)band.by0 * w, rows}, Span{sbool + (int64_t)band.by0 * w, bar_rows}, w,
               StoreWord{bits, black, sw});
    clear_pads(bits, rows, nk, sw);
    __syncthreads();
    if (warp == 0) {  // the column bit set: word k the OR of the rows' words k
      for (int k = tid; k < nk; k += 32) {
        uint32_t c = 0u;
#pragma unroll 8
        for (int r = 0; r < rows; ++r) c |= bits[r * sw + k];
        s.colbits[k] = c;
      }
      __syncwarp();
      warp_runs(s.colbits, w, MAX_GPB, s.g_start, s.g_end, &s.n_g);
    }
    __syncthreads();
  }

  // 3. the glyph windows: gate, resample, classify
  await_templates(s, rank);
  if (warp < MAX_GPB) classify_slot(s, bits, sw, lb, w, T, warp);
  __syncthreads();

  // 4. words
  if (warp == 0) group_band(s, lb, h, w, budget);
  __syncthreads();

  // 5. the bar scan: every (word, row) pair below the band's words
  for (int i = warp; i < s.item0[MAX_WPB]; i += WARPS) scan_item(s, black, band.by0, sw, w, i);
  __syncthreads();

  // 6. the record: the band's word slots, band_bad into block 0, which writes the header
  if (band_block) {
    // first: the arrive's release then covers no store to device memory
    if (tid == 0) {
      *cluster.map_shared_rank(s.bad + b, 0) = s.band_bad;
      mbar_arrive_remote(smem_addr(&s.hdr_bar), 0);
    }
    int16_t* words = out + HDR_I16 + b * MAX_WPB * WORD_I16;
    for (int i = tid; i < MAX_WPB * WORD_I16; i += THREADS) words[i] = (int16_t)word_lane(s, i / WORD_I16, i % WORD_I16);
  }
  if (rank == 0) {  // no block's memory is written after this wait
    mbar_wait(smem_addr(&s.hdr_bar), 0);
    if (tid < HDR_I16) out[tid] = (int16_t)header_lane(s, T, tid);
  }
}

}  // namespace

// text, sbool: B frames of H x W bytes (nonzero = True), frame b at
// + b * stride bytes (stride >= H * W); tpl: f32 [T, 192]; out: i16
// [B, REC_I16]; budget: scan_budget(W).
extern "C" int smh_scales_read(const void* text, int64_t text_stride, const void* sbool, int64_t sbool_stride,
                               const void* tpl, int T, int H, int W, int B, int budget, void* out, void* stream) {
  if (T < 1 || T > MAX_TEMPLATES || H < 1 || W < 1 || H > MAX_DIM || W > MAX_DIM || B < 1 || budget < 0 ||
      budget > MAX_BUDGET || text_stride < (int64_t)H * W || sbool_stride < (int64_t)H * W ||
      (reinterpret_cast<uintptr_t>(tpl) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  // The staged rows: a band's first WIN_H, and from its first row the
  // rows the bar scan can read (at most WIN_H + budget + BAR_H - 1), each
  // no more than the plane.
  const int64_t bar_rows = H < (int64_t)WIN_H + budget + BAR_H - 1 ? H : (int64_t)WIN_H + budget + BAR_H - 1;
  const size_t smem = staged_bytes((H < WIN_H ? H : WIN_H) + bar_rows, W);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  // Once per device, the largest shared memory any shape takes: the launch
  // then asks for what its own shape needs, and no thread changes the
  // limit between another's check and launch.
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(scales_read_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev].store(true, std::memory_order_release);
  }
  scales_read_kernel<<<B * CLUSTER, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), text_stride, static_cast<const uint8_t*>(sbool), sbool_stride,
      static_cast<const float*>(tpl), T, H, W, budget, static_cast<int16_t*>(out));
  return (int)cudaGetLastError();
}
