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
// and writes 8 budget + 28 bytes. The launch (~0.84 us) and a chain of
// dependent round trips (the tile's bytes, the look-back, the last tile's
// reads of every state, the ticket) cost more. Its first design (a cluster of 8
// blocks per frame, so 8 SMs of 132, every word a load -- four where a
// row's bytes are not 4-byte aligned, as at 4K -- a corrected f32 division
// a word for its row, the non-zero words loaded twice, a distributed
// shared memory exchange and a cluster barrier) took 5.49-5.81 us at 822 x
// 986 and 10.34-12.27 at 1644 x 1972 on an H100 (PERF.md). This design
// spreads a frame over many blocks and joins them with a single-pass scan,
// a decoupled look-back:
//
//  * a tile is whole rows, at most TILE_WORDS words, a block of THREADS
//    each: 13 tiles at 822 x 986 (104 blocks for a batch of 8, a block an
//    SM), 50 at 1644 x 1972 (tiles of half the words measured as fast or
//    slower on an H100, slower for a batch: 200 blocks on 132 SMs);
//  * a block's tile is its index: its look-back waits only on blocks of
//    lower indices, which the hardware dispatches no later (the order
//    CUB's single-pass scan relies on too). A tile from an atomic counter,
//    which needs no such order, measured 0.3-0.4 us slower on an H100
//    (its round trip heads the chain), and staging the index's tile under
//    that round trip slower still (PERF.md);
//  * it reads the tile's bytes with aligned 16-byte loads into shared
//    memory and forms each word there from two aligned 32-bit reads and a
//    funnel shift, so an odd row pitch costs nothing (a first cut that
//    loaded each word from device memory where the rows are whole u32s
//    measured slower on an H100); a thread's words lie
//    a block apart, their rows and columns stepped from the first (one
//    division a thread, none a word), all read before any is used, and
//    kept in registers for the write;
//  * a ballot a word and round gives the non-zero words, warp 0 scans the
//    (round, warp) counts and publishes the tile's count (an aggregate) at
//    once, then looks back: it reads the 32 tiles before its own, waits
//    while one has published nothing, and sums back to the nearest tile
//    with an inclusive prefix, then publishes its own;
//  * each block writes its non-zero words of rank < budget; the last tile
//    writes nz. The empty slots: those at or past the frame's word count
//    can never be written, and every tile's other warps clear a share of
//    them during the look-back; the rest, past nz, the last tile clears
//    (blocks that finished first helping it by chunks measured 3.5 us
//    faster on a sparse 4K mask at budget 32768 and 2.7 us slower at the
//    1080p map's top rung, 8192, on an H100: PERF.md);
//  * a tile's state is 16 bytes written and read as one vector: the flag
//    and count, its own bbox (16 bits a bound), the flag and count again.
//    A vector access is atomic only word by word, so a read counts as
//    published only where both flag words agree and neither bbox word is
//    0, which a published bbox never is (an empty one is 0xffff): a read
//    that saw part of a store shows as nothing published. The bbox words
//    do not change from the tile's first publish to its second. The last
//    tile publishes nothing (no tile reads it): its look-back done, it
//    reads every other tile's state for the frame's bbox, and writes it
//    with nz: no bbox atomics and no second pass;
//  * each block takes a ticket once it reads no more of the scratch: an
//    atomic add with release and acquire order, so every block's stores
//    to the scratch and its reads of it come before the ticket of the
//    frame's last block, and that block (the acquire, then a block
//    barrier) puts the scratch back to zero after them (the ticket and the
//    tiles' states). A relaxed ticket, 0.2-0.5 us faster on an H100, would
//    let that reset overtake another block's state store, which the next
//    launch would read. The last tile writes the bbox and nz after its
//    ticket, so its release waits on no store. Nothing is cleared before a
//    launch and no argument changes from call to call;
//  * measured on an H100 (PERF.md), the chain's round trips are ~0.15-0.25
//    us each (an atomic) and ~0.15 (a load), and every step of a block
//    takes some 500 cycles however little it does (a clock64 timeline of
//    each block, probe_mask_words).
//
// A batch is one launch: blockIdx.y selects the frame, whose bits start at
// bits + f * stride bytes, its output at out + f (7 + 2 budget) i32s and
// its scratch at scratch + f (HEAD + STATE tiles) u32s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = 4;                     // words a thread takes
constexpr int TILE_WORDS = THREADS * ROUNDS;  // words a tile holds at most: whole rows
constexpr int MAX_TILES = 4096;               // tiles a frame may have
constexpr int META = 7;                       // y0, y1, x0, x1, cy0, cx0, nz
constexpr int HEAD = 4;                       // u32 of a frame's scratch before its tiles' states
constexpr int STATE = 4;                      // u32 of a tile's state: flag and count, its bbox, flag and count again
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t AGGREGATE = 1u << 30;      // a tile's state: its own count
constexpr uint32_t PREFIX = 2u << 30;         // the count of every tile up to its own
constexpr uint32_t VALUE = (1u << 30) - 1u;
static_assert(ROUNDS * WARPS <= 64, "one warp scans the (round, warp) counts, two a lane");
static_assert((int64_t)MAX_TILES * TILE_WORDS <= VALUE, "a count fits a state");

struct Shared {
  alignas(16) uint8_t bytes[4 * TILE_WORDS + 48];  // the tile's bytes from the 16-byte chunk holding its first
  int count[ROUNDS * WARPS];  // non-zero words of (round, warp), then the rank of its first in the tile
  int box[WARPS][4];          // each warp's y0, y1, x0, x1
  int exclusive, inclusive;
  bool last;
};

// A tile's state, 16 bytes in one vector store: x = flag (2 bits) and
// count, y = y0 | y1 << 16, z = x0 | x1 << 16 (its own bbox; 0xffff each:
// none), w = x again. The store is atomic only word by word (flag_of).
__device__ __forceinline__ void put_state(uint32_t* p, uint32_t x, uint32_t y, uint32_t z) {
  asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %1};" ::"l"(p), "r"(x), "r"(y), "r"(z) : "memory");
}

__device__ __forceinline__ uint4 get_state(const uint32_t* p) {
  uint4 v;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

// The state's flag: 0 (nothing published, or a read that saw part of a
// store: the flag words differ, or a bbox word is still the scratch's 0),
// 1 (aggregate), 2 (prefix).
__device__ __forceinline__ uint32_t flag_of(const uint4& v) {
  return v.x == v.w && v.y != 0u && v.z != 0u ? v.x >> 30 : 0u;
}

// The frame's ticket: an atomic add, ordered after this block's accesses of
// the scratch (release) and before what follows it (acquire).
__device__ __forceinline__ unsigned take_ticket(uint32_t* p) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(p) : "memory");
  return old;
}

// The word with its pixels at columns >= W cleared (kernel 3 writes them 0).
__device__ __forceinline__ uint32_t inside(uint32_t v, int j, int W) {
  const int valid = W - 32 * j;  // pixels of the word inside the plane
  if (valid >= 32) return v;
  const uint32_t keep = (1u << valid) - 1u;         // pixels 0 .. valid - 1
  return v & __byte_perm(__brev(keep), 0, 0x0123);  // in the word's bit order
}

// Zeroes p[lo, hi), threads k = 0 .. n - 1 of the block together (this
// thread is k): 16-byte stores between the 16-byte boundaries.
__device__ __forceinline__ void clear(int32_t* p, int lo, int hi, int k, int n) {
  if (lo >= hi) return;
  const int b0 = min(hi, lo + (int)((4 - ((reinterpret_cast<uintptr_t>(p + lo) >> 2) & 3)) & 3));
  const int b1 = b0 + ((hi - b0) & ~3);  // p + b0 .. p + b1: 16-byte aligned
  for (int i = lo + k; i < b0; i += n) p[i] = 0;
  for (int i = b1 + k; i < hi; i += n) p[i] = 0;
  int4* q = reinterpret_cast<int4*>(p + b0);
  for (int i = k; i < (b1 - b0) >> 2; i += n) q[i] = make_int4(0, 0, 0, 0);
}

// Stages the bytes of rows row0 .. row0 + rows in dst, 16-byte chunks from
// the one holding their first byte, thread tid of the block taking chunks
// tid, tid + THREADS, ...; returns where the first byte lies in dst.
__device__ __forceinline__ int stage(uint8_t* dst, const uint8_t* bits, int row0, int rows, int bpr, int tid) {
  const uintptr_t first = reinterpret_cast<uintptr_t>(bits + (int64_t)row0 * bpr);
  const uint4* chunk = reinterpret_cast<const uint4*>(first & ~uintptr_t(15));
  const int lead = (int)(first & 15);
  const int chunks = (lead + rows * bpr + 15) >> 4;
  for (int c = tid; c < chunks; c += THREADS) reinterpret_cast<uint4*>(dst)[c] = __ldg(chunk + c);
  return lead;
}

__global__ void __launch_bounds__(THREADS)
    mask_words_kernel(const uint8_t* __restrict__ bits, int64_t stride, int H, int W, int bpr, int nw,
                      int tile_rows, int tiles, int step_rows, int step_cols, int budget,
                      uint32_t* __restrict__ scratch, int32_t* __restrict__ out) {
  constexpr int NC = ROUNDS * WARPS;  // (round, warp) counts
  constexpr int E = (NC + 31) / 32;   // counts a lane scans
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t frame = blockIdx.y;
  bits += frame * stride;
  out += frame * (int64_t)(META + 2 * budget);
  uint32_t* sc = scratch + frame * (int64_t)(HEAD + STATE * tiles);  // the ticket, pad; the tiles' states
  uint32_t* state = sc + HEAD;
  const int t = blockIdx.x;
  const int row0 = t * tile_rows;
  const int rows = min(tile_rows, H - row0);
  const int words = rows * nw;
  const int lead = stage(s.bytes, bits, row0, rows, bpr, tid);  // the tile's bytes into shared memory
  __syncthreads();

  // Word k = r THREADS + tid of the tile (row i[r], word j[r] of the row):
  // every round's word first, then the ballots of the non-zero words and
  // the bbox.
  int i[ROUNDS], j[ROUNDS];
  i[0] = tid / nw;
  j[0] = tid - i[0] * nw;
#pragma unroll
  for (int r = 1; r < ROUNDS; ++r) {
    j[r] = j[r - 1] + step_cols;
    i[r] = i[r - 1] + step_rows + (j[r] >= nw);
    j[r] -= j[r] >= nw ? nw : 0;
  }
  uint32_t v[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const bool in = r * THREADS + tid < words;
    const int o = in ? lead + i[r] * bpr + 4 * j[r] : 0;  // its first byte in s.bytes
    const uint32_t* al = reinterpret_cast<const uint32_t*>(s.bytes + (o & ~3));
    uint32_t word = __funnelshift_r(al[0], al[1], 8 * (o & 3));
    const int n = bpr - 4 * j[r];  // the row's bytes from the word's first
    if (n < 4) word &= (1u << (8 * n)) - 1u;
    v[r] = in ? inside(word, j[r], W) : 0u;
  }
  unsigned ballot[ROUNDS];
  int y0 = H, y1 = 0, x0 = W, x1 = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    ballot[r] = __ballot_sync(FULL, v[r] != 0u);
    if (v[r] != 0u) {
      const uint32_t d = __brev(__byte_perm(v[r], 0, 0x0123));  // bit p = pixel p
      y0 = min(y0, row0 + i[r]);
      y1 = max(y1, row0 + i[r] + 1);
      x0 = min(x0, 32 * j[r] + __ffs(d) - 1);
      x1 = max(x1, 32 * j[r] + 32 - __clz(d));
    }
  }
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r)
    if (lane == r) s.count[r * WARPS + warp] = __popc(ballot[r]);
  y0 = __reduce_min_sync(FULL, y0);
  y1 = __reduce_max_sync(FULL, y1);
  x0 = __reduce_min_sync(FULL, x0);
  x1 = __reduce_max_sync(FULL, x1);
  if (lane == 0) {
    s.box[warp][0] = y0;
    s.box[warp][1] = y1;
    s.box[warp][2] = x0;
    s.box[warp][3] = x1;
  }
  __syncthreads();

  // Slots at or past the frame's word count (all = H nw) are empty whatever
  // nz is: the other warps clear this tile's share of them while warp 0
  // scans and looks back.
  const int all = (int)min((int64_t)H * nw, (int64_t)budget);
  int32_t* idx = out + META;
  int32_t* dat = idx + budget;
  if (warp > 0) {
    const int share = (budget - all + tiles - 1) / tiles;
    const int lo = all + t * share, hi = min(budget, lo + share);
    clear(idx, lo, hi, tid - 32, THREADS - 32);
    clear(dat, lo, hi, tid - 32, THREADS - 32);
  }

  const bool last_tile = t == tiles - 1;
  uint32_t ry0 = 0xffffu, ry1 = 0u, rx0 = 0xffffu, rx1 = 0u;  // the last tile's: the frame's bbox
  if (warp == 0) {
    // The (round, warp) counts' ranks in the tile, and the tile's count and
    // bbox, published at once.
    int c[E], sum = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      c[e] = lane * E + e < NC ? s.count[lane * E + e] : 0;
      sum += c[e];
    }
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += up;
    }
    int rank = inc - sum;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (lane * E + e < NC) s.count[lane * E + e] = rank;
      rank += c[e];
    }
    const int total = __shfl_sync(FULL, inc, 31);
    const int by0 = __reduce_min_sync(FULL, lane < WARPS ? s.box[lane][0] : H);
    const int by1 = __reduce_max_sync(FULL, lane < WARPS ? s.box[lane][1] : 0);
    const int bx0 = __reduce_min_sync(FULL, lane < WARPS ? s.box[lane][2] : W);
    const int bx1 = __reduce_max_sync(FULL, lane < WARPS ? s.box[lane][3] : 0);
    const uint32_t by = by1 > 0 ? (uint32_t)by0 | (uint32_t)by1 << 16 : 0xffffu;  // none: y0 past every row, y1 0
    const uint32_t bx = by1 > 0 ? (uint32_t)bx0 | (uint32_t)bx1 << 16 : 0xffffu;
    uint32_t* mine = state + STATE * t;
    if (lane == 0 && !last_tile) put_state(mine, (t == 0 ? PREFIX : AGGREGATE) | (uint32_t)total, by, bx);
    // The look-back: the count of every tile before this one.
    int exclusive = 0;
    if (t > 0) {
      int pred = t - 1;  // the window's nearest tile, at lane 0
      while (true) {
        const int q = pred - lane;
        const uint4 st = q >= 0 ? get_state(state + STATE * q) : make_uint4(PREFIX, 0xffffu, 0xffffu, PREFIX);  // before tile 0
        const uint32_t flag = flag_of(st);
        const unsigned pre = __ballot_sync(FULL, flag == 2u);
        const int stop = pre ? __ffs(pre) - 1 : 31;  // the nearest tile with its prefix
        if (__any_sync(FULL, lane <= stop && flag == 0u)) continue;  // a tile up to it has published nothing yet
        exclusive += __reduce_add_sync(FULL, lane <= stop ? (unsigned)(st.x & VALUE) : 0u);
        if (pre) break;
        pred -= 32;
      }
      if (lane == 0 && !last_tile) put_state(mine, PREFIX | (uint32_t)(exclusive + total), by, bx);
    }
    if (last_tile) {
      // The frame's bbox from its own and every other tile's state (each
      // published by now, or about to be: a read shows a flag once it is).
      if (lane == 0) {
        ry0 = by & 0xffffu;
        ry1 = by >> 16;
        rx0 = bx & 0xffffu;
        rx1 = bx >> 16;
      }
      for (int q = lane; q < tiles - 1; q += 32) {
        uint4 st;
        do {
          st = get_state(state + STATE * q);
        } while (flag_of(st) == 0u);
        ry0 = min(ry0, st.y & 0xffffu);
        ry1 = max(ry1, st.y >> 16);
        rx0 = min(rx0, st.z & 0xffffu);
        rx1 = max(rx1, st.z >> 16);
      }
      ry0 = __reduce_min_sync(FULL, ry0);
      ry1 = __reduce_max_sync(FULL, ry1);
      rx0 = __reduce_min_sync(FULL, rx0);
      rx1 = __reduce_max_sync(FULL, rx1);
    }
    if (lane == 0) {
      s.exclusive = exclusive;
      s.inclusive = exclusive + total;
    }
  }
  __syncthreads();
  const int base = s.exclusive;
  const int inc = s.inclusive;
  // The block reads no more of the scratch after this (the barrier orders
  // warp 0's reads before the ticket): its ticket's round trip runs under
  // the writes.
  unsigned ticket = 0u;
  if (tid == 0) {
    ticket = take_ticket(sc);
    if (last_tile) {
      const bool empty = ry1 == 0u;
      out[0] = empty ? H : (int)ry0;
      out[1] = (int)ry1;
      out[2] = empty ? W : (int)rx0;
      out[3] = (int)rx1;
      out[4] = 0;
      out[5] = 0;
      out[6] = inc;
    }
  }

  if (base < budget) {
    const unsigned below = (1u << lane) - 1u;
    const int64_t k0 = (int64_t)row0 * nw;  // the tile's first word's index
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      if (v[r] == 0u) continue;
      const int at = base + s.count[r * WARPS + warp] + __popc(ballot[r] & below);
      if (at < budget) {
        idx[at] = (int32_t)(k0 + r * THREADS + tid);
        dat[at] = (int32_t)v[r];
      }
    }
  }
  // The other empty slots, [min(nz, all), all): no block writes them.
  if (last_tile) {
    clear(idx, min(inc, all), all, tid, THREADS);
    clear(dat, min(inc, all), all, tid, THREADS);
  }

  // The frame's last block to take its ticket (every block has then read
  // all it reads of the scratch and stored all it stores there; the ticket
  // acquired that, and the barrier passes it to every thread): the scratch
  // back to zero.
  if (tid == 0) s.last = ticket == (unsigned)tiles - 1u;
  __syncthreads();
  if (!s.last) return;
  if (tid == 0) sc[0] = 0u;  // the ticket
  for (int q = tid; q < STATE * tiles; q += THREADS) state[q] = 0u;
}

}  // namespace

// Tiles of an H-row frame of W columns (rows of a tile: TILE_WORDS / nw), or
// -1 where it has more than 0xffff rows or columns, a row more than
// TILE_WORDS words or the frame more than MAX_TILES tiles.
extern "C" int smh_mask_words_tiles(int H, int W) {
  if (H <= 0 || W <= 0 || H > 0xffff || W > 0xffff) return -1;  // a state's bbox: 16 bits a bound
  const int nw = ((W + 7) / 8 + 3) / 4;
  if (nw > TILE_WORDS) return -1;
  const int tile_rows = TILE_WORDS / nw;
  const int tiles = (H + tile_rows - 1) / tile_rows;
  return tiles <= MAX_TILES ? tiles : -1;
}

// B frames: frame f's bit plane, H rows of (W + 7) / 8 bytes, at bits + f *
// stride (bytes); its output, i32 [7 + 2 budget], at out + f (7 + 2 budget).
// scratch: B (HEAD + STATE tiles) u32s (scratch_words), all zero, used by no
// launch that may run at the same time (the wrapper keeps one per device
// and stream); every launch leaves it zero.
extern "C" int smh_mask_words(const void* bits, int64_t stride, int H, int W, int B, int budget, void* scratch,
                              int64_t scratch_words, void* out, void* stream) {
  const int tiles = smh_mask_words_tiles(H, W);
  if (tiles < 0 || B <= 0 || B > 65535 || budget < 0 || scratch_words < (int64_t)B * (HEAD + STATE * tiles))
    return (int)cudaErrorInvalidValue;
  const int bpr = (W + 7) / 8;
  const int nw = (bpr + 3) / 4;
  mask_words_kernel<<<dim3(tiles, B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), stride, H, W, bpr, nw, TILE_WORDS / nw, tiles, THREADS / nw, THREADS % nw,
      budget, static_cast<uint32_t*>(scratch), static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
