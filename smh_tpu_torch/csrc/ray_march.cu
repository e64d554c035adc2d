// Longest-line ray march: for each seed, 3600 rays (one per 0.1 degree),
// each marched until it leaves the plane or crosses a gap of more than
// max_gap non-white samples; then each seed's longest ray. One launch.
//
// Replaces smh_tpu/ops/lsd.py::_march_span + _finalize (XLA ops, not a
// Pallas kernel; entry find_longest_lines_batch). Each (seed, angle) lane
// follows the oracle's sequential state machine, bit for bit:
//
//   pos(k) = start + k * d, rounded twice (__fmul_rn, __fadd_rn: no FMA,
//            the plain version's two roundings);
//   a sample is white iff it is in the plane and the mask byte is 255;
//   abort at the first in-plane step that completes a run of max_gap + 1
//            non-white samples (samples before k = 0 count as white), with
//            the endpoint pos(k - max_gap - 1) (the closed form of
//            lsd.py:147-152);
//   at the first step out of the plane, the endpoint is that position less
//            one step if its saturating-cast pixel is in the plane and black
//            (byte 0), else the start (lsd.py:154-167);
//   a lane still alive after k_total steps keeps end = start, as a JAX lane
//            still alive after its last span does (the caller passes the
//            same span-rounded bound).
//
// Seeds lie inside the plane (the backend seeds from mask pixels), so a
// ray's in-plane steps are a prefix of k (positions are monotone in k).
//
// smh_ray_march_acc marches on the oracle's positions instead (upstream
// vision-cpu/src/lib.rs:387-449, and its GPU twin's one thread an angle):
//
//   pos(k) = off(k) + start, one rounding, where off(0) = 0 and off(k) =
//            off(k - 1) + d, each addition rounded (`x_off += dx`);
//   a ray that ends on a gap ends at pos(s) - d, s the gap's first sample,
//            if s's byte is 0, else at its start (the oracle restores the
//            gap's first position and takes the same final check as a ray
//            that left the plane).
//
// A thread takes its word's offsets by 32 real additions; a warp's lanes
// and the ends take off(k) by `advance`, which jumps over the additions of
// one binade exactly.
//
// The design, for an H100 (where the simple version paid one L2 round trip
// per step, since each step's test waited for its load):
//
// * Words of 32 steps. A position does not depend on any loaded byte; only
//   the stop does. So a word's 32 loads issue together and its samples
//   become bit words (white, in the plane, byte 0). `word_event` finds the
//   word's first event in step order with bit arithmetic: the gap run
//   carried in from earlier words (a count), a run that starts inside the
//   word (shift-and doubling, for max_gap + 1 <= 32), the first step out of
//   the plane, and the k_total bound. The run count carries to the next
//   word. One round trip per word, not per step.
// * A thread a lane for the first LANE_CHUNKS words: background rays die
//   within max_gap + 1 samples, so most lanes end in their first word.
// * Survivors (rays along a line) go to their block's queue in shared
//   memory. A seed's angles are split over a cluster of CLUSTER blocks, and
//   its survivors bunch around the lines' directions, in one or two blocks:
//   so every warp of the cluster takes survivors from the cluster's queues
//   (distributed shared memory, one counter in block 0), one at a time.
//   Lane l samples steps k0 + 32 w + l of WARP_WORDS words, `__ballot_sync`
//   makes the words, their in-word runs are found side by side, and the
//   warp takes their events in order as one thread would, while the next
//   round's loads are in flight. A long ray pays one round trip per
//   32 * WARP_WORDS steps.
// * One launch per batch, one cluster per seed. Each lane's squared length
//   and angle form a u64 key (f32 bits << 32 | angle; lengths are >= 0, so
//   their bits order as integers, and the higher angle wins a tie, as
//   finalize_plain's last argmax does). Each thread keeps the largest key
//   of the lanes it finished, each warp reduces by shuffles, each block by
//   a shared-memory atomicMax, and each block stores its key into block 0's
//   shared memory (distributed shared memory); after one cluster barrier,
//   block 0 takes the largest and reads the winner's end from L2 (another
//   block may have written it). Deterministic. Two cluster barriers in
//   all: one before the survivors, one before the result. Not a 64-bit
//   atomicMax into block 0's key: through distributed shared memory it
//   loses concurrent updates on the H100 (PERF.md §6).
// * What bounds it: latency, not bytes (the u8 mask sits in L2; the bytes
//   a call must read take ~0.3 us at 3.35 TB/s): the longest ray's warp
//   rounds, then the launch and the two barriers. `probe_ray_march.py`
//   splits a call that way and times other designs and constants as
//   patches of this source (the fused pass's bit plane instead of the u8
//   mask among them). The design and constants here are the fastest
//   (PERF.md §6); the entry takes the u8 mask.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;        // blocks per seed: one thread block cluster
constexpr int MAX_PER_BLOCK = 1024;  // angles a block holds in its queue
constexpr int MAX_THREADS = 512;
constexpr int WORD = 32;          // steps per word
constexpr int LANE_CHUNKS = 1;    // words a thread marches alone
constexpr int WARP_WORDS = 4;     // words a warp loads per round
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float pos(float o, float d, int k) {
  return __fadd_rn(o, __fmul_rn(d, (float)k));
}

// s with d added n times, each addition rounded to nearest even, exactly,
// without n dependent additions. While the sum stays in one binade every
// addition rounds to that binade's grid u, so the increment it adds is
// constant from the second addition that lands there (the first may round
// a tie from an odd multiple of u; the sums it lands on are even, and from
// an even multiple the tie goes the same way each time): three real
// additions a binade, then a jump to the binade's top at most. Rounding to
// nearest is symmetric, so d < 0 runs on -s and -d.
__device__ __forceinline__ float advance(float s, float d, int n) {
  if (n <= 0) return s;
  if (d == 0.f) return __fadd_rn(s, d);
  const bool neg = d < 0.f;
  const float a = fabsf(d);
  float t = neg ? -s : s;
  while (n > 0) {
    const float t1 = __fadd_rn(t, a);
    t = t1;
    if (--n == 0) break;
    const float t2 = __fadd_rn(t1, a);
    t = t2;
    if (--n == 0) break;
    const float t3 = __fadd_rn(t2, a);
    t = t3;
    if (--n == 0) break;
    // t1's binade [top / 2, top) and its grid u = top * 2^-24 (t1 >= a > 0 is normal).
    const int bits = (__float_as_int(t1) & 0x7f800000) + 0x00800000;
    const float top = __int_as_float(bits);
    if (t3 < top) {
      const float per_u = __int_as_float(0x8b000000 - bits);  // 1 / u = 2^24 / top, a power of two
      const float inc = __fsub_rn(t3, t2);  // exact: t2 and t3 share a binade
      const int steps = (int)__fmul_rn(inc, per_u);  // integers below 2^24: exact
      if (steps == 0) break;  // the sum no longer moves
      const int m = min(n, (int)__fmul_rn(__fsub_rn(top, t3), per_u) / steps);
      t = __fadd_rn(t3, __fmul_rn((float)m, inc));  // a multiple of u up to top: exact
      n -= m;
    }
  }
  return neg ? -t : t;
}

// A lane's ray. With ACC its positions are the oracle's: (bx, by) is the
// offset at step kb, from which `sample` advances (rebase moves it on).
template <bool ACC>
struct Ray {
  float x0, y0, dx, dy;
  float bx = 0.f, by = 0.f;
  int kb = 0;
  __device__ Ray(float x0_, float y0_, float dx_, float dy_) : x0(x0_), y0(y0_), dx(dx_), dy(dy_) {}
  __device__ void rebase(int k) {
    bx = advance(bx, dx, k - kb);
    by = advance(by, dy, k - kb);
    kb = k;
  }
  // The position of step k (k >= kb with ACC).
  __device__ float px(int k) const { return ACC ? __fadd_rn(advance(bx, dx, k - kb), x0) : pos(x0, dx, k); }
  __device__ float py(int k) const { return ACC ? __fadd_rn(advance(by, dy, k - kb), y0) : pos(y0, dy, k); }
};

// The byte at an in-range pixel.
__device__ __forceinline__ uint32_t pixel(const uint8_t* __restrict__ mask, int W, int cx, int cy) {
  return __ldg(mask + (int64_t)cy * W + cx);
}

// The sample at (px, py): sets `in` (in the plane) and returns the byte at
// its saturating-cast pixel (negatives clamp to 0), or 1 (neither black nor
// white) past the plane's far edges.
__device__ __forceinline__ uint32_t sample_at(const uint8_t* __restrict__ mask, int H, int W, float px, float py,
                                              bool& in) {
  in = px >= 0.f && py >= 0.f && px < (float)W && py < (float)H;
  const int cx = (int)fmaxf(px, 0.f);
  const int cy = (int)fmaxf(py, 0.f);
  return (cx < W && cy < H) ? pixel(mask, W, cx, cy) : 1u;
}

// Step k of ray r (sample_at).
template <bool ACC>
__device__ __forceinline__ uint32_t sample(const uint8_t* __restrict__ mask, int H, int W, const Ray<ACC>& r, int k,
                                           bool& in) {
  return sample_at(mask, H, W, r.px(k), r.py(k), in);
}

enum : int { EV_NONE = 0, EV_GAP = 1, EV_OUT = 2, EV_ALIVE = 3 };

// Steps k0 + S0 .. k0 + S1 - 1 of ray r into bits S0 .. S1 - 1 of the
// words (white: in the plane and 255; in the plane; byte 0), every load
// before any test. With ACC the offsets are taken one addition a step.
template <int S0, int S1, bool ACC>
__device__ __forceinline__ void lane_word(const uint8_t* __restrict__ mask, int H, int W, const Ray<ACC>& r, int k0,
                                          uint32_t& white, uint32_t& inb, uint32_t& black) {
  uint32_t v[S1 - S0];
  bool in[S1 - S0];
  if constexpr (ACC) {
    float ox = advance(r.bx, r.dx, k0 + S0 - r.kb), oy = advance(r.by, r.dy, k0 + S0 - r.kb);
#pragma unroll
    for (int s = S0; s < S1; ++s) {
      v[s - S0] = sample_at(mask, H, W, __fadd_rn(ox, r.x0), __fadd_rn(oy, r.y0), in[s - S0]);
      ox = __fadd_rn(ox, r.dx);
      oy = __fadd_rn(oy, r.dy);
    }
  } else {
#pragma unroll
    for (int s = S0; s < S1; ++s) v[s - S0] = sample(mask, H, W, r, k0 + s, in[s - S0]);
  }
#pragma unroll
  for (int s = S0; s < S1; ++s) {
    inb |= (uint32_t)in[s - S0] << s;
    white |= (uint32_t)(in[s - S0] && v[s - S0] == 255u) << s;
    black |= (uint32_t)(v[s - S0] == 0u) << s;
  }
}

// Steps of a word (bit j = step k0 + j) that complete a run of `window`
// non-white samples inside the word: bit j of the result is set iff bits
// j - window + 1 .. j of nw are (shift-and doubling; none if window > 32).
__device__ __forceinline__ uint32_t word_runs(uint32_t nw, int window) {
  if (window > WORD) return 0u;
  uint32_t t = nw;
  int len = 1;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    if (2 * len <= window) {
      t &= t << len;
      len *= 2;
    }
  }
  if (len < window) t &= t << (window - len);
  return t;
}

// The in-plane, in-bound steps of a word: the prefix before its first step
// out of the plane (out) and before the bound (valid = k_total - k0).
__device__ __forceinline__ uint32_t word_live(uint32_t inb, int valid, int& out) {
  out = inb == FULL ? WORD : __ffs(~inb) - 1;  // in-plane steps are a prefix
  const int lim = max(0, min(out, valid));
  return lim >= WORD ? FULL : (1u << lim) - 1u;
}

// The first event of the word of steps k0 .. k0 + 31, in step order, from
// its white and live words, its out-of-plane step and its in-word runs
// (word_runs of ~white & live); carry counts the non-white samples just
// before k0 (< window). Returns (kind, j): EV_GAP when step k0 + j
// completes the run (endpoint pos(k0 + j - window)); EV_OUT when step
// k0 + j is the first out of the plane; EV_ALIVE when the bound ends the
// march first; EV_NONE with carry updated otherwise.
__device__ __forceinline__ int word_event(uint32_t white, uint32_t live, int out, int valid, uint32_t runs,
                                          int window, int& carry, int& j) {
  // The run carried in reaches the window before the word's first white.
  const int z = white ? __ffs(white) - 1 : WORD;
  const int lim = __popc(live);
  int g = window - 1 - carry;
  if (g >= min(z, lim)) g = WORD;
  if (runs) g = min(g, __ffs(runs) - 1);
  if (g < WORD) {
    j = g;
    return EV_GAP;
  }
  if (out < WORD && out < valid) {
    j = out;
    return EV_OUT;
  }
  if (valid <= WORD) {
    j = valid;
    return EV_ALIVE;
  }
  carry = white ? __clz(white) : carry + WORD;
  return EV_NONE;
}

// The lane's end for an event of `kind` at step k (zero: the byte of that
// step's saturating-cast pixel is 0).
template <bool ACC>
__device__ __forceinline__ void event_end(const uint8_t* __restrict__ mask, int W, const Ray<ACC>& r, int kind, int k,
                                          bool zero, int window, float& ex, float& ey) {
  ex = r.x0;
  ey = r.y0;
  if constexpr (ACC) {
    // A gap ends at its first sample (in the plane), an exit at its step;
    // then one step back if that sample's byte is 0.
    if (kind == EV_GAP || kind == EV_OUT) {
      if (kind == EV_GAP) k -= window - 1;
      const float px = __fadd_rn(advance(0.f, r.dx, k), r.x0);
      const float py = __fadd_rn(advance(0.f, r.dy, k), r.y0);
      if (kind == EV_GAP) zero = pixel(mask, W, (int)px, (int)py) == 0u;
      if (zero) {
        ex = __fsub_rn(px, r.dx);
        ey = __fsub_rn(py, r.dy);
      }
    }
  } else if (kind == EV_GAP) {
    ex = pos(r.x0, r.dx, k - window);
    ey = pos(r.y0, r.dy, k - window);
  } else if (kind == EV_OUT && zero) {
    ex = __fsub_rn(pos(r.x0, r.dx, k), r.dx);
    ey = __fsub_rn(pos(r.y0, r.dy, k), r.dy);
  }
}

template <bool ACC>
__device__ __forceinline__ unsigned long long lane_key(const Ray<ACC>& r, float ex, float ey, int a) {
  const float lx = __fsub_rn(r.x0, ex);
  const float ly = __fsub_rn(r.y0, ey);
  const float len = __fadd_rn(__fmul_rn(lx, lx), __fmul_rn(ly, ly));
  return ((unsigned long long)__float_as_uint(len) << 32) | (unsigned)a;
}

__device__ __forceinline__ unsigned long long max_key(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

template <bool BATCH, bool ACC>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(MAX_THREADS)
ray_march_kernel(const uint8_t* __restrict__ mask, int64_t mask_stride, int H, int W, const float* __restrict__ pts,
                 const float* __restrict__ cosv, const float* __restrict__ sinv, int N, int max_gap,
                 int k_total, float* __restrict__ end_x, float* __restrict__ end_y,
                 float* __restrict__ best_x, float* __restrict__ best_y, float* __restrict__ best_len) {
  __shared__ int q_angle[MAX_PER_BLOCK];
  __shared__ int q_k0[MAX_PER_BLOCK];
  __shared__ int q_carry[MAX_PER_BLOCK];
  __shared__ int q_count, q_head;
  __shared__ unsigned long long s_key;
  __shared__ unsigned long long s_keys[CLUSTER];  // block 0: each block's key

  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.y;
  if constexpr (BATCH) mask += b * mask_stride;  // this seed's mask
  const int per = (N + CLUSTER - 1) / CLUSTER;
  const int a0 = blockIdx.x * per;
  const int a1 = min(N, a0 + per);
  const int window = max_gap + 1;
  const float x0 = pts[2 * b];
  const float y0 = pts[2 * b + 1];
  float* ex_row = end_x + (int64_t)b * N;
  float* ey_row = end_y + (int64_t)b * N;
  if (threadIdx.x == 0) {
    q_count = 0;
    q_head = 0;
    s_key = 0ull;
  }
  __syncthreads();
  unsigned long long key = 0ull;  // the best (length, angle) this thread finished

  // -- a thread a lane for the first LANE_CHUNKS words --------------------------
  for (int a = a0 + threadIdx.x; a < a1; a += blockDim.x) {
    const Ray<ACC> r{x0, y0, cosv[a], sinv[a]};
    int k0 = 0, carry = 0, kind = EV_NONE, j = 0;
    bool zero = false;
    for (int c = 0; c < LANE_CHUNKS && kind == EV_NONE; ++c, k0 += WORD) {
      if (k0 >= k_total) {
        kind = EV_ALIVE;
        break;
      }
      uint32_t white = 0, inb = 0, black = 0;
      const int valid = k_total - k0;
      int out;
      lane_word<0, WORD>(mask, H, W, r, k0, white, inb, black);
      const uint32_t live = word_live(inb, valid, out);
      kind = word_event(white, live, out, valid, word_runs(~white & live, window), window, carry, j);
      if (kind != EV_NONE) zero = (black >> min(j, WORD - 1)) & 1u;
    }
    if (kind == EV_NONE) {
      const int slot = atomicAdd(&q_count, 1);
      q_angle[slot] = a;
      q_k0[slot] = k0;
      q_carry[slot] = carry;
      continue;
    }
    float ex, ey;
    event_end(mask, W, r, kind, k0 - WORD + j, zero, window, ex, ey);
    ex_row[a] = ex;
    ey_row[a] = ey;
    key = max_key(key, lane_key(r, ex, ey, a));
  }
  cluster.sync();  // every block's queue is complete

  // -- the survivors, a warp a ray, from the queues of the whole cluster ----------
  // Item i of the cluster's queue is slot i - start[r] of block r's; lane r
  // of each warp holds start[r] (r < CLUSTER).
  const int lane = threadIdx.x & 31;
  const int rank = (int)cluster.block_rank();
  int count = 0;
  if (lane < CLUSTER) count = *cluster.map_shared_rank(&q_count, lane);
  int incl = count;
#pragma unroll
  for (int d = 1; d < CLUSTER; d <<= 1) {
    const int up = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += up;
  }
  const int start = incl - count;
  const int total = __shfl_sync(FULL, incl, CLUSTER - 1);
  // Each warp takes the next item from a counter, block 0's.
  int* head = cluster.map_shared_rank(&q_head, 0);
  for (;;) {
    int next = 0;
    if (lane == 0) next = atomicAdd(head, 1);
    const int item = __shfl_sync(FULL, next, 0);
    if (item >= total) break;
    const int owner = __popc(__ballot_sync(FULL, lane > 0 && lane < CLUSTER && item >= start));
    const int slot = item - __shfl_sync(FULL, start, owner);
    const int a = *cluster.map_shared_rank(q_angle + slot, owner);
    Ray<ACC> r{x0, y0, cosv[a], sinv[a]};
    int k0 = *cluster.map_shared_rank(q_k0 + slot, owner);
    int carry = *cluster.map_shared_rank(q_carry + slot, owner);
    if constexpr (ACC) r.rebase(k0 + lane);
    int kind = EV_NONE, j = 0;
    bool zero = false;
    uint32_t v[WARP_WORDS];
    bool in[WARP_WORDS];
#pragma unroll
    for (int w = 0; w < WARP_WORDS; ++w) v[w] = sample(mask, H, W, r, k0 + w * WORD + lane, in[w]);
    while (kind == EV_NONE) {
      if constexpr (ACC) r.rebase(k0 + WARP_WORDS * WORD + lane);  // the next round's loads advance from its first step
      uint32_t vn[WARP_WORDS];
      bool inn[WARP_WORDS];
#pragma unroll
      for (int w = 0; w < WARP_WORDS; ++w)  // the next round's loads, in flight while this round is tested
        vn[w] = sample(mask, H, W, r, k0 + (WARP_WORDS + w) * WORD + lane, inn[w]);
      uint32_t white[WARP_WORDS], live[WARP_WORDS], black[WARP_WORDS], runs[WARP_WORDS];
      int out[WARP_WORDS];
#pragma unroll
      for (int w = 0; w < WARP_WORDS; ++w) {  // the words' runs are independent of the carry
        const uint32_t inb = __ballot_sync(FULL, in[w]);
        white[w] = __ballot_sync(FULL, in[w] && v[w] == 255u);
        black[w] = __ballot_sync(FULL, v[w] == 0u);
        live[w] = word_live(inb, k_total - (k0 + w * WORD), out[w]);
        runs[w] = word_runs(~white[w] & live[w], window);
      }
#pragma unroll
      for (int w = 0; w < WARP_WORDS; ++w) {
        if (kind == EV_NONE) {
          if (k0 >= k_total) {
            kind = EV_ALIVE;
            j = 0;
          } else {
            kind = word_event(white[w], live[w], out[w], k_total - k0, runs[w], window, carry, j);
            if (kind != EV_NONE) zero = (black[w] >> min(j, WORD - 1)) & 1u;
          }
          k0 += WORD;
        }
      }
      if (kind == EV_NONE) {  // k0 is the next round's first step
#pragma unroll
        for (int w = 0; w < WARP_WORDS; ++w) {
          v[w] = vn[w];
          in[w] = inn[w];
        }
      }
    }
    if (lane == 0) {
      float ex, ey;
      event_end(mask, W, r, kind, k0 - WORD + j, zero, window, ex, ey);
      ex_row[a] = ex;
      ey_row[a] = ey;
      key = max_key(key, lane_key(r, ex, ey, a));
    }
  }

  // -- the seed's best: the largest key of the cluster, in block 0 ----------------
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) key = max_key(key, __shfl_xor_sync(FULL, key, d));
  if (lane == 0) atomicMax(&s_key, key);
  __syncthreads();
  if (threadIdx.x == 0) *cluster.map_shared_rank(s_keys + rank, 0) = s_key;
  cluster.sync();  // every end is written, every key is in, no block's memory is read after this
  if (rank == 0 && threadIdx.x == 0) {
    unsigned long long best = 0ull;
    for (int r = 0; r < CLUSTER; ++r) best = max_key(best, s_keys[r]);
    const int a = (int)(best & 0xffffffffu);
    best_x[b] = __ldcg(ex_row + a);  // another block's lane, perhaps: read from L2
    best_y[b] = __ldcg(ey_row + a);
    best_len[b] = __uint_as_float((uint32_t)(best >> 32));
  }
}

// One launch on `stream`: B clusters of CLUSTER blocks.
template <bool BATCH, bool ACC>
int launch(const void* mask, int64_t mask_stride, int H, int W, const void* pts, int B, const void* cosv,
           const void* sinv, int N, int max_gap, int k_total, void* end_x, void* end_y, void* best_x, void* best_y,
           void* best_len, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  const int per = (N + CLUSTER - 1) / CLUSTER;
  if (per > MAX_PER_BLOCK || max_gap < 0 || k_total < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const int rounded = (per + 31) / 32 * 32;
  const int threads = rounded < MAX_THREADS ? rounded : MAX_THREADS;
  ray_march_kernel<BATCH, ACC><<<dim3(CLUSTER, B), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), mask_stride, H, W, static_cast<const float*>(pts),
      static_cast<const float*>(cosv), static_cast<const float*>(sinv), N, max_gap, k_total,
      static_cast<float*>(end_x), static_cast<float*>(end_y), static_cast<float*>(best_x),
      static_cast<float*>(best_y), static_cast<float*>(best_len));
  return (int)cudaGetLastError();
}

}  // namespace

// mask: u8 [H, W]; pts: f32 [B, 2] (x, y); cosv, sinv: f32 [N]; end_x,
// end_y: f32 [B, N]; best_x, best_y, best_len: f32 [B]. Every seed marches
// the one mask.
extern "C" int smh_ray_march(const void* mask, int H, int W, const void* pts, int B, const void* cosv,
                             const void* sinv, int N, int max_gap, int k_total, void* end_x, void* end_y,
                             void* best_x, void* best_y, void* best_len, void* stream) {
  return launch<false, false>(mask, 0, H, W, pts, B, cosv, sinv, N, max_gap, k_total, end_x, end_y, best_x, best_y,
                              best_len, stream);
}

// smh_ray_march on the oracle's positions (the top of this file).
extern "C" int smh_ray_march_acc(const void* mask, int H, int W, const void* pts, int B, const void* cosv,
                                 const void* sinv, int N, int max_gap, int k_total, void* end_x, void* end_y,
                                 void* best_x, void* best_y, void* best_len, void* stream) {
  return launch<false, true>(mask, 0, H, W, pts, B, cosv, sinv, N, max_gap, k_total, end_x, end_y, best_x, best_y,
                             best_len, stream);
}

// smh_ray_march over B masks, one per seed: seed b's u8 [H, W] mask starts
// at mask + b * mask_stride (bytes, >= H * W).
extern "C" int smh_ray_march_masks(const void* mask, int64_t mask_stride, int H, int W, const void* pts, int B,
                                   const void* cosv, const void* sinv, int N, int max_gap, int k_total, void* end_x,
                                   void* end_y, void* best_x, void* best_y, void* best_len, void* stream) {
  if (mask_stride < (int64_t)H * W) return (int)cudaErrorInvalidValue;
  return launch<true, false>(mask, mask_stride, H, W, pts, B, cosv, sinv, N, max_gap, k_total, end_x, end_y, best_x,
                             best_y, best_len, stream);
}
