// The fused pass's tail: the ui checksum, the red gate and the hostpack,
// in one launch.
//
// Replaces the last region of smh_tpu's jitted fused pass (XLA ops, not a
// Pallas kernel; smh_tpu/ops/pipeline.py::_analyze_flat_core): the ui
// checksum _weighted_check(ui_flat) (:340, taken at :636), the red gate
// _red_gate_roi (:528) and the hostpack's assembly in _pack_outputs
// (:792-886, the jnp.concatenate at :886). The plain twin is
// smh_tpu_torch/ops/kernels.py::hostpack_tail_plain; every output byte
// equals it. Per frame it writes one hostpack row:
//
//   red      f32 count * (1 / n): the share of the n button pixels (BGR,
//            interleaved) whose R, G and B each lie within `tol` of the
//            button's colour, each step rounded once as XLA rounds it
//   ui_check u32 sum and sum of (y + 1) (x + 7) v over the ui plane, mod
//            2^32: v is the luma (one plane) or r + g + b (three planes)
//   sections the other sections' bytes, copied from the buffers the pass's
//            kernels wrote: a table of (source, frame stride, offset, bytes)
//
// at the offsets of hostpack_layout (red at red_off, ui_check at ui_off; a
// negative red_off leaves the red gate out). No memset: every byte of the
// row is written, and no offset or row need be aligned.
//
// What bounds it on an H100: the launch and one round trip of loads and
// of the reduction's atomics. Its bytes are the ui plane read once (0.81 MB
// for the 1080p map's luma: 0.24 us at 3.35 TB/s; 3.24 MB at 4K), the
// button and the sections (~40 KB). Design:
//
//  * where each frame's planes are contiguous (the fused pass's luma and
//    its r, g, b planes), a thread sums aligned 16-byte chunks of a plane,
//    a chunk within a row by four __dp4a for its sum and four for its
//    sum of offset * pixel, the row's weight applied once, and a chunk
//    across a row's end (or the plane's ends, or a plane under 16 px wide)
//    byte by byte; the planes' misalignments differ, and the checksum is
//    linear, so each plane is chunked on its own. Other planes (a window,
//    the mesh's interleaved colour ui) by quads of 4 pixels of a row, each
//    the aligned 32-bit words that hold it (__funnelshift_r) or bytes
//    where pixels lie `step` > 1 bytes apart. All in u32: mod 2^32 is exact
//    in that ring, and a 4K plane of 255s wraps the weighted sum;
//  * a block of 256 threads, one chunk a thread, at most 4 blocks an SM
//    over the launch (a loop takes the rest; 198 blocks at the 1080p map,
//    528 at 4K, 66 a frame for 8 frames);
//  * the button's pixels and the sections' bytes spread over every block
//    of the frame, the sections as one index space (they lie back to back
//    in the row), read from a __grid_constant__ table;
//  * the three sums are added into the frame's three u64 slots of a
//    scratch that every launch leaves zeroed (each slot on its own 128-byte
//    line), as kernel 6 adds its checksums: each block adds 2^48 + its u32
//    partial, so the top 16 bits count the blocks in, and the thread whose
//    add finds every other block's there writes its section's 4 bytes and
//    zeroes the slot. No memset before the launch, no fence and no ticket.
//
// Its designs on an H100 (device us at 822 x 986 / 1644 x 1972 / 8 frames
// of 822 x 986; chip_smoke.py and probe_hostpack.py, PERF.md): a warp a
// row, a lane a quad, one load in flight a lane, 5.8 / 9.3 / - (in the sync
// frame); quads a grid's width apart, a 64-bit division a quad, 4.5 / 7.5 /
// 10.3; every load of a thread's first share issued before any use, the
// table's loops unrolled, 5.7 / 7.7 / 11.2 (more code, slower); the table a
// __grid_constant__, plain loops, 4.1 / 6.2 / 10.1; 16-byte chunks, two a
// thread, 3.8 / 3.7 / 7.2; one a thread (this design) 3.2 / 3.6 / 6.9-7.6.
// Past an empty kernel (0.95) it is the reduction and its atomics' round
// trip (2.0-2.2 with no ui, button or section) and one load round trip. A
// clock64 timeline of every block (probe_hostpack.py, 822 x 986; cycles,
// median / slowest block): the ui loads 1150 / 2790, the button 70 / 620,
// the sections 190 / 1120, the block's reduction 120 / 180, the slot
// atomic's return 770 / 1610; 2700 / 4000 in all. Designs that lost to it
// in turns (probe_hostpack.py, the same card): one loop of steps whose
// every load (1, 2 or 4 chunks a thread, a button pixel, a section byte)
// issues before any use, 3.3 / 4.8 / 7.1 (2 chunks 4.0 / 4.0 / 7.1, 4
// chunks 4.9 / 4.6 / 8.3); thread block clusters gathering their blocks'
// partials in the first block's shared memory (one cluster barrier)
// before one add each, clusters of 8 4.0 / 5.8 / 10.3, of 16 3.9 / 5.7 /
// 10.6; 1024-thread blocks in clusters of 16, 4 chunks a thread, one
// cluster and no add a frame at 822 x 986, 8.6 / 6.9 / 16.5.
//
// A batch of B frames is one launch: blockIdx.y selects the frame, whose
// planes, button and sections start their frame strides after the previous
// frame's, and whose row starts `out_stride` bytes after it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QUADS_AT_ONCE = 4;   // strided planes: quads a thread loads before it sums them
constexpr int CHUNKS_AT_ONCE = 1;  // contiguous planes: 16-byte chunks a thread loads before it sums them
constexpr int BLOCKS_PER_SM = 4;   // the launch's blocks, at most, over every frame
constexpr int MAX_SECTIONS = 16;
constexpr int SLOTS = 3;           // u64 slots of the scratch a frame: ui sum, ui weighted sum, red count
constexpr int SLOT_STRIDE = 16;    // u64s between slots: one 128-byte line each
constexpr int COUNT_SHIFT = 48;    // a slot: the blocks added (16 bits), their u32 partials' sum
constexpr unsigned FULL = 0xffffffffu;

struct Section {
  const uint8_t* src;
  int64_t stride;  // bytes between the frames' copies
  int64_t start;   // its first byte among the sections' bytes
};

// The sections lie back to back in the row from `off`, `bytes` in all.
struct Sections {
  Section s[MAX_SECTIONS];
  int n;
  int64_t off, bytes;
};

struct Planes {
  const uint8_t* p[3];
  int64_t step, pitch, stride;  // bytes between pixels, rows and frames
  int h, w;
};

struct Button {
  const uint8_t* p;  // n pixels of B, G, R bytes
  int64_t stride;
  int n;
  int r, g, b, tol;
};

// Pixels x .. x + 3 (x >= 0 a multiple of 4) of a plane row as a
// little-endian word, pixels past w zero: with step 1, the aligned words
// that hold them, shifted into place; else byte by byte.
__device__ __forceinline__ uint32_t load_quad(const uint8_t* __restrict__ row, int x, int w, int64_t step) {
  const int n = min(w - x, 4);  // pixels of the quad inside the row
  if (step != 1) {
    uint32_t v = 0u;
    for (int i = 0; i < n; ++i) v |= (uint32_t)__ldg(row + (x + i) * step) << (8 * i);
    return v;
  }
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + x);
  const uint32_t* al = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const int sh = (int)(a & 3);
  const uint32_t lo = __ldg(al);
  const uint32_t hi = (sh != 0 && 4 - sh < n) ? __ldg(al + 1) : 0u;
  const uint32_t v = __funnelshift_r(lo, hi, 8 * sh);
  return n == 4 ? v : v & ((1u << (8 * n)) - 1u);
}

// Adds the 16 bytes of a plane's aligned chunk whose byte 0 is pixel i0 of
// a contiguous h x w plane of n = h w pixels (bytes outside [0, n) are not
// the plane's). One row: by __dp4a, the row's weight once; else (a row's
// end, the plane's ends, w < 16) byte by byte.
__device__ __forceinline__ void add_chunk(const uint4 v, int i0, int n, int w, uint32_t& sum, uint32_t& wsum) {
  if (i0 >= 0 && i0 + 16 <= n) {
    const int row = i0 / w, col = i0 - row * w;
    if (col + 16 <= w) {
      const uint32_t s1 = __dp4a(v.x, 0x01010101u, __dp4a(v.y, 0x01010101u,
                          __dp4a(v.z, 0x01010101u, __dp4a(v.w, 0x01010101u, 0u))));
      const uint32_t s2 = __dp4a(v.x, 0x03020100u, __dp4a(v.y, 0x07060504u,
                          __dp4a(v.z, 0x0b0a0908u, __dp4a(v.w, 0x0f0e0d0cu, 0u))));  // sum of b p_b
      sum += s1;
      wsum += (uint32_t)(row + 1) * ((uint32_t)(col + 7) * s1 + s2);
      return;
    }
  }
  const int b0 = max(0, -i0), b1 = min(16, n - i0);
  if (b0 >= b1) return;
  int row = (i0 + b0) / w, col = i0 + b0 - row * w;
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (b < b0 || b >= b1) continue;
    const uint32_t px = (words[b >> 2] >> (8 * (b & 3))) & 0xffu;
    sum += px;
    wsum += (uint32_t)(row + 1) * (uint32_t)(col + 7) * px;
    if (++col == w) {
      col = 0;
      ++row;
    }
  }
}

__device__ __forceinline__ void store_u32(uint8_t* at, uint32_t v) {
#pragma unroll
  for (int k = 0; k < 4; ++k) at[k] = (uint8_t)(v >> (8 * k));
}

__device__ __forceinline__ uint32_t is_red(const uint8_t* __restrict__ px, const Button& btn) {
  const int bb = __ldg(px), gg = __ldg(px + 1), rr = __ldg(px + 2);
  return (abs(btn.r - rr) <= btn.tol) & (abs(btn.g - gg) <= btn.tol) & (abs(btn.b - bb) <= btn.tol);
}

// NP: the ui planes (1 or 3); FLAT: each frame's planes contiguous (pitch
// w, step 1). The table is a __grid_constant__: a loop indexing it at run
// time reads the parameter bank in place (a plain by-value parameter
// indexed so is first copied to each thread's local memory).
template <int NP, bool FLAT>
__global__ void __launch_bounds__(THREADS)
    hostpack_kernel(const Planes ui, const Button btn, const __grid_constant__ Sections sec,
                    uint8_t* __restrict__ out, int64_t out_stride, int red_off, int ui_off,
                    unsigned long long* __restrict__ scratch) {
  __shared__ uint32_t part[WARPS][SLOTS];
  const int64_t f = blockIdx.y;
  out += f * out_stride;
  scratch += SLOTS * SLOT_STRIDE * f;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gt = blockIdx.x * THREADS + tid;  // this thread among the frame's
  const int gn = gridDim.x * THREADS;
  uint32_t sum = 0u, wsum = 0u;

  if (FLAT) {
    // The ui checksum over each plane's aligned 16-byte chunks: chunk j of
    // plane c starts 16 j bytes past the plane's first byte rounded down to
    // 16, and holds pixels 16 j - s_c .. + 15 (s_c: that rounding). The
    // planes' chunks are counted one after another; h w < 2^32.
    const int n = ui.h * ui.w;
    const uint4* base[NP];
    int shift[NP], first[NP + 1];
    first[0] = 0;
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      const uintptr_t a = reinterpret_cast<uintptr_t>(ui.p[c] + f * ui.stride);
      base[c] = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
      shift[c] = (int)(a & 15);
      first[c + 1] = first[c] + (shift[c] + n + 15) / 16;
    }
    for (int j0 = gt; j0 < first[NP]; j0 += CHUNKS_AT_ONCE * gn) {
      uint4 v[CHUNKS_AT_ONCE];
      int i0[CHUNKS_AT_ONCE];
#pragma unroll
      for (int k = 0; k < CHUNKS_AT_ONCE; ++k) {
        const int j = j0 + k * gn;
        int c = 0;
#pragma unroll
        for (int d = 1; d < NP; ++d) c += j >= first[d];
        i0[k] = j < first[NP] ? 16 * (j - first[c]) - shift[c] : n;  // past the planes: no pixel
        v[k] = j < first[NP] ? __ldg(base[c] + (j - first[c])) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < CHUNKS_AT_ONCE; ++k) add_chunk(v[k], i0[k], n, ui.w, sum, wsum);
    }
  } else {
    // The ui checksum over quads: quad q is pixels 4 (q % qpr) .. + 3 of row
    // q / qpr (h qpr < 2^31); a thread's quads lie gn apart, their rows and
    // columns stepped from its first.
    const int qpr = (ui.w + 3) >> 2;
    const int quads = ui.h * qpr;
    const int dy = gn / qpr, dc = gn % qpr;
    int y = gt / qpr, col = gt % qpr;  // this thread's next quad
    for (int q0 = gt; q0 < quads; q0 += QUADS_AT_ONCE * gn) {
      uint32_t v[QUADS_AT_ONCE][NP];
      int ys[QUADS_AT_ONCE], xs[QUADS_AT_ONCE];
#pragma unroll
      for (int k = 0; k < QUADS_AT_ONCE; ++k) {
        ys[k] = y;
        xs[k] = q0 + k * gn < quads ? 4 * col : ui.w;  // past the plane: no pixel
        col += dc;
        y += dy;
        if (col >= qpr) {
          col -= qpr;
          ++y;
        }
        const int64_t at = f * ui.stride + (int64_t)ys[k] * ui.pitch;
#pragma unroll
        for (int c = 0; c < NP; ++c) v[k][c] = xs[k] < ui.w ? load_quad(ui.p[c] + at, xs[k], ui.w, ui.step) : 0u;
      }
#pragma unroll
      for (int k = 0; k < QUADS_AT_ONCE; ++k) {
        uint32_t s1 = 0u, s2 = 0u;
#pragma unroll
        for (int c = 0; c < NP; ++c) {
          s1 += __dp4a(v[k][c], 0x01010101u, 0u);  // the quad's pixels
          s2 += __dp4a(v[k][c], 0x03020100u, 0u);  // and their offsets in the quad
        }
        sum += s1;
        wsum += (uint32_t)(ys[k] + 1) * ((uint32_t)(xs[k] + 7) * s1 + s2);
      }
    }
  }

  // The red gate's count.
  uint32_t red = 0u;
  const uint8_t* bp = btn.p + f * btn.stride;
  for (int64_t i = gt; i < btn.n; i += gn) red += is_red(bp + 3 * i, btn);

  // The sections' bytes, one index space over all of them, grid-stride: byte
  // t is byte t - start of the last section starting at or before it.
  for (int64_t t = gt; t < sec.bytes; t += gn) {
    int s = 0;
    while (s + 1 < sec.n && sec.s[s + 1].start <= t) ++s;
    out[sec.off + t] = __ldg(sec.s[s].src + f * sec.s[s].stride + (t - sec.s[s].start));
  }

  sum = __reduce_add_sync(FULL, sum);
  wsum = __reduce_add_sync(FULL, wsum);
  red = __reduce_add_sync(FULL, red);
  if (lane == 0) {
    part[warp][0] = sum;
    part[warp][1] = wsum;
    part[warp][2] = red;
  }
  __syncthreads();
  if (tid < SLOTS) {  // slot tid: the block's partial into the frame's slot
    uint32_t v = 0u;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) v += part[k][tid];
    unsigned long long* slot = scratch + tid * SLOT_STRIDE;
    const unsigned long long old = atomicAdd(slot, (1ull << COUNT_SHIFT) | v);
    if ((old >> COUNT_SHIFT) == gridDim.x - 1) {  // every other block's partial is in
      const uint32_t total = (uint32_t)(old + v);  // the low 32 bits: the u32 sum
      *slot = 0ull;
      if (tid < 2) {
        store_u32(out + ui_off + 4 * tid, total);
      } else if (red_off >= 0) {
        const float recip = __fdiv_rn(1.0f, __int2float_rn(btn.n));
        store_u32(out + red_off, __float_as_uint(__fmul_rn(__uint2float_rn(total), recip)));
      }
    }
  }
}

}  // namespace

// B frames. The ui plane(s): n_planes (1 or 3) planes of h x w pixels,
// `step` bytes apart in a row, rows `pitch` apart, frame f's at p_c + f *
// stride. The button: btn_px pixels of B, G, R bytes at btn + f *
// btn_stride (btn may be null with btn_px 0 and red_off -1), tested against
// (r, g, b) +- tol. table: n_sections rows of int64 (source address, frame
// stride, offset, bytes), each section starting where the one before ends.
// Frame f's row starts at out + f * out_stride; red_off and ui_off are the
// offsets of the red ratio (negative: none) and of the ui checksum.
// scratch: SLOTS * SLOT_STRIDE * B u64s, all zero, used by no launch that
// may run at the same time (the wrapper keeps one per device and stream);
// every launch leaves it zero. h and w below 2^16.
extern "C" int smh_hostpack(const void* p0, const void* p1, const void* p2, int n_planes, int64_t step,
                            int64_t pitch, int64_t stride, int h, int w, const void* btn, int64_t btn_stride,
                            int btn_px, int r, int g, int b, int tol, const void* table, int n_sections, void* out,
                            int64_t out_stride, int red_off, int ui_off, int B, void* scratch, void* stream) {
  if ((n_planes != 1 && n_planes != 3) || h <= 0 || w <= 0 || h > 65535 || w > 65535 || step <= 0 || B <= 0 ||
      B > 65535 || n_sections < 0 || n_sections > MAX_SECTIONS || btn_px < 0 || (red_off >= 0 && btn_px == 0) ||
      ui_off < 0 || (reinterpret_cast<uintptr_t>(scratch) & 7) != 0)
    return (int)cudaErrorInvalidValue;
  Planes ui{{static_cast<const uint8_t*>(p0), static_cast<const uint8_t*>(p1), static_cast<const uint8_t*>(p2)},
            step, pitch, stride, h, w};
  Button bt{static_cast<const uint8_t*>(btn), btn_stride, btn_px, r, g, b, tol};
  Sections sec{};
  sec.n = n_sections;
  const int64_t* rows = static_cast<const int64_t*>(table);
  sec.off = n_sections > 0 ? rows[2] : 0;
  for (int s = 0; s < n_sections; ++s) {
    if (rows[4 * s + 3] <= 0 || rows[4 * s + 2] != sec.off + sec.bytes) return (int)cudaErrorInvalidValue;
    sec.s[s] = Section{reinterpret_cast<const uint8_t*>(rows[4 * s]), rows[4 * s + 1], sec.bytes};
    sec.bytes += rows[4 * s + 3];
  }
  // Blocks a frame: enough for each thread's share of the plane
  // (CHUNKS_AT_ONCE chunks or QUADS_AT_ONCE quads), at most BLOCKS_PER_SM
  // an SM over the whole launch (the loop takes the rest), at least one;
  // more where the button or the sections would give a thread more than 2
  // pixels or 8 bytes; at most 65535 (the slots count the blocks in 16
  // bits).
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
  const bool flat = step == 1 && pitch == w && (int64_t)h * w <= (1 << 30);
  const int64_t per_thread = flat ? 16 * CHUNKS_AT_ONCE : 4 * QUADS_AT_ONCE;  // pixels of a plane
  int64_t blocks = ((int64_t)h * w + per_thread * THREADS - 1) / (per_thread * THREADS);
  const int64_t most = BLOCKS_PER_SM * n_sm / B > 1 ? BLOCKS_PER_SM * n_sm / B : 1;
  if (blocks > most) blocks = most;
  int64_t by_bytes = (btn_px / 2 + THREADS - 1) / THREADS;
  if ((sec.bytes / 8 + THREADS - 1) / THREADS > by_bytes) by_bytes = (sec.bytes / 8 + THREADS - 1) / THREADS;
  if (by_bytes > blocks) blocks = by_bytes;
  if (blocks > 65535) blocks = 65535;
  auto kernel = n_planes == 1 ? (flat ? hostpack_kernel<1, true> : hostpack_kernel<1, false>)
                              : (flat ? hostpack_kernel<3, true> : hostpack_kernel<3, false>);
  kernel<<<dim3((unsigned)blocks, (unsigned)B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ui, bt, sec, static_cast<uint8_t*>(out), out_stride, red_off, ui_off,
      static_cast<unsigned long long*>(scratch));
  return (int)cudaGetLastError();
}
