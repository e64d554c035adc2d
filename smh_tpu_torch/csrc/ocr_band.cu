// The OCR row band of the quadrant's scales images, and the bit-packed
// keep mask, from kernel 6's planes.
//
// Replaces a region of smh_tpu's jitted fused pass (XLA ops, not a Pallas
// kernel; smh_tpu/ops/pipeline.py::_pack_outputs :792): the banded
// transport (:826-851) -- the keep mask's row bbox by two
// _first_true_counts (:313) of its row flags, the band's start b0 =
// clip(oy0, 0, brq_h - band) (:837), the smeta (:838) and the
// dynamic_slices of scales_bits and of pack_bits(keep) ("binary") or of
// ocr_img ("gray") -- and the unbanded binary transport's pack_bits(keep)
// (:855-858). keep is ocr_img < OCR_BINARY_THRESHOLD, which kernel 6 writes
// as its u8 0/1 text plane. The plain twin is smh_tpu_torch/ops/kernels.py::
// ocr_band_plain; every output byte equals it. Per frame it writes:
//
//   banded:   oy0, oy1, b0 (i32, 4-byte aligned: the first text row, one
//             past the last, and the band's start; h, 0 and h - band with
//             no text), then rows
//             b0 .. b0 + band of the scales bits (band x ceil(w / 8) bytes),
//             then the same rows of the packed keep mask (binary: band x
//             ceil(w / 8)) or of ocr_img (gray: band x w)
//   unbanded: the packed keep mask, h x ceil(w / 8) bytes
//
// the hostpack's scales_meta, scales_bits and ocr_bits / ocr_img sections
// (the unbanded scales bits need no kernel: kernel 9 copies kernel 6's).
// Bits are MSB first (np.packbits order), pad bits zero.
//
// What bounds it on an H100: not its bytes. The band's start depends on the
// whole keep plane (203 KB at the 1080p quadrant, 810 KB at 4K: 0.06 /
// 0.24 us at 3.35 TB/s; the band itself ~27 KB at 1080p), so a frame's
// copy waits on a reduction over all of it: the chain is the launch, the
// strip's loads, the blocks' rows meeting and the band's loads; at 4K the
// strip read, on the SMs of one cluster, takes the most. The design needs
// no scratch, no ticket and no memset, so nothing is left for a later
// launch (or a CUDA graph) to find:
//
//  * banded, a thread block cluster of CLUSTER blocks a frame (16, the
//    H100's non-portable maximum, so the strip read runs on 16 SMs): each
//    block reads a strip of the keep plane's rows as the aligned 16-byte
//    chunks that hold them, two loads in flight a thread (the bytes
//    outside its strip masked off), and finds its first and last text
//    byte. The blocks' rows meet without a second cluster barrier: each
//    block sends its pair to every block by an asynchronous distributed
//    shared memory store (st.async) that an mbarrier in the receiving
//    block counts in bytes, and waits on its own mbarrier until all
//    CLUSTER pairs have landed. The one cluster barrier, arrived on at the
//    start and waited on before the first store, makes sure every block has
//    started and has set up its mbarrier. No block touches another's shared
//    memory after its pairs are sent, and each waits for the pairs sent to
//    it, so a block may exit at once. Every warp then joins the CLUSTER
//    pairs from its own shared memory, and the cluster copies the band in
//    one index space, a run of it a block (so every SM of the cluster
//    copies): a thread an aligned 16-byte chunk of the output, its bytes
//    from the two aligned source chunks under it by a funnel shift (the
//    spans' starts are any value mod 16), a 16-byte store where the chunk
//    lies inside the section and bytes at its ends; the binary keep bits a
//    thread 16 pixels of a row (two output bytes, from __vcmpne4 nibbles and
//    a bit reversal);
//  * unbanded, no reduction: blocks of UNBANDED_THREADS threads, a thread 16
//    pixels of a row, a batch's frames along blockIdx.y.
//
// Designs that lost to this one in turns on the card (probe_ocr_band.py's
// variants; device us, the verify quadrant's gray band of 51 / 102 rows,
// against 3.17 / 4.72; NVIDIA H100 80GB HBM3, 700 W): a cluster of 8
// blocks 3.71 / 6.72; blocks of 1024 threads 3.68 / 4.90, of 256 3.20 /
// 5.51; the strip by one bulk copy (cp.async.bulk) into shared memory 3.55
// / 5.47; the rows through a second cluster barrier 3.68 / 5.29; the copy
// by five 32-bit loads a chunk 3.22 / 4.84; the copy on the first blocks
// 3.35 / 4.73; and the design before it, a cluster of 8 blocks of 1024 threads that pulled
// the rows through distributed shared memory and copied a byte a thread,
// 5.22 / 8.31.
//
// A batch is one launch: blockIdx.y selects the frame (a cluster a frame
// when banded), whose planes start at their frame strides and whose output
// at out + f * out_stride bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;  // banded: a block's threads
constexpr int WARPS = THREADS / 32;
constexpr int CLUSTER = 16;  // banded: blocks a frame, one thread block cluster
constexpr int UNBANDED_THREADS = 256;
constexpr int SMETA = 3;  // i32: oy0, oy1, b0
constexpr unsigned FULL = 0xffffffffu;
static_assert(WARPS <= 32 && CLUSTER <= 32, "one warp joins the warps' and the cluster's rows");

// Bit i: byte i of the 4 is non-zero.
__device__ __forceinline__ uint32_t nonzero4(uint32_t x) {
  const uint32_t t = __vcmpne4(x, 0u);  // 0xff a non-zero byte
  return ((t >> 7) & 1u) | ((t >> 14) & 2u) | ((t >> 21) & 4u) | ((t >> 28) & 8u);
}

// Bit i: byte i of the 16 is non-zero.
__device__ __forceinline__ uint32_t nonzero16(uint4 v) {
  return nonzero4(v.x) | nonzero4(v.y) << 4 | nonzero4(v.z) << 8 | nonzero4(v.w) << 12;
}

__device__ __forceinline__ uint32_t word_of(uint4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The aligned 32-bit word at a, or zero where it holds no byte of [lo, hi)
// (a word that holds one lies in mapped memory).
__device__ __forceinline__ uint32_t word_in(uintptr_t a, uintptr_t lo, uintptr_t hi) {
  return a < hi && a + 4 > lo ? __ldg(reinterpret_cast<const uint32_t*>(a)) : 0u;
}

// The 16 bytes at p (any alignment), from the five aligned 32-bit words
// under them (those that hold no byte of [lo, hi) read as zero), each
// output word a funnel shift of two: the keep bits' loads.
__device__ __forceinline__ uint4 load16(uintptr_t p, uintptr_t lo, uintptr_t hi) {
  const uintptr_t a = p & ~uintptr_t(3);
  const uint32_t w0 = word_in(a, lo, hi), w1 = word_in(a + 4, lo, hi), w2 = word_in(a + 8, lo, hi),
                 w3 = word_in(a + 12, lo, hi), w4 = word_in(a + 16, lo, hi);
  const int s = 8 * (int)(p & 3);
  return make_uint4(__funnelshift_r(w0, w1, s), __funnelshift_r(w1, w2, s), __funnelshift_r(w2, w3, s),
                    __funnelshift_r(w3, w4, s));
}

// load16 from the two aligned 16-byte chunks under the bytes (a chunk that
// holds no byte of [lo, hi) is not read, and its bytes read as zero), the
// words picked by the offset in two steps of selects: the copy's loads, two
// where load16 takes five.
__device__ __forceinline__ uint4 load16_wide(uintptr_t p, uintptr_t lo, uintptr_t hi) {
  const uintptr_t a = p & ~uintptr_t(15);
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  const uint4 u = a < hi && a + 16 > lo ? __ldg(reinterpret_cast<const uint4*>(a)) : z;
  const uint4 v = a + 16 < hi && a + 32 > lo ? __ldg(reinterpret_cast<const uint4*>(a) + 1) : z;
  const bool two = (p & 8) != 0, one = (p & 4) != 0;
  const uint32_t x0 = two ? u.z : u.x, x1 = two ? u.w : u.y, x2 = two ? v.x : u.z, x3 = two ? v.y : u.w,
                 x4 = two ? v.z : v.x, x5 = two ? v.w : v.y;
  const uint32_t w0 = one ? x1 : x0, w1 = one ? x2 : x1, w2 = one ? x3 : x2, w3 = one ? x4 : x3, w4 = one ? x5 : x4;
  const int s = 8 * (int)(p & 3);
  return make_uint4(__funnelshift_r(w0, w1, s), __funnelshift_r(w1, w2, s), __funnelshift_r(w2, w3, s),
                    __funnelshift_r(w3, w4, s));
}

// Folds the text bytes of the 16 at frame byte o, those of [lo, hi), into
// the first and last text byte.
__device__ __forceinline__ void fold(uint4 v, int o, int lo, int hi, int& first, int& last) {
  uint32_t m = nonzero16(v);  // bit i: byte o + i
  if (o < lo) m &= ~0u << (lo - o);
  if (o + 16 > hi) m &= (1u << (hi - o)) - 1u;
  if (m != 0u) {
    first = min(first, o + __ffs(m) - 1);
    last = max(last, o + 31 - __clz(m));
  }
}

// The aligned 16-byte chunks of the n bytes at dst.
__device__ __forceinline__ int span_chunks(const uint8_t* dst, int n) {
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  return (int)((d + n + 15 - (d & ~uintptr_t(15))) >> 4);
}

// Chunk c of span_chunks(dst, n): its bytes of dst[0 .. n) from src[0 ..
// n), in one 16-byte store where the chunk lies inside the span.
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const uint8_t* src, int n, int c) {
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t p = (d & ~uintptr_t(15)) + 16 * (uintptr_t)c;
  const int off = (int)((intptr_t)p - (intptr_t)d);  // the span's byte at the chunk's start (< 0 at its head)
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uint4 v = load16_wide(s + off, s, s + n);
  if (off >= 0 && off + 16 <= n) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (off + i >= 0 && off + i < n) reinterpret_cast<uint8_t*>(p)[i] = (uint8_t)(word_of(v, i >> 2) >> (8 * (i & 3)));
}

// Pixels 16 g .. 16 g + 15 of a keep row of w pixels (those at or past w
// read as zero), packed MSB first into bytes 2 g and 2 g + 1 of dst (the
// second where the row has it).
__device__ __forceinline__ void pack16(const uint8_t* row, int w, int g, uint8_t* dst) {
  const int x = 16 * g;
  const uintptr_t r = reinterpret_cast<uintptr_t>(row);
  uint32_t m = nonzero16(load16(r + x, r, r + w));  // bit i: pixel x + i
  if (w - x < 16) m &= (1u << (w - x)) - 1u;
  const uint32_t b = __brev(m);  // bit 31 - i: pixel x + i, so byte 3: pixels x .. x + 7, MSB first
  uint8_t* o = dst + 2 * g;
  if (x + 8 >= w) {
    *o = (uint8_t)(b >> 24);
  } else if ((reinterpret_cast<uintptr_t>(o) & 1) == 0) {
    *reinterpret_cast<uint16_t*>(o) = (uint16_t)((b >> 24) | ((b >> 8) & 0xff00u));
  } else {
    o[0] = (uint8_t)(b >> 24);
    o[1] = (uint8_t)(b >> 16);
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// The address of the shared memory at `at` (this block's) in block `rank`
// of the cluster.
__device__ __forceinline__ uint32_t in_block(uint32_t at, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(at), "r"(rank));
  return out;
}

// Waits until phase 0 of the barrier at `bar` has completed.
__device__ __forceinline__ void wait_phase0(uint32_t bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  } while (!done);
}

template <bool BANDED>
__global__ void __launch_bounds__(BANDED ? THREADS : UNBANDED_THREADS)
    ocr_band_kernel(const uint8_t* __restrict__ text, int64_t text_stride, const uint8_t* __restrict__ sbits,
                    int64_t sbits_stride, const uint8_t* __restrict__ ocr, int64_t ocr_stride, int h, int w,
                    int band, int binary, uint8_t* __restrict__ out, int64_t out_stride) {
  const int tid = threadIdx.x;
  const int64_t f = blockIdx.y;
  const int bpr = (w + 7) / 8;
  const int g16 = (w + 15) / 16;
  text += f * text_stride;
  out += f * out_stride;

  if constexpr (!BANDED) {
    // The keep mask of the whole quadrant: a thread 16 pixels of a row.
    const int it = blockIdx.x * UNBANDED_THREADS + tid;
    if (it >= h * g16) return;
    const int r = it / g16;
    pack16(text + (int64_t)r * w, w, it - r * g16, out + (int64_t)r * bpr);
  } else {
    __shared__ int s_lo[WARPS], s_hi[WARPS];
    __shared__ int2 s_rows[CLUSTER];  // block k's first and last text row (h, -1: none), pushed by block k
    __shared__ uint64_t s_full;       // completes once every block's rows have landed in s_rows
    const int lane = tid & 31;
    const int warp = tid >> 5;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    sbits += f * sbits_stride;
    ocr += f * ocr_stride;

    // 1. The first and last text byte of this block's strip of the keep
    //    plane, rows r0 .. r1 (bytes lo .. hi of the frame), from the
    //    aligned 16-byte chunks that hold them.
    const int per = (h + CLUSTER - 1) / CLUSTER;
    const int r0 = min(h, rank * per);
    const int r1 = min(h, r0 + per);
    const int lo = r0 * w, hi = r1 * w;
    const uintptr_t at = (reinterpret_cast<uintptr_t>(text) + lo) & ~uintptr_t(15);
    const int off = (int)((intptr_t)at - reinterpret_cast<intptr_t>(text));  // the frame byte chunk 0 starts at
    const int chunks = lo < hi ? (hi - off + 15) >> 4 : 0;
    const uint32_t full = smem(&s_full);
    if (tid == 0) {  // s_full expects CLUSTER pairs of rows, before any block can send one
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(full) : "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(full), "r"(CLUSTER * 8) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();           // s_full is set up before any thread waits on it
    cluster_arrive_relaxed();  // this block has started (waited on before the first remote store)
    int first = INT_MAX, last = -1;
    const uint4* p = reinterpret_cast<const uint4*>(at);
    for (int c = tid; c < chunks; c += 2 * THREADS) {  // two loads in flight a thread
      const uint4 v0 = __ldg(p + c);
      const uint4 v1 = c + THREADS < chunks ? __ldg(p + c + THREADS) : make_uint4(0u, 0u, 0u, 0u);
      fold(v0, off + 16 * c, lo, hi, first, last);
      if (c + THREADS < chunks) fold(v1, off + 16 * (c + THREADS), lo, hi, first, last);
    }
    // 2. The block's rows, pushed into every block's shared memory.
    first = __reduce_min_sync(FULL, first);
    last = __reduce_max_sync(FULL, last);
    if (lane == 0) {
      s_lo[warp] = first;
      s_hi[warp] = last;
    }
    __syncthreads();
    cluster_wait_acquire();  // every block of the cluster has started
    if (warp == 0) {
      first = __reduce_min_sync(FULL, lane < WARPS ? s_lo[lane] : INT_MAX);
      last = __reduce_max_sync(FULL, lane < WARPS ? s_hi[lane] : -1);
      if (lane < CLUSTER) {  // an asynchronous store of the pair into block `lane`, which counts its bytes
        const int a = first == INT_MAX ? h : first / w, b = last < 0 ? -1 : last / w;
        asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.s32 [%0], {%1, %2}, [%3];" ::"r"(
                         in_block(smem(&s_rows[rank]), lane)),
                     "r"(a), "r"(b), "r"(in_block(full, lane))
                     : "memory");
      }
    }
    wait_phase0(full);  // every block's rows are in this block's shared memory

    // 3. The frame's rows and the band's start, by every warp from its own
    //    block's shared memory.
    int a = h, b = -1;
    if (lane < CLUSTER) {
      const int2 rows = s_rows[lane];
      a = rows.x;
      b = rows.y;
    }
    a = __reduce_min_sync(FULL, a);
    b = __reduce_max_sync(FULL, b);
    const int b0 = min(a, h - band);  // oy0 >= 0
    if (rank == 0 && tid == 0) {
      int32_t* meta = reinterpret_cast<int32_t*>(out);
      meta[0] = a;
      meta[1] = b + 1;
      meta[2] = b0;
    }

    // 4. The band, in one index space over the cluster's threads, a run of
    //    it a block: the scales bits' chunks, then the keep bits' 16-pixel
    //    groups (binary) or ocr_img's chunks (gray).
    uint8_t* dst = out + 4 * SMETA;
    const int nb = band * bpr;
    const uint8_t* src = sbits + (int64_t)b0 * bpr;
    uint8_t* dst2 = dst + nb;
    const int ng = band * w;
    const uint8_t* src2 = ocr + (int64_t)b0 * w;
    const uint8_t* keep = text + (int64_t)b0 * w;
    const int c1 = span_chunks(dst, nb);
    const int items = c1 + (binary ? band * g16 : span_chunks(dst2, ng));
    const int share = (items + CLUSTER - 1) / CLUSTER;  // a block's run of items, so every SM copies
    const int end = min(items, (rank + 1) * share);
    for (int i = rank * share + tid; i < end; i += THREADS) {
      if (i < c1) {
        copy_chunk(dst, src, nb, i);
      } else if (binary) {
        const int r = (i - c1) / g16;
        pack16(keep + (int64_t)r * w, w, i - c1 - r * g16, dst2 + (int64_t)r * bpr);
      } else {
        copy_chunk(dst2, src2, ng, i - c1);
      }
    }
  }
}

}  // namespace

// B frames of an h x w quadrant: the keep plane (u8, non-zero = text) of
// frame f at text + f * text_stride, its scales bits (h rows of (w + 7) / 8
// bytes) at sbits + f * sbits_stride and its ocr_img (h rows of w bytes) at
// ocr + f * ocr_stride (bytes; the rows of each contiguous); band: the band's
// rows (1 <= band <= h), or 0 for the unbanded keep mask (sbits and ocr are
// then not read); binary: the band's second section is the keep mask (else
// ocr_img). Frame f's output at out + f * out_stride (bytes): 12 + band
// ((w + 7) / 8 + (binary ? (w + 7) / 8 : w)) bytes banded (out and
// out_stride 4-byte aligned: the smeta is 3 i32), h ((w + 7) / 8)
// unbanded.
extern "C" int smh_ocr_band(const void* text, int64_t text_stride, const void* sbits, int64_t sbits_stride,
                            const void* ocr, int64_t ocr_stride, int h, int w, int band, int binary, int B, void* out,
                            int64_t out_stride, void* stream) {
  const int64_t bpr = (w + 7) / 8;
  const int64_t row = band > 0 ? 4 * SMETA + band * (bpr + (binary ? bpr : w)) : h * bpr;
  if (h <= 0 || w <= 0 || (int64_t)h * w > INT32_MAX - 16 * CLUSTER * THREADS || band < 0 || band > h || B <= 0 ||
      B > 65535 || out_stride < row ||
      (band > 0 && ((out_stride | (int64_t)reinterpret_cast<uintptr_t>(out)) & 3) != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* t = static_cast<const uint8_t*>(text);
  const uint8_t* sb = static_cast<const uint8_t*>(sbits);
  const uint8_t* oc = static_cast<const uint8_t*>(ocr);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (band == 0) {
    const int64_t items = (int64_t)h * ((w + 15) / 16);
    const unsigned blocks = (unsigned)((items + UNBANDED_THREADS - 1) / UNBANDED_THREADS);
    ocr_band_kernel<false><<<dim3(blocks, B), UNBANDED_THREADS, 0, s>>>(t, text_stride, sb, sbits_stride, oc,
                                                                        ocr_stride, h, w, 0, 1, o, out_stride);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // Once per device: a cluster past 8 blocks is non-portable and must be
  // allowed, and the card must hold one.
  static int ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    if (CLUSTER > 8) {
      err = cudaFuncSetAttribute(ocr_band_kernel<true>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
    }
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, ocr_band_kernel<true>, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (fit < 1) return (int)cudaErrorInvalidConfiguration;
    ready[dev] = 1;
  }
  err = cudaLaunchKernelEx(&cfg, ocr_band_kernel<true>, t, text_stride, sb, sbits_stride, oc, ocr_stride, h, w, band,
                           binary, o, out_stride);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
