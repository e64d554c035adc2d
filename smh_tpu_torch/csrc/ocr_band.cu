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
// copy waits on a reduction over all of it. The design needs no scratch, no
// ticket and no memset, so nothing is left for a later launch (or a CUDA
// graph) to find:
//
//  * banded, a thread block cluster of CLUSTER blocks a frame: each block
//    reads a strip of the keep plane's rows as aligned 16-byte chunks (the
//    bytes outside its strip masked off) and finds its first and last text
//    row, a division a non-zero chunk; the cluster joins the blocks'
//    rows through distributed shared memory after one cluster barrier;
//    each block then copies its share of the band. A block arrives on a
//    second cluster barrier once it has read the others' rows and waits on
//    it before it exits, so its shared memory outlives their reads, and
//    the copy runs between the two;
//  * the keep bits, a warp 32 pixels of a row: a ballot of the lanes'
//    bytes is the group's four output bytes after a bit reversal and a
//    byte swap (MSB first);
//  * unbanded, no reduction: blocks of warps over (row, 32-pixel group)
//    pairs, a batch's frames along blockIdx.y.
//
// A batch is one launch: blockIdx.y selects the frame (a cluster a frame
// when banded), whose planes start at their frame strides and whose output
// at out + f * out_stride bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int CLUSTER = 8;  // blocks a frame in the banded mode: one thread block cluster
constexpr int SMETA = 3;    // i32: oy0, oy1, b0
constexpr unsigned FULL = 0xffffffffu;
static_assert(WARPS == 32 && CLUSTER <= 32, "one warp joins the warps' and the cluster's rows");

// Bit i: byte i of the 4 is non-zero.
__device__ __forceinline__ uint32_t nonzero4(uint32_t x) {
  const uint32_t t = __vcmpne4(x, 0u);  // 0xff a non-zero byte
  return ((t >> 7) & 1u) | ((t >> 14) & 2u) | ((t >> 21) & 4u) | ((t >> 28) & 8u);
}

// The warp packs pixels x .. x + 31 of a keep row (w pixels; those at or
// past w read as zero) into dst[0 .. min(4, room)): lane l holds pixel x + l.
// Called by every lane of the warp.
__device__ __forceinline__ void pack32(const uint8_t* __restrict__ row, int x, int w, uint8_t* __restrict__ dst,
                                       int room, int lane) {
  const bool on = x + lane < w && __ldg(row + x + lane) != 0;
  const unsigned b = __ballot_sync(FULL, on);                 // bit l: pixel x + l
  const uint32_t word = __byte_perm(__brev(b), 0u, 0x0123);   // byte j: pixels 8j .. 8j + 7, MSB first
  if (lane < 4 && lane < room) dst[lane] = (uint8_t)(word >> (8 * lane));
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <bool BANDED>
__global__ void __launch_bounds__(THREADS)
    ocr_band_kernel(const uint8_t* __restrict__ text, int64_t text_stride, const uint8_t* __restrict__ sbits,
                    int64_t sbits_stride, const uint8_t* __restrict__ ocr, int64_t ocr_stride, int h, int w,
                    int band, int binary, uint8_t* __restrict__ out, int64_t out_stride) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t f = blockIdx.y;
  const int bpr = (w + 7) / 8;
  const int groups = (w + 31) / 32;
  text += f * text_stride;
  out += f * out_stride;

  if constexpr (!BANDED) {
    // The keep mask of the whole quadrant.
    const int items = h * groups;
    for (int it = blockIdx.x * WARPS + warp; it < items; it += gridDim.x * WARPS) {
      const int r = it / groups;
      const int g = it - r * groups;
      pack32(text + (int64_t)r * w, 32 * g, w, out + (int64_t)r * bpr + 4 * g, bpr - 4 * g, lane);
    }
  } else {
    __shared__ int s_lo[WARPS], s_hi[WARPS];
    __shared__ int s_rows[2];  // this block's first and last text row (h, -1: none)
    __shared__ int s_b0;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    sbits += f * sbits_stride;
    ocr += f * ocr_stride;

    // 1. The text rows of this block's strip, rows r0 .. r1 (bytes lo .. hi
    //    of the frame), from the aligned 16-byte chunks that hold them.
    const int per = (h + CLUSTER - 1) / CLUSTER;
    const int r0 = min(h, rank * per);
    const int r1 = min(h, r0 + per);
    const int lo = r0 * w, hi = r1 * w;
    int ylo = h, yhi = -1;
    if (lo < hi) {
      const uintptr_t base = reinterpret_cast<uintptr_t>(text);
      const uintptr_t first = (base + lo) & ~uintptr_t(15);
      const int off = (int)((intptr_t)first - (intptr_t)base);  // the frame byte chunk 0 starts at (<= lo)
      const int chunks = (hi - off + 15) >> 4;
      const uint4* p = reinterpret_cast<const uint4*>(first);
      for (int c = tid; c < chunks; c += THREADS) {
        const uint4 v = __ldg(p + c);
        uint32_t m = nonzero4(v.x) | nonzero4(v.y) << 4 | nonzero4(v.z) << 8 | nonzero4(v.w) << 12;
        const int o = off + 16 * c;  // < hi
        if (o < lo) m &= ~0u << (lo - o);
        if (o + 16 > hi) m &= (1u << (hi - o)) - 1u;
        if (m != 0u) {
          ylo = min(ylo, (o + __ffs(m) - 1) / w);
          yhi = max(yhi, (o + 31 - __clz(m)) / w);
        }
      }
    }
    ylo = __reduce_min_sync(FULL, ylo);
    yhi = __reduce_max_sync(FULL, yhi);
    if (lane == 0) {
      s_lo[warp] = ylo;
      s_hi[warp] = yhi;
    }
    __syncthreads();
    if (warp == 0) {
      ylo = __reduce_min_sync(FULL, s_lo[lane]);
      yhi = __reduce_max_sync(FULL, s_hi[lane]);
      if (lane == 0) {
        s_rows[0] = ylo;
        s_rows[1] = yhi;
      }
    }
    cluster.sync();  // every block's rows are in its shared memory

    // 2. The frame's rows from every block's, and the band's start.
    if (warp == 0) {
      int a = h, b = -1;
      if (lane < CLUSTER) {
        a = *cluster.map_shared_rank(&s_rows[0], lane);
        b = *cluster.map_shared_rank(&s_rows[1], lane);
      }
      a = __reduce_min_sync(FULL, a);
      b = __reduce_max_sync(FULL, b);
      if (lane == 0) {
        const int b0 = min(a, h - band);  // oy0 >= 0
        s_b0 = b0;
        if (rank == 0) {
          int32_t* meta = reinterpret_cast<int32_t*>(out);
          meta[0] = a;
          meta[1] = b + 1;
          meta[2] = b0;
        }
      }
    }
    __syncthreads();
    cluster_arrive_release();  // this block reads no more of the others' shared memory
    const int b0 = s_b0;

    // 3. This block's share of the band: a thread a byte of the scales
    //    bits and of ocr_img, a warp 32 pixels of the keep bits.
    const int gt = rank * THREADS + tid;
    constexpr int T = CLUSTER * THREADS;
    uint8_t* dst = out + 4 * SMETA;
    const int nb = band * bpr;
    const uint8_t* src = sbits + (int64_t)b0 * bpr;
    for (int i = gt; i < nb; i += T) dst[i] = __ldg(src + i);
    dst += nb;
    if (binary) {
      const int items = band * groups;
      for (int it = rank * WARPS + warp; it < items; it += CLUSTER * WARPS) {
        const int r = it / groups;
        const int g = it - r * groups;
        pack32(text + (int64_t)(b0 + r) * w, 32 * g, w, dst + (int64_t)r * bpr + 4 * g, bpr - 4 * g, lane);
      }
    } else {
      const int ng = band * w;
      src = ocr + (int64_t)b0 * w;
      for (int i = gt; i < ng; i += T) dst[i] = __ldg(src + i);
    }
    cluster_wait_acquire();  // every block has read what it reads of this one's shared memory
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
  if (h <= 0 || w <= 0 || (int64_t)h * w > INT32_MAX - 16 || band < 0 || band > h || B <= 0 || B > 65535 ||
      out_stride < row || (band > 0 && ((out_stride | (int64_t)reinterpret_cast<uintptr_t>(out)) & 3) != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* t = static_cast<const uint8_t*>(text);
  const uint8_t* sb = static_cast<const uint8_t*>(sbits);
  const uint8_t* oc = static_cast<const uint8_t*>(ocr);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (band == 0) {
    const int64_t items = (int64_t)h * ((w + 31) / 32);
    const unsigned blocks = (unsigned)((items + WARPS - 1) / WARPS);
    ocr_band_kernel<false><<<dim3(blocks, B), THREADS, 0, s>>>(t, text_stride, sb, sbits_stride, oc, ocr_stride, h, w,
                                                               0, 1, o, out_stride);
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
  const cudaError_t err = cudaLaunchKernelEx(&cfg, ocr_band_kernel<true>, t, text_stride, sb, sbits_stride, oc,
                                             ocr_stride, h, w, band, binary, o, out_stride);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
