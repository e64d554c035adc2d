// The delta apply: a frame rebuilt from the device-resident buffer and the
// changed chunks of a delta upload, or a batch's chain of such frames.
//
// Replaces the scatter of smh_tpu's delta dispatches (XLA ops, not a
// Pallas kernel): _analyze_delta_flat (smh_tpu/ops/pipeline.py:1060-1062,
// `resident.reshape(-1, chunk).at[idx].set(data)`) and the lax.scan of
// _analyze_batch_delta (:1142-1155), whose step applies frame i's updates
// to frame i - 1. The plain twin is smh_tpu_torch/ops/kernels.py::
// delta_apply_plain (a copy and an index_copy_ a frame); every output byte
// equals it.
//
// The upload holds B index tables of `bucket` i32 chunk indices, then B
// blocks of `bucket` chunks of `chunk` bytes. Row f of the output is row
// f - 1 (row -1: `resident`) with frame f's chunks written over it.
// `resident` is never written: a consume view of the previous frame may
// still read it. No memset: every byte of every row is written.
//
// Each frame's indices are NON-DECREASING (the host's diff emits changed
// chunks in ascending order and pads the bucket by repeating the last
// index with its data), so the updates that land in a range of chunks are
// one run of the table, found by a search:
//
//  * a block owns a tile of THREADS 16-byte pieces (128 chunks of 32 B), a
//    thread one piece: it loads the resident's piece first, then for each
//    frame in chain order replaces it by the last update of its chunk in
//    that frame's table, if any, and stores it to the frame's row. No grid
//    barrier: the chain of a tile never leaves the block's registers;
//  * the run of a frame's table that falls in the tile is found once a
//    block by a warp's 32-way search (a ballot over 32 samples narrows the
//    range 32-fold a step: 4 dependent loads for the ladder's top bucket,
//    131072), a warp each of the 2 B bounds; each thread then
//    binary-searches its chunk in that run (at most 128 chunks, plus the
//    padding's repeats in the tile that holds the last index);
//  * a duplicate index takes its last entry's data, as a sequential
//    scatter would; the padding's duplicates carry equal data.
//
// What bounds it on an H100: its bytes, the resident read once and each
// row written once (2.46 MB + B rows of 2.46 MB at the 1080p map, ~1.5 us a
// frame at 3.35 TB/s), and for a small upload the launch and its chain of
// dependent loads: the bound search's three steps and each thread's search
// of its chunk (a clock64 timeline of every block, probe_delta_apply.py:
// ~2100 and ~1250 cycles at the 1080p buffer, under the tile's bytes,
// against ~260 for an idle load). Measured (chip_smoke.py and
// probe_delta_apply.py, NVIDIA H100 80GB HBM3, PERF.md): 3.1 us at the
// 1080p buffer, 6.4 at 4K, 9.8-9.9 for a chain of 8 at 1080p (bounds 1.5 /
// 5.9 / 6.8); in the sync frame 2.8 / 4.8, under the 4K bound, as the
// resident buffer the frame before wrote is still in the 50 MB L2. The
// designs that lost to this one in turns (us at 1080p / 4K / the chain of
// 8): a block-wide 256-way search and a walk of the run into a shared map
// of the tile's chunks, every frame's data load at once, 3.8 / 10.3 / 12.1
// (256 scattered loads a step waited behind the tile's bytes, and at 4K
// three waves of blocks each paid the chain); that with 4 pieces a thread
// and every row's resident bytes stored before the chain, 4.7 / 10.2 /
// 14.0; one warp a frame for both bounds with 64 samples a step and the
// entries' searches in lockstep, 3.4 / 8.2 / 12.1; these searches with the
// table's last index from their first step and all frames' searches
// before one barrier, then each frame's entry and rounds of 4 frames' data
// loads, 3.2-3.3 / 6.7-6.9 / 10.6-10.7 (the padded top bucket at 4K
// 7.4-7.7 against this design's 9.0); this design with one warp's search
// of where a run's repeats begin in a tile whose run outgrows its chunks,
// 3.3 / 7.4 / 10.4, the padded top bucket 8.7 (against 8.9): the added
// code cost more than the search it saved, even with the search off.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16-byte pieces of a tile, a thread each
constexpr int WARPS = THREADS / 32;
constexpr int MAX_FRAMES = 4096;  // 2 i32 bounds a frame in shared memory
constexpr unsigned FULL = 0xffffffffu;

// The first position of t[lo, hi) whose value is >= key (hi if none), the
// whole warp searching together: each step samples 32 positions and keeps
// the range between the last sample below key and the first at or above
// it. All lanes call it and get the same result.
__device__ __forceinline__ int warp_lower_bound(const int32_t* __restrict__ t, int lo, int hi, int key, int lane) {
  while (hi - lo > 32) {
    const int n = hi - lo;
    const int pos = lo + (int)(((int64_t)lane * n) >> 5);
    const unsigned m = __popc(__ballot_sync(FULL, __ldg(t + pos) < key));  // samples 0 .. m - 1 lie below key
    const int nlo = m == 0 ? lo : lo + (int)(((int64_t)(m - 1) * n) >> 5) + 1;
    hi = m == 32 ? hi : lo + (int)(((int64_t)m * n) >> 5);
    lo = nlo;
  }
  return lo + __popc(__ballot_sync(FULL, lane < hi - lo && __ldg(t + lo + lane) < key));
}

// The first position of t[lo, hi) whose value is > key (hi if none).
__device__ __forceinline__ int upper_bound(const int32_t* __restrict__ t, int lo, int hi, int key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(t + mid) <= key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
    delta_apply_kernel(const uint4* __restrict__ resident, int64_t pieces, const int32_t* __restrict__ idx,
                       const uint4* __restrict__ data, int bucket, int ppc, int B, uint4* __restrict__ out) {
  extern __shared__ int bounds[];  // frame f's entries in this tile: [bounds[2 f], bounds[2 f + 1])
  const int64_t p0 = (int64_t)blockIdx.x * THREADS;
  const int64_t p = p0 + threadIdx.x;
  const bool in = p < pieces;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (in) v = __ldg(resident + p);  // under the searches

  const int c_lo = (int)(p0 / ppc);                                        // the tile's first chunk
  const int c_hi = (int)((min(p0 + THREADS, pieces) - 1) / ppc) + 1;  // one past its last
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = warp; k < 2 * B; k += WARPS) {  // warp-uniform
    const int b = warp_lower_bound(idx + (int64_t)(k >> 1) * bucket, 0, bucket, (k & 1) ? c_hi : c_lo, lane);
    if (lane == 0) bounds[k] = b;
  }
  __syncthreads();
  if (!in) return;

  const int c = (int)(p / ppc), part = (int)(p % ppc);
  for (int f = 0; f < B; ++f) {
    const int lo = bounds[2 * f], hi = bounds[2 * f + 1];
    if (lo < hi) {
      const int32_t* t = idx + (int64_t)f * bucket;
      const int j = upper_bound(t, lo, hi, c) - 1;  // the last entry <= c
      if (j >= lo && __ldg(t + j) == c) v = __ldg(data + ((int64_t)f * bucket + j) * ppc + part);
    }
    out[(int64_t)f * pieces + p] = v;
  }
}

}  // namespace

// resident: `bytes` bytes (a multiple of `chunk`); buf: B index tables of
// `bucket` i32 (each non-decreasing), then B * bucket chunks of `chunk`
// bytes (a multiple of 16), at a 16-byte aligned address as are resident
// and out; out: B rows of `bytes`. Indices outside [0, bytes / chunk)
// update nothing.
extern "C" int smh_delta_apply(const void* resident, int64_t bytes, const void* buf, int bucket, int chunk, int B,
                               void* out, void* stream) {
  if (bytes <= 0 || chunk <= 0 || chunk % 16 != 0 || bytes % chunk != 0 || bytes / chunk >= INT32_MAX ||
      bucket <= 0 || B <= 0 || B > MAX_FRAMES ||
      ((reinterpret_cast<uintptr_t>(resident) | reinterpret_cast<uintptr_t>(out) |
        (reinterpret_cast<uintptr_t>(buf) + 4 * (int64_t)B * bucket)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t pieces = bytes / 16;
  const int64_t blocks = (pieces + THREADS - 1) / THREADS;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int32_t* idx = static_cast<const int32_t*>(buf);
  const uint4* data = reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(buf) + 4 * (int64_t)B * bucket);
  delta_apply_kernel<<<(unsigned)blocks, THREADS, 2 * B * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(resident), pieces, idx, data, bucket, chunk / 16, B, static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}
