// Longest-line ray march: for each seed, 3600 rays (one per 0.1 degree),
// each marched until it leaves the plane or crosses a gap of more than
// max_gap non-white samples; then each seed's longest ray.
//
// Replaces smh_tpu/ops/lsd.py::_march_span + _finalize (XLA ops, not a
// Pallas kernel; entry find_longest_lines_batch), and is the reference's own
// GPU shape (vision-gpu/cuda/cuda.cu:637-739: one thread per angle, a
// data-dependent loop). The TPU version marches dense [B, N, K] spans with
// windowed ANDs because a TPU has no cheap per-lane loop; a GPU thread does,
// so each (seed, angle) lane runs the oracle's sequential state machine:
//
//   pos(k) = start + k * d, rounded twice (__fmul_rn, __fadd_rn: no FMA,
//            the plain version's two roundings);
//   a sample is white iff it is in the plane and the mask byte is 255;
//   abort at the first in-plane step that completes a run of max_gap + 1
//            non-white samples (samples before k = 0 count as white), with
//            the endpoint pos(k - max_gap - 1) (the closed form of
//            lsd.py:147-152);
//   at the first step out of the plane, the endpoint is that position less
//            one step if its saturating-cast pixel is in the plane and black,
//            else the start (lsd.py:154-167);
//   a lane still alive after k_total steps keeps end = start, as a JAX lane
//            still alive after its last span does (the caller passes the
//            same span-rounded bound).
//
// Seeds lie inside the plane (the backend seeds from mask pixels), so a
// ray's in-plane steps are a prefix of k (positions are monotone in k) and
// the first out-of-plane step is the JAX `sum(inb)`.
//
// The second kernel reduces each seed to the last angle with the largest
// squared length (lsd.py:183-193) in one block: each thread keeps its best
// (length, angle) with ties to the later angle, then a shared-memory tree
// keeps the larger length, ties to the higher angle. Deterministic.
//
// What bounds it on an H100: latency of dependent mask loads. The u8 mask
// (0.8 MB at the 1080p map, 3.2 MB at 4K) sits in L2; background rays die
// after max_gap + 1 samples, rays along a real line march its length. One
// thread per lane, 128 lanes per block, B x 29 blocks; no shared memory in
// the march. Simple and right first; the per-step loads are not coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE_THREADS = 128;
constexpr int REDUCE_THREADS = 256;

__global__ void ray_march_lanes(const uint8_t* __restrict__ mask, int H, int W,
                                const float* __restrict__ pts,
                                const float* __restrict__ cosv,
                                const float* __restrict__ sinv, int N,
                                int max_gap, int k_total,
                                float* __restrict__ end_x,
                                float* __restrict__ end_y) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (a >= N) return;
  const float x0 = pts[2 * b];
  const float y0 = pts[2 * b + 1];
  const float dx = cosv[a];
  const float dy = sinv[a];
  const float fw = (float)W;
  const float fh = (float)H;
  const int window = max_gap + 1;
  float ex = x0;
  float ey = y0;
  int run = 0;  // trailing non-white samples
  for (int k = 0; k < k_total; ++k) {
    const float kf = (float)k;
    const float px = __fadd_rn(x0, __fmul_rn(dx, kf));
    const float py = __fadd_rn(y0, __fmul_rn(dy, kf));
    if (!(px >= 0.f && py >= 0.f && px < fw && py < fh)) {
      // Out of the plane: the reference's final check with a saturating
      // f32 -> u32 cast (negatives clamp to 0).
      const int cxi = (int)fmaxf(px, 0.f);
      const int cyi = (int)fmaxf(py, 0.f);
      if (cxi < W && cyi < H && mask[(int64_t)cyi * W + cxi] == 0) {
        ex = __fsub_rn(px, dx);
        ey = __fsub_rn(py, dy);
      }
      break;
    }
    const bool white = mask[(int64_t)(int)py * W + (int)px] == 255;
    run = white ? 0 : run + 1;
    if (run >= window) {
      const float ke = (float)(k - window);
      ex = __fadd_rn(x0, __fmul_rn(dx, ke));
      ey = __fadd_rn(y0, __fmul_rn(dy, ke));
      break;
    }
  }
  end_x[(int64_t)b * N + a] = ex;
  end_y[(int64_t)b * N + a] = ey;
}

__global__ void ray_march_reduce(const float* __restrict__ pts,
                                 const float* __restrict__ end_x,
                                 const float* __restrict__ end_y, int N,
                                 float* __restrict__ best_x,
                                 float* __restrict__ best_y,
                                 float* __restrict__ best_len) {
  __shared__ float s_len[REDUCE_THREADS];
  __shared__ int s_idx[REDUCE_THREADS];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float x0 = pts[2 * b];
  const float y0 = pts[2 * b + 1];
  const float* ex = end_x + (int64_t)b * N;
  const float* ey = end_y + (int64_t)b * N;
  float best = -1.f;
  int besti = -1;
  for (int a = t; a < N; a += REDUCE_THREADS) {
    const float lx = __fsub_rn(x0, ex[a]);
    const float ly = __fsub_rn(y0, ey[a]);
    const float len = __fadd_rn(__fmul_rn(lx, lx), __fmul_rn(ly, ly));
    if (len >= best) {  // a grows: ties go to the later angle
      best = len;
      besti = a;
    }
  }
  s_len[t] = best;
  s_idx[t] = besti;
  __syncthreads();
  for (int s = REDUCE_THREADS / 2; s > 0; s >>= 1) {
    if (t < s) {
      const float hi = s_len[t + s];
      const int ih = s_idx[t + s];
      if (hi > s_len[t] || (hi == s_len[t] && ih > s_idx[t])) {
        s_len[t] = hi;
        s_idx[t] = ih;
      }
    }
    __syncthreads();
  }
  if (t == 0) {
    const int i = s_idx[0];
    best_x[b] = ex[i];
    best_y[b] = ey[i];
    best_len[b] = s_len[0];
  }
}

}  // namespace

// mask: u8 [H, W]; pts: f32 [B, 2] (x, y); cosv, sinv: f32 [N]; end_x,
// end_y: f32 [B, N]; best_x, best_y, best_len: f32 [B]. Both kernels run on
// `stream`, one after the other.
extern "C" int smh_ray_march(const void* mask, int H, int W, const void* pts,
                             int B, const void* cosv, const void* sinv, int N,
                             int max_gap, int k_total, void* end_x, void* end_y,
                             void* best_x, void* best_y, void* best_len,
                             void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + LANE_THREADS - 1) / LANE_THREADS, B);
  ray_march_lanes<<<grid, LANE_THREADS, 0, s>>>(
      static_cast<const uint8_t*>(mask), H, W, static_cast<const float*>(pts),
      static_cast<const float*>(cosv), static_cast<const float*>(sinv), N,
      max_gap, k_total, static_cast<float*>(end_x), static_cast<float*>(end_y));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ray_march_reduce<<<B, REDUCE_THREADS, 0, s>>>(
      static_cast<const float*>(pts), static_cast<const float*>(end_x),
      static_cast<const float*>(end_y), N, static_cast<float*>(best_x),
      static_cast<float*>(best_y), static_cast<float*>(best_len));
  return (int)cudaGetLastError();
}
