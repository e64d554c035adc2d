// Marker classify + Rec.709 luma over three u8 channel planes.
//
// Replaces smh_tpu/ops/pallas_kernels.py::_classify_luma_kernel (entry
// classify_luma_pallas_planes). Per pixel: HSV in f32 with the oracle's order
// of operations and truncating casts, the three fireteam colour tests (with
// the player-direction-arc saturation alternative and the minimum
// saturation), and the Rec.709 luma (0.2126r + 0.7152g) + 0.0722b truncated
// to u8.
//
// What bounds it on an H100: bytes. It reads 3 and writes 2 bytes per pixel
// (~4 MB for the 1080p map ROI, ~16 MB at 4K) and does ~40 flops per pixel,
// far below the card's flop/byte balance. The design keeps to one pass: one
// thread per pixel, neighbouring threads on neighbouring bytes so every warp
// load and store coalesces, no shared memory.
//
// Exactness: the result must be bit-identical to smh_tpu/vision/pixmath.py.
// Every float operation is a __f*_rn intrinsic: division stays correctly
// rounded and nvcc never contracts a multiply and an add into an FMA, which
// would round the luma line differently and flip truncated values.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct ClassifyParams {
  int hsv[3][3];  // (h, s, v) of the alpha, bravo and charlie marker colours
  int hue_tol;
  int sat_tol;
  int arc_sat;
  int vib_tol;
  int min_sat;
};

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

__global__ void classify_luma_kernel(const uint8_t* __restrict__ r8,
                                     const uint8_t* __restrict__ g8,
                                     const uint8_t* __restrict__ b8,
                                     uint8_t* __restrict__ marker,
                                     uint8_t* __restrict__ luma, int64_t n,
                                     ClassifyParams p) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float rf = (float)r8[i];
    const float gf = (float)g8[i];
    const float bf = (float)b8[i];

    const float r = __fdiv_rn(rf, 255.0f);
    const float g = __fdiv_rn(gf, 255.0f);
    const float b = __fdiv_rn(bf, 255.0f);

    const float mx = fmaxf(r, fmaxf(g, b));
    const float mn = fminf(r, fminf(g, b));
    const float delta = __fsub_rn(mx, mn);
    const float safe_delta = delta == 0.0f ? 1.0f : delta;

    const float h_r = __fmul_rn(60.0f, __fdiv_rn(__fsub_rn(g, b), safe_delta));
    const float h_g = __fmul_rn(
        60.0f, __fadd_rn(__fdiv_rn(__fsub_rn(b, r), safe_delta), 2.0f));
    const float h_b = __fmul_rn(
        60.0f, __fadd_rn(__fdiv_rn(__fsub_rn(r, g), safe_delta), 4.0f));
    float h = mx == mn ? 0.0f : (mx == r ? h_r : (mx == g ? h_g : h_b));
    if (h < 0.0f) h = __fadd_rn(h, 360.0f);

    const float safe_mx = mx == 0.0f ? 1.0f : mx;
    const float s =
        mx > 0.0f ? __fdiv_rn(__fmul_rn(100.0f, delta), safe_mx) : 0.0f;
    const float v = __fmul_rn(100.0f, mx);

    // Truncating casts, as the oracle's astype (values are non-negative).
    const int hi = (int)h;
    const int si = (int)s;
    const int vi = (int)v;

    bool ok = false;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const bool hue_ok = iabs(hi - p.hsv[c][0]) <= p.hue_tol;
      const bool sat_ok = iabs(si - p.hsv[c][1]) <= p.sat_tol;
      const bool arc_ok = iabs(si - (p.hsv[c][1] - p.arc_sat)) <= p.sat_tol;
      const bool vib_ok = iabs(vi - p.hsv[c][2]) <= p.vib_tol;
      ok = ok || (hue_ok && (sat_ok || arc_ok) && vib_ok);
    }
    marker[i] = (ok && si >= p.min_sat) ? 1 : 0;

    const float l = __fadd_rn(
        __fadd_rn(__fmul_rn(0.2126f, rf), __fmul_rn(0.7152f, gf)),
        __fmul_rn(0.0722f, bf));
    luma[i] = (uint8_t)(int)l;
  }
}

}  // namespace

// params: 14 ints — (h, s, v) x 3 colours, then hue_tol, sat_tol, arc_sat,
// vib_tol, min_sat (host memory, read before the launch).
extern "C" int smh_classify_luma(const void* r8, const void* g8, const void* b8,
                                 void* marker, void* luma, int64_t n,
                                 const void* params, void* stream) {
  const int* q = static_cast<const int*>(params);
  ClassifyParams p;
  for (int c = 0; c < 3; ++c)
    for (int k = 0; k < 3; ++k) p.hsv[c][k] = q[3 * c + k];
  p.hue_tol = q[9];
  p.sat_tol = q[10];
  p.arc_sat = q[11];
  p.vib_tol = q[12];
  p.min_sat = q[13];
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond ~64 blocks/SM
  classify_luma_kernel<<<(unsigned)blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(r8), static_cast<const uint8_t*>(g8),
      static_cast<const uint8_t*>(b8), static_cast<uint8_t*>(marker),
      static_cast<uint8_t*>(luma), n, p);
  return (int)cudaGetLastError();
}
