// The window crop of the dilated marker mask: the crop_h x crop_w window of
// kernel 3's bit plane at the mask's bbox less a margin, clamped into the
// plane, bit-packed afresh, and its 24-byte meta.
//
// Replaces a region of smh_tpu's jitted fused pass (XLA ops, not a Pallas
// kernel; smh_tpu/ops/pipeline.py::_pack_outputs :792): the clamped origin
// (`jnp.clip` of bbox - margin, :813-814), the `jax.lax.dynamic_slice` of
// the bool mask lsd_bool (:815-816), the meta (:819-821) and the window's
// `pack_bits` (:885). The plain twin is smh_tpu_torch/ops/kernels.py::
// window_crop_plain (unpack, gather, pack); every output byte equals it.
// Per frame it writes, 4-byte aligned:
//
//   y0, y1, x0, x1, cy0, cx0   i32: kernel 7's bbox and the window's origin,
//                              cy0 = clamp(y0 - margin, 0, H - crop_h),
//                              cx0 = clamp(x0 - margin, 0, W - crop_w)
//   crop_h x ceil(crop_w / 8)  bytes: window pixel (r, c) is mask pixel
//                              (cy0 + r, cx0 + c), MSB first (np.packbits
//                              order), pad bits zero
//
// that is the hostpack's lsd_meta and lsd_crop sections. An empty mask
// (kernel 7's y0 = H, x0 = W) takes the clamped origin JAX computes for it.
//
// What bounds it on an H100: not its bytes. At the 1080p map's half-size
// window (411 x 493 of 822 x 986) it reads ~26 KB of bits and writes as
// much (~0.015 us at 3.35 TB/s); the launch (~1 us) and its chain of two
// dependent loads (the bbox, then the bits at the origin it gives) cost
// more. The design is the simplest that needs no host sync and no memset:
// a thread an output byte, which is source bytes (cx0 / 8 + c) and the one
// after it of row cy0 + r, shifted left by cx0 mod 8. Byte loads keep the
// MSB-first order (a 32-bit load would need a byte swap before its funnel
// shift), and neighbouring threads read neighbouring bytes. The second
// byte is read only where it lies inside the row (the last byte of a row
// has none after it); the bits it would give lie past column W, so past
// crop_w, and are cleared with the pad bits.
//
// A batch is one launch: blockIdx.y selects the frame, whose bits start at
// bits + f * bits_stride bytes, its bbox at words + f * words_stride i32s
// and its output at out + f * out_stride bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int META = 6;  // i32: y0, y1, x0, x1, cy0, cx0

__global__ void __launch_bounds__(THREADS)
    window_crop_kernel(const uint8_t* __restrict__ bits, int64_t bits_stride, int H, int W, int bpr,
                       const int32_t* __restrict__ words, int64_t words_stride, int crop_h, int crop_w, int cbpr,
                       int margin, uint8_t* __restrict__ out, int64_t out_stride) {
  const int64_t f = blockIdx.y;
  bits += f * bits_stride;
  words += f * words_stride;
  out += f * out_stride;
  const int y0 = __ldg(words + 0);
  const int x0 = __ldg(words + 2);
  const int cy0 = min(max(y0 - margin, 0), H - crop_h);
  const int cx0 = min(max(x0 - margin, 0), W - crop_w);
  if (blockIdx.x == 0 && threadIdx.x < META) {
    const int t = threadIdx.x;
    reinterpret_cast<int32_t*>(out)[t] = t < 4 ? __ldg(words + t) : (t == 4 ? cy0 : cx0);
  }
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= crop_h * cbpr) return;
  const int r = k / cbpr;
  const int c = k - r * cbpr;
  const uint8_t* row = bits + (int64_t)(cy0 + r) * bpr;
  const int sb = (cx0 >> 3) + c;  // < bpr: the byte holds mask column cx0 + 8c < W
  const int s = cx0 & 7;
  uint32_t v = (uint32_t)__ldg(row + sb) << 8;
  if (s != 0 && sb + 1 < bpr) v |= __ldg(row + sb + 1);
  uint32_t o = (v >> (8 - s)) & 0xffu;
  const int tail = crop_w & 7;
  if (c == cbpr - 1 && tail != 0) o &= 0xffu << (8 - tail);  // the pad bits
  out[4 * META + k] = (uint8_t)o;
}

}  // namespace

// B frames: frame f's bit plane, H rows of (W + 7) / 8 bytes, at bits + f *
// bits_stride (bytes); its kernel 7 words (bbox at i32 lanes 0-3) at words
// + f * words_stride (i32s); its output, 24 + crop_h * ((crop_w + 7) / 8)
// bytes, at out + f * out_stride (bytes; out and out_stride 4-byte
// aligned). 1 <= crop_h <= H, 1 <= crop_w <= W.
extern "C" int smh_window_crop(const void* bits, int64_t bits_stride, int H, int W, const void* words,
                               int64_t words_stride, int crop_h, int crop_w, int margin, int B, void* out,
                               int64_t out_stride, void* stream) {
  const int bpr = (W + 7) / 8;
  const int cbpr = (crop_w + 7) / 8;
  const int64_t n = (int64_t)crop_h * cbpr;
  if (H <= 0 || W <= 0 || crop_h <= 0 || crop_w <= 0 || crop_h > H || crop_w > W || B <= 0 || B > 65535 ||
      margin < 0 || n > INT32_MAX - THREADS || out_stride < 4 * META + n || (out_stride & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 3) != 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  window_crop_kernel<<<dim3(blocks, B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), bits_stride, H, W, bpr, static_cast<const int32_t*>(words), words_stride,
      crop_h, crop_w, cbpr, margin, static_cast<uint8_t*>(out), out_stride);
  return (int)cudaGetLastError();
}
