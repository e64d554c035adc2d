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
// more. So a thread takes an aligned unit of BYTES output bytes (a 32-bit
// word), in blocks of whole output rows (threadIdx.y the row, threadIdx.x
// its unit, so no division): output byte c of row r is source bytes (cx0 /
// 8 + c) and the one after it of row cy0 + r, shifted left by cx0 mod 8,
// so the unit comes from BYTES + 1 source bytes, which lie in the WORDS + 1
// aligned 32-bit words under them; neighbouring threads read neighbouring
// words. A word is read only where it holds a byte of the row (the last
// byte of a row has none after it: the bits it would give lie past column
// W, so past crop_w, and are cleared with the pad bits). Each word goes
// big-endian (__byte_perm), two of them give an output word by
// __funnelshift_l by 8 x (the byte offset mod 4) + cx0 mod 8 with no
// select, and it goes back to memory order: one store where the unit lies
// inside the row, bytes at the row's ends.
//
// Designs beside it in turns on the card (probe_window_crop.py's variants;
// device us at the 1080p / 4K half-size windows / B = 8, against 1.50 /
// 1.52 / 1.71; NVIDIA H100 80GB HBM3, 700 W): the design before it, a thread an output byte
// from two byte loads 1.43 / 1.64 / 1.94 (the chain floor, the launch and
// two dependent loads, is 1.13); blocks of 64 threads 1.51 / 1.57 / 2.07,
// of 128 1.48 / 1.58 / 1.82, of 512 1.59 / 1.54 / 1.70; 16 bytes a thread
// 2.10 / 1.86 / 2.22 (1.50 / 1.51 / 1.78 in blocks of 64).
//
// A batch is one launch: blockIdx.y selects the frame, whose bits start at
// bits + f * bits_stride bytes, its bbox at words + f * words_stride i32s
// and its output at out + f * out_stride bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BYTES = 4;  // output bytes a thread: one aligned 32-bit word of a row
constexpr int WORDS = BYTES / 4;
constexpr int META = 6;  // i32: y0, y1, x0, x1, cy0, cx0

__device__ __forceinline__ uint32_t big_endian(uint32_t x) { return __byte_perm(x, 0u, 0x0123); }

// The aligned 32-bit word at a, big-endian, or zero where it holds no byte
// of [lo, hi).
__device__ __forceinline__ uint32_t word_in(uintptr_t a, uintptr_t lo, uintptr_t hi) {
  return a < hi && a + 4 > lo ? big_endian(__ldg(reinterpret_cast<const uint32_t*>(a))) : 0u;
}

__global__ void __launch_bounds__(THREADS)
    window_crop_kernel(const uint8_t* __restrict__ bits, int64_t bits_stride, int H, int W, int bpr,
                       const int32_t* __restrict__ words, int64_t words_stride, int crop_h, int crop_w, int cbpr,
                       int margin, uint8_t* __restrict__ out, int64_t out_stride) {
  const int64_t f = blockIdx.y;
  bits += f * bits_stride;
  words += f * words_stride;
  out += f * out_stride;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  const int y0 = __ldg(words + 0);
  const int x0 = __ldg(words + 2);
  const int cy0 = min(max(y0 - margin, 0), H - crop_h);
  const int cx0 = min(max(x0 - margin, 0), W - crop_w);
  if (blockIdx.x == 0 && t < META)
    reinterpret_cast<int32_t*>(out)[t] = t < 4 ? __ldg(words + t) : (t == 4 ? cy0 : cx0);
  const int r = blockIdx.x * blockDim.y + threadIdx.y;  // this thread's row, and threadIdx.x its unit of it
  if (r >= crop_h) return;
  const uintptr_t d = reinterpret_cast<uintptr_t>(out + 4 * META + (int64_t)r * cbpr);  // the row's byte 0
  const uintptr_t p = (d & ~uintptr_t(BYTES - 1)) + BYTES * (uintptr_t)threadIdx.x;  // this thread's unit
  const int c = (int)((intptr_t)p - (intptr_t)d);  // the row's byte at the unit's start (< 0 at its head)
  if (c >= cbpr) return;

  // Source bytes sb .. sb + BYTES of row cy0 + r (the BYTES under the unit
  // and the one after), from the WORDS + 1 aligned 32-bit words under them.
  const uintptr_t row = reinterpret_cast<uintptr_t>(bits + (int64_t)(cy0 + r) * bpr);
  const uintptr_t sp = row + (intptr_t)((cx0 >> 3) + c);
  const uintptr_t a = sp & ~uintptr_t(3);
  uint32_t e[WORDS + 1];
#pragma unroll
  for (int i = 0; i <= WORDS; ++i) e[i] = word_in(a + 4 * i, row, row + bpr);
  const int s = 8 * (int)(sp & 3) + (cx0 & 7);  // <= 31
  uint32_t o[WORDS];
#pragma unroll
  for (int i = 0; i < WORDS; ++i) o[i] = big_endian(__funnelshift_l(e[i + 1], e[i], s));
  const int tail = crop_w & 7;
  const int last = cbpr - 1 - c;  // the unit's byte that is the row's last
  if (tail != 0 && last < BYTES) {
    const uint32_t pad = ~((0xffu >> tail) << (8 * (last & 3)));  // clears the pad bits of byte last
#pragma unroll
    for (int i = 0; i < WORDS; ++i) o[i] &= (last >> 2) == i ? pad : ~0u;
  }
  if (c >= 0 && c + BYTES <= cbpr) {
    if constexpr (WORDS == 4)
      *reinterpret_cast<uint4*>(p) = make_uint4(o[0], o[1], o[2], o[3]);
    else
      *reinterpret_cast<uint32_t*>(p) = o[0];
    return;
  }
#pragma unroll
  for (int i = 0; i < BYTES; ++i)
    if (c + i >= 0 && c + i < cbpr) reinterpret_cast<uint8_t*>(p)[i] = (uint8_t)(o[i >> 2] >> (8 * (i & 3)));
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
  const int upr = (cbpr + 2 * BYTES - 2) / BYTES;  // the aligned units a row's bytes can touch
  const int64_t n = (int64_t)crop_h * cbpr;
  if (H <= 0 || W <= 0 || crop_h <= 0 || crop_w <= 0 || crop_h > H || crop_w > W || B <= 0 || B > 65535 ||
      margin < 0 || upr > THREADS || n > INT32_MAX - THREADS || out_stride < 4 * META + n ||
      (out_stride & 3) != 0 || (reinterpret_cast<uintptr_t>(out) & 3) != 0)
    return (int)cudaErrorInvalidValue;
  const int rpb = THREADS / upr;  // rows a block, a thread each of their units
  const unsigned blocks = (unsigned)((crop_h + rpb - 1) / rpb);
  window_crop_kernel<<<dim3(blocks, B), dim3(upr, rpb), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), bits_stride, H, W, bpr, static_cast<const int32_t*>(words), words_stride,
      crop_h, crop_w, cbpr, margin, static_cast<uint8_t*>(out), out_stride);
  return (int)cudaGetLastError();
}
