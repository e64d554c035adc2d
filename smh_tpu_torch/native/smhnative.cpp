// Native host hot loops for smh_tpu.
//
// The line-segment search is scalar pointer-chasing — the one workload in
// the pipeline that vector units (TPU or otherwise) fundamentally dislike.
// The TPU path (smh_tpu/ops/lsd.py) batches it as dense span scans; this
// module is the host-side engine for the same computation, semantically
// identical to the numpy oracle (smh_tpu/vision/reference.py), which in turn
// ports vision-cpu/src/lib.rs:387-449 + vision-common/src/lsd.rs:5-107 from
// the reference. float accumulation matches Rust's f32 ops exactly.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in the image).

#include <cmath>
#include <cstdint>
#include <cstring>

#include "smh_consts.h"  // generated from consts.toml by smh_tpu/consts.py

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int N_ANGLES = (int)LSD_NUM_ANGLES;
constexpr float PI_F = 3.14159265358979323846f;

struct LineResult {
    float x0, y0, x1, y1, len2;
};

// A (possibly windowed) view of the LSD mask: crop memory of (ch, cw) bytes
// placed at (ox, oy) inside a logical full plane of (fh, fw). All float
// coordinates below are FULL-plane coordinates — pixels outside the crop
// read as 0 (black), which is exact because the crop covers the white-pixel
// bounding box by construction (smh_tpu/ops/pipeline.py hostpack v2). With
// ox = oy = 0 and crop == full this degenerates to the round-1 behaviour,
// so windowed and full runs are bit-identical.
struct MaskView {
    const uint8_t* p;
    int ch, cw;  // crop memory dims
    int fh, fw;  // logical full-plane dims (bounds checks use these)
    int ox, oy;  // crop origin in the full plane
};

inline uint8_t sample(const MaskView& v, uint32_t xi, uint32_t yi) {
    const int cx = (int)xi - v.ox;
    const int cy = (int)yi - v.oy;
    if (cx < 0 || cy < 0 || cx >= v.cw || cy >= v.ch) return 0;
    return v.p[(size_t)cy * v.cw + cx];
}

inline bool in_bounds_f(float x, float y, int w, int h) {
    return x >= 0.0f && y >= 0.0f && x < (float)w && y < (float)h;
}

// Exact port of the oracle's single-angle ray march (vision-cpu:388-432).
inline void march_one(const MaskView& v, float x_start,
                      float y_start, float max_gap, float dx, float dy,
                      float* out_xe, float* out_ye) {
    const int w = v.fw, h = v.fh;
    float x = x_start, y = y_start;
    float x_end = x_start, y_end = y_start;
    float gap0 = 0.0f, gap_sx = 0.0f, gap_sy = 0.0f;
    float x_off = 0.0f, y_off = 0.0f;

    while (in_bounds_f(x, y, w, h)) {
        const uint8_t px = sample(v, (uint32_t)x, (uint32_t)y);
        if (px == 255) {
            gap0 = 0.0f; gap_sx = 0.0f; gap_sy = 0.0f;
        } else if (gap0 >= max_gap) {
            x = gap_sx; y = gap_sy;
            break;
        } else if (gap0 == 0.0f) {
            gap0 = 1.0f; gap_sx = x; gap_sy = y;
        } else {
            gap0 += 1.0f;
        }
        x_off += dx;
        y_off += dy;
        x = x_off + x_start;
        y = y_off + y_start;
    }

    // Final check with Rust's saturating f32->u32 cast (negatives -> 0).
    const uint32_t xi = x < 0.0f ? 0u : (uint32_t)x;
    const uint32_t yi = y < 0.0f ? 0u : (uint32_t)y;
    if (xi < (uint32_t)w && yi < (uint32_t)h && sample(v, xi, yi) == 0) {
        x_end = x - dx;
        y_end = y - dy;
    }
    *out_xe = x_end;
    *out_ye = y_end;
}

inline void longest_line(const MaskView& v, float px, float py,
                         float max_gap, LineResult* out) {
    float best_len = -1.0f;
    int best_idx = -1;
    float best_xe = px, best_ye = py;

#ifdef _OPENMP
#pragma omp parallel
    {
        float loc_len = -1.0f;
        int loc_idx = -1;
        float loc_xe = px, loc_ye = py;
#pragma omp for nowait schedule(static)
        for (int a = 0; a < N_ANGLES; a++) {
            const float theta = ((float)a / 10.0f) * (PI_F / 180.0f);
            const float dx = cosf(theta), dy = sinf(theta);
            float xe, ye;
            march_one(v, px, py, max_gap, dx, dy, &xe, &ye);
            const float l = (px - xe) * (px - xe) + (py - ye) * (py - ye);
            // ties -> higher angle index ("last max wins", like the
            // reference's right-biased fold)
            if (l > loc_len || (l == loc_len && a > loc_idx)) {
                loc_len = l; loc_idx = a; loc_xe = xe; loc_ye = ye;
            }
        }
#pragma omp critical
        {
            if (loc_len > best_len || (loc_len == best_len && loc_idx > best_idx)) {
                best_len = loc_len; best_idx = loc_idx;
                best_xe = loc_xe; best_ye = loc_ye;
            }
        }
    }
#else
    for (int a = 0; a < N_ANGLES; a++) {
        const float theta = ((float)a / 10.0f) * (PI_F / 180.0f);
        const float dx = cosf(theta), dy = sinf(theta);
        float xe, ye;
        march_one(v, px, py, max_gap, dx, dy, &xe, &ye);
        const float l = (px - xe) * (px - xe) + (py - ye) * (py - ye);
        if (l > best_len || (l == best_len && a > best_idx)) {
            best_len = l; best_idx = a; best_xe = xe; best_ye = ye;
        }
    }
#endif

    out->x0 = px; out->y0 = py;
    out->x1 = best_xe; out->y1 = best_ye;
    out->len2 = best_len < 0.0f ? 0.0f : best_len;
}

// Centre snap (vision-common/src/lsd.rs:5-44). Out-of-bounds reads count as
// non-white (the reference uses unchecked reads and never hits the edge).
inline void get_centre(const MaskView& v, float inx, float iny,
                       float* outx, float* outy) {
    const float MAX_DIST = LSD_CENTRE_MAX_DIST;
    const int w = v.fw, h = v.fh;
    const int yi = (int)iny;
    const int xi = (int)inx;

    auto white = [&](int x, int y) -> bool {
        return x >= 0 && x < w && y >= 0 && y < h &&
               sample(v, (uint32_t)x, (uint32_t)y) == 255;
    };

    float left = inx;
    while (left > 0.0f && fabsf(left - inx) < MAX_DIST && white((int)left, yi)) left -= 1.0f;
    float right = inx;
    while (right < (float)(w - 1) && fabsf(right - inx) < MAX_DIST && white((int)right, yi)) right += 1.0f;
    float up = iny;
    while (up > 0.0f && fabsf(up - iny) < MAX_DIST && white(xi, (int)up)) up -= 1.0f;
    float down = iny;
    while (down < (float)(h - 1) && fabsf(down - iny) < MAX_DIST && white(xi, (int)down)) down += 1.0f;

    *outx = (left + right) / 2.0f;
    *outy = (up + down) / 2.0f;
}

inline void nearest_on_line(double ptx, double pty, double x0, double y0,
                            double x1, double y1, double* nx, double* ny) {
    const double dx = x1 - x0, dy = y1 - y0;
    if (dx == 0.0 && dy == 0.0) { *nx = x0; *ny = y0; return; }
    const double u = ((ptx - x0) * dx + (pty - y0) * dy) / (dx * dx + dy * dy);
    *nx = x0 + u * dx;
    *ny = y0 + u * dy;
}

}  // namespace

extern "C" {

// Longest line from one seed. out = {x0, y0, x1, y1, len2}.
void smh_find_longest_line(const uint8_t* mask, int h, int w, float px,
                           float py, float max_gap, float* out) {
    const MaskView v{mask, h, w, h, w, 0, 0};
    LineResult r;
    longest_line(v, px, py, max_gap, &r);
    out[0] = r.x0; out[1] = r.y0; out[2] = r.x1; out[3] = r.y1; out[4] = r.len2;
}

// Full seed scan with suppression (vision-common/src/lsd.rs:60-107),
// over a windowed view: the crop holds every white pixel, so scanning it in
// row-major order visits exactly the seeds a full-plane scan would, in the
// same order; all geometry runs in full-plane coordinates.
static int find_lines_view(const MaskView& v, int max_gap, int max_lines,
                           float min_len_sqr, float dedup_dist_sqr,
                           float* out_lines) {
    if (max_lines <= 0) return 0;
    const float mg = (float)max_gap;
    int n_lines = 0;

    for (int cy = 0; cy < v.ch; cy++) {
        for (int cx = 0; cx < v.cw; cx++) {
            if (v.p[(size_t)cy * v.cw + cx] != 255) continue;
            const int x = cx + v.ox;
            const int y = cy + v.oy;

            // suppression against accepted lines (infinite-line distance)
            bool suppressed = false;
            for (int i = 0; i < n_lines; i++) {
                double nx, ny;
                nearest_on_line((double)x, (double)y, out_lines[i * 4 + 0],
                                out_lines[i * 4 + 1], out_lines[i * 4 + 2],
                                out_lines[i * 4 + 3], &nx, &ny);
                const double ddx = (double)x - nx, ddy = (double)y - ny;
                if (ddx * ddx + ddy * ddy < (double)dedup_dist_sqr) {
                    suppressed = true;
                    break;
                }
            }
            if (suppressed) continue;

            float sx, sy;
            get_centre(v, (float)x, (float)y, &sx, &sy);

            LineResult r;
            longest_line(v, sx, sy, mg, &r);

            if (r.len2 > min_len_sqr) {
                float ex, ey;
                get_centre(v, r.x1, r.y1, &ex, &ey);
                out_lines[n_lines * 4 + 0] = r.x0;
                out_lines[n_lines * 4 + 1] = r.y0;
                out_lines[n_lines * 4 + 2] = ex;
                out_lines[n_lines * 4 + 3] = ey;
                n_lines++;
                if (n_lines == max_lines) return n_lines;
            }
        }
    }
    return n_lines;
}

int smh_find_lines(const uint8_t* mask, int h, int w, int max_gap,
                   int max_lines, float min_len_sqr, float dedup_dist_sqr,
                   float* out_lines) {
    const MaskView v{mask, h, w, h, w, 0, 0};
    return find_lines_view(v, max_gap, max_lines, min_len_sqr, dedup_dist_sqr,
                           out_lines);
}

// Windowed scan: crop (ch, cw) at (ox, oy) of a (fh, fw) plane; results in
// full-plane coordinates, bit-identical to scanning the full plane.
int smh_find_lines_view(const uint8_t* crop, int ch, int cw, int fh, int fw,
                        int ox, int oy, int max_gap, int max_lines,
                        float min_len_sqr, float dedup_dist_sqr,
                        float* out_lines) {
    const MaskView v{crop, ch, cw, fh, fw, ox, oy};
    return find_lines_view(v, max_gap, max_lines, min_len_sqr, dedup_dist_sqr,
                           out_lines);
}

// Delta-transport diff: indices of 32-byte sub-chunks where a != b.
//
// Exactly the output of the Python two-level refine (tpu_backend.
// _refine_subchunks over a 128 B u64-view compare): the 128 B level only
// exists to keep the numpy two-pass cheap — "all differing 32 B sub-chunks"
// is the same set. numpy pays ~10.7 ms at 4K (the elementwise != builds an
// 18.7 M bool temp, then flatnonzero re-reads it); this loop runs at memory
// speed (~1-2 ms for 2x18.7 MB) and emits indices directly. n_bytes must be
// a multiple of 32 (the transport pads to _DELTA_CHUNK=128). out_idx must
// hold n_bytes/32 entries (worst case). Returns the count.
int smh_diff_subchunks(const uint8_t* a, const uint8_t* b, int64_t n_bytes,
                       int32_t* out_idx) {
    const uint64_t* pa = (const uint64_t*)a;
    const uint64_t* pb = (const uint64_t*)b;
    const int64_t n_sub = n_bytes >> 5;  // 32 B = 4 u64
    int64_t n = 0;
    for (int64_t i = 0; i < n_sub; i++) {
        const int64_t o = i << 2;
        const uint64_t d = (pa[o] ^ pb[o]) | (pa[o + 1] ^ pb[o + 1]) |
                           (pa[o + 2] ^ pb[o + 2]) | (pa[o + 3] ^ pb[o + 3]);
        if (d) out_idx[n++] = (int32_t)i;
    }
    return (int)n;
}

// Gather the changed sub-chunks into the upload buffer: idx table (int32,
// padded to `bucket` by repeating the last index) followed by the 32 B
// payloads. Mirrors the numpy tail of load_frame; one pass, no fancy-index
// temps. Requires n_changed >= 1 and bucket >= n_changed.
void smh_gather_subchunks(const uint8_t* packed, const int32_t* idx,
                          int n_changed, int bucket, uint8_t* out) {
    int32_t* oidx = (int32_t*)out;
    uint8_t* odata = out + (size_t)bucket * 4;
    const int32_t last = idx[n_changed - 1];
    for (int i = 0; i < bucket; i++) {
        const int32_t k = i < n_changed ? idx[i] : last;
        oidx[i] = k;
        std::memcpy(odata + (size_t)i * 32, packed + (size_t)k * 32, 32);
    }
}

int smh_native_version() { return 4; }

}  // extern "C"

// -- fused planarize + delta diff --------------------------------------------
//
// The per-frame host half used to be two full passes over the ROI buffer:
// cv2.split (read 13 MB BGRA, write 9.7 MB planes + a discarded 3.2 MB alpha
// scratch at 4K) then smh_diff_subchunks (re-read the 9.7 MB packed buffer
// from DRAM plus the 9.7 MB mirror). This kernel does both in ONE sweep:
// deinterleave the BGRA map ROI into the plane-major layout the device pass
// reads (tpu_backend._pack_rois_bgr) while comparing every written 32 B
// window against the mirror, marking changed sub-chunks in a bitmap. The
// bytes are compared while still in registers, so the packed buffer is
// written once and never re-read.
//
// Sub-chunk marking: plane rows start at arbitrary offsets mod 32, so one
// 32-byte compare window can straddle two sub-chunks; the mismatch mask is
// split at the sub-chunk boundary. A final sweep over the bitmap emits the
// changed indices in ascending order — the EXACT set (and order) that
// smh_diff_subchunks / the numpy two-level refine produce.

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

inline void mark_window(uint8_t* dirty, int64_t o, uint32_t mismatch) {
    if (!mismatch) return;
    const int shift = (int)(o & 31);
    if (shift == 0) {
        dirty[o >> 5] = 1;
        return;
    }
    const uint32_t lowmask = (1u << (32 - shift)) - 1u;
    if (mismatch & lowmask) dirty[o >> 5] = 1;
    if (mismatch & ~lowmask) dirty[(o >> 5) + 1] = 1;
}

// INPLACE: `packed` doubles as the diff base (the rolling chain mirror) —
// every window is COMPARED first and stored only on mismatch, so unchanged
// content costs reads only (no RFO/write traffic) and the buffer rolls
// forward to the current frame without a separate mirror. Produces the
// same changed-index set as the out-of-place diff against a mirror whose
// bytes equal the rolling buffer's pre-call content.
template <bool DIFF, bool INPLACE>
void pack_diff_impl(const uint8_t* map_bgra, int64_t map_pitch, int mh,
                    int mw, const uint8_t* btn_bgra, int64_t btn_pitch,
                    int bh, int bw, int64_t total, uint8_t* packed,
                    const uint8_t* mirror, uint8_t* dirty) {
    static_assert(!INPLACE || DIFF, "INPLACE implies DIFF");
    if (INPLACE) mirror = packed;
    const int64_t msz = (int64_t)mh * mw;

#if defined(__AVX2__)
    const __m256i shuf = _mm256_setr_epi8(
        0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15,
        0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15);
    const __m256i perm = _mm256_setr_epi32(0, 4, 1, 5, 2, 6, 3, 7);
#endif

    for (int y = 0; y < mh; y++) {
        const uint8_t* row = map_bgra + (int64_t)y * map_pitch;
        const int64_t rowbase = (int64_t)y * mw;
        int x = 0;
#if defined(__AVX2__)
        for (; x + 32 <= mw; x += 32) {
            const uint8_t* src = row + (int64_t)x * 4;
            __m256i r0 = _mm256_loadu_si256((const __m256i*)(src));
            __m256i r1 = _mm256_loadu_si256((const __m256i*)(src + 32));
            __m256i r2 = _mm256_loadu_si256((const __m256i*)(src + 64));
            __m256i r3 = _mm256_loadu_si256((const __m256i*)(src + 96));
            // Per 16 B lane (4 pixels): gather to [BBBB GGGG RRRR AAAA].
            r0 = _mm256_shuffle_epi8(r0, shuf);
            r1 = _mm256_shuffle_epi8(r1, shuf);
            r2 = _mm256_shuffle_epi8(r2, shuf);
            r3 = _mm256_shuffle_epi8(r3, shuf);
            // Dword unpacks collect same-channel dwords across registers;
            // the final vpermd restores pixel order within each plane.
            __m256i u0 = _mm256_unpacklo_epi32(r0, r1);
            __m256i u1 = _mm256_unpackhi_epi32(r0, r1);
            __m256i u2 = _mm256_unpacklo_epi32(r2, r3);
            __m256i u3 = _mm256_unpackhi_epi32(r2, r3);
            __m256i b = _mm256_permutevar8x32_epi32(
                _mm256_unpacklo_epi64(u0, u2), perm);
            __m256i g = _mm256_permutevar8x32_epi32(
                _mm256_unpackhi_epi64(u0, u2), perm);
            __m256i r = _mm256_permutevar8x32_epi32(
                _mm256_unpacklo_epi64(u1, u3), perm);
            const int64_t ob = rowbase + x;
            const int64_t og = msz + ob;
            const int64_t orr = 2 * msz + ob;
            if (DIFF) {
                // Compare BEFORE storing: in INPLACE mode the comparand IS
                // the destination (mark_window splits straddling windows).
                const uint32_t eb = (uint32_t)_mm256_movemask_epi8(
                    _mm256_cmpeq_epi8(
                        b, _mm256_loadu_si256((const __m256i*)(mirror + ob))));
                const uint32_t eg = (uint32_t)_mm256_movemask_epi8(
                    _mm256_cmpeq_epi8(
                        g, _mm256_loadu_si256((const __m256i*)(mirror + og))));
                const uint32_t er = (uint32_t)_mm256_movemask_epi8(
                    _mm256_cmpeq_epi8(
                        r, _mm256_loadu_si256((const __m256i*)(mirror + orr))));
                if (!INPLACE || ~eb)
                    _mm256_storeu_si256((__m256i*)(packed + ob), b);
                if (!INPLACE || ~eg)
                    _mm256_storeu_si256((__m256i*)(packed + og), g);
                if (!INPLACE || ~er)
                    _mm256_storeu_si256((__m256i*)(packed + orr), r);
                mark_window(dirty, ob, ~eb);
                mark_window(dirty, og, ~eg);
                mark_window(dirty, orr, ~er);
            } else {
                _mm256_storeu_si256((__m256i*)(packed + ob), b);
                _mm256_storeu_si256((__m256i*)(packed + og), g);
                _mm256_storeu_si256((__m256i*)(packed + orr), r);
            }
        }
#endif
        for (; x < mw; x++) {  // row tail (and the whole row without AVX2)
            const uint8_t* px = row + (int64_t)x * 4;
            const int64_t o = rowbase + x;
            for (int c = 0; c < 3; c++) {
                const int64_t oc = (int64_t)c * msz + o;
                const uint8_t v = px[c];
                // Compare first: INPLACE aliases mirror and packed.
                if (DIFF && v != mirror[oc]) dirty[oc >> 5] = 1;
                packed[oc] = v;
            }
        }
    }

    // Button ROI: interleaved BGR right after the planes (it is tiny).
    const int64_t btn_base = 3 * msz;
    for (int y = 0; y < bh; y++) {
        const uint8_t* row = btn_bgra + (int64_t)y * btn_pitch;
        for (int x = 0; x < bw; x++) {
            const int64_t o = btn_base + ((int64_t)y * bw + x) * 3;
            for (int c = 0; c < 3; c++) {
                const uint8_t v = row[(int64_t)x * 4 + c];
                if (DIFF && v != mirror[o + c]) dirty[(o + c) >> 5] = 1;
                packed[o + c] = v;
            }
        }
    }

    // Zero the chunk-grid padding (mirrors are packed buffers, so their
    // tails are zero too — compared anyway for safety).
    const int64_t used = btn_base + (int64_t)bh * bw * 3;
    for (int64_t o = used; o < total; o++) {
        if (DIFF && mirror[o]) dirty[o >> 5] = 1;
        packed[o] = 0;
    }
}

// Ascending changed sub-chunk indices from the dirty bitmap (shared by
// both pack+diff entry points).
int emit_dirty(const uint8_t* dirty, int64_t n_sub, int32_t* out_idx) {
    int n = 0;
    int64_t i = 0;
    for (; i + 8 <= n_sub; i += 8) {
        uint64_t w;
        std::memcpy(&w, dirty + i, 8);
        if (!w) continue;
        for (int k = 0; k < 8; k++)
            if (dirty[i + k]) out_idx[n++] = (int32_t)(i + k);
    }
    for (; i < n_sub; i++)
        if (dirty[i]) out_idx[n++] = (int32_t)i;
    return n;
}

}  // namespace

extern "C" {

// Fused planarize + delta diff. Packs the BGRA map ROI (row pitch
// `map_pitch` bytes) as plane-major BGR into packed[0..3*mh*mw), the BGRA
// button ROI interleaved-BGR after it, zeroes the tail up to `total`
// (a multiple of 32), and — when `mirror` is non-NULL — marks every 32 B
// sub-chunk whose bytes differ from mirror. `dirty` is caller scratch of
// total/32 bytes (zeroed here). Changed sub-chunk indices are emitted to
// out_idx in ascending order; returns the count, or -1 in pack-only mode.
int smh_pack_diff(const uint8_t* map_bgra, int64_t map_pitch, int mh, int mw,
                  const uint8_t* btn_bgra, int64_t btn_pitch, int bh, int bw,
                  int64_t total, uint8_t* packed, const uint8_t* mirror,
                  uint8_t* dirty, int32_t* out_idx) {
    if (mirror == nullptr) {
        pack_diff_impl<false, false>(map_bgra, map_pitch, mh, mw, btn_bgra,
                                     btn_pitch, bh, bw, total, packed,
                                     nullptr, nullptr);
        return -1;
    }
    const int64_t n_sub = total >> 5;
    std::memset(dirty, 0, (size_t)n_sub);
    pack_diff_impl<true, false>(map_bgra, map_pitch, mh, mw, btn_bgra,
                                btn_pitch, bh, bw, total, packed, mirror,
                                dirty);
    return emit_dirty(dirty, n_sub, out_idx);
}

// In-place rolling pack+diff: `roll` holds the previous frame's packed
// bytes on entry (the chain mirror) and the CURRENT frame's on return.
// Windows are compared before being (conditionally) stored, so unchanged
// content pays read traffic only — no separate mirror buffer, no
// read-for-ownership on the ~90% of the ROI that does not move between
// frames. Changed 32 B sub-chunk indices (identical set and order to
// smh_pack_diff against an equal-content mirror) go to out_idx; returns
// the count. The caller must gather the changed payload bytes out of
// `roll` before packing the next frame over it.
int smh_pack_diff_roll(const uint8_t* map_bgra, int64_t map_pitch, int mh,
                       int mw, const uint8_t* btn_bgra, int64_t btn_pitch,
                       int bh, int bw, int64_t total, uint8_t* roll,
                       uint8_t* dirty, int32_t* out_idx) {
    const int64_t n_sub = total >> 5;
    std::memset(dirty, 0, (size_t)n_sub);
    pack_diff_impl<true, true>(map_bgra, map_pitch, mh, mw, btn_bgra,
                               btn_pitch, bh, bw, total, roll, nullptr,
                               dirty);
    return emit_dirty(dirty, n_sub, out_idx);
}

}  // extern "C"
