// The batch delta path's rolling pack + diff + gather, split into row bands.
//
// smh_pack_diff_roll (smhnative.cpp) rolls one frame over the whole flat
// upload layout: the map as three planes of mh*mw bytes (B, G, R), the
// button interleaved BGR after them, zeros up to `total`. A batch of frames
// rolled that way is one core's sweep per frame. Here the map's rows are
// cut into bands, and one call rolls ONE band of the same global layout
// through a whole batch: frame by frame, it compares the band's bytes of
// all three planes against the rolling buffer in registers, stores the
// windows that changed, marks the changed 32 B sub-chunks in a bitmap of
// its own, and gathers their payloads before the next frame overwrites
// them. A band's bytes depend only on its own previous frame, so the bands
// of one batch run on separate threads with no barrier between frames; each
// thread writes only its own bytes of the shared buffer.
//
// A band's bytes are three segments of the layout, [c*msz + y0*mw,
// c*msz + y1*mw) for plane c (the last band's R segment runs on over the
// button and the zero tail, to `total`). Segments of neighbouring bands
// (and the B plane's last band and the G plane's first) touch, and where
// the seam is not 32 B aligned one sub-chunk holds bytes of both. Such an
// edge sub-chunk is emitted by each band every frame, changed or not: its
// index (bitwise NOT of it when this band saw no change), and a payload of
// the band's own bytes with zeros elsewhere. smh_roll_merge ORs the entries
// of one index, so the merged sub-chunk is changed when either band saw a
// change and its payload is both bands' bytes of the same frame. Sub-chunk
// 0 is emitted every frame too: it is the keep-alive payload of a frame
// with no change.
//
// Exposed via a plain C ABI for ctypes, beside smhnative.cpp in one library.

#include <cstdint>
#include <cstring>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr int SUB = 32;  // delta sub-chunk, bytes
constexpr int N_SEG = 3;  // a band's segments: one per plane

inline void mark(uint8_t* dirty, int64_t o, uint32_t mismatch) {
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

// Rows [y0, y1) of one BGRA map into the three planes of `roll`, each
// 32-pixel window compared before it is stored (stored only on change).
void roll_rows(const uint8_t* map_bgra, int64_t map_pitch, int64_t msz, int mw,
               int y0, int y1, uint8_t* roll, uint8_t* dirty) {
#if defined(__AVX2__)
    const __m256i shuf = _mm256_setr_epi8(
        0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15,
        0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15);
    const __m256i perm = _mm256_setr_epi32(0, 4, 1, 5, 2, 6, 3, 7);
#endif
    for (int y = y0; y < y1; y++) {
        const uint8_t* row = map_bgra + (int64_t)y * map_pitch;
        const int64_t rowbase = (int64_t)y * mw;
        int x = 0;
#if defined(__AVX2__)
        for (; x + 32 <= mw; x += 32) {
            const uint8_t* src = row + (int64_t)x * 4;
            __m256i r0 = _mm256_shuffle_epi8(_mm256_loadu_si256((const __m256i*)(src)), shuf);
            __m256i r1 = _mm256_shuffle_epi8(_mm256_loadu_si256((const __m256i*)(src + 32)), shuf);
            __m256i r2 = _mm256_shuffle_epi8(_mm256_loadu_si256((const __m256i*)(src + 64)), shuf);
            __m256i r3 = _mm256_shuffle_epi8(_mm256_loadu_si256((const __m256i*)(src + 96)), shuf);
            // Per 16 B lane (4 pixels) [BBBB GGGG RRRR AAAA]; the dword
            // unpacks collect each channel, vpermd restores pixel order.
            const __m256i u0 = _mm256_unpacklo_epi32(r0, r1);
            const __m256i u1 = _mm256_unpackhi_epi32(r0, r1);
            const __m256i u2 = _mm256_unpacklo_epi32(r2, r3);
            const __m256i u3 = _mm256_unpackhi_epi32(r2, r3);
            const __m256i planes[3] = {
                _mm256_permutevar8x32_epi32(_mm256_unpacklo_epi64(u0, u2), perm),
                _mm256_permutevar8x32_epi32(_mm256_unpackhi_epi64(u0, u2), perm),
                _mm256_permutevar8x32_epi32(_mm256_unpacklo_epi64(u1, u3), perm),
            };
            for (int c = 0; c < 3; c++) {
                const int64_t o = c * msz + rowbase + x;
                const uint32_t ne = ~(uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(
                    planes[c], _mm256_loadu_si256((const __m256i*)(roll + o))));
                if (ne) {
                    _mm256_storeu_si256((__m256i*)(roll + o), planes[c]);
                    mark(dirty, o, ne);
                }
            }
        }
#endif
        for (; x < mw; x++) {  // row tail (and the whole row without AVX2)
            const uint8_t* px = row + (int64_t)x * 4;
            for (int c = 0; c < 3; c++) {
                const int64_t o = c * msz + rowbase + x;
                if (px[c] != roll[o]) {
                    roll[o] = px[c];
                    dirty[o >> 5] = 1;
                }
            }
        }
    }
}

// The button, interleaved BGR at 3*msz, then zeros up to `total`.
void roll_tail(const uint8_t* btn_bgra, int64_t btn_pitch, int bh, int bw,
               int64_t base, int64_t total, uint8_t* roll, uint8_t* dirty) {
    for (int y = 0; y < bh; y++) {
        const uint8_t* row = btn_bgra + (int64_t)y * btn_pitch;
        for (int x = 0; x < bw; x++) {
            const int64_t o = base + ((int64_t)y * bw + x) * 3;
            for (int c = 0; c < 3; c++) {
                if (row[(int64_t)x * 4 + c] != roll[o + c]) {
                    roll[o + c] = row[(int64_t)x * 4 + c];
                    dirty[(o + c) >> 5] = 1;
                }
            }
        }
    }
    for (int64_t o = base + (int64_t)bh * bw * 3; o < total; o++) {
        if (roll[o]) {
            roll[o] = 0;
            dirty[o >> 5] = 1;
        }
    }
}

// One entry: the index (NOT-ed when unchanged) and the segment's own bytes
// of the sub-chunk, zeros elsewhere.
inline void put(int64_t k, bool changed, int64_t start, int64_t end,
                const uint8_t* roll, int32_t* idx, uint8_t* data) {
    *idx = changed ? (int32_t)k : ~(int32_t)k;
    const int64_t cs = k * SUB;
    if (cs >= start && cs + SUB <= end) {
        std::memcpy(data, roll + cs, SUB);
        return;
    }
    const int64_t s = cs > start ? cs : start;
    const int64_t e = cs + SUB < end ? cs + SUB : end;
    std::memset(data, 0, SUB);
    std::memcpy(data + (s - cs), roll + s, (size_t)(e - s));
}

// The segment [start, end)'s entries: its changed sub-chunks, and its
// first and last ones (and sub-chunk 0) changed or not when they are
// partial. -> entries written.
int emit(int64_t start, int64_t end, const uint8_t* roll, const uint8_t* dirty,
         int32_t* idx, uint8_t* data) {
    const int64_t lo = start / SUB, hi = (end + SUB - 1) / SUB;
    int n = 0;
    auto one = [&](int64_t k, bool always) {
        if (!dirty[k] && !always) return;
        put(k, dirty[k] != 0, start, end, roll, idx + n, data + (int64_t)n * SUB);
        n++;
    };
    if (lo >= hi) return 0;
    one(lo, lo * SUB < start || (lo + 1) * SUB > end || lo == 0);
    int64_t k = lo + 1;
    for (; k + 8 <= hi - 1; k += 8) {  // interior: whole sub-chunks, changed only
        uint64_t w;
        std::memcpy(&w, dirty + k, 8);
        if (!w) continue;
        for (int i = 0; i < 8; i++)
            if (dirty[k + i]) one(k + i, false);
    }
    for (; k < hi - 1; k++)
        if (dirty[k]) one(k, false);
    if (hi - 1 > lo) one(hi - 1, hi * SUB > end);
    return n;
}

// The segments of rows [y0, y1): plane c's, the last band's R segment
// through the button and the tail.
void segments(int64_t msz, int mw, int mh, int y0, int y1, int64_t total,
              int64_t* start, int64_t* end) {
    for (int c = 0; c < N_SEG; c++) {
        start[c] = c * msz + (int64_t)y0 * mw;
        end[c] = c * msz + (int64_t)y1 * mw;
    }
    if (y1 == mh) end[N_SEG - 1] = total;
}

}  // namespace

extern "C" {

// Entries one band can emit a frame: every sub-chunk its segments touch.
int64_t smh_roll_band_cap(int mh, int mw, int y0, int y1, int64_t total) {
    int64_t start[N_SEG], end[N_SEG], cap = 0;
    segments((int64_t)mh * mw, mw, mh, y0, y1, total, start, end);
    for (int c = 0; c < N_SEG; c++)
        if (end[c] > start[c]) cap += (end[c] + SUB - 1) / SUB - start[c] / SUB;
    return cap;
}

// Roll rows [y0, y1) of the map (and, for the band with y1 == mh, the button
// and the zero tail) through n_frames frames. maps[f] / btns[f] point at
// frame f's BGRA map and button ROIs (row pitches map_pitch[f], btn_pitch[f]).
// `roll` is the chain's rolling buffer of `total` bytes, shared by the
// bands; `dirty` is this band's own scratch of total/32 bytes. Frame f's
// entries go to idx[f*cap ...] and data[(f*cap ...)*32], segment by
// segment, their counts to cnt[f*3 + c].
void smh_roll_band(const uint8_t* const* maps, const int64_t* map_pitch,
                   const uint8_t* const* btns, const int64_t* btn_pitch,
                   int n_frames, int mh, int mw, int bh, int bw, int64_t total,
                   int y0, int y1, uint8_t* roll, uint8_t* dirty, int64_t cap,
                   int32_t* idx, uint8_t* data, int32_t* cnt) {
    const int64_t msz = (int64_t)mh * mw;
    int64_t start[N_SEG], end[N_SEG];
    segments(msz, mw, mh, y0, y1, total, start, end);
    for (int f = 0; f < n_frames; f++) {
        for (int c = 0; c < N_SEG; c++)
            if (end[c] > start[c])
                std::memset(dirty + start[c] / SUB, 0,
                            (size_t)((end[c] + SUB - 1) / SUB - start[c] / SUB));
        roll_rows(maps[f], map_pitch[f], msz, mw, y0, y1, roll, dirty);
        if (y1 == mh)
            roll_tail(btns[f], btn_pitch[f], bh, bw, 3 * msz, total, roll, dirty);
        int64_t n = 0;
        for (int c = 0; c < N_SEG; c++) {
            const int k = emit(start[c], end[c], roll, dirty, idx + f * cap + n,
                               data + (f * cap + n) * SUB);
            cnt[f * N_SEG + c] = k;
            n += k;
        }
    }
}

// Merge the bands' entries of each frame into the batch's delta upload. The
// segments in ascending layout order are plane c's of band 0, 1, ..., then
// plane c+1's; entries of one index (an edge sub-chunk) are ORed. Band j's
// entries are idx[j], data[j] and cnt[j], laid out as smh_roll_band writes
// them with its cap[j]. counts[f] = frame f's changed sub-chunks. With
// bucket > 0, `out` is the batch buffer [batch*bucket int32 indices |
// batch*bucket 32 B payloads], and row f (f < n_frames) gets frame f's
// changed sub-chunks padded to `bucket` by repeating the last; a frame with
// no change gets sub-chunk 0 (keep-alive), padded likewise.
void smh_roll_merge(int n_bands, int n_frames, const int32_t* const* idx,
                    const uint8_t* const* data, const int32_t* const* cnt,
                    const int64_t* cap, int bucket, int batch, uint8_t* out,
                    int32_t* counts) {
    int32_t* out_idx = (int32_t*)out;
    uint8_t* out_data = out + (int64_t)batch * bucket * 4;
    for (int f = 0; f < n_frames; f++) {
        int32_t* oi = bucket > 0 ? out_idx + (int64_t)f * bucket : nullptr;
        uint8_t* od = bucket > 0 ? out_data + (int64_t)f * bucket * SUB : nullptr;
        int n = 0;
        int64_t key = -1;
        bool changed = false;
        uint8_t pay[SUB], chunk0[SUB] = {0};
        auto flush = [&]() {
            if (key < 0) return;
            if (key == 0) std::memcpy(chunk0, pay, SUB);
            if (changed) {
                if (oi != nullptr) {
                    oi[n] = (int32_t)key;
                    std::memcpy(od + (int64_t)n * SUB, pay, SUB);
                }
                n++;
            }
        };
        for (int c = 0; c < N_SEG; c++) {
            for (int j = 0; j < n_bands; j++) {
                const int32_t* bc = cnt[j] + f * N_SEG;
                int64_t o = (int64_t)f * cap[j];
                for (int s = 0; s < c; s++) o += bc[s];
                const int32_t* bi = idx[j] + o;
                const uint8_t* bd = data[j] + o * SUB;
                for (int e = 0; e < bc[c]; e++) {
                    const int32_t v = bi[e];
                    const int64_t k = v < 0 ? ~v : v;
                    if (k == key) {
                        for (int b = 0; b < SUB; b++) pay[b] |= bd[(int64_t)e * SUB + b];
                        changed |= v >= 0;
                        continue;
                    }
                    flush();
                    key = k;
                    changed = v >= 0;
                    std::memcpy(pay, bd + (int64_t)e * SUB, SUB);
                }
            }
        }
        flush();
        counts[f] = n;
        if (oi == nullptr) continue;
        if (n == 0) {  // keep-alive: sub-chunk 0 as it stands
            oi[0] = 0;
            std::memcpy(od, chunk0, SUB);
            n = 1;
        }
        for (int i = n; i < bucket; i++) {
            oi[i] = oi[n - 1];
            std::memcpy(od + (int64_t)i * SUB, od + (int64_t)(n - 1) * SUB, SUB);
        }
    }
}

}  // extern "C"
