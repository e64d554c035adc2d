// smhtess: a C implementation of the Tesseract C API subset the ctypes
// binding (smh_tpu/ocr/tesseract.py) uses, backed by a real glyph
// recognizer so the binding's full runtime path — Init2 traineddata load,
// SetImage stride marshalling, Recognize, result/page iterators, bounding
// boxes, TessDeleteText ownership — executes against a real C ABI even on
// hosts with no tesseract traineddata (this image ships libtesseract.so.5
// but no model, and has no egress to fetch one).
//
// The reference counterpart is the vision-ocr crate's C++ shim over
// TessBaseAPI (/root/reference/vision-ocr/src/ocr.cpp:7-55) plus its
// embedded eng.traineddata (vision-ocr/src/lib.rs:129-159). Here the
// "traineddata" is the SMHT template pack written by ocr/tessdata_gen.py:
// the same DejaVu digits+'m' templates the smhocr engine classifies with,
// re-implemented in C++ (threshold -> 4-connected components -> word
// grouping -> bilinear 12x16 resize -> zero-mean/unit-norm correlation).
//
// Semantics intentionally mirror ocr/smhocr.py so the two engines can be
// cross-validated; constants that must match are loaded from the
// traineddata header, not duplicated.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kMinGlyphPx = 8;   // smhocr.MIN_GLYPH_PX
constexpr int kMinGlyphH = 5;    // smhocr.MIN_GLYPH_H
constexpr int kMaxGlyphH = 48;   // smhocr.MAX_GLYPH_H
constexpr float kMinConfidence = 0.55f;  // smhocr.MIN_CONFIDENCE

struct Template {
  char ch;
  std::vector<float> data;  // gh*gw, zero-mean unit-norm
};

struct Result {
  std::string text;
  float confidence;  // 0..100
  int x0, y0, x1, y1;
};

struct Api {
  bool inited = false;
  int gw = 0, gh = 0;
  unsigned threshold = 0;
  std::vector<Template> templates;
  int psm = 0;
  int dpi = 0;
  // latest image (copied out of the caller's buffer at SetImage time)
  std::vector<uint8_t> img;
  int w = 0, h = 0;
  std::vector<Result> results;
  bool recognized = false;
};

struct Iter {
  Api* api;
  size_t idx = 0;
};

bool load_traineddata(Api* api, const char* datapath, const char* lang) {
  std::string path(datapath ? datapath : ".");
  if (!path.empty() && path.back() != '/') path += '/';
  path += lang ? lang : "eng";
  path += ".traineddata";
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  char magic[4];
  uint32_t hdr[5];
  if (std::fread(magic, 1, 4, f) != 4 || std::memcmp(magic, "SMHT", 4) != 0 ||
      std::fread(hdr, 4, 5, f) != 5 || hdr[0] != 1) {
    std::fclose(f);
    return false;
  }
  api->gw = (int)hdr[1];
  api->gh = (int)hdr[2];
  api->threshold = hdr[3];
  uint32_t n = hdr[4];
  api->templates.clear();
  bool truncated = false;
  for (uint32_t i = 0; i < n; i++) {
    uint8_t ch;
    if (std::fread(&ch, 1, 1, f) != 1) { truncated = true; break; }
    Template t;
    t.ch = (char)ch;
    t.data.resize((size_t)api->gw * api->gh);
    if (std::fread(t.data.data(), 4, t.data.size(), f) != t.data.size()) {
      truncated = true;
      break;
    }
    api->templates.push_back(std::move(t));
  }
  std::fclose(f);
  // A traineddata cut off mid-template must fail init (real Tesseract
  // rejects corrupt models); accepting a partial set would silently
  // misclassify every glyph whose template is missing.
  return !truncated && !api->templates.empty();
}

// Bilinear resize of a float mask to gw x gh, then zero-mean unit-norm —
// the C++ twin of smhocr._normalize (PIL BILINEAR on the 0/255 mask).
void normalize_glyph(const std::vector<float>& src, int sw, int sh, int gw,
                     int gh, std::vector<float>& out) {
  out.assign((size_t)gw * gh, 0.f);
  // PIL-style box mapping: dst pixel center i+0.5 maps to src (i+0.5)*scale.
  const float sx = (float)sw / gw, sy = (float)sh / gh;
  for (int y = 0; y < gh; y++) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = (int)std::floor(fy);
    float wy = fy - y0;
    int y1 = y0 + 1;
    if (y0 < 0) y0 = 0;
    if (y1 > sh - 1) y1 = sh - 1;
    if (y0 > sh - 1) y0 = sh - 1;
    for (int x = 0; x < gw; x++) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = (int)std::floor(fx);
      float wx = fx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) x0 = 0;
      if (x1 > sw - 1) x1 = sw - 1;
      if (x0 > sw - 1) x0 = sw - 1;
      float v = (1 - wy) * ((1 - wx) * src[(size_t)y0 * sw + x0] +
                            wx * src[(size_t)y0 * sw + x1]) +
                wy * ((1 - wx) * src[(size_t)y1 * sw + x0] +
                      wx * src[(size_t)y1 * sw + x1]);
      out[(size_t)y * gw + x] = v;
    }
  }
  float mean = 0.f;
  for (float v : out) mean += v;
  mean /= out.size();
  float norm = 0.f;
  for (float& v : out) {
    v -= mean;
    norm += v * v;
  }
  norm = std::sqrt(norm);
  if (norm > 1e-6f)
    for (float& v : out) v /= norm;
}

struct Glyph {
  int x0, y0, x1, y1;
  int label;
};

void recognize(Api* api) {
  api->results.clear();
  api->recognized = true;
  const int w = api->w, h = api->h;
  if (w <= 0 || h <= 0 || api->templates.empty()) return;

  // threshold: text where gray < threshold
  std::vector<int32_t> labels((size_t)w * h, 0);
  const uint8_t* img = api->img.data();

  // 4-connected component labeling via BFS (matches scipy ndimage.label's
  // default cross structure in smhocr).
  int next_label = 0;
  std::vector<int> stack;
  std::vector<Glyph> glyphs;
  std::vector<int> sizes;
  std::vector<Glyph> boxes;
  for (int sy = 0; sy < h; sy++) {
    for (int sxp = 0; sxp < w; sxp++) {
      size_t si = (size_t)sy * w + sxp;
      if (img[si] >= api->threshold || labels[si]) continue;
      int lab = ++next_label;
      labels[si] = lab;
      stack.clear();
      stack.push_back((int)si);
      int x0 = sxp, x1 = sxp + 1, y0 = sy, y1 = sy + 1, count = 0;
      while (!stack.empty()) {
        int p = stack.back();
        stack.pop_back();
        int px = p % w, py = p / w;
        count++;
        if (px < x0) x0 = px;
        if (px + 1 > x1) x1 = px + 1;
        if (py < y0) y0 = py;
        if (py + 1 > y1) y1 = py + 1;
        const int nx[4] = {px - 1, px + 1, px, px};
        const int ny[4] = {py, py, py - 1, py + 1};
        for (int k = 0; k < 4; k++) {
          if (nx[k] < 0 || nx[k] >= w || ny[k] < 0 || ny[k] >= h) continue;
          size_t ni = (size_t)ny[k] * w + nx[k];
          if (img[ni] < api->threshold && !labels[ni]) {
            labels[ni] = lab;
            stack.push_back((int)ni);
          }
        }
      }
      int gh_ = y1 - y0, gw_ = x1 - x0;
      if (count < kMinGlyphPx) continue;
      if (gh_ < kMinGlyphH || gh_ > kMaxGlyphH || gw_ > kMaxGlyphH) continue;
      glyphs.push_back({x0, y0, x1, y1, lab});
    }
  }
  if (glyphs.empty()) return;

  // sort by x0 and group into words (same rules as smhocr.read)
  for (size_t i = 1; i < glyphs.size(); i++)
    for (size_t j = i; j > 0 && glyphs[j].x0 < glyphs[j - 1].x0; j--)
      std::swap(glyphs[j], glyphs[j - 1]);

  std::vector<std::vector<Glyph>> words;
  for (const Glyph& g : glyphs) {
    bool placed = false;
    for (auto& word : words) {
      const Glyph& last = word.back();
      int v_overlap = std::min(g.y1, last.y1) - std::max(g.y0, last.y0);
      int min_h = std::min(g.y1 - g.y0, last.y1 - last.y0);
      int gap = g.x0 - last.x1;
      int max_gap = std::max(4, (int)(0.9f * min_h));
      if (v_overlap > 0.5f * min_h && gap >= -2 && gap <= max_gap) {
        word.push_back(g);
        placed = true;
        break;
      }
    }
    if (!placed) words.push_back({g});
  }

  std::vector<float> mask, norm;
  for (const auto& word : words) {
    std::string text;
    float score_sum = 0.f;
    int wx0 = word[0].x0, wy0 = word[0].y0, wx1 = word[0].x1, wy1 = word[0].y1;
    for (const Glyph& g : word) {
      int sw = g.x1 - g.x0, sh = g.y1 - g.y0;
      mask.assign((size_t)sw * sh, 0.f);
      for (int y = g.y0; y < g.y1; y++)
        for (int x = g.x0; x < g.x1; x++)
          if (labels[(size_t)y * w + x] == g.label)
            mask[(size_t)(y - g.y0) * sw + (x - g.x0)] = 1.f;
      normalize_glyph(mask, sw, sh, api->gw, api->gh, norm);
      char best_ch = '?';
      float best = -1.f;
      for (const Template& t : api->templates) {
        float s = 0.f;
        for (size_t k = 0; k < norm.size(); k++) s += norm[k] * t.data[k];
        if (s > best) {
          best = s;
          best_ch = t.ch;
        }
      }
      text += (best >= kMinConfidence) ? best_ch : '?';
      score_sum += std::max(best, 0.f);
      if (g.x0 < wx0) wx0 = g.x0;
      if (g.y0 < wy0) wy0 = g.y0;
      if (g.x1 > wx1) wx1 = g.x1;
      if (g.y1 > wy1) wy1 = g.y1;
    }
    Result r;
    r.text = text;
    r.confidence = 100.f * score_sum / word.size();
    r.x0 = wx0;
    r.y0 = wy0;
    r.x1 = wx1;
    r.y1 = wy1;
    api->results.push_back(std::move(r));
  }
}

}  // namespace

extern "C" {

void* TessBaseAPICreate() { return new Api(); }

void TessBaseAPIDelete(void* h) { delete (Api*)h; }

int TessBaseAPIInit2(void* h, const char* datapath, const char* lang,
                     int oem) {
  (void)oem;  // template matcher has one engine mode
  Api* api = (Api*)h;
  api->inited = load_traineddata(api, datapath, lang);
  return api->inited ? 0 : -1;
}

void TessBaseAPISetPageSegMode(void* h, int psm) { ((Api*)h)->psm = psm; }

void TessBaseAPISetImage(void* h, const void* data, int w, int hgt, int bpp,
                         int stride) {
  Api* api = (Api*)h;
  api->w = w;
  api->h = hgt;
  api->recognized = false;
  api->img.resize((size_t)w * hgt);
  const uint8_t* src = (const uint8_t*)data;
  if (bpp != 1) {  // only 8-bit gray supported, like the binding sends
    api->img.assign((size_t)w * hgt, 255);
    return;
  }
  for (int y = 0; y < hgt; y++)
    std::memcpy(&api->img[(size_t)y * w], src + (size_t)y * stride, w);
}

void TessBaseAPISetSourceResolution(void* h, int dpi) { ((Api*)h)->dpi = dpi; }

int TessBaseAPIRecognize(void* h, void* monitor) {
  (void)monitor;
  Api* api = (Api*)h;
  if (!api->inited) return -1;
  recognize(api);
  return 0;
}

void* TessBaseAPIGetIterator(void* h) {
  Api* api = (Api*)h;
  if (!api->recognized) return nullptr;
  Iter* it = new Iter();
  it->api = api;
  return it;
}

void* TessResultIteratorGetPageIterator(void* hit) {
  return hit;  // page iterator is a view owned by the result iterator,
               // same ownership contract as the real C API
}

char* TessResultIteratorGetUTF8Text(void* hit, int level) {
  (void)level;  // word == textline for sparse scale labels
  Iter* it = (Iter*)hit;
  if (it->idx >= it->api->results.size()) return nullptr;
  const std::string& s = it->api->results[it->idx].text;
  char* out = (char*)std::malloc(s.size() + 1);
  std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

float TessResultIteratorConfidence(void* hit, int level) {
  (void)level;
  Iter* it = (Iter*)hit;
  if (it->idx >= it->api->results.size()) return 0.f;
  return it->api->results[it->idx].confidence;
}

int TessPageIteratorBoundingBox(void* hit, int level, int* left, int* top,
                                int* right, int* bottom) {
  (void)level;
  Iter* it = (Iter*)hit;
  if (it->idx >= it->api->results.size()) return 0;
  const Result& r = it->api->results[it->idx];
  *left = r.x0;
  *top = r.y0;
  *right = r.x1;
  *bottom = r.y1;
  return 1;
}

int TessResultIteratorNext(void* hit, int level) {
  (void)level;
  Iter* it = (Iter*)hit;
  it->idx++;
  return it->idx < it->api->results.size() ? 1 : 0;
}

void TessResultIteratorDelete(void* hit) { delete (Iter*)hit; }

void TessDeleteText(void* text) { std::free(text); }

}  // extern "C"
