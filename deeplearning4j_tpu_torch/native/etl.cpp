// Native ETL loops for the host-side data path of the PyTorch port.
//
// A copy of deeplearning4j_tpu/native/etl.cpp with the same four entries
// and the same arithmetic, so the two packages' record readers, image
// loaders and skip-gram pair generators give the same numbers. These are
// host loops that feed the card, where a Python for-loop would be the
// bottleneck:
//   * skip-gram training-pair generation (word2vec: per-token nested
//     window loops over the whole corpus, every epoch)
//   * CSV numeric parsing (record readers)
//   * HWC uint8 -> CHW float image conversion with flip/scale, and the
//     fused bilinear resize (image pipeline)
// Compiled at first use by deeplearning4j_tpu_torch/native/__init__.py with
// g++ (-O3 -shared -fPIC) into deeplearning4j_tpu_torch/_build/, keyed by a
// hash of this file. Each caller keeps a numpy twin with the same math.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Skip-gram pairs with reference-style reduced windows.
//   idxs      concatenated sentence token ids
//   offsets   n_sent+1 prefix offsets into idxs
//   bs        per-token window draw b ~ U[1, window] (caller's rng keeps
//             determinism identical to the Python path)
//   out_*     capacity >= sum(2*bs[i]) (caller allocates the bound)
// Returns the number of pairs written.
long sg_pairs(const int32_t* idxs, const int64_t* offsets, int64_t n_sent,
              const int32_t* bs, int32_t* out_centers,
              int32_t* out_contexts) {
    long k = 0;
    for (int64_t s = 0; s < n_sent; ++s) {
        const int64_t lo = offsets[s], hi = offsets[s + 1];
        const int64_t n = hi - lo;
        for (int64_t pos = 0; pos < n; ++pos) {
            const int64_t b = bs[lo + pos];
            int64_t jlo = pos - b < 0 ? 0 : pos - b;
            int64_t jhi = pos + b + 1 > n ? n : pos + b + 1;
            const int32_t center = idxs[lo + pos];
            for (int64_t j = jlo; j < jhi; ++j) {
                if (j == pos) continue;
                out_centers[k] = center;
                out_contexts[k] = idxs[lo + j];
                ++k;
            }
        }
    }
    return k;
}

// CSV numeric parse: writes row-major floats, returns the number of rows
// (-1 on ragged rows / capacity overflow). *cols receives the column
// count of the first row. Handles \n and \r\n, skips empty lines; no
// quoting (numeric CSVs only — the Python csv reader stays the general
// path).
long csv_parse(const char* buf, int64_t len, char delim, float* out,
               int64_t max_vals, int64_t* cols) {
    int64_t k = 0;
    long rows = 0;
    int64_t row_cols = 0;
    *cols = 0;
    const char* p = buf;
    const char* end = buf + len;
    while (p < end) {
        // skip blank lines
        while (p < end && (*p == '\n' || *p == '\r')) ++p;
        if (p >= end) break;
        row_cols = 0;
        while (p < end && *p != '\n' && *p != '\r') {
            char* next = nullptr;
            float v = strtof(p, &next);
            if (next == p) return -1;  // not a number
            if (k >= max_vals) return -1;
            out[k++] = v;
            ++row_cols;
            p = next;
            if (p < end && *p == delim) ++p;
        }
        if (*cols == 0) *cols = row_cols;
        else if (row_cols != *cols) return -1;  // ragged
        ++rows;
    }
    return rows;
}

// HWC uint8 -> CHW float32, optional horizontal flip and affine
// y = x * scale + shift (the ImagePreProcessingScaler fuse).
void hwc_to_chw(const uint8_t* src, int64_t h, int64_t w, int64_t c,
                int flip_h, float scale, float shift, float* dst) {
    for (int64_t ch = 0; ch < c; ++ch) {
        float* plane = dst + ch * h * w;
        for (int64_t y = 0; y < h; ++y) {
            const uint8_t* row = src + y * w * c;
            float* drow = plane + y * w;
            if (flip_h) {
                for (int64_t x = 0; x < w; ++x)
                    drow[x] = (float)row[(w - 1 - x) * c + ch] * scale
                              + shift;
            } else {
                for (int64_t x = 0; x < w; ++x)
                    drow[x] = (float)row[x * c + ch] * scale + shift;
            }
        }
    }
}

// Fused bilinear resize + HWC->CHW + affine normalize (+optional h-flip):
// the whole NativeImageLoader.asMatrix hot path in ONE pass over the
// output (reference: NativeImageLoader wraps C++ OpenCV resize/convert,
// SURVEY.md §2.4). src is [h,w,c] uint8, dst is [c,oh,ow] float32.
void resize_hwc_to_chw(const uint8_t* src, int64_t h, int64_t w, int64_t c,
                       int64_t oh, int64_t ow, int flip_h, float scale,
                       float shift, float* dst) {
    if (h <= 0 || w <= 0 || oh <= 0 || ow <= 0 || c <= 0) return;
    // half-pixel centers, classic bilinear (OpenCV INTER_LINEAR
    // semantics — NO antialiasing; PIL's antialiased downscale differs).
    // The numpy fallback (_bilinear_resize_chw) implements the same math.
    const float sy = (float)h / (float)oh;
    const float sx = (float)w / (float)ow;
    for (int64_t y = 0; y < oh; ++y) {
        float fy = ((float)y + 0.5f) * sy - 0.5f;
        if (fy < 0) fy = 0;
        int64_t y0 = (int64_t)fy;
        if (y0 > h - 1) y0 = h - 1;
        int64_t y1 = y0 + 1 < h ? y0 + 1 : h - 1;
        const float wy = fy - (float)y0;
        for (int64_t x = 0; x < ow; ++x) {
            const int64_t xo = flip_h ? ow - 1 - x : x;
            float fx = ((float)x + 0.5f) * sx - 0.5f;
            if (fx < 0) fx = 0;
            int64_t x0 = (int64_t)fx;
            if (x0 > w - 1) x0 = w - 1;
            int64_t x1 = x0 + 1 < w ? x0 + 1 : w - 1;
            const float wx = fx - (float)x0;
            const uint8_t* p00 = src + (y0 * w + x0) * c;
            const uint8_t* p01 = src + (y0 * w + x1) * c;
            const uint8_t* p10 = src + (y1 * w + x0) * c;
            const uint8_t* p11 = src + (y1 * w + x1) * c;
            for (int64_t ch = 0; ch < c; ++ch) {
                const float top = (float)p00[ch] * (1.0f - wx)
                                  + (float)p01[ch] * wx;
                const float bot = (float)p10[ch] * (1.0f - wx)
                                  + (float)p11[ch] * wx;
                dst[ch * oh * ow + y * ow + xo] =
                    (top * (1.0f - wy) + bot * wy) * scale + shift;
            }
        }
    }
}

}  // extern "C"
