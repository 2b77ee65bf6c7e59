// Native host-side ops of roadvision_tpu_torch — a copy of
// roadvision_tpu/runtime/native/host_ops.cpp, the code unchanged.
//
// The overlay raster (rectangles, glyph masks) and the RAW/PROC compare
// canvas are bandwidth-bound byte shuffling on the host, where the
// reference leaned on OpenCV's C++ (SURVEY.md §2.3). Plain C ABI for
// ctypes; built by roadvision_tpu_torch/runtime/native/__init__.py
// (g++ -O3 -shared -fPIC) at its first call, never at import.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Fill an axis-aligned rect (x1..x2, y1..y2 exclusive) with a BGR color.
void rvt_fill_rect(uint8_t* img, int h, int w,
                   int x1, int y1, int x2, int y2,
                   uint8_t b, uint8_t g, uint8_t r) {
    x1 = std::max(0, x1); y1 = std::max(0, y1);
    x2 = std::min(w, x2); y2 = std::min(h, y2);
    if (x1 >= x2 || y1 >= y2) return;
    for (int y = y1; y < y2; ++y) {
        uint8_t* row = img + (static_cast<size_t>(y) * w + x1) * 3;
        for (int x = x1; x < x2; ++x) {
            row[0] = b; row[1] = g; row[2] = r;
            row += 3;
        }
    }
}

// Rectangle outline with thickness t centered on the border lines
// (matches vis/draw.py::draw_rect semantics).
void rvt_draw_rect(uint8_t* img, int h, int w,
                   int x1, int y1, int x2, int y2, int t,
                   uint8_t b, uint8_t g, uint8_t r) {
    if (t < 1) t = 1;
    int lo = t / 2, hi = (t + 1) / 2;
    rvt_fill_rect(img, h, w, x1, y1 - lo, x2 + 1, y1 + hi, b, g, r);  // top
    rvt_fill_rect(img, h, w, x1, y2 - lo, x2 + 1, y2 + hi, b, g, r);  // bottom
    rvt_fill_rect(img, h, w, x1 - lo, y1, x1 + hi, y2 + 1, b, g, r);  // left
    rvt_fill_rect(img, h, w, x2 - lo, y1, x2 + hi, y2 + 1, b, g, r);  // right
}

// Blit a boolean glyph mask (mh×mw, uint8 0/1) at (x, y) in color.
void rvt_blit_mask(uint8_t* img, int h, int w,
                   const uint8_t* mask, int mh, int mw,
                   int x, int y, uint8_t b, uint8_t g, uint8_t r) {
    int ya = std::max(0, y), xa = std::max(0, x);
    int yb = std::min(h, y + mh), xb = std::min(w, x + mw);
    for (int yy = ya; yy < yb; ++yy) {
        const uint8_t* mrow = mask + static_cast<size_t>(yy - y) * mw + (xa - x);
        uint8_t* row = img + (static_cast<size_t>(yy) * w + xa) * 3;
        for (int xx = xa; xx < xb; ++xx) {
            if (*mrow) { row[0] = b; row[1] = g; row[2] = r; }
            ++mrow; row += 3;
        }
    }
}

// Compose the RAW/PROC compare canvas horizontally:
// out is (h, w*2 + divider, 3); divider filled with (40,40,40).
void rvt_canvas_h(const uint8_t* raw, const uint8_t* proc,
                  uint8_t* out, int h, int w, int divider) {
    const int ow = 2 * w + divider;
    for (int y = 0; y < h; ++y) {
        uint8_t* orow = out + static_cast<size_t>(y) * ow * 3;
        std::memcpy(orow, raw + static_cast<size_t>(y) * w * 3, w * 3);
        uint8_t* d = orow + w * 3;
        for (int x = 0; x < divider; ++x) { d[0] = d[1] = d[2] = 40; d += 3; }
        std::memcpy(orow + (w + divider) * 3,
                    proc + static_cast<size_t>(y) * w * 3, w * 3);
    }
}

// Vertical variant: out is (h*2 + divider, w, 3).
void rvt_canvas_v(const uint8_t* raw, const uint8_t* proc,
                  uint8_t* out, int h, int w, int divider) {
    const size_t row = static_cast<size_t>(w) * 3;
    std::memcpy(out, raw, row * h);
    uint8_t* d = out + row * h;
    for (size_t i = 0; i < row * divider; ++i) d[i] = 40;
    std::memcpy(out + row * (h + divider), proc, row * h);
}

// Pack n equally-sized frames into one contiguous batch buffer.
void rvt_pack_batch(const uint8_t** srcs, int n, uint8_t* dst,
                    size_t frame_bytes) {
    for (int i = 0; i < n; ++i)
        std::memcpy(dst + static_cast<size_t>(i) * frame_bytes,
                    srcs[i], frame_bytes);
}

}  // extern "C"
