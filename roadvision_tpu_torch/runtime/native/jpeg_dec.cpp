// Native JPEG decode of roadvision_tpu_torch — a copy of
// roadvision_tpu/runtime/native/jpeg_dec.cpp, the code unchanged.
//
// The counterpart of jpeg_enc.cpp (the reference decodes through
// cv2.VideoCapture, src/io_video/capture.py:13): libjpeg(-turbo)
// decompresses straight into BGR rows (JCS_EXT_BGR), so MJPEG-AVI
// playback and image-dir sources get the uint8 BGR contract with no
// channel flip on the Python side. JDCT_ISLOW (the default, as PIL)
// keeps the decode bit-identical to the PIL path.

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
    jpeg_error_mgr pub;
    jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
    ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
    longjmp(err->jump, 1);
}

void emit_message(j_common_ptr, int) {}  // silence warnings

}  // namespace

extern "C" {

// Decode a JPEG byte stream to an (h, w, 3) uint8 BGR image. On success
// stores a malloc'd h*w*3 buffer in *out (caller frees with
// rvt_jpeg_free_dec), writes the geometry to *h/*w, and returns the byte
// length. Returns -1 on any decode error (corrupt stream, not a JPEG,
// unsupported colorspace).
long rvt_jpeg_decode_bgr(const uint8_t* data, long n,
                         int* h, int* w, uint8_t** out) {
    jpeg_decompress_struct cinfo;
    ErrorMgr jerr;
    uint8_t* buf = nullptr;

    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit;
    jerr.pub.emit_message = emit_message;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        if (buf) free(buf);
        return -1;
    }

    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
                 static_cast<unsigned long>(n));
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    cinfo.out_color_space = JCS_EXT_BGR;  // BGR rows, no host-side flip
    jpeg_start_decompress(&cinfo);

    const int height = static_cast<int>(cinfo.output_height);
    const int width = static_cast<int>(cinfo.output_width);
    const size_t stride = static_cast<size_t>(width) * 3;
    buf = static_cast<uint8_t*>(malloc(stride * height));
    if (!buf) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = buf + cinfo.output_scanline * stride;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);

    *h = height;
    *w = width;
    *out = buf;
    return static_cast<long>(stride * height);
}

void rvt_jpeg_free_dec(uint8_t* p) { free(p); }

}  // extern "C"
