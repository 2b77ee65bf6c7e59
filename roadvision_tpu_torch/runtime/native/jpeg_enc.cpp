// Native MJPEG encode tail of roadvision_tpu_torch — a copy of
// roadvision_tpu/runtime/native/jpeg_enc.cpp, the code unchanged.
//
// The reference records through cv2.VideoWriter's native codecs
// (main_preview.py:130-137). A thin C++ path over libjpeg(-turbo):
//   * JCS_EXT_BGR input (BGR rows read directly, no channel flip or
//     intermediate RGB copy on the Python side),
//   * JDCT_IFAST or JDCT_ISLOW, as the caller asks,
//   * default 4:2:0 chroma subsampling (as the PIL path).
//
// Built apart from host_ops.cpp because it links -ljpeg; where that
// fails the Python side keeps its PIL path (writer.encode_jpeg_bgr).

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

// Encode an (h, w, 3) uint8 BGR image (row stride in bytes) to baseline
// JPEG. On success returns the byte length and stores a malloc'd buffer
// in *out (caller frees with rvt_jpeg_free). Returns -1 on error.
long rvt_jpeg_encode_bgr(const uint8_t* src, int h, int w, long stride,
                         int quality, int fast_dct, uint8_t** out) {
    jpeg_compress_struct cinfo;
    ErrorMgr jerr;
    unsigned char* buf = nullptr;
    unsigned long buflen = 0;

    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit;
    jerr.pub.emit_message = emit_message;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_compress(&cinfo);
        if (buf) free(buf);
        return -1;
    }

    jpeg_create_compress(&cinfo);
    jpeg_mem_dest(&cinfo, &buf, &buflen);

    cinfo.image_width = static_cast<JDIMENSION>(w);
    cinfo.image_height = static_cast<JDIMENSION>(h);
    cinfo.input_components = 3;
    cinfo.in_color_space = JCS_EXT_BGR;
    jpeg_set_defaults(&cinfo);
    jpeg_set_quality(&cinfo, quality, TRUE);
    cinfo.dct_method = fast_dct ? JDCT_IFAST : JDCT_ISLOW;
    // defaults keep 2x2 chroma subsampling (4:2:0), matching the PIL path

    jpeg_start_compress(&cinfo, TRUE);
    while (cinfo.next_scanline < cinfo.image_height) {
        JSAMPROW row = const_cast<JSAMPROW>(
            src + static_cast<size_t>(cinfo.next_scanline) * stride);
        jpeg_write_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);

    *out = buf;
    return static_cast<long>(buflen);
}

void rvt_jpeg_free(uint8_t* p) { free(p); }

}  // extern "C"
