// Native host image pipeline: decode (libjpeg/libpng) + PIL-exact bilinear
// resize + ImageNet normalisation, threaded over a batch.
//
// Native counterpart of the reference's host-side PIL/torchvision input
// path (reference: data/datasets/transforms.py:8-43 and the per-image decode
// loop of base_dataset.py:124-144).  The reference leans on PIL inside a
// Python loop; here the whole decode->resize->normalise chain for a batch is
// one C++ call with a real thread pool (no GIL), feeding the DINO cache-build
// and eval input paths.
//
// Parity contract (tested byte-/bit-exact in tests/test_native_io.py):
//   * resize matches Pillow's BILINEAR resampling exactly — same separable
//     triangle filter, same coefficient rounding to 22-bit fixed point
//     (PRECISION_BITS), same clip8 semantics (Pillow src/libImaging/Resample.c).
//   * RGB->L uses Pillow's ITU-R 601-2 integer formula (convert.c L24).
//   * normalisation performs the same float32 IEEE ops as transforms.py
//     ((u8/255.0f - mean) / std), so the batch output is bit-identical to the
//     PIL+numpy path.
// Unsupported inputs (CMYK JPEG, 16-bit PNG, ...) return an error and the
// Python caller falls back to PIL.

#include <cstddef>  // jpeglib.h uses size_t/FILE without including them
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Pillow-exact bilinear resampling (8-bit, C channels interleaved)
// ---------------------------------------------------------------------------

constexpr int PRECISION_BITS = 32 - 8 - 2;

inline uint8_t clip8(int in) {
    if (in >= (1 << PRECISION_BITS << 8)) return 255;
    if (in <= 0) return 0;
    return (uint8_t)(in >> PRECISION_BITS);
}

inline double bilinear_filter(double x) {
    if (x < 0.0) x = -x;
    return x < 1.0 ? 1.0 - x : 0.0;
}

// Pillow Resample.c::precompute_coeffs for the full-image box, followed by
// normalize_coeffs_8bpc (double -> 22-bit fixed point with .5 rounding).
void precompute_coeffs_8bpc(int in_size, int out_size, std::vector<int>& bounds,
                            std::vector<int32_t>& kk, int* ksize_out) {
    const double scale = (double)in_size / out_size;
    const double filterscale = scale < 1.0 ? 1.0 : scale;
    const double support = 1.0 * filterscale;  // bilinear support = 1.0
    const int ksize = (int)ceil(support) * 2 + 1;
    std::vector<double> prekk((size_t)out_size * ksize, 0.0);
    bounds.assign((size_t)out_size * 2, 0);
    const double ss = 1.0 / filterscale;
    for (int xx = 0; xx < out_size; xx++) {
        const double center = (xx + 0.5) * scale;
        double ww = 0.0;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double* k = &prekk[(size_t)xx * ksize];
        int x = 0;
        for (; x < xmax; x++) {
            const double w = bilinear_filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (x = 0; x < xmax; x++)
            if (ww != 0.0) k[x] /= ww;
        bounds[(size_t)xx * 2 + 0] = xmin;
        bounds[(size_t)xx * 2 + 1] = xmax;
    }
    kk.resize(prekk.size());
    for (size_t i = 0; i < prekk.size(); i++) {
        const double v = prekk[i];
        kk[i] = (int32_t)(v < 0 ? v * (1 << PRECISION_BITS) - 0.5
                                : v * (1 << PRECISION_BITS) + 0.5);
    }
    *ksize_out = ksize;
}

// src (sh, sw, c) -> dst (sh, dw, c)
void resample_horizontal(const uint8_t* src, int sh, int sw, int c, uint8_t* dst,
                         int dw, const std::vector<int>& bounds,
                         const std::vector<int32_t>& kk, int ksize) {
    for (int y = 0; y < sh; y++) {
        const uint8_t* row = src + (size_t)y * sw * c;
        uint8_t* orow = dst + (size_t)y * dw * c;
        for (int xx = 0; xx < dw; xx++) {
            const int xmin = bounds[(size_t)xx * 2];
            const int xmax = bounds[(size_t)xx * 2 + 1];
            const int32_t* k = &kk[(size_t)xx * ksize];
            for (int ch = 0; ch < c; ch++) {
                int ss0 = 1 << (PRECISION_BITS - 1);
                for (int x = 0; x < xmax; x++)
                    ss0 += row[(size_t)(x + xmin) * c + ch] * k[x];
                orow[(size_t)xx * c + ch] = clip8(ss0);
            }
        }
    }
}

// src (sh, w, c) -> dst (dh, w, c)
void resample_vertical(const uint8_t* src, int sh, int w, int c, uint8_t* dst,
                       int dh, const std::vector<int>& bounds,
                       const std::vector<int32_t>& kk, int ksize) {
    (void)sh;
    for (int yy = 0; yy < dh; yy++) {
        const int ymin = bounds[(size_t)yy * 2];
        const int ymax = bounds[(size_t)yy * 2 + 1];
        const int32_t* k = &kk[(size_t)yy * ksize];
        uint8_t* orow = dst + (size_t)yy * w * c;
        for (int x = 0; x < w * c; x++) {
            int ss0 = 1 << (PRECISION_BITS - 1);
            for (int y = 0; y < ymax; y++)
                ss0 += src[(size_t)(y + ymin) * w * c + x] * k[y];
            orow[x] = clip8(ss0);
        }
    }
}

int resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c, uint8_t* dst,
                       int dh, int dw) {
    if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || c <= 0) return 1;
    if (sh == dh && sw == dw) {  // Image.resize same-size short-circuit (copy)
        memcpy(dst, src, (size_t)sh * sw * c);
        return 0;
    }
    const bool need_h = sw != dw;
    const bool need_v = sh != dh;
    std::vector<int> hb, vb;
    std::vector<int32_t> hk, vk;
    int hks = 0, vks = 0;
    if (need_h) precompute_coeffs_8bpc(sw, dw, hb, hk, &hks);
    if (need_v) precompute_coeffs_8bpc(sh, dh, vb, vk, &vks);
    if (need_h && need_v) {
        std::vector<uint8_t> tmp((size_t)sh * dw * c);
        resample_horizontal(src, sh, sw, c, tmp.data(), dw, hb, hk, hks);
        resample_vertical(tmp.data(), sh, dw, c, dst, dh, vb, vk, vks);
    } else if (need_h) {
        resample_horizontal(src, sh, sw, c, dst, dw, hb, hk, hks);
    } else {
        resample_vertical(src, sh, sw, c, dst, dh, vb, vk, vks);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Mode conversion (Pillow convert.c semantics)
// ---------------------------------------------------------------------------

// Pillow convert.c: L = (R*19595 + G*38470 + B*7471 + 0x8000) >> 16
inline uint8_t rgb_to_l(const uint8_t* p) {
    return (uint8_t)((p[0] * 19595 + p[1] * 38470 + p[2] * 7471 + 0x8000) >> 16);
}

// in-place-capable channel conversion; returns malloc'd buffer
uint8_t* convert_channels(const uint8_t* src, size_t npix, int c, int want) {
    uint8_t* out = (uint8_t*)malloc(npix * want);
    if (!out) return nullptr;
    if (c == want) {
        memcpy(out, src, npix * c);
    } else if (c == 1 && want == 3) {
        for (size_t i = 0; i < npix; i++)
            out[i * 3] = out[i * 3 + 1] = out[i * 3 + 2] = src[i];
    } else if (c == 3 && want == 1) {
        for (size_t i = 0; i < npix; i++) out[i] = rgb_to_l(src + i * 3);
    } else {
        free(out);
        return nullptr;
    }
    return out;
}

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg)
// ---------------------------------------------------------------------------

struct JErr {
    jpeg_error_mgr pub;
    jmp_buf jb;
};

void jerr_exit(j_common_ptr cinfo) {
    longjmp(((JErr*)cinfo->err)->jb, 1);
}
void jerr_emit(j_common_ptr, int) {}  // silence warnings

// decodes to native channels (1 for grayscale source, 3 otherwise)
int decode_jpeg(const uint8_t* data, size_t len, uint8_t** out, int* w, int* h,
                int* c) {
    jpeg_decompress_struct cinfo;
    JErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jerr_exit;
    jerr.pub.emit_message = jerr_emit;
    // volatile: buf is written between setjmp and longjmp — without it the
    // error path's free() may see a stale register copy (C11 7.13.2.1 UB),
    // leaking the buffer on every corrupt image
    uint8_t* volatile buf = nullptr;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        free(buf);
        return 2;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, (unsigned long)len);
    jpeg_read_header(&cinfo, TRUE);
    if (cinfo.jpeg_color_space == JCS_GRAYSCALE) {
        cinfo.out_color_space = JCS_GRAYSCALE;
    } else if (cinfo.jpeg_color_space == JCS_YCbCr ||
               cinfo.jpeg_color_space == JCS_RGB) {
        cinfo.out_color_space = JCS_RGB;
    } else {  // CMYK/YCCK etc. -> let PIL handle it
        jpeg_destroy_decompress(&cinfo);
        return 3;
    }
    jpeg_start_decompress(&cinfo);
    const int W = cinfo.output_width, H = cinfo.output_height;
    const int C = cinfo.output_components;
    buf = (uint8_t*)malloc((size_t)W * H * C);
    if (!buf) {
        jpeg_destroy_decompress(&cinfo);
        return 4;
    }
    while ((int)cinfo.output_scanline < H) {
        JSAMPROW row = buf + (size_t)cinfo.output_scanline * W * C;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    *out = buf;
    *w = W;
    *h = H;
    *c = C;
    return 0;
}

// ---------------------------------------------------------------------------
// PNG decode (libpng)
// ---------------------------------------------------------------------------

struct PngReadState {
    const uint8_t* data;
    size_t len;
    size_t pos;
};

void png_read_mem(png_structp png, png_bytep out, png_size_t n) {
    PngReadState* s = (PngReadState*)png_get_io_ptr(png);
    if (s->pos + n > s->len) png_error(png, "read past end");
    memcpy(out, s->data + s->pos, n);
    s->pos += n;
}

int decode_png(const uint8_t* data, size_t len, uint8_t** out, int* w, int* h,
               int* c) {
    if (len < 8 || png_sig_cmp((png_const_bytep)data, 0, 8)) return 2;
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    if (!png) return 4;
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_read_struct(&png, nullptr, nullptr);
        return 4;
    }
    uint8_t* volatile buf = nullptr;  // see decode_jpeg: setjmp-safe free
    std::vector<png_bytep> rows;
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        free(buf);
        return 2;
    }
    PngReadState state{data, len, 0};
    png_set_read_fn(png, &state, png_read_mem);
    png_read_info(png, info);
    const int bit_depth = png_get_bit_depth(png, info);
    const int color_type = png_get_color_type(png, info);
    if (bit_depth == 16) {  // PIL maps these to I;16 — not our contract
        png_destroy_read_struct(&png, &info, nullptr);
        return 3;
    }
    if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
        png_set_expand_gray_1_2_4_to_8(png);
    // convert("RGB")/("L") drops alpha without compositing — strip it
    if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) {
        // palette transparency expands to alpha; strip that too
        png_set_tRNS_to_alpha(png);
        png_set_strip_alpha(png);
    }
    png_set_interlace_handling(png);
    png_read_update_info(png, info);
    const int W = png_get_image_width(png, info);
    const int H = png_get_image_height(png, info);
    const int C = png_get_channels(png, info);
    if (C != 1 && C != 3) {
        png_destroy_read_struct(&png, &info, nullptr);
        return 3;
    }
    buf = (uint8_t*)malloc((size_t)W * H * C);
    if (!buf) {
        png_destroy_read_struct(&png, &info, nullptr);
        return 4;
    }
    rows.resize(H);
    for (int y = 0; y < H; y++) rows[y] = buf + (size_t)y * W * C;
    png_read_image(png, rows.data());
    png_read_end(png, nullptr);
    png_destroy_read_struct(&png, &info, nullptr);
    *out = buf;
    *w = W;
    *h = H;
    *c = C;
    return 0;
}

// ---------------------------------------------------------------------------
// File plumbing
// ---------------------------------------------------------------------------

int read_file(const char* path, std::vector<uint8_t>& out) {
    FILE* f = fopen(path, "rb");
    if (!f) return 5;
    fseek(f, 0, SEEK_END);
    const long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (n < 0) {
        fclose(f);
        return 5;
    }
    out.resize((size_t)n);
    const size_t got = fread(out.data(), 1, (size_t)n, f);
    fclose(f);
    return got == (size_t)n ? 0 : 5;
}

// decode any supported container to native channels
int decode_bytes(const uint8_t* data, size_t len, uint8_t** out, int* w, int* h,
                 int* c) {
    if (len >= 2 && data[0] == 0xFF && data[1] == 0xD8)
        return decode_jpeg(data, len, out, w, h, c);
    if (len >= 8 && !png_sig_cmp((png_const_bytep)data, 0, 8))
        return decode_png(data, len, out, w, h, c);
    return 3;  // unsupported container (webp/tiff/bmp -> PIL fallback)
}

int load_u8_impl(const char* path, int want_ch, int dh, int dw, uint8_t** out,
                 int* w, int* h, int* c) {
    std::vector<uint8_t> bytes;
    int rc = read_file(path, bytes);
    if (rc) return rc;
    uint8_t* raw = nullptr;
    int W = 0, H = 0, C = 0;
    rc = decode_bytes(bytes.data(), bytes.size(), &raw, &W, &H, &C);
    if (rc) return rc;
    if (want_ch != 0 && want_ch != C) {
        uint8_t* conv = convert_channels(raw, (size_t)W * H, C, want_ch);
        free(raw);
        if (!conv) return 3;
        raw = conv;
        C = want_ch;
    }
    if (dh > 0 && dw > 0 && (dh != H || dw != W)) {
        uint8_t* res = (uint8_t*)malloc((size_t)dh * dw * C);
        if (!res) {
            free(raw);
            return 4;
        }
        rc = resize_bilinear_u8(raw, H, W, C, res, dh, dw);
        free(raw);
        if (rc) {
            free(res);
            return rc;
        }
        raw = res;
        H = dh;
        W = dw;
    }
    *out = raw;
    *w = W;
    *h = H;
    *c = C;
    return 0;
}

}  // namespace

extern "C" {

// Decode + optional channel conversion + optional resize.  want_ch: 0 native,
// 1 "L", 3 "RGB".  dh/dw <= 0 skips the resize.  *out is malloc'd (ip_free).
// Returns 0 on success; >0 error codes (see decode_* / read_file).
int ip_load_u8(const char* path, int want_ch, int dh, int dw, uint8_t** out,
               int* w, int* h, int* c) {
    return load_u8_impl(path, want_ch, dh, dw, out, w, h, c);
}

// Pillow-BILINEAR-exact resize of an interleaved u8 buffer.
int ip_resize_u8(const uint8_t* src, int sh, int sw, int c, uint8_t* dst,
                 int dh, int dw) {
    return resize_bilinear_u8(src, sh, sw, c, dst, dh, dw);
}

// Threaded batch: decode -> convert -> resize(dh,dw) -> float32
// (u8/255 - mean[c]) / std[c], written to out (n, dh, dw, want_ch) C-order.
// mean/std are want_ch-long.  Returns 0 on success, else 1-based index of the
// first failing image (so the caller can report the path).
int ip_load_norm_batch(const char** paths, int n, int want_ch, int dh, int dw,
                       const float* mean, const float* std_, float* out,
                       int nthreads) {
    if (n <= 0) return 0;
    if (want_ch != 1 && want_ch != 3) return 1;
    if (nthreads <= 0) nthreads = 1;
    if (nthreads > n) nthreads = n;
    std::atomic<int> fail{0};  // 1-based index, first-wins by min
    std::atomic<int> next{0};
    auto worker = [&]() {
        for (;;) {
            const int i = next.fetch_add(1);
            if (i >= n || fail.load()) return;
            uint8_t* raw = nullptr;
            int W, H, C;
            const int rc = load_u8_impl(paths[i], want_ch, dh, dw, &raw, &W, &H, &C);
            if (rc) {
                // record min(first-failing index); 0 means no failure yet
                const int mine = i + 1;
                int cur = fail.load();
                while ((cur == 0 || cur > mine) &&
                       !fail.compare_exchange_weak(cur, mine)) {
                }
                return;
            }
            float* dst = out + (size_t)i * dh * dw * want_ch;
            const size_t npix = (size_t)dh * dw;
            for (size_t p = 0; p < npix; p++)
                for (int ch = 0; ch < want_ch; ch++) {
                    const float v = (float)raw[p * want_ch + ch] / 255.0f;
                    dst[p * want_ch + ch] = (v - mean[ch]) / std_[ch];
                }
            free(raw);
        }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
    return fail.load();
}

void ip_free(void* p) { free(p); }

}  // extern "C"
