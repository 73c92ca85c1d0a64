// sparkdl_tpu native host shim: batch image resize + NHWC packing.
//
// TPU-native counterpart of the reference's native host path: its hot
// loop ran in the executor JVM (Scala ImageUtils.resizeImage row resize)
// and in libtensorflow C++ via TensorFrames/JNI — never per-row Python
// (reference call stack SURVEY §3.2). Here the per-row decode-adjacent
// work (bilinear resize, channel conversion, contiguous uint8 NHWC
// packing for device infeed) runs in C++ with OpenMP across rows,
// called once per Arrow batch through ctypes (which drops the GIL), so
// engine host threads scale past the Python interpreter.
//
// Resampling is classic bilinear with half-pixel centers (the
// OpenCV/TF convention). PIL's resize applies an area-style triangle
// filter when downscaling, so outputs differ by a few counts on
// downscale — the same situation as the reference, whose JVM
// (java.awt) resize and PIL resize paths likewise disagreed per-pixel.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#ifdef SDL_HAVE_JPEG
#include <csetjmp>
#include <jpeglib.h>
#endif

namespace {

inline float clampf(float v, float lo, float hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

inline uint8_t to_u8(float v) {
    return static_cast<uint8_t>(clampf(v + 0.5f, 0.0f, 255.0f));
}

// ITU-R 601-2 luma, PIL "L" convention.
inline float luma(float r, float g, float b) {
    return (r * 299.0f + g * 587.0f + b * 114.0f) / 1000.0f;
}

// Precomputed 1-D bilinear coordinates: out index -> (lo, hi, frac),
// half-pixel centers, edge-clamped.
struct Axis {
    std::vector<int> lo, hi;
    std::vector<float> frac;
    Axis(int src_n, int dst_n) : lo(dst_n), hi(dst_n), frac(dst_n) {
        const float scale = static_cast<float>(src_n) / dst_n;
        for (int i = 0; i < dst_n; ++i) {
            float s = (i + 0.5f) * scale - 0.5f;
            s = clampf(s, 0.0f, static_cast<float>(src_n - 1));
            lo[i] = static_cast<int>(s);
            hi[i] = std::min(lo[i] + 1, src_n - 1);
            frac[i] = s - lo[i];
        }
    }
};

// Interpolate up to 4 channels at one (row-pair, column) site using
// precomputed horizontal coefficients. r0/r1 are the two source rows.
inline void lerp_site(const uint8_t* r0, const uint8_t* r1, int c_in,
                      int x0, int x1, float fx, float fy, float* out) {
    const uint8_t* p00 = r0 + x0 * c_in;
    const uint8_t* p01 = r0 + x1 * c_in;
    const uint8_t* p10 = r1 + x0 * c_in;
    const uint8_t* p11 = r1 + x1 * c_in;
    const float gx = 1.0f - fx, gy = 1.0f - fy;
    for (int ch = 0; ch < c_in; ++ch) {
        const float top = p00[ch] * gx + p01[ch] * fx;
        const float bot = p10[ch] * gx + p11[ch] * fx;
        out[ch] = top * gy + bot * fy;
    }
}

// Resize one h*w*c_in image into H*W*C at dst. ``src_stride`` is the
// source row pitch in SAMPLES (>= w*c_in; raw libjpeg planes are padded
// to iMCU multiples). Returns 0 on success, nonzero for unsupported
// channel combinations.
int resize_one_strided(const uint8_t* src, int h, int w, int c_in,
                       size_t src_stride, uint8_t* dst, int H, int W,
                       int C) {
    const bool same_size = (h == H && w == W);
    const bool packed = (src_stride == static_cast<size_t>(w) * c_in);

    // fast paths for same-size inputs (pure pack / channel convert)
    if (same_size && c_in == C) {
        if (packed) {
            std::memcpy(dst, src, static_cast<size_t>(H) * W * C);
        } else {
            for (int y = 0; y < H; ++y)
                std::memcpy(dst + static_cast<size_t>(y) * W * C,
                            src + static_cast<size_t>(y) * src_stride,
                            static_cast<size_t>(W) * C);
        }
        return 0;
    }
    if (same_size && packed) {
        const size_t n = static_cast<size_t>(H) * W;
        if (c_in == 1 && C == 3) {
            for (size_t i = 0; i < n; ++i) {
                const uint8_t v = src[i];
                dst[i * 3] = dst[i * 3 + 1] = dst[i * 3 + 2] = v;
            }
            return 0;
        }
        if (c_in == 4 && C == 3) {
            for (size_t i = 0; i < n; ++i) {
                dst[i * 3]     = src[i * 4];
                dst[i * 3 + 1] = src[i * 4 + 1];
                dst[i * 3 + 2] = src[i * 4 + 2];
            }
            return 0;
        }
        if ((c_in == 3 || c_in == 4) && C == 1) {
            for (size_t i = 0; i < n; ++i) {
                const uint8_t* p = src + i * c_in;
                dst[i] = to_u8(luma(p[0], p[1], p[2]));
            }
            return 0;
        }
        return 2;
    }

    const bool ok = (c_in == C) || (c_in == 1 && C == 3)
        || (c_in == 4 && C == 3) || ((c_in == 3 || c_in == 4) && C == 1);
    if (!ok) return 2;

    const Axis ax(w, W), ay(h, H);
    float v[4];
    for (int y = 0; y < H; ++y) {
        const uint8_t* r0 = src + static_cast<size_t>(ay.lo[y]) * src_stride;
        const uint8_t* r1 = src + static_cast<size_t>(ay.hi[y]) * src_stride;
        const float fy = ay.frac[y];
        uint8_t* row = dst + static_cast<size_t>(y) * W * C;
        for (int x = 0; x < W; ++x) {
            lerp_site(r0, r1, c_in, ax.lo[x], ax.hi[x], ax.frac[x], fy, v);
            uint8_t* px = row + x * C;
            if (c_in == C) {
                for (int ch = 0; ch < C; ++ch) px[ch] = to_u8(v[ch]);
            } else if (c_in == 1) {              // gray -> RGB
                px[0] = px[1] = px[2] = to_u8(v[0]);
            } else if (C == 3) {                 // RGBA -> RGB
                px[0] = to_u8(v[0]); px[1] = to_u8(v[1]);
                px[2] = to_u8(v[2]);
            } else {                             // RGB(A) -> gray
                px[0] = to_u8(luma(v[0], v[1], v[2]));
            }
        }
    }
    return 0;
}

int resize_one(const uint8_t* src, int h, int w, int c_in,
               uint8_t* dst, int H, int W, int C) {
    return resize_one_strided(src, h, w, c_in,
                              static_cast<size_t>(w) * c_in, dst, H, W, C);
}

// --- YCbCr 4:2:0 packing (link-payload halving: 1.5 B/px vs RGB's 3) ---
//
// Packed layout per image: Y[H*W] then Cb[(H/2)*(W/2)] then
// Cr[(H/2)*(W/2)], H and W even. BT.601 full-range (the JPEG/JFIF and
// PIL "YCbCr" convention); the inverse conversion runs fused on-device
// (ops/infeed.py::fused_yuv420_resize_normalize).

inline size_t yuv420_size(int H, int W) {
    return static_cast<size_t>(H) * W
        + 2 * (static_cast<size_t>(H / 2) * (W / 2));
}

// RGB (H*W*3, packed) -> planar YCbCr with 2x2 box-averaged chroma, the
// standard encoder subsampling. Chroma is averaged in float BEFORE the
// uint8 round so the 4 sites contribute exactly.
void rgb_to_yuv420(const uint8_t* rgb, int H, int W, uint8_t* dst) {
    uint8_t* Y = dst;
    uint8_t* Cb = dst + static_cast<size_t>(H) * W;
    uint8_t* Cr = Cb + static_cast<size_t>(H / 2) * (W / 2);
    const int CW = W / 2;
    for (int y = 0; y < H; y += 2) {
        for (int x = 0; x < W; x += 2) {
            float scb = 0.0f, scr = 0.0f;
            for (int dy = 0; dy < 2; ++dy) {
                for (int dx = 0; dx < 2; ++dx) {
                    const uint8_t* p =
                        rgb + (static_cast<size_t>(y + dy) * W + x + dx) * 3;
                    const float r = p[0], g = p[1], b = p[2];
                    Y[static_cast<size_t>(y + dy) * W + x + dx] =
                        to_u8(0.299f * r + 0.587f * g + 0.114f * b);
                    scb += 128.0f - 0.168736f * r - 0.331264f * g
                        + 0.5f * b;
                    scr += 128.0f + 0.5f * r - 0.418688f * g
                        - 0.081312f * b;
                }
            }
            Cb[static_cast<size_t>(y / 2) * CW + x / 2] =
                to_u8(scb * 0.25f);
            Cr[static_cast<size_t>(y / 2) * CW + x / 2] =
                to_u8(scr * 0.25f);
        }
    }
}

#ifdef SDL_HAVE_JPEG

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(err->jump, 1);
}

// DCT-domain prescale selection (libjpeg scaled decode): smallest
// power-of-two M/8 with src*M >= 8*dst on BOTH axes. Power-of-two
// only, for two measured reasons: (a) the 1x1/2x2/4x4 scaled IDCTs
// are the SIMD-accelerated kernels — the intermediate M/8 factors fall
// back to scalar IDCTs that measured SLOWER than the full SIMD 8x8
// (375x500→299²: 453 vs 532 img/s at 7/8 on this host); (b) raw-data
// mode pairs a scaled Y IDCT with unscaled stored chroma and the pow2
// sizes are what every libjpeg ships there. The acceptance rule is
// deliberately floor semantics (src >= (8/M)*dst, NOT ceil of the
// scaled dims >= dst): it is exactly PIL draft's rule, so the two
// prescales engage on identical inputs and agree bit-for-bit — ceil
// would additionally engage only in the one-pixel band
// src == 2*dst - 1 (e.g. 299→150), where PIL stays at full res. The
// <2x bilinear-after guarantee survives: if M/2 failed to cover then
// src*M/8 < 2*dst. Returns 8 (no scaling) when even 4/8 undershoots.
int choose_scale_num(int src_h, int src_w, int dst_h, int dst_w) {
    for (int m = 1; m < 8; m *= 2) {
        if (static_cast<long>(src_h) * m >= 8L * dst_h &&
            static_cast<long>(src_w) * m >= 8L * dst_w) return m;
    }
    return 8;
}

// Decode one JPEG to RGB into dst (h*w*3, dims from a prior header
// parse). Returns 0 on success.
int jpeg_decode_rgb(const uint8_t* data, size_t len, uint8_t* dst,
                    int expect_h, int expect_w) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, len);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;   // libjpeg converts gray/YCbCr
    jpeg_start_decompress(&cinfo);
    if (static_cast<int>(cinfo.output_height) != expect_h ||
        static_cast<int>(cinfo.output_width) != expect_w ||
        cinfo.output_components != 3) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = dst +
            static_cast<size_t>(cinfo.output_scanline) * expect_w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

inline int pad_to(int v, int m) { return ((v + m - 1) / m) * m; }

// Scaled-IDCT geometry fields moved in the libjpeg v7 ABI: v6 has one
// square DCT_scaled_size per component, v7+ splits it into h/v. The
// shim compiles on first use against whatever jpeglib.h the host
// ships, so both spellings must build (a failed -DSDL_HAVE_JPEG
// attempt silently drops the whole native JPEG path).
#if JPEG_LIB_VERSION >= 70
#define SDL_COMP_DCT_H(ci) ((ci).DCT_h_scaled_size)
#define SDL_COMP_DCT_V(ci) ((ci).DCT_v_scaled_size)
#define SDL_MIN_DCT_H(cinfo) ((cinfo).min_DCT_h_scaled_size)
#define SDL_MIN_DCT_V(cinfo) ((cinfo).min_DCT_v_scaled_size)
#else
#define SDL_COMP_DCT_H(ci) ((ci).DCT_scaled_size)
#define SDL_COMP_DCT_V(ci) ((ci).DCT_scaled_size)
#define SDL_MIN_DCT_H(cinfo) ((cinfo).min_DCT_scaled_size)
#define SDL_MIN_DCT_V(cinfo) ((cinfo).min_DCT_scaled_size)
#endif

// Decode one JPEG to RGB into caller scratch ``tmp`` at the natural or
// DCT-prescaled size: when ``scale_to_h/w`` > 0, decode at the smallest
// M/8 still covering that target (choose_scale_num). On success tmp
// holds (*dh) x (*dw) x 3 and the caller resizes. Returns 0 on success.
int jpeg_decode_rgb_scaled(const uint8_t* data, size_t len,
                           std::vector<uint8_t>& tmp, int scale_to_h,
                           int scale_to_w, int* dh, int* dw) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, len);
    jpeg_read_header(&cinfo, TRUE);
    if (static_cast<int64_t>(cinfo.image_height) * cinfo.image_width
        > (int64_t)100000000) {
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    if (scale_to_h > 0 && scale_to_w > 0) {
        cinfo.scale_num = choose_scale_num(
            cinfo.image_height, cinfo.image_width,
            scale_to_h, scale_to_w);
        cinfo.scale_denom = 8;
    }
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    const int h = cinfo.output_height, w = cinfo.output_width;
    if (h <= 0 || w <= 0 || cinfo.output_components != 3) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    tmp.resize(static_cast<size_t>(h) * w * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = tmp.data()
            + static_cast<size_t>(cinfo.output_scanline) * w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    *dh = h;
    *dw = w;
    return 0;
}

// Decode one JPEG straight to packed planar YCbCr 4:2:0 at (H, W).
// Fast path: a YCbCr source with the standard 2x2/1x1/1x1 sampling is
// read via jpeg_read_raw_data — libjpeg skips BOTH its chroma upsample
// and the YCbCr->RGB conversion; Y resizes from its decoded plane and
// Cb/Cr straight from their stored planes (resize and the affine color
// transform commute, so doing color on-device is exact up to rounding).
// ``scaled`` additionally prescales in the DCT domain (power-of-two
// M/8 covering the target — choose_scale_num): the Y IDCT emits a
// low-passed plane a quarter the samples at 1/2 scale while chroma,
// already stored at half res, stays unscaled; per-component geometry
// (strides, rows per raw read) therefore comes from comp_info rather
// than the full-scale constants. Grayscale decodes to Y with neutral
// chroma; anything else decodes RGB (prescaled when ``scaled``) and
// re-subsamples. Returns 0 on success.
int jpeg_decode_420(const uint8_t* data, size_t len, uint8_t* dst,
                    int H, int W, int scaled) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    // Constructed BEFORE setjmp: a longjmp out of libjpeg mid-decode
    // (corrupt payload behind a valid header) must not jump out of
    // these objects' scopes — skipped destructors would leak one
    // image's worth of heap per corrupt row, and the jump is formally
    // UB. Declared here, the error path returns through their normal
    // destruction.
    std::vector<uint8_t> buf[3];   // raw420 per-component planes
    std::vector<uint8_t> tmp;      // grayscale / RGB decode scratch
    std::vector<uint8_t> sized;    // RGB resize scratch
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, len);
    jpeg_read_header(&cinfo, TRUE);
    jpeg_calc_output_dimensions(&cinfo);
    const int full_h = cinfo.output_height, full_w = cinfo.output_width;
    if (full_h <= 0 || full_w <= 0 ||
        static_cast<int64_t>(full_h) * full_w > (int64_t)100000000) {
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    uint8_t* Y = dst;
    uint8_t* Cb = dst + static_cast<size_t>(H) * W;
    uint8_t* Cr = Cb + static_cast<size_t>(H / 2) * (W / 2);
    const size_t chroma_bytes = static_cast<size_t>(H / 2) * (W / 2);

    // one prescale policy for every branch below (raw420 detection
    // reads only sampling factors, which scale_num doesn't affect)
    if (scaled) {
        cinfo.scale_num = choose_scale_num(full_h, full_w, H, W);
        cinfo.scale_denom = 8;
    }

    const bool raw420 = cinfo.jpeg_color_space == JCS_YCbCr
        && cinfo.num_components == 3
        && cinfo.comp_info[0].h_samp_factor == 2
        && cinfo.comp_info[0].v_samp_factor == 2
        && cinfo.comp_info[1].h_samp_factor == 1
        && cinfo.comp_info[1].v_samp_factor == 1
        && cinfo.comp_info[2].h_samp_factor == 1
        && cinfo.comp_info[2].v_samp_factor == 1;

    if (raw420) {
        cinfo.raw_data_out = TRUE;
        cinfo.out_color_space = JCS_YCbCr;
        jpeg_start_decompress(&cinfo);
        // One raw read delivers one iMCU row: mcu_h output scanlines,
        // during which component i receives v_samp * DCT_scaled rows of
        // mcus_per_row * h_samp * DCT_scaled samples. At full scale
        // this reduces to the familiar 16 Y / 8 chroma lines; under
        // prescale Y's DCT_scaled_size shrinks while stored-half-res
        // chroma stays at 8, so the per-component numbers MUST come
        // from comp_info.
        const int mcu_w = cinfo.max_h_samp_factor * SDL_MIN_DCT_H(cinfo);
        const int mcu_h = cinfo.max_v_samp_factor * SDL_MIN_DCT_V(cinfo);
        const int mcus_per_row =
            (static_cast<int>(cinfo.output_width) + mcu_w - 1) / mcu_w;
        const int imcu_rows =
            (static_cast<int>(cinfo.output_height) + mcu_h - 1) / mcu_h;
        int rows_per[3], dh[3], dw[3];
        size_t stride[3];
        for (int i = 0; i < 3; ++i) {
            const jpeg_component_info& ci = cinfo.comp_info[i];
            rows_per[i] = ci.v_samp_factor * SDL_COMP_DCT_V(ci);
            stride[i] = static_cast<size_t>(mcus_per_row)
                * ci.h_samp_factor * SDL_COMP_DCT_H(ci);
            dh[i] = ci.downsampled_height;
            dw[i] = ci.downsampled_width;
            if (rows_per[i] <= 0 || rows_per[i] > 16 || dh[i] <= 0
                || dw[i] <= 0
                || stride[i] < static_cast<size_t>(dw[i])) {
                jpeg_abort_decompress(&cinfo);
                jpeg_destroy_decompress(&cinfo);
                return 2;
            }
            buf[i].resize(stride[i]
                          * (static_cast<size_t>(imcu_rows)
                             * rows_per[i]));
        }
        JSAMPROW rows0[16], rows1[16], rows2[16];
        JSAMPARRAY planes[3] = {rows0, rows1, rows2};
        for (int r = 0; r < imcu_rows
                 && cinfo.output_scanline < cinfo.output_height; ++r) {
            for (int i = 0; i < 3; ++i)
                for (int k = 0; k < rows_per[i]; ++k)
                    planes[i][k] = buf[i].data()
                        + (static_cast<size_t>(r) * rows_per[i] + k)
                        * stride[i];
            jpeg_read_raw_data(&cinfo, planes, mcu_h);
        }
        jpeg_finish_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        if (resize_one_strided(buf[0].data(), dh[0], dw[0], 1, stride[0],
                               Y, H, W, 1) ||
            resize_one_strided(buf[1].data(), dh[1], dw[1], 1, stride[1],
                               Cb, H / 2, W / 2, 1) ||
            resize_one_strided(buf[2].data(), dh[2], dw[2], 1, stride[2],
                               Cr, H / 2, W / 2, 1))
            return 2;
        return 0;
    }

    if (cinfo.num_components == 1) {
        cinfo.out_color_space = JCS_GRAYSCALE;
        jpeg_start_decompress(&cinfo);
        const int h = cinfo.output_height, w = cinfo.output_width;
        tmp.resize(static_cast<size_t>(h) * w);
        while (cinfo.output_scanline < cinfo.output_height) {
            JSAMPROW row = tmp.data()
                + static_cast<size_t>(cinfo.output_scanline) * w;
            jpeg_read_scanlines(&cinfo, &row, 1);
        }
        jpeg_finish_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        if (resize_one(tmp.data(), h, w, 1, Y, H, W, 1)) return 2;
        std::memset(Cb, 128, chroma_bytes);
        std::memset(Cr, 128, chroma_bytes);
        return 0;
    }

    // non-4:2:0 color (4:4:4 / 4:2:2 / RGB-coded): decode inline from
    // the already-parsed header (prescaled when ``scaled``), resize in
    // RGB, subsample at the target size
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    if (cinfo.output_components != 3) {
        jpeg_abort_decompress(&cinfo);
        jpeg_destroy_decompress(&cinfo);
        return 2;
    }
    const int h = cinfo.output_height, w = cinfo.output_width;
    tmp.resize(static_cast<size_t>(h) * w * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row = tmp.data()
            + static_cast<size_t>(cinfo.output_scanline) * w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    sized.resize(static_cast<size_t>(H) * W * 3);
    if (resize_one(tmp.data(), h, w, 3, sized.data(), H, W, 3)) return 2;
    rgb_to_yuv420(sized.data(), H, W, dst);
    return 0;
}

int jpeg_dims(const uint8_t* data, size_t len, int32_t* h, int32_t* w,
              int32_t* src_components) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, data, len);
    jpeg_read_header(&cinfo, TRUE);
    jpeg_calc_output_dimensions(&cinfo);
    *h = cinfo.output_height;
    *w = cinfo.output_width;
    if (src_components != nullptr)
        *src_components = cinfo.num_components;
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

#endif  // SDL_HAVE_JPEG

}  // namespace

extern "C" {

int sdl_has_jpeg() {
#ifdef SDL_HAVE_JPEG
    return 1;
#else
    return 0;
#endif
}

// Header-parse n JPEG blobs: fills h/w and the SOURCE component count
// (1 = grayscale, 3 = color; -1 on parse failure).
int sdl_jpeg_batch_dims(const uint8_t** blobs, const int64_t* lens,
                        int64_t n, int32_t* h, int32_t* w, int32_t* c,
                        int32_t num_threads) {
#ifdef SDL_HAVE_JPEG
#ifdef _OPENMP
    if (num_threads > 0) omp_set_num_threads(num_threads);
#pragma omp parallel for schedule(dynamic)
#endif
    for (int64_t i = 0; i < n; ++i) {
        if (jpeg_dims(blobs[i], static_cast<size_t>(lens[i]),
                      &h[i], &w[i], &c[i]) != 0) {
            h[i] = -1;
            w[i] = -1;
            c[i] = -1;
        }
    }
    return 0;
#else
    (void)blobs; (void)lens; (void)n; (void)h; (void)w; (void)c;
    (void)num_threads;
    return 3;
#endif
}

// Decode n JPEGs to RGB into caller buffers dsts[i] (sized h[i]*w[i]*3
// from sdl_jpeg_batch_dims). ok[i]=1 on success. Parallel over images.
int sdl_jpeg_batch_decode(const uint8_t** blobs, const int64_t* lens,
                          int64_t n, uint8_t** dsts, const int32_t* h,
                          const int32_t* w, uint8_t* ok,
                          int32_t num_threads) {
#ifdef SDL_HAVE_JPEG
#ifdef _OPENMP
    if (num_threads > 0) omp_set_num_threads(num_threads);
#pragma omp parallel for schedule(dynamic)
#endif
    for (int64_t i = 0; i < n; ++i) {
        ok[i] = (h[i] > 0 && w[i] > 0 &&
                 jpeg_decode_rgb(blobs[i], static_cast<size_t>(lens[i]),
                                 dsts[i], h[i], w[i]) == 0) ? 1 : 0;
    }
    return 0;
#else
    (void)blobs; (void)lens; (void)n; (void)dsts; (void)h; (void)w;
    (void)ok; (void)num_threads;
    return 3;
#endif
}

// Fused infeed path: decode n JPEGs, bilinear-resize, channel-convert,
// and pack into one contiguous [n, H, W, C] uint8 buffer. ``scaled``
// != 0 enables DCT-domain prescale (decode at the smallest M/8 still
// covering (H, W), then resize — see choose_scale_num). Failed rows
// get ok[i]=0 (their dst slot is zeroed). This is the C++ host shim of
// SURVEY §2.3: the whole decode→resize→layout chain in one native call.
int sdl_decode_resize_pack_v3(const uint8_t** blobs,
                              const int64_t* lens, int64_t n,
                              uint8_t* dst, int32_t H, int32_t W,
                              int32_t C, uint8_t* ok,
                              int32_t num_threads, int32_t scaled) {
#ifdef SDL_HAVE_JPEG
    const size_t row_stride = static_cast<size_t>(H) * W * C;
#ifdef _OPENMP
    if (num_threads > 0) omp_set_num_threads(num_threads);
#pragma omp parallel for schedule(dynamic)
#endif
    for (int64_t i = 0; i < n; ++i) {
        ok[i] = 0;
        int h = 0, w = 0;
        uint8_t* out = dst + i * row_stride;
        std::vector<uint8_t> tmp;
        if (jpeg_decode_rgb_scaled(blobs[i], static_cast<size_t>(lens[i]),
                                   tmp, scaled ? H : 0, scaled ? W : 0,
                                   &h, &w) != 0 ||
            resize_one(tmp.data(), h, w, 3, out, H, W, C) != 0) {
            std::memset(out, 0, row_stride);
            continue;
        }
        ok[i] = 1;
    }
    return 0;
#else
    (void)blobs; (void)lens; (void)n; (void)dst; (void)H; (void)W;
    (void)C; (void)ok; (void)num_threads; (void)scaled;
    return 3;
#endif
}

// Fused 4:2:0 infeed: decode n JPEGs into packed planar YCbCr at
// (H, W) — Y[H*W] ++ Cb[H/2*W/2] ++ Cr[H/2*W/2] per image, 1.5 B/px on
// the wire instead of RGB's 3 (the link-payload halving of VERDICT r4
// next #1). Standard 4:2:0 sources stream out of libjpeg raw (no host
// chroma upsample, no color conversion); the matching device op
// (ops/infeed.py) fuses upsample + color conversion + resize into the
// model program. H and W must be even (returns 4). Failed rows get
// ok[i]=0 with a zeroed slot.
int sdl_decode_resize_pack_420_v3(const uint8_t** blobs,
                                  const int64_t* lens, int64_t n,
                                  uint8_t* dst, int32_t H, int32_t W,
                                  uint8_t* ok, int32_t num_threads,
                                  int32_t scaled) {
#ifdef SDL_HAVE_JPEG
    if (H <= 0 || W <= 0 || (H % 2) != 0 || (W % 2) != 0) return 4;
    const size_t row_stride = yuv420_size(H, W);
#ifdef _OPENMP
    if (num_threads > 0) omp_set_num_threads(num_threads);
#pragma omp parallel for schedule(dynamic)
#endif
    for (int64_t i = 0; i < n; ++i) {
        uint8_t* out = dst + i * row_stride;
        if (jpeg_decode_420(blobs[i], static_cast<size_t>(lens[i]),
                            out, H, W, scaled) != 0) {
            std::memset(out, 0, row_stride);
            ok[i] = 0;
            continue;
        }
        ok[i] = 1;
    }
    return 0;
#else
    (void)blobs; (void)lens; (void)n; (void)dst; (void)H; (void)W;
    (void)ok; (void)num_threads; (void)scaled;
    return 3;
#endif
}

// Resize + channel-convert + pack n images into a contiguous
// [n, H, W, C] uint8 buffer. srcs[i] points at an src_h[i]*src_w[i]*
// src_c[i] uint8 HWC image. Parallel over rows. Returns 0 on success;
// 2 if any row had an unsupported channel conversion.
int sdl_resize_pack_batch(const uint8_t** srcs,
                          const int32_t* src_h,
                          const int32_t* src_w,
                          const int32_t* src_c,
                          int64_t n,
                          uint8_t* dst,
                          int32_t H, int32_t W, int32_t C,
                          int32_t num_threads) {
    const size_t row_stride = static_cast<size_t>(H) * W * C;
    int status = 0;
#ifdef _OPENMP
    if (num_threads > 0) omp_set_num_threads(num_threads);
#pragma omp parallel for schedule(dynamic) reduction(max : status)
#endif
    for (int64_t i = 0; i < n; ++i) {
        const int rc = resize_one(srcs[i], src_h[i], src_w[i], src_c[i],
                                  dst + i * row_stride, H, W, C);
        if (rc > status) status = rc;
    }
    return status;
}

// v2-signature entry points, kept byte-compatible so an older Python
// wrapper paired with this binary cannot feed the v3 functions an
// extra-argument call (args 7+ travel on the stack in SysV — the v3
// impl would read garbage for ``scaled``). New capability = NEW symbol,
// the same convention the v2 4:2:0 packer used.
int sdl_decode_resize_pack(const uint8_t** blobs, const int64_t* lens,
                           int64_t n, uint8_t* dst, int32_t H, int32_t W,
                           int32_t C, uint8_t* ok, int32_t num_threads) {
    return sdl_decode_resize_pack_v3(blobs, lens, n, dst, H, W, C, ok,
                                     num_threads, 0);
}

int sdl_decode_resize_pack_420(const uint8_t** blobs, const int64_t* lens,
                               int64_t n, uint8_t* dst, int32_t H,
                               int32_t W, uint8_t* ok,
                               int32_t num_threads) {
    return sdl_decode_resize_pack_420_v3(blobs, lens, n, dst, H, W, ok,
                                         num_threads, 0);
}

// v4: DCT-prescaled decode via the NEW ``*_v3`` symbols (trailing
// ``scaled`` flag); the v2-named symbols keep their old signatures.
// (An interim build briefly shipped version 3 with the flag appended
// to the v2-named symbols instead — the binding refuses that ABI's
// JPEG symbols rather than guess a signature, hence the skip to 4.)
int sdl_version() { return 4; }

}  // extern "C"
