/* Exact-float bilinear affine crop: the host data pipeline's hot op (copy
 * of cs_vit_tpu/native/fastcrop.c; the code below is the same, line for
 * line, and is built with the same flags, so both packages' crops give the
 * same bits).
 *
 * Same sampling math as cs_vit_tpu_torch/ops/resample.py (kornia
 * crop_and_resize(align_corners=True) convention): output pixel (x, y) of an
 * out_h x out_w patch samples the source at
 *   src = tl + x/(out_w-1) * (tr - tl) + y/(out_h-1) * (bl - tl)
 * with bilinear interpolation and zero padding outside the image.
 *
 * Built at first use by cs_vit_tpu_torch/native/__init__.py with the C
 * compiler on PATH and loaded via ctypes (which releases the interpreter
 * lock for the call); the numpy path is taken only where there is no
 * compiler. Single-threaded on purpose: the loader parallelizes across
 * items.
 *
 * Layouts: images are float32 C-order [H, W, C]; corners are float32 [4, 2]
 * ordered (tl, tr, br, bl) in (x, y) pixel coordinates.
 */

#include <stddef.h>
#include <stdint.h>
#include <math.h>

static inline const float *pix(const float *img, int64_t H, int64_t W,
                               int64_t C, int64_t y, int64_t x) {
    return img + (y * W + x) * C;
}

void crop_affine_bilinear(
    const float *img, int64_t H, int64_t W, int64_t C,
    const float *corners,             /* [4][2]: tl, tr, br, bl */
    float *out, int64_t out_h, int64_t out_w) {
    /* coordinate math in double: matches the numpy path's float64 linspace
       grid, so floor() decisions agree bit-for-bit at integer corners */
    const double tlx = corners[0], tly = corners[1];
    const double trx = corners[2], try_ = corners[3];
    const double blx = corners[6], bly = corners[7];

    const double sxw = (out_w > 1) ? 1.0 / (double)(out_w - 1) : 0.0;
    const double syh = (out_h > 1) ? 1.0 / (double)(out_h - 1) : 0.0;

    for (int64_t j = 0; j < out_h; ++j) {
        const double ty = (double)j * syh;
        const double row_x = tlx + ty * (blx - tlx);
        const double row_y = tly + ty * (bly - tly);
        float *orow = out + j * out_w * C;
        for (int64_t i = 0; i < out_w; ++i) {
            const double tx = (double)i * sxw;
            const double sx = row_x + tx * (trx - tlx);
            const double sy = row_y + tx * (try_ - tly);
            const double fx = floor(sx);
            const double fy = floor(sy);
            const int64_t x0 = (int64_t)fx;
            const int64_t y0 = (int64_t)fy;
            const float wx = (float)(sx - fx);
            const float wy = (float)(sy - fy);

            const int v00 = (x0 >= 0 && x0 < W && y0 >= 0 && y0 < H);
            const int v01 = (x0 + 1 >= 0 && x0 + 1 < W && y0 >= 0 && y0 < H);
            const int v10 = (x0 >= 0 && x0 < W && y0 + 1 >= 0 && y0 + 1 < H);
            const int v11 = (x0 + 1 >= 0 && x0 + 1 < W && y0 + 1 >= 0 && y0 + 1 < H);

            const float w00 = (1.0f - wx) * (1.0f - wy);
            const float w01 = wx * (1.0f - wy);
            const float w10 = (1.0f - wx) * wy;
            const float w11 = wx * wy;

            float *op = orow + i * C;
            for (int64_t c = 0; c < C; ++c) {
                float acc = 0.0f;
                if (v00) acc += w00 * pix(img, H, W, C, y0, x0)[c];
                if (v01) acc += w01 * pix(img, H, W, C, y0, x0 + 1)[c];
                if (v10) acc += w10 * pix(img, H, W, C, y0 + 1, x0)[c];
                if (v11) acc += w11 * pix(img, H, W, C, y0 + 1, x0 + 1)[c];
                op[c] = acc;
            }
        }
    }
}

void crop_affine_bilinear_batch(
    const float *imgs, int64_t N, int64_t H, int64_t W, int64_t C,
    const float *corners,             /* [N][4][2] */
    float *out, int64_t out_h, int64_t out_w) {
    for (int64_t n = 0; n < N; ++n) {
        crop_affine_bilinear(
            imgs + n * H * W * C, H, W, C,
            corners + n * 8,
            out + n * out_h * out_w * C, out_h, out_w);
    }
}

/* uint8-source variant: interpolates raw [0,255] bytes and scales the result
 * by 1/255, so decoded JPEG frames never need a full-frame float conversion
 * (the crop output is the only float tensor the pipeline materializes).
 * Bilinear weights commute with the constant scale, so results match the
 * float path to ~1 ulp. */

static inline const uint8_t *pix_u8(const uint8_t *img, int64_t H, int64_t W,
                                    int64_t C, int64_t y, int64_t x) {
    return img + (y * W + x) * C;
}

void crop_affine_bilinear_u8(
    const uint8_t *img, int64_t H, int64_t W, int64_t C,
    const float *corners,             /* [4][2]: tl, tr, br, bl */
    float *out, int64_t out_h, int64_t out_w) {
    const double tlx = corners[0], tly = corners[1];
    const double trx = corners[2], try_ = corners[3];
    const double blx = corners[6], bly = corners[7];

    const double sxw = (out_w > 1) ? 1.0 / (double)(out_w - 1) : 0.0;
    const double syh = (out_h > 1) ? 1.0 / (double)(out_h - 1) : 0.0;
    const float inv255 = 1.0f / 255.0f;

    for (int64_t j = 0; j < out_h; ++j) {
        const double ty = (double)j * syh;
        const double row_x = tlx + ty * (blx - tlx);
        const double row_y = tly + ty * (bly - tly);
        float *orow = out + j * out_w * C;
        for (int64_t i = 0; i < out_w; ++i) {
            const double tx = (double)i * sxw;
            const double sx = row_x + tx * (trx - tlx);
            const double sy = row_y + tx * (try_ - tly);
            const double fx = floor(sx);
            const double fy = floor(sy);
            const int64_t x0 = (int64_t)fx;
            const int64_t y0 = (int64_t)fy;
            const float wx = (float)(sx - fx);
            const float wy = (float)(sy - fy);

            const int v00 = (x0 >= 0 && x0 < W && y0 >= 0 && y0 < H);
            const int v01 = (x0 + 1 >= 0 && x0 + 1 < W && y0 >= 0 && y0 < H);
            const int v10 = (x0 >= 0 && x0 < W && y0 + 1 >= 0 && y0 + 1 < H);
            const int v11 = (x0 + 1 >= 0 && x0 + 1 < W && y0 + 1 >= 0 && y0 + 1 < H);

            const float w00 = (1.0f - wx) * (1.0f - wy);
            const float w01 = wx * (1.0f - wy);
            const float w10 = (1.0f - wx) * wy;
            const float w11 = wx * wy;

            float *op = orow + i * C;
            for (int64_t c = 0; c < C; ++c) {
                float acc = 0.0f;
                if (v00) acc += w00 * (float)pix_u8(img, H, W, C, y0, x0)[c];
                if (v01) acc += w01 * (float)pix_u8(img, H, W, C, y0, x0 + 1)[c];
                if (v10) acc += w10 * (float)pix_u8(img, H, W, C, y0 + 1, x0)[c];
                if (v11) acc += w11 * (float)pix_u8(img, H, W, C, y0 + 1, x0 + 1)[c];
                op[c] = acc * inv255;
            }
        }
    }
}

void crop_affine_bilinear_u8_batch(
    const uint8_t *imgs, int64_t N, int64_t H, int64_t W, int64_t C,
    const float *corners,             /* [N][4][2] */
    float *out, int64_t out_h, int64_t out_w) {
    for (int64_t n = 0; n < N; ++n) {
        crop_affine_bilinear_u8(
            imgs + n * H * W * C, H, W, C,
            corners + n * 8,
            out + n * out_h * out_w * C, out_h, out_w);
    }
}
