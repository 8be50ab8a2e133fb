// Native host-side data-pipeline kernels.
//
// The reference outsources its input hot path to torch DataLoader worker
// processes (reference ddpm.py:1321, num_workers=cpu_count()); this
// environment's single-core hosts make per-sample Python work the bottleneck
// instead.  These C kernels implement the per-batch hot path — gather +
// normalize + degrade — in one pass over contiguous buffers, called via
// ctypes (see native/__init__.py; numpy route when no compiler is found).
// The port's copy of localdiffusion_tpu/native/dataops.cc.
//
// Build (native/__init__.py does it at first use, into build/native/):
//   g++ -O3 -shared -fPIC dataops.cc -o libdataops.so

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// Gather uint8 images by index and normalize to float32 with y = scale * x.
// images: [n, h*w] row-major uint8; out: [k, h*w] float32.
void gather_normalize_u8(const uint8_t* images, const int64_t* idx,
                         int64_t k, int64_t hw, float scale, float* out) {
  for (int64_t i = 0; i < k; ++i) {
    const uint8_t* src = images + idx[i] * hw;
    float* dst = out + i * hw;
    for (int64_t j = 0; j < hw; ++j) dst[j] = scale * (float)src[j];
  }
}

// Bilinear resize (half-pixel centers, torch align_corners=False) of a
// single-channel float32 image.
void bilinear_resize_f32(const float* src, int64_t sh, int64_t sw,
                         float* dst, int64_t dh, int64_t dw) {
  for (int64_t oy = 0; oy < dh; ++oy) {
    float fy = ((float)oy + 0.5f) * (float)sh / (float)dh - 0.5f;
    float wy = fy - std::floor(fy);
    if (fy < 0) { fy = 0; wy = 0; }
    int64_t y0 = (int64_t)fy; if (y0 > sh - 1) y0 = sh - 1;
    int64_t y1 = y0 + 1; if (y1 > sh - 1) y1 = sh - 1;
    for (int64_t ox = 0; ox < dw; ++ox) {
      float fx = ((float)ox + 0.5f) * (float)sw / (float)dw - 0.5f;
      float wx = fx - std::floor(fx);
      if (fx < 0) { fx = 0; wx = 0; }
      int64_t x0 = (int64_t)fx; if (x0 > sw - 1) x0 = sw - 1;
      int64_t x1 = x0 + 1; if (x1 > sw - 1) x1 = sw - 1;
      float top = src[y0 * sw + x0] * (1 - wx) + src[y0 * sw + x1] * wx;
      float bot = src[y1 * sw + x0] * (1 - wx) + src[y1 * sw + x1] * wx;
      dst[oy * dw + ox] = top * (1 - wy) + bot * wy;
    }
  }
}

// The MNIST LR degradation for a batch: per image, subsample (H-only when
// h_only != 0, else H+W, reference data.py:825-827), bilinear-resize back to
// [h, w], and normalize by `scale`.  images: [n, h, w] uint8 → out [n, h, w].
void degrade_batch_u8(const uint8_t* images, int64_t n, int64_t h, int64_t w,
                      int h_only, float scale, float* out) {
  int64_t sh = (h + 1) / 2;
  int64_t sw = h_only ? w : (w + 1) / 2;
  float* sub = new float[sh * sw];
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* img = images + i * h * w;
    for (int64_t y = 0; y < sh; ++y)
      for (int64_t x = 0; x < sw; ++x)
        sub[y * sw + x] = (float)img[(2 * y) * w + (h_only ? x : 2 * x)];
    bilinear_resize_f32(sub, sh, sw, out + i * h * w, h, w);
    float* dst = out + i * h * w;
    for (int64_t j = 0; j < h * w; ++j) dst[j] *= scale;
  }
  delete[] sub;
}

}  // extern "C"
