// wfdata — native host-side data-engine kernels for waveformer_tpu_torch
// (a copy of waveformer_tpu/runtime/wfdata.cpp).
//
// The training-input pipeline (patch cropping + spatial augmentation +
// smoothing) is the framework's host hot path: it must outrun the device step
// to keep the device fed (the reference leans on 12 batchgenerators worker
// processes for the same reason, `light_training/trainer.py:161-164`).
// These kernels replace the scipy inner loops with OpenMP-parallel C++:
//
//   * affine_trilinear_f32 — fused rotation/scale resampling (order-1),
//     constant boundary fill — the SpatialTransform inner loop
//   * affine_nearest_f32 — label-safe variant for segmentations
//   * gaussian_blur_f32 — separable 3-pass blur (reflect boundary)
//   * crop_pad_f32 — out-of-bounds patch extraction with constant fill
//
// Exposed with plain C linkage; loaded from Python via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// y[i,j,k] = x(M @ (i,j,k) + offset), trilinear, constant fill.
// x: (D,H,W) float32; m: 3x3 row-major; off: 3
void affine_trilinear_f32(const float* x, float* y, int64_t D, int64_t H,
                          int64_t W, const double* m, const double* off,
                          float cval) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t i = 0; i < D; ++i) {
    for (int64_t j = 0; j < H; ++j) {
      const double base_d = m[0] * i + m[1] * j + off[0];
      const double base_h = m[3] * i + m[4] * j + off[1];
      const double base_w = m[6] * i + m[7] * j + off[2];
      float* row = y + (i * H + j) * W;
      for (int64_t k = 0; k < W; ++k) {
        const double sd = base_d + m[2] * k;
        const double sh = base_h + m[5] * k;
        const double sw = base_w + m[8] * k;
        // scipy mode='constant' order=1: any coordinate outside
        // [0, size-1] → cval (no partial blending)
        if (sd < 0.0 || sd > (double)(D - 1) || sh < 0.0 ||
            sh > (double)(H - 1) || sw < 0.0 || sw > (double)(W - 1)) {
          row[k] = cval;
          continue;
        }
        int64_t d0 = (int64_t)sd, h0 = (int64_t)sh, w0 = (int64_t)sw;
        if (d0 > D - 2) d0 = D - 2 > 0 ? D - 2 : 0;
        if (h0 > H - 2) h0 = H - 2 > 0 ? H - 2 : 0;
        if (w0 > W - 2) w0 = W - 2 > 0 ? W - 2 : 0;
        const double fd = sd - d0, fh = sh - h0, fw = sw - w0;
        const int64_t d1 = D > 1 ? d0 + 1 : d0;
        const int64_t h1 = H > 1 ? h0 + 1 : h0;
        const int64_t w1 = W > 1 ? w0 + 1 : w0;
        const float* p00 = x + (d0 * H + h0) * W;
        const float* p01 = x + (d0 * H + h1) * W;
        const float* p10 = x + (d1 * H + h0) * W;
        const float* p11 = x + (d1 * H + h1) * W;
        const double c00 = p00[w0] * (1 - fw) + p00[w1] * fw;
        const double c01 = p01[w0] * (1 - fw) + p01[w1] * fw;
        const double c10 = p10[w0] * (1 - fw) + p10[w1] * fw;
        const double c11 = p11[w0] * (1 - fw) + p11[w1] * fw;
        const double c0 = c00 * (1 - fh) + c01 * fh;
        const double c1 = c10 * (1 - fh) + c11 * fh;
        row[k] = (float)(c0 * (1 - fd) + c1 * fd);
      }
    }
  }
}

void affine_nearest_f32(const float* x, float* y, int64_t D, int64_t H,
                        int64_t W, const double* m, const double* off,
                        float cval) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t i = 0; i < D; ++i) {
    for (int64_t j = 0; j < H; ++j) {
      const double base_d = m[0] * i + m[1] * j + off[0];
      const double base_h = m[3] * i + m[4] * j + off[1];
      const double base_w = m[6] * i + m[7] * j + off[2];
      float* row = y + (i * H + j) * W;
      for (int64_t k = 0; k < W; ++k) {
        const double sd = base_d + m[2] * k;
        const double sh = base_h + m[5] * k;
        const double sw = base_w + m[8] * k;
        // scipy mode='constant': coordinate outside [0, size-1] → cval
        if (sd < 0.0 || sd > (double)(D - 1) || sh < 0.0 ||
            sh > (double)(H - 1) || sw < 0.0 || sw > (double)(W - 1)) {
          row[k] = cval;
          continue;
        }
        // nearest = floor(coord + 0.5); exact-half ties depend on fp
        // rounding order and are not bit-stable across implementations
        const int64_t di =
            std::min<int64_t>((int64_t)std::floor(sd + 0.5), D - 1);
        const int64_t hi =
            std::min<int64_t>((int64_t)std::floor(sh + 0.5), H - 1);
        const int64_t wi =
            std::min<int64_t>((int64_t)std::floor(sw + 0.5), W - 1);
        row[k] = x[(di * H + hi) * W + wi];
      }
    }
  }
}

// separable gaussian blur, reflect boundary (scipy default), truncate 4 sigma
static void blur_axis(const float* src, float* dst, int64_t n_outer,
                      int64_t n_axis, int64_t stride,
                      const std::vector<float>& kern) {
  const int64_t r = (int64_t)kern.size() / 2;
#pragma omp parallel for schedule(static)
  for (int64_t o = 0; o < n_outer; ++o) {
    // outer index decomposes around the axis: o = hi * 1 + lo over
    // contiguous memory; caller passes pointers laid out so axis has
    // `stride`, outer iterates the remaining dims contiguously.
    const int64_t hi = o / stride;
    const int64_t lo = o % stride;
    const float* s = src + hi * n_axis * stride + lo;
    float* d = dst + hi * n_axis * stride + lo;
    for (int64_t i = 0; i < n_axis; ++i) {
      float acc = 0.f;
      for (int64_t t = -r; t <= r; ++t) {
        int64_t idx = i + t;
        if (idx < 0) idx = -idx - 1;           // reflect
        if (idx >= n_axis) idx = 2 * n_axis - idx - 1;
        acc += kern[t + r] * s[idx * stride];
      }
      d[i * stride] = acc;
    }
  }
}

void gaussian_blur_f32(const float* x, float* y, int64_t D, int64_t H,
                       int64_t W, double sigma) {
  int64_t r = std::max<int64_t>(1, (int64_t)std::lround(4.0 * sigma));
  std::vector<float> kern(2 * r + 1);
  double s2 = 2.0 * sigma * sigma, sum = 0.0;
  for (int64_t t = -r; t <= r; ++t) {
    kern[t + r] = (float)std::exp(-(double)(t * t) / s2);
    sum += kern[t + r];
  }
  for (auto& k : kern) k = (float)(k / sum);
  std::vector<float> tmp((size_t)(D * H * W));
  // axis W (stride 1, outer D*H)
  blur_axis(x, tmp.data(), D * H, W, 1, kern);
  // axis H (stride W, outer D*W → iterate hi=D, lo=W)
  blur_axis(tmp.data(), y, D * W, H, W, kern);
  // axis D (stride H*W, outer H*W)
  std::memcpy(tmp.data(), y, sizeof(float) * (size_t)(D * H * W));
  blur_axis(tmp.data(), y, H * W, D, H * W, kern);
}

// crop a patch with constant fill for out-of-bounds regions.
// x: (C, D, H, W); patch corner (d0,h0,w0) may be negative.
void crop_pad_f32(const float* x, float* y, int64_t C, int64_t D, int64_t H,
                  int64_t W, int64_t d0, int64_t h0, int64_t w0, int64_t pd,
                  int64_t ph, int64_t pw, float fill) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t c = 0; c < C; ++c) {
    for (int64_t i = 0; i < pd; ++i) {
      const int64_t di = d0 + i;
      float* dst = y + ((c * pd + i) * ph) * pw;
      if (di < 0 || di >= D) {
        std::fill(dst, dst + ph * pw, fill);
        continue;
      }
      for (int64_t j = 0; j < ph; ++j) {
        const int64_t hj = h0 + j;
        float* drow = dst + j * pw;
        if (hj < 0 || hj >= H) {
          std::fill(drow, drow + pw, fill);
          continue;
        }
        const int64_t wa = std::max<int64_t>(0, -w0);
        const int64_t wb = std::min<int64_t>(pw, W - w0);
        if (wa > 0) std::fill(drow, drow + std::min(wa, pw), fill);
        if (wb > wa)
          std::memcpy(drow + wa, x + ((c * D + di) * H + hj) * W + (w0 + wa),
                      sizeof(float) * (size_t)(wb - wa));
        if (wb < pw) std::fill(drow + std::max<int64_t>(wb, 0), drow + pw, fill);
      }
    }
  }
}

int wfdata_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
