// Depthwise 3×3×3 "same" convolution, channels-last, for Hopper.
//
// Replaces the TPU kernel waveformer_tpu/ops/dwconv_pallas.py (`dwconv3`,
// `_kernel` :32-44): stride 1, zero padding 1, one (3,3,3) filter per
// channel, fp32 accumulation in the kd → kh → kw tap order, no bias.
// x, y: (B, D, H, W, C) contiguous, C a multiple of 8; weights (27, C) fp32.
//
// What bounds it: bytes. 27 multiply-adds per element is far below the
// card's ops:byte balance; at (8, 64, 64, 64, 192) bf16 the kernel must read
// and write 805 MB each, ≈0.48 ms at 3.35 TB/s. The design keeps loads wide
// and reuses each load in registers:
//   * a thread owns 8 channels (one 16-byte bf16 vector) of 2 consecutive
//     output voxels along W of one (b, h) row and marches along D; each
//     input plane is loaded once (3 rows × 4 vectors) and applied to the
//     three outputs in flight (6 vector loads per output instead of 27);
//   * a warp spans 4 channel vectors × 8 W-neighbours: 64 contiguous bytes
//     per voxel, and overlapping rows between neighbours hit L1;
//   * the block's 27 × 32 tap weights sit in shared memory; each tap is read
//     once per row for both outputs, as a broadcast to 8 lanes.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kOutW = 2;  // output voxels per thread along W

// One thread: 8 channels × 2 W-outputs of one (b, h) row, marching along D.
// Input plane p feeds outputs p + 1 (kd = 0), p (kd = 1) and p − 1 (kd = 2),
// so marching p upwards adds each output's taps in kd → kh → kw order.
template <typename T>
__global__ void __launch_bounds__(256) dwconv3_kernel(
    const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
    int B, int D, int H, int W, int C, int chunks_per_block) {
  extern __shared__ __align__(16) float wsm[];
  const int cc = chunks_per_block;
  const int chunk0 = blockIdx.y * cc;
  for (int e = threadIdx.x; e < 27 * cc * 8; e += blockDim.x) {
    const int t = e / (cc * 8), c = e % (cc * 8);
    wsm[e] = w[t * C + chunk0 * 8 + c];
  }
  __syncthreads();

  const int lc = threadIdx.x % cc;
  const int lv = threadIdx.x / cc;
  const int per_block = blockDim.x / cc;
  const int wt = (W + kOutW - 1) / kOutW;
  const long long item = (long long)blockIdx.x * per_block + lv;
  if (lv >= per_block || item >= (long long)B * H * wt) return;
  const int wq = (int)(item % wt);
  const int hi = (int)((item / wt) % H);
  const int bi = (int)(item / ((long long)wt * H));
  const int w0 = wq * kOutW;
  const int c0 = (chunk0 + lc) * 8;
  const long long plane = (long long)H * W * C;
  const T* xb = x + (long long)bi * D * plane + c0;
  T* yb = y + (long long)bi * D * plane + ((long long)hi * W) * C + c0;
  const float* wl = wsm + lc * 8;  // tap t of this thread's channels: wl + t·cc·8

  // acc_lo: output p − 1 (gets kd = 2), acc_mid: output p (kd = 1),
  // acc_hi: output p + 1 (kd = 0)
  float acc_lo[kOutW][8], acc_mid[kOutW][8], acc_hi[kOutW][8];
#pragma unroll
  for (int o = 0; o < kOutW; ++o)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc_lo[o][i] = acc_mid[o][i] = acc_hi[o][i] = 0.f;

  for (int pd = 0; pd < D; ++pd) {
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int hh = hi + kh - 1;
      if (hh < 0 || hh >= H) continue;
      const T* row = xb + (long long)pd * plane + (long long)hh * W * C;
      float v[kOutW + 2][8];  // inputs w0 − 1 … w0 + kOutW, zero outside
#pragma unroll
      for (int pidx = 0; pidx < kOutW + 2; ++pidx) {
        const int ww = w0 + pidx - 1;
        if (ww >= 0 && ww < W) {
          wft::load8(row + (long long)ww * C, v[pidx]);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) v[pidx][i] = 0.f;
        }
      }
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        // one weight read per tap, shared by the kOutW outputs
        float t0[8], t1[8], t2[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          t0[i] = wl[((0 * 3 + kh) * 3 + kw) * cc * 8 + i];
          t1[i] = wl[((1 * 3 + kh) * 3 + kw) * cc * 8 + i];
          t2[i] = wl[((2 * 3 + kh) * 3 + kw) * cc * 8 + i];
        }
#pragma unroll
        for (int o = 0; o < kOutW; ++o) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc_hi[o][i] = fmaf(v[o + kw][i], t0[i], acc_hi[o][i]);
            acc_mid[o][i] = fmaf(v[o + kw][i], t1[i], acc_mid[o][i]);
            acc_lo[o][i] = fmaf(v[o + kw][i], t2[i], acc_lo[o][i]);
          }
        }
      }
    }
    if (pd >= 1) {  // output pd − 1 has all its taps (plane pd was its last)
      T* out = yb + (long long)(pd - 1) * plane;
#pragma unroll
      for (int o = 0; o < kOutW; ++o)
        if (w0 + o < W) wft::store8(out + (long long)(w0 + o) * C, acc_lo[o]);
    }
#pragma unroll
    for (int o = 0; o < kOutW; ++o)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc_lo[o][i] = acc_mid[o][i];
        acc_mid[o][i] = acc_hi[o][i];
        acc_hi[o][i] = 0.f;
      }
  }
  // output D − 1: its kd = 2 plane is the zero border
  T* out = yb + (long long)(D - 1) * plane;
#pragma unroll
  for (int o = 0; o < kOutW; ++o)
    if (w0 + o < W) wft::store8(out + (long long)(w0 + o) * C, acc_lo[o]);
}

// Channel chunks per block: 4 where they divide, so a warp spans 4 chunks ×
// 8 voxel items (64 contiguous bytes per voxel, weights read as broadcasts).
int pick_chunks(int chunks) {
  return chunks % 4 == 0 ? 4 : (chunks % 2 == 0 ? 2 : 1);
}

template <typename T>
cudaError_t launch(const void* x, const float* w, void* y, int B, int D,
                   int H, int W, int C, cudaStream_t stream) {
  const int chunks = C / 8;
  const int cc = pick_chunks(chunks);
  const int per_block = 256 / cc;
  const long long items = (long long)B * H * ((W + kOutW - 1) / kOutW);
  const long long blocks = (items + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = (size_t)27 * cc * 8 * sizeof(float);
  dim3 grid((unsigned)blocks, chunks / cc);
  dwconv3_kernel<T><<<grid, per_block * cc, smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(y), B, D, H, W, C, cc);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success).
extern "C" int wft_dwconv3(int dtype, const void* x, const void* w, void* y,
                           int B, int D, int H, int W, int C, void* stream) {
  if (C % 8 != 0 || B < 1 || D < 1 || H < 1 || W < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (dtype == wft::kFloat32) return (int)launch<float>(x, wf, y, B, D, H, W, C, s);
  if (dtype == wft::kBFloat16) {
    return (int)launch<__nv_bfloat16>(x, wf, y, B, D, H, W, C, s);
  }
  return (int)cudaErrorInvalidValue;
}
