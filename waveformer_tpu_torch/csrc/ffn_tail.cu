// Fused CCF-FFN tail for Hopper: out = gelu(LN(dwconv3(h1) + b_dw)) @ W_fc + b_fc.
//
// Replaces the TPU kernel tools/exp_ffn_pallas.py (`ffn_tail`, `_kernel`
// :66-125). h1 (B, D, H, W, Ch) channels-last; depthwise taps (27, Ch), the
// bias, the LayerNorm scale and shift (Ch,) and the Dense bias (C,) fp32;
// the Dense weight transposed to (C, Ch) in the input dtype; out
// (B, D, H, W, C) in the input dtype. The stencil, bias, LayerNorm and GELU
// are fp32; the GELU output is rounded to the input dtype before the Dense,
// which accumulates in fp32, as the TPU kernel does (:114-121). GELU is the
// exact erf form (the port's `models/common.py::gelu`); any H is taken.
//
// What bounds it: at (8, 64³, 192 → 48) bf16 the kernel must read h1 once
// and write out once (1.0 GB, 0.30 ms at 3.35 TB/s); the stencil, LN and
// GELU are about 3e10 fp32 operations (0.44 ms at 67 TFLOP/s), the bound;
// the Dense is 3.9e10 operations on tensor cores (0.04 ms). Everything
// between the read of h1 and the write of out stays on chip. A block of 8
// warps owns 16 output voxels (one m16 tile) across all Ch channels:
//   * the stencil: a thread computes the 27 taps for 8 channels (one 16-byte
//     vector) of 2 of the voxels, in the kd → kh → kw order, plus the bias,
//     into an fp32 tile in shared memory (16 × Ch, 96 KB at Ch = 1536);
//   * each warp takes voxels and computes mean and variance (two passes)
//     with shuffles, then the affine LN and GELU, rounding to bf16 into a
//     second tile;
//   * bf16: the Dense runs on mma.sync.m16n8k16, each warp taking 8-wide
//     column tiles of out; the A fragments come from the bf16 tile, the B
//     fragments straight from the (C, Ch) weight (each weight element is
//     used once per block, so staging it would buy no reuse; it stays in
//     L2). fp32: an FMA loop over the fp32 tile.
// Two ways to feed the stencil, chosen from the dtype and Ch:
//   * `ffn_tail_march_kernel` (bf16, Ch ≤ 192: the 64³ stage): the
//     block owns a 16-voxel run along W of one (b, h) row and marches along
//     D, one output plane per step. The input rows h − 1 … h + 1, columns
//     w0 − 1 … w0 + 16, of planes d − 1, d and d + 1 sit in a 4-slot cp.async
//     ring in shared memory, zero-filled outside the volume (no padded copy
//     of h1); plane d + 2 is copied while plane d is computed. Each input row
//     is fetched about 3.4 times per output instead of 27;
//   * `ffn_tail_kernel` (fp32, and Ch > 192, where the ring would leave one
//     block per SM or not fit): the block owns 16 consecutive voxels and
//     reads every tap from global memory (L1/L2), skipping taps outside the
//     volume.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTV = 16;        // voxels per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kPair = 2;       // voxels per stencil thread
constexpr int kSlots = 4;      // planes in the march kernel's ring
// Widest Ch for the march kernel. At Ch = 384 its ring (166 KB) leaves one
// block per SM and it is slower than reading the taps from L2 (2.18 against
// 1.79 ms at (8, 32³, 384 → 96) on an H100 SXM, chip_smoke.py); at Ch = 192
// it is faster (5.88 against 7.18 ms at (8, 64³, 192 → 48)).
constexpr int kMarchMaxCh = 192;

struct Params {
  const void* h1;
  const float* dw_w;
  const float* dw_b;
  const float* ln_s;
  const float* ln_b;
  const void* fc_w;  // (C, Ch)
  const float* fc_b;
  void* out;
  int B, D, H, W, Ch, C;
  float eps;
};

// LayerNorm (two-pass) and GELU of the fp32 tile's rows, one warp per
// voxel; the result goes to `a_s` in bf16 (bf16) or back into the tile (fp32).
template <typename T>
__device__ __forceinline__ void ln_gelu(const Params& p, float* tile, __nv_bfloat16* a_s) {
  const int fs = p.Ch + 4, as = p.Ch + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int lv = warp; lv < kTV; lv += kThreads / 32) {
    float* row = tile + lv * fs;
    float s = 0.f;
    for (int c = lane; c < p.Ch; c += 32) s += row[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float mean = s / p.Ch;
    float q = 0.f;
    for (int c = lane; c < p.Ch; c += 32) {
      const float d = row[c] - mean;
      q = fmaf(d, d, q);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
    const float rstd = rsqrtf(q / p.Ch + p.eps);
    for (int c = lane; c < p.Ch; c += 32) {
      const float z = (row[c] - mean) * rstd * p.ln_s[c] + p.ln_b[c];
      const float gz = 0.5f * z * (1.f + erff(z * 0.7071067811865476f));
      if constexpr (sizeof(T) == 2) {
        a_s[lv * as + c] = __float2bfloat16(gz);
      } else {
        row[c] = gz;
      }
    }
  }
}

// out[base + r, :] = row r of the tile @ W_fc + b_fc for the first `nvalid` rows.
template <typename T>
__device__ __forceinline__ void dense(const Params& p, const float* tile,
                                      const __nv_bfloat16* a_s, long long base, int nvalid) {
  T* out = static_cast<T*>(p.out) + base * p.C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if constexpr (sizeof(T) == 2) {
    const int as = p.Ch + 8;  // bf16 row stride: conflict-free fragments
    const int g = lane / 4, t = lane % 4;
    const __nv_bfloat16* fcw = static_cast<const __nv_bfloat16*>(p.fc_w);
    for (int nt = warp; nt < p.C / 8; nt += kThreads / 32) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* br = fcw + (long long)(nt * 8 + g) * p.Ch + 2 * t;
      const __nv_bfloat16* ar0 = a_s + g * as + 2 * t;
      const __nv_bfloat16* ar1 = ar0 + 8 * as;
#pragma unroll 4
      for (int k0 = 0; k0 < p.Ch; k0 += 16) {
        const uint32_t af[4] = {wft::ld32(ar0 + k0), wft::ld32(ar1 + k0),
                                wft::ld32(ar0 + k0 + 8), wft::ld32(ar1 + k0 + 8)};
        // a fresh fragment per K-step, added in IEEE fp32 (see conv3.cu)
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        wft::mma_bf16(part, af, wft::ld32(br + k0), wft::ld32(br + k0 + 8));
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += part[i];
      }
      const int n = nt * 8 + 2 * t;
      const float b0 = p.fc_b[n], b1 = p.fc_b[n + 1];
      if (g < nvalid) {
        *reinterpret_cast<uint32_t*>(out + (long long)g * p.C + n) =
            wft::pack_bf16(acc[0] + b0, acc[1] + b1);
      }
      if (g + 8 < nvalid) {
        *reinterpret_cast<uint32_t*>(out + (long long)(g + 8) * p.C + n) =
            wft::pack_bf16(acc[2] + b0, acc[3] + b1);
      }
    }
  } else {
    const int fs = p.Ch + 4;
    const float* fcw = static_cast<const float*>(p.fc_w);
    for (int e = threadIdx.x; e < kTV * p.C; e += kThreads) {
      const int lv = e / p.C, n = e % p.C;
      if (lv >= nvalid) continue;
      const float* row = tile + lv * fs;
      const float* wr = fcw + (long long)n * p.Ch;
      float s = 0.f;
      for (int k = 0; k < p.Ch; ++k) s = fmaf(row[k], wr[k], s);
      out[(long long)lv * p.C + n] = s + p.fc_b[n];
    }
  }
}

size_t tile_bytes(int ch, bool bf16) {
  return (size_t)kTV * (ch + 4) * sizeof(float) + (bf16 ? (size_t)kTV * (ch + 8) * 2 : 0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ffn_tail_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int fs = p.Ch + 4;  // fp32 row stride
  float* tile = smem;       // [kTV][Ch + 4]
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(tile + kTV * fs);
  const long long nvox = (long long)p.B * p.D * p.H * p.W;
  const long long v0 = (long long)blockIdx.x * kTV;
  const int nvec = p.Ch / 8;
  const T* h1 = static_cast<const T*>(p.h1);

  for (int e = threadIdx.x; e < (kTV / kPair) * nvec; e += kThreads) {
    const int c0 = (e % nvec) * 8;
    const int lv0 = (e / nvec) * kPair;
    float acc[kPair][8];
    int vd[kPair], vh[kPair], vw[kPair], vb[kPair];
    bool ok[kPair];
#pragma unroll
    for (int q = 0; q < kPair; ++q) {
      const long long v = v0 + lv0 + q;
      ok[q] = v < nvox;
      vw[q] = (int)(v % p.W);
      vh[q] = (int)((v / p.W) % p.H);
      vd[q] = (int)((v / ((long long)p.W * p.H)) % p.D);
      vb[q] = (int)(v / ((long long)p.W * p.H * p.D));
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[q][i] = 0.f;
    }
#pragma unroll
    for (int tap = 0; tap < 27; ++tap) {
      const int kd = tap / 9 - 1, kh = (tap / 3) % 3 - 1, kw = tap % 3 - 1;
      float wv[8];
      wft::load8(p.dw_w + (long long)tap * p.Ch + c0, wv);
#pragma unroll
      for (int q = 0; q < kPair; ++q) {
        const int dd = vd[q] + kd, hh = vh[q] + kh, ww = vw[q] + kw;
        if (!ok[q] || dd < 0 || dd >= p.D || hh < 0 || hh >= p.H || ww < 0 || ww >= p.W) {
          continue;
        }
        float xv[8];
        wft::load8(h1 + ((((long long)vb[q] * p.D + dd) * p.H + hh) * p.W + ww) * p.Ch + c0,
                   xv);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[q][i] = fmaf(xv[i], wv[i], acc[q][i]);
      }
    }
    float bv[8];
    wft::load8(p.dw_b + c0, bv);
#pragma unroll
    for (int q = 0; q < kPair; ++q) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[q][i] = ok[q] ? acc[q][i] + bv[i] : 0.f;
      wft::store8(tile + (lv0 + q) * fs + c0, acc[q]);
    }
  }
  __syncthreads();
  ln_gelu<T>(p, tile, a_s);
  __syncthreads();
  dense<T>(p, tile, a_s, v0, (int)min((long long)kTV, nvox - v0));
}

__global__ void __launch_bounds__(kThreads) ffn_tail_march_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int kCols = kTV + 2;  // w0 − 1 … w0 + 16
  extern __shared__ __align__(16) float smem[];
  const int fs = p.Ch + 4;
  float* tile = smem;
  bf16* a_s = reinterpret_cast<bf16*>(tile + kTV * fs);
  bf16* ring = a_s + kTV * (p.Ch + 8);  // [slot][3 rows][kCols][Ch]
  const int slot = 3 * kCols * p.Ch;
  const int wblocks = (p.W + kTV - 1) / kTV;
  const int w0 = (blockIdx.x % wblocks) * kTV;
  const int h = (blockIdx.x / wblocks) % p.H;
  const int b = blockIdx.x / (wblocks * p.H);
  const int nvec = p.Ch / 8;
  const bf16* h1 = static_cast<const bf16*>(p.h1);
  const int nvalid = min(kTV, p.W - w0);

  // rows h − 1 … h + 1, columns w0 − 1 … w0 + 16 of plane pd, zero outside
  auto load_plane = [&](int pd) {
    bf16* dst = ring + ((pd + kSlots) % kSlots) * slot;
    for (int e = threadIdx.x; e < 3 * kCols * nvec; e += kThreads) {
      const int cv = e % nvec, col = (e / nvec) % kCols, row = e / (nvec * kCols);
      const int hh = h + row - 1, ww = w0 + col - 1;
      const bool ok = pd >= 0 && pd < p.D && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W;
      const bf16* src =
          ok ? h1 + ((((long long)b * p.D + pd) * p.H + hh) * p.W + ww) * p.Ch + cv * 8 : h1;
      wft::cp_async<16>(dst + (row * kCols + col) * p.Ch + cv * 8, src, ok);
    }
  };

  for (int pd = -1; pd <= 1; ++pd) {
    load_plane(pd);
    wft::cp_async_commit();
  }
  for (int d = 0; d < p.D; ++d) {
    // plane d + 2 goes into plane d − 2's slot (its last reader, the stencil
    // of plane d − 1, is behind a barrier) and is copied during this step
    if (d + 2 <= p.D) load_plane(d + 2);
    wft::cp_async_commit();
    wft::cp_async_wait<1>();  // planes d − 1 … d + 1 have landed
    __syncthreads();
    // the stencil of plane d, kd → kh → kw, plus the bias
    for (int e = threadIdx.x; e < (kTV / kPair) * nvec; e += kThreads) {
      const int c0 = (e % nvec) * 8;
      const int lv0 = (e / nvec) * kPair;
      float acc[kPair][8];
#pragma unroll
      for (int q = 0; q < kPair; ++q)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[q][i] = 0.f;
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        const bf16* pl = ring + ((d - 1 + kd + kSlots) % kSlots) * slot;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          float xv[kPair + 2][8];  // columns lv0 … lv0 + 3 (w0 + lv0 − 1 …)
#pragma unroll
          for (int c = 0; c < kPair + 2; ++c) {
            wft::load8(pl + (kh * kCols + lv0 + c) * p.Ch + c0, xv[c]);
          }
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            float wv[8];
            wft::load8(p.dw_w + (long long)((kd * 3 + kh) * 3 + kw) * p.Ch + c0, wv);
#pragma unroll
            for (int q = 0; q < kPair; ++q)
#pragma unroll
              for (int i = 0; i < 8; ++i) acc[q][i] = fmaf(xv[q + kw][i], wv[i], acc[q][i]);
          }
        }
      }
      float bv[8];
      wft::load8(p.dw_b + c0, bv);
#pragma unroll
      for (int q = 0; q < kPair; ++q) {
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[q][i] = lv0 + q < nvalid ? acc[q][i] + bv[i] : 0.f;
        wft::store8(tile + (lv0 + q) * fs + c0, acc[q]);
      }
    }
    __syncthreads();  // the tile is complete
    ln_gelu<bf16>(p, tile, a_s);
    __syncthreads();
    dense<bf16>(p, tile, a_s, (((long long)b * p.D + d) * p.H + h) * p.W + w0, nvalid);
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = tile_bytes(p.Ch, sizeof(T) == 2);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_tail_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long nvox = (long long)p.B * p.D * p.H * p.W;
  const long long blocks = (nvox + kTV - 1) / kTV;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ffn_tail_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_march(const Params& p, cudaStream_t stream) {
  const size_t smem = tile_bytes(p.Ch, true) + (size_t)kSlots * 3 * (kTV + 2) * p.Ch * 2;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_tail_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)p.B * p.H * ((p.W + kTV - 1) / kTV);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ffn_tail_march_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). Ch must be a multiple of 8 (16 for
// bf16) and, for bf16, C a multiple of 8; h1, dw_w and dw_b 16-byte aligned.
extern "C" int wft_ffn_tail(int dtype, const void* h1, const void* dw_w, const void* dw_b,
                            const void* ln_s, const void* ln_b, const void* fc_w,
                            const void* fc_b, void* out, int B, int D, int H, int W, int Ch,
                            int C, float eps, void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || C < 1 || Ch < 8 || Ch % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{h1, static_cast<const float*>(dw_w), static_cast<const float*>(dw_b),
           static_cast<const float*>(ln_s), static_cast<const float*>(ln_b), fc_w,
           static_cast<const float*>(fc_b), out, B, D, H, W, Ch, C, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == wft::kFloat32) return (int)launch<float>(p, s);
  if (dtype == wft::kBFloat16 && Ch % 16 == 0 && C % 8 == 0) {
    return (int)(Ch <= kMarchMaxCh ? launch_march(p, s) : launch<__nv_bfloat16>(p, s));
  }
  return (int)cudaErrorInvalidValue;
}
