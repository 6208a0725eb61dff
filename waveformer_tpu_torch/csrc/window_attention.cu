// Fused window attention for Hopper: out = softmax(q·kᵀ·scale + bias_h)·v.
//
// Replaces the TPU kernel waveformer_tpu/ops/attention_pallas.py
// (`window_attention`, `_kernel` :34-51). Shapes: q/k/v/out (BW, H, N, D)
// with any strides whose last dimension is contiguous; bias (H, N, N) fp32
// contiguous, shared by every window. Scores, softmax and the PV sum are
// fp32; the probabilities are cast to the input dtype before PV, as the
// model's composition does (`models/attention.py:100-101`).
//
// What bounds it: not the two products (D = 16 on the WaveFormer path) but
// the bias and the exponentials. At the stage-1 call (512, 3, 512, 16) bf16,
// q/k/v/out are 100.7 MB; a block that re-read its head's 1 MiB fp32 bias
// for every window would pull 1.6 GB. So each block owns one
// (head, 64-query tile, group of windows): it loads its 64 bias rows once
// into shared memory (~130 KB) and then loops over its windows, as the TPU
// kernel kept the bias block resident across its window-fastest grid.
// Per window it streams K/V in 64-key tiles through shared memory and runs
// an online (flash-style) softmax in the log2 domain.
//
// Two paths, chosen from the dtype and shape:
//   * bf16 with D a multiple of 16 and N ≤ 512 (every call of the
//     WaveFormer path): both products on mma.sync tensor cores, see
//     `window_attention_tc_kernel`;
//   * otherwise (fp32, D = 8, 24, ..., N up to 1024): fp32 FMA loops. Four
//     threads share a query row, each taking every fourth key; their partial
//     (max, sum, acc) states are merged with warp shuffles at the end. Bias
//     rows are padded to N + 4 floats and K/V rows to D + 4 floats, so the 8
//     query rows × 4 keys a warp reads at once fall in 32 distinct banks.
// wgmma and TMA are later work.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kKeyTile = 64;    // keys per shared-memory tile
constexpr int kThreadsPerQ = 4;  // threads sharing one query row
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* o;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  int bw, n;
  float qscale;  // scale · log2(e)
  int windows_per_block;
};

template <typename T, int D>
__global__ void __launch_bounds__(256) window_attention_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int qt = blockDim.x / kThreadsPerQ;  // query rows of this block
  const int n = p.n;
  const int bstride = n + 4;
  const int kvstride = D + 4;
  float* bias_s = smem;
  float* k_s = bias_s + qt * bstride;
  float* v_s = k_s + kKeyTile * kvstride;

  const int head = blockIdx.y;
  const int q0 = blockIdx.x * qt;
  const int w0 = blockIdx.z * p.windows_per_block;
  const int w1 = min(w0 + p.windows_per_block, p.bw);
  const int tid = threadIdx.x;
  const int r = tid / kThreadsPerQ;
  const int sub = tid % kThreadsPerQ;

  // this block's bias rows, once, pre-multiplied by log2(e)
  const float* bsrc = p.bias + ((size_t)head * n + q0) * n;
  for (int e = tid * 4; e < qt * n; e += blockDim.x * 4) {
    const int row = e / n, col = e % n;
    float4 b = *reinterpret_cast<const float4*>(bsrc + (size_t)row * n + col);
    b.x *= kLog2e; b.y *= kLog2e; b.z *= kLog2e; b.w *= kLog2e;
    *reinterpret_cast<float4*>(bias_s + row * bstride + col) = b;
  }

  const float* brow = bias_s + r * bstride;
  for (int w = w0; w < w1; ++w) {
    const T* qp = static_cast<const T*>(p.q) + w * p.q_sb + head * p.q_sh +
                  (long long)(q0 + r) * p.q_sn;
    const T* kb = static_cast<const T*>(p.k) + w * p.k_sb + head * p.k_sh;
    const T* vb = static_cast<const T*>(p.v) + w * p.v_sb + head * p.v_sh;
    float qf[D];
#pragma unroll
    for (int c = 0; c < D; c += 8) wft::load8(qp + c, qf + c);
#pragma unroll
    for (int d = 0; d < D; ++d) qf[d] *= p.qscale;
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
    float m = -INFINITY, l = 0.f;

    for (int k0 = 0; k0 < n; k0 += kKeyTile) {
      __syncthreads();  // the previous tile (and the bias fill) is done
      for (int e = tid; e < kKeyTile * (D / 8); e += blockDim.x) {
        const int row = e / (D / 8), c = (e % (D / 8)) * 8;
        float tmp[8];
        wft::load8(kb + (long long)(k0 + row) * p.k_sn + c, tmp);
        wft::store8(k_s + row * kvstride + c, tmp);
        wft::load8(vb + (long long)(k0 + row) * p.v_sn + c, tmp);
        wft::store8(v_s + row * kvstride + c, tmp);
      }
      __syncthreads();

      constexpr int kPer = kKeyTile / kThreadsPerQ;
      float sc[kPer];
      float cmax = -INFINITY;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int j = i * kThreadsPerQ + sub;
        const float* kr = k_s + j * kvstride;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + d);
          s = fmaf(qf[d], kk.x, s);
          s = fmaf(qf[d + 1], kk.y, s);
          s = fmaf(qf[d + 2], kk.z, s);
          s = fmaf(qf[d + 3], kk.w, s);
        }
        s += brow[k0 + j];
        sc[i] = s;
        cmax = fmaxf(cmax, s);
      }
      const float mnew = fmaxf(m, cmax);
      const float corr = exp2f(m - mnew);  // 0 on the first tile
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int j = i * kThreadsPerQ + sub;
        const float pr = exp2f(sc[i] - mnew);
        l += pr;
        const float pq = wft::round_to<T>(pr);
        const float* vr = v_s + j * kvstride;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + d);
          acc[d] = fmaf(pq, vv.x, acc[d]);
          acc[d + 1] = fmaf(pq, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(pq, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(pq, vv.w, acc[d + 3]);
        }
      }
      m = mnew;
    }

    // merge the partial states of the threads that share this query row
#pragma unroll
    for (int off = 1; off < kThreadsPerQ; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, off);
      const float lo = __shfl_xor_sync(0xffffffffu, l, off);
      const float mn = fmaxf(m, mo);
      const float cs = exp2f(m - mn), co = exp2f(mo - mn);
      l = l * cs + lo * co;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[d], off);
        acc[d] = acc[d] * cs + ao * co;
      }
      m = mn;
    }
    const float inv = 1.f / l;
    T* op = static_cast<T*>(p.o) + w * p.o_sb + head * p.o_sh +
            (long long)(q0 + r) * p.o_sn;
    constexpr int kOutPer = D / kThreadsPerQ;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (d / kOutPer == sub) op[d] = wft::from_f<T>(acc[d] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int h, cudaStream_t stream) {
  const int qt = p.n <= 512 ? 64 : 32;
  const size_t smem =
      (size_t)(qt * (p.n + 4) + 2 * kKeyTile * (D + 4)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int groups = (p.bw + p.windows_per_block - 1) / p.windows_per_block;
  dim3 grid(p.n / qt, h, groups);
  window_attention_kernel<T, D>
      <<<grid, qt * kThreadsPerQ, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 tensor-core path (D a multiple of 16, N ≤ 512): the same block
// decomposition, with both products on mma.sync.m16n8k16 (bf16 in, fp32
// accumulate). Four warps own 16 query rows each. S = Q·Kᵀ comes out in the
// accumulator layout that is also the A-operand layout of P·V, so the
// probabilities go from registers to the second product without shared
// memory. K sits in shared memory row-major ([key][d], rows padded to D+8)
// and V transposed ([d][key], rows padded to 72), which makes every B
// fragment a pair of consecutive bf16 and every warp read conflict-free.

constexpr int kTcQueries = 64;  // 4 warps × 16 rows

using wft::ld32;
using wft::mma_bf16;
using wft::pack_bf16;

template <int D>
__global__ void __launch_bounds__(128) window_attention_tc_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kKS = D + 8;         // K row stride (bf16)
  constexpr int kVS = kKeyTile + 8;  // Vᵀ row stride (bf16)
  const int n = p.n;
  const int bstride = n + 8;
  float* bias_s = smem;
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(bias_s + kTcQueries * bstride);
  __nv_bfloat16* vt_s = k_s + kKeyTile * kKS;

  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kTcQueries;
  const int w0 = blockIdx.z * p.windows_per_block;
  const int w1 = min(w0 + p.windows_per_block, p.bw);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row group, column pair

  const float* bsrc = p.bias + ((size_t)head * n + q0) * n;
  for (int e = tid * 4; e < kTcQueries * n; e += blockDim.x * 4) {
    const int row = e / n, col = e % n;
    float4 b = *reinterpret_cast<const float4*>(bsrc + (size_t)row * n + col);
    b.x *= kLog2e; b.y *= kLog2e; b.z *= kLog2e; b.w *= kLog2e;
    *reinterpret_cast<float4*>(bias_s + row * bstride + col) = b;
  }
  const float* brow0 = bias_s + (warp * 16 + g) * bstride;
  const float* brow1 = brow0 + 8 * bstride;

  for (int w = w0; w < w1; ++w) {
    using bf16 = __nv_bfloat16;
    const bf16* qr0 = static_cast<const bf16*>(p.q) + w * p.q_sb + head * p.q_sh +
                      (long long)(q0 + warp * 16 + g) * p.q_sn;
    const bf16* qr1 = qr0 + 8 * p.q_sn;
    const bf16* kb = static_cast<const bf16*>(p.k) + w * p.k_sb + head * p.k_sh;
    const bf16* vb = static_cast<const bf16*>(p.v) + w * p.v_sb + head * p.v_sh;
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      qa[ks][0] = ld32(qr0 + ks * 16 + 2 * t);
      qa[ks][1] = ld32(qr1 + ks * 16 + 2 * t);
      qa[ks][2] = ld32(qr0 + ks * 16 + 2 * t + 8);
      qa[ks][3] = ld32(qr1 + ks * 16 + 2 * t + 8);
    }
    float o[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    for (int k0 = 0; k0 < n; k0 += kKeyTile) {
      __syncthreads();  // the previous tile (and the bias fill) is done
      for (int e = tid; e < kKeyTile * (D / 8); e += blockDim.x) {
        const int row = e / (D / 8), c = (e % (D / 8)) * 8;
        *reinterpret_cast<uint4*>(k_s + row * kKS + c) =
            *reinterpret_cast<const uint4*>(kb + (long long)(k0 + row) * p.k_sn + c);
        const uint4 vv =
            *reinterpret_cast<const uint4*>(vb + (long long)(k0 + row) * p.v_sn + c);
        const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
        for (int i = 0; i < 8; ++i) vt_s[(c + i) * kVS + row] = ve[i];
      }
      __syncthreads();

      float s[kKeyTile / 8][4];
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const bf16* kr = k_s + (j * 8 + g) * kKS + ks * 16 + 2 * t;
          mma_bf16(s[j], qa[ks], ld32(kr), ld32(kr + 8));
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) {
        const int col = k0 + j * 8 + 2 * t;
        const float2 b0 = *reinterpret_cast<const float2*>(brow0 + col);
        const float2 b1 = *reinterpret_cast<const float2*>(brow1 + col);
        s[j][0] = fmaf(s[j][0], p.qscale, b0.x);
        s[j][1] = fmaf(s[j][1], p.qscale, b0.y);
        s[j][2] = fmaf(s[j][2], p.qscale, b1.x);
        s[j][3] = fmaf(s[j][3], p.qscale, b1.y);
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      // the four threads of a quad share rows g and g + 8
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);  // 0 on the first tile
      m0 = mx0;
      m1 = mx1;
      l0 *= c0;
      l1 *= c1;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][0] *= c0; o[dn][1] *= c0; o[dn][2] *= c1; o[dn][3] *= c1;
      }
      uint32_t pa[kKeyTile / 16][4];
#pragma unroll
      for (int j = 0; j < kKeyTile / 8; ++j) {
        const float p00 = exp2f(s[j][0] - m0), p01 = exp2f(s[j][1] - m0);
        const float p10 = exp2f(s[j][2] - m1), p11 = exp2f(s[j][3] - m1);
        l0 += p00 + p01;
        l1 += p10 + p11;
        pa[j / 2][(j % 2) * 2] = pack_bf16(p00, p01);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p10, p11);
      }
#pragma unroll
      for (int u = 0; u < kKeyTile / 16; ++u) {
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const bf16* vr = vt_s + (dn * 8 + g) * kVS + u * 16 + 2 * t;
          mma_bf16(o[dn], pa[u], ld32(vr), ld32(vr + 8));
        }
      }
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    bf16* or0 = static_cast<bf16*>(p.o) + w * p.o_sb + head * p.o_sh +
                (long long)(q0 + warp * 16 + g) * p.o_sn;
    bf16* or1 = or0 + 8 * p.o_sn;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(or0 + dn * 8 + 2 * t) =
          pack_bf16(o[dn][0] * inv0, o[dn][1] * inv0);
      *reinterpret_cast<uint32_t*>(or1 + dn * 8 + 2 * t) =
          pack_bf16(o[dn][2] * inv1, o[dn][3] * inv1);
    }
  }
}

template <int D>
cudaError_t launch_tc(const Params& p, int h, cudaStream_t stream) {
  const size_t smem = (size_t)kTcQueries * (p.n + 8) * sizeof(float) +
                      (size_t)(kKeyTile * (D + 8) + D * (kKeyTile + 8)) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int groups = (p.bw + p.windows_per_block - 1) / p.windows_per_block;
  dim3 grid(p.n / kTcQueries, h, groups);
  window_attention_tc_kernel<D><<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int h, int d, cudaStream_t stream) {
  switch (d) {
    case 8: return launch<T, 8>(p, h, stream);
    case 16: return launch<T, 16>(p, h, stream);
    case 24: return launch<T, 24>(p, h, stream);
    case 32: return launch<T, 32>(p, h, stream);
    case 40: return launch<T, 40>(p, h, stream);
    case 48: return launch<T, 48>(p, h, stream);
    case 56: return launch<T, 56>(p, h, stream);
    case 64: return launch<T, 64>(p, h, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t (0 on success). Strides are in elements.
extern "C" int wft_window_attention(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    void* o, long long q_sb, long long q_sh, long long q_sn, long long k_sb,
    long long k_sh, long long k_sn, long long v_sb, long long v_sh,
    long long v_sn, long long o_sb, long long o_sh, long long o_sn, int bw,
    int h, int n, int d, float scale, int windows_per_block, void* stream) {
  if (n % 64 != 0 || n > 1024 || d % 8 != 0 || d < 8 || d > 64 ||
      windows_per_block < 1 || bw < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{q, k, v, static_cast<const float*>(bias), o,
           q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn,
           o_sb, o_sh, o_sn, bw, n, scale * kLog2e, windows_per_block};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == wft::kFloat32) {
    err = dispatch_d<float>(p, h, d, s);
  } else if (dtype == wft::kBFloat16 && n <= 512 && d % 16 == 0) {
    switch (d) {
      case 16: err = launch_tc<16>(p, h, s); break;
      case 32: err = launch_tc<32>(p, h, s); break;
      case 48: err = launch_tc<48>(p, h, s); break;
      default: err = launch_tc<64>(p, h, s); break;
    }
  } else if (dtype == wft::kBFloat16) {
    err = dispatch_d<__nv_bfloat16>(p, h, d, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
