// Tiled matrix products for Hopper: bf16 → fp32 and int8 → int32 on mma.sync.
//
// Replaces the TPU kernel tools/exp_int8_mxu.py (`make`, `mm_kernel`
// :26-45), the probe that asks whether int8 products run faster than bf16
// ones. For x (M, K) and w (K, N) row-major and s (8,) fp32 on the device
// (s[0] is read by the kernel, so a caller that changes it from call to call
// needs no host sync):
//   * bf16 → fp32: out = (x ⊕ bf16(s[0])) @ w, ⊕ an add rounded to bf16 per
//     element before the product (:34-35), or, with perturb_out,
//     out = x @ w + s[0] (:30-32);
//   * int8 → int32: with perturb_out, out = x @ w + int32(s[0]), the cast
//     truncating toward zero (:30-32); without, (x ⊕ int8(s[0])) @ w, ⊕
//     wrapping in two's complement.
//
// What bounds it: the output (fp32 or int32) is the largest stream at the
// probe's shapes. (32768, 1024, 512): bf16 135.3 MB → 40.4 µs at 3.35 TB/s
// (its 34.4 GFLOP take 34.7 µs at 989 TFLOP/s); int8 101.2 MB → 30.2 µs.
// (16384, 2048, 512): bf16 34.4 GFLOP → 34.7 µs (operations); int8 68.2 MB
// → 20.3 µs (bytes).
//
// Design (simple first: mma.sync and cp.async, no wgmma or TMA yet). A block
// of 8 warps owns a 128 × 128 output tile; the warps are 2 (M) × 4 (N), each
// 64 × 32. K is walked in 128-byte chunks (64 bf16 or 128 int8) through a
// 3-stage cp.async ring in shared memory (105 KB: two blocks per SM, as the
// 128 registers a thread may have allow). On an H100 this beat 64-byte
// chunks in 4 or 3 stages by 12% (bf16) and 9% (int8) at the probe's shapes:
// fewer barriers per mma. The TPU kernel kept all of w in VMEM (:42); at
// 1-2 MB it does not fit 227 KB of shared memory, so w is tiled too and
// stays in the 50 MB L2, read by every row of blocks.
//   * A fragments come from the x tile by ldmatrix (144-byte rows: no bank
//     conflicts). Their bytes are the same for both types: a register holds
//     two bf16 or four int8 of one row.
//   * bf16 B fragments come from the (k, n) w tile by ldmatrix.trans.
//   * int8: mma wants B K-contiguous per output column, and ldmatrix.trans
//     moves 16-bit elements only, so a register it delivers holds bytes of
//     two k rows × two columns. Two such registers, from matrices whose rows
//     are the k ≡ 0,1 and the k ≡ 2,3 (mod 4) rows of 16, give after two
//     byte permutes four consecutive k of column 2g and of column 2g + 1.
//     One mma takes the even columns of a 16-column group and another the
//     odd ones, so a thread ends with four consecutive output columns. No
//     transposed copy of w is made. Rows k and k + 8 of one such matrix would
//     share banks, so the w tile's 16-byte chunks are XOR-swizzled by
//     ((k >> 1) & 6) | (k & 1).
//   * The input perturbation is applied in shared memory, once per element
//     and stage, by the thread that copied the element.
//   * The epilogue adds the output perturbation and stores 16-byte vectors
//     (bf16: one shuffle joins a thread's two columns with its neighbour's).
//   * The bf16 fragments accumulate over all of K in the tensor cores, whose
//     fp32 sums are not rounded to nearest: at most about 2^-22 of
//     Σ|x||w| per K-step of 16.

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBM = 128;              // output rows per block
constexpr int kBN = 128;              // output columns per block
constexpr int kThreads = 256;         // 8 warps, 2 (M) × 4 (N), 64 × 32 each
constexpr int kStages = 3;            // cp.async ring depth
constexpr int kKB = 128;              // bytes of K per stage
constexpr int kAS = kKB + 16;         // x tile row stride in bytes
constexpr int kABytes = kBM * kAS;
constexpr int kBS16 = (kBN + 8) * 2;  // bf16 w tile row stride in bytes
constexpr int kBBytes = (kKB / 2) * kBS16;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr size_t kSmem = (size_t)kStages * kStageBytes;
static_assert(kBBytes >= kKB * kBN, "the int8 w tile fits the bf16 one's room");

struct Params {
  const float* s;
  const uint8_t* x;
  const uint8_t* w;
  void* out;
  int M, K, N;
  int perturb_out;
};

// Chunk swizzle of the int8 w tile's row k: the eight rows that one ldmatrix
// matrix reads (k ≡ 0,1 or 2,3 mod 4, within 16) land in eight bank groups.
__device__ __forceinline__ int swz(int k) { return ((k >> 1) & 6) | (k & 1); }

template <bool kInt8, bool kW16>
__global__ void __launch_bounds__(kThreads, 2) tiled_matmul_kernel(Params p) {
  using Acc = typename std::conditional<kInt8, int, float>::type;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  constexpr int kES = kInt8 ? 1 : 2;  // bytes per element
  const int kbytes = p.K * kES;       // bytes of an x row
  const long long wrow = (long long)p.N * kES;
  const int ktiles = (kbytes + kKB - 1) / kKB;
  const float s0 = p.s[0];
  const bool perturb_in = !p.perturb_out;

  auto load = [&](int slot, int kt) {
    uint8_t* as = smem + slot * kStageBytes;
    uint8_t* bs = as + kABytes;
    const int kb0 = kt * kKB;
#pragma unroll
    for (int i = 0; i < kBM * kKB / 16 / kThreads; ++i) {  // x: 16-byte chunks
      const int e = tid + i * kThreads, row = e / (kKB / 16), cb = e % (kKB / 16);
      const bool ok = m0 + row < p.M && kb0 + cb * 16 < kbytes;
      const uint8_t* src = ok ? p.x + (long long)(m0 + row) * kbytes + kb0 + cb * 16 : p.x;
      wft::cp_async<16, false>(as + row * kAS + cb * 16, src, ok);
    }
    if constexpr (!kInt8) {
#pragma unroll
      for (int i = 0; i < kKB / 2 * kBN * 2 / 16 / kThreads; ++i) {  // w: chunks of 8 bf16
        const int e = tid + i * kThreads, row = e / (kBN / 8), cb = e % (kBN / 8);
        const int k = kt * (kKB / 2) + row, n = n0 + cb * 8;
        const bool ok = k < p.K && n < p.N;
        const uint8_t* src = ok ? p.w + k * wrow + n * 2 : p.w;
        wft::cp_async<16, false>(bs + row * kBS16 + cb * 16, src, ok);
      }
    } else if constexpr (kW16) {
#pragma unroll
      for (int i = 0; i < kKB * kBN / 16 / kThreads; ++i) {  // w: chunks of 16 int8
        const int e = tid + i * kThreads, row = e / (kBN / 16), cb = e % (kBN / 16);
        const int k = kb0 + row, n = n0 + cb * 16;
        const bool ok = k < p.K && n < p.N;
        const uint8_t* src = ok ? p.w + k * wrow + n : p.w;
        wft::cp_async<16, false>(bs + row * kBN + (cb ^ swz(row)) * 16, src, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kKB * kBN / 8 / kThreads; ++i) {  // N % 16 == 8: 8-byte copies
        const int e = tid + i * kThreads, row = e / (kBN / 8), h = e % (kBN / 8);
        const int k = kb0 + row, n = n0 + h * 8;
        const bool ok = k < p.K && n < p.N;
        const uint8_t* src = ok ? p.w + k * wrow + n : p.w;
        wft::cp_async<8>(bs + row * kBN + ((h / 2) ^ swz(row)) * 16 + (h % 2) * 8, src, ok);
      }
    }
  };

  // x ⊕ s on the x chunks this thread copied into `slot`
  auto perturb_x = [&](int slot) {
    uint8_t* as = smem + slot * kStageBytes;
#pragma unroll
    for (int i = 0; i < kBM * kKB / 16 / kThreads; ++i) {
      const int e = tid + i * kThreads;
      uint4* q = reinterpret_cast<uint4*>(as + (e / (kKB / 16)) * kAS + (e % (kKB / 16)) * 16);
      uint4 v = *q;
      uint32_t* u = reinterpret_cast<uint32_t*>(&v);
      if constexpr (kInt8) {
        const uint32_t sb = (uint32_t)(uint8_t)(int8_t)__float2int_rz(s0) * 0x01010101u;
#pragma unroll
        for (int j = 0; j < 4; ++j) u[j] = __vadd4(u[j], sb);  // per byte, wrapping
      } else {
        const float sb = __bfloat162float(__float2bfloat16_rn(s0));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u[j]));
          u[j] = wft::pack_bf16(f.x + sb, f.y + sb);
        }
      }
      *q = v;
    }
  };

  // [m-tile][n-tile][fragment]; int8 n-tile 2·c + e holds the even (e = 0)
  // or odd (e = 1) columns of the warp's 16-column group c
  Acc acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ktiles) load(st, st);
    wft::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    wft::cp_async_wait<kStages - 2>();  // this thread's copies of stage kt landed
    if (perturb_in) perturb_x(kt % kStages);
    __syncthreads();  // everyone's copies landed; stage kt - 1 is free
    if (kt + kStages - 1 < ktiles) load((kt + kStages - 1) % kStages, kt + kStages - 1);
    wft::cp_async_commit();
    const uint8_t* as = smem + (kt % kStages) * kStageBytes;
    const uint8_t* bs = as + kABytes;
#pragma unroll
    for (int kk = 0; kk < kKB / 32; ++kk) {  // mma K-steps of 32 bytes
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        wft::ldmatrix_x4(af[mi], as + (wm + mi * 16 + lane % 16) * kAS + kk * 32 + (lane / 16) * 16);
      }
      uint32_t bf[4][2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        uint32_t r[4];
        if constexpr (!kInt8) {
          // matrices: k 0-7 and 8-15 of columns 0-7, then of columns 8-15
          const int k = kk * 16 + lane % 8 + ((lane / 8) % 2) * 8;
          wft::ldmatrix_x4_trans(r, bs + k * kBS16 + (wn + c * 16 + (lane / 16) * 8) * 2);
          bf[2 * c][0] = r[0];
          bf[2 * c][1] = r[1];
          bf[2 * c + 1][0] = r[2];
          bf[2 * c + 1][1] = r[3];
        } else {
          // matrix j, row i holds k = 16·(j / 2) + 4·(i / 2) + 2·(j % 2) + i % 2
          // of the group's 16 columns; lane (g, t) gets k 4t, 4t + 1 (matrix 0)
          // and 4t + 2, 4t + 3 (matrix 1) of columns 2g and 2g + 1
          const int j = lane / 8, i = lane % 8;
          const int k = kk * 32 + (j / 2) * 16 + (i / 2) * 4 + (j % 2) * 2 + i % 2;
          wft::ldmatrix_x4_trans(r, bs + k * kBN + (((wn + c * 16) / 16) ^ swz(k)) * 16);
          bf[2 * c][0] = __byte_perm(r[0], r[1], 0x6420);      // column 2g, k 4t…4t+3
          bf[2 * c + 1][0] = __byte_perm(r[0], r[1], 0x7531);  // column 2g + 1
          bf[2 * c][1] = __byte_perm(r[2], r[3], 0x6420);      // k 16+4t…16+4t+3
          bf[2 * c + 1][1] = __byte_perm(r[2], r[3], 0x7531);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if constexpr (kInt8) {
            wft::mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
          } else {
            wft::mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
          }
        }
    }
  }

  if constexpr (kInt8) {
    int* out = static_cast<int*>(p.out);
    const int po = p.perturb_out ? __float2int_rz(s0) : 0;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int* ev = acc[mi][2 * c];
        const int* od = acc[mi][2 * c + 1];
        const int col = n0 + wn + c * 16 + 4 * t;
        const int row = m0 + wm + mi * 16 + g;
        if (col >= p.N) continue;
        if (row < p.M) {
          *reinterpret_cast<int4*>(out + (long long)row * p.N + col) =
              make_int4(ev[0] + po, od[0] + po, ev[1] + po, od[1] + po);
        }
        if (row + 8 < p.M) {
          *reinterpret_cast<int4*>(out + (long long)(row + 8) * p.N + col) =
              make_int4(ev[2] + po, od[2] + po, ev[3] + po, od[3] + po);
        }
      }
  } else {
    float* out = static_cast<float*>(p.out);
    const bool odd = t & 1;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        // even t: row g, columns 2t…2t+3; odd t: row g + 8, columns 2t−2…2t+1
        float* a = acc[mi][ni];
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
        float4 v = odd ? make_float4(r0, r1, a[2], a[3]) : make_float4(a[0], a[1], r0, r1);
        if (p.perturb_out) {
          v.x += s0;
          v.y += s0;
          v.z += s0;
          v.w += s0;
        }
        const int row = m0 + wm + mi * 16 + g + (odd ? 8 : 0);
        const int col = n0 + wn + ni * 8 + 2 * (t & ~1);
        if (row < p.M && col < p.N) {
          *reinterpret_cast<float4*>(out + (long long)row * p.N + col) = v;
        }
      }
  }
}

template <bool kInt8, bool kW16>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kernel = tiled_matmul_kernel<kInt8, kW16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). int8 = 0: x, w bf16 and out fp32;
// int8 = 1: x, w int8 and out int32. x rows must be whole 16-byte vectors
// (K % 8 == 0 for bf16, K % 16 == 0 for int8), N % 8 == 0, and x, w and out
// 16-byte aligned.
extern "C" int wft_tiled_matmul(int int8, const void* s, const void* x, const void* w, void* out,
                                int M, int K, int N, int perturb_out, void* stream) {
  const int es = int8 ? 1 : 2;
  if (M < 1 || K < 1 || N < 1 || (K * es) % 16 != 0 || N % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{static_cast<const float*>(s), static_cast<const uint8_t*>(x),
                 static_cast<const uint8_t*>(w), out, M, K, N, perturb_out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!int8) return (int)launch<false, true>(p, st);
  return (int)(N % 16 == 0 ? launch<true, true>(p, st) : launch<true, false>(p, st));
}
