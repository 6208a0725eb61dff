// CCF-FFN tail for Hopper: out = gelu(LN(dwconv3(h1) + b_dw)) @ W_fc + b_fc.
//
// Replaces the TPU kernel tools/exp_ffn_pallas.py (`ffn_tail`, `_kernel`
// :66-125). h1 (B, D, H, W, Ch) channels-last; depthwise taps (27, Ch), the
// bias, the LayerNorm scale and shift (Ch,) and the Dense bias (C,) fp32;
// the Dense weight transposed to (C, Ch) in the input dtype; out
// (B, D, H, W, C) in the input dtype. LayerNorm and GELU are fp32; the GELU
// output is rounded to the input dtype before the Dense, which accumulates
// in fp32, as the TPU kernel does (:114-121). GELU is the exact erf form
// (the port's `models/common.py::gelu`).
//
// Two designs, chosen from the dtype only (`wft_ffn_tail_design`):
//
// bf16, `split_wgmma`: two launches. The caller (ops/ffn_tail_cuda.py) runs
// the stencil and its bias on `dwconv3`'s TMA plane ring (csrc/dwconv3.cu),
// which rounds y = dwconv3(h1) + b_dw once from fp32 to bf16 and writes it
// out; this file's `ln_gelu_dense_kernel` then takes y as M = B·D·H·W rows of
// Ch and computes gelu(LN(y)) @ W_fc + b_fc row by row.
//   What bounds it: at (8, 64³, 192 → 48) it must read y (805 MB) and write
//   out (201 MB), 0.30 ms at 3.35 TB/s; LayerNorm and GELU are about 20
//   fp32 operations an element (4.0e8 elements, 0.12 ms at 67 TFLOP/s), the
//   Dense 3.9e10 operations on the tensor cores (0.04 ms). With the stencil's
//   0.48 ms of bytes, the two launches cannot beat 0.78 ms; the one-pass
//   bound of the whole tail is 0.45 ms.
//   Design: persistent blocks, two an SM where the N tile is at most 48
//   wide and the whole weight fits beside two stages of y in each (192 →
//   48), else one, each walking an equal share of 64-row blocks of y (one
//   wgmma M tile); two blocks let one's products and epilogue overlap the
//   other's LayerNorm. Where the row blocks are fewer than half the block
//   slots (8³ · 8 = 64 at 1536 → 384), ng blocks share a row block's N
//   tiles, each redoing its LayerNorm. 9 warps a block:
//   * a producer warp (one thread) TMA-loads a row block as ⌈Ch/64⌉ boxes of
//     64 rows × 64 channels, 128-byte swizzled (rows past M and channels
//     past Ch are zero-filled), and the weight as (BN rows × 64 channels)
//     boxes, K-major and 128-byte swizzled. Where the whole weight fits
//     beside two stages of y (Ch·C·2 = 18 KB at 192 → 48, 72 KB at 384 →
//     96) it is loaded once and y runs through a ring of up to 4 stages.
//     Else (768 → 192, 1536 → 384) y has one stage and the weight streams
//     from L2 through a ring of up to 8 chunks, in the order the consumers
//     multiply them; a row block's first ring of chunks is loaded before
//     its rows, while the block before it multiplies;
//   * two consumer warpgroups share each row block. Each takes 32 of its
//     rows for LayerNorm and GELU: four threads a row, a thread on every
//     fourth 16-byte chunk (eight threads of one phase read one chunk of
//     eight rows: no bank conflicts under the swizzle). Statistics are
//     Σx and Σx² in fp32 (E[x²] − μ², as the JAX `_ln_f32`), reduced by two
//     shuffles; then each element is normalised, put through GELU (erf as
//     a branch-free polynomial, `gelu_poly`), rounded to bf16 and written
//     back in place, so the tile becomes the A operand. A proxy fence and a
//     barrier of the 256 consumers precede the products;
//   * the Dense: the C columns are cut into N tiles of BN (the smallest of
//     8, 16, 24, 32, 48, 64, 96 that is ≥ C / 2; ⌈C / BN⌉ tiles, weight rows
//     past C zero-filled), the block's tiles taken in turn by its two
//     warpgroups: SS
//     wgmma.m64nBNk16 over the Ch / 16 K-steps, A and B descriptors moved 32
//     bytes a step inside a box. The epilogue adds the bias in fp32 and
//     stores bf16 pairs of the rows below M and the columns below C. A
//     stage is released when both warpgroups' products have completed; a
//     streamed chunk when its owner's products have, the other warpgroup
//     releasing it once it has landed (both walk the ring in order).
//   y must fit one stage beside two weight chunks: Ch ≤ 1600.
//   The GELU's erf differs from erff by ≤ 2e-7, far below the bf16 rounding
//   of its result.
//
// fp32, `fp32` (`ffn_tail_kernel`, one launch): the card's fp32 check. A
// block of 8 warps owns 16 consecutive voxels across all Ch channels: a
// thread computes the 27 taps (read from global memory, L1/L2) for 8
// channels of 2 voxels, plus the bias, into an fp32 tile in shared memory;
// each warp takes voxels for LayerNorm (two passes) and GELU in place; an FMA
// loop does the Dense.

#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

enum Design : int { kFp32 = 0, kSplitWgmma = 1 };

int design_of(int dtype, int ch, int c) {
  if (dtype == wft::kFloat32 && ch > 0 && ch % 8 == 0 && c > 0) return kFp32;
  if (dtype == wft::kBFloat16 && ch > 0 && ch % 16 == 0 && c > 0 && c % 8 == 0) {
    return kSplitWgmma;
  }
  return -1;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.f + erff(z * 0.7071067811865476f));
}

// The same GELU without branches, erf by Abramowitz & Stegun 7.1.26 (|error|
// ≤ 1.5e-7, the JAX `_gelu_f32`'s formula), one reciprocal and one exp2 on
// the special-function unit: with x = |z|/√2, t = 1/(1 + 0.3275911x) and
// h = z/2 · poly(t) · e^(−x²), gelu(z) = z − h for z ≥ 0 and h below. erff's
// branches keep a thread's eight elements from interleaving.
__device__ __forceinline__ float gelu_poly(float z) {
  const float x = fabsf(z) * 0.7071067811865476f;
  const float t = __fdividef(1.f, fmaf(0.3275911f, x, 1.f));
  float p = fmaf(t, 1.061405429f, -1.453152027f);
  p = fmaf(p, t, 1.421413741f);
  p = fmaf(p, t, -0.284496736f);
  p = fmaf(p, t, 0.254829592f);
  const float h = 0.5f * z * (p * t) * __expf(-x * x);
  return z >= 0.f ? z - h : h;
}

// ---------------------------------------------------------------------------
// bf16: ln_gelu_dense (see the header).

constexpr int kRows = 64;                    // rows per row block: one wgmma M tile
constexpr int kBox = 64;                     // channels per box: one 128-byte row
constexpr int kBoxBytes = kRows * kBox * 2;  // 8 KB
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kLgdThreads = kConsumers + 32; // and the producer warp
constexpr int kMaxStages = 4;                // y ring depth
constexpr int kMaxWSlots = 8;                // weight ring depth when streamed
constexpr int kMaxSmem = 232448;             // one block an SM
constexpr int kPairSmem = 115712;            // each of two blocks an SM
// the alignment slack and the barriers
constexpr int kSmemExtra = 1024 + 8 * 2 * (kMaxStages + kMaxWSlots);
// the widest N tile at which two blocks share an SM (the registers of 18
// warps: at most 5 on one scheduler, ≤ 96 a thread)
constexpr int kPairBN = 48;

struct LgdParams {
  const float* ln_s;
  const float* ln_b;
  const float* fc_b;
  __nv_bfloat16* out;
  long long M;
  int Ch, C;
  float eps;
  int kb;          // 64-channel boxes per row, ⌈Ch / 64⌉
  int nt;          // N tiles, ⌈C / BN⌉
  int ng;          // N groups: block (x, y) takes the tiles y, y + ng, …
  int stages;      // y ring depth
  int wslots;      // weight ring slots; 0: the weight is resident
  long long rblocks;  // ⌈M / 64⌉
};

// Byte offset of 16-byte chunk j (channels 8j … 8j + 7) of row r in a stage:
// box j / 8, the chunk index XORed with r mod 8 by the 128-byte swizzle.
__device__ __forceinline__ int chunk_off(int r, int j) {
  return (j >> 3) * kBoxBytes + r * 128 + (((j & 7) ^ (r & 7)) << 4);
}

template <int BN>
__global__ void __launch_bounds__(kLgdThreads, BN <= kPairBN ? 2 : 1)
    ln_gelu_dense_kernel(const __grid_constant__ CUtensorMap ymap,
                         const __grid_constant__ CUtensorMap wmap, LgdParams p) {
  constexpr int kChunk = BN * 128;  // one weight box: BN rows × 64 channels
  extern __shared__ uint8_t smem_raw[];
  // swizzled TMA boxes and wgmma atoms want 1024-byte aligned tiles
  uint8_t* smem = smem_raw + ((1024 - wft::smem_u32(smem_raw) % 1024) % 1024);
  const int stage_bytes = p.kb * kBoxBytes;
  const int ntl = (p.nt - (int)blockIdx.y + p.ng - 1) / p.ng;  // this block's N tiles
  const int nchunks = ntl * p.kb;  // its weight boxes a row block, tile-major
  uint8_t* ys = smem;
  uint8_t* ws = smem + p.stages * stage_bytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ws + (p.wslots ? p.wslots : p.nt * p.kb) * kChunk);
  uint64_t* empty = full + p.stages;
  uint64_t* wfull = empty + p.stages;  // [wslots], or [1] for the resident weight
  uint64_t* wempty = wfull + kMaxWSlots;
  const int tid = threadIdx.x;
  // this block's row blocks: blockIdx.x, + gridDim.x, …
  const long long nrb =
      p.rblocks > blockIdx.x ? (p.rblocks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      wft::mbar_init(full + i, 1);
      wft::mbar_init(empty + i, kConsumers);
    }
    for (int i = 0; i < kMaxWSlots; ++i) {
      wft::mbar_init(wfull + i, 1);
      wft::mbar_init(wempty + i, kConsumers);
    }
    wft::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one thread issues every copy
    if (tid == kConsumers) {
      auto load_y = [&](long long i) {
        const int slot = (int)(i % p.stages);
        if (i >= p.stages) {
          wft::mbar_wait_or_trap(empty + slot, (uint32_t)((i / p.stages - 1) & 1));
        }
        uint8_t* st = ys + slot * stage_bytes;
        wft::mbar_arrive_expect_tx(full + slot, (uint32_t)stage_bytes);
        const int r0 = (int)((blockIdx.x + i * gridDim.x) * kRows);
        for (int kb = 0; kb < p.kb; ++kb) {
          wft::tma_load_2d(st + kb * kBoxBytes, &ymap, full + slot, kb * kBox, r0);
        }
      };
      if (p.wslots == 0) {
        wft::mbar_arrive_expect_tx(wfull, (uint32_t)(p.nt * p.kb * kChunk));
        for (int c = 0; c < p.nt * p.kb; ++c) {  // all of it
          wft::tma_load_2d(ws + c * kChunk, &wmap, wfull, (c % p.kb) * kBox, (c / p.kb) * BN);
        }
        for (long long i = 0; i < nrb; ++i) load_y(i);
      } else {
        // row block i goes in after the first ring's worth of its weight
        // chunks (those slots free up while block i − 1 multiplies) and
        // before the rest
        const int ahead = min(p.wslots, nchunks);
        long long wc = 0;
        for (long long i = 0; i < nrb; ++i) {
          for (int c = 0; c < nchunks; ++c, ++wc) {
            if (c == ahead) load_y(i);
            const int slot = (int)(wc % p.wslots);
            if (wc >= p.wslots) {
              wft::mbar_wait_or_trap(wempty + slot, (uint32_t)((wc / p.wslots - 1) & 1));
            }
            wft::mbar_arrive_expect_tx(wfull + slot, kChunk);
            wft::tma_load_2d(ws + slot * kChunk, &wmap, wfull + slot, (c % p.kb) * kBox,
                             ((int)blockIdx.y + c / p.kb * p.ng) * BN);
          }
          if (ahead == nchunks) load_y(i);
        }
      }
    }
    return;
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // LayerNorm and GELU: row `er` of the block, 16-byte chunks cls, cls + 4, …
  const int er = 32 * wg + 8 * warp + (lane & 7);
  const int cls = lane >> 3;
  const int nvec = p.Ch / 8;
  const int ksteps = p.Ch / 16;
  const float inv_ch = 1.f / (float)p.Ch;
  const int g = lane / 4, t = lane % 4;
  if (p.wslots == 0) wft::mbar_wait_or_trap(wfull, 0);
  for (long long i = 0; i < nrb; ++i) {
    const int slot = (int)(i % p.stages);
    wft::mbar_wait_or_trap(full + slot, (uint32_t)((i / p.stages) & 1));
    uint8_t* st = ys + slot * stage_bytes;

    float s = 0.f, q = 0.f;
#pragma unroll 2
    for (int j = cls; j < nvec; j += 4) {
      const uint4 u = *reinterpret_cast<const uint4*>(st + chunk_off(er, j));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        s += f.x + f.y;
        q = fmaf(f.x, f.x, fmaf(f.y, f.y, q));
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    q += __shfl_xor_sync(0xffffffffu, q, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    q += __shfl_xor_sync(0xffffffffu, q, 16);
    const float mean = s * inv_ch;
    const float rstd = rsqrtf(fmaxf(q * inv_ch - mean * mean, 0.f) + p.eps);
    const float shift = -mean * rstd;
#pragma unroll 2
    for (int j = cls; j < nvec; j += 4) {
      uint4* ptr = reinterpret_cast<uint4*>(st + chunk_off(er, j));
      uint4 u = *ptr;
      uint32_t* w = reinterpret_cast<uint32_t*>(&u);
      const float4 sa = __ldg(reinterpret_cast<const float4*>(p.ln_s + 8 * j));
      const float4 sb = __ldg(reinterpret_cast<const float4*>(p.ln_s + 8 * j + 4));
      const float4 ba = __ldg(reinterpret_cast<const float4*>(p.ln_b + 8 * j));
      const float4 bb = __ldg(reinterpret_cast<const float4*>(p.ln_b + 8 * j + 4));
      const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
      const float bi[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[e]));
        const float z0 = fmaf(fmaf(f.x, rstd, shift), sc[2 * e], bi[2 * e]);
        const float z1 = fmaf(fmaf(f.y, rstd, shift), sc[2 * e + 1], bi[2 * e + 1]);
        w[e] = wft::pack_bf16(gelu_poly(z0), gelu_poly(z1));
      }
      *ptr = u;
    }
    wft::fence_proxy_async();  // the writes, before wgmma reads them
    wft::named_bar_sync(1, kConsumers);

    // the Dense: this warpgroup's N tiles. A streamed weight passes every
    // chunk through the ring in order, and both warpgroups wait on each one
    // (a parity wait must not run two phases ahead of its slot); the other
    // warpgroup's chunks are released as soon as they have landed.
    const uint32_t a_addr = wft::smem_u32(st);
    const long long row0 = (blockIdx.x + i * gridDim.x) * kRows + warp * 16 + g;
    long long wc = i * nchunks;  // streamed: the chunk number
    for (int li = 0; li < ntl; ++li) {
      const int nt = (int)blockIdx.y + li * p.ng;
      if (li % 2 != wg) {
        for (int kb = 0; p.wslots && kb < p.kb; ++kb, ++wc) {
          const int ws_slot = (int)(wc % p.wslots);
          wft::mbar_wait_or_trap(wfull + ws_slot, (uint32_t)((wc / p.wslots) & 1));
          wft::mbar_arrive(wempty + ws_slot);
        }
        continue;
      }
      float acc[BN / 2];
#pragma unroll
      for (int r = 0; r < BN / 2; ++r) acc[r] = 0.f;
      for (int kb = 0; kb < p.kb; ++kb, ++wc) {
        uint32_t b_addr;
        if (p.wslots) {
          const int ws_slot = (int)(wc % p.wslots);
          wft::mbar_wait_or_trap(wfull + ws_slot, (uint32_t)((wc / p.wslots) & 1));
          b_addr = wft::smem_u32(ws + ws_slot * kChunk);
        } else {
          b_addr = wft::smem_u32(ws + (nt * p.kb + kb) * kChunk);
        }
        const int kn = min(4, ksteps - 4 * kb);
        wft::wgmma_fence();
        wft::fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < kn) {
            // both K-major: k16 = 32 bytes into the 128-byte row, 8-row groups 1 KB apart
            const uint64_t da =
                wft::wgmma_desc(a_addr + kb * kBoxBytes + kk * 32, 16, 1024, wft::kSwizzle128);
            const uint64_t db = wft::wgmma_desc(b_addr + kk * 32, 16, 1024, wft::kSwizzle128);
            wft::Wgmma<BN>::template run<0, 0>(acc, da, db, 1);
          }
        }
        wft::wgmma_commit();
        wft::fence_regs(acc);
        if (p.wslots) {
          wft::wgmma_wait<1>();  // the previous chunk's products are done: release it
          if (kb > 0) wft::mbar_arrive(wempty + (int)((wc - 1) % p.wslots));
        }
      }
      wft::wgmma_wait<0>();
      wft::fence_regs(acc);
      if (p.wslots) wft::mbar_arrive(wempty + (int)((wc - 1) % p.wslots));
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = nt * BN + 8 * j + 2 * t;
        if (col < p.C) {
          const float b0 = __ldg(p.fc_b + col), b1 = __ldg(p.fc_b + col + 1);
          if (row0 < p.M) {
            *reinterpret_cast<uint32_t*>(p.out + row0 * p.C + col) =
                wft::pack_bf16(acc[4 * j] + b0, acc[4 * j + 1] + b1);
          }
          if (row0 + 8 < p.M) {
            *reinterpret_cast<uint32_t*>(p.out + (row0 + 8) * p.C + col) =
                wft::pack_bf16(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
          }
        }
      }
    }
    wft::mbar_arrive(empty + slot);  // after this thread's products (if any) completed
  }
}

// N tile width: the smallest of 8, 16, 24, 32, 48, 64, 96 that is ≥ C / 2
// (two tiles, one a warpgroup, where C ≤ 192); 96 above.
int tile_n(int c) {
  static const int kWidths[] = {8, 16, 24, 32, 48, 64};
  const int half = (c / 2 + 7) / 8 * 8;
  for (int bn : kWidths) {
    if (half <= bn) return bn;
  }
  return 96;
}

template <int BN>
cudaError_t launch_lgd(const void* y, const float* ln_s, const float* ln_b, const void* fc_w,
                       const float* fc_b, void* out, long long M, int Ch, int C, float eps,
                       cudaStream_t stream) {
  LgdParams p{ln_s, ln_b, fc_b, static_cast<__nv_bfloat16*>(out), M, Ch, C, eps};
  p.kb = (Ch + kBox - 1) / kBox;
  p.nt = (C + BN - 1) / BN;
  p.rblocks = (M + kRows - 1) / kRows;
  const long long stage = (long long)p.kb * kBoxBytes, chunk = (long long)BN * 128;
  const long long resident = (long long)p.nt * p.kb * chunk;
  const long long pair = kPairSmem - kSmemExtra, one = kMaxSmem - kSmemExtra;
  if (BN <= kPairBN && resident + 2 * stage <= pair) {  // two blocks an SM
    p.wslots = 0;
    p.stages = (int)std::min<long long>(kMaxStages, (pair - resident) / stage);
  } else if (resident + 2 * stage <= one) {
    p.wslots = 0;
    p.stages = (int)std::min<long long>(kMaxStages, (one - resident) / stage);
  } else {  // one stage of y, the rest for the weight's ring
    p.stages = 1;
    p.wslots = (int)std::min<long long>(kMaxWSlots, (one - stage) / chunk);
    if (p.wslots < 2) return cudaErrorInvalidValue;  // Ch too wide for one stage
  }
  const size_t smem = (size_t)p.stages * stage +
                      (size_t)(p.wslots ? p.wslots : p.nt * p.kb) * chunk + kSmemExtra;
  CUtensorMap ymap, wmap;
  const uint64_t ydims[2] = {(uint64_t)Ch, (uint64_t)M}, ystr[1] = {(uint64_t)Ch * 2};
  const uint32_t ybox[2] = {kBox, kRows};
  cudaError_t err =
      wft::make_map_bf16(&ymap, y, 2, ydims, ystr, ybox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const uint64_t wdims[2] = {(uint64_t)Ch, (uint64_t)C};
  const uint32_t wbox[2] = {kBox, BN};
  err = wft::make_map_bf16(&wmap, fc_w, 2, wdims, ystr, wbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ln_gelu_dense_kernel<BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(ln_gelu_dense_kernel<BN>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ln_gelu_dense_kernel<BN>,
                                                      kLgdThreads, smem);
  if (err != cudaSuccess) return err;
  const long long slots = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  // where the row blocks leave slots idle, ng blocks share each row block's
  // N tiles (each redoes its LayerNorm; a streamed weight shrinks ng-fold)
  p.ng = (int)std::max<long long>(1, std::min<long long>(p.nt, slots / p.rblocks));
  const long long gx = std::min(p.rblocks, slots / p.ng);
  ln_gelu_dense_kernel<BN>
      <<<dim3((unsigned)gx, (unsigned)p.ng), kLgdThreads, smem, stream>>>(ymap, wmap, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: one fused kernel (see the header).

constexpr int kTV = 16;        // voxels per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kPair = 2;       // voxels per stencil thread

struct Params {
  const float* h1;
  const float* dw_w;
  const float* dw_b;
  const float* ln_s;
  const float* ln_b;
  const float* fc_w;  // (C, Ch)
  const float* fc_b;
  float* out;
  int B, D, H, W, Ch, C;
  float eps;
};

__global__ void __launch_bounds__(kThreads) ffn_tail_kernel(Params p) {
  extern __shared__ __align__(16) float tile[];  // [kTV][Ch + 4]
  const int fs = p.Ch + 4;
  const long long nvox = (long long)p.B * p.D * p.H * p.W;
  const long long v0 = (long long)blockIdx.x * kTV;
  const int nvalid = (int)min((long long)kTV, nvox - v0);
  const int nvec = p.Ch / 8;

  // the stencil plus its bias, into the tile
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
        wft::load8(p.h1 + ((((long long)vb[q] * p.D + dd) * p.H + hh) * p.W + ww) * p.Ch + c0,
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

  // LayerNorm (two passes) and GELU of the tile's rows in place, a warp a voxel
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
      row[c] = gelu_erf((row[c] - mean) * rstd * p.ln_s[c] + p.ln_b[c]);
    }
  }
  __syncthreads();

  // the Dense, an FMA loop over the tile
  float* out = p.out + v0 * p.C;
  for (int e = threadIdx.x; e < kTV * p.C; e += kThreads) {
    const int lv = e / p.C, n = e % p.C;
    if (lv >= nvalid) continue;
    const float* row = tile + lv * fs;
    const float* wr = p.fc_w + (long long)n * p.Ch;
    float s = 0.f;
    for (int k = 0; k < p.Ch; ++k) s = fmaf(row[k], wr[k], s);
    out[(long long)lv * p.C + n] = s + p.fc_b[n];
  }
}

cudaError_t launch_fp32(const Params& p, cudaStream_t stream) {
  const size_t smem = (size_t)kTV * (p.Ch + 4) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long nvox = (long long)p.B * p.D * p.H * p.W;
  const long long blocks = (nvox + kTV - 1) / kTV;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ffn_tail_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The design for these arguments: 0 = fp32 (`wft_ffn_tail`), 1 = split_wgmma
// (dwconv3, then `wft_ln_gelu_dense`); −1 where neither takes them.
extern "C" int wft_ffn_tail_design(int dtype, int ch, int c) { return design_of(dtype, ch, c); }

// The fp32 tail in one launch. Returns a cudaError_t (0 on success). Ch must
// be a multiple of 8; h1, dw_w and dw_b 16-byte aligned.
extern "C" int wft_ffn_tail(int dtype, const void* h1, const void* dw_w, const void* dw_b,
                            const void* ln_s, const void* ln_b, const void* fc_w,
                            const void* fc_b, void* out, int B, int D, int H, int W, int Ch,
                            int C, float eps, void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || design_of(dtype, Ch, C) != kFp32) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{static_cast<const float*>(h1), static_cast<const float*>(dw_w),
           static_cast<const float*>(dw_b), static_cast<const float*>(ln_s),
           static_cast<const float*>(ln_b), static_cast<const float*>(fc_w),
           static_cast<const float*>(fc_b), static_cast<float*>(out), B, D, H, W, Ch, C, eps};
  return (int)launch_fp32(p, static_cast<cudaStream_t>(stream));
}

// out (M, C) = gelu(LN(y)) @ fc_w + fc_b, bf16, for y (M, Ch) and fc_w
// given as (C, Ch); ln_s, ln_b (Ch,) and fc_b (C,) fp32, 16-byte aligned.
// Returns a cudaError_t (0 on success); Ch must be a multiple of 16 and at
// most 1600, C a multiple of 8.
extern "C" int wft_ln_gelu_dense(const void* y, const void* ln_s, const void* ln_b,
                                 const void* fc_w, const void* fc_b, void* out, long long M,
                                 int Ch, int C, float eps, void* stream) {
  if (M < 1 || M > 0x7fffffffLL - kRows || design_of(wft::kBFloat16, Ch, C) != kSplitWgmma) {
    return (int)cudaErrorInvalidValue;
  }
  const float* s = static_cast<const float*>(ln_s);
  const float* b = static_cast<const float*>(ln_b);
  const float* fb = static_cast<const float*>(fc_b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile_n(C)) {
    case 8: return (int)launch_lgd<8>(y, s, b, fc_w, fb, out, M, Ch, C, eps, st);
    case 16: return (int)launch_lgd<16>(y, s, b, fc_w, fb, out, M, Ch, C, eps, st);
    case 24: return (int)launch_lgd<24>(y, s, b, fc_w, fb, out, M, Ch, C, eps, st);
    case 32: return (int)launch_lgd<32>(y, s, b, fc_w, fb, out, M, Ch, C, eps, st);
    case 48: return (int)launch_lgd<48>(y, s, b, fc_w, fb, out, M, Ch, C, eps, st);
    case 64: return (int)launch_lgd<64>(y, s, b, fc_w, fb, out, M, Ch, C, eps, st);
    default: return (int)launch_lgd<96>(y, s, b, fc_w, fb, out, M, Ch, C, eps, st);
  }
}
