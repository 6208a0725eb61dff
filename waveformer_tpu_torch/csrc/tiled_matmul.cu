// Tiled matrix products for Hopper, both on TMA + wgmma: bf16 → fp32 and
// int8 → int32.
//
// Replaces the TPU kernel tools/exp_int8_mxu.py::make (`make` :25-45,
// `mm_kernel` :26, `pallas_call` :37), the probe that asks whether int8
// products run faster than bf16 ones. For x (M, K) and w (K, N) row-major
// and s (8,) fp32 on the device (s[0] is read by the kernel, so a caller that
// changes it from call to call needs no host sync):
//   * bf16 → fp32: out = (x ⊕ bf16(s[0])) @ w, ⊕ an add rounded to bf16 per
//     element before the product (:34-35), or, with perturb_out,
//     out = x @ w + s[0] (:30-32);
//   * int8 → int32: with perturb_out, out = x @ w + int32(s[0]), the cast
//     truncating toward zero (:30-32); without, (x ⊕ int8(s[0])) @ w, ⊕
//     wrapping in two's complement.
//
// What bounds it: the output (fp32 or int32) is the largest stream at the
// probe's shapes. (32768, 1024, 512): bf16 135.3 MB → 40.4 µs at 3.35 TB/s
// (its 34.4 GFLOP take 34.7 µs at 989 TFLOP/s); int8 101.2 MB → 30.2 µs
// (its 34.4 GOP take 17.4 µs at 1,979 TOP/s). (16384, 2048, 512): bf16
// 34.4 GFLOP → 34.7 µs (operations); int8 68.2 MB → 20.3 µs (bytes).
//
// bf16 (`tiled_matmul_wgmma_kernel`): one persistent block per SM walks
// over 128 × 256 output tiles (tile t: row tile t / ⌈N/256⌉, so the blocks
// running at once share x's rows in L2). Two consumer warpgroups each
// multiply 64 rows of a tile with wgmma.m64n256k16, and one producer warp
// keeps a ring of 4 stages of 64 K-values (48 KB each) in flight with TMA:
// the x box (128 rows × 128 bytes, K-major) and four w boxes (64 K-rows × 64
// columns each, MN-major, read with wgmma's transpose bit), all 128-byte
// swizzled and zero-filled past M, K and N. A full and an empty mbarrier
// per stage replace the block barriers; the stage counter runs on across a
// block's tiles, so the producer fills the next tile's stages while the
// consumers store the last one. A warpgroup keeps one batch of products in
// flight while it waits for the next stage, and releases a stage when its
// products are done. The input perturbation is applied by each warpgroup to
// its own 64 rows of the x stage in shared memory (elementwise, so the
// swizzle does not matter), then fence.proxy.async and a barrier of that
// warpgroup only; the zero-filled x past K gains s too, which meets w's
// zero-filled rows. The accumulators (128 a thread) hold all of K in the
// tensor cores, whose fp32 sums are not rounded to nearest: at most about
// 2^-22 of Σ|x||w| per K-step of 16. The epilogue adds the output
// perturbation and stores 16-byte vectors (one shuffle joins a thread's two
// columns with its neighbour's).
//
// int8 (`tiled_matmul_s8_kernel`, design `tma_wgmma_s8`). wgmma has no
// transpose for 8-bit operands: A and B must both be K-major in shared
// memory. x is; w (K, N) is not, so each call first launches
// `w_kmajor_kernel`, which writes wᵀ (N, K) into a scratch the wrapper
// allocates (K·N bytes each way: 0.5 MB at the headline, 1 MB at (16384,
// 2048, 512); 0.3-0.6 µs of bytes and a launch). The product kernel then follows the bf16 design:
// one persistent block per SM walks over 128 × 256 output tiles in the same
// order; one producer warp keeps a 4-stage TMA ring full (the x box, 128
// rows × 128 bytes of K, and the wᵀ box, 256 rows × 128 bytes, both
// 128-byte swizzled and zero-filled past M, N and K: 48 KB a stage); two
// consumer warpgroups each multiply 64 rows with
// wgmma.m64n256k32.s32.s8.s8, exact int32 sums, both descriptors moving 32
// bytes along the swizzled rows per k32 step. The input perturbation is a
// per-byte __vadd4 on the warpgroup's 64 rows of the x stage, then
// fence.proxy.async and a barrier of that warpgroup only; x's zero fill
// past K gains s too and meets wᵀ's zero fill, so it adds nothing.
//   The output stream sets the bound (int32: two thirds of the headline's
// bytes), so it leaves through TMA stores: a warpgroup writes its 64 × 256
// accumulators, plus the output perturbation, in slices of 32 columns into
// two 8 KB 128-byte-swizzled staging buffers (8-byte writes, no bank
// conflicts), and one thread stores each slice with
// cp.async.bulk.tensor in a bulk group, which clips rows past M and
// columns past N. A buffer is written again once its store has read it
// (cp.async.bulk.wait_group.read); the stores drain while the warpgroup
// starts the next tile's products, whose stages the producer has already
// loaded. Shared memory: 4 × 48 KB stages + 32 KB staging = 224 KB.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

struct Params {
  const float* s;
  const uint8_t* x;
  const uint8_t* w;
  void* out;
  int M, K, N;
  int perturb_out;
};

// ---------------------------------------------------------------------------
// bf16 → fp32: TMA + wgmma (see the header).

constexpr int kWgBM = 128;                    // output rows per block: 2 warpgroups × 64
constexpr int kWgBN = 256;                    // output columns per block
constexpr int kWgBK = 64;                     // K-values per stage: one 128-byte swizzle row
constexpr int kWgStages = 4;                  // ring depth
constexpr int kWgThreads = 2 * 128 + 32;      // two consumer warpgroups, one producer warp
constexpr int kWgABytes = kWgBM * kWgBK * 2;  // x box: 128 rows × 128 bytes
constexpr int kWgBBox = kWgBK * 64 * 2;       // one w box: 64 K-rows × 64 columns
constexpr int kWgStageBytes = kWgABytes + (kWgBN / 64) * kWgBBox;
constexpr size_t kWgSmem = (size_t)kWgStages * kWgStageBytes + 2 * kWgStages * 8 + 1024;

__global__ void __launch_bounds__(kWgThreads)
    tiled_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                              const __grid_constant__ CUtensorMap wmap, Params p) {
  extern __shared__ uint8_t smem_raw[];
  // swizzled TMA boxes and wgmma atoms want 1024-byte aligned stages
  uint8_t* smem = smem_raw + ((1024 - wft::smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWgStages * kWgStageBytes);
  uint64_t* empty = full + kWgStages;
  const int tid = threadIdx.x, wg = tid / 128;
  const int ntiles = (p.N + kWgBN - 1) / kWgBN;
  const int tiles = (p.M + kWgBM - 1) / kWgBM * ntiles;
  const int ktiles = (p.K + kWgBK - 1) / kWgBK;
  if (tid == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      wft::mbar_init(full + i, 1);
      wft::mbar_init(empty + i, 2 * 128);
    }
    wft::mbar_init_fence();
  }
  __syncthreads();

  // tile t: rows (t / ntiles)·128 …, columns (t % ntiles)·256 …; the stage
  // counter `it` runs on across this block's tiles
  if (wg == 2) {  // the producer warp: one thread issues every copy
    if (tid == 2 * 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / ntiles * kWgBM, n0 = tile % ntiles * kWgBN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int slot = it % kWgStages;
          if (it >= kWgStages) wft::mbar_wait(empty + slot, (it / kWgStages - 1) & 1);
          uint8_t* st = smem + slot * kWgStageBytes;
          wft::mbar_arrive_expect_tx(full + slot, kWgStageBytes);
          wft::tma_load_2d(st, &xmap, full + slot, kt * kWgBK, m0);
#pragma unroll
          for (int j = 0; j < kWgBN / 64; ++j) {
            wft::tma_load_2d(st + kWgABytes + j * kWgBBox, &wmap, full + slot, n0 + 64 * j,
                             kt * kWgBK);
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64·wg … + 63 of each tile
  const int lt = tid % 128, warp = lt / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const float s0 = p.s[0];
  const bool perturb_in = !p.perturb_out;
  const float sb = __bfloat162float(__float2bfloat16_rn(s0));
  float* out = static_cast<float*>(p.out);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / ntiles * kWgBM, n0 = tile % ntiles * kWgBN;
    float acc[kWgBN / 2];
#pragma unroll
    for (int i = 0; i < kWgBN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int slot = it % kWgStages;
      wft::mbar_wait(full + slot, (it / kWgStages) & 1);
      uint8_t* as = smem + slot * kWgStageBytes + wg * (kWgABytes / 2);
      if (perturb_in) {  // x ⊕ s on this warpgroup's 64 rows (8 KB)
#pragma unroll
        for (int i = 0; i < kWgABytes / 2 / 16 / 128; ++i) {
          uint4* q = reinterpret_cast<uint4*>(as) + lt + i * 128;
          uint4 v = *q;
          uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u[j]));
            u[j] = wft::pack_bf16(f.x + sb, f.y + sb);
          }
          *q = v;
        }
        wft::fence_proxy_async();          // the writes, before wgmma reads them
        wft::named_bar_sync(1 + wg, 128);  // this warpgroup only
      }
      const uint32_t a_addr = wft::smem_u32(as);
      const uint32_t b_addr = wft::smem_u32(smem + slot * kWgStageBytes + kWgABytes);
      wft::wgmma_fence();
      wft::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        // x: K-major, k16 = 32 bytes into the 128-byte row; w: MN-major,
        // 16 K-rows = 2048 bytes down, 64-column boxes 8 KB apart
        const uint64_t da = wft::wgmma_desc(a_addr + kk * 32, 16, 1024, wft::kSwizzle128);
        const uint64_t db = wft::wgmma_desc(b_addr + kk * 2048, kWgBBox, 1024, wft::kSwizzle128);
        wft::Wgmma<kWgBN>::run<0, 1>(acc, da, db, 1);
      }
      wft::wgmma_commit();
      wft::fence_regs(acc);
      wft::wgmma_wait<1>();  // the previous stage's products are done: release it
      if (kt > 0) wft::mbar_arrive(empty + (it - 1) % kWgStages);
    }
    wft::wgmma_wait<0>();
    wft::fence_regs(acc);
    // the tile's last stage; the producer is already filling the next tile's
    wft::mbar_arrive(empty + (it - 1) % kWgStages);

#pragma unroll
    for (int j = 0; j < kWgBN / 8; ++j) {
      // even t: row g, columns 2t…2t+3; odd t: row g + 8, columns 2t−2…2t+1
      const bool odd = t & 1;
      const float* a = acc + 4 * j;
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
      float4 v = odd ? make_float4(r0, r1, a[2], a[3]) : make_float4(a[0], a[1], r0, r1);
      if (p.perturb_out) {
        v.x += s0;
        v.y += s0;
        v.z += s0;
        v.w += s0;
      }
      const int row = m0 + wg * 64 + warp * 16 + g + (odd ? 8 : 0);
      const int col = n0 + j * 8 + 2 * (t & ~1);
      if (row < p.M && col < p.N) {
        *reinterpret_cast<float4*>(out + (long long)row * p.N + col) = v;
      }
    }
  }
}

cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {(uint64_t)p.K, (uint64_t)p.M}, xstr[1] = {(uint64_t)p.K * 2};
  const uint32_t xbox[2] = {kWgBK, kWgBM};
  cudaError_t err =
      wft::make_map_bf16(&xmap, p.x, 2, xdims, xstr, xbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const uint64_t wdims[2] = {(uint64_t)p.N, (uint64_t)p.K}, wstr[1] = {(uint64_t)p.N * 2};
  const uint32_t wbox[2] = {64, kWgBK};
  err = wft::make_map_bf16(&wmap, p.w, 2, wdims, wstr, wbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tiled_matmul_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWgSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // one persistent block per SM (the ring takes most of its shared memory)
  const long long tiles = (long long)((p.M + kWgBM - 1) / kWgBM) * ((p.N + kWgBN - 1) / kWgBN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  tiled_matmul_wgmma_kernel<<<grid, kWgThreads, kWgSmem, stream>>>(xmap, wmap, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// int8 → int32: wᵀ, then TMA + wgmma with TMA stores (see the header).

// wᵀ: w (K, N) → wt (N, K), both row-major int8, by 64 × 64 tiles through
// shared memory: 8-byte loads along N, 16-byte stores along K.
constexpr int kTT = 64;

__global__ void __launch_bounds__(256)
    w_kmajor_kernel(const uint8_t* __restrict__ w, uint8_t* __restrict__ wt, int K, int N) {
  __shared__ __align__(16) uint8_t tile[kTT][kTT + 8];  // [k][n]
  const int k0 = blockIdx.y * kTT, n0 = blockIdx.x * kTT, tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kTT * kTT / 8 / 256; ++j) {
    const int i = tid + 256 * j, r = i / 8, c = i % 8, k = k0 + r, n = n0 + 8 * c;
    uint2 v = make_uint2(0u, 0u);
    if (k < K && n < N) v = *reinterpret_cast<const uint2*>(w + (long long)k * N + n);
    *reinterpret_cast<uint2*>(&tile[r][8 * c]) = v;
  }
  __syncthreads();
  const int rr = tid % kTT, cc = tid / kTT;  // wt row n0 + rr, K bytes 16·cc …
  if (n0 + rr < N && k0 + 16 * cc < K) {     // K % 16 == 0: whole chunks
    uint32_t u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 16 * cc + 4 * j;
      u[j] = (uint32_t)tile[k][rr] | (uint32_t)tile[k + 1][rr] << 8 |
             (uint32_t)tile[k + 2][rr] << 16 | (uint32_t)tile[k + 3][rr] << 24;
    }
    *reinterpret_cast<uint4*>(wt + (long long)(n0 + rr) * K + k0 + 16 * cc) =
        make_uint4(u[0], u[1], u[2], u[3]);
  }
}

constexpr int kS8BM = 128;                    // output rows per tile: 2 warpgroups × 64
constexpr int kS8BN = 256;                    // output columns per tile
constexpr int kS8BK = 128;                    // K bytes per stage: one 128-byte swizzle row
constexpr int kS8Stages = 4;                  // ring depth
constexpr int kS8EpiBufs = 2;                 // staging slices per warpgroup
constexpr int kS8Threads = 2 * 128 + 32;      // two consumer warpgroups, one producer warp
constexpr int kS8ABytes = kS8BM * kS8BK;      // x box: 128 rows × 128 bytes
constexpr int kS8StageBytes = kS8ABytes + kS8BN * kS8BK;  // + the wᵀ box
constexpr int kS8Slice = 64 * 32 * 4;         // 64 rows × 32 int32 columns (128-byte rows)
constexpr int kS8EpiBytes = 2 * kS8EpiBufs * kS8Slice;
constexpr size_t kS8Smem = (size_t)kS8Stages * kS8StageBytes + kS8EpiBytes + 2 * kS8Stages * 8 + 1024;

__global__ void __launch_bounds__(kS8Threads)
    tiled_matmul_s8_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const __grid_constant__ CUtensorMap omap, Params p) {
  extern __shared__ uint8_t smem_raw[];
  // swizzled TMA boxes and wgmma atoms want 1024-byte aligned stages
  uint8_t* smem = smem_raw + ((1024 - wft::smem_u32(smem_raw) % 1024) % 1024);
  uint8_t* epi = smem + kS8Stages * kS8StageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + kS8EpiBytes);
  uint64_t* empty = full + kS8Stages;
  const int tid = threadIdx.x, wg = tid / 128;
  const int ntiles = (p.N + kS8BN - 1) / kS8BN;
  const int tiles = (p.M + kS8BM - 1) / kS8BM * ntiles;
  const int ktiles = (p.K + kS8BK - 1) / kS8BK;
  if (tid == 0) {
    for (int i = 0; i < kS8Stages; ++i) {
      wft::mbar_init(full + i, 1);
      wft::mbar_init(empty + i, 2 * 128);
    }
    wft::mbar_init_fence();
  }
  __syncthreads();

  // tile t: rows (t / ntiles)·128 …, columns (t % ntiles)·256 …; the stage
  // counter `it` runs on across this block's tiles
  if (wg == 2) {  // the producer warp: one thread issues every copy
    if (tid == 2 * 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / ntiles * kS8BM, n0 = tile % ntiles * kS8BN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int slot = it % kS8Stages;
          if (it >= kS8Stages) wft::mbar_wait_or_trap(empty + slot, (it / kS8Stages - 1) & 1);
          uint8_t* st = smem + slot * kS8StageBytes;
          wft::mbar_arrive_expect_tx(full + slot, kS8StageBytes);
          wft::tma_load_2d(st, &xmap, full + slot, kt * kS8BK, m0);
          wft::tma_load_2d(st + kS8ABytes, &wmap, full + slot, kt * kS8BK, n0);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64·wg … + 63 of each tile
  const int lt = tid % 128, warp = lt / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const float s0 = p.s[0];
  const bool perturb_in = !p.perturb_out;
  const uint32_t sb = (uint32_t)(uint8_t)(int8_t)__float2int_rz(s0) * 0x01010101u;
  const int po = p.perturb_out ? __float2int_rz(s0) : 0;
  uint8_t* ebuf = epi + wg * kS8EpiBufs * kS8Slice;
  int it = 0, slices = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / ntiles * kS8BM, n0 = tile % ntiles * kS8BN;
    int acc[kS8BN / 2];
#pragma unroll
    for (int i = 0; i < kS8BN / 2; ++i) acc[i] = 0;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int slot = it % kS8Stages;
      wft::mbar_wait_or_trap(full + slot, (it / kS8Stages) & 1);
      uint8_t* as = smem + slot * kS8StageBytes + wg * (kS8ABytes / 2);
      if (perturb_in) {  // x ⊕ s on this warpgroup's 64 rows (8 KB), per byte
#pragma unroll
        for (int i = 0; i < kS8ABytes / 2 / 16 / 128; ++i) {
          uint4* q = reinterpret_cast<uint4*>(as) + lt + i * 128;
          uint4 v = *q;
          v.x = __vadd4(v.x, sb);
          v.y = __vadd4(v.y, sb);
          v.z = __vadd4(v.z, sb);
          v.w = __vadd4(v.w, sb);
          *q = v;
        }
        wft::fence_proxy_async();          // the writes, before wgmma reads them
        wft::named_bar_sync(1 + wg, 128);  // this warpgroup only
      }
      const uint32_t a_addr = wft::smem_u32(as);
      const uint32_t b_addr = wft::smem_u32(smem + slot * kS8StageBytes + kS8ABytes);
      wft::wgmma_fence();
      wft::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < kS8BK / 32; ++kk) {
        // both K-major: k32 = 32 bytes into the 128-byte rows, 8-row groups 1 KB apart
        const uint64_t da = wft::wgmma_desc(a_addr + kk * 32, 16, 1024, wft::kSwizzle128);
        const uint64_t db = wft::wgmma_desc(b_addr + kk * 32, 16, 1024, wft::kSwizzle128);
        wft::WgmmaS8<kS8BN>::run(acc, da, db, 1);
      }
      wft::wgmma_commit();
      wft::fence_regs(acc);
      wft::wgmma_wait<1>();  // the previous stage's products are done: release it
      if (kt > 0) wft::mbar_arrive(empty + (it - 1) % kS8Stages);
    }
    wft::wgmma_wait<0>();
    wft::fence_regs(acc);
    // the tile's last stage; the producer is already filling the next tile's
    wft::mbar_arrive(empty + (it - 1) % kS8Stages);

    if (m0 + 64 * wg >= p.M) continue;  // this warpgroup's rows are all past M
    // slice c: columns n0 + 32c … + 31; row r of a slice is 128 bytes whose
    // 16-byte chunks are swizzled by r % 8 (= g), as TMA's 128-byte swizzle reads them
#pragma unroll
    for (int c = 0; c < kS8BN / 32; ++c) {  // unrolled: acc is indexed by constants
      if (n0 + 32 * c >= p.N) break;
      uint8_t* buf = ebuf + (slices++ % kS8EpiBufs) * kS8Slice;
      if (lt == 0) wft::bulk_wait_read<kS8EpiBufs - 1>();  // buf's last store has read it
      wft::named_bar_sync(1 + wg, 128);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int* a = acc + 4 * (4 * c + jj);
        const int chunk = (2 * jj + t / 2) ^ g, within = (t % 2) * 8;
        const int r = warp * 16 + g;
        *reinterpret_cast<int2*>(buf + r * 128 + chunk * 16 + within) =
            make_int2(a[0] + po, a[1] + po);
        *reinterpret_cast<int2*>(buf + (r + 8) * 128 + chunk * 16 + within) =
            make_int2(a[2] + po, a[3] + po);
      }
      wft::fence_proxy_async();  // the writes, before the TMA store reads them
      wft::named_bar_sync(1 + wg, 128);
      if (lt == 0) {
        wft::tma_store_2d(&omap, buf, n0 + 32 * c, m0 + 64 * wg);
        wft::bulk_commit();
      }
    }
  }
  if (lt == 0) wft::bulk_wait<0>();  // every store done before exit
}

// The current device's SM count, with the kernel's shared-memory limit set
// on that device, once per device: a call's host work is close to its time
// on the card, so a back-to-back caller should pay neither again.
cudaError_t s8_device_setup(int* sms) {
  constexpr int kMaxDevices = 64;
  static int cached_sms[kMaxDevices] = {};  // 0: not set up yet
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && cached_sms[device] > 0) {
    *sms = cached_sms[device];
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(tiled_matmul_s8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kS8Smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device < kMaxDevices) cached_sms[device] = *sms;
  return err;
}

cudaError_t launch_s8(const Params& p, cudaStream_t stream) {
  // p.w is wᵀ (N, K) from w_kmajor_kernel
  CUtensorMap xmap, wmap, omap;
  const uint64_t xdims[2] = {(uint64_t)p.K, (uint64_t)p.M}, xstr[1] = {(uint64_t)p.K};
  const uint32_t xbox[2] = {kS8BK, kS8BM};
  cudaError_t err = wft::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.x, 2, xdims, xstr,
                                  xbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const uint64_t wdims[2] = {(uint64_t)p.K, (uint64_t)p.N}, wstr[1] = {(uint64_t)p.K};
  const uint32_t wbox[2] = {kS8BK, kS8BN};
  err = wft::make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.w, 2, wdims, wstr, wbox,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const uint64_t odims[2] = {(uint64_t)p.N, (uint64_t)p.M}, ostr[1] = {(uint64_t)p.N * 4};
  const uint32_t obox[2] = {32, 64};
  err = wft::make_map(&omap, CU_TENSOR_MAP_DATA_TYPE_INT32, p.out, 2, odims, ostr, obox,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = s8_device_setup(&sms);
  if (err != cudaSuccess) return err;
  // one persistent block per SM (the ring and the staging take its shared memory)
  const long long tiles = (long long)((p.M + kS8BM - 1) / kS8BM) * ((p.N + kS8BN - 1) / kS8BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  tiled_matmul_s8_kernel<<<grid, kS8Threads, kS8Smem, stream>>>(xmap, wmap, omap, p);
  return cudaGetLastError();
}

}  // namespace

// The design that runs a product of this type: 0 = TMA + wgmma (bf16),
// 1 = wᵀ, then TMA + wgmma with TMA stores (int8).
extern "C" int wft_tiled_matmul_design(int int8) { return int8 ? 1 : 0; }

// wt (N, K) = wᵀ for w (K, N), both row-major int8: the K-major operand the
// int8 product reads (wft_tiled_matmul launches it first; this entry runs it
// alone). K % 16 == 0, N % 8 == 0, w and wt 16-byte aligned. Returns a
// cudaError_t (0 on success).
extern "C" int wft_w_kmajor(const void* w, void* wt, int K, int N, void* stream) {
  if (K < 1 || N < 1 || K % 16 != 0 || N % 8 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kTT - 1) / kTT, (K + kTT - 1) / kTT);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  w_kmajor_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(w), static_cast<uint8_t*>(wt), K, N);
  return (int)cudaGetLastError();
}

// Returns a cudaError_t (0 on success). int8 = 0: x, w (K, N) bf16 and out
// fp32, wt unused; int8 = 1: x, w (K, N) int8 and out int32, and wt an (N, K)
// int8 scratch that w_kmajor_kernel fills with wᵀ before the product reads
// it (two launches, one call: the host work of a call is close to its time
// on the card). x rows must be whole 16-byte vectors (K % 8 == 0 for bf16,
// K % 16 == 0 for int8), N % 8 == 0, and x, w, wt and out 16-byte aligned.
extern "C" int wft_tiled_matmul(int int8, const void* s, const void* x, const void* w, void* wt,
                                void* out, int M, int K, int N, int perturb_out, void* stream) {
  const int es = int8 ? 1 : 2;
  if (M < 1 || K < 1 || N < 1 || (K * es) % 16 != 0 || N % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (int8) {
    const int err = wft_w_kmajor(w, wt, K, N, stream);
    if (err != 0) return err;
  }
  const Params p{static_cast<const float*>(s), static_cast<const uint8_t*>(x),
                 static_cast<const uint8_t*>(int8 ? wt : w), out, M, K, N, perturb_out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(int8 ? launch_s8(p, st) : launch_bf16(p, st));
}
