// Tiled matrix products for Hopper: bf16 → fp32 on TMA + wgmma, int8 → int32
// on mma.sync.
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
// int8 (`tiled_matmul_kernel`, simple first: mma.sync and cp.async). A block
// of 8 warps owns a 128 × 128 output tile; the warps are 2 (M) × 4 (N), each
// 64 × 32. K is walked in 128-byte chunks (128 int8) through a 3-stage
// cp.async ring in shared memory (two blocks per SM, as the 128 registers a
// thread may have allow). The TPU kernel kept all of w in VMEM (:42); at
// 1-2 MB it does not fit 227 KB of shared memory, so w is tiled too and
// stays in the 50 MB L2, read by every row of blocks.
//   * A fragments come from the x tile by ldmatrix (144-byte rows: no bank
//     conflicts), a register holding four int8 of one row.
//   * mma wants B K-contiguous per output column, and ldmatrix.trans moves
//     16-bit elements only, so a register it delivers holds bytes of two k
//     rows × two columns. Two such registers, from matrices whose rows are
//     the k ≡ 0,1 and the k ≡ 2,3 (mod 4) rows of 16, give after two byte
//     permutes four consecutive k of column 2g and of column 2g + 1. One mma
//     takes the even columns of a 16-column group and another the odd ones,
//     so a thread ends with four consecutive output columns. No transposed
//     copy of w is made. Rows k and k + 8 of one such matrix would share
//     banks, so the w tile's 16-byte chunks are XOR-swizzled by
//     ((k >> 1) & 6) | (k & 1).
//   * The input perturbation is applied in shared memory, once per element
//     and stage, by the thread that copied the element.
//   * The epilogue adds the output perturbation and stores 16-byte vectors.

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
// int8 → int32: mma.sync (see the header).

constexpr int kBM = 128;              // output rows per block
constexpr int kBN = 128;              // output columns per block
constexpr int kThreads = 256;         // 8 warps, 2 (M) × 4 (N), 64 × 32 each
constexpr int kStages = 3;            // cp.async ring depth
constexpr int kKB = 128;              // K-values (bytes) per stage
constexpr int kAS = kKB + 16;         // x tile row stride in bytes
constexpr int kABytes = kBM * kAS;
constexpr int kBBytes = kKB * kBN;    // w tile: 128 K-rows × 128 columns
constexpr int kStageBytes = kABytes + kBBytes;
constexpr size_t kSmem = (size_t)kStages * kStageBytes;

// Chunk swizzle of the w tile's row k: the eight rows that one ldmatrix
// matrix reads (k ≡ 0,1 or 2,3 mod 4, within 16) land in eight bank groups.
__device__ __forceinline__ int swz(int k) { return ((k >> 1) & 6) | (k & 1); }

template <bool kW16>
__global__ void __launch_bounds__(kThreads, 2) tiled_matmul_kernel(Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kbytes = p.K;  // bytes of an x row
  const long long wrow = p.N;
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
    if constexpr (kW16) {
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
    const uint32_t sb = (uint32_t)(uint8_t)(int8_t)__float2int_rz(s0) * 0x01010101u;
#pragma unroll
    for (int i = 0; i < kBM * kKB / 16 / kThreads; ++i) {
      const int e = tid + i * kThreads;
      uint4* q = reinterpret_cast<uint4*>(as + (e / (kKB / 16)) * kAS + (e % (kKB / 16)) * 16);
      uint4 v = *q;
      uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) u[j] = __vadd4(u[j], sb);  // per byte, wrapping
      *q = v;
    }
  };

  // [m-tile][n-tile][fragment]; n-tile 2·c + e holds the even (e = 0) or odd
  // (e = 1) columns of the warp's 16-column group c
  int acc[4][4][4];
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
        // matrix j, row i holds k = 16·(j / 2) + 4·(i / 2) + 2·(j % 2) + i % 2
        // of the group's 16 columns; lane (g, t) gets k 4t, 4t + 1 (matrix 0)
        // and 4t + 2, 4t + 3 (matrix 1) of columns 2g and 2g + 1
        uint32_t r[4];
        const int j = lane / 8, i = lane % 8;
        const int k = kk * 32 + (j / 2) * 16 + (i / 2) * 4 + (j % 2) * 2 + i % 2;
        wft::ldmatrix_x4_trans(r, bs + k * kBN + (((wn + c * 16) / 16) ^ swz(k)) * 16);
        bf[2 * c][0] = __byte_perm(r[0], r[1], 0x6420);      // column 2g, k 4t…4t+3
        bf[2 * c + 1][0] = __byte_perm(r[0], r[1], 0x7531);  // column 2g + 1
        bf[2 * c][1] = __byte_perm(r[2], r[3], 0x6420);      // k 16+4t…16+4t+3
        bf[2 * c + 1][1] = __byte_perm(r[2], r[3], 0x7531);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) wft::mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  }

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
}

template <bool kW16>
cudaError_t launch_int8(const Params& p, cudaStream_t stream) {
  auto kernel = tiled_matmul_kernel<kW16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The design that runs a product of this type: 0 = TMA + wgmma (bf16),
// 1 = mma.sync (int8).
extern "C" int wft_tiled_matmul_design(int int8) { return int8 ? 1 : 0; }

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
  if (!int8) return (int)launch_bf16(p, st);
  return (int)(N % 16 == 0 ? launch_int8<true>(p, st) : launch_int8<false>(p, st));
}
