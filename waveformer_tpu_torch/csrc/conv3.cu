// Dense 3×3×3 "same" convolution as an implicit GEMM, for Hopper.
//
// Replaces three TPU kernels that compute the same product:
//   * waveformer_tpu/ops/conv_pallas.py `conv3x3x3_same` (`_kernel` :26-47),
//     (D, H, W, C) × (3, 3, 3, C, O) → (D, H, W, O);
//   * waveformer_tpu/ops/conv_pallas.py `conv3x3x3_cw` (`_kernel_cw`
//     :119-150), the same conv in the (D, H, C, W) → (D, H, O, W) layout;
//   * tools/exp_fused_conv.py `conv3x3x3_fused` (`_kernel` :44-113), the
//     DHWC conv with an optional InstanceNorm (+ LeakyReLU) prologue on load
//     and a per-channel [Σ, Σ²] epilogue of the fp32 accumulator.
// Stride 1, zero padding 1, no bias, K = 27·C ordered (kd, kh, kw, c),
// fp32 accumulation; a leading batch dimension B in one launch.
//
// What bounds it: operations. At (8, 128³, 48 → 48) bf16 the product is
// 2.09 TFLOP (2.1 ms at the bf16 tensor rate) against 1.6 GB of traffic
// (0.5 ms); with C = 4 (the first encoder block) it is bytes. Four designs,
// chosen from the dtype, the layout and the shape only (`design_of`,
// queried by `wft_conv3_design`):
//
// `conv3_cl_kernel` (bf16, DHWC, C % 8 == 0: every conv of the model but the
// first): an implicit GEMM with M = voxels, N = output channels, on wgmma
// with both operands in shared memory. A block owns one output plane × th
// h-rows × tw w-columns (2·MT M tiles of 8 × 8 voxels, arranged to pad the
// plane least: 16 × 32 at BN ≤ 48, 16 × 16 at BN = 64 or 96) × BN output
// channels (O rounded up to 8 up to 48, else 64 or 96; 192 → 2 × 96) and
// walks K in stages of (kd, 16 input channels). One producer thread loads
// each stage with TMA into a ring of 2-4 stages tracked by full/empty
// mbarriers: the nine (kh, kw) taps' weights of that (kd, chunk) from the
// per-tap packing (32-byte swizzle), and one box {16 channels, tw + 2, th +
// 2} of the map over x as (C, W, H, D, B) at (c0, w0 − 1, h0 − 1, d + kd −
// 1, b), also 32-byte swizzled. W is an outer dimension there, so the start
// −1 is legal, and TMA's zero fill outside the volume and past C is the SAME
// padding. The halo lands as [th + 2][tw + 2][16 channels]: one 32-byte row
// per voxel, which is a row of the 32-byte-swizzled K-major layout of a
// wgmma operand, so 8 w-neighbours are one 8-row atom and the next h-row's
// are (tw + 2)·32 bytes on (sbo). Tap (kh, kw) of an M tile is then the same
// descriptor moved by (kh·(tw + 2) + kw)·32 bytes: the swizzle follows the
// address bits, as TMA wrote them, so any 32-byte step is legal (a card test
// holds it). A is read straight from the halo, with no ldmatrix and no
// shuffles, and each input element leaves L2 about 1.2 times a stage instead
// of 9. (Two boxes of 8 channels, 16-byte rows, unswizzled, gave the same
// product with twice the TMA requests: `design_variants --kernel
// conv3_dhwc`.) Two consumer warpgroups each own MT (4 at BN ≤ 48, else 2) M
// tiles and issue, per stage, one group of 9·MT wgmma.m64nBNk16, keeping the
// previous stage's group in flight; the slot of stage s − 1 goes back to the
// producer when that group is done. With the prologue on, the consumers
// normalise stage s + 1's in-volume cells in place (z = (x − mean)·rstd,
// LeakyReLU, one rounding to bf16) while the products of stage s run, each
// thread always the same 8 channels of its cells (mean and rstd loaded once
// a stage), then fence the generic-proxy writes before the async proxy's
// reads and meet at a named barrier; cells outside the volume stay zero.
// (Three separate normalising warps, to keep the prologue off the warps that
// feed the tensor cores, were slower at every shape: at BN = 48 they fall
// behind the products.) One fp32 accumulator holds all of K. Statistics: per
// block, column sums of acc and acc² over its voxels inside the volume, in a
// fixed order (a thread's rows, xor shuffles over the 8 lanes of a column,
// the warps in order through shared memory), into the scratch array. The
// bf16 tile is staged [voxel][n] in the ring and stored along C in 16-byte
// vectors. At C = 4 a map's W stride (8 bytes) is no multiple of 16, which
// TMA needs, so the flagship's first conv (128³·4 → 48) stays on the halo
// kernel below: it moves bytes, not products, and beats cuDNN there.
//
// `conv3_halo_kernel` (bf16, DHWC, C % 4 == 0 otherwise): a
// block of 8 warps owns one output plane × 8 h-rows × 32 w-columns (each warp
// one row, two m16 tiles) × NT·8 output channels, and walks K in stages of
// one kd × 16 input channels. A stage copies the block's 10 × 34 input halo
// of that plane and those channels into shared memory once (cp.async,
// zero-filled outside the volume and past C), with the nine (kh, kw) taps'
// weights; `ldmatrix` then reads each tap's A fragments straight from the
// halo, one row address per lane (cell (row + kh, col + kw)), so every input
// element is fetched about 4 times instead of 27. A 2-stage ring copies
// stage s + 1 while stage s is multiplied. With the prologue on, each thread
// normalises the in-volume halo pieces it copied, in shared memory (mean
// and rstd staged there once), before the stage is multiplied; cells outside
// the volume stay zero, so the SAME halo stays zero after normalisation.
//
// `conv3_tma_kernel` (bf16, DHCW, W % 8 == 0, as TMA's 16-byte strides
// need): an implicit GEMM with M = voxels, N = output channels, on wgmma.
// A block owns one output plane × th h-rows × wt w-columns (wt = 16, 32 or
// 64, the smallest ≥ W up to 64; th·wt = 512 voxels at BN ≤ 48, 256 at
// BN = 96) × BN output channels
// (16, 32, 48 or 96) and walks K in stages of (kd, 16 input channels). A
// producer warp loads each stage with TMA into a ring of 2-4 stages tracked
// by full/empty mbarriers, from 5-D maps over x as (W, C, H, D, B) (D and B
// apart, so plane −1 of an instance is zero): the main box {wt, 16
// channels, th + 2 rows} at W start w0, swizzled by wt·2 bytes, two halo
// boxes {8, 16, th + 2} at w0 − 8 and w0 + wt, and the nine (kh, kw) taps'
// weights of that (kd, chunk) from the per-tap packing. TMA's zero fill
// outside the tensor gives the SAME padding in D, H and W and the zero
// channels past C; nothing is padded in device memory. A box's W start must
// be 16-byte aligned (a start of w0 − 1 + kw faulted on the H100), and a
// wgmma descriptor's start is 16-byte aligned too, so the one-voxel kw
// shift cannot come from shared-memory addresses: each consumer warp reads
// its 16 voxels × 16 channels of a box row with ldmatrix.trans (the kw = 1
// A fragment) plus the 8 voxels on either side, and makes the kw = 0 and
// kw = 2 fragments with warp shuffles (lane g ∓ 1). Four consumer
// warpgroups each own MT (2 at BN ≤ 48, else 1) M tiles of 64 voxels (64 /
// wt rows at one stride) and issue, per (M tile, kh), three wgmma.m64nBNk16
// with A in registers and B (n rows of 16 channels, K-major) from shared
// memory, keeping the previous group in flight while they build the next;
// the kernel is bound by that latency, not by the tensor rate or L2. The
// accumulators hold all of K (no statistics on this path); the bf16 tile
// is staged [n][voxel] in the ring and stored along W in 16-byte vectors.
// Each stage reads (th + 2)·16·(wt + 16)·2 bytes of x from L2.
//
// `conv3_kernel` (fp32, and bf16 DHCW with W % 8 != 0 or DHWC with C % 4 !=
// 0): the first design, one tap × 16 channels per chunk, 64 voxels per
// 4-warp block, loads through registers with zero-fill past C; bf16 on
// mma.sync, fp32 as an FMA loop (one row × NT·4 columns per thread).
//
// The mma.sync designs: the tensor cores' fp32 sums are not rounded to
// nearest, so each chunk goes into a fresh fragment that is added to an IEEE
// fp32 total (the error does not grow with K). The fp32 tile goes through shared
// memory for the store and the statistics. Every design with statistics
// writes each block's column sums of acc and acc² (in a fixed order) to a
// scratch array, and a second kernel adds the blocks of an instance in a
// fixed order, so two calls give bit-identical statistics (no fp32
// atomics). No padded copy of the input goes to device memory (the TPU
// kernels' pads of W and C are TPU tiling).

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBM = 64;        // output voxels per block
constexpr int kBK = 16;        // K-chunk: one tap × 16 input channels
constexpr int kThreads = 128;  // 4 warps
constexpr int kAK = kBK + 8;   // bf16 row stride of the A/B tiles: conflict-free fragments
constexpr float kNegSlope = 0.01f;

enum Layout : int { kDHWC = 0, kDHCW = 1 };

struct Params {
  const void* x;      // (B, D, H, W, C) or (B, D, H, C, W)
  const void* w;      // (Opad, kstride), k = tap·C + c, zero-padded, input dtype;
                      // the per-tap packing for the TMA kernel (wft_conv3)
  const float* mean;  // (B, C) prologue statistics, or null for no prologue
  const float* rstd;  // (B, C)
  void* y;            // (B, D, H, W, O) or (B, D, H, O, W)
  float* partial;     // (B, 2, O, tiles) per-block [Σ, Σ²], or null
  int B, D, H, W, C, O;
  int tiles;          // blocks per instance along D·H·W
  int act;            // LeakyReLU after the prologue's normalisation
  int kstride;        // weight row stride: 27·C rounded up to 8
};

// Offset of element (b, d, h, w, c) in a tensor of `ch` channels.
template <int L>
__device__ __forceinline__ long long offset(const Params& p, int ch, int b, int d, int h,
                                            int w, int c) {
  const long long row = ((long long)b * p.D + d) * p.H + h;
  if (L == kDHWC) return (row * p.W + w) * ch + c;
  return (row * ch + c) * p.W + w;
}

// Store the BM × BN fp32 tile `cs` (row stride BN + 4) of block (b, tile, n0)
// in T and, with statistics on, write its column sums of acc and acc² (rows
// in order) to the scratch array. `pos(row, d, h, w)` gives a row's output
// voxel and returns false for a row past the volume.
template <typename T, int L, int BM, int BN, typename Pos>
__device__ __forceinline__ void store_tile(const Params& p, const float* cs, int b, int tile,
                                           int n0, Pos pos) {
  T* y = static_cast<T*>(p.y);
  for (int e = threadIdx.x; e < BM * BN; e += blockDim.x) {
    // DHWC: channels fastest (contiguous); DHCW: voxels fastest (contiguous in W)
    const int row = L == kDHWC ? e / BN : e % BM;
    const int n = L == kDHWC ? e % BN : e / BM;
    int d, h, w;
    if (!pos(row, d, h, w) || n0 + n >= p.O) continue;
    y[offset<L>(p, p.O, b, d, h, w, n0 + n)] = wft::from_f<T>(cs[row * (BN + 4) + n]);
  }
  if (p.partial == nullptr) return;
  for (int n = threadIdx.x; n < BN; n += blockDim.x) {
    if (n0 + n >= p.O) continue;
    float s = 0.f, s2 = 0.f;
    for (int row = 0; row < BM; ++row) {
      int d, h, w;
      if (!pos(row, d, h, w)) continue;
      const float c = cs[row * (BN + 4) + n];
      s += c;
      s2 = fmaf(c, c, s2);
    }
    float* dst = p.partial + (((long long)b * 2) * p.O + n0 + n) * p.tiles + tile;
    dst[0] = s;
    dst[(long long)p.O * p.tiles] = s2;
  }
}

template <typename T, int L, int NT>
__global__ void __launch_bounds__(kThreads) conv3_kernel(Params p) {
  constexpr int BN = NT * 8;
  constexpr bool kTC = sizeof(T) == 2;  // bf16 → tensor cores
  constexpr int kABytes = kTC ? (kBM + BN) * kAK * 2 : kBK * ((kBM + 4) + BN) * 4;
  __shared__ __align__(16) unsigned char ab_raw[kABytes];
  __shared__ __align__(16) float c_s[kBM][BN + 4];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.tiles;
  const int tile = blockIdx.x % p.tiles;
  const int n0 = blockIdx.y * BN;
  const long long vol = (long long)p.D * p.H * p.W;
  const T* x = static_cast<const T*>(p.x);
  const T* wt = static_cast<const T*>(p.w);

  // this thread gathers 8 channels of one A row
  const int r = tid % kBM;
  const int half = tid / kBM;
  const long long v = (long long)tile * kBM + r;
  const bool row_ok = v < vol;
  const int vw = (int)(v % p.W);
  const int vh = (int)((v / p.W) % p.H);
  const int vd = (int)(v / ((long long)p.W * p.H));
  const bool vec = L == kDHWC && p.C % 8 == 0;
  const float* mean = p.mean ? p.mean + (long long)b * p.C : nullptr;
  const float* rstd = p.mean ? p.rstd + (long long)b * p.C : nullptr;

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float accf[NT * 4];  // fp32 path: row r, columns half·NT·4 + j
#pragma unroll
  for (int j = 0; j < NT * 4; ++j) accf[j] = 0.f;

  for (int tap = 0; tap < 27; ++tap) {
    const int dd = vd + tap / 9 - 1;
    const int hh = vh + (tap / 3) % 3 - 1;
    const int ww = vw + tap % 3 - 1;
    const bool inside = row_ok && dd >= 0 && dd < p.D && hh >= 0 && hh < p.H &&
                        ww >= 0 && ww < p.W;
    for (int c0 = 0; c0 < p.C; c0 += kBK) {
      // A: 8 channels of row r, zero outside the volume and past C
      float a[8];
      const int cb = c0 + half * 8;
      if (inside && vec && cb + 8 <= p.C) {
        wft::load8(x + offset<L>(p, p.C, b, dd, hh, ww, cb), a);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          a[i] = inside && cb + i < p.C
                     ? wft::to_f(x[offset<L>(p, p.C, b, dd, hh, ww, cb + i)])
                     : 0.f;
        }
      }
      if (mean != nullptr && inside) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (cb + i < p.C) {
            float z = (a[i] - mean[cb + i]) * rstd[cb + i];
            if (p.act) z = z >= 0.f ? z : z * kNegSlope;
            a[i] = z;
          }
        }
      }
      if constexpr (kTC) {
        __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(ab_raw);
        __nv_bfloat16* b_s = a_s + kBM * kAK;
        wft::store8(a_s + r * kAK + half * 8, a);
        for (int e = tid; e < BN * kBK; e += kThreads) {
          const int n = e / kBK, k = e % kBK;
          b_s[n * kAK + k] = n0 + n < p.O && c0 + k < p.C
                                 ? wt[(long long)(n0 + n) * p.kstride + tap * p.C + c0 + k]
                                 : __float2bfloat16(0.f);
        }
        __syncthreads();
        const __nv_bfloat16* ar0 = a_s + (warp * 16 + g) * kAK + 2 * t;
        const __nv_bfloat16* ar1 = ar0 + 8 * kAK;
        const uint32_t af[4] = {wft::ld32(ar0), wft::ld32(ar1), wft::ld32(ar0 + 8),
                                wft::ld32(ar1 + 8)};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          // the tensor cores' fp32 sums are not rounded to nearest: a chunk
          // goes into a fresh fragment and is added to the IEEE fp32 total,
          // so the error does not grow with K (the statistics depend on it)
          const __nv_bfloat16* br = b_s + (j * 8 + g) * kAK + 2 * t;
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          wft::mma_bf16(part, af, wft::ld32(br), wft::ld32(br + 8));
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += part[i];
        }
      } else {
        float* a_s = reinterpret_cast<float*>(ab_raw);  // [kBK][kBM + 4]
        float* b_s = a_s + kBK * (kBM + 4);              // [kBK][BN]
#pragma unroll
        for (int i = 0; i < 8; ++i) a_s[(half * 8 + i) * (kBM + 4) + r] = a[i];
        for (int e = tid; e < BN * kBK; e += kThreads) {
          const int n = e / kBK, k = e % kBK;
          b_s[k * BN + n] = n0 + n < p.O && c0 + k < p.C
                                ? wft::to_f(wt[(long long)(n0 + n) * p.kstride + tap * p.C + c0 + k])
                                : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kBK; ++k) {
          const float av = a_s[k * (kBM + 4) + r];
          const float* br = b_s + k * BN + half * NT * 4;
#pragma unroll
          for (int j = 0; j < NT * 4; ++j) accf[j] = fmaf(av, br[j], accf[j]);
        }
      }
      __syncthreads();
    }
  }

  // the fp32 tile, for the store and the statistics
  if constexpr (kTC) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      c_s[warp * 16 + g][j * 8 + 2 * t] = acc[j][0];
      c_s[warp * 16 + g][j * 8 + 2 * t + 1] = acc[j][1];
      c_s[warp * 16 + g + 8][j * 8 + 2 * t] = acc[j][2];
      c_s[warp * 16 + g + 8][j * 8 + 2 * t + 1] = acc[j][3];
    }
  } else {
#pragma unroll
    for (int j = 0; j < NT * 4; ++j) c_s[r][half * NT * 4 + j] = accf[j];
  }
  __syncthreads();
  // row r is voxel tile·64 + r of the instance
  store_tile<T, L, kBM, BN>(p, &c_s[0][0], b, tile, n0, [&](int row, int& d, int& h, int& w) {
    const long long v = (long long)tile * kBM + row;
    w = (int)(v % p.W);
    h = (int)((v / p.W) % p.H);
    d = (int)(v / ((long long)p.W * p.H));
    return v < vol;
  });
}

// stats[b, s, o] = Σ over the tiles of partial[b, s, o, :], in a fixed order:
// thread i takes tiles i, i + 256, …, then a fixed tree over the threads.
__global__ void __launch_bounds__(256) stats_reduce_kernel(const float* __restrict__ partial,
                                                           float* __restrict__ stats,
                                                           int tiles) {
  __shared__ float red[256];
  const long long row = blockIdx.x;  // (b·2 + s)·O + o
  const float* src = partial + row * tiles;
  float s = 0.f;
  for (int i = threadIdx.x; i < tiles; i += 256) s += src[i];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int width = 128; width > 0; width >>= 1) {
    if (threadIdx.x < width) red[threadIdx.x] += red[threadIdx.x + width];
    __syncthreads();
  }
  if (threadIdx.x == 0) stats[row] = red[0];
}

// ---------------------------------------------------------------------------
// bf16, DHWC, C % 4 == 0: the pipelined implicit GEMM (see the header).

constexpr int kTH = 8;                             // output rows (h) per block: one per warp
constexpr int kTW = 32;                            // output columns (w) per block: two m16 tiles
constexpr int kHaloCells = (kTH + 2) * (kTW + 2);  // input cells of a block's halo
constexpr int kHC = 16;  // input channels per stage: one mma K-step
constexpr int kHS = kHC + 8;  // bf16 row stride of the ring: conflict-free ldmatrix
constexpr int kHaloThreads = 256;

// Two 8×8 bf16 matrices from shared memory (the x4 form is in common.cuh).
__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(s));
}

// Four consecutive bf16 (8 bytes) ↔ fp32.
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

// bf16 elements of one ring stage: the halo, then the nine taps' weights.
template <int NT>
__host__ __device__ constexpr int halo_stage_elems() {
  return kHaloCells * kHS + 9 * NT * 8 * kHS;
}

template <int NT>
__host__ __device__ constexpr int halo_ring_bytes() {
  return 2 * halo_stage_elems<NT>() * 2;
}

// Copied pieces are 4 channels (8 bytes): C % 4 == 0. Stage s covers
// kd = s / chunks and input channels 16·(s % chunks) …; dynamic shared
// memory holds the 2-stage ring, then (prologue) mean and rstd of the
// instance's C channels; the ring holds the fp32 output tile at the end.
template <int NT>
__global__ void __launch_bounds__(kHaloThreads, 2) conv3_halo_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int BN = NT * 8;
  constexpr int kStage = halo_stage_elems<NT>();
  constexpr int V = 4;              // channels per copied piece
  constexpr int kPieces = kHC / V;  // copied pieces per cell and stage
  static_assert(kTH * kTW * (BN + 4) * 4 <= halo_ring_bytes<NT>(), "output tile fits the ring");
  extern __shared__ __align__(16) unsigned char dyn[];
  bf16* ring = reinterpret_cast<bf16*>(dyn);
  float* mean_s = reinterpret_cast<float*>(dyn + halo_ring_bytes<NT>());
  float* rstd_s = mean_s + p.C;

  const int tid = threadIdx.x;
  const int hblocks = (p.H + kTH - 1) / kTH, wblocks = (p.W + kTW - 1) / kTW;
  const int b = blockIdx.x / p.tiles;
  const int tile = blockIdx.x % p.tiles;
  const int w0 = (tile % wblocks) * kTW;
  const int h0 = (tile / wblocks) % hblocks * kTH;
  const int d0 = tile / (wblocks * hblocks);
  const int n0 = blockIdx.y * BN;
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* wt = static_cast<const bf16*>(p.w);
  const bool pro = p.mean != nullptr;
  if (pro) {
    for (int c = tid; c < p.C; c += kHaloThreads) {
      mean_s[c] = p.mean[(long long)b * p.C + c];
      rstd_s[c] = p.rstd[(long long)b * p.C + c];
    }
  }
  const int chunks = (p.C + kHC - 1) / kHC;
  const int stages = 3 * chunks;

  // whether halo cell `cell` of stage s lies inside the volume, and its offset
  auto cell_in = [&](int s, int cell, long long& off) -> bool {
    const int d = d0 + s / chunks - 1;
    const int h = h0 + cell / (kTW + 2) - 1, w = w0 + cell % (kTW + 2) - 1;
    off = ((((long long)b * p.D + d) * p.H + h) * p.W + w) * p.C;
    return d >= 0 && d < p.D && h >= 0 && h < p.H && w >= 0 && w < p.W;
  };
  auto load = [&](int s) {
    bf16* hs = ring + (s % 2) * kStage;
    bf16* ws = hs + kHaloCells * kHS;
    const int c0 = s % chunks * kHC, kd = s / chunks;
    for (int e = tid; e < kHaloCells * kPieces; e += kHaloThreads) {
      const int cell = e / kPieces, c = c0 + e % kPieces * V;
      long long off;
      const bool ok = cell_in(s, cell, off) && c < p.C;
      wft::cp_async<V * 2, true>(hs + cell * kHS + c - c0, ok ? x + off + c : x, ok);
    }
    // rows past O are zero in the padded weights; channels past C are zero-filled
    for (int e = tid; e < 9 * BN * kPieces; e += kHaloThreads) {
      const int j = e / (BN * kPieces), n = e / kPieces % BN, c = c0 + e % kPieces * V;
      const bool ok = c < p.C;
      wft::cp_async<V * 2, true>(
          ws + (j * BN + n) * kHS + c - c0,
          ok ? wt + (long long)(n0 + n) * p.kstride + (kd * 9 + j) * p.C + c : wt, ok);
    }
  };
  // the prologue, on the in-volume halo pieces this thread copied
  auto normalise = [&](int s) {
    bf16* hs = ring + (s % 2) * kStage;
    const int c0 = s % chunks * kHC;
    for (int e = tid; e < kHaloCells * kPieces; e += kHaloThreads) {
      const int cell = e / kPieces, c = c0 + e % kPieces * V;
      long long off;
      if (!cell_in(s, cell, off) || c >= p.C) continue;
      bf16* q = hs + cell * kHS + c - c0;
      float z[V];
      load4(q, z);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        z[i] = (z[i] - mean_s[c + i]) * rstd_s[c + i];
        if (p.act) z[i] = z[i] >= 0.f ? z[i] : z[i] * kNegSlope;
      }
      store4(q, z);
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // ldmatrix lanes: A rows (lane % 8) + 8·((lane / 8) % 2) at k 8·(lane / 16);
  // B rows (lane % 8) + 8·(lane / 16) at k 8·((lane / 8) % 2)
  const int a_col = (lane % 8) + 8 * ((lane / 8) % 2), a_k = 8 * (lane / 16);
  const int b_row = (lane % 8) + 8 * (lane / 16), b_k = 8 * ((lane / 8) % 2);
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;

  if (pro) __syncthreads();  // mean_s / rstd_s
  load(0);
  wft::cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    // stage s + 1 fills the slot of stage s − 1, released by the last barrier
    if (s + 1 < stages) load(s + 1);
    wft::cp_async_commit();
    wft::cp_async_wait<1>();  // this thread's pieces of stage s have landed
    if (pro) normalise(s);
    __syncthreads();  // stage s is visible to every warp
    const bf16* hs = ring + (s % 2) * kStage;
    const bf16* ws = hs + kHaloCells * kHS;
#pragma unroll
    for (int j = 0; j < 9; ++j) {  // tap (kh, kw) = (j / 3, j % 3)
      uint32_t bfr[NT][2];
#pragma unroll
      for (int n = 0; n + 1 < NT; n += 2) {
        uint32_t r[4];
        wft::ldmatrix_x4(r, ws + (j * BN + n * 8 + b_row) * kHS + b_k);
        bfr[n][0] = r[0];
        bfr[n][1] = r[1];
        bfr[n + 1][0] = r[2];
        bfr[n + 1][1] = r[3];
      }
      if constexpr (NT % 2 == 1) {
        ldmatrix_x2(bfr[NT - 1][0], bfr[NT - 1][1],
                    ws + (j * BN + (NT - 1) * 8 + lane % 8) * kHS + b_k);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // output (h0 + warp, w0 + col) reads halo cell (warp + kh, col + kw)
        uint32_t af[4];
        wft::ldmatrix_x4(af, hs + ((warp + j / 3) * (kTW + 2) + mt * 16 + a_col + j % 3) * kHS + a_k);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          // a fresh fragment per product, added to the IEEE fp32 total
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          wft::mma_bf16(part, af, bfr[n][0], bfr[n][1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][n][i] += part[i];
        }
      }
    }
    __syncthreads();  // every warp is done with stage s's slot
  }
  wft::cp_async_wait<0>();

  // the fp32 tile, row r = output (h0 + r / 32, w0 + r % 32), in the ring
  float* cs = reinterpret_cast<float*>(dyn);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float* r0 = cs + (warp * kTW + mt * 16 + g) * (BN + 4) + n * 8 + 2 * t;
      float* r1 = r0 + 8 * (BN + 4);
      r0[0] = acc[mt][n][0];
      r0[1] = acc[mt][n][1];
      r1[0] = acc[mt][n][2];
      r1[1] = acc[mt][n][3];
    }
  __syncthreads();
  store_tile<bf16, kDHWC, kTH * kTW, BN>(p, cs, b, tile, n0,
                                         [&](int row, int& d, int& h, int& w) {
                                           d = d0;
                                           h = h0 + row / kTW;
                                           w = w0 + row % kTW;
                                           return h < p.H && w < p.W;
                                         });
}

template <int NT>
cudaError_t launch_halo_nt(const Params& p, cudaStream_t stream) {
  const size_t smem = halo_ring_bytes<NT>() + (p.mean ? 2 * sizeof(float) * p.C : 0);
  cudaError_t err = cudaFuncSetAttribute(
      conv3_halo_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((long long)p.B * p.tiles), (p.O + NT * 8 - 1) / (NT * 8));
  conv3_halo_kernel<NT><<<grid, kHaloThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Output channels per block, as n-tiles of 8: the narrowest that covers
// O ≤ 32, else 48 or 64 columns, whichever pads O less (96 → 2 × 48,
// 192 → 3 × 64); padded columns are wasted tensor-core work.
int pick_nt(int O) {
  if (O <= 8) return 1;
  if (O <= 16) return 2;
  if (O <= 32) return 4;
  return (O + 47) / 48 * 48 - O < (O + 63) / 64 * 64 - O ? 6 : 8;
}

cudaError_t launch_halo(const Params& p, cudaStream_t stream) {
  switch (pick_nt(p.O)) {
    case 1: return launch_halo_nt<1>(p, stream);
    case 2: return launch_halo_nt<2>(p, stream);
    case 4: return launch_halo_nt<4>(p, stream);
    case 6: return launch_halo_nt<6>(p, stream);
    default: return launch_halo_nt<8>(p, stream);
  }
}

template <typename T, int L, int NT>
cudaError_t launch_nt(const Params& p, cudaStream_t stream) {
  dim3 grid((unsigned)((long long)p.B * p.tiles), (p.O + NT * 8 - 1) / (NT * 8));
  conv3_kernel<T, L, NT><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int L>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  switch (pick_nt(p.O)) {
    case 1: return launch_nt<T, L, 1>(p, stream);
    case 2: return launch_nt<T, L, 2>(p, stream);
    case 4: return launch_nt<T, L, 4>(p, stream);
    case 6: return launch_nt<T, L, 6>(p, stream);
    default: return launch_nt<T, L, 8>(p, stream);
  }
}

// ---------------------------------------------------------------------------
// bf16, DHCW, W % 8 == 0: TMA + wgmma (see the header).

constexpr int kSmemMax = 232448;  // dynamic shared memory a block may have

// Consumer warpgroups per block and M tiles of 64 voxels per warpgroup (48
// accumulators a thread either way): four warpgroups hide the latency of
// building a fragment and of a product better than two with twice the tiles.
template <int BN>
__host__ __device__ constexpr int tma_wgs() {
  return 4;
}

template <int BN>
__host__ __device__ constexpr int tma_mt() {
  return BN <= 48 ? 2 : 1;
}

// Threads of a block: the consumer warpgroups, then one producer warp.
template <int BN>
__host__ __device__ constexpr int tma_threads() {
  return tma_wgs<BN>() * 128 + 32;
}

struct TmaTiles {
  int wt;           // voxels of a box row (W tile): 16, 32 or 64
  int th;           // output rows (h) per block: 64·WGS·MT / wt
  int wblocks, hblocks, chunks;
  int stages;       // ring depth
  int main_bytes;   // the main box: (th + 2) rows × 16 channels × wt
  int halo_bytes;   // one halo box: (th + 2) rows × 16 channels × 8
  int stage_bytes;  // main box, two halo boxes, nine taps' weights; 1 KB multiple
};

// Byte offset `off` of an aligned box after TMA's swizzle of `span`-byte rows
// (128, 64 or 32): 16-byte chunk bits [4, 4 + log2(span / 16)) ^= bits [7, …).
__device__ __forceinline__ uint32_t swizzled(uint32_t off, uint32_t span) {
  return off ^ (((off >> 7) & (span / 16 - 1)) << 4);
}

template <int BN>
__global__ void __launch_bounds__(tma_threads<BN>())
    conv3_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap hmap,
                     const __grid_constant__ CUtensorMap wmap, Params p, TmaTiles q) {
  using bf16 = __nv_bfloat16;
  constexpr int WGS = tma_wgs<BN>(), MT = tma_mt<BN>();
  constexpr int kVox = WGS * MT * 64;  // output voxels per block
  constexpr int kCS = kVox + 8;      // row stride of the staged output tile
  extern __shared__ uint8_t smem_raw[];
  // swizzled boxes want 1024-byte aligned stages
  uint8_t* smem = smem_raw + ((1024 - wft::smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + q.stages * q.stage_bytes);
  uint64_t* empty = full + q.stages;
  const int tid = threadIdx.x, wg = tid / 128;
  int blk = blockIdx.x;
  const int w0 = blk % q.wblocks * q.wt;
  blk /= q.wblocks;
  const int h0 = blk % q.hblocks * q.th;
  blk /= q.hblocks;
  const int d = blk % p.D, b = blk / p.D;
  const int n0 = blockIdx.y * BN;
  const int stages = 3 * q.chunks;  // (kd, 16-channel chunk)
  if (tid == 0) {
    for (int i = 0; i < q.stages; ++i) {
      wft::mbar_init(full + i, 1);
      wft::mbar_init(empty + i, WGS * 128);
    }
    wft::mbar_init_fence();
  }
  __syncthreads();

  if (wg == WGS) {  // the producer warp: one thread issues every copy
    if (tid == WGS * 128) {
      for (int s = 0; s < stages; ++s) {
        const int slot = s % q.stages, kd = s / q.chunks, c0 = s % q.chunks * 16;
        if (s >= q.stages) wft::mbar_wait(empty + slot, (s / q.stages - 1) & 1);
        uint8_t* st = smem + slot * q.stage_bytes;
        wft::mbar_arrive_expect_tx(full + slot,
                                   q.main_bytes + 2 * q.halo_bytes + 9 * BN * 32);
        // input rows h0 − 1 … h0 + th of plane d + kd − 1, channels c0 …;
        // TMA fills zeros outside the volume and past C. W starts must be
        // 16-byte aligned: the main box at w0, the halos at w0 − 8, w0 + wt
        wft::tma_load_5d(st, &xmap, full + slot, w0, c0, h0 - 1, d + kd - 1, b);
        wft::tma_load_5d(st + q.main_bytes, &hmap, full + slot, w0 - 8, c0, h0 - 1, d + kd - 1, b);
        wft::tma_load_5d(st + q.main_bytes + q.halo_bytes, &hmap, full + slot, w0 + q.wt, c0,
                         h0 - 1, d + kd - 1, b);
        wft::tma_load_3d(st + q.main_bytes + 2 * q.halo_bytes, &wmap, full + slot, 0, n0,
                         (c0 / 16 * 3 + kd) * 9);
      }
    }
    return;
  }

  // a consumer warpgroup: M tiles wg·MT …; warp `warp` owns voxels 16·warp …
  // of each, i.e. box row r_o + kh at w offset wb for tap row kh
  const int lt = tid % 128, warp = lt / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const uint32_t span = 2 * q.wt;
  // ldmatrix lanes: matrix i = lane / 8, its row j = lane % 8 is channel
  // j + 8·(i / 2) (main: voxels +8·(i % 2)) or j + 8·(i % 2) (halo: prev/next)
  const int li = lane / 8, lj = lane % 8;
  const int main_k = lj + 8 * (li / 2), main_v = 8 * (li % 2);
  const int halo_k = lj + 8 * (li % 2);
  const bool halo_next = li >= 2;
  const int up = (lane + 28) & 31, down = (lane + 4) & 31;  // lanes of g − 1, g + 1
  float acc[MT][BN / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;
  // the three kw fragments of each kh: a set is rebuilt three groups after
  // its last use, and one group stays in flight
  uint32_t frag[3][3][4];

  for (int s = 0; s < stages; ++s) {
    const int slot = s % q.stages;
    wft::mbar_wait(full + slot, (s / q.stages) & 1);
    const uint8_t* main_p = smem + slot * q.stage_bytes;
    const uint8_t* left_p = main_p + q.main_bytes;
    const uint8_t* right_p = left_p + q.halo_bytes;
    const uint32_t b_addr = wft::smem_u32(right_p + q.halo_bytes);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int vox = (wg * MT + mt) * 64 + warp * 16;
      const int r_o = vox / q.wt, wb = vox % q.wt;
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const int row = r_o + kh;
        uint32_t a[4], h[4];
        // kw = 1: voxels wb … wb + 15 (ldmatrix.trans: lane (g, t) gets
        // voxel g, channels 2t, 2t + 1 of each 8 × 8 matrix)
        wft::ldmatrix_x4_trans(
            a, main_p + swizzled((row * 16 + main_k) * span + (wb + main_v) * 2, span));
        // prev (wb − 8 …) and next (wb + 16 …) 8 voxels, from the halo boxes
        // at the W tile's ends
        const uint8_t* ha;
        if (!halo_next) {
          ha = wb == 0 ? left_p + (row * 16 + halo_k) * 16
                       : main_p + swizzled((row * 16 + halo_k) * span + (wb - 8) * 2, span);
        } else {
          ha = wb + 16 == q.wt
                   ? right_p + (row * 16 + halo_k) * 16
                   : main_p + swizzled((row * 16 + halo_k) * span + (wb + 16) * 2, span);
        }
        wft::ldmatrix_x4_trans(h, ha);
        uint32_t(&f)[3][4] = frag[kh];
#pragma unroll
        for (int i = 0; i < 4; ++i) f[1][i] = a[i];
        // kw = 0: voxel m − 1, from lane g − 1 (g = 0: the previous 8 voxels' last)
        const uint32_t u0 = __shfl_sync(0xffffffffu, a[0], up);
        const uint32_t u1 = __shfl_sync(0xffffffffu, a[1], up);
        const uint32_t u2 = __shfl_sync(0xffffffffu, a[2], up);
        const uint32_t u3 = __shfl_sync(0xffffffffu, a[3], up);
        const uint32_t p0 = __shfl_sync(0xffffffffu, h[0], up);
        const uint32_t p1 = __shfl_sync(0xffffffffu, h[1], up);
        f[0][0] = g ? u0 : p0;
        f[0][1] = g ? u1 : u0;
        f[0][2] = g ? u2 : p1;
        f[0][3] = g ? u3 : u2;
        // kw = 2: voxel m + 1, from lane g + 1 (g = 7: the next 8 voxels' first)
        const uint32_t v0 = __shfl_sync(0xffffffffu, a[0], down);
        const uint32_t v1 = __shfl_sync(0xffffffffu, a[1], down);
        const uint32_t v2 = __shfl_sync(0xffffffffu, a[2], down);
        const uint32_t v3 = __shfl_sync(0xffffffffu, a[3], down);
        const uint32_t n0v = __shfl_sync(0xffffffffu, h[2], down);
        const uint32_t n1v = __shfl_sync(0xffffffffu, h[3], down);
        f[2][0] = g < 7 ? v0 : v1;
        f[2][1] = g < 7 ? v1 : n0v;
        f[2][2] = g < 7 ? v2 : v3;
        f[2][3] = g < 7 ? v3 : n1v;
        wft::wgmma_fence();
        wft::fence_regs(acc[mt]);
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          // B: tap (kh, kw)'s weights, K-major (n rows of 16 channels, 32-byte swizzle)
          const uint64_t db = wft::wgmma_desc(b_addr + (kh * 3 + kw) * BN * 32, 16, 256,
                                              wft::kSwizzle32);
          wft::WgmmaRS<BN>::template run<0>(acc[mt], f[kw], db, 1);
        }
        wft::wgmma_commit();
        wft::fence_regs(acc[mt]);
        // the group before this one is done: its fragment set is free, and
        // after a stage's first group the previous stage's weights are too
        wft::wgmma_wait<1>();
        if (s > 0 && mt == 0 && kh == 0) wft::mbar_arrive(empty + (s - 1) % q.stages);
      }
    }
  }
  wft::wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) wft::fence_regs(acc[mt]);

  // the bf16 tile, [n][voxel], in the ring once every warpgroup is done
  wft::named_bar_sync(1, WGS * 128);
  bf16* cs = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int v = (wg * MT + mt) * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = 8 * j + 2 * t;
      cs[n * kCS + v] = __float2bfloat16(acc[mt][4 * j]);
      cs[(n + 1) * kCS + v] = __float2bfloat16(acc[mt][4 * j + 1]);
      cs[n * kCS + v + 8] = __float2bfloat16(acc[mt][4 * j + 2]);
      cs[(n + 1) * kCS + v + 8] = __float2bfloat16(acc[mt][4 * j + 3]);
    }
  }
  wft::named_bar_sync(1, WGS * 128);
  // 16-byte stores along W: voxel v = r·wt + w of the block is (h0 + r, w0 + w)
  bf16* y = static_cast<bf16*>(p.y);
  const int vecs = q.wt / 8;
  for (int e = tid; e < BN * q.th * vecs; e += WGS * 128) {
    const int c8 = e % vecs, r = e / vecs % q.th, n = e / (vecs * q.th);
    const int h = h0 + r, w = w0 + 8 * c8;
    if (n0 + n >= p.O || h >= p.H || w >= p.W) continue;
    *reinterpret_cast<uint4*>(y + ((((long long)b * p.D + d) * p.H + h) * p.O + n0 + n) * p.W + w) =
        *reinterpret_cast<const uint4*>(cs + n * kCS + r * q.wt + 8 * c8);
  }
}

template <int BN>
cudaError_t launch_tma_bn(const Params& p, cudaStream_t stream) {
  TmaTiles q;
  q.wt = p.W <= 16 ? 16 : p.W <= 32 ? 32 : 64;
  q.th = tma_wgs<BN>() * tma_mt<BN>() * 64 / q.wt;
  q.wblocks = (p.W + q.wt - 1) / q.wt;
  q.hblocks = (p.H + q.th - 1) / q.th;
  q.chunks = (p.C + 15) / 16;
  q.main_bytes = (q.th + 2) * 16 * q.wt * 2;
  q.halo_bytes = (q.th + 2) * 16 * 8 * 2;
  q.stage_bytes = (q.main_bytes + 2 * q.halo_bytes + 9 * BN * 32 + 1023) / 1024 * 1024;
  q.stages = (kSmemMax - 1024 - 4 * 16) / q.stage_bytes;
  if (q.stages > 4) q.stages = 4;
  if (q.stages < 2) return cudaErrorInvalidValue;
  const size_t smem = (size_t)q.stages * q.stage_bytes + q.stages * 16 + 1024;
  // x as (W, C, H, D, B): D and B apart, so plane −1 of an instance is zero
  CUtensorMap xmap, hmap, wmap;
  const uint64_t row = (uint64_t)p.W * 2;
  const uint64_t xdims[5] = {(uint64_t)p.W, (uint64_t)p.C, (uint64_t)p.H, (uint64_t)p.D,
                             (uint64_t)p.B};
  const uint64_t xstr[4] = {row, row * p.C, row * p.C * p.H, row * p.C * p.H * p.D};
  const uint32_t xbox[5] = {(uint32_t)q.wt, 16, (uint32_t)q.th + 2, 1, 1};
  cudaError_t err =
      wft::make_map_bf16(&xmap, p.x, 5, xdims, xstr, xbox, wft::swizzle_for(2 * q.wt));
  if (err != cudaSuccess) return err;
  const uint32_t hbox[5] = {8, 16, (uint32_t)q.th + 2, 1, 1};  // 16-byte rows, unswizzled
  err = wft::make_map_bf16(&hmap, p.x, 5, xdims, xstr, hbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  // weights as (16 channels, O, 27·chunks taps) of the per-tap packing
  const uint64_t wdims[3] = {16, (uint64_t)p.O, (uint64_t)27 * q.chunks};
  const uint64_t wstr[2] = {32, (uint64_t)p.O * 32};
  const uint32_t wbox[3] = {16, BN, 9};
  err = wft::make_map_bf16(&wmap, p.w, 3, wdims, wstr, wbox, CU_TENSOR_MAP_SWIZZLE_32B);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv3_tma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)p.B * p.D * q.hblocks * q.wblocks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (p.O + BN - 1) / BN);
  conv3_tma_kernel<BN><<<grid, tma_threads<BN>(), smem, stream>>>(xmap, hmap, wmap, p, q);
  return cudaGetLastError();
}

// Output channels per block: the narrowest wgmma width that covers O ≤ 48,
// else 96 (192 → 2 × 96).
cudaError_t launch_tma(const Params& p, cudaStream_t stream) {
  if (p.O <= 16) return launch_tma_bn<16>(p, stream);
  if (p.O <= 32) return launch_tma_bn<32>(p, stream);
  if (p.O <= 48) return launch_tma_bn<48>(p, stream);
  return launch_tma_bn<96>(p, stream);
}

// ---------------------------------------------------------------------------
// bf16, DHWC, C % 8 == 0: TMA + wgmma with A read from shared memory (see
// the header).

constexpr int kClWgs = 2;                      // consumer warpgroups
constexpr int kClThreads = kClWgs * 128 + 32;  // and one producer warp

// M tiles of 64 voxels per consumer warpgroup: 96 fp32 accumulators a thread
// at BN = 48 and at BN = 96.
__host__ __device__ constexpr int cl_mt(int BN) { return BN <= 48 ? 4 : 2; }

// 16-byte halo pieces a consumer thread normalises per stage, at most: the
// halo with the most cells is the narrowest, (8·2·MT + 2) × (8 + 2).
__host__ __device__ constexpr int cl_pieces(int BN) {
  return (2 * (16 * cl_mt(BN) + 2) * 10 + kClWgs * 128 - 1) / (kClWgs * 128);
}

struct ClTiles {
  int th, tw;       // output rows (h) and columns (w) of a block, multiples of 8
  int hblocks, wblocks, chunks;
  int stages;       // ring depth
  int box_bytes;    // the halo: (th + 2)·(tw + 2) voxels of 16 channels
  int stage_bytes;  // the nine taps' weights, then the halo; 1 KB multiple
  int tiles;        // blocks per instance: D·hblocks·wblocks
};

// Output channels per block: O rounded up to 8 up to 48, else 64 or 96
// (192 → 2 × 96: at 96 × 256 voxels a stage's weights and halo are 38 KB
// per 1,728 tensor clocks, against 61 KB at 192 × 128).
int cl_bn(int O) {
  if (O <= 48) return (O + 7) / 8 * 8;
  const int blocks = (O + 95) / 96, per = (O + blocks - 1) / blocks;
  return per <= 64 ? 64 : 96;
}

// Bytes after the ring: full and empty barriers, the warps' column sums
// [warp][2][BN], the prologue's mean and rstd.
size_t cl_extra_bytes(int stages, int BN, int C) {
  return (size_t)stages * 16 + (size_t)kClWgs * 4 * 2 * BN * 4 + (size_t)2 * C * 4;
}

// A block's 2·MT M tiles of 8 × 8 voxels, arranged (th / 8) × (tw / 8): the
// fewest padded voxels over the plane, then the fewest halo cells, then the
// widest rows.
ClTiles cl_tiles(int D, int H, int W, int C, int BN) {
  ClTiles q{};
  const int mtiles = kClWgs * cl_mt(BN);
  long long best_vox = -1, best_halo = 0;
  for (int tw8 = 1; tw8 <= mtiles; tw8 *= 2) {
    const int th = 8 * (mtiles / tw8), tw = 8 * tw8;
    const long long blocks = (long long)((H + th - 1) / th) * ((W + tw - 1) / tw);
    const long long vox = blocks * th * tw, halo = blocks * (th + 2) * (tw + 2);
    if (best_vox < 0 || vox < best_vox || (vox == best_vox && halo <= best_halo)) {
      best_vox = vox, best_halo = halo, q.th = th, q.tw = tw;
    }
  }
  q.hblocks = (H + q.th - 1) / q.th;
  q.wblocks = (W + q.tw - 1) / q.tw;
  q.chunks = (C + 15) / 16;
  q.box_bytes = (q.th + 2) * (q.tw + 2) * 32;
  q.stage_bytes = (9 * BN * 32 + q.box_bytes + 1023) / 1024 * 1024;
  q.stages = 4;
  while (q.stages >= 2 &&
         1024 + (size_t)q.stages * q.stage_bytes + cl_extra_bytes(q.stages, BN, C) > kSmemMax) {
    --q.stages;
  }
  q.tiles = D * q.hblocks * q.wblocks;
  return q;
}

// The A operand of an M tile for one tap, straight from the halo: the halo
// is [th + 2][tw + 2][16 channels], one 32-byte row per voxel with the
// 32-byte swizzle, so 8 w-neighbours are one 8-row atom of the K-major
// layout and the next h-row's 8 are `row_cells`·32 bytes on (sbo). `cell`
// is the halo cell of the tile's first voxel shifted by the tap: cell0 +
// kh·row_cells + kw. Any 32-byte step of the start is legal: the swizzle
// follows the address bits, as TMA wrote them (a card test holds it).
__device__ __forceinline__ uint64_t cl_desc_a(uint32_t halo, int cell, int row_cells) {
  return wft::wgmma_desc(halo + cell * 32, 16, row_cells * 32, wft::kSwizzle32);
}

// The B operand of tap j: BN rows of 16 channels (32 bytes), K-major, as TMA
// writes the per-tap packing with the 32-byte swizzle.
template <int BN>
__device__ __forceinline__ uint64_t cl_desc_b(uint32_t weights, int j) {
  return wft::wgmma_desc(weights + j * BN * 32, 16, 256, wft::kSwizzle32);
}

// kPro: the InstanceNorm prologue (p.mean, p.rstd set), compiled apart so
// that the conv alone carries none of its code in the main loop.
template <int BN, bool kPro>
__global__ void __launch_bounds__(kClThreads, 1)
    conv3_cl_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, Params p, ClTiles q) {
  using bf16 = __nv_bfloat16;
  constexpr int MT = cl_mt(BN), kConsumers = kClWgs * 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - wft::smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + q.stages * q.stage_bytes);
  uint64_t* empty = full + q.stages;
  float* red = reinterpret_cast<float*>(empty + q.stages);  // [warp][2][BN]
  float* mean_s = red + kClWgs * 4 * 2 * BN;
  float* rstd_s = mean_s + p.C;
  const int tid = threadIdx.x, wg = tid / 128;
  const int b = blockIdx.x / p.tiles, tile = blockIdx.x % p.tiles;
  const int w0 = tile % q.wblocks * q.tw;
  const int h0 = tile / q.wblocks % q.hblocks * q.th;
  const int d = tile / (q.wblocks * q.hblocks);
  const int n0 = blockIdx.y * BN;
  const int stages = 3 * q.chunks;  // (kd, 16-channel chunk)
  if (tid == 0) {
    for (int i = 0; i < q.stages; ++i) {
      wft::mbar_init(full + i, 1);
      wft::mbar_init(empty + i, kConsumers);
    }
    wft::mbar_init_fence();
  }
  if (kPro) {
    for (int c = tid; c < p.C; c += kClThreads) {
      mean_s[c] = p.mean[(long long)b * p.C + c];
      rstd_s[c] = p.rstd[(long long)b * p.C + c];
    }
  }
  __syncthreads();

  if (wg == kClWgs) {  // the producer warp: one thread issues every copy
    if (tid == kConsumers) {
      for (int s = 0; s < stages; ++s) {
        const int slot = s % q.stages, kd = s / q.chunks, c0 = s % q.chunks * 16;
        if (s >= q.stages) wft::mbar_wait_or_trap(empty + slot, (s / q.stages - 1) & 1);
        uint8_t* st = smem + slot * q.stage_bytes;
        uint8_t* halo = st + 9 * BN * 32;
        wft::mbar_arrive_expect_tx(full + slot, 9 * BN * 32 + q.box_bytes);
        wft::tma_load_3d(st, &wmap, full + slot, 0, n0, (c0 / 16 * 3 + kd) * 9);
        // input cells (h0 − 1 …, w0 − 1 …) of plane d + kd − 1: TMA fills
        // zeros outside the volume (the SAME padding) and past C
        wft::tma_load_5d(halo, &xmap, full + slot, c0, w0 - 1, h0 - 1, d + kd - 1, b);
      }
    }
    return;
  }

  // a consumer warpgroup: M tiles wg·MT … of the block's (th / 8) × (tw / 8)
  // grid; row m = 8r + c of tile (mh, mw) is output voxel (h0 + 8·mh + r,
  // w0 + 8·mw + c), which reads halo cell (8·mh + r + kh, 8·mw + c + kw)
  const int lt = tid % 128, warp = lt / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int tw8 = q.tw / 8, row_cells = q.tw + 2;
  int cell0[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int mi = wg * MT + i;
    cell0[i] = 8 * (mi / tw8) * row_cells + 8 * (mi % tw8);
  }
  float acc[MT][BN / 2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) acc[i][k] = 0.f;

  // the prologue's pieces of this thread, the same in every stage: piece k
  // is 8-channel half e % 2 = tid % 2 of halo cell e / 2, e = tid + 256·k,
  // at byte offset off[k] of the stage's halo (swizzled), or −1 where its
  // voxel lies outside the plane (H × W) or past the halo
  constexpr int kPieces = cl_pieces(BN);
  int off[kPieces];
  {
    const int cells = (q.th + 2) * row_cells;
#pragma unroll
    for (int k = 0; k < kPieces; ++k) {
      const int e = tid + kConsumers * k, cell = e / 2;
      const int h = h0 - 1 + cell / row_cells, w = w0 - 1 + cell % row_cells;
      const bool in = e < 2 * cells && h >= 0 && h < p.H && w >= 0 && w < p.W;
      off[k] = in ? (int)swizzled(16 * e, 32) : -1;
    }
  }
  // the prologue on stage s in place: in-volume cells only, so the SAME halo
  // (TMA's zero fill) stays zero; rounded to bf16 once
  auto normalise = [&](int s) {
    const int kd = s / q.chunks, c0 = s % q.chunks * 16;
    const int dd = d + kd - 1;
    const int c = c0 + 8 * (tid % 2);  // this thread's 8 channels
    if (dd < 0 || dd >= p.D || c >= p.C) return;
    const float4* m4 = reinterpret_cast<const float4*>(mean_s + c);
    const float4* r4 = reinterpret_cast<const float4*>(rstd_s + c);
    const float4 m[2] = {m4[0], m4[1]}, r[2] = {r4[0], r4[1]};
    uint8_t* halo = smem + (s % q.stages) * q.stage_bytes + 9 * BN * 32;
    // pieces in groups of kGroup: loaded, then computed, then stored (offset
    // 0 stands in for one outside, which is not stored), so a group's loads
    // do not wait for the stores before them; groups of 3 keep BN = 48 in
    // 168 registers
    constexpr int kGroup = 3;
#pragma unroll
    for (int k0 = 0; k0 < kPieces; k0 += kGroup) {
      uint4 raw[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup && k0 + k < kPieces; ++k) {
        const int o = off[k0 + k];
        raw[k] = *reinterpret_cast<const uint4*>(halo + (o < 0 ? 0 : o));
      }
#pragma unroll
      for (int k = 0; k < kGroup && k0 + k < kPieces; ++k) {
        __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&raw[k]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 a = __bfloat1622float2(x2[2 * i]), b = __bfloat1622float2(x2[2 * i + 1]);
          float z[4] = {(a.x - m[i].x) * r[i].x, (a.y - m[i].y) * r[i].y,
                        (b.x - m[i].z) * r[i].z, (b.y - m[i].w) * r[i].w};
          if (p.act) {
#pragma unroll
            for (int j = 0; j < 4; ++j) z[j] = fmaxf(z[j], z[j] * kNegSlope);  // LeakyReLU
          }
          x2[2 * i] = __floats2bfloat162_rn(z[0], z[1]);
          x2[2 * i + 1] = __floats2bfloat162_rn(z[2], z[3]);
        }
      }
#pragma unroll
      for (int k = 0; k < kGroup && k0 + k < kPieces; ++k) {
        if (off[k0 + k] >= 0) *reinterpret_cast<uint4*>(halo + off[k0 + k]) = raw[k];
      }
    }
  };

  // stage s has landed (and, with the prologue, this thread's part of it is
  // normalised and ordered before the async proxy's reads)
  auto ready = [&](int s) {
    wft::mbar_wait_or_trap(full + s % q.stages, (s / q.stages) & 1);
    if (kPro) {
      normalise(s);
      wft::fence_proxy_async();
    }
  };

  if (kPro) {
    ready(0);
    wft::named_bar_sync(1, kConsumers);
  }
  for (int s = 0; s < stages; ++s) {
    if (!kPro) ready(s);
    const uint32_t st = wft::smem_u32(smem + (s % q.stages) * q.stage_bytes);
    const uint32_t halo = st + 9 * BN * 32;
    wft::wgmma_fence();
#pragma unroll
    for (int i = 0; i < MT; ++i) wft::fence_regs(acc[i]);
#pragma unroll
    for (int j = 0; j < 9; ++j) {  // tap (kh, kw) = (j / 3, j % 3)
      const uint64_t db = cl_desc_b<BN>(st, j);
      const int shift = j / 3 * row_cells + j % 3;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        wft::Wgmma<BN>::template run<0, 0>(acc[i], cl_desc_a(halo, cell0[i] + shift, row_cells),
                                           db, 1);
      }
    }
    wft::wgmma_commit();
#pragma unroll
    for (int i = 0; i < MT; ++i) wft::fence_regs(acc[i]);
    // the group of stage s − 1 is done: its slot goes back to the producer
    wft::wgmma_wait<1>();
    if (s > 0) wft::mbar_arrive(empty + (s - 1) % q.stages);
    if (kPro) {
      // normalise stage s + 1 while the products of stage s run
      if (s + 1 < stages) ready(s + 1);
      wft::named_bar_sync(1, kConsumers);
    }
  }
  wft::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < MT; ++i) wft::fence_regs(acc[i]);

  // accumulator rows 16·warp + g and + 8 of tile i: voxel rows 2·warp and
  // 2·warp + 1 of the tile, column g; rows past H or W are not outputs
  bool ok0[MT], ok1[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int mi = wg * MT + i;
    const int h = h0 + 8 * (mi / tw8) + 2 * warp, w = w0 + 8 * (mi % tw8) + g;
    ok0[i] = h < p.H && w < p.W;
    ok1[i] = h + 1 < p.H && w < p.W;
  }
  const bool stats = p.partial != nullptr;
  if (stats) {
    // column sums of acc and acc², in a fixed order: the thread's rows, the
    // 8 lanes of a column (xor over g), then the warps in order
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float v0 = acc[i][4 * j + e], v1 = acc[i][4 * j + 2 + e];
          if (ok0[i]) s1 += v0, s2 = fmaf(v0, v0, s2);
          if (ok1[i]) s1 += v1, s2 = fmaf(v1, v1, s2);
        }
#pragma unroll
        for (int off = 4; off < 32; off *= 2) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        }
        if (g == 0) {
          float* r = red + (wg * 4 + warp) * 2 * BN + 8 * j + 2 * t + e;
          r[0] = s1;
          r[BN] = s2;
        }
      }
  }
  wft::named_bar_sync(1, kConsumers);  // every warpgroup is done with the ring
  if (stats) {
    for (int n = tid; n < BN; n += kConsumers) {
      if (n0 + n >= p.O) continue;
      float s1 = 0.f, s2 = 0.f;
      for (int w = 0; w < kClWgs * 4; ++w) {
        s1 += red[w * 2 * BN + n];
        s2 += red[w * 2 * BN + BN + n];
      }
      float* dst = p.partial + (((long long)b * 2) * p.O + n0 + n) * p.tiles + tile;
      dst[0] = s1;
      dst[(long long)p.O * p.tiles] = s2;
    }
  }
  // the bf16 tile, [voxel][n] with rows of BN + 8, in the ring
  constexpr int kCS = BN + 8;
  bf16* cs = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int v = (wg * MT + i) * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = 8 * j + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(cs + v * kCS + n) =
          __floats2bfloat162_rn(acc[i][4 * j], acc[i][4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(cs + (v + 8) * kCS + n) =
          __floats2bfloat162_rn(acc[i][4 * j + 2], acc[i][4 * j + 3]);
    }
  }
  wft::named_bar_sync(1, kConsumers);
  // 16-byte stores along C (elementwise where O % 8 != 0)
  bf16* y = static_cast<bf16*>(p.y);
  constexpr int kVecs = BN / 8;
  for (int e = tid; e < kClWgs * MT * 64 * kVecs; e += kConsumers) {
    const int v = e / kVecs, c8 = e % kVecs;
    const int mi = v / 64, m = v % 64;
    const int h = h0 + 8 * (mi / tw8) + m / 8, w = w0 + 8 * (mi % tw8) + m % 8;
    const int n = n0 + 8 * c8;
    if (h >= p.H || w >= p.W || n >= p.O) continue;
    bf16* dst = y + ((((long long)b * p.D + d) * p.H + h) * p.W + w) * p.O + n;
    const bf16* src = cs + v * kCS + 8 * c8;
    if (p.O % 8 == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int k = 0; k < 8 && n + k < p.O; ++k) dst[k] = src[k];
    }
  }
}

template <int BN, bool kPro>
cudaError_t launch_cl_kernel(const Params& p, cudaStream_t stream) {
  const ClTiles q = cl_tiles(p.D, p.H, p.W, p.C, BN);
  // the staged bf16 tile must fit the ring
  const size_t tile_bytes = (size_t)kClWgs * cl_mt(BN) * 64 * (BN + 8) * 2;
  if (q.stages < 2 || q.tiles != p.tiles || tile_bytes > (size_t)q.stages * q.stage_bytes) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = 1024 + (size_t)q.stages * q.stage_bytes + cl_extra_bytes(q.stages, BN, p.C);
  // x as (C, W, H, D, B): D and B apart, so plane −1 of an instance is zero;
  // C % 8 == 0 makes every stride a multiple of 16 bytes, as TMA needs
  CUtensorMap xmap, wmap;
  const uint64_t row = (uint64_t)p.C * 2;
  const uint64_t xdims[5] = {(uint64_t)p.C, (uint64_t)p.W, (uint64_t)p.H, (uint64_t)p.D,
                             (uint64_t)p.B};
  const uint64_t xstr[4] = {row, row * p.W, row * p.W * p.H, row * p.W * p.H * p.D};
  const uint32_t xbox[5] = {16, (uint32_t)q.tw + 2, (uint32_t)q.th + 2, 1, 1};
  cudaError_t err =
      wft::make_map_bf16(&xmap, p.x, 5, xdims, xstr, xbox, CU_TENSOR_MAP_SWIZZLE_32B);
  if (err != cudaSuccess) return err;
  // weights as (16 channels, O, 27·chunks taps) of the per-tap packing
  const uint64_t wdims[3] = {16, (uint64_t)p.O, (uint64_t)27 * q.chunks};
  const uint64_t wstr[2] = {32, (uint64_t)p.O * 32};
  const uint32_t wbox[3] = {16, BN, 9};
  err = wft::make_map_bf16(&wmap, p.w, 3, wdims, wstr, wbox, CU_TENSOR_MAP_SWIZZLE_32B);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv3_cl_kernel<BN, kPro>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((long long)p.B * p.tiles), (p.O + BN - 1) / BN);
  conv3_cl_kernel<BN, kPro><<<grid, kClThreads, smem, stream>>>(xmap, wmap, p, q);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_cl_bn(const Params& p, cudaStream_t stream) {
  return p.mean != nullptr ? launch_cl_kernel<BN, true>(p, stream)
                           : launch_cl_kernel<BN, false>(p, stream);
}

cudaError_t launch_cl(const Params& p, cudaStream_t stream) {
  switch (cl_bn(p.O)) {
    case 8: return launch_cl_bn<8>(p, stream);
    case 16: return launch_cl_bn<16>(p, stream);
    case 24: return launch_cl_bn<24>(p, stream);
    case 32: return launch_cl_bn<32>(p, stream);
    case 40: return launch_cl_bn<40>(p, stream);
    case 48: return launch_cl_bn<48>(p, stream);
    case 64: return launch_cl_bn<64>(p, stream);
    default: return launch_cl_bn<96>(p, stream);
  }
}

// One m64n16k16 product as conv3_cl_kernel issues it for one tap: A from a
// halo image [rows][row_cells][16] at `cell`, written with the 32-byte
// swizzle as TMA writes it; B the first 16 rows of a per-tap packing box; out
// (64, 16) fp32. For the card test of the descriptors.
__global__ void __launch_bounds__(128) conv3_cl_probe_kernel(const __nv_bfloat16* halo,
                                                             const __nv_bfloat16* wt,
                                                             float* out, int rows,
                                                             int row_cells, int cell) {
  __shared__ __align__(1024) uint8_t sm[1024 + 16384];
  const int tid = threadIdx.x;
  for (int e = tid; e < rows * row_cells * 2; e += 128) {
    *reinterpret_cast<uint4*>(sm + 1024 + swizzled(16 * e, 32)) =
        reinterpret_cast<const uint4*>(halo)[e];
  }
  for (int e = tid; e < 16 * 2; e += 128) {  // 16 rows of 32 bytes
    *reinterpret_cast<uint4*>(sm + swizzled(16 * e, 32)) = reinterpret_cast<const uint4*>(wt)[e];
  }
  wft::fence_proxy_async();
  __syncthreads();
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const uint32_t base = wft::smem_u32(sm);
  wft::wgmma_fence();
  wft::Wgmma<16>::run<0, 0>(acc, cl_desc_a(base + 1024, cell, row_cells), cl_desc_b<16>(base, 0),
                            0);
  wft::wgmma_commit();
  wft::wgmma_wait<0>();
  wft::fence_regs(acc);
  const int warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float* r0 = out + (16 * warp + g) * 16 + 8 * j + 2 * t;
    r0[0] = acc[4 * j];
    r0[1] = acc[4 * j + 1];
    r0[8 * 16] = acc[4 * j + 2];
    r0[8 * 16 + 1] = acc[4 * j + 3];
  }
}

// ---------------------------------------------------------------------------
// Dispatch: depends on the dtype, the layout and the shape only.

enum Design : int { kHaloMma = 0, kPlain = 1, kTmaWgmma = 2, kTmaWgmmaCl = 3 };

// C % 8 == 0 for the channels-last TMA design: a map's strides must be
// multiples of 16 bytes, and at C = 4 the W stride is 8. The flagship's one
// C = 4 conv (encoder1 conv1, 128³·4 → 48) moves bytes, not products, and the
// halo kernel already beats cuDNN there.
int design_of(int dtype, int layout, int W, int C) {
  if (dtype == wft::kBFloat16 && layout == kDHWC && C % 8 == 0) return kTmaWgmmaCl;
  if (dtype == wft::kBFloat16 && layout == kDHWC && C % 4 == 0) return kHaloMma;
  if (dtype == wft::kBFloat16 && layout == kDHCW && W % 8 == 0) return kTmaWgmma;
  return kPlain;
}

long long tiles_of(int dtype, int layout, int D, int H, int W, int C, int O) {
  const int design = design_of(dtype, layout, W, C);
  if (design == kHaloMma) return (long long)D * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  if (design == kTmaWgmmaCl) return cl_tiles(D, H, W, C, cl_bn(O)).tiles;
  return ((long long)D * H * W + kBM - 1) / kBM;
}

}  // namespace

// The design wft_conv3 launches for these arguments: 0 = the halo-tile
// mma.sync kernel, 1 = the plain kernel, 2 = the (D, H, C, W) TMA + wgmma
// kernel, 3 = the channels-last TMA + wgmma kernel.
extern "C" int wft_conv3_design(int dtype, int layout, int W, int C) {
  return design_of(dtype, layout, W, C);
}

// Blocks per instance along the volume for these arguments (DHWC, where
// the statistics are): the scratch `partial` of wft_conv3 holds
// B·2·O·tiles floats.
extern "C" long long wft_conv3_tiles(int dtype, int layout, int D, int H, int W, int C, int O) {
  return tiles_of(dtype, layout, D, H, W, C, O);
}

// Returns a cudaError_t (0 on success). For designs 0 and 1, `w` is
// (ceil(O / 64)·64, K8) in the input dtype, K8 = 27·C rounded up to 8, row n
// holding output channel n's taps at k = tap·C + c (tap = (kd·3 + kh)·3 +
// kw), zero elsewhere. For designs 2 and 3, `w` is the per-tap packing
// (ceil(C / 16), 3, 9, O, 16) bf16: [chunk, kd, kh·3 + kw, n, c − 16·chunk],
// zero past C.
// `mean`/`rstd` (B, C) fp32 turn the prologue on (DHWC only); `partial`
// (B·2·O·tiles) and `stats` (B, 2, O) fp32 turn the statistics on (DHWC
// only). All pointers must be 16-byte aligned.
extern "C" int wft_conv3(int dtype, int layout, const void* x, const void* w,
                         const void* mean, const void* rstd, int act, void* y,
                         void* partial, void* stats, int B, int D, int H, int W, int C,
                         int O, void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || C < 1 || O < 1) return (int)cudaErrorInvalidValue;
  if (layout != kDHWC && (mean != nullptr || stats != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((mean == nullptr) != (rstd == nullptr) || (partial == nullptr) != (stats == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int design = design_of(dtype, layout, W, C);
  const long long tiles = tiles_of(dtype, layout, D, H, W, C, O);
  if ((long long)B * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Params p{x, w, static_cast<const float*>(mean), static_cast<const float*>(rstd), y,
           static_cast<float*>(partial), B, D, H, W, C, O, (int)tiles, act,
           (27 * C + 7) / 8 * 8};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (design == kTmaWgmmaCl) {
    err = launch_cl(p, s);
  } else if (design == kHaloMma) {
    err = launch_halo(p, s);
  } else if (design == kTmaWgmma) {
    err = launch_tma(p, s);
  } else if (dtype == wft::kFloat32) {
    err = layout == kDHWC ? launch<float, kDHWC>(p, s) : launch<float, kDHCW>(p, s);
  } else {
    err = layout == kDHWC ? launch<__nv_bfloat16, kDHWC>(p, s)
                          : launch<__nv_bfloat16, kDHCW>(p, s);
  }
  if (err != cudaSuccess || stats == nullptr) return (int)err;
  stats_reduce_kernel<<<(unsigned)(B * 2 * O), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(stats), (int)tiles);
  return (int)cudaGetLastError();
}

// One tap's wgmma of the channels-last TMA design (conv3_cl_probe_kernel),
// for the card test of its shared-memory descriptors. Returns a cudaError_t.
extern "C" int wft_conv3_cl_probe(const void* halo, const void* w, void* out, int rows,
                                  int row_cells, int cell, void* stream) {
  if (rows * row_cells * 32 > 16384 || cell < 0 ||
      cell + 7 * row_cells + 8 > rows * row_cells) {
    return (int)cudaErrorInvalidValue;
  }
  conv3_cl_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(halo), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(out), rows, row_cells, cell);
  return (int)cudaGetLastError();
}
