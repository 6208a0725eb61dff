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
// (0.5 ms); with C = 4 (the first encoder block) it is bytes. Two designs,
// chosen from the dtype, the layout and C (wgmma/TMA are later work):
//
// `conv3_halo_kernel` (bf16, DHWC, C % 4 == 0: every conv of the model): a
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
// `conv3_kernel` (fp32, the DHCW layout, C % 4 != 0): the first design, one
// tap × 16 channels per chunk, 64 voxels per 4-warp block, loads through
// registers with zero-fill past C; bf16 on mma.sync, fp32 as an FMA loop
// (one row × NT·4 columns per thread).
//
// Both: the tensor cores' fp32 sums are not rounded to nearest, so each
// chunk goes into a fresh fragment that is added to an IEEE fp32 total
// (the error does not grow with K). The fp32 tile goes through shared
// memory for the store and the statistics: each block writes its column
// sums of acc and acc² (rows in order) to a scratch array, and a second
// kernel adds the blocks of an instance in a fixed order, so two calls give
// bit-identical statistics (no fp32 atomics). No padded copy of the input
// goes to device memory (the TPU kernels' pads of W and C are TPU tiling).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBM = 64;        // output voxels per block
constexpr int kBK = 16;        // K-chunk: one tap × 16 input channels
constexpr int kThreads = 128;  // 4 warps
constexpr int kAK = kBK + 8;   // bf16 row stride of the A/B tiles: conflict-free fragments
constexpr float kNegSlope = 0.01f;

enum Layout : int { kDHWC = 0, kDHCW = 1 };

struct Params {
  const void* x;      // (B, D, H, W, C) or (B, D, H, C, W)
  const void* w;      // (Opad, kstride), k = tap·C + c, zero-padded, input dtype
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

// Four (x4) or two (x2) 8×8 bf16 matrices from shared memory, one row
// address per lane (lanes 0-7 the first matrix, 8-15 the second, ...).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(s));
}

// V consecutive bf16 ↔ fp32 (V = 8: 16 bytes, V = 4: 8 bytes).
template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float* o) {
  if constexpr (V == 8) {
    wft::load8(p, o);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
}

template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 8) {
    wft::store8(p, v);
  } else {
    uint2 u;
    *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = u;
  }
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

// V: channels per copied piece (8 when C % 8 == 0, else 4). Stage s covers
// kd = s / chunks and input channels 16·(s % chunks) …; dynamic shared
// memory holds the 2-stage ring, then (prologue) mean and rstd of the
// instance's C channels; the ring holds the fp32 output tile at the end.
template <int V, int NT>
__global__ void __launch_bounds__(kHaloThreads, 2) conv3_halo_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int BN = NT * 8;
  constexpr int kStage = halo_stage_elems<NT>();
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
      wft::cp_async<V * 2, V != 8>(hs + cell * kHS + c - c0, ok ? x + off + c : x, ok);
    }
    // rows past O are zero in the padded weights; channels past C are zero-filled
    for (int e = tid; e < 9 * BN * kPieces; e += kHaloThreads) {
      const int j = e / (BN * kPieces), n = e / kPieces % BN, c = c0 + e % kPieces * V;
      const bool ok = c < p.C;
      wft::cp_async<V * 2, V != 8>(
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
      load_v<V>(q, z);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        z[i] = (z[i] - mean_s[c + i]) * rstd_s[c + i];
        if (p.act) z[i] = z[i] >= 0.f ? z[i] : z[i] * kNegSlope;
      }
      store_v<V>(q, z);
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
        ldmatrix_x4(r, ws + (j * BN + n * 8 + b_row) * kHS + b_k);
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
        ldmatrix_x4(af, hs + ((warp + j / 3) * (kTW + 2) + mt * 16 + a_col + j % 3) * kHS + a_k);
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

template <int V, int NT>
cudaError_t launch_halo_nt(const Params& p, cudaStream_t stream) {
  const size_t smem = halo_ring_bytes<NT>() + (p.mean ? 2 * sizeof(float) * p.C : 0);
  cudaError_t err = cudaFuncSetAttribute(
      conv3_halo_kernel<V, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((long long)p.B * p.tiles), (p.O + NT * 8 - 1) / (NT * 8));
  conv3_halo_kernel<V, NT><<<grid, kHaloThreads, smem, stream>>>(p);
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

template <int V>
cudaError_t launch_halo(const Params& p, cudaStream_t stream) {
  switch (pick_nt(p.O)) {
    case 1: return launch_halo_nt<V, 1>(p, stream);
    case 2: return launch_halo_nt<V, 2>(p, stream);
    case 4: return launch_halo_nt<V, 4>(p, stream);
    case 6: return launch_halo_nt<V, 6>(p, stream);
    default: return launch_halo_nt<V, 8>(p, stream);
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

bool use_halo(int dtype, int layout, int C) {
  return dtype == wft::kBFloat16 && layout == kDHWC && C % 4 == 0;
}

long long tiles_of(int dtype, int layout, int D, int H, int W, int C) {
  if (use_halo(dtype, layout, C)) {
    return (long long)D * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  }
  return ((long long)D * H * W + kBM - 1) / kBM;
}

}  // namespace

// Blocks per instance along the volume for these arguments: the scratch
// `partial` of wft_conv3 holds B·2·O·tiles floats.
extern "C" long long wft_conv3_tiles(int dtype, int layout, int D, int H, int W, int C) {
  return tiles_of(dtype, layout, D, H, W, C);
}

// Returns a cudaError_t (0 on success). `w` is (ceil(O / 64)·64, K8) in the
// input dtype, K8 = 27·C rounded up to 8, row n holding output channel n's
// taps at k = tap·C + c (tap = (kd·3 + kh)·3 + kw), zero elsewhere.
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
  const long long tiles = tiles_of(dtype, layout, D, H, W, C);
  if ((long long)B * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Params p{x, w, static_cast<const float*>(mean), static_cast<const float*>(rstd), y,
           static_cast<float*>(partial), B, D, H, W, C, O, (int)tiles, act,
           (27 * C + 7) / 8 * 8};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (use_halo(dtype, layout, C)) {
    err = C % 8 == 0 ? launch_halo<8>(p, s) : launch_halo<4>(p, s);
  } else if (dtype == wft::kFloat32) {
    err = layout == kDHWC ? launch<float, kDHWC>(p, s) : launch<float, kDHCW>(p, s);
  } else if (dtype == wft::kBFloat16) {
    err = layout == kDHWC ? launch<__nv_bfloat16, kDHWC>(p, s)
                          : launch<__nv_bfloat16, kDHCW>(p, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || stats == nullptr) return (int)err;
  stats_reduce_kernel<<<(unsigned)(B * 2 * O), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(stats), (int)tiles);
  return (int)cudaGetLastError();
}
