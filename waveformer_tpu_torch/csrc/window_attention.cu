// Fused window attention for Hopper: out = softmax(q·kᵀ·scale + bias_h
// [+ mask_w])·v.
//
// Replaces the TPU kernel waveformer_tpu/ops/attention_pallas.py
// (`window_attention`, `_kernel` :34-51). Shapes: q/k/v/out (BW, H, N, D)
// with any strides whose last dimension is contiguous; bias (H, N, N) fp32
// contiguous, shared by every window; any N from 1 to 1024 and D from 1 to
// 64. Scores, softmax and the PV sum are fp32; the probabilities are cast to
// the input dtype before PV, as the model's composition does
// (`models/attention.py:100-101`).
//
// Shifted windows (Swin's `compute_mask`): with `labels`, (nW, N) uint8 shift
// region labels of window `bw % nW` (row stride `lstride` ≥ N, the rows
// zero-padded to a multiple of 128 so that every key tile's pairs can be
// read without a bound check), the score of query i and key j gets −100
// added where labels[w, i] ≠ labels[w, j], in fp32 before the softmax, as
// MONAI adds its (nW, N, N) mask (−100, not −∞). The labels are a template
// flag of both designs: a launch without them compiles and runs the code it
// ran before they existed. nW·N bytes against the (nW, N, N) fp32 mask's
// nW·N²·4 (0.47 GB at Swin's stage 1).
//
// What bounds it: the exponentials. At the stage-1 call (512, 3, 512, 16)
// bf16 the kernel takes 512·3·512² = 4.03e8 exp2, ≈0.10 ms on the H100's
// special-function units (132 SMs × 16 a clock); the products need 0.026 ms
// of the bf16 tensor rate and the bytes (q/k/v/out 100.7 MB, bias 3.1 MB)
// 0.031 ms. So everything else is kept off the special-function pipe, and
// enough warps run at once to keep it busy. A block owns one (head, 64-query
// tile) at a time and keeps its 64 bias rows (≤ 133 KB fp32, pre-multiplied
// by log2 e) in shared memory across many windows, as the TPU kernel kept the
// bias block resident across its window-fastest grid.
//
// Two designs, chosen from the dtype and the shape only (`design_of`,
// queried by `wft_window_attention_design`):
//
// `tma_wgmma` (bf16, D ∈ {16, 32, 48, 64}, N ≤ 512: every call of the
// WaveFormer path): warp-specialised. Three consumer warpgroups at D = 16
// (two above, where a third K/V ring does not fit) share the block's bias
// rows; each takes its own windows of the block's work, and a
// producer warp keeps them fed with TMA loads from 4-D tensor maps over
// q/k/v as (D, N, H, BW). N and the window are separate dimensions, so the
// rows past N of a ragged window read zeros, never the next window. Every
// tile is loaded as D/16 boxes of 16 columns (32-byte rows, 32-byte swizzle):
// the Q tile (64 × D, a ring of 2 per consumer) and the K and V tiles (KT =
// 128 keys at D ≤ 32, 64 at D ≥ 48, a ring of 2-4 stages per consumer, full
// and empty mbarriers). Per key tile a consumer computes S = Q·Kᵀ on
// wgmma.m64nKTk16 (A = Q and B = K, both K-major in shared memory, D/16
// steps), then the online softmax in registers (scale, bias row, −∞ past N,
// quad-shuffle row max, ex2.approx in the log2 domain), packs P to bf16 in
// the A-fragment layout and adds P·V on wgmma.m64nDk16 with A from registers
// and B = the V tile read MN-major (the transpose bit: no transposed copy).
// One warpgroup's softmax overlaps the others' products. The grid has one
// block per SM (or as many as fit); block b walks items [b·per, (b+1)·per)
// of the (head, query tile)-major list of (head, query tile, window), so all
// SMs get equal work at every shape, and reloads the bias only where its
// range crosses to the next (head, query tile).
//
// `fma` (fp32, and bf16 at other D or N > 512): fp32 FMA loops. A block
// owns one (head, query tile of 8-64 rows, group of windows); it streams K/V
// in 64-key tiles through shared memory; four threads share a query row, each
// taking every fourth key, and their partial (max, sum, acc) states are
// merged with warp shuffles at the end. Rows, keys and head columns past N
// and D are masked; D % 8 != 0 loads element by element. Bias rows are padded
// to a stride ≡ 4 (mod 32) and K/V rows to D + 4 floats, so the 8 query rows
// × 4 keys a warp reads at once fall in 32 distinct banks.

#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskLog2 = -100.f * kLog2e;  // MONAI's −100, in the log2 domain
constexpr int kMaxN = 1024, kMaxD = 64;

enum Design : int { kFma = 0, kTmaWgmma = 1 };

int design_of(int dtype, int n, int d) {
  return dtype == wft::kBFloat16 && d % 16 == 0 && d <= 64 && n <= 512 ? kTmaWgmma : kFma;
}

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
  int bw, h, n, d;
  float qscale;  // scale · log2(e)
  int windows_per_block;  // fma design
  const uint8_t* labels;  // (n_win, lstride) shift-region labels, or null
  int n_win, lstride;
};

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// ---------------------------------------------------------------------------
// The fma design (see the header).

constexpr int kKeyTile = 64;    // keys per shared-memory tile
constexpr int kThreadsPerQ = 4;  // threads sharing one query row

// Bias row stride of the fma design: ≡ 4 (mod 32) floats, room for a tile
__host__ __device__ int fma_bias_stride(int n) {
  return (n + kKeyTile - 1) / kKeyTile * kKeyTile + 4;
}

// Up to 8 elements of one row as fp32: a 16-byte vector when `vec` and all 8
// are there, else element by element, zero from `count` on.
template <typename T>
__device__ __forceinline__ void load_upto8(const T* src, bool vec, int count, float* o) {
  if (vec && count >= 8) {
    wft::load8(src, o);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = i < count ? wft::to_f(src[i]) : 0.f;
}

template <typename T, int DP, bool kMasked>  // DP: D rounded up to 8
__global__ void __launch_bounds__(256) window_attention_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int qt = blockDim.x / kThreadsPerQ;  // query rows of this block
  const int n = p.n, d = p.d;
  const bool vec = d % 8 == 0;  // 16-byte rows (the wrapper aligns the views)
  const int bstride = fma_bias_stride(n);
  constexpr int kvstride = DP + 4;
  float* bias_s = smem;
  float* k_s = bias_s + qt * bstride;
  float* v_s = k_s + kKeyTile * kvstride;
  int* kl_s = reinterpret_cast<int*>(v_s + kKeyTile * kvstride);  // the key tile's labels

  const int head = blockIdx.y;
  const int q0 = blockIdx.x * qt;
  const int w0 = blockIdx.z * p.windows_per_block;
  const int w1 = min(w0 + p.windows_per_block, p.bw);
  const int tid = threadIdx.x;
  const int r = tid / kThreadsPerQ;
  const int sub = tid % kThreadsPerQ;
  const bool row_ok = q0 + r < n;

  // this block's bias rows, once, pre-multiplied by log2(e); rows past N zero
  const float* bsrc = p.bias + ((size_t)head * n + q0) * n;
  for (int row = 0; row < qt; ++row) {
    const bool ok = q0 + row < n;
    for (int col = tid; col < n; col += blockDim.x) {
      bias_s[row * bstride + col] = ok ? bsrc[(size_t)row * n + col] * kLog2e : 0.f;
    }
  }

  const float* brow = bias_s + r * bstride;
  for (int w = w0; w < w1; ++w) {
    const uint8_t* lrow = kMasked ? p.labels + (size_t)(w % p.n_win) * p.lstride : nullptr;
    const int ql = kMasked && row_ok ? lrow[q0 + r] : 0;
    const T* qp = static_cast<const T*>(p.q) + w * p.q_sb + head * p.q_sh +
                  (long long)(row_ok ? q0 + r : 0) * p.q_sn;
    const T* kb = static_cast<const T*>(p.k) + w * p.k_sb + head * p.k_sh;
    const T* vb = static_cast<const T*>(p.v) + w * p.v_sb + head * p.v_sh;
    float qf[DP];
#pragma unroll
    for (int c = 0; c < DP; c += 8) load_upto8(qp + c, vec, row_ok ? d - c : 0, qf + c);
#pragma unroll
    for (int c = 0; c < DP; ++c) qf[c] *= p.qscale;
    float acc[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[c] = 0.f;
    float m = -INFINITY, l = 0.f;

    for (int k0 = 0; k0 < n; k0 += kKeyTile) {
      __syncthreads();  // the previous tile (and the bias fill) is done
      for (int e = tid; e < kKeyTile * (DP / 8); e += blockDim.x) {
        const int row = e / (DP / 8), c = (e % (DP / 8)) * 8;
        const int count = k0 + row < n ? d - c : 0;  // zero rows past N
        float tmp[8];
        load_upto8(kb + (long long)(k0 + row) * p.k_sn + c, vec, count, tmp);
        wft::store8(k_s + row * kvstride + c, tmp);
        load_upto8(vb + (long long)(k0 + row) * p.v_sn + c, vec, count, tmp);
        wft::store8(v_s + row * kvstride + c, tmp);
      }
      if constexpr (kMasked) {  // rows past N read the zero padding
        for (int row = tid; row < kKeyTile; row += blockDim.x) kl_s[row] = lrow[k0 + row];
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
        for (int c = 0; c < DP; c += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + c);
          s = fmaf(qf[c], kk.x, s);
          s = fmaf(qf[c + 1], kk.y, s);
          s = fmaf(qf[c + 2], kk.z, s);
          s = fmaf(qf[c + 3], kk.w, s);
        }
        s = k0 + j < n ? s + brow[k0 + j] : -INFINITY;
        if constexpr (kMasked) s += kl_s[j] != ql ? kMaskLog2 : 0.f;
        sc[i] = s;
        cmax = fmaxf(cmax, s);
      }
      const float mnew = fmaxf(m, cmax);
      // a thread whose keys so far are all past N keeps l = acc = 0
      const float mref = mnew == -INFINITY ? 0.f : mnew;
      const float corr = exp2f(m - mref);  // 0 on the first tile
      l *= corr;
#pragma unroll
      for (int c = 0; c < DP; ++c) acc[c] *= corr;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int j = i * kThreadsPerQ + sub;
        const float pr = exp2f(sc[i] - mref);
        l += pr;
        const float pq = wft::round_to<T>(pr);
        const float* vr = v_s + j * kvstride;
#pragma unroll
        for (int c = 0; c < DP; c += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + c);
          acc[c] = fmaf(pq, vv.x, acc[c]);
          acc[c + 1] = fmaf(pq, vv.y, acc[c + 1]);
          acc[c + 2] = fmaf(pq, vv.z, acc[c + 2]);
          acc[c + 3] = fmaf(pq, vv.w, acc[c + 3]);
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
      const float mref = mn == -INFINITY ? 0.f : mn;
      const float cs = exp2f(m - mref), co = exp2f(mo - mref);
      l = l * cs + lo * co;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[c], off);
        acc[c] = acc[c] * cs + ao * co;
      }
      m = mn;
    }
    if (row_ok) {
      const float inv = 1.f / l;
      T* op = static_cast<T*>(p.o) + w * p.o_sb + head * p.o_sh + (long long)(q0 + r) * p.o_sn;
      constexpr int kOutPer = DP / kThreadsPerQ;
#pragma unroll
      for (int c = 0; c < DP; ++c) {
        if (c / kOutPer == sub && c < d) op[c] = wft::from_f<T>(acc[c] * inv);
      }
    }
  }
}

template <typename T, int DP, bool kMasked>
cudaError_t launch_fma(Params p, cudaStream_t stream) {
  const int qt = p.n > 512 ? 32 : std::min(64, (p.n + 7) / 8 * 8);
  const size_t smem =
      (size_t)(qt * fma_bias_stride(p.n) + 2 * kKeyTile * (DP + 4) + (kMasked ? kKeyTile : 0)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(window_attention_kernel<T, DP, kMasked>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // windows per block: about two waves of blocks over the SMs; fewer windows
  // per block re-read the bias more often, more leave SMs idle
  const int qtiles = (p.n + qt - 1) / qt;
  const int per_window = qtiles * p.h;
  const int groups =
      std::min(p.bw, std::max(1, (2 * sm_count() + per_window - 1) / per_window));
  p.windows_per_block = (p.bw + groups - 1) / groups;
  dim3 grid(qtiles, p.h, (p.bw + p.windows_per_block - 1) / p.windows_per_block);
  window_attention_kernel<T, DP, kMasked><<<grid, qt * kThreadsPerQ, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool kMasked>
cudaError_t dispatch_fma(const Params& p, cudaStream_t stream) {
  switch ((p.d + 7) / 8) {
    case 1: return launch_fma<T, 8, kMasked>(p, stream);
    case 2: return launch_fma<T, 16, kMasked>(p, stream);
    case 3: return launch_fma<T, 24, kMasked>(p, stream);
    case 4: return launch_fma<T, 32, kMasked>(p, stream);
    case 5: return launch_fma<T, 40, kMasked>(p, stream);
    case 6: return launch_fma<T, 48, kMasked>(p, stream);
    case 7: return launch_fma<T, 56, kMasked>(p, stream);
    default: return launch_fma<T, 64, kMasked>(p, stream);
  }
}

// ---------------------------------------------------------------------------
// The tma_wgmma design (see the header).

constexpr int kSmemMax = 232448;  // dynamic shared memory a block may have
constexpr int kQRows = 64;        // query rows of a block: one wgmma M
constexpr int kQSlots = 2;        // Q tiles in flight per consumer
constexpr int kChunkRows = 32;    // bytes of a 16-column box row (32-byte swizzle)

// Keys per K/V tile: 128 where the ring still has ≥ 2 stages beside 133 KB
// of bias rows, else 64.
template <int D>
__host__ __device__ constexpr int key_tile() {
  return D <= 32 ? 128 : 64;
}

// Consumer warpgroups per block: three at D = 16, where three K/V rings fit
// beside the bias rows (more warps to hide the latency of each tile's
// product → softmax → product chain), two above.
template <int D>
__host__ __device__ constexpr int consumers() {
  return D == 16 ? 3 : 2;
}

// Threads of a block: the consumer warpgroups, then one producer warp.
template <int D>
__host__ __device__ constexpr int tma_threads() {
  return consumers<D>() * 128 + 32;
}

struct TmaPlan {
  int stages;           // K/V ring depth per consumer
  int bstride;          // bias row stride in floats: ≡ 8 (mod 32), ≥ the last tile's end
  int q_bytes;          // one Q slot: D/16 boxes of 64 rows × 32 bytes
  int kv_bytes;         // one K/V stage: K's D/16 boxes of KT rows, then V's
  int kv_off, bias_off, bar_off;  // byte offsets in the aligned shared memory
  int qtiles;           // 64-query tiles per window
  int items_per_block;  // (head, query tile, window) items per block
};

using wft::mbar_wait_or_trap;

// ex2.approx: 2^x on the special-function unit (−∞ → +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 64 bias rows of (head, q0) into shared memory, × log2(e); rows past N
// zero. Four loads in flight per thread; 16-byte vectors where N % 4 == 0.
template <bool kVec>
__device__ __forceinline__ void fill_bias(float* bias_s, const float* bsrc, int n, int q0,
                                          int bstride, int tid, int threads) {
  constexpr int kW = kVec ? 4 : 1;
  const int rows = min(kQRows, n - q0);
  const int total = rows * n / kW;  // valid words
  for (int e0 = tid; e0 < total; e0 += 4 * threads) {
    float vals[4][kW];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * threads;
      if (e < total) {
        if constexpr (kVec) {
          const float4 b = *reinterpret_cast<const float4*>(bsrc + (size_t)e * 4);
          vals[u][0] = b.x, vals[u][1] = b.y, vals[u][2] = b.z, vals[u][3] = b.w;
        } else {
          vals[u][0] = bsrc[e];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * threads;
      if (e < total) {
        const int f = e * kW, row = f / n, col = f % n;  // n % kW == 0: one row
#pragma unroll
        for (int i = 0; i < kW; ++i) bias_s[row * bstride + col + i] = vals[u][i] * kLog2e;
      }
    }
  }
  for (int e = rows * n + tid; e < kQRows * n; e += threads) {
    bias_s[e / n * bstride + e % n] = 0.f;
  }
}

template <int D, bool kMasked>
__global__ void __launch_bounds__(tma_threads<D>(), 1)
    window_attention_tma_kernel(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap, Params p, TmaPlan t) {
  using bf16 = __nv_bfloat16;
  constexpr int KT = key_tile<D>(), CH = D / 16, kConsumers = consumers<D>();
  constexpr int kBox = KT * kChunkRows;  // bytes of one 16-column K or V box
  extern __shared__ uint8_t smem_raw[];
  // 32-byte swizzled boxes and wgmma atoms want 256-byte aligned tiles
  uint8_t* smem = smem_raw + ((256 - wft::smem_u32(smem_raw) % 256) % 256);
  float* bias_s = reinterpret_cast<float*>(smem + t.bias_off);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + t.bar_off);
  const int S = t.stages;
  // consumer c's barriers: full[S], empty[S], qfull[kQSlots], qempty[kQSlots]
  const int nbar = 2 * S + 2 * kQSlots;
  auto full = [&](int c, int i) { return bars + c * nbar + i; };
  auto empty = [&](int c, int i) { return bars + c * nbar + S + i; };
  auto qfull = [&](int c, int i) { return bars + c * nbar + 2 * S + i; };
  auto qempty = [&](int c, int i) { return bars + c * nbar + 2 * S + kQSlots + i; };
  auto q_slot = [&](int c, int i) { return smem + (c * kQSlots + i) * t.q_bytes; };
  auto kv_stage = [&](int c, int i) { return smem + t.kv_off + (c * S + i) * t.kv_bytes; };

  const int tid = threadIdx.x, wg = tid / 128;
  const int n = p.n;
  const int ntiles = (n + KT - 1) / KT;
  const long long total = (long long)t.qtiles * p.h * p.bw;
  const long long i0 = (long long)blockIdx.x * t.items_per_block;
  const long long i1 = min(i0 + t.items_per_block, total);
  if (tid == 0) {
    for (int c = 0; c < kConsumers; ++c) {
      for (int i = 0; i < S; ++i) {
        wft::mbar_init(full(c, i), 1);
        wft::mbar_init(empty(c, i), 128);
      }
      for (int i = 0; i < kQSlots; ++i) {
        wft::mbar_init(qfull(c, i), 1);
        wft::mbar_init(qempty(c, i), 128);
      }
    }
    wft::mbar_init_fence();
  }
  __syncthreads();

  // The block's items as segments of one (head, query tile): windows
  // wbeg … wbeg + nwin − 1; consumer c takes the segment's windows c,
  // c + kConsumers, ….
  if (wg == kConsumers) {  // the producer warp: one thread issues every copy
    if (tid != kConsumers * 128) return;
    int tc[kConsumers] = {}, qc[kConsumers] = {};
    for (long long seg = i0; seg < i1;) {
      const int pair = (int)(seg / p.bw);
      const long long seg_end = min(i1, (long long)(pair + 1) * p.bw);
      const int wbeg = (int)(seg - (long long)pair * p.bw), nwin = (int)(seg_end - seg);
      const int head = pair / t.qtiles, q0 = pair % t.qtiles * kQRows;
      for (int i = 0; i < nwin; i += kConsumers) {
        for (int kt = 0; kt < ntiles; ++kt) {
          for (int c = 0; c < kConsumers && i + c < nwin; ++c) {
            const int w = wbeg + i + c;
            if (kt == 0) {
              const int qs = qc[c] % kQSlots;
              if (qc[c] >= kQSlots) mbar_wait_or_trap(qempty(c, qs), (qc[c] / kQSlots - 1) & 1);
              wft::mbar_arrive_expect_tx(qfull(c, qs), t.q_bytes);
#pragma unroll
              for (int ch = 0; ch < CH; ++ch) {
                wft::tma_load_4d(q_slot(c, qs) + ch * kQRows * kChunkRows, &qmap, qfull(c, qs),
                                 16 * ch, q0, head, w);
              }
              ++qc[c];
            }
            const int slot = tc[c] % S;
            if (tc[c] >= S) mbar_wait_or_trap(empty(c, slot), (tc[c] / S - 1) & 1);
            wft::mbar_arrive_expect_tx(full(c, slot), t.kv_bytes);
            uint8_t* st = kv_stage(c, slot);
#pragma unroll
            for (int ch = 0; ch < CH; ++ch) {
              wft::tma_load_4d(st + ch * kBox, &kmap, full(c, slot), 16 * ch, kt * KT, head, w);
              wft::tma_load_4d(st + (CH + ch) * kBox, &vmap, full(c, slot), 16 * ch, kt * KT,
                               head, w);
            }
            ++tc[c];
          }
        }
      }
      seg = seg_end;
    }
    return;
  }

  // a consumer warpgroup; warp `warp` owns query rows 16·warp … of the tile
  const int c = wg;
  const int lt = tid % 128, warp = lt / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  int tc = 0, qc = 0;
  for (long long seg = i0; seg < i1;) {
    const int pair = (int)(seg / p.bw);
    const long long seg_end = min(i1, (long long)(pair + 1) * p.bw);
    const int wbeg = (int)(seg - (long long)pair * p.bw), nwin = (int)(seg_end - seg);
    const int head = pair / t.qtiles, q0 = pair % t.qtiles * kQRows;
    seg = seg_end;

    // the segment's bias rows, filled by both consumers between two barriers
    wft::named_bar_sync(1, kConsumers * 128);  // the last segment's readers are done
    const float* bsrc = p.bias + ((size_t)head * n + q0) * n;
    if (n % 4 == 0) {
      fill_bias<true>(bias_s, bsrc, n, q0, t.bstride, tid, kConsumers * 128);
    } else {
      fill_bias<false>(bias_s, bsrc, n, q0, t.bstride, tid, kConsumers * 128);
    }
    wft::named_bar_sync(1, kConsumers * 128);
    const float* brow0 = bias_s + (warp * 16 + g) * t.bstride;
    const float* brow1 = brow0 + 8 * t.bstride;

    for (int i = c; i < nwin; i += kConsumers) {
      const int w = wbeg + i;
      // the window's labels as key pairs (2 bytes: the rows are padded to 128)
      const uint16_t* lpair =
          kMasked ? reinterpret_cast<const uint16_t*>(p.labels + (size_t)(w % p.n_win) * p.lstride)
                  : nullptr;
      int ql0 = 0, ql1 = 0;
      if constexpr (kMasked) {
        const int r0 = q0 + warp * 16 + g;
        const uint8_t* lrow = p.labels + (size_t)(w % p.n_win) * p.lstride;
        ql0 = lrow[r0];  // rows past N (< lstride) read the padding and are not stored
        ql1 = lrow[r0 + 8];
      }
      const int qs = qc % kQSlots;
      mbar_wait_or_trap(qfull(c, qs), (qc / kQSlots) & 1);
      const uint32_t q_addr = wft::smem_u32(q_slot(c, qs));
      float o[D / 2];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

      for (int kt = 0; kt < ntiles; ++kt) {
        const int slot = tc % S;
        mbar_wait_or_trap(full(c, slot), (tc / S) & 1);
        const uint32_t k_addr = wft::smem_u32(kv_stage(c, slot));
        const uint32_t v_addr = k_addr + CH * kBox;

        // S = Q·Kᵀ: A = Q (64 rows), B = K (KT rows), both K-major, 32-byte rows
        float s[KT / 2];
        wft::wgmma_fence();
        wft::fence_regs(s);
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) {
          const uint64_t da =
              wft::wgmma_desc(q_addr + ch * kQRows * kChunkRows, 16, 256, wft::kSwizzle32);
          const uint64_t db = wft::wgmma_desc(k_addr + ch * kBox, 16, 256, wft::kSwizzle32);
          wft::Wgmma<KT>::template run<0, 0>(s, da, db, ch > 0);
        }
        wft::wgmma_commit();
        wft::fence_regs(s);
        wft::wgmma_wait<0>();
        wft::fence_regs(s);
        if (kt == ntiles - 1) wft::mbar_arrive(qempty(c, qs));  // Q is read for the last time

        // online softmax in the log2 domain; rows g and g + 8 of the warp's 16
        const int k0 = kt * KT;
        const bool tail = k0 + KT > n;
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          const int col = k0 + j * 8 + 2 * tq;
          const float2 b0 = *reinterpret_cast<const float2*>(brow0 + col);
          const float2 b1 = *reinterpret_cast<const float2*>(brow1 + col);
          s[4 * j] = fmaf(s[4 * j], p.qscale, b0.x);
          s[4 * j + 1] = fmaf(s[4 * j + 1], p.qscale, b0.y);
          s[4 * j + 2] = fmaf(s[4 * j + 2], p.qscale, b1.x);
          s[4 * j + 3] = fmaf(s[4 * j + 3], p.qscale, b1.y);
          if constexpr (kMasked) {
            const uint32_t pair = __ldg(lpair + col / 2);
            const int ka = pair & 0xff, kb = pair >> 8;
            s[4 * j] += ka != ql0 ? kMaskLog2 : 0.f;
            s[4 * j + 1] += kb != ql0 ? kMaskLog2 : 0.f;
            s[4 * j + 2] += ka != ql1 ? kMaskLog2 : 0.f;
            s[4 * j + 3] += kb != ql1 ? kMaskLog2 : 0.f;
          }
          if (tail) {  // keys past N
            if (col >= n) s[4 * j] = s[4 * j + 2] = -INFINITY;
            if (col + 1 >= n) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
          }
          mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        // the four threads of a quad share rows g and g + 8; every tile has
        // a key below N, so the maxima are finite
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float c0 = ex2(m0 - mx0), c1 = ex2(m1 - mx1);  // 0 on the first tile
        m0 = mx0;
        m1 = mx1;
        l0 *= c0;
        l1 *= c1;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= c0;
          o[4 * j + 1] *= c0;
          o[4 * j + 2] *= c1;
          o[4 * j + 3] *= c1;
        }
        // P in the A-fragment layout of key step u: the accumulator tiles 2u, 2u + 1
        uint32_t pa[KT / 16][4];
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          const float p00 = ex2(s[4 * j] - m0), p01 = ex2(s[4 * j + 1] - m0);
          const float p10 = ex2(s[4 * j + 2] - m1), p11 = ex2(s[4 * j + 3] - m1);
          l0 += p00 + p01;
          l1 += p10 + p11;
          pa[j / 2][(j % 2) * 2] = wft::pack_bf16(p00, p01);
          pa[j / 2][(j % 2) * 2 + 1] = wft::pack_bf16(p10, p11);
        }

        // O += P·V: A = P from registers, B = V (KT key rows × D), MN-major
        wft::wgmma_fence();
        wft::fence_regs(o);
#pragma unroll
        for (int u = 0; u < KT / 16; ++u) {
          const uint64_t db =
              wft::wgmma_desc(v_addr + u * 16 * kChunkRows, kBox, 256, wft::kSwizzle32);
          wft::WgmmaRS<D>::template run<1>(o, pa[u], db, 1);
        }
        wft::wgmma_commit();
        wft::fence_regs(o);
        wft::wgmma_wait<0>();
        wft::fence_regs(o);
        wft::mbar_arrive(empty(c, slot));
        ++tc;
      }
      ++qc;

      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
      bf16* ob = static_cast<bf16*>(p.o) + w * p.o_sb + head * p.o_sh;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (r0 < n) {
          *reinterpret_cast<uint32_t*>(ob + (long long)r0 * p.o_sn + j * 8 + 2 * tq) =
              wft::pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        }
        if (r1 < n) {
          *reinterpret_cast<uint32_t*>(ob + (long long)r1 * p.o_sn + j * 8 + 2 * tq) =
              wft::pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
        }
      }
    }
  }
}

// A bf16 tensor map over q, k or v as (D, N, H, BW), boxes of 16 columns ×
// `rows`, 32-byte swizzle; rows past N (and windows past BW) read zeros.
cudaError_t attention_map(CUtensorMap* map, const void* base, const Params& p, long long sb,
                          long long sh, long long sn, int rows) {
  const uint64_t dims[4] = {(uint64_t)p.d, (uint64_t)p.n, (uint64_t)p.h, (uint64_t)p.bw};
  const uint64_t strides[3] = {(uint64_t)sn * 2, (uint64_t)sh * 2, (uint64_t)sb * 2};
  const uint32_t box[4] = {16, (uint32_t)rows, 1, 1};
  return wft::make_map_bf16(map, base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_32B);
}

template <int D, bool kMasked>
cudaError_t launch_tma(const Params& p, cudaStream_t stream) {
  constexpr int KT = key_tile<D>(), CH = D / 16, kConsumers = consumers<D>();
  TmaPlan t;
  t.qtiles = (p.n + kQRows - 1) / kQRows;
  t.bstride = (p.n + KT - 1) / KT * KT + 8;
  t.q_bytes = CH * kQRows * kChunkRows;
  t.kv_bytes = 2 * CH * KT * kChunkRows;
  const int bias_bytes = kQRows * t.bstride * 4;
  const int base = 256 + kConsumers * kQSlots * t.q_bytes + bias_bytes;
  auto need = [&](int stages) {
    return base + kConsumers * stages * t.kv_bytes + kConsumers * (2 * stages + 2 * kQSlots) * 8;
  };
  t.stages = 4;
  while (t.stages >= 2 && need(t.stages) > kSmemMax) --t.stages;
  if (t.stages < 2) return cudaErrorInvalidValue;
  t.kv_off = kConsumers * kQSlots * t.q_bytes;
  t.bias_off = t.kv_off + kConsumers * t.stages * t.kv_bytes;
  t.bar_off = t.bias_off + bias_bytes;
  const size_t smem = need(t.stages);

  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = attention_map(&qmap, p.q, p, p.q_sb, p.q_sh, p.q_sn, kQRows);
  if (err != cudaSuccess) return err;
  err = attention_map(&kmap, p.k, p, p.k_sb, p.k_sh, p.k_sn, KT);
  if (err != cudaSuccess) return err;
  err = attention_map(&vmap, p.v, p, p.v_sb, p.v_sh, p.v_sn, KT);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(window_attention_tma_kernel<D, kMasked>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      window_attention_tma_kernel<D, kMasked>,
                                                      tma_threads<D>(), smem);
  if (err != cudaSuccess) return err;
  // equal shares of the (head, query tile, window) items for every block in flight
  const long long total = (long long)t.qtiles * p.h * p.bw;
  const long long slots = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  t.items_per_block = (int)((total + slots - 1) / slots);
  const long long blocks = (total + t.items_per_block - 1) / t.items_per_block;
  window_attention_tma_kernel<D, kMasked><<<(unsigned)blocks, tma_threads<D>(), smem, stream>>>(
      qmap, kmap, vmap, p, t);
  return cudaGetLastError();
}

template <bool kMasked>
cudaError_t dispatch(int dtype, const Params& p, cudaStream_t s) {
  if (design_of(dtype, p.n, p.d) == kTmaWgmma) {
    switch (p.d) {
      case 16: return launch_tma<16, kMasked>(p, s);
      case 32: return launch_tma<32, kMasked>(p, s);
      case 48: return launch_tma<48, kMasked>(p, s);
      default: return launch_tma<64, kMasked>(p, s);
    }
  }
  if (dtype == wft::kFloat32) return dispatch_fma<float, kMasked>(p, s);
  return dispatch_fma<__nv_bfloat16, kMasked>(p, s);
}

}  // namespace

// The design wft_window_attention launches for these arguments: 0 = the fma
// kernel, 1 = the TMA + wgmma kernel.
extern "C" int wft_window_attention_design(int dtype, int n, int d) {
  return design_of(dtype, n, d);
}

// Returns a cudaError_t (0 on success). Strides are in elements; for the TMA
// design the q/k/v strides must be multiples of 8 and the pointers 16-byte
// aligned, as for the fma design at D % 8 == 0. `labels` is null, or (n_win,
// lstride) uint8 with n_win dividing bw and lstride a multiple of 128 ≥ n.
extern "C" int wft_window_attention(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    void* o, long long q_sb, long long q_sh, long long q_sn, long long k_sb,
    long long k_sh, long long k_sn, long long v_sb, long long v_sh,
    long long v_sn, long long o_sb, long long o_sh, long long o_sn, int bw,
    int h, int n, int d, float scale, const void* labels, int n_win, int lstride,
    void* stream) {
  if (n < 1 || n > kMaxN || d < 1 || d > kMaxD || bw < 1 || h < 1 ||
      (dtype != wft::kFloat32 && dtype != wft::kBFloat16)) {
    return (int)cudaErrorInvalidValue;
  }
  if (labels != nullptr && (n_win < 1 || bw % n_win != 0 || lstride < n || lstride % 128 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{q, k, v, static_cast<const float*>(bias), o,
                 q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn,
                 o_sb, o_sh, o_sn, bw, h, n, d, scale * kLog2e, 1,
                 static_cast<const uint8_t*>(labels), n_win, lstride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(labels != nullptr ? dispatch<true>(dtype, p, s) : dispatch<false>(dtype, p, s));
}
