// Depthwise 3×3×3 "same" convolution, channels-last, for Hopper.
//
// Replaces the TPU kernel waveformer_tpu/ops/dwconv_pallas.py (`dwconv3`,
// `_kernel` :32-44): stride 1, zero padding 1, one (3,3,3) filter per
// channel, fp32 accumulation in the kd → kh → kw tap order, one rounding to
// the output dtype. New beside it: an optional fp32 bias (C,), added to the
// fp32 sum before that rounding (the model's conv bias, which the JAX model
// adds right after the stencil).
// x, y: (B, D, H, W, C) contiguous, any C ≥ 1; weights (27, C) fp32; bias
// (C,) fp32 or null.
//
// What bounds it: bytes. 27 multiply-adds per element is far below the
// card's ops:byte balance; at (8, 64, 64, 64, 192) bf16 the kernel must read
// and write 805 MB each, ≈0.48 ms at 3.35 TB/s. The 27 fp32 FMAs per element
// alone take ≈0.32 ms of the fp32 rate there, so the other instructions per
// element (loads, unpacks, stores, addresses) have to stay few, or issue and
// not bytes sets the pace.
//
// Two designs, chosen from the dtype and C only (`design_of`, queried by
// `wft_dwconv3_design`):
//
// `tma_ring` (bf16, C % 8 == 0: every call of the WaveFormer path; TMA needs
// the 2·C-byte W stride to be a multiple of 16 bytes). A block owns output
// tiles of 8 (H) × 16 (W) voxels × 64 channels (8 × 8 × 128 where W ≤ 8, so
// that no warp idles on a narrow volume) and marches each along D. One
// thread loads one (channels, W + 2, 10) box per input plane, started at
// (c0, w0 − 1, h0 − 1), into a ring of 4 plane stages (23-26 KB each) with
// full and empty mbarriers, refilling the stage of plane m − 1 as it starts
// plane m; TMA fills the halo outside the volume with zeros, so the padding
// costs nothing, and each input byte leaves L2 about 10·18/(8·16) = 1.41
// times. Eight warps each own a 2 × 8 voxel patch of 64 channels; lane l
// owns channels 2l, 2l + 1 of them (one bf16x2 word: a warp reads one
// 128-byte voxel row, conflict-free) and keeps their 27 taps in registers
// for the whole tile. Each input plane is read once (4 rows × 10 words a
// thread), unpacked once and fed to the three outputs it touches (input
// plane p → outputs p + 1, p, p − 1 with kd = 0, 1, 2): three sets of 2 × 8
// × 2 fp32 accumulators whose roles rotate statically (the D loop is
// unrolled by 3), so no accumulator is moved. An output's first tap adds
// onto its bias, the last one completes it, and it is rounded once and
// stored as 32-bit words (a warp writes one whole 128-byte voxel row). Per
// output element: 27 FMAs, 1.25 shared loads, 2.5 unpack instructions, half
// a pack and half a store. Eight warps, two per scheduler, leave each
// thread up to 255 registers (a ninth, producer warp would put three on one
// scheduler and cap them at 168, which spilled). Equal work: one block per
// SM walks an equal share of the tiles, each along all of D (cutting D into
// segments where there are few tiles per block balances the SMs better but
// re-reads two halo planes per segment, and was slower at every shape of
// the WaveFormer path: PERF.md §6).
//
// `vector` (fp32, and bf16 with C % 8 != 0): a thread owns 8 channels (16-byte
// vectors where C % 8 == 0, element by element otherwise: `kTail`) of 2
// consecutive output voxels along W of one (b, h) row and
// marches along D; each input plane is loaded once (3 rows × 4 vectors) and
// applied to the three outputs in flight; the block's 27 × 32 tap weights sit
// in shared memory.
//
// The backward (new: the JAX kernel's backward is a plain `custom_vjp`
// composition, with no Pallas kernel). dx is this kernel run on g with the
// taps flipped on all three axes (the caller flips them). The weight
// gradient, `wft_dwconv3_wgrad`: dk[kd, kh, kw, c] = Σ over voxels of x
// shifted by the tap times g, and db[c] = Σ g, in fp32. Bound by bytes like
// the forward: x and g are read once each, 27 FMAs an element (the ten
// calls of a batch-4 training step read 3.35 GB in bf16, ≈ 1.0 ms at 3.35
// TB/s; dx's read of g and write another 3.35 GB). The same design rule, queried by `wft_dwconv3_wgrad_design`:
// `tma_ring` keeps the forward's tiles, warps, lanes and ring, a stage
// holding x's input plane p (the halo box) and g's plane p + 1 (a box of the
// tile itself); each warp holds its patch of the last three g planes in
// registers, and each lane its two channels' 27 tap sums and Σ g for every
// tile its block visits (a block owns one channel tile). `vector`: four
// warps of a block walk whole voxel columns along D, lane l owning channels
// 2l, 2l + 1. Each block's warps add their sums in shared memory into one
// partial; a second kernel adds the partials in block order, so the same
// inputs give the same bits (no atomics).

#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

enum Design : int { kVector = 0, kTmaRing = 1 };

int design_of(int dtype, int c) {
  return dtype == wft::kBFloat16 && c % 8 == 0 ? kTmaRing : kVector;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// ---------------------------------------------------------------------------
// The vector design (see the header).

constexpr int kOutW = 2;  // output voxels per thread along W

// 8 channels of one output voxel plus their bias: one 16-byte store, or
// (kTail) the first `left` of them one by one.
template <typename T, bool kTail>
__device__ __forceinline__ void store_out(T* p, const float* v, const float* b, int left) {
  float s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = v[i] + b[i];
  if constexpr (!kTail) {
    wft::store8(p, s);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < left) p[i] = wft::from_f<T>(s[i]);
  }
}

// One thread: 8 channels × 2 W-outputs of one (b, h) row, marching along D.
// Input plane p feeds outputs p + 1 (kd = 0), p (kd = 1) and p − 1 (kd = 2),
// so marching p upwards adds each output's taps in kd → kh → kw order.
template <typename T, bool kTail>
__global__ void __launch_bounds__(256) dwconv3_kernel(
    const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    T* __restrict__ y, int B, int D, int H, int W, int C, int chunks_per_block) {
  extern __shared__ __align__(16) float wsm[];
  const int cc = chunks_per_block;
  const int chunk0 = blockIdx.y * cc;
  for (int e = threadIdx.x; e < 27 * cc * 8; e += blockDim.x) {
    const int t = e / (cc * 8), c = chunk0 * 8 + e % (cc * 8);
    wsm[e] = !kTail || c < C ? w[t * C + c] : 0.f;
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
  float bs[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) bs[i] = bias != nullptr && c0 + i < C ? bias[c0 + i] : 0.f;

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
        if (ww >= 0 && ww < W && !kTail) {
          wft::load8(row + (long long)ww * C, v[pidx]);
        } else if (ww >= 0 && ww < W) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            v[pidx][i] = c0 + i < C ? wft::to_f(row[(long long)ww * C + i]) : 0.f;
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
        if (w0 + o < W)
          store_out<T, kTail>(out + (long long)(w0 + o) * C, acc_lo[o], bs, C - c0);
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
    if (w0 + o < W) store_out<T, kTail>(out + (long long)(w0 + o) * C, acc_lo[o], bs, C - c0);
}

// Channel chunks per block: 4 where they divide, so a warp spans 4 chunks ×
// 8 voxel items (64 contiguous bytes per voxel, weights read as broadcasts).
int pick_chunks(int chunks) {
  return chunks % 4 == 0 ? 4 : (chunks % 2 == 0 ? 2 : 1);
}

template <typename T, bool kTail>
cudaError_t launch_vector(const void* x, const float* w, const float* bias, void* y, int B,
                          int D, int H, int W, int C, cudaStream_t stream) {
  const int chunks = (C + 7) / 8;
  const int cc = pick_chunks(chunks);
  const int per_block = 256 / cc;
  const long long items = (long long)B * H * ((W + kOutW - 1) / kOutW);
  const long long blocks = (items + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = (size_t)27 * cc * 8 * sizeof(float);
  dim3 grid((unsigned)blocks, chunks / cc);
  dwconv3_kernel<T, kTail><<<grid, per_block * cc, smem, stream>>>(
      static_cast<const T*>(x), w, bias, static_cast<T*>(y), B, D, H, W, C, cc);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tma_ring design (see the header).

// A tile is kHT × WT output voxels × 64·(16 / WT) channels: WT = 16, or 8
// for volumes at most 8 wide, where the second half of the warps takes a
// second 64-channel group instead of voxels past W.
constexpr int kHT = 8;                           // output voxels of a tile along H
constexpr int kHR = 2, kWR = 8;                  // output voxels of a warp (H, W)
constexpr int kWarps = 8;                        // 2 per scheduler: ≤ 255 registers
constexpr int kStages = 4;                       // input planes in the ring

template <int WT>
struct Tile {
  static constexpr int kGroups = 16 / WT;                          // 64-channel groups
  static constexpr int kCT = 64 * kGroups;                         // channels
  static constexpr int kRowBytes = kCT * 2;                        // one voxel, bf16
  static constexpr int kStageBytes = (kHT + 2) * (WT + 2) * kRowBytes;  // one input box
};

struct RingPlan {
  int B, D, H, W, C;
  int th, tw, tc;         // tiles along H, W, C
  long long items;        // tiles, each marched along all of D
  int items_per_block;
};

struct Item {
  int b, h0, w0, c0;
};

template <int WT>
__device__ __forceinline__ Item decode(const RingPlan& q, long long i) {
  Item it;
  it.c0 = (int)(i % q.tc) * Tile<WT>::kCT;
  i /= q.tc;
  it.w0 = (int)(i % q.tw) * WT;
  i /= q.tw;
  it.h0 = (int)(i % q.th) * kHT;
  it.b = (int)(i / q.th);
  return it;
}

using Acc = float[3][kHR][kWR][2];

// Round, pack and store accumulator set `S` of the warp's patch as output
// plane `o` (voxels outside the volume and channels past C are skipped).
template <int S>
__device__ __forceinline__ void ring_store(const Acc& acc, __nv_bfloat16* y, const RingPlan& q,
                                           const Item& it, int hp, int wp, int ch, int o) {
  if (ch >= q.C) return;
#pragma unroll
  for (int r = 0; r < kHR; ++r) {
    const int h = hp + r;
    if (h >= q.H) break;
    __nv_bfloat16* row = y + ((((long long)it.b * q.D + o) * q.H + h) * q.W + wp) * q.C + ch;
#pragma unroll
    for (int c = 0; c < kWR; ++c) {
      if (wp + c < q.W) {
        *reinterpret_cast<uint32_t*>(row + (long long)c * q.C) =
            wft::pack_bf16(acc[S][r][c][0], acc[S][r][c][1]);
      }
    }
  }
}

// One input plane into the three accumulator sets in flight. With J the
// plane's index mod 3: set J % 3 holds output p − 1 (kd = 2), (J + 1) % 3
// output p (kd = 1), (J + 2) % 3 output p + 1 (kd = 0), whose first tap adds
// onto the bias. `src` is the stage's word of this lane at the patch's
// first halo row and column.
template <int WT, int J>
__device__ __forceinline__ void ring_plane(Acc& acc, const uint8_t* src, const float2 (&tap)[27],
                                           float2 bs) {
  constexpr int LO = J % 3, MID = (J + 1) % 3, HI = (J + 2) % 3;
  constexpr int kRow = Tile<WT>::kRowBytes;
#pragma unroll
  for (int hh = 0; hh < kHR + 2; ++hh) {
    float2 v[kWR + 2];
#pragma unroll
    for (int c = 0; c < kWR + 2; ++c) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(src + (hh * (WT + 2) + c) * kRow);
      v[c] = make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
    }
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int r = hh - kh;  // the patch row this input row feeds through kh
      if (r < 0 || r >= kHR) continue;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const float2 t0 = tap[kh * 3 + kw], t1 = tap[9 + kh * 3 + kw], t2 = tap[18 + kh * 3 + kw];
#pragma unroll
        for (int c = 0; c < kWR; ++c) {
          const float2 a = v[c + kw];
          float* hi = acc[HI][r][c];
          if (kh == 0 && kw == 0) {
            hi[0] = fmaf(a.x, t0.x, bs.x);
            hi[1] = fmaf(a.y, t0.y, bs.y);
          } else {
            hi[0] = fmaf(a.x, t0.x, hi[0]);
            hi[1] = fmaf(a.y, t0.y, hi[1]);
          }
          acc[MID][r][c][0] = fmaf(a.x, t1.x, acc[MID][r][c][0]);
          acc[MID][r][c][1] = fmaf(a.y, t1.y, acc[MID][r][c][1]);
          acc[LO][r][c][0] = fmaf(a.x, t2.x, acc[LO][r][c][0]);
          acc[LO][r][c][1] = fmaf(a.y, t2.y, acc[LO][r][c][1]);
        }
      }
    }
  }
}

// The block's input planes in order, issued by one thread (lane 0 of warp
// 0): tile by tile, planes 0 … D − 1 of each.
template <int WT>
struct Producer {
  long long i, i1;
  Item it;
  int p, n;  // the next plane, and the ring uses issued so far

  __device__ void start(const RingPlan& q, long long i0, long long end) {
    i = i0, i1 = end, n = 0;
    if (i < i1) it = decode<WT>(q, i), p = 0;
  }

  // Issue the next plane (if any) into its stage, once the stage's previous
  // plane has been freed by every warp.
  __device__ void issue(const RingPlan& q, const CUtensorMap* map, uint8_t* smem, uint64_t* full,
                        uint64_t* empty) {
    if (i >= i1) return;
    const int s = n % kStages;
    if (n >= kStages) wft::mbar_wait_or_trap(empty + s, (n / kStages - 1) & 1);
    wft::mbar_arrive_expect_tx(full + s, Tile<WT>::kStageBytes);
    wft::tma_load_5d(smem + s * Tile<WT>::kStageBytes, map, full + s, it.c0, it.w0 - 1,
                     it.h0 - 1, p, it.b);
    ++n;
    if (++p == q.D && ++i < i1) it = decode<WT>(q, i), p = 0;
  }
};

template <int WT>
__global__ void __launch_bounds__(kWarps * 32, 1)
    dwconv3_ring_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ w,
                        const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                        RingPlan q) {
  using T = Tile<WT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - wft::smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * T::kStageBytes);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long i0 = (long long)blockIdx.x * q.items_per_block;
  const long long i1 = min(i0 + q.items_per_block, q.items);
  const bool producer = tid == 0;
  Producer<WT> prod;
  if (producer) {
    for (int s = 0; s < kStages; ++s) {
      wft::mbar_init(full + s, 1);
      wft::mbar_init(empty + s, kWarps);
    }
    wft::mbar_init_fence();
    prod.start(q, i0, i1);
    for (int s = 0; s < kStages; ++s) prod.issue(q, &xmap, smem, full, empty);
  }
  __syncthreads();

  // warp → the 2 × 8 patch at (hr0, wr0) and the channel group g of each
  // tile; warps w and w + 4 share a scheduler and take the two W halves (or
  // channel groups)
  const int hr0 = warp % (kHT / kHR) * kHR;
  const int half = warp / (kHT / kHR);
  const int wr0 = WT == 16 ? half * kWR : 0, g = WT == 16 ? 0 : half;
  const uint8_t* lane_src = smem + (hr0 * (WT + 2) + wr0) * T::kRowBytes + g * 128 + lane * 4;
  int n = 0;  // planes consumed
  Acc acc;
  for (long long i = i0; i < i1; ++i) {
    const Item it = decode<WT>(q, i);
    const int ch = it.c0 + g * 64 + 2 * lane;
    const bool live = ch < q.C;
    float2 tap[27];
#pragma unroll
    for (int t = 0; t < 27; ++t)
      tap[t] = live ? *reinterpret_cast<const float2*>(w + (long long)t * q.C + ch)
                    : make_float2(0.f, 0.f);
    const float2 bs = live && bias != nullptr ? *reinterpret_cast<const float2*>(bias + ch)
                                              : make_float2(0.f, 0.f);
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int r = 0; r < kHR; ++r)
#pragma unroll
        for (int c = 0; c < kWR; ++c) acc[s][r][c][0] = bs.x, acc[s][r][c][1] = bs.y;
    const int hp = it.h0 + hr0, wp = it.w0 + wr0;
    // a patch outside the volume (or a channel group past C) only keeps the ring's count
    const bool inside = hp < q.H && wp < q.W && it.c0 + g * 64 < q.C;
    // one input plane p with accumulator roles J: refill the stage the
    // previous plane used, wait for this one's, feed it in, free it, then
    // store output p − 1 (complete now), and output p if p is the last
    // plane of the volume
    auto step = [&](auto j, int p) {
      constexpr int J = decltype(j)::value;
      if (producer && n > 0) prod.issue(q, &xmap, smem, full, empty);
      const int s = n % kStages;
      wft::mbar_wait_or_trap(full + s, (n / kStages) & 1);
      if (inside) ring_plane<WT, J>(acc, lane_src + s * T::kStageBytes, tap, bs);
      __syncwarp();
      if (lane == 0) wft::mbar_arrive(empty + s);
      ++n;
      if (!inside) return;
      if (p >= 1) ring_store<J % 3>(acc, y, q, it, hp, wp, ch, p - 1);
      if (p == q.D - 1) ring_store<(J + 1) % 3>(acc, y, q, it, hp, wp, ch, p);
    };
    for (int p = 0;;) {
      step(std::integral_constant<int, 0>(), p);
      if (++p == q.D) break;
      step(std::integral_constant<int, 1>(), p);
      if (++p == q.D) break;
      step(std::integral_constant<int, 2>(), p);
      if (++p == q.D) break;
    }
  }
}

template <int WT>
cudaError_t launch_ring(const void* x, const float* w, const float* bias, void* y, int B, int D,
                        int H, int W, int C, cudaStream_t stream) {
  using T = Tile<WT>;
  RingPlan q{B, D, H, W, C};
  q.th = (H + kHT - 1) / kHT;
  q.tw = (W + WT - 1) / WT;
  q.tc = (C + T::kCT - 1) / T::kCT;
  CUtensorMap xmap;
  const uint64_t dims[5] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)D, (uint64_t)B};
  const uint64_t strides[4] = {(uint64_t)C * 2, (uint64_t)W * C * 2, (uint64_t)H * W * C * 2,
                               (uint64_t)D * H * W * C * 2};
  const uint32_t box[5] = {T::kCT, WT + 2, kHT + 2, 1, 1};
  cudaError_t err = wft::make_map_bf16(&xmap, x, 5, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  const size_t smem = 1024 + kStages * T::kStageBytes + 2 * kStages * 8;
  err = cudaFuncSetAttribute(dwconv3_ring_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dwconv3_ring_kernel<WT>,
                                                      kWarps * 32, smem);
  if (err != cudaSuccess) return err;
  const long long slots = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  q.items = (long long)B * q.th * q.tw * q.tc;
  const long long per = (q.items + slots - 1) / slots;
  if (per > 0x7fffffffLL) return cudaErrorInvalidValue;
  q.items_per_block = (int)per;
  const long long blocks = (q.items + per - 1) / per;
  dwconv3_ring_kernel<WT><<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      xmap, w, bias, static_cast<__nv_bfloat16*>(y), q);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The weight gradient (see the header): partial tap sums a block, then
// `wgrad_sum_kernel`. A partial is 28 rows (the 27 taps in kd → kh → kw
// order, then Σ g) of `cp` channels.

constexpr int kSums = 28;

// Sum the blocks' partials in block order: one thread per (row, channel).
__global__ void wgrad_sum_kernel(const float* __restrict__ part, int blocks, int cp, int C,
                                 float* __restrict__ dk, float* __restrict__ db) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kSums * C) return;
  const int t = e / C, c = e % C;
  float s = 0.f;
  for (int j = 0; j < blocks; ++j) s += part[((long long)j * kSums + t) * cp + c];
  if (t < 27) {
    dk[t * C + c] = s;
  } else if (db != nullptr) {
    db[c] = s;
  }
}

cudaError_t launch_wgrad_sum(const float* part, int blocks, int cp, int C, float* dk, float* db,
                             cudaStream_t stream) {
  const int n = kSums * C;
  wgrad_sum_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, blocks, cp, C, dk, db);
  return cudaGetLastError();
}

// Where the partials go: `blocks` along x of the grid (each a partial of
// every channel tile), `tiles` channel tiles of `ct` channels along y.
struct WgradGrid {
  int blocks, tiles, ct;
  long long floats() const { return (long long)blocks * kSums * tiles * ct; }
};

// The vector wgrad: a block of 4 warps owns 64 channels (lane l: 2l, 2l + 1,
// element by element, masked past C); each warp walks whole voxel columns
// (b, h, w) along D with the g of planes p + 1, p, p − 1 in registers, so
// each x element is loaded 9 times (from L1) and each g element once.
constexpr int kVecWarps = 4;

template <typename T>
__global__ void __launch_bounds__(kVecWarps * 32) wgrad_vector_kernel(
    const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part, int B, int D,
    int H, int W, int C, int cp) {
  __shared__ float red[kVecWarps][kSums][64];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ch = blockIdx.y * 64 + 2 * lane;
  const bool v0 = ch < C, v1 = ch + 1 < C;
  const long long plane = (long long)H * W * C;
  const long long cols = (long long)B * H * W;
  auto load = [&](const T* p) {
    return make_float2(v0 ? wft::to_f(p[ch]) : 0.f, v1 ? wft::to_f(p[ch + 1]) : 0.f);
  };
  float acc[27][2], gs[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < 27; ++t) acc[t][0] = acc[t][1] = 0.f;
  for (long long col = (long long)blockIdx.x * kVecWarps + warp; col < cols;
       col += (long long)gridDim.x * kVecWarps) {
    const int wi = (int)(col % W), hi = (int)((col / W) % H);
    const long long bi = col / ((long long)W * H);
    const T* xb = x + bi * D * plane;
    const T* gb = g + bi * D * plane + ((long long)hi * W + wi) * C;
    float2 glo = make_float2(0.f, 0.f), gmid = glo, ghi = load(gb);
    gs[0] += ghi.x, gs[1] += ghi.y;
    for (int p = 0; p < D; ++p) {
      glo = gmid, gmid = ghi;  // g planes p − 1, p, then p + 1 (zero at D)
      ghi = make_float2(0.f, 0.f);
      if (p + 1 < D) {
        ghi = load(gb + (p + 1) * plane);
        gs[0] += ghi.x, gs[1] += ghi.y;
      }
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const int hh = hi + kh - 1;
        if (hh < 0 || hh >= H) continue;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int ww = wi + kw - 1;
          if (ww < 0 || ww >= W) continue;
          // x at plane p pairs with g at p + 1 (kd = 0), p (kd = 1), p − 1 (kd = 2)
          const float2 a = load(xb + p * plane + ((long long)hh * W + ww) * C);
          float* t0 = acc[kh * 3 + kw];
          float* t1 = acc[9 + kh * 3 + kw];
          float* t2 = acc[18 + kh * 3 + kw];
          t0[0] = fmaf(a.x, ghi.x, t0[0]), t0[1] = fmaf(a.y, ghi.y, t0[1]);
          t1[0] = fmaf(a.x, gmid.x, t1[0]), t1[1] = fmaf(a.y, gmid.y, t1[1]);
          t2[0] = fmaf(a.x, glo.x, t2[0]), t2[1] = fmaf(a.y, glo.y, t2[1]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 27; ++t) {
    red[warp][t][2 * lane] = acc[t][0];
    red[warp][t][2 * lane + 1] = acc[t][1];
  }
  red[warp][27][2 * lane] = gs[0], red[warp][27][2 * lane + 1] = gs[1];
  __syncthreads();
  for (int e = threadIdx.x; e < kSums * 64; e += blockDim.x) {
    const int t = e / 64, cl = e % 64;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kVecWarps; ++w) s += red[w][t][cl];
    part[((long long)blockIdx.x * kSums + t) * cp + blockIdx.y * 64 + cl] = s;
  }
}

WgradGrid vector_wgrad_grid(int B, int H, int W, int C) {
  WgradGrid q;
  q.ct = 64;
  q.tiles = (C + 63) / 64;
  const long long warps = (long long)B * H * W;  // one voxel column each at most
  const long long want = (8LL * sm_count() + q.tiles - 1) / q.tiles;
  q.blocks = (int)std::max(1LL, std::min(want, (warps + kVecWarps - 1) / kVecWarps));
  return q;
}

template <typename T>
cudaError_t launch_vector_wgrad(const void* x, const void* g, float* part, const WgradGrid& q,
                                int B, int D, int H, int W, int C, cudaStream_t stream) {
  dim3 grid((unsigned)q.blocks, (unsigned)q.tiles);
  wgrad_vector_kernel<T><<<grid, kVecWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), part, B, D, H, W, C, q.ct * q.tiles);
  return cudaGetLastError();
}

// The tma_ring wgrad. A stage holds x's input plane p as the forward's box
// (one-voxel halo, TMA's zero fill as the padding) and g's plane p + 1 as
// a box of the tile itself; a tile's stages run p = −1 … D − 1 (no x box at
// p = −1, no g box at p = D − 1). Each warp keeps its 2 × 8 patch of the
// last three g planes as fp32 registers, sets whose roles rotate statically
// (the D loop is unrolled by 3, as the forward's accumulators are), and
// every lane its two channels' 27 tap sums and Σ g, across every tile the
// block visits: a block owns one channel tile and a run of spatial tiles.
template <int WT>
struct WgradTile {
  static constexpr int kXBytes = Tile<WT>::kStageBytes;
  static constexpr int kGBytes = kHT * WT * Tile<WT>::kRowBytes;
  static constexpr int kStageBytes = kXBytes + kGBytes;
};

struct WgradPlan {
  int B, D, H, W, C;
  int th, tw;
  long long items;  // spatial tiles (b, h, w), each marched along all of D
  int items_per_block;
};

template <int WT>
__device__ __forceinline__ void decode_spatial(const WgradPlan& q, long long i, int& b, int& h0,
                                               int& w0) {
  w0 = (int)(i % q.tw) * WT;
  i /= q.tw;
  h0 = (int)(i % q.th) * kHT;
  b = (int)(i / q.th);
}

using GSets = float2[3][kHR][kWR];

// g's plane into set J, and onto the lane's Σ g. `src`: the stage's g box
// at this lane's word of the patch's first voxel.
template <int WT, int J>
__device__ __forceinline__ void wgrad_load_g(GSets& gv, float (&gs)[2], const uint8_t* src) {
  constexpr int kRow = Tile<WT>::kRowBytes;
#pragma unroll
  for (int r = 0; r < kHR; ++r)
#pragma unroll
    for (int c = 0; c < kWR; ++c) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(src + (r * WT + c) * kRow);
      const float2 v = make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
      gv[J][r][c] = v;
      gs[0] += v.x, gs[1] += v.y;
    }
}

// x's plane p against g's planes p + 1 (set J, kd = 0), p (set (J + 2) % 3,
// kd = 1) and p − 1 (set (J + 1) % 3, kd = 2). `src`: the stage's x box at
// this lane's word of the patch's first halo row and column.
template <int WT, int J>
__device__ __forceinline__ void wgrad_plane(float (&acc)[27][2], const uint8_t* src,
                                            const GSets& gv) {
  constexpr int G0 = J, G1 = (J + 2) % 3, G2 = (J + 1) % 3;
  constexpr int kRow = Tile<WT>::kRowBytes;
#pragma unroll
  for (int hh = 0; hh < kHR + 2; ++hh) {
    float2 v[kWR + 2];
#pragma unroll
    for (int c = 0; c < kWR + 2; ++c) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(src + (hh * (WT + 2) + c) * kRow);
      v[c] = make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
    }
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int r = hh - kh;  // the patch row this x row meets through kh
      if (r < 0 || r >= kHR) continue;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        float* t0 = acc[kh * 3 + kw];
        float* t1 = acc[9 + kh * 3 + kw];
        float* t2 = acc[18 + kh * 3 + kw];
#pragma unroll
        for (int c = 0; c < kWR; ++c) {
          const float2 a = v[c + kw];
          t0[0] = fmaf(a.x, gv[G0][r][c].x, t0[0]), t0[1] = fmaf(a.y, gv[G0][r][c].y, t0[1]);
          t1[0] = fmaf(a.x, gv[G1][r][c].x, t1[0]), t1[1] = fmaf(a.y, gv[G1][r][c].y, t1[1]);
          t2[0] = fmaf(a.x, gv[G2][r][c].x, t2[0]), t2[1] = fmaf(a.y, gv[G2][r][c].y, t2[1]);
        }
      }
    }
  }
}

// The block's stages in order, issued by one thread (lane 0 of warp 0).
template <int WT>
struct WgradProducer {
  long long i, i1;
  int b, h0, w0, c0;
  int p, n;  // the stage's x plane (−1 … D − 1), and the ring uses issued so far

  __device__ void start(const WgradPlan& q, long long i0, long long end, int c) {
    i = i0, i1 = end, n = 0, c0 = c;
    if (i < i1) decode_spatial<WT>(q, i, b, h0, w0), p = -1;
  }

  __device__ void issue(const WgradPlan& q, const CUtensorMap* xmap, const CUtensorMap* gmap,
                        uint8_t* smem, uint64_t* full, uint64_t* empty) {
    using S = WgradTile<WT>;
    if (i >= i1) return;
    const int s = n % kStages;
    if (n >= kStages) wft::mbar_wait_or_trap(empty + s, (n / kStages - 1) & 1);
    const bool has_x = p >= 0, has_g = p + 1 < q.D;
    wft::mbar_arrive_expect_tx(full + s, (has_x ? S::kXBytes : 0) + (has_g ? S::kGBytes : 0));
    uint8_t* stage = smem + s * S::kStageBytes;
    if (has_x) wft::tma_load_5d(stage, xmap, full + s, c0, w0 - 1, h0 - 1, p, b);
    if (has_g) wft::tma_load_5d(stage + S::kXBytes, gmap, full + s, c0, w0, h0, p + 1, b);
    ++n;
    if (++p == q.D && ++i < i1) decode_spatial<WT>(q, i, b, h0, w0), p = -1;
  }
};

template <int WT>
__global__ void __launch_bounds__(kWarps * 32, 1)
    wgrad_ring_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap gmap, float* __restrict__ part,
                      WgradPlan q) {
  using T = Tile<WT>;
  using S = WgradTile<WT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - wft::smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * S::kStageBytes);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.y * T::kCT;
  const long long i0 = (long long)blockIdx.x * q.items_per_block;
  const long long i1 = min(i0 + q.items_per_block, q.items);
  const bool producer = tid == 0;
  WgradProducer<WT> prod;
  if (producer) {
    for (int s = 0; s < kStages; ++s) {
      wft::mbar_init(full + s, 1);
      wft::mbar_init(empty + s, kWarps);
    }
    wft::mbar_init_fence();
    prod.start(q, i0, i1, c0);
    for (int s = 0; s < kStages; ++s) prod.issue(q, &xmap, &gmap, smem, full, empty);
  }
  __syncthreads();

  // warp → patch and channel group, as in the forward
  const int hr0 = warp % (kHT / kHR) * kHR;
  const int half = warp / (kHT / kHR);
  const int wr0 = WT == 16 ? half * kWR : 0, g = WT == 16 ? 0 : half;
  const uint8_t* x_src = smem + (hr0 * (WT + 2) + wr0) * T::kRowBytes + g * 128 + lane * 4;
  const uint8_t* g_src =
      smem + S::kXBytes + (hr0 * WT + wr0) * T::kRowBytes + g * 128 + lane * 4;
  float acc[27][2], gs[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < 27; ++t) acc[t][0] = acc[t][1] = 0.f;
  GSets gv;
  int n = 0;  // stages consumed
  for (long long i = i0; i < i1; ++i) {
    int b, h0, w0;
    decode_spatial<WT>(q, i, b, h0, w0);
    // a patch outside the volume (or a channel group past C) only keeps the ring's count
    const bool inside = h0 + hr0 < q.H && w0 + wr0 < q.W && c0 + g * 64 < q.C;
#pragma unroll
    for (int r = 0; r < kHR; ++r)
#pragma unroll
      for (int c = 0; c < kWR; ++c) gv[2][r][c] = make_float2(0.f, 0.f);  // g plane −1
    // the stage of x plane p and g plane p + 1 into set J = (p + 1) % 3
    auto step = [&](auto j, int p) {
      constexpr int J = decltype(j)::value;
      if (producer && n > 0) prod.issue(q, &xmap, &gmap, smem, full, empty);
      const int s = n % kStages;
      wft::mbar_wait_or_trap(full + s, (n / kStages) & 1);
      if (inside) {
        const int off = s * S::kStageBytes;
        if (p + 1 < q.D) {
          wgrad_load_g<WT, J>(gv, gs, g_src + off);
        } else {
#pragma unroll
          for (int r = 0; r < kHR; ++r)
#pragma unroll
            for (int c = 0; c < kWR; ++c) gv[J][r][c] = make_float2(0.f, 0.f);
        }
        if (p >= 0) wgrad_plane<WT, J>(acc, x_src + off, gv);
      }
      __syncwarp();
      if (lane == 0) wft::mbar_arrive(empty + s);
      ++n;
    };
    step(std::integral_constant<int, 0>(), -1);
    for (int p = 0;;) {
      step(std::integral_constant<int, 1>(), p);
      if (++p == q.D) break;
      step(std::integral_constant<int, 2>(), p);
      if (++p == q.D) break;
      step(std::integral_constant<int, 0>(), p);
      if (++p == q.D) break;
    }
  }

  // every stage has landed and been consumed: the ring's memory takes the
  // warps' sums, added up in warp order for each channel group
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [warp][kSums][64]
#pragma unroll
  for (int t = 0; t < 27; ++t) {
    red[(warp * kSums + t) * 64 + 2 * lane] = acc[t][0];
    red[(warp * kSums + t) * 64 + 2 * lane + 1] = acc[t][1];
  }
  red[(warp * kSums + 27) * 64 + 2 * lane] = gs[0];
  red[(warp * kSums + 27) * 64 + 2 * lane + 1] = gs[1];
  __syncthreads();
  constexpr int kPerGroup = kWarps / T::kGroups;
  const int cp = gridDim.y * T::kCT;
  for (int e = tid; e < kSums * T::kCT; e += blockDim.x) {
    const int t = e / T::kCT, cl = e % T::kCT, grp = cl / 64;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kPerGroup; ++w)
      s += red[((grp * kPerGroup + w) * kSums + t) * 64 + cl % 64];
    part[((long long)blockIdx.x * kSums + t) * cp + c0 + cl] = s;
  }
}

// One block per SM (the ring takes 158-168 KB), the SMs shared out over the
// channel tiles, each block's run of spatial tiles of equal length.
template <int WT>
WgradGrid ring_wgrad_grid(int B, int H, int W, int C, WgradPlan* plan) {
  WgradPlan q{B, 0, H, W, C};
  q.th = (H + kHT - 1) / kHT;
  q.tw = (W + WT - 1) / WT;
  q.items = (long long)B * q.th * q.tw;
  WgradGrid grid;
  grid.ct = Tile<WT>::kCT;
  grid.tiles = (C + grid.ct - 1) / grid.ct;
  const long long want = std::max(1, sm_count() / grid.tiles);
  const long long per = (q.items + want - 1) / want;
  q.items_per_block = (int)std::min(per, 0x7fffffffLL);
  grid.blocks = (int)((q.items + per - 1) / per);
  if (plan != nullptr) *plan = q;
  return grid;
}

template <int WT>
cudaError_t launch_ring_wgrad(const void* x, const void* g, float* part, int B, int D, int H,
                              int W, int C, cudaStream_t stream) {
  using T = Tile<WT>;
  WgradPlan q;
  const WgradGrid grid = ring_wgrad_grid<WT>(B, H, W, C, &q);
  q.D = D;
  const uint64_t dims[5] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)D, (uint64_t)B};
  const uint64_t strides[4] = {(uint64_t)C * 2, (uint64_t)W * C * 2, (uint64_t)H * W * C * 2,
                               (uint64_t)D * H * W * C * 2};
  const uint32_t xbox[5] = {T::kCT, WT + 2, kHT + 2, 1, 1};
  const uint32_t gbox[5] = {T::kCT, WT, kHT, 1, 1};
  CUtensorMap xmap, gmap;
  cudaError_t err =
      wft::make_map_bf16(&xmap, x, 5, dims, strides, xbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  err = wft::make_map_bf16(&gmap, g, 5, dims, strides, gbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  const size_t smem = 1024 + kStages * WgradTile<WT>::kStageBytes + 2 * kStages * 8;
  err = cudaFuncSetAttribute(wgrad_ring_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 blocks((unsigned)grid.blocks, (unsigned)grid.tiles);
  wgrad_ring_kernel<WT><<<blocks, kWarps * 32, smem, stream>>>(xmap, gmap, part, q);
  return cudaGetLastError();
}

WgradGrid wgrad_grid(int dtype, int B, int H, int W, int C) {
  if (design_of(dtype, C) == kTmaRing) {
    return W <= 8 ? ring_wgrad_grid<8>(B, H, W, C, nullptr)
                  : ring_wgrad_grid<16>(B, H, W, C, nullptr);
  }
  return vector_wgrad_grid(B, H, W, C);
}

}  // namespace

// The design wft_dwconv3 launches for these arguments: 0 = vector, 1 = tma_ring.
extern "C" int wft_dwconv3_design(int dtype, int c) { return design_of(dtype, c); }

// Returns a cudaError_t (0 on success). `bias` may be null. For the tma_ring
// design x must be 16-byte aligned, as the vector design needs at C % 8 == 0.
extern "C" int wft_dwconv3(int dtype, const void* x, const void* w, const void* bias, void* y,
                           int B, int D, int H, int W, int C, void* stream) {
  if (C < 1 || B < 1 || D < 1 || H < 1 || W < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  const bool tail = C % 8 != 0;
  if (dtype == wft::kFloat32) {
    return (int)(tail ? launch_vector<float, true>(x, wf, bf, y, B, D, H, W, C, s)
                      : launch_vector<float, false>(x, wf, bf, y, B, D, H, W, C, s));
  }
  if (dtype == wft::kBFloat16) {
    if (design_of(dtype, C) == kTmaRing) {
      return (int)(W <= 8 ? launch_ring<8>(x, wf, bf, y, B, D, H, W, C, s)
                          : launch_ring<16>(x, wf, bf, y, B, D, H, W, C, s));
    }
    return (int)launch_vector<__nv_bfloat16, true>(x, wf, bf, y, B, D, H, W, C, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The design wft_dwconv3_wgrad launches for these arguments (the forward's
// rule): 0 = vector, 1 = tma_ring.
extern "C" int wft_dwconv3_wgrad_design(int dtype, int c) { return design_of(dtype, c); }

// fp32 elements of the partials buffer wft_dwconv3_wgrad needs for these
// arguments (the card's SM count sets the grid); -1 for arguments it refuses.
extern "C" long long wft_dwconv3_wgrad_workspace(int dtype, int B, int D, int H, int W, int C) {
  if (C < 1 || B < 1 || D < 1 || H < 1 || W < 1) return -1;
  if (dtype != wft::kFloat32 && dtype != wft::kBFloat16) return -1;
  return wgrad_grid(dtype, B, H, W, C).floats();
}

// The weight gradient of the stencil for x and its output gradient g, both
// (B, D, H, W, C) of `dtype`: dk (27, C) fp32, dk[kd·9 + kh·3 + kw][c] =
// Σ x[b, d + kd − 1, h + kh − 1, w + kw − 1, c] · g[b, d, h, w, c] (zero
// outside the volume), and, when `db` is not null, db (C,) = Σ g. `part`
// holds `part_floats` fp32 scratch elements, at least
// wft_dwconv3_wgrad_workspace's count. Two launches (the partials, then their
// sum in a fixed order): the same inputs give the same bits. Returns a
// cudaError_t (0 on success); for the tma_ring design x and g must be 16-byte
// aligned.
extern "C" int wft_dwconv3_wgrad(int dtype, const void* x, const void* g, void* part,
                                 long long part_floats, void* dk, void* db, int B, int D, int H,
                                 int W, int C, void* stream) {
  const long long need = wft_dwconv3_wgrad_workspace(dtype, B, D, H, W, C);
  if (need < 0 || part_floats < need) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  const WgradGrid grid = wgrad_grid(dtype, B, H, W, C);
  cudaError_t err;
  if (design_of(dtype, C) == kTmaRing) {
    err = W <= 8 ? launch_ring_wgrad<8>(x, g, pf, B, D, H, W, C, s)
                 : launch_ring_wgrad<16>(x, g, pf, B, D, H, W, C, s);
  } else if (dtype == wft::kFloat32) {
    err = launch_vector_wgrad<float>(x, g, pf, grid, B, D, H, W, C, s);
  } else {
    err = launch_vector_wgrad<__nv_bfloat16>(x, g, pf, grid, B, D, H, W, C, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wgrad_sum(pf, grid.blocks, grid.ct * grid.tiles, C,
                               static_cast<float*>(dk), static_cast<float*>(db), s);
}
