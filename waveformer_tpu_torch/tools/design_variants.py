"""Time design variants of a hand-written kernel against the committed source.

    python -m waveformer_tpu_torch.tools.design_variants [--kernel tiled_matmul|conv3|conv3_dhwc|window_attention|dwconv3|ffn_tail] [--iters 32]

A variant is the committed `csrc/<source>.cu` with a few text substitutions
(tile sizes, ring depth, warpgroups, the exponential, D segments, the
halo's layout, the prologue's overlap and grouping, the GELU, the split of
shared memory between y and a streamed weight), listed in `VARIANTS`; `conv3` is the (D, H, C, W)
design of `csrc/conv3.cu` and `conv3_dhwc` its channels-last TMA design,
timed in both forms (the conv alone, and with the InstanceNorm prologue and
the statistics). Each is built
with the port's nvcc flags into `_build/variants/`, then swapped in for the
committed library, so the public wrappers run it unchanged: every variant
is first held against the plain version, then timed with CUDA events at the
shapes of its path, in turns (the variants in order, then in reverse). One
JSON line per (variant, shape, pass), with the card's name. CUDA only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
from typing import Dict, List, Tuple

import torch

from waveformer_tpu_torch.ops import _build
from waveformer_tpu_torch.ops import conv_cuda
from waveformer_tpu_torch.ops import dwconv_cuda
from waveformer_tpu_torch.ops import ffn_tail_cuda
from waveformer_tpu_torch.ops import fused_conv_cuda
from waveformer_tpu_torch.ops import tiled_matmul_cuda as tm
from waveformer_tpu_torch.ops.attention_cuda import window_attention, window_attention_reference
from waveformer_tpu_torch.utils.profiling import device_time

# the exp2 of one variant of window_attention.cu
POLY_EXP2 = r"""// 2^x on the FMA pipe: Cody-Waite split x = i + f (|f| ≤ 1/2, i by the
// 1.5·2^23 rounding trick), 2^f as a degree-4 polynomial (relative error
// ≤ 4e-5, below bf16's 2^-9), 2^i added to the exponent bits
__device__ __forceinline__ float exp2_fma(float x) {
  x = fmaxf(x, -126.f);
  const float j = x + 12582912.f;
  const float f = x - (j - 12582912.f);
  float p = fmaf(f, 9.6181291e-3f, 5.5504109e-2f);
  p = fmaf(p, f, 2.4022651e-1f);
  p = fmaf(p, f, 6.9314718e-1f);
  p = fmaf(p, f, 1.f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(j) << 23));
}

// ex2.approx: 2^x on the special-function unit (−∞ → +0)"""


def _dw_segments(per_block: int) -> List[Tuple[str, str]]:
    """dwconv3.cu with each tile's D cut into segments wherever the tiles
    alone give a block fewer than `per_block` items (balance across SMs;
    each segment re-reads its two halo planes)."""
    return [
        ("  long long items;", "  int seg_len, nseg;\n  long long items;"),
        ("struct Item {\n  int b, h0, w0, c0;\n};",
         "struct Item {\n  int b, h0, w0, c0, d0, d1, p0, p1;\n};"),
        ("  Item it;\n  it.c0 = (int)(i % q.tc)",
         "  Item it;\n  const int seg = (int)(i % q.nseg);\n  i /= q.nseg;\n"
         "  it.d0 = seg * q.seg_len, it.d1 = min(it.d0 + q.seg_len, q.D);\n"
         "  it.p0 = max(it.d0 - 1, 0), it.p1 = min(it.d1, q.D - 1);\n"
         "  it.c0 = (int)(i % q.tc)"),
        ("decode<WT>(q, i), p = 0;", "decode<WT>(q, i), p = it.p0;"),
        ("if (++p == q.D && ++i < i1)", "if (++p > it.p1 && ++i < i1)"),
        ("    for (int p = 0;;) {", "    for (int p = it.p0;;) {"),
        ("if (++p == q.D) break;", "if (++p > it.p1) break;"),
        ("      if (p >= 1) ring_store", "      if (p - 1 >= it.d0) ring_store"),
        ("if (p == q.D - 1) ring_store", "if (p == q.D - 1 && it.d1 == q.D) ring_store"),
        ("  q.items = (long long)B * q.th * q.tw * q.tc;\n",
         "  const long long tiles = (long long)B * q.th * q.tw * q.tc;\n"
         f"  long long nseg = tiles < {per_block} * slots ? ({per_block} * slots + tiles - 1) / tiles : 1;\n"
         "  if (nseg > D) nseg = D;\n"
         "  q.seg_len = (int)((D + nseg - 1) / nseg);\n"
         "  q.nseg = (D + q.seg_len - 1) / q.seg_len;\n"
         "  q.items = tiles * q.nseg;\n"),
    ]


# conv3_dhwc: the halo's TMA load, and the first layout of the halo: two
# boxes of 8 channels (16-byte voxel rows, unswizzled, each 128-byte
# aligned), read by descriptors whose lbo is the second box's offset
_CL_HALO_LOAD = ("        wft::tma_load_5d(halo, &xmap, full + slot, c0, w0 - 1, h0 - 1, d + kd - 1, "
                 "b);\n")
_CL_HALF = "((q.box_bytes + 127) / 128 * 128)"
_CL_HALVES = [
    ("  q.box_bytes = (q.th + 2) * (q.tw + 2) * 32;\n"
     "  q.stage_bytes = (9 * BN * 32 + q.box_bytes + 1023) / 1024 * 1024;",
     "  q.box_bytes = (q.th + 2) * (q.tw + 2) * 16;\n"
     f"  q.stage_bytes = (9 * BN * 32 + 2 * {_CL_HALF} + 1023) / 1024 * 1024;"),
    ("template <int BN>\n__device__ __forceinline__ uint64_t cl_desc_b(",
     "__device__ __forceinline__ uint64_t cl_desc_a16(uint32_t halo, int cell, int row_cells,\n"
     "                                                int half) {\n"
     "  return wft::wgmma_desc(halo + cell * 16, half, row_cells * 16, wft::kSwizzleNone);\n}\n\n"
     "template <int BN>\n__device__ __forceinline__ uint64_t cl_desc_b("),
    ("wft::mbar_arrive_expect_tx(full + slot, 9 * BN * 32 + q.box_bytes);",
     "wft::mbar_arrive_expect_tx(full + slot, 9 * BN * 32 + 2 * q.box_bytes);"),
    (_CL_HALO_LOAD, _CL_HALO_LOAD + f"        wft::tma_load_5d(halo + {_CL_HALF}, &xmap, full + slot, "
     "c0 + 8, w0 - 1, h0 - 1, d + kd - 1, b);\n"),
    ("      off[k] = in ? (int)swizzled(16 * e, 32) : -1;",
     f"      off[k] = in ? (e & 1) * {_CL_HALF} + e / 2 * 16 : -1;"),
    ("acc[i], cl_desc_a(halo, cell0[i] + shift, row_cells),",
     f"acc[i], cl_desc_a16(halo, cell0[i] + shift, row_cells, {_CL_HALF}),"),
    ("  const uint32_t xbox[5] = {16, (uint32_t)q.tw + 2, (uint32_t)q.th + 2, 1, 1};\n"
     "  cudaError_t err =\n"
     "      wft::make_map_bf16(&xmap, p.x, 5, xdims, xstr, xbox, CU_TENSOR_MAP_SWIZZLE_32B);",
     "  const uint32_t xbox[5] = {8, (uint32_t)q.tw + 2, (uint32_t)q.th + 2, 1, 1};\n"
     "  cudaError_t err =\n"
     "      wft::make_map_bf16(&xmap, p.x, 5, xdims, xstr, xbox, CU_TENSOR_MAP_SWIZZLE_NONE);"),
]

# ffn_tail.cu's first plan: one block an SM, no N groups; the weight
# resident where it fits beside two stages of y, else y in a ring of up to 4
# stages (2 at 768 → 192, 1 at 1536 → 384) and the weight in what is left (2
# chunks), row block i + stages − 1 loaded before block i's weight
_FFN_FIRST_PLAN = [
    ("constexpr int kPairBN = 48;", "constexpr int kPairBN = 0;"),
    ("""    p.stages = 1;
    p.wslots = (int)std::min<long long>(kMaxWSlots, (one - stage) / chunk);
    if (p.wslots < 2) return cudaErrorInvalidValue;  // Ch too wide for one stage""",
     """    p.stages = (int)std::min<long long>(kMaxStages, (one - 2 * chunk) / stage);
    p.wslots = (int)std::min<long long>(2, (one - p.stages * stage) / chunk);
    if (p.stages < 1) return cudaErrorInvalidValue;"""),
    ("  p.ng = (int)std::max<long long>(1, std::min<long long>(p.nt, slots / p.rblocks));",
     "  p.ng = 1;"),
    ("""        const int ahead = min(p.wslots, nchunks);
        long long wc = 0;
        for (long long i = 0; i < nrb; ++i) {
          for (int c = 0; c < nchunks; ++c, ++wc) {
            if (c == ahead) load_y(i);""",
     """        for (long long i = 0; i < nrb && i < p.stages - 1; ++i) load_y(i);
        long long wc = 0;
        for (long long i = 0; i < nrb; ++i) {
          if (i + p.stages - 1 < nrb) load_y(i + p.stages - 1);
          for (int c = 0; c < nchunks; ++c, ++wc) {"""),
    ("""          if (ahead == nchunks) load_y(i);\n""", ""),
]

# name → substitutions (old, new) on the committed source; the first is it
VARIANTS: Dict[str, Dict[str, List[Tuple[str, str]]]] = {
    "tiled_matmul": {
        "persistent, 128x256, 4 stages (committed)": [],
        "one block per tile": [
            ("const int grid = (int)(tiles < sms ? tiles : sms);", "const int grid = (int)tiles;")],
        "persistent, 3 stages": [("kWgStages = 4;", "kWgStages = 3;")],
    },
    "window_attention": {
        "3 consumer warpgroups at D = 16, 128-key tiles (committed)": [],
        "2 consumer warpgroups (the first TMA design)": [("return D == 16 ? 3 : 2;", "return 2;")],
        "a quarter of the exponentials as an FMA-pipe polynomial": [
            ("// ex2.approx: 2^x on the special-function unit (−∞ → +0)", POLY_EXP2),
            ("const float p00 = ex2(s[4 * j] - m0), p01 = ex2(s[4 * j + 1] - m0);\n"
             "          const float p10 = ex2(s[4 * j + 2] - m1), p11 = ex2(s[4 * j + 3] - m1);",
             "const bool fma_pipe = j % 4 == 3;  // unrolled: decided at compile time\n"
             "          const float p00 = fma_pipe ? exp2_fma(s[4 * j] - m0) : ex2(s[4 * j] - m0);\n"
             "          const float p01 = fma_pipe ? exp2_fma(s[4 * j + 1] - m0) : ex2(s[4 * j + 1] - m0);\n"
             "          const float p10 = fma_pipe ? exp2_fma(s[4 * j + 2] - m1) : ex2(s[4 * j + 2] - m1);\n"
             "          const float p11 = fma_pipe ? exp2_fma(s[4 * j + 3] - m1) : ex2(s[4 * j + 3] - m1);")],
        "64-key tiles at every head dim": [("return D <= 32 ? 128 : 64;", "return 64;")],
    },
    "conv3": {
        "4 warpgroups (committed)": [],
        "2 warpgroups, twice the M tiles (the first wgmma design)": [
            ("constexpr int tma_wgs() {\n  return 4;", "constexpr int tma_wgs() {\n  return 2;"),
            ("constexpr int tma_mt() {\n  return BN <= 48 ? 2 : 1;",
             "constexpr int tma_mt() {\n  return BN <= 48 ? 4 : 2;")],
        "6 warpgroups × 1 M tile at BN ≤ 48": [
            ("constexpr int tma_wgs() {\n  return 4;",
             "constexpr int tma_wgs() {\n  return BN <= 48 ? 6 : 4;"),
            ("constexpr int tma_mt() {\n  return BN <= 48 ? 2 : 1;",
             "constexpr int tma_mt() {\n  return 1;")],
        "ring of 2 stages": [("if (q.stages > 4) q.stages = 4;", "if (q.stages > 2) q.stages = 2;")],
        "two groups in flight": [
            ("wft::wgmma_wait<1>();\n        if (s > 0 && mt == 0 && kh == 0)",
             "wft::wgmma_wait<2>();\n        if (s > 0 && mt == 0 && kh == 1)")],
    },
    "conv3_dhwc": {
        "32-byte voxel rows, 16 x 32 voxels at BN <= 48, 4 stages, prologue overlapped (committed)": [],
        "16 x 16 voxels at every BN (2 M tiles a warpgroup)": [
            ("constexpr int cl_mt(int BN) { return BN <= 48 ? 4 : 2; }",
             "constexpr int cl_mt(int BN) { return 2; }")],
        "ring of 2 stages": [("  q.stages = 4;\n  while (q.stages >= 2", "  q.stages = 2;\n  while (q.stages >= 2")],
        "ring of up to 6 stages": [("  q.stages = 4;\n  while (q.stages >= 2", "  q.stages = 6;\n  while (q.stages >= 2")],
        # the same result with twice the TMA work of one operand: how much of
        # a stage's time the copies take
        "halo box loaded twice": [
            ("wft::mbar_arrive_expect_tx(full + slot, 9 * BN * 32 + q.box_bytes);",
             "wft::mbar_arrive_expect_tx(full + slot, 9 * BN * 32 + 2 * q.box_bytes);"),
            (_CL_HALO_LOAD, _CL_HALO_LOAD * 2)],
        "weights loaded twice": [
            ("wft::mbar_arrive_expect_tx(full + slot, 9 * BN * 32 + q.box_bytes);",
             "wft::mbar_arrive_expect_tx(full + slot, 18 * BN * 32 + q.box_bytes);"),
            ("        wft::tma_load_3d(st, &wmap, full + slot, 0, n0, (c0 / 16 * 3 + kd) * 9);\n",
             "        wft::tma_load_3d(st, &wmap, full + slot, 0, n0, (c0 / 16 * 3 + kd) * 9);\n"
             "        wft::tma_load_3d(st, &wmap, full + slot, 0, n0, (c0 / 16 * 3 + kd) * 9);\n")],
        "16-byte voxel rows in two unswizzled 8-channel boxes (the first layout)": _CL_HALVES,
        "prologue on the stage about to be multiplied (not overlapped)": [
            ("  if (kPro) {\n    ready(0);\n    wft::named_bar_sync(1, kConsumers);\n  }\n", ""),
            ("    if (!kPro) ready(s);\n",
             "    ready(s);\n    if (kPro) wft::named_bar_sync(1, kConsumers);\n"),
            ("    if (kPro) {\n      // normalise stage s + 1 while the products of stage s run\n"
             "      if (s + 1 < stages) ready(s + 1);\n      wft::named_bar_sync(1, kConsumers);\n"
             "    }\n", "")],
        "prologue pieces loaded all at once (spills at BN = 48)": [
            ("    constexpr int kGroup = 3;\n", "    constexpr int kGroup = kPieces;\n")],
        "two stages' groups in flight": [
            ("    wft::wgmma_wait<1>();\n    if (s > 0) wft::mbar_arrive(empty + (s - 1) % q.stages);",
             "    wft::wgmma_wait<2>();\n    if (s > 1) wft::mbar_arrive(empty + (s - 2) % q.stages);")],
    },
    "ffn_tail": {
        "branch-free GELU, 2 blocks an SM at 192 -> 48, N groups at 8^3 (committed)": [],
        "erff GELU (the first design)": [
            ("gelu_poly(z0), gelu_poly(z1)", "gelu_erf(z0), gelu_erf(z1)")],
        "1 block an SM, no N groups, streamed weight in 2 y stages + 2 chunks (the first design)":
            _FFN_FIRST_PLAN,
    },
    "dwconv3": {
        "whole-D march per tile (committed)": [],
        "D cut below 4 tiles per block (the first ring design)": _dw_segments(4),
        "D cut below 8 tiles per block": _dw_segments(8),
    },
}
# (M, K, N) of the int8 probe; (B, (D, H, W), C, O) of the flagship's DHCW convs;
# (B·nW, H, N, D) of the flagship's attention calls
MM_SHAPES = [(32768, 1024, 512), (16384, 2048, 512)]
ATTN_SHAPES = [(512, 3, 512, 16), (64, 6, 512, 16), (8, 3, 512, 16)]
# (B, D, H, W, C) of the flagship's depthwise convs (chip_smoke.DW_MAIN_SHAPES)
DW_SHAPES = [(8, 64, 64, 64, 192), (8, 32, 32, 32, 384), (8, 16, 16, 16, 768),
             (8, 8, 8, 8, 1536), (8, 64, 64, 64, 96)]
CONV_SHAPES = [(8, (128,) * 3, 4, 48), (8, (128,) * 3, 96, 48), (8, (64,) * 3, 96, 48),
               (8, (32,) * 3, 192, 96), (8, (16,) * 3, 384, 192)]
# (B, (D, H, W), C, O) of the channels-last TMA design: the largest and the
# smallest res-block convs of a batch-8 forward
CONV_DHWC_SHAPES = [(8, (128,) * 3, 96, 48), (8, (16,) * 3, 384, 192)]
# (B, (D, H, W), Ch, C) of the flagship's CCF-FFN tails (chip_smoke.FFN_MAIN_SHAPES)
FFN_SHAPES = [(8, (64,) * 3, 192, 48), (8, (32,) * 3, 384, 96), (8, (16,) * 3, 768, 192),
              (8, (8,) * 3, 1536, 384)]
# the source each kernel's variants edit
SOURCES = {"conv3_dhwc": "conv3"}


def build(kernel: str, name: str, subs: List[Tuple[str, str]]) -> ctypes.CDLL:
    """Compile the committed source of `kernel` with `subs` applied; raise
    if one does not apply."""
    source = SOURCES.get(kernel, kernel)
    src = open(os.path.join(_build.CSRC, f"{source}.cu")).read()
    for old, new in subs:
        if old not in src:
            raise ValueError(f"variant {name!r}: {old!r} is not in {kernel}.cu")
        src = src.replace(old, new)
    tag = "".join(c if c.isalnum() else "_" for c in name)[:48]
    out_dir = os.path.join(_build.BUILD_DIR, "variants", kernel, tag)
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(_build.CSRC):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(_build.CSRC, f), out_dir)
    cu = os.path.join(out_dir, f"{source}.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"{source}.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, cu], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(lib)


def _mm_cases(iters: int):
    for m, k, n in MM_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(m, k, device="cuda", generator=g).to(torch.bfloat16)
        w = torch.randn(k, n, device="cuda", generator=g).to(torch.bfloat16)
        s = torch.zeros(8, device="cuda")

        def check(x=x, w=w, s=s):
            got = tm.tiled_matmul(s, x, w, out_dtype=torch.float32, perturb_out=False)
            want = tm.tiled_matmul_reference(s, x, w, out_dtype=torch.float32,
                                             perturb_out=False)
            scale = x.float().abs() @ w.float().abs()
            return bool(((got - want).abs() <= 1e-4 * scale).all())

        def time_it(x=x, w=w):
            return device_time(lambda s: tm.tiled_matmul(
                s, x, w, out_dtype=torch.float32, perturb_out=False), s, iters=iters) * 1e6

        lib_us = device_time(lambda s: torch.mm(x, w, out_dtype=torch.float32), s,
                             iters=iters) * 1e6
        yield [m, k, n], check, time_it, {"unit": "us", "library": lib_us}


def _conv_cases(iters: int):
    for b, dhw, c, o in CONV_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(b, *dhw, c, device="cuda", generator=g).to(torch.bfloat16)
        w = torch.randn(3, 3, 3, c, o, device="cuda", generator=g) * (27 * c) ** -0.5
        x_cw = x.transpose(-1, -2).contiguous()
        del x

        def check(x_cw=x_cw, w=w):
            got = conv_cuda.conv3x3x3_cw(x_cw, w, block_h=1).float()
            want = conv_cuda.conv3x3x3_cw_reference(x_cw, w).float()
            return bool(((got - want).abs() <= 2e-2 + 1.6e-2 * want.abs()).all())

        def time_it(x_cw=x_cw, w=w):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            conv_cuda.conv3x3x3_cw(x_cw, w, block_h=1)
            start.record()
            for _ in range(iters):
                conv_cuda.conv3x3x3_cw(x_cw, w, block_h=1)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters

        yield [b, *dhw, c, o], check, time_it, {"unit": "ms"}


def _conv_dhwc_cases(iters: int):
    for b, dhw, c, o in CONV_DHWC_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(b, *dhw, c, device="cuda", generator=g).to(torch.bfloat16)
        w = torch.randn(3, 3, 3, c, o, device="cuda", generator=g) * (27 * c) ** -0.5
        pro = (torch.randn(b, c, device="cuda", generator=g) * 0.5,
               torch.rand(b, c, device="cuda", generator=g) + 0.5)
        for form, args in (("conv", (None, False, False)), ("fused", (pro, True, True))):

            def call(x=x, w=w, args=args):
                return conv_cuda.launch(x, w, conv_cuda.DHWC, *args)

            def check(x=x, w=w, args=args, call=call):
                got = call()[0].float()
                want = fused_conv_cuda.conv3x3x3_fused_reference(
                    x, w, prologue=args[0], act=args[1]).float()
                return bool(((got - want).abs() <= 2e-2 + 1.6e-2 * want.abs()).all())

            def time_it(call=call):
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                call()
                torch.cuda._sleep(1_000_000 * iters)  # as for attention: device time
                start.record()
                for _ in range(iters):
                    call()
                end.record()
                torch.cuda.synchronize()
                return start.elapsed_time(end) / iters

            yield [b, *dhw, c, o], check, time_it, {"unit": "ms", "form": form}


def _attn_cases(iters: int):
    for shape in ATTN_SHAPES:
        bw, h, n, d = shape
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(3))
        b = torch.randn(h, n, n, device="cuda", generator=g) * 0.5

        def check(q=q, k=k, v=v, b=b, d=d):
            got = window_attention(q, k, v, b, d**-0.5).float()
            want = window_attention_reference(q, k, v, b, d**-0.5).float()
            return bool(((got - want).abs() <= 2e-2 + 1.6e-2 * want.abs()).all())

        def time_it(q=q, k=k, v=v, b=b, d=d):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            window_attention(q, k, v, b, d**-0.5)
            # queued behind a device sleep: the small calls are shorter than
            # their host launch work, which would otherwise be timed
            torch.cuda._sleep(1_000_000 * iters)
            start.record()
            for _ in range(iters):
                window_attention(q, k, v, b, d**-0.5)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters

        yield list(shape), check, time_it, {"unit": "ms"}


def _dw_cases(iters: int):
    for shape in DW_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
        w = torch.randn(3, 3, 3, shape[-1], device="cuda", generator=g)
        b = torch.randn(shape[-1], device="cuda", generator=g)

        def check(x=x, w=w, b=b):
            got = dwconv_cuda.dwconv3(x, w, b).float()
            want = dwconv_cuda.dwconv3_reference(x.float(), w, b).to(torch.bfloat16).float()
            return bool(((got - want).abs() <= 2e-2 + 1.6e-2 * want.abs()).all())

        def time_it(x=x, w=w, b=b):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            dwconv_cuda.dwconv3(x, w, b)
            torch.cuda._sleep(1_000_000 * iters)  # as for attention: device time
            start.record()
            for _ in range(iters):
                dwconv_cuda.dwconv3(x, w, b)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters

        yield list(shape), check, time_it, {"unit": "ms"}


def _ffn_cases(iters: int):
    """`ln_gelu_dense` (the bf16 tail's second launch) on the stencil's
    output at the four tails of a batch-8 forward."""
    for b, dhw, ch, c in FFN_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        y = (torch.randn(b, *dhw, ch, device="cuda", generator=g) + 0.3).to(torch.bfloat16)
        args = (1 + 0.1 * torch.randn(ch, device="cuda", generator=g),
                0.1 * torch.randn(ch, device="cuda", generator=g),
                torch.randn(ch, c, device="cuda", generator=g) * ch**-0.5,
                0.1 * torch.randn(c, device="cuda", generator=g))

        def check(y=y, args=args):
            got = ffn_tail_cuda.ln_gelu_dense(y, *args).float()
            want = ffn_tail_cuda.ln_gelu_dense_reference(y, *args).float()
            return bool(((got - want).abs() <= 2e-2 + 1.6e-2 * want.abs()).all())

        def time_it(y=y, args=args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ffn_tail_cuda.ln_gelu_dense(y, *args)
            torch.cuda._sleep(1_000_000 * iters)  # as for attention: device time
            start.record()
            for _ in range(iters):
                ffn_tail_cuda.ln_gelu_dense(y, *args)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters

        yield [b, *dhw, ch, c], check, time_it, {"unit": "ms"}


def run(kernel: str, iters: int) -> List[dict]:
    names = list(VARIANTS[kernel])
    libs = {n: build(kernel, n, VARIANTS[kernel][n]) for n in names}
    source = SOURCES.get(kernel, kernel)
    committed = _build.LIBRARIES.get(source)
    card = torch.cuda.get_device_name(0)
    rows = []
    cases = {"tiled_matmul": lambda: _mm_cases(iters),
             "conv3": lambda: _conv_cases(max(iters // 8, 3)),
             "conv3_dhwc": lambda: _conv_dhwc_cases(max(iters // 4, 3)),
             "window_attention": lambda: _attn_cases(iters),
             "dwconv3": lambda: _dw_cases(iters),
             "ffn_tail": lambda: _ffn_cases(iters)}[kernel]()
    try:
        for shape, check, time_it, extra in cases:
            for n in names:
                _build.LIBRARIES._libs[source] = libs[n]
                if not check():
                    raise RuntimeError(f"variant {n!r} disagrees with the plain version at {shape}")
            for pass_, order in enumerate((names, names[::-1])):
                for n in order:
                    _build.LIBRARIES._libs[source] = libs[n]
                    row = {"kernel": kernel, "variant": n, "shape": shape, "pass": pass_,
                           "time": time_it(), **extra, "device": card}
                    print(json.dumps(row), flush=True)
                    rows.append(row)
            torch.cuda.empty_cache()
    finally:
        _build.LIBRARIES._libs[source] = committed
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(VARIANTS), default="tiled_matmul")
    ap.add_argument("--iters", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("design_variants: needs a CUDA device")
    run(args.kernel, args.iters)


if __name__ == "__main__":
    main()
