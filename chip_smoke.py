#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel of `waveformer_tpu_torch/csrc` with nvcc;
  3. each kernel against its plain PyTorch version at the main path's
     shapes, in fp32 (TF32 off) and bf16, with its time beside the plain
     version's, a PyTorch library call's and the card's bound (the stencil
     also with a bias, on the design its rule names, beside the time of the
     separate bias add its epilogue replaces);
  4. the flagship model on the card (kernels, fp32) against the same
     weights on the CPU (plain versions), batch 1 at 128³; then two more of
     the repository's configurations the same way, in the models' default
     channels-last layout: the abdomen CT network at 96³ (6³ = 216-token
     windows) and the 32³ example network (2³ = 8-token windows, head dims 4
     and 8), each with exact window-attention launch counts per design and
     every stencil launch on its fp32 `vector` design;
  5. the main path, as `bench.py` drives the JAX package: flagship bf16
     WaveFormer → 8-way patch-TTA sliding window (roi 128³, sw_batch 8,
     overlap 0.5) → `Predictor.predict_case` / `predict_cases` on synthetic
     (4, 150, 180, 145) cases; kernel launches are counted over the run
     (window attention and the stencil also per design: all on TMA + wgmma
     and all on the TMA plane ring);
  6. the dense 3³ conv kernel (`csrc/conv3.cu`) in its three forms (DHWC,
     DHCW, fused with the InstanceNorm prologue and statistics; bf16 DHCW on
     the (D, H, C, W) TMA + wgmma design, bf16 DHWC with C % 8 == 0 on the
     channels-last TMA + wgmma design, C = 4 on the mma.sync halo kernel)
     against its plain version at the 16 convs of the 8 res blocks of a
     batch-8 forward and the JAX tests' shapes, fp32 and bf16, with
     `F.conv3d` (cuDNN) as the library time;
  7. the CCF-FFN tail (`csrc/ffn_tail.cu`) against its plain version at the
     8 tails of a batch-8 forward and one odd shape: bf16 on `split_wgmma`
     (the stencil's TMA ring with its bias, then `ln_gelu_dense`: LayerNorm,
     GELU and the Dense on TMA + wgmma), fp32 on the one-launch kernel; and
     `ln_gelu_dense` alone against its plain version, timed with its own
     bound;
  8. the conv-block path: one batch-8 128³ bf16 flagship forward with its 8
     `UnetResBlock`s and 8 `CCF_FFN`s captured by hooks, then every block
     again through the fused conv (`res_block_fused_module`), through the
     plain conv kernel in both layouts (`res_block_reference`), and every
     FFN through the fused tail (`ffn_tail_module`), each against the
     module's own output; launches are counted over that run, the conv
     kernel's also per design (the 16 (D, H, C, W) convs on the (D, H, C,
     W) TMA design, the 30 channels-last ones with C % 8 == 0 on the
     channels-last TMA design, the 2 with C = 4 on the halo kernel), the 8
     tails all `split_wgmma` (8 stencil launches on the TMA ring, 8 of
     `ln_gelu_dense`), and each block's time on each path is printed;
  9. the int8 probe's path: the bf16 → fp32 (`tma_wgmma`) and int8 → int32
     (`tma_wgmma_s8`: the `w_kmajor` transpose, then TMA + wgmma with TMA
     stores) tiled-matmul kernels (`csrc/tiled_matmul.cu`) against their
     plain version at the probe's shapes and odd ones, in all four (type,
     perturbation) variants
     and three values of s[0] (int8 bit-equal), `w_kmajor` against its plain
     version, then the probe's entry point
     `waveformer_tpu_torch.tools.exp_int8_mxu.run` with exact launch counts
     (per product and one transpose per int8 product; each type's design as
     the built library reports it) and the kernels' times beside cuBLAS's.
The last lines are a `{"kernels": [...]}` JSON line (each kernel at the
main-path call with the largest bound, with its worst ratio to its library
call over the main-path shapes), the card line, and
`{"ok": true, "device": {...}}`. Without CUDA, or without the repository
beside it, the script exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
CASE_SHAPE = (4, 150, 180, 145)
STREAM_CASES = 3
# published H100 SXM peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12
# exp2 on the special-function units: 132 SMs × 16 a clock at ≈1.83 GHz (the
# figure the FlashAttention-3 paper gives for the H100 SXM5)
EXP2_PER_S = 3.9e12
# device clocks of sleep queued ahead of each timed call (≈0.6 ms at the
# H100's clock): more than the host needs to launch any call timed here
SLEEP_CYCLES_PER_CALL = 1_000_000

ATTN_MAIN_SHAPES = [  # (B·nW, H, N, D) of the 14 calls of a batch-8 forward
    (512, 3, 512, 16), (64, 3, 512, 16), (8, 3, 512, 16),
    (64, 6, 512, 16), (8, 6, 512, 16), (8, 12, 512, 16), (8, 24, 512, 16),
]
# the JAX tests' shapes, then ragged windows: the abdomen config's 6³, the 32³
# networks' 2³ (head dim 4), a 3³
ATTN_TEST_SHAPES = [(4, 3, 512, 16), (2, 24, 512, 16), (3, 2, 128, 8),
                    (4, 3, 216, 16), (16, 2, 8, 4), (2, 3, 27, 16)]
# two more of the repository's configurations, driven card against CPU:
# examples/abdomen_ct/config.yaml:31-44 and examples/brats2023/run_example.py:107-119
EXTRA_CONFIGS = {
    "abdomen_ct_96": dict(img_size=(96, 96, 96), patch_size=2, in_chans=1, out_chans=14,
                          embed_dims=(48, 96, 192, 384), depths=(2, 2, 2, 2),
                          num_heads=(3, 6, 12, 24), decom_levels=(3, 2, 1, 0),
                          multi_scale_attention=True, drop_path_rate=0.1),
    "example_32": dict(img_size=(32, 32, 32), patch_size=2, in_chans=4, out_chans=4,
                       embed_dims=(8, 16, 32, 64), depths=(1, 1, 1, 1),
                       num_heads=(2, 4, 8, 8), decom_levels=(3, 2, 1, 0),
                       multi_scale_attention=True, drop_path_rate=0.0),
}
DW_MAIN_SHAPES = [  # (B, D, H, W, C) of the 10 depthwise convs of a forward
    (8, 64, 64, 64, 192), (8, 32, 32, 32, 384), (8, 16, 16, 16, 768),
    (8, 8, 8, 8, 1536), (8, 64, 64, 64, 96),
]
# (B, (D, H, W), C, O) of the 16 dense 3³ convs of the 8 res blocks of a
# batch-8 forward (encoder1-4, decoder4-2 and decoder1's conv blocks)
CONV_MAIN_SHAPES = [
    (8, (128,) * 3, 4, 48), (8, (128,) * 3, 48, 48), (8, (128,) * 3, 96, 48),
    (8, (64,) * 3, 48, 48), (8, (64,) * 3, 96, 48), (8, (32,) * 3, 96, 96),
    (8, (32,) * 3, 192, 96), (8, (16,) * 3, 192, 192), (8, (16,) * 3, 384, 192),
]
CONV_TEST_SHAPES = [(1, (8, 8, 16), 4, 8), (1, (4, 16, 8), 6, 5), (2, (4, 8, 8), 3, 4)]
# (B, (D, H, W), Ch, C) of the 8 CCF-FFN tails of a batch-8 forward, and an odd one
FFN_MAIN_SHAPES = [
    (8, (64,) * 3, 192, 48), (8, (32,) * 3, 384, 96), (8, (16,) * 3, 768, 192),
    (8, (8,) * 3, 1536, 384),
]
FFN_ODD_SHAPE = (2, (5, 6, 7), 64, 16)
# fp32 operations per hidden element of the tail outside the Dense:
# 27 multiply-adds of the stencil (54), the bias (1), LayerNorm (sum, centre,
# square-add, scale, shift: 8) and GELU (about 12 with its erf)
FFN_FP32_OPS_PER_ELEMENT = 75
# the same for `ln_gelu_dense` alone: LayerNorm (8) and GELU (12)
LGD_FP32_OPS_PER_ELEMENT = 20
# kernel vs plain version: fp32 sums in another order (TF32 off); in bf16
# both sides round an fp32 result to bf16 (2^-7 relative) and attention
# rounds its probabilities to bf16 before PV at other points
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1.6e-2, 2e-2)}
# a block's output against the module's, bf16: the module and the kernel path
# each round a conv output to bf16 before an InstanceNorm, and one rounding
# flip there moves the normalised output by ulp(y)/σ (up to 0.031 at |y|/σ
# up to 8) wherever the output lies, zero included; the atol covers one such
# flip, and the relative RMS error of the whole output stays below 1e-2
BLOCK_TOL = (1.6e-2, 4e-2)
BLOCK_REL_RMS = 1e-2
# (M, K, N) of the tiled-matmul checks: the int8 probe's shapes, then odd
# ones (a ragged row block, N % 16 == 8, a K tail of half a stage)
TM_SHAPES = [(32768, 1024, 512), (16384, 2048, 512), (96, 48, 40), (64, 2080, 24)]
TM_S_VALUES = (0.0, 3.7, -2.5)
# bf16 → fp32 kernel vs plain: equal products summed in another order, and the
# tensor cores' fp32 sums are not rounded to nearest (≤ about 2^-22 of Σ|x||w|
# per 16-deep K-step, 130 steps at K = 2080): 1e-4 of Σ|x'||w| + |s0|
TM_RTOL = 1e-4
TM_ITERS = 64


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Device ms per call of `fn`: CUDA events around `iters` calls that are
    queued behind a device-side sleep, so that a call shorter than its host
    launch work is timed on the device, not at the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters=20):
    """Host µs to launch one call of `fn` (no device wait inside)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def within(got, want, dtype_name):
    rtol, atol = TOL[dtype_name]
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    return ok, float(err.max())


def check_attention(ac):
    dev = torch.device("cuda")
    rows, ok = [], True
    for shape in ATTN_MAIN_SHAPES + ATTN_TEST_SHAPES:
        bw, h, n, d = shape
        g = torch.Generator(device=dev).manual_seed(SEED)
        q, k, v = (torch.randn(shape, device=dev, generator=g) for _ in range(3))
        bias = torch.randn(h, n, n, device=dev, generator=g) * 0.5
        scale = d**-0.5
        row = {"kernel": "window_attention", "shape": list(shape)}
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            qq, kk, vv = (t.to(dt) for t in (q, k, v))
            got = ac.window_attention(qq, kk, vv, bias, scale)
            want = ac.window_attention_reference(qq, kk, vv, bias, scale)
            torch.cuda.synchronize()
            good, err = within(got, want, name)
            ok &= good
            row[f"max_err_{name}"] = err
        qq, kk, vv = (t.to(torch.bfloat16) for t in (q, k, v))
        row["design_bf16"] = ac.design(torch.bfloat16, n, d)
        if shape in ATTN_MAIN_SHAPES:
            mask = bias.to(torch.bfloat16)[None]
            row["kernel_ms"] = cuda_ms(lambda: ac.window_attention(qq, kk, vv, bias, scale))
            row["kernel_host_us"] = host_us(lambda: ac.window_attention(qq, kk, vv, bias, scale))
            row["plain_ms"] = cuda_ms(
                lambda: ac.window_attention_reference(qq, kk, vv, bias, scale), iters=5)
            row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask, scale=scale))
            # the least time: bytes (q/k/v/out bf16, bias fp32), the two products
            # at the tensor rate, or one exp2 per score on the special-function units
            times = {
                "bytes": (4 * bw * h * n * d * 2 + h * n * n * 4) / HBM_BYTES_PER_S * 1e3,
                "operations": 4 * bw * h * n * n * d / BF16_TENSOR_FLOPS * 1e3,
                "exponentials": bw * h * n * n / EXP2_PER_S * 1e3,
            }
            row["bound_by"] = max(times, key=times.get)
            row["bound_ms"] = times[row["bound_by"]]
            row["bound_parts_ms"] = times
        else:  # the ragged windows' time, beside nothing
            row["ragged_ms_bf16"] = cuda_ms(lambda: ac.window_attention(qq, kk, vv, bias, scale))
        log(json.dumps(row))
        rows.append(row)
    return ok, rows


def check_dwconv(dc):
    """Phase 3, stencil: each shape in fp32 (`vector`) and bf16 (`tma_ring`
    at C % 8 == 0), with and without a bias, against the plain version in
    fp32 rounded once, with a launch on the design `dc.design` names; at the
    main path's shapes the bf16 kernel with its bias, beside the separate
    bias add it replaces (`out + b`, bf16)."""
    dev = torch.device("cuda")
    rows, ok = [], True
    for shape in DW_MAIN_SHAPES + [(2, 6, 5, 7, 96)]:
        g = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn(shape, device=dev, generator=g)
        c = shape[-1]
        w = torch.randn(3, 3, 3, c, device=dev, generator=g)
        b = torch.randn(c, device=dev, generator=g)
        row = {"kernel": "dwconv3", "shape": list(shape),
               "design": dc.design(torch.bfloat16, c)}
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            xx = x.to(dt)
            for bias, key in ((None, name), (b, f"{name}_bias")):
                design = dc.design(dt, c)
                before = dc.design_launches[design]
                got = dc.dwconv3(xx, w, bias)
                want = dc.dwconv3_reference(xx.float(), w, bias).to(dt)
                torch.cuda.synchronize()
                good, err = within(got, want, name)
                ok &= good and dc.design_launches[design] == before + 1
                row[f"max_err_{key}"] = err
        if shape in DW_MAIN_SHAPES:
            xx = x.to(torch.bfloat16)
            bb = b.to(torch.bfloat16)
            wt = w.permute(3, 0, 1, 2).unsqueeze(1).to(torch.bfloat16).contiguous()
            xcf = xx.permute(0, 4, 1, 2, 3)
            y = dc.dwconv3(xx, w)
            row["kernel_ms"] = cuda_ms(lambda: dc.dwconv3(xx, w, b))
            row["bias_add_ms"] = cuda_ms(lambda: y + bb)
            row["plain_ms"] = cuda_ms(lambda: dc.dwconv3_reference(xx, w, bb))
            row["library_ms"] = cuda_ms(
                lambda: F.conv3d(xcf, wt, padding=1, groups=c))
            elems = int(np.prod(shape))
            nbytes = 2 * elems * 2 + 28 * c * 4
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * 27 * elems / FP32_FLOPS * 1e3
            row["bound_ms"] = max(t_bytes, t_ops)
            row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(json.dumps(row))
        rows.append(row)
    return ok, rows


def check_flagship_vs_cpu(create_waveformer, Config, ac, dc):
    kw = dict(Config().network.model_kwargs(), io_layout="channels_first")
    cpu = create_waveformer(kw, device="cpu", seed=SEED)
    gpu = create_waveformer(kw, device="cuda")
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    x = torch.from_numpy(
        np.random.default_rng(SEED).standard_normal((1, 4, 128, 128, 128)).astype(np.float32))
    a0, d0 = ac.launches, dc.launches
    dw0 = dict(dc.design_launches)
    with torch.inference_mode():
        t0 = time.time()
        want = cpu(x)
        t_cpu = time.time() - t0
        got = gpu(x.cuda()).cpu()
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    ok = bool(torch.isfinite(got).all()) and diff <= 2e-3 * max(1.0, scale)
    row = {"check": "flagship_card_vs_cpu_fp32", "max_abs_logit_diff": diff,
           "max_abs_logit": scale, "cpu_s": t_cpu,
           "window_attention_launches": ac.launches - a0,
           "dwconv3_launches": dc.launches - d0,
           "dwconv3_launches_by_design": {k: dc.design_launches[k] - dw0[k] for k in dw0}}
    ok &= row["window_attention_launches"] == 14 and row["dwconv3_launches"] == 10
    ok &= row["dwconv3_launches_by_design"] == {"vector": 10, "tma_ring": 0}  # fp32
    log(json.dumps(row))
    return ok


def count_attention_calls(model, x):
    """Window-attention calls of one forward of `model` on `x`, counted by
    hooks on its `WindowAttention` modules (each module call is one call of
    the kernel wrapper)."""
    from waveformer_tpu_torch.models.attention import WindowAttention

    calls = []
    handles = [m.register_forward_hook(lambda *a: calls.append(1))
               for m in model.modules() if isinstance(m, WindowAttention)]
    with torch.inference_mode():
        out = model(x)
    for h in handles:
        h.remove()
    return out, len(calls)


def check_configs_vs_cpu(create_waveformer, ac, dc):
    """Phase 4, second half: the abdomen and 32³ configurations, batch 1,
    fp32, default (channels-last) layout, card against CPU within the
    flagship's rule, with exact attention launch counts per design and every
    stencil launch on the fp32 `vector` design."""
    ok, rows = True, []
    for name, cfg in EXTRA_CONFIGS.items():
        cpu = create_waveformer(cfg, device="cpu", seed=SEED)
        gpu = create_waveformer(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict(), strict=True)
        shape = (1, *cfg["img_size"], cfg["in_chans"])
        x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(shape).astype(np.float32))
        want, calls = count_attention_calls(cpu, x)
        before = dict(ac.design_launches)
        dw_before, d0 = dict(dc.design_launches), dc.launches
        with torch.inference_mode():
            got = gpu(x.cuda()).cpu()
        designs = {k: ac.design_launches[k] - before[k] for k in before}
        dw_designs = {k: dc.design_launches[k] - dw_before[k] for k in dw_before}
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        good = (bool(torch.isfinite(got).all()) and got.shape == want.shape
                and diff <= 2e-3 * max(1.0, scale)
                and designs == {"fma": calls, "tma_wgmma": 0} and calls > 0
                and dw_designs == {"vector": dc.launches - d0, "tma_ring": 0}
                and dc.launches > d0)
        ok &= good
        row = {"check": f"{name}_card_vs_cpu_fp32", "logits_shape": list(got.shape),
               "max_abs_logit_diff": diff, "max_abs_logit": scale,
               "attention_calls": calls, "attention_launches_by_design": designs,
               "dwconv3_launches_by_design": dw_designs, "ok": good}
        log(json.dumps(row))
        rows.append(row)
        del cpu, gpu
        torch.cuda.empty_cache()
    return ok, rows


def run_main_path(create_waveformer, Config, SlidingWindowInferer, Predictor, ac, dc):
    # the bench protocol: (C, D, H, W) cases, channels-first model and inferer
    model = create_waveformer(Config().network.model_kwargs(), dtype=torch.bfloat16, seed=SEED,
                              io_layout="channels_first")
    inferer = SlidingWindowInferer(
        roi_size=(128, 128, 128), sw_batch_size=8, overlap=0.5,
        mirror_axes=(0, 1, 2), tta_mode="patch", layout="channels_first",
    )
    predictor = Predictor(inferer, upload_dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED)
    cases = [rng.standard_normal(CASE_SHAPE).astype(np.float32)
             for _ in range(STREAM_CASES + 1)]
    ok = True

    def check_seg(seg):
        return seg.shape == CASE_SHAPE[1:] and seg.dtype == np.uint8 and int(seg.max()) < 4

    ok &= check_seg(predictor.predict_case(cases[0], model, out_channels=4))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ac.launches = dc.launches = 0
    for counts in (ac.design_launches, dc.design_launches):
        for k in counts:
            counts[k] = 0
    t0 = time.time()
    seg = predictor.predict_case(cases[1], model, out_channels=4)
    s_case = time.time() - t0
    case_counts = (ac.launches, dc.launches)
    case_designs = dict(ac.design_launches)
    dw_designs = dict(dc.design_launches)
    ok &= check_seg(seg) and case_counts == (112, 80)
    ok &= case_designs == {"fma": 0, "tma_wgmma": 112}
    ok &= dw_designs == {"vector": 0, "tma_ring": 80}

    ac.launches = dc.launches = 0
    t0 = time.time()
    segs = list(predictor.predict_cases(cases[1:], model, out_channels=4))
    s_stream = time.time() - t0
    stream_counts = (ac.launches, dc.launches)
    ok &= all(check_seg(s) for s in segs)
    ok &= stream_counts == (112 * STREAM_CASES, 80 * STREAM_CASES)
    ok &= np.array_equal(segs[0], seg)  # same case, same labels
    row = {"check": "main_path_predict", "case_shape": list(CASE_SHAPE),
           "seconds_per_case": s_case, "stream_cases": STREAM_CASES,
           "stream_cases_per_s": STREAM_CASES / s_stream,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "per_case_launches": {"window_attention": case_counts[0],
                                 "dwconv3": case_counts[1]},
           "per_case_attention_designs": case_designs,
           "per_case_dwconv3_designs": dw_designs,
           "stream_launches": {"window_attention": stream_counts[0],
                               "dwconv3": stream_counts[1]},
           "label_counts": np.bincount(seg.ravel(), minlength=4).tolist()}
    log(json.dumps(row))
    return ok, {"window_attention": stream_counts[0], "dwconv3": stream_counts[1]}


def bound(nbytes, t_ops_s):
    """(bound_ms, bound_by): the larger of the bytes at the HBM rate and the
    operations' time at their peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = t_ops_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_conv(cc, fc):
    """Phase 6: conv3.cu as conv3x3x3_same (DHWC), conv3x3x3_cw (DHCW) and
    conv3x3x3_fused (prologue + statistics) against the plain versions."""
    dev = torch.device("cuda")
    rows = {"conv3x3x3_same": [], "conv3x3x3_cw": [], "conv3x3x3_fused": []}
    ok = True
    for b, dhw, c, o in CONV_MAIN_SHAPES + CONV_TEST_SHAPES:
        main_shape = (b, dhw, c, o) in CONV_MAIN_SHAPES
        g = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn(b, *dhw, c, device=dev, generator=g)
        w = torch.randn(3, 3, 3, c, o, device=dev, generator=g) * (27 * c) ** -0.5
        pro = (torch.randn(b, c, device=dev, generator=g) * 0.5,
               torch.rand(b, c, device=dev, generator=g) + 0.5)
        n = int(np.prod(dhw))
        shape = [b, *dhw, c, o]
        rs = {k: {"kernel": k, "shape": shape} for k in rows}
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            xx = x.to(dt)
            want = cc.conv3x3x3_reference(xx, w)
            for k, fn in (("conv3x3x3_same", cc.conv3x3x3_batched),
                          ("conv3x3x3_cw", cc.conv3x3x3_same_v2)):
                good, err = within(fn(xx, w, block_h=1), want, name)
                ok &= good
                rs[k][f"max_err_{name}"] = err
            del want
            y, st = fc.conv3x3x3_fused(xx, w, prologue=pro, emit_stats=True)
            wy, wst = fc.conv3x3x3_fused_reference(xx, w, prologue=pro, emit_stats=True)
            good, err = within(y, wy, name)
            # [Σ, Σ²] of the fp32 accumulator: equal inputs, another order;
            # Σ against its natural scale √(n·Σ²), Σ² against itself
            scale = torch.stack([torch.sqrt(n * wst[:, 1]), wst[:, 1]], dim=1)
            st_err = float(((st - wst).abs() / scale).max())
            # per-instance mean and rstd against plain InstanceNorm statistics
            km, kr = fc.moments_from_stats(st, n)
            var, mu = torch.var_mean(wy.float(), dim=(1, 2, 3), unbiased=False)
            mom_err = max(float(((km - mu).abs() / (var.sqrt() + 1e-3)).max()),
                          float((kr * torch.sqrt(var + 1e-5) - 1).abs().max()))
            y2, st2 = fc.conv3x3x3_fused(xx, w, prologue=pro, emit_stats=True)
            same = torch.equal(st, st2) and torch.equal(y, y2)
            ok &= good and st_err <= 1e-4 and mom_err <= 1e-3 and same
            rs["conv3x3x3_fused"].update({f"max_err_{name}": err, f"stats_rel_err_{name}": st_err,
                                          f"moments_err_{name}": mom_err,
                                          f"stats_bit_identical_{name}": same})
            del xx, y, wy, y2
        if main_shape:
            xx = x.to(torch.bfloat16)
            x_cw = xx.transpose(-1, -2).contiguous()
            xcf = xx.permute(0, 4, 1, 2, 3)
            wt = w.permute(4, 3, 0, 1, 2).to(torch.bfloat16).contiguous()
            lib_ms = cuda_ms(lambda: F.conv3d(xcf, wt, padding=1), iters=5, warmup=1)
            nbytes = 2 * b * n * (c + o) + 2 * 27 * c * o
            bms, by = bound(nbytes, 2 * b * n * 27 * c * o / BF16_TENSOR_FLOPS)
            timed = {
                "conv3x3x3_same": (lambda: cc.conv3x3x3_batched(xx, w, block_h=1),
                                   lambda: cc.conv3x3x3_reference(xx, w)),
                "conv3x3x3_cw": (lambda: cc.conv3x3x3_cw(x_cw, w, block_h=1),
                                 lambda: cc.conv3x3x3_cw_reference(x_cw, w)),
                "conv3x3x3_fused": (
                    lambda: fc.conv3x3x3_fused(xx, w, prologue=pro, emit_stats=True),
                    lambda: fc.conv3x3x3_fused_reference(xx, w, prologue=pro, emit_stats=True)),
            }
            for k, (kern, plain) in timed.items():
                rs[k].update({"kernel_ms": cuda_ms(kern, iters=5, warmup=1),
                              "plain_ms": cuda_ms(plain, iters=3, warmup=1),
                              "library_ms": lib_ms, "bound_ms": bms, "bound_by": by})
            rs["conv3x3x3_same"]["design"] = rs["conv3x3x3_fused"]["design"] = cc.design(
                torch.bfloat16, cc.DHWC, dhw[2], c)
            rs["conv3x3x3_cw"]["design"] = cc.design(torch.bfloat16, cc.DHCW, dhw[2], c)
            del xx, x_cw, xcf
        for k, r in rs.items():
            log(json.dumps(r))
            rows[k].append(r)
        del x
        torch.cuda.empty_cache()
    return ok, rows


def check_ffn_tail(ft):
    """Phase 7: ffn_tail.cu against `ffn_tail_reference` (bf16 on
    `split_wgmma`: the stencil ring, then `ln_gelu_dense`; fp32 on the
    one-launch kernel), and `ln_gelu_dense` alone against its plain version
    on the stencil's bf16 output. At the main shapes, the times of the whole
    tail and of `ln_gelu_dense`, each beside its plain version and its bound
    (the tail's is that of one pass over h1; `split_floor_ms` adds the
    stencil's bytes to `ln_gelu_dense`'s bound)."""
    dev = torch.device("cuda")
    rows, lgd_rows, ok = [], [], True
    for b, dhw, ch, c in FFN_MAIN_SHAPES + [FFN_ODD_SHAPE]:
        g = torch.Generator(device=dev).manual_seed(SEED)
        h1 = torch.randn(b, *dhw, ch, device=dev, generator=g)
        r = lambda *s, scale=1.0: torch.randn(*s, device=dev, generator=g) * scale
        params = (r(3, 3, 3, ch, scale=0.2), r(ch, scale=0.1), 1 + r(ch, scale=0.1),
                  r(ch, scale=0.1), r(ch, c, scale=ch**-0.5), r(c, scale=0.1))
        shape = [b, *dhw, ch, c]
        row = {"kernel": "ffn_tail", "shape": shape, "design": ft.design(torch.bfloat16, ch, c)}
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            hh = h1.to(dt)
            design = ft.design(dt, ch, c)
            before = ft.design_launches[design]
            good, err = within(ft.ffn_tail(hh, *params), ft.ffn_tail_reference(hh, *params), name)
            ok &= good and ft.design_launches[design] == before + 1
            row[f"max_err_{name}"] = err
        hh = h1.to(torch.bfloat16)
        y = ft.dwconv3(hh, params[0], params[1])
        lgd = {"kernel": "ln_gelu_dense", "shape": shape}
        good, lgd["max_err_bfloat16"] = within(ft.ln_gelu_dense(y, *params[2:]),
                                               ft.ln_gelu_dense_reference(y, *params[2:]),
                                               "bfloat16")
        ok &= good
        if (b, dhw, ch, c) in FFN_MAIN_SHAPES:
            vox = b * int(np.prod(dhw))
            nbytes = 2 * vox * (ch + c) + 4 * 30 * ch + 2 * ch * c + 4 * c
            t_ops = max(FFN_FP32_OPS_PER_ELEMENT * vox * ch / FP32_FLOPS,
                        2 * vox * ch * c / BF16_TENSOR_FLOPS)
            bms, by = bound(nbytes, t_ops)
            row.update({"kernel_ms": cuda_ms(lambda: ft.ffn_tail(hh, *params), iters=10),
                        "plain_ms": cuda_ms(lambda: ft.ffn_tail_reference(hh, *params), iters=5),
                        "library_ms": None, "bound_ms": bms, "bound_by": by})
            lgd_bytes = 2 * vox * (ch + c) + 4 * 2 * ch + 2 * ch * c + 4 * c
            lgd_ops = max(LGD_FP32_OPS_PER_ELEMENT * vox * ch / FP32_FLOPS,
                          2 * vox * ch * c / BF16_TENSOR_FLOPS)
            lbms, lby = bound(lgd_bytes, lgd_ops)
            lgd.update({"kernel_ms": cuda_ms(lambda: ft.ln_gelu_dense(y, *params[2:]), iters=10),
                        "plain_ms": cuda_ms(lambda: ft.ln_gelu_dense_reference(y, *params[2:]),
                                            iters=5),
                        "library_ms": None, "bound_ms": lbms, "bound_by": lby})
            # the two launches' floor: the stencil's bytes (h1 in, y out) and
            # ln_gelu_dense's bound
            row["split_floor_ms"] = (2 * 2 * vox * ch + 4 * 28 * ch) / HBM_BYTES_PER_S * 1e3 + lbms
            row["ln_gelu_dense_ms"] = lgd["kernel_ms"]
        log(json.dumps(row))
        log(json.dumps(lgd))
        rows.append(row)
        lgd_rows.append(lgd)
        del h1, hh, y
        torch.cuda.empty_cache()
    return ok, rows, lgd_rows


def path_err(got, want):
    """(ok, numbers) of a block's output against the module's, bf16."""
    rtol, atol = BLOCK_TOL
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ratio = err / (atol + rtol * w.abs())
    worst = int(ratio.argmax())
    out = {"max_err": float(err.max()), "outside_tol": int((ratio > 1).sum()),
           "worst_tol_ratio": float(ratio.reshape(-1)[worst]),
           "worst_want": float(w.reshape(-1)[worst]), "worst_got": float(g.reshape(-1)[worst]),
           "rel_rms": float(err.norm() / w.norm())}
    return out["outside_tol"] == 0 and out["rel_rms"] <= BLOCK_REL_RMS, out


def run_conv_block_path(create_waveformer, Config, cc, fc, ft, dc):
    """Phase 8: the flagship's 8 UnetResBlocks and 8 CCF-FFN tails on the
    kernels, each against the module's own output in one bf16 forward."""
    from waveformer_tpu_torch.models.conv_blocks import UnetResBlock
    from waveformer_tpu_torch.models.layers import CCF_FFN

    model = create_waveformer(Config().network.model_kwargs(), dtype=torch.bfloat16, seed=SEED,
                              io_layout="channels_first")
    captured = []
    handles = [
        m.register_forward_hook(lambda mod, args, out, name=name: captured.append(
            (name, mod, args[0], out)))
        for name, m in model.named_modules() if isinstance(m, (UnetResBlock, CCF_FFN))
    ]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(8, 4, 128, 128, 128, device="cuda", generator=g).to(torch.bfloat16)
    with torch.inference_mode():
        model(x)
    for h in handles:
        h.remove()
    del x
    blocks = [t for t in captured if isinstance(t[1], UnetResBlock)]
    ffns = [t for t in captured if isinstance(t[1], CCF_FFN)]
    ok = len(blocks) == 8 and len(ffns) == 8

    def conv_dhwc(a, k):  # the unfused conv kernel, channels-last
        return cc.conv3x3x3_batched(a, k, block_h=1)

    def conv_dhcw(a, k):  # the unfused conv kernel in the (D, H, C, W) layout
        return cc.conv3x3x3_same_v2(a, k, block_h=1)

    for k in cc.launches:
        cc.launches[k] = 0
    for k in cc.design_launches:
        cc.design_launches[k] = 0
    fc.launches = ft.launches = ft.ln_gelu_dense_launches = 0
    for d in (ft.design_launches, dc.design_launches):
        for k in d:
            d[k] = 0
    rows = []
    with torch.inference_mode():
        for name, m, xin, want in blocks:
            ws = fc.res_block_weights(m)
            row = {"check": "conv_block", "block": name, "shape": list(xin.shape),
                   "out_channels": want.shape[-1]}
            for key, fn in (
                ("fused", lambda: fc.res_block_fused_module(m, xin)),
                ("conv3_dhwc", lambda: fc.res_block_reference(xin, *ws, conv=conv_dhwc)),
                ("conv3_dhcw", lambda: fc.res_block_reference(xin, *ws, conv=conv_dhcw)),
            ):
                good, err = path_err(fn(), want)
                ok &= good
                row.update({f"{k}_{key}": v for k, v in err.items()})
            rows.append(row)
        for name, m, xin, want in ffns:
            good, err = path_err(ft.ffn_tail_module(m, xin), want)
            ok &= good
            rows.append({"check": "ffn_tail", "block": name, "shape": list(xin.shape),
                         **{f"{k}_fused": v for k, v in err.items()}})
        torch.cuda.synchronize()
    counts = {"conv3x3x3_fused": fc.launches, "ffn_tail": ft.launches,
              "ln_gelu_dense": ft.ln_gelu_dense_launches,
              "conv3x3x3_same": cc.launches["conv3x3x3_same"] + cc.launches["conv3x3x3_batched"],
              "conv3x3x3_cw": cc.launches["conv3x3x3_cw"] + cc.launches["conv3x3x3_same_v2"]}
    ok &= counts == {"conv3x3x3_fused": 16, "ffn_tail": 8, "ln_gelu_dense": 8,
                     "conv3x3x3_same": 16, "conv3x3x3_cw": 16}
    # the 8 tails on the bf16 split design: each one stencil launch on the
    # TMA ring, then one ln_gelu_dense
    tail_designs = {"ffn_tail": dict(ft.design_launches), "dwconv3": dict(dc.design_launches)}
    ok &= tail_designs == {"ffn_tail": {"fp32": 0, "split_wgmma": 8},
                           "dwconv3": {"vector": 0, "tma_ring": 8}}
    # every conv3.cu launch by design: the fused and DHWC convs with C % 8 ==
    # 0 on the channels-last TMA kernel, the two with C = 4 (encoder1's
    # first conv) on the halo kernel, the 16 (D, H, C, W) convs on the (D, H,
    # C, W) TMA kernel, none on the plain one
    designs = dict(cc.design_launches)
    ok &= designs == {"halo_mma": 2, "plain": 0, "tma_wgmma": 16, "tma_wgmma_cl": 30}

    # per-block times, after the counts are read
    with torch.inference_mode():
        for row, (name, m, xin, _) in zip(rows, blocks + ffns):
            if row["check"] == "conv_block":
                ws = fc.res_block_weights(m)
                row["fused_ms"] = cuda_ms(lambda: fc.res_block_fused_module(m, xin), iters=3,
                                          warmup=1)
                row["conv3_dhwc_ms"] = cuda_ms(
                    lambda: fc.res_block_reference(xin, *ws, conv=conv_dhwc), iters=3, warmup=1)
            else:
                row["fused_ms"] = cuda_ms(lambda: ft.ffn_tail_module(m, xin), iters=3, warmup=1)
            row["module_ms"] = cuda_ms(lambda: m(xin), iters=3, warmup=1)
            log(json.dumps(row))
    log(json.dumps({"check": "conv_block_path", "launches": counts, "conv3_designs": designs,
                    "tail_designs": tail_designs,
                    "fused_ms": sum(r["fused_ms"] for r in rows),
                    "module_ms": sum(r["module_ms"] for r in rows)}))
    del captured, blocks, ffns
    torch.cuda.empty_cache()
    return ok, counts


def tiled_matmul_inputs(kind, m, k, n, s0, tm):
    g = torch.Generator(device="cuda").manual_seed(SEED)
    if kind == "bf16":
        x = torch.randn(m, k, device="cuda", generator=g).to(torch.bfloat16)
        w = torch.randn(k, n, device="cuda", generator=g).to(torch.bfloat16)
    else:
        x = torch.randint(-127, 127, (m, k), device="cuda", generator=g, dtype=torch.int8)
        w = torch.randint(-127, 127, (k, n), device="cuda", generator=g, dtype=torch.int8)
        x[0, :4] = torch.tensor([126, 125, -127, -126], dtype=torch.int8)  # x ⊕ s wraps
    s = torch.zeros(8, device="cuda")
    s[0] = s0
    return s, x, w, tm.PAIRS[x.dtype][1]


def check_tiled_matmul(tm):
    """Phase 9, first half: both tiled-matmul kernels against the plain
    version in all four (type, perturbation) variants; int8 bit-equal, bf16
    within TM_RTOL of Σ|x'||w| + |s0| (x' the perturbed input)."""
    ok, rows = True, []
    for m, k, n in TM_SHAPES:
        for kind in ("bf16", "int8"):
            row = {"kernel": f"tiled_matmul_{kind}", "shape": [m, k, n]}
            for perturb_out in (False, True):
                for s0 in TM_S_VALUES:
                    s, x, w, out_dtype = tiled_matmul_inputs(kind, m, k, n, s0, tm)
                    got = tm.tiled_matmul(s, x, w, out_dtype=out_dtype, perturb_out=perturb_out)
                    want = tm.tiled_matmul_reference(s, x, w, out_dtype=out_dtype,
                                                     perturb_out=perturb_out)
                    torch.cuda.synchronize()
                    key = f"perturb_{'out' if perturb_out else 'in'}_s{s0:g}"
                    if kind == "int8":
                        good = torch.equal(got, want)
                        err = float((got.double() - want.double()).abs().max())
                    else:
                        scale = (x.float().abs() + abs(s0)) @ w.float().abs() + abs(s0)
                        diff = (got - want).abs()
                        good = bool(torch.isfinite(got).all()) and bool(
                            (diff <= TM_RTOL * scale).all())
                        err = float(diff.max())
                    ok &= good
                    row[key] = err
                    del x, w, got, want
            log(json.dumps(row))
            rows.append(row)
        # the int8 product's K-major operand, bit for bit
        _, _, w, _ = tiled_matmul_inputs("int8", m, k, n, 0.0, tm)
        wt, want = tm.w_kmajor(w), tm.w_kmajor_reference(w)
        torch.cuda.synchronize()
        good = wt.is_contiguous() and wt.shape == want.shape and torch.equal(wt, want)
        ok &= good
        err = float((wt.int() - want.int()).abs().max()) if wt.shape == want.shape else np.nan
        row = {"kernel": "w_kmajor", "shape": [k, n], "max_err": err}
        log(json.dumps(row))
        rows.append(row)
    return ok, rows


def worst_library(timed):
    """The kernels line's worst ratio to the library call: the largest
    kernel / library time over (kernel, library, shape) of the main-path
    calls, with its shape (None where no call has a library time)."""
    pairs = [(k / lib, shape) for k, lib, shape in timed if lib]
    if not pairs:
        return {"worst_library_ratio": None, "worst_library_shape": None}
    ratio, shape = max(pairs, key=lambda t: t[0])
    return {"worst_library_ratio": ratio, "worst_library_shape": shape}


def run_int8_probe(tm, probe):
    """Phase 9, second half: the probe's entry point (`run`, 64 timed calls
    per shape and type), with exact launch counts, then the plain version's
    time at the largest shape."""
    for k in tm.launches:
        tm.launches[k] = 0
    rows = probe.run(iters=TM_ITERS)
    counts = dict(tm.launches)
    # one design per input type, as the built library reports it
    designs = {kind: tm.design(dt) for kind, dt in (("bf16", torch.bfloat16),
                                                     ("int8", torch.int8))}
    per_kind = len(probe.SHAPES) * (TM_ITERS + 1)  # device_time's warm-up and 64 calls
    # every int8 product on the new design, after one transpose of its w
    ok = counts == {"tiled_matmul_bf16": per_kind, "tiled_matmul_int8": per_kind,
                    "w_kmajor": per_kind}
    ok &= designs == {"bf16": "tma_wgmma", "int8": "tma_wgmma_s8"}
    for r in rows:
        ok &= all(np.isfinite(r[k]) and r[k] > 0 for k in ("us", "top_s", "library_us"))
        log(json.dumps(r))
    entries = []
    for kind in ("bf16", "int8"):
        worst = worst_library((r["us"], r["library_us"], [r["M"], r["K"], r["N"]])
                              for r in rows if r["dtype"] == kind)
        r = max((r for r in rows if r["dtype"] == kind), key=lambda r: r["bound_us"])
        s, x, w, out_dtype = tiled_matmul_inputs(kind, r["M"], r["K"], r["N"], 0.0, tm)
        plain_ms = cuda_ms(lambda: tm.tiled_matmul_reference(
            s, x, w, out_dtype=out_dtype, perturb_out=kind == "int8"), iters=5, warmup=1)
        entries.append({"name": f"tiled_matmul_{kind}", "design": tm.design(x.dtype),
                        "ms": r["us"] / 1e3,
                        "plain_ms": plain_ms, "bound_ms": r["bound_us"] / 1e3,
                        "bound_by": r["bound_by"], "library_ms": r["library_us"] / 1e3,
                        "library_call": r["library_call"], "shape": [r["M"], r["K"], r["N"]],
                        "int8_speedup_kernel": r["int8_speedup_kernel"],
                        "int8_speedup_library": r["int8_speedup_library"], **worst})
        del x, w
    # the transpose at the probe's largest w, timed alone, beside its plain version
    k, n = max(((r["K"], r["N"]) for r in rows), key=lambda kn: kn[0] * kn[1])
    _, _, w, _ = tiled_matmul_inputs("int8", 16, k, n, 0.0, tm)
    entries.append({"name": "w_kmajor", "design": "tiled 64 x 64 through shared memory",
                    "ms": cuda_ms(lambda: tm.w_kmajor(w), iters=64),
                    "plain_ms": cuda_ms(lambda: tm.w_kmajor_reference(w), iters=64),
                    "bound_ms": 2 * k * n / probe.HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                    "library_ms": cuda_ms(lambda: w.t().contiguous(), iters=64),
                    "library_call": "w.t().contiguous()", "shape": [k, n],
                    "part_of": "tiled_matmul_int8 (tma_wgmma_s8, before each product)"})
    log(json.dumps({"check": "int8_probe", "launches": counts, "designs": designs,
                    "expected_per_kind": per_kind}))
    torch.cuda.empty_cache()
    return ok, counts, entries


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from waveformer_tpu_torch.config import Config
        from waveformer_tpu_torch.inference import Predictor, SlidingWindowInferer
        from waveformer_tpu_torch.models import create_waveformer
        from waveformer_tpu_torch.ops import _build
        from waveformer_tpu_torch.ops import attention_cuda as ac
        from waveformer_tpu_torch.ops import conv_cuda as cc
        from waveformer_tpu_torch.ops import dwconv_cuda as dc
        from waveformer_tpu_torch.ops import ffn_tail_cuda as ft
        from waveformer_tpu_torch.ops import fused_conv_cuda as fc
        from waveformer_tpu_torch.ops import tiled_matmul_cuda as tm
        from waveformer_tpu_torch.tools import exp_int8_mxu as probe
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2

    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed = []

    t0 = time.time()
    _build.LIBRARIES.build_all()
    log(json.dumps({"phase": "build", "seconds": time.time() - t0,
                    "sources": _build.sources()}))

    phases = [
        ("attention", lambda: check_attention(ac)),
        ("dwconv3", lambda: check_dwconv(dc)),
    ]
    results = {}
    for name, fn in phases:
        ok, rows = fn()
        results[name] = rows
        if not ok:
            failed.append(name)
    if not check_flagship_vs_cpu(create_waveformer, Config, ac, dc):
        failed.append("flagship_card_vs_cpu")
    ok, _ = check_configs_vs_cpu(create_waveformer, ac, dc)
    if not ok:
        failed.append("configs_card_vs_cpu")
    ok, launches = run_main_path(
        create_waveformer, Config, SlidingWindowInferer, Predictor, ac, dc)
    if not ok:
        failed.append("main_path")
    ok, conv_rows = check_conv(cc, fc)
    results.update(conv_rows)
    if not ok:
        failed.append("conv3")
    ok, results["ffn_tail"], results["ln_gelu_dense"] = check_ffn_tail(ft)
    if not ok:
        failed.append("ffn_tail")
    ok, block_launches = run_conv_block_path(create_waveformer, Config, cc, fc, ft, dc)
    if not ok:
        failed.append("conv_block_path")
    launches.update(block_launches)
    ok, results["tiled_matmul"] = check_tiled_matmul(tm)
    if not ok:
        failed.append("tiled_matmul")
    ok, probe_launches, probe_entries = run_int8_probe(tm, probe)
    if not ok:
        failed.append("int8_probe")
    launches.update(probe_launches)
    for name, n in launches.items():
        if n == 0:
            failed.append(f"{name} never launched on its path")

    def headline(rows, kname, source, replaces, **extra):
        # the main-path call with the largest bound; a bound set by the
        # exponentials is one of operations (special-function ones)
        timed = [r for r in rows if "kernel_ms" in r]
        r = max(timed, key=lambda r: r["bound_ms"])
        by = {"bound_by": r["bound_by"]}
        if r["bound_by"] == "exponentials":
            by = {"bound_by": "operations", "bound_operations": "exp2"}
        return {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[kname],
                "max_abs_err": max(v for x in rows for k, v in x.items()
                                   if k.startswith("max_err_")),
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                **by, "library_ms": r["library_ms"], "shape": r["shape"],
                **worst_library((r["kernel_ms"], r["library_ms"], r["shape"]) for r in timed),
                **extra}

    conv_src = "waveformer_tpu_torch/csrc/conv3.cu"
    cudnn = {"library_call": "F.conv3d, bf16, the conv alone (cuDNN)"}
    log(json.dumps({"kernels": [
        headline(results["attention"], "window_attention",
                 "waveformer_tpu_torch/csrc/window_attention.cu",
                 "waveformer_tpu/ops/attention_pallas.py:34",
                 design=ac.design(torch.bfloat16, *ATTN_MAIN_SHAPES[0][2:])),
        headline(results["dwconv3"], "dwconv3",
                 "waveformer_tpu_torch/csrc/dwconv3.cu",
                 "waveformer_tpu/ops/dwconv_pallas.py:32",
                 design=dc.design(torch.bfloat16, DW_MAIN_SHAPES[0][-1])),
        headline(results["conv3x3x3_same"], "conv3x3x3_same", conv_src,
                 "waveformer_tpu/ops/conv_pallas.py:51",
                 design=cc.design(torch.bfloat16, cc.DHWC, CONV_MAIN_SHAPES[2][1][2],
                                  CONV_MAIN_SHAPES[2][2]), **cudnn),
        headline(results["conv3x3x3_cw"], "conv3x3x3_cw", conv_src,
                 "waveformer_tpu/ops/conv_pallas.py:154",
                 design=cc.design(torch.bfloat16, cc.DHCW, CONV_MAIN_SHAPES[2][1][2],
                                  CONV_MAIN_SHAPES[2][2]), **cudnn),
        headline(results["ffn_tail"], "ffn_tail", "waveformer_tpu_torch/csrc/ffn_tail.cu",
                 "tools/exp_ffn_pallas.py:149",
                 design=ft.design(torch.bfloat16, *FFN_MAIN_SHAPES[0][2:])),
        headline(results["ln_gelu_dense"], "ln_gelu_dense",
                 "waveformer_tpu_torch/csrc/ffn_tail.cu", "tools/exp_ffn_pallas.py:149",
                 part_of="ffn_tail (split_wgmma, after dwconv3)"),
        headline(results["conv3x3x3_fused"], "conv3x3x3_fused", conv_src,
                 "tools/exp_fused_conv.py:120",
                 design=cc.design(torch.bfloat16, cc.DHWC, CONV_MAIN_SHAPES[2][1][2],
                                  CONV_MAIN_SHAPES[2][2]), **cudnn),
        *({"route": "cuda", "source": "waveformer_tpu_torch/csrc/tiled_matmul.cu",
           "replaces": "tools/exp_int8_mxu.py:37", "launches": launches[e["name"]],
           "max_abs_err": max(v for r in results["tiled_matmul"] if r["kernel"] == e["name"]
                              for k, v in r.items()
                              if k.startswith("perturb_") or k == "max_err"),
           **e} for e in probe_entries),
    ]}))
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
