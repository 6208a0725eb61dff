#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel of `waveformer_tpu_torch/csrc` with nvcc;
  3. each kernel against its plain PyTorch version at the main path's
     shapes, in fp32 (TF32 off) and bf16, with its time beside the plain
     version's, a PyTorch library call's and the card's bound;
  4. the flagship model on the card (kernels, fp32) against the same
     weights on the CPU (plain versions), batch 1 at 128³;
  5. the main path, as `bench.py` drives the JAX package: flagship bf16
     WaveFormer → 8-way patch-TTA sliding window (roi 128³, sw_batch 8,
     overlap 0.5) → `Predictor.predict_case` / `predict_cases` on synthetic
     (4, 150, 180, 145) cases; kernel launches are counted over the run;
  6. the dense 3³ conv kernel (`csrc/conv3.cu`) in its three forms (DHWC,
     DHCW, fused with the InstanceNorm prologue and statistics) against its
     plain version at the 16 convs of the 8 res blocks of a batch-8 forward
     and the JAX tests' shapes, fp32 and bf16, with `F.conv3d` (cuDNN) as
     the library time;
  7. the fused CCF-FFN tail (`csrc/ffn_tail.cu`) against its plain version
     at the 8 tails of a batch-8 forward and one odd shape;
  8. the conv-block path: one batch-8 128³ bf16 flagship forward with its 8
     `UnetResBlock`s and 8 `CCF_FFN`s captured by hooks, then every block
     again through the fused conv (`res_block_fused_module`), through the
     plain conv kernel in both layouts (`res_block_reference`), and every
     FFN through the fused tail (`ffn_tail_module`), each against the
     module's own output; launches are counted over that run, and each
     block's time on each path is printed;
  9. the int8 probe's path: the bf16 → fp32 and int8 → int32 tiled-matmul
     kernels (`csrc/tiled_matmul.cu`) against their plain version at the
     probe's shapes and odd ones, in all four (type, perturbation) variants
     and three values of s[0] (int8 bit-equal), then the probe's entry point
     `waveformer_tpu_torch.tools.exp_int8_mxu.run` with exact launch counts
     and the kernels' times beside cuBLAS's.
The last lines are a `{"kernels": [...]}` JSON line, the card line, and
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

ATTN_MAIN_SHAPES = [  # (B·nW, H, N, D) of the 14 calls of a batch-8 forward
    (512, 3, 512, 16), (64, 3, 512, 16), (8, 3, 512, 16),
    (64, 6, 512, 16), (8, 6, 512, 16), (8, 12, 512, 16), (8, 24, 512, 16),
]
ATTN_TEST_SHAPES = [(4, 3, 512, 16), (2, 24, 512, 16), (3, 2, 128, 8)]
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
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
        if shape in ATTN_MAIN_SHAPES:
            qq, kk, vv = (t.to(torch.bfloat16) for t in (q, k, v))
            mask = bias.to(torch.bfloat16)[None]
            row["kernel_ms"] = cuda_ms(lambda: ac.window_attention(qq, kk, vv, bias, scale))
            row["plain_ms"] = cuda_ms(
                lambda: ac.window_attention_reference(qq, kk, vv, bias, scale), iters=5)
            row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mask, scale=scale))
            nbytes = 4 * bw * h * n * d * 2 + h * n * n * 4
            flops = 4 * bw * h * n * n * d
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_TENSOR_FLOPS * 1e3
            row["bound_ms"] = max(t_bytes, t_ops)
            row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(json.dumps(row))
        rows.append(row)
    return ok, rows


def check_dwconv(dc):
    dev = torch.device("cuda")
    rows, ok = [], True
    for shape in DW_MAIN_SHAPES + [(2, 6, 5, 7, 96)]:
        g = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn(shape, device=dev, generator=g)
        w = torch.randn(3, 3, 3, shape[-1], device=dev, generator=g)
        row = {"kernel": "dwconv3", "shape": list(shape)}
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            xx = x.to(dt)
            got = dc.dwconv3(xx, w)
            want = dc.dwconv3_reference(xx.float(), w).to(dt)
            torch.cuda.synchronize()
            good, err = within(got, want, name)
            ok &= good
            row[f"max_err_{name}"] = err
        if shape in DW_MAIN_SHAPES:
            xx = x.to(torch.bfloat16)
            c = shape[-1]
            wt = w.permute(3, 0, 1, 2).unsqueeze(1).to(torch.bfloat16).contiguous()
            xcf = xx.permute(0, 4, 1, 2, 3)
            row["kernel_ms"] = cuda_ms(lambda: dc.dwconv3(xx, w))
            row["plain_ms"] = cuda_ms(lambda: dc.dwconv3_reference(xx, w))
            row["library_ms"] = cuda_ms(
                lambda: F.conv3d(xcf, wt, padding=1, groups=c))
            elems = int(np.prod(shape))
            nbytes = 2 * elems * 2 + 27 * c * 4
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * 27 * elems / FP32_FLOPS * 1e3
            row["bound_ms"] = max(t_bytes, t_ops)
            row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(json.dumps(row))
        rows.append(row)
    return ok, rows


def check_flagship_vs_cpu(create_waveformer, Config, ac, dc):
    kw = Config().network.model_kwargs()
    cpu = create_waveformer(kw, device="cpu", seed=SEED)
    gpu = create_waveformer(kw, device="cuda")
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    x = torch.from_numpy(
        np.random.default_rng(SEED).standard_normal((1, 4, 128, 128, 128)).astype(np.float32))
    a0, d0 = ac.launches, dc.launches
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
           "dwconv3_launches": dc.launches - d0}
    ok &= row["window_attention_launches"] == 14 and row["dwconv3_launches"] == 10
    log(json.dumps(row))
    return ok


def run_main_path(create_waveformer, Config, SlidingWindowInferer, Predictor, ac, dc):
    model = create_waveformer(Config().network.model_kwargs(), dtype=torch.bfloat16, seed=SEED)
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
    t0 = time.time()
    seg = predictor.predict_case(cases[1], model, out_channels=4)
    s_case = time.time() - t0
    case_counts = (ac.launches, dc.launches)
    ok &= check_seg(seg) and case_counts == (112, 80)

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
            del xx, x_cw, xcf
        for k, r in rs.items():
            log(json.dumps(r))
            rows[k].append(r)
        del x
        torch.cuda.empty_cache()
    return ok, rows


def check_ffn_tail(ft):
    """Phase 7: ffn_tail.cu against `ffn_tail_reference`."""
    dev = torch.device("cuda")
    rows, ok = [], True
    for b, dhw, ch, c in FFN_MAIN_SHAPES + [FFN_ODD_SHAPE]:
        g = torch.Generator(device=dev).manual_seed(SEED)
        h1 = torch.randn(b, *dhw, ch, device=dev, generator=g)
        r = lambda *s, scale=1.0: torch.randn(*s, device=dev, generator=g) * scale
        params = (r(3, 3, 3, ch, scale=0.2), r(ch, scale=0.1), 1 + r(ch, scale=0.1),
                  r(ch, scale=0.1), r(ch, c, scale=ch**-0.5), r(c, scale=0.1))
        row = {"kernel": "ffn_tail", "shape": [b, *dhw, ch, c]}
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            hh = h1.to(dt)
            good, err = within(ft.ffn_tail(hh, *params), ft.ffn_tail_reference(hh, *params), name)
            ok &= good
            row[f"max_err_{name}"] = err
        if (b, dhw, ch, c) in FFN_MAIN_SHAPES:
            hh = h1.to(torch.bfloat16)
            vox = b * int(np.prod(dhw))
            nbytes = 2 * vox * (ch + c) + 4 * 30 * ch + 2 * ch * c + 4 * c
            t_ops = max(FFN_FP32_OPS_PER_ELEMENT * vox * ch / FP32_FLOPS,
                        2 * vox * ch * c / BF16_TENSOR_FLOPS)
            bms, by = bound(nbytes, t_ops)
            row.update({"kernel_ms": cuda_ms(lambda: ft.ffn_tail(hh, *params), iters=10),
                        "plain_ms": cuda_ms(lambda: ft.ffn_tail_reference(hh, *params), iters=5),
                        "library_ms": None, "bound_ms": bms, "bound_by": by})
        log(json.dumps(row))
        rows.append(row)
        del h1
        torch.cuda.empty_cache()
    return ok, rows


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


def run_conv_block_path(create_waveformer, Config, cc, fc, ft):
    """Phase 8: the flagship's 8 UnetResBlocks and 8 CCF-FFN tails on the
    kernels, each against the module's own output in one bf16 forward."""
    from waveformer_tpu_torch.models.conv_blocks import UnetResBlock
    from waveformer_tpu_torch.models.layers import CCF_FFN

    model = create_waveformer(Config().network.model_kwargs(), dtype=torch.bfloat16, seed=SEED)
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
    fc.launches = ft.launches = 0
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
              "conv3x3x3_same": cc.launches["conv3x3x3_same"] + cc.launches["conv3x3x3_batched"],
              "conv3x3x3_cw": cc.launches["conv3x3x3_cw"] + cc.launches["conv3x3x3_same_v2"]}
    ok &= counts == {"conv3x3x3_fused": 16, "ffn_tail": 8, "conv3x3x3_same": 16,
                     "conv3x3x3_cw": 16}

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
    log(json.dumps({"check": "conv_block_path", "launches": counts,
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
    return ok, rows


def run_int8_probe(tm, probe):
    """Phase 9, second half: the probe's entry point (`run`, 64 timed calls
    per shape and type), with exact launch counts, then the plain version's
    time at the largest shape."""
    for k in tm.launches:
        tm.launches[k] = 0
    rows = probe.run(iters=TM_ITERS)
    counts = dict(tm.launches)
    per_kind = len(probe.SHAPES) * (TM_ITERS + 1)  # device_time's warm-up and 64 calls
    ok = counts == {"tiled_matmul_bf16": per_kind, "tiled_matmul_int8": per_kind}
    for r in rows:
        ok &= all(np.isfinite(r[k]) and r[k] > 0 for k in ("us", "top_s", "library_us"))
        log(json.dumps(r))
    entries = []
    for kind in ("bf16", "int8"):
        r = max((r for r in rows if r["dtype"] == kind), key=lambda r: r["bound_us"])
        s, x, w, out_dtype = tiled_matmul_inputs(kind, r["M"], r["K"], r["N"], 0.0, tm)
        plain_ms = cuda_ms(lambda: tm.tiled_matmul_reference(
            s, x, w, out_dtype=out_dtype, perturb_out=kind == "int8"), iters=5, warmup=1)
        entries.append({"name": f"tiled_matmul_{kind}", "ms": r["us"] / 1e3,
                        "plain_ms": plain_ms, "bound_ms": r["bound_us"] / 1e3,
                        "bound_by": r["bound_by"], "library_ms": r["library_us"] / 1e3,
                        "library_call": r["library_call"], "shape": [r["M"], r["K"], r["N"]],
                        "int8_speedup_kernel": r["int8_speedup_kernel"],
                        "int8_speedup_library": r["int8_speedup_library"]})
        del x, w
    log(json.dumps({"check": "int8_probe", "launches": counts, "expected_per_kind": per_kind}))
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
    ok, launches = run_main_path(
        create_waveformer, Config, SlidingWindowInferer, Predictor, ac, dc)
    if not ok:
        failed.append("main_path")
    ok, conv_rows = check_conv(cc, fc)
    results.update(conv_rows)
    if not ok:
        failed.append("conv3")
    ok, results["ffn_tail"] = check_ffn_tail(ft)
    if not ok:
        failed.append("ffn_tail")
    ok, block_launches = run_conv_block_path(create_waveformer, Config, cc, fc, ft)
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
        # the main-path call with the largest bound
        r = max((r for r in rows if "kernel_ms" in r), key=lambda r: r["bound_ms"])
        return {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[kname],
                "max_abs_err": max(max(x["max_err_float32"], x["max_err_bfloat16"])
                                   for x in rows),
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "shape": r["shape"], **extra}

    conv_src = "waveformer_tpu_torch/csrc/conv3.cu"
    cudnn = {"library_call": "F.conv3d, bf16, the conv alone (cuDNN)"}
    log(json.dumps({"kernels": [
        headline(results["attention"], "window_attention",
                 "waveformer_tpu_torch/csrc/window_attention.cu",
                 "waveformer_tpu/ops/attention_pallas.py:34"),
        headline(results["dwconv3"], "dwconv3",
                 "waveformer_tpu_torch/csrc/dwconv3.cu",
                 "waveformer_tpu/ops/dwconv_pallas.py:32"),
        headline(results["conv3x3x3_same"], "conv3x3x3_same", conv_src,
                 "waveformer_tpu/ops/conv_pallas.py:51", **cudnn),
        headline(results["conv3x3x3_cw"], "conv3x3x3_cw", conv_src,
                 "waveformer_tpu/ops/conv_pallas.py:154", **cudnn),
        headline(results["ffn_tail"], "ffn_tail", "waveformer_tpu_torch/csrc/ffn_tail.cu",
                 "tools/exp_ffn_pallas.py:149"),
        headline(results["conv3x3x3_fused"], "conv3x3x3_fused", conv_src,
                 "tools/exp_fused_conv.py:120", **cudnn),
        *({"route": "cuda", "source": "waveformer_tpu_torch/csrc/tiled_matmul.cu",
           "replaces": "tools/exp_int8_mxu.py:26", "launches": launches[e["name"]],
           "max_abs_err": max(v for r in results["tiled_matmul"] if r["kernel"] == e["name"]
                              for k, v in r.items() if k.startswith("perturb_")),
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
