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
     (4, 150, 180, 145) cases; kernel launches are counted over the run.
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
# kernel vs plain version: fp32 sums in another order (TF32 off); in bf16
# both sides round an fp32 result to bf16 (2^-7 relative) and attention
# rounds its probabilities to bf16 before PV at other points
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1.6e-2, 2e-2)}


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
        from waveformer_tpu_torch.ops import dwconv_cuda as dc
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
    for name, n in launches.items():
        if n == 0:
            failed.append(f"{name} never launched on the main path")

    def headline(rows, kname, route, source, replaces):
        r = next(r for r in rows if "kernel_ms" in r)  # the largest main-path call
        return {"name": kname, "route": route, "source": source, "replaces": replaces,
                "launches": launches[kname],
                "max_abs_err": max(max(x["max_err_float32"], x["max_err_bfloat16"])
                                   for x in rows),
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "shape": r["shape"]}

    log(json.dumps({"kernels": [
        headline(results["attention"], "window_attention", "cuda",
                 "waveformer_tpu_torch/csrc/window_attention.cu",
                 "waveformer_tpu/ops/attention_pallas.py:34"),
        headline(results["dwconv3"], "dwconv3", "cuda",
                 "waveformer_tpu_torch/csrc/dwconv3.cu",
                 "waveformer_tpu/ops/dwconv_pallas.py:32"),
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
