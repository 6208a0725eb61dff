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
     separate bias add its epilogue replaces); attention and the stencil
     also at every shape phases 14 and 15 give them (a tensor rank's heads
     and hidden channels, a spatial rank's windows and halo slabs, the 64³
     flagship's 4³-token windows); the stencil's backward kernels (dgrad on
     the forward kernel with flipped taps, `wft_dwconv3_wgrad`) against the
     plain composition at every shape in both dtypes, one launch of each on
     the design the rule names, and at the main shapes their ms in bf16
     beside the plain composition's and the bound;
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
  5b. the serving pipeline, in a temporary directory: two BraTS-shaped
     cases (raw (240, 240, 155) ground truth under a non-RAS affine,
     preprocessed (4, 150, 180, 145) data with its properties), a YAML
     config read by the port's own reader and a `best_model_*.npz` in the
     JAX package's format from the seed-0 flagship;
     `waveformer_tpu_torch.scripts.predict` at `--tta 8` (launches exactly
     112 `tma_wgmma` attention and 80 `tma_ring` stencil launches a case),
     each written NIfTI equal voxel for voxel (and in its affine) to
     `predict_case` + `save_to_nii` of the in-memory seed-0 model, then
     `scripts.compute_metrics` (a finite (2, 3, 2) result) and
     `dice_torch` on the card against the host `dice` (1e-6);
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
 10. the training path: (a) one fp32 train step (DiceCE, the optax-form
     clip at 12, AdamW on fp32 masters) of the 32³ example network at
     batch 2, the card (kernels) against the CPU (plain versions) from the
     same seeded weights and batch; (b) the flagship at full width and depth,
     128³, batch 2, bf16, built by `scripts.train.build_model`, 6 steps on
     one resident batch: the loss after 5 updates below the first, exactly
     14 `tma_wgmma` attention and 10 `tma_ring` stencil launches a forward
     and 10 `dgrad_tma_ring` and 10 `wgrad_tma_ring` backward launches a
     step (none a validation forward), device ms a step
     by CUDA events and peak memory; (c) `scripts.train.main` on a
     temporary tree of 4 synthetic (4, 150, 180, 145) cases and a YAML
     config (roi 128³, batch 2, bf16, `train_fast` augmentation in 2
     workers, 2 epochs of 4 steps, validation every epoch): finite losses,
     best and final params `.npz` files whose weights, loaded through
     `state_dict_from_jax` into a fresh model, give eval logits equal to the
     trainer's, the warm steps/s through the trainer and its loader-wait
     share. Phase 10's launches count toward the kernels line.
 11. the front end and the deploy wrapper, in a temporary directory, from 3
     raw cases as the BraTS download names them ((240, 240, 155) fp32
     modalities nonzero in an ellipsoid brain, a seeded tumour with labels
     1-3, under the non-RAS serving affine): `scripts.rename_data` (15
     files), `scripts.convert_split` (the test list), `scripts.preprocess
     --dataset-type mri --num-processes 2` (`plans.json` read back by
     `Plans.load`; every stored channel of mean 0 and std 1 to 1e-5; seg
     −1 outside the nonzero mask; `class_locations` for labels 1-3; one
     case run again in-process through `run_case_npy`, equal to the
     worker's artifact), `scripts.predict --tta 8` on those artifacts with
     the seed-0 flagship's JAX-format checkpoint, `deploy.process` on the
     renamed raw tree (each label map at the raw shape, exactly the source
     affine, voxel-equal to `scripts.predict`'s), both with exactly 14
     `tma_wgmma` attention and 10 `tma_ring` stencil launches per forward
     (forwards counted from the inferer's own window grid for the
     preprocessed shapes), then `scripts.compute_metrics` on the deploy
     outputs (a finite (3, 3, 2) result); the preprocessing host s/case,
     the deploy s/case split into read, preprocess, card and write, and
     the metrics s/case on a line of their own. Phase 11's launches count
     toward the kernels line.
 12. SSL pretraining, which runs none of the port's kernels (its attention
     is flax's plain multi-head attention, in the port
     `F.scaled_dot_product_attention`; its decoder convs are cuDNN's):
     every kernel's launches are counted over the phase and must stay 0.
     (a) one fp32 SSL step (two context-restoration views, NT-Xent × L1 +
     L1, AdamW without clipping on fp32 masters) of a 32³ SSLViT (patch 8,
     hidden 64, 2 layers) at batch 2, the card against the CPU from the
     same carried weights and views, at phase 10a's limits; (b) the
     pretraining script's default SSLViT (ViT-B: 96³, patch 16, hidden 768,
     12 layers, 12 heads, the vae decoder, about 108 M parameters) in bf16
     on fp32 masters, one resident batch of 2 and pair of views: 2 warm-up
     steps, device ms a step by CUDA events over 5, peak memory, finite
     losses with the 5th below the 1st; (c) `scripts.pretrain_ssl.main` at
     its default widths in both data modes (`--data-dir`: 4 synthetic
     (4, 150, 180, 145) cases, 2 workers, 12 steps, validation every 6;
     `--datalist-json`: 3 CT-like (192, 192, 128) int16 volumes, cached, 4
     steps, validation every 2): finite losses, best and final `.npz`, the
     final one reloaded into a fresh SSLViT with fp32 outputs equal to the
     trainer's, the warm steps/s and loader-wait share from
     `SSLTrainer.step_times`. To iterate on it alone: `chip_smoke.run_ssl()`
     after `_build.LIBRARIES.build_all()` and TF32 off.
 14. model parallelism on the one card: ranks are child processes over
     gloo with CUDA tensors, each with TF32 off. The flagship at full width
     and depth (seed-0 weights), 128³, batch 1, on phase 4's input, in
     fp32 and bf16, through `make_mesh` → `shard_model` → `shard_batch` →
     the sharded forward under `torch.no_grad()` → `gather_depth`: (a)
     tensor=3 (3 ranks; tensor=2 does not divide stage 1's 3 heads), (b)
     spatial=2 (2 ranks), each against a one-process forward in a child of
     its own (fp32 within atol 2e-4 / rtol 1e-3, JAX's tolerance for its
     sharding tests; bf16 within TOL["bfloat16"]), with exactly 14
     attention and 10 stencil launches a forward on every rank on the
     dtype's designs, and (b)'s fp32 peak memory a rank at most 0.7× the
     one-process peak. Each rank's forward seconds and the bytes its
     collectives moved are printed. Phase 14's launches count toward the
     kernels line. To iterate on it alone: `chip_smoke.run_model_parallel()`
     from a guarded script after `_build.LIBRARIES.build_all()`.
 15. model-parallel training on the one card, the ranks as in phase 14:
     the flagship (seed-0 weights, channels-last, batch 1, phase 10b's
     kind of input: unit normal plus the tumour mask, its concentric
     labels) takes two train steps (`master_params`, then `shard_model`,
     `shard_batch`, `make_train_step`) against the same two steps in a
     one-process child: (a) spatial=2 at 128³ in fp32 and bf16; (b)
     tensor=3 in fp32 at 64³ (three ranks of fp32 128³ activations would
     not fit the card) and in bf16 at 128³. Gates: step 1's assembled
     gradients against the one process's, each parameter's ‖Δg‖ within
     MP_TRAIN_TOL (fp32 and bf16), the unclipped norm within 1e-4 relative
     in fp32, the ranks' masters bit-equal after the steps, exactly 14
     attention and 10 stencil launches a step on every rank on the dtype's
     designs (and 10 dgrad and 10 wgrad launches of the stencil's backward,
     `vector` in fp32, `tma_ring` in bf16), and at spatial=2 a rank's fp32
     peak at most 0.7× the one process's. Each rank's seconds a step,
     forward and backward collective bytes and the gradient assembly's
     device ms a line are printed. (c)
     `Trainer(mesh=spatial=2)` on phase 10c's kind of tree (bf16, batch 2,
     the loader in the row lead's process, whose spawned workers would
     start up longer than the 2 steps take; patch validation and
     full-volume validation on the unsharded copy at (0, 0, 0)), then a
     periodic state that a second trainer, built from other weights,
     reloads to bit-equal masters on both ranks; (d)
     `SSLTrainer(mesh=spatial=2)`, two fp32 steps (the first at lr 0) of
     phase 12a's SSLViT, its masters equal on both ranks and within phase
     10a's master limit of the steps without a mesh. To iterate on it
     alone: `chip_smoke.run_model_parallel_training()` from a guarded
     script after `_build.LIBRARIES.build_all()`.
 16. the auxiliary ops, which run none of the port's kernels (the JAX
     package writes them in plain `jnp`): each sub-phase's calls on the
     card against the same calls on CPU tensors in fp32 (TF32 off), every
     output on the card, every kernel's launches 0, each sub-phase's card
     ms (CUDA events) and peak memory on its line. (a) `grid_pull` at
     orders 0-3 × zero/clamp/reflect and with per-dimension orders and
     bounds, `grid_push` and `grid_count` at orders 1 and 3, pull's
     gradients for the volume and the coordinates at orders 1 and 3, the
     adjoint identity and `spline_prefilter` at order 3, on a (128³, 4)
     volume and 2,097,152 points (the identity grid displaced smoothly by
     up to 4 voxels); (b) `bilateral_filter` and `joint_bilateral_filter`
     on (1, 128³, 4) at σs = 1, σc = 0.5, `TrainableBilateralFilter`'s
     forward and backward against the CPU at 64³, then its 128³ backward
     on the card alone (finite gradients, peak memory); (c) `gmm_fit`
     (4096 × 4, K = 2, 20 steps) and `gmm_segment` of a 128³ × 4 volume
     with two seeded classes, one under 4096 seeds (labels ≥ 99.9% equal);
     (d) criss-cross attention at CCNet's Cityscapes head (2, 97 × 97, 64
     / 512) with its gradients; (e) the legacy 2D modules at SegFormer
     MiT-B2's stage 1 on 512² images, batch 2, weights carried from the CPU
     modules; (f) the generic wavelet path with a registered 2-tap bank at
     the flagship's stage-1 shape (8, 64³, 48), level 3, a copy of db1's
     bank against the Haar path, and a 4-tap bank raising ValueError. To
     iterate on it alone: `chip_smoke.run_aux_ops()` with TF32 off (no
     kernel build needed).
 17. the repository's drivers, each through its `main` with no `--device`
     (so on the card): (a) `tools.bench_train --device-only` at the
     flagship (bf16 on fp32 masters, 128³, batch 1), a warm-up step and 5
     chained steps; (b) its pipeline mode, `Trainer` over 2 spawned loader
     workers, 2 epochs of 4 steps on four synthetic (4, 150, 180, 145)
     cases; (c) `tools.bench_tta --tta 1 2 --cases 1`; (d) the liver-CT
     example driver (`examples.liver_ct`: preprocess, train, predict,
     metrics) at `--cases 4 --epochs 1 --steps 3`. Gates: finite losses,
     label maps and metrics of the right shapes, and exact launch counts
     per design: 14 `tma_wgmma` attention and 10 `tma_ring` stencil
     launches a bf16 flagship forward (a train step's forward, N forwards
     a case at tta N), and for the example's tiny fp32 network its own
     forward's `fma` and `vector` launches times its forwards (3 steps, 4
     validation batches, the validation cases' windows). Phase 17's
     launches count toward the kernels line. To iterate on it alone:
     `chip_smoke.run_drivers(ac, dc)` from a guarded script after
     `_build.LIBRARIES.build_all()` and TF32 off.
 18. SwinUNETR-V2's shifted windows: the masked kernel (`window_attention`
     with `ops.window.shift_labels`) at the four calls of a batch-8 128³
     forward, (8000 | 1000 | 216 | 64, 3 | 6 | 12 | 24, 343, 16) with the
     labels of the padded grids 70³ / 35³ / 21³ / 14³, against the plain
     composition in bf16 (`tma_wgmma`) and fp32 (`fma`), one masked launch
     a call on the design its rule names, with the bf16 kernel's ms beside
     the unmasked launch's, the plain composition's and the bound; then a
     128³ case through `Predictor` (8-way patch TTA: 8 batch-1 forwards)
     on the seed-0 bf16 model built by `models.create_model` (`model_type:
     "SwinUNETR"`): exactly 8 `tma_wgmma` launches a forward, 4 of them
     masked, none on `fma`. Its launches count toward the kernels line.
     To iterate on it alone: `chip_smoke.run_swin_path(ac)` after
     `_build.LIBRARIES.build_all()` and TF32 off.
The last lines are a `{"kernels": [...]}` JSON line (each kernel at the
main-path call with the largest bound, with its worst ratio to its library
call over the main-path shapes), the card line, and
`{"ok": true, "device": {...}}`. Without CUDA, or without the repository
beside it, the script exits non-zero and prints no result.
"""

import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
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
# phase 14's calls (batch 1, N = 512, D = 16) that the lists above lack: the
# one process's, a tensor=3 rank's H/3 heads, a spatial=2 rank's local
# windows (its gathered grids are the one process's)
ATTN_SHARDED_SHAPES = [(1, 3, 512, 16), (1, 6, 512, 16), (1, 12, 512, 16), (1, 24, 512, 16),
                       (64, 1, 512, 16), (8, 1, 512, 16), (1, 1, 512, 16), (8, 2, 512, 16),
                       (1, 2, 512, 16), (1, 4, 512, 16), (1, 8, 512, 16),
                       (32, 3, 512, 16), (4, 6, 512, 16)]
# phase 15's calls that phase 14 does not make: the 64³ flagship's 4³-token
# windows, the one process's heads and a tensor=3 rank's H/3 (its 128³
# calls are phase 14's)
ATTN_TRAIN_SHAPES = [(64, 3, 64, 16), (8, 3, 64, 16), (1, 3, 64, 16), (8, 6, 64, 16),
                     (1, 6, 64, 16), (1, 12, 64, 16), (1, 24, 64, 16), (64, 1, 64, 16),
                     (8, 1, 64, 16), (1, 1, 64, 16), (8, 2, 64, 16), (1, 2, 64, 16),
                     (1, 4, 64, 16), (1, 8, 64, 16)]
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
# phase 14's calls: the one process's (batch 1), a tensor=3 rank's Ch/3
# hidden channels, a spatial=2 rank's (D/2 + 2)-plane halo slabs
DW_SHARDED_SHAPES = [
    (1, 64, 64, 64, 192), (1, 32, 32, 32, 384), (1, 16, 16, 16, 768), (1, 8, 8, 8, 1536),
    (1, 64, 64, 64, 96), (1, 64, 64, 64, 64), (1, 32, 32, 32, 128), (1, 16, 16, 16, 256),
    (1, 8, 8, 8, 512), (1, 34, 64, 64, 192), (1, 18, 32, 32, 384), (1, 10, 16, 16, 768),
    (1, 6, 8, 8, 1536), (1, 34, 64, 64, 96),
]
# phase 15's 64³ calls: the one process's and a tensor=3 rank's Ch/3
DW_TRAIN_SHAPES = [
    (1, 32, 32, 32, 192), (1, 16, 16, 16, 384), (1, 8, 8, 8, 768), (1, 4, 4, 4, 1536),
    (1, 32, 32, 32, 96), (1, 32, 32, 32, 64), (1, 16, 16, 16, 128), (1, 8, 8, 8, 256),
    (1, 4, 4, 4, 512),
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
# phase 10: card against CPU on one fp32 train step of the 32³ network
# (loss and gradient norm: fp32 sums in other orders, TF32 off; masters: one
# AdamW step moves a parameter by at most lr = 1e-4)
TRAIN_STEP_TOL = {"loss_rel": 1e-4, "grad_norm_rel": 1e-3, "master_abs": 1e-5}
TRAIN_RESIDENT_STEPS = 5
TRAIN_STEPS_PER_EPOCH = 4
# the serving phase: raw BraTS volumes (X, Y, Z) under a non-RAS source affine,
# and each case's crop in canonical (D, H, W) = (155, 240, 240), of CASE_SHAPE
SERVING_RAW_SHAPE = (240, 240, 155)
SERVING_AFFINE = np.diag([-1.0, -1.0, 1.0, 1.0]).astype(np.float32)
SERVING_BBOXES = [((2, 152), (30, 210), (48, 193)), ((4, 154), (28, 208), (50, 195))]
# the front-end phase: raw cases whose brain ellipsoid keeps this margin
# (raw voxels X, Y, Z) from the faces, a crop of about (145, 179, 159) in
# canonical (D, H, W), bucketed to 192³ as BraTS cases are; 2 workers
FRONT_END_CASES = 3
FRONT_END_MARGIN = (40, 30, 5)
FRONT_END_WORKERS = 2
# phase 12, SSL pretraining: 12a's SSLViT, card against CPU in fp32 (the
# gates are phase 10a's TRAIN_STEP_TOL); 12b's, the pretraining script's
# defaults (ViT-B, about 108 M parameters, 216 tokens a volume)
SSL_STEP_CONFIG = dict(img_size=(32, 32, 32), patch_size=8, in_channels=4, hidden_size=64,
                       mlp_dim=256, num_layers=2, num_heads=4, projection_size=16,
                       upsample_mode="vae")
SSL_FULL_CONFIG = dict(img_size=(96, 96, 96), patch_size=16, in_channels=4, hidden_size=768,
                       mlp_dim=3072, num_layers=12, num_heads=12, projection_size=256,
                       upsample_mode="vae")
SSL_WARMUP_STEPS = 2
SSL_RESIDENT_STEPS = 5
SSL_SCRIPT_STEPS = 12
# 12c's datalist mode: CT-like int16 volumes (X, Y, Z), one of them validates
SSL_CT_VOLUMES = 3
SSL_CT_SHAPE = (192, 192, 128)
# phase 13, data parallelism: 13a's network (the 32³ example at phase 10a's
# batch, drop path on), 13d's steps; every child process's time limit
PARALLEL_NET = dict(EXTRA_CONFIGS["example_32"], drop_path_rate=0.2)
PARALLEL_STEPS = 2
PARALLEL_SSL_STEPS = 4
CHILD_TIMEOUT_S = 300
GROUP_TIMEOUT_S = 60
# phase 14, model parallelism: (data, spatial, tensor) of each sub-phase,
# the one-process forward's first; a rank's peak over the one process's
MODEL_PARALLEL_MESHES = {"one_process": (1, 1, 1), "tensor3": (1, 1, 3), "spatial2": (1, 2, 1)}
MODEL_PARALLEL_TOL = {"float32": (1e-3, 2e-4), "bfloat16": TOL["bfloat16"]}  # (rtol, atol)
MODEL_PARALLEL_PEAK_RATIO = 0.7
# phase 15, model-parallel training: each sub-phase's mesh and its runs
# (dtype, cube side); the one-process child runs every run once
MP_TRAIN_RUNS = {"spatial2": ((1, 2, 1), (("float32", 128), ("bfloat16", 128))),
                 "tensor3": ((1, 1, 3), (("float32", 64), ("bfloat16", 128)))}
# step 1's gradients, each parameter's ‖Δg‖ against (its ‖g‖, the model's
# max |g|·√n). fp32: sums in other orders (TF32 off); the CPU test of these
# steps on the 32³ toy found up to 1.4e-3 of ‖g‖ where an InstanceNorm input
# is near constant. bf16: the ranks round activations to bf16 at other
# points than the one process (fp32 partial sums, resizes rounded once:
# phase 14's logits used 0.87 of TOL["bfloat16"]), and a rounding flip
# moves a gradient element by up to ulp(2^-8) of its size along the
# backward: 5e-2 of ‖g‖; the biases with an exact gradient of 0 get noise
# of about 1e-3 of the model's largest gradient. Norm: 1e-4 (fp32), 2e-2
MP_TRAIN_TOL = {"float32": (1e-2, 1e-6, 1e-4), "bfloat16": (5e-2, 1e-3, 2e-2)}
MP_TRAINER_STEPS = 2
# phase 16, the auxiliary ops (no port kernel on their path), card against
# CPU in fp32 with TF32 off. Limits: the CPU tests' against JAX (forwards
# 1e-5, gradients and GMM parameters 1e-4, relative to each output's largest
# value) widened 10× for the card's other summation order (push's atomics,
# cuBLAS/cuDNN reductions); GMM labels flip only at a likelihood tie.
AUX_TOL = {"forward": 1e-4, "gradient": 1e-3, "gmm_params": 1e-3, "labels_equal": 0.999,
           "adjoint": 1e-5}
AUX_VOLUME = (128, 128, 128, 4)  # a BraTS crop, channels-last
AUX_MAX_DISPLACEMENT = 4.0  # voxels, a smooth seeded field on the identity grid
AUX_BILATERAL = (1.0, 0.5)  # σs, σc: radius 2, 125 offsets
AUX_BILATERAL_GRAD_SIDE = 64  # the trainable filter's backward card vs CPU
AUX_GMM_FIT = (4096, 4, 2, 20)  # rows, channels, components, EM steps
AUX_GMM_SEEDS = (20000, 3000)  # seeded voxels of class 0 (outside) and 1 (inside)
AUX_CC = (2, 97, 97, 64, 512)  # CCNet's Cityscapes head: B, 769/8, 769/8, Cqk, Cv
AUX_MIT_B2 = (2, 512, 3, 64, 256)  # batch, image side, in, stage-1 width, MLP hidden
AUX_WAVELET = ((8, 64, 64, 64, 48), 3)  # the flagship's stage-1 input, DWT level 3
# phase 17, the drivers: bench_train's chained steps after its warm-up; its
# pipeline mode's (steps an epoch, epochs, loader workers); bench_tta's settings
DRIVER_STEPS = 5
DRIVER_PIPELINE = (4, 2, 2)
DRIVER_TTA = (1, 2)


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
    for shape in ATTN_MAIN_SHAPES + ATTN_TEST_SHAPES + ATTN_SHARDED_SHAPES + ATTN_TRAIN_SHAPES:
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
        else:  # the other shapes' time, beside nothing
            row["other_ms_bf16"] = cuda_ms(lambda: ac.window_attention(qq, kk, vv, bias, scale))
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
    for shape in DW_MAIN_SHAPES + [(2, 6, 5, 7, 96)] + DW_SHARDED_SHAPES + DW_TRAIN_SHAPES:
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
        for dt in (torch.float32, torch.bfloat16):
            good, row[f"backward_err_share_{str(dt).split('.')[1]}"] = check_dwconv_backward(
                dc, x.to(dt), 0.2 * w, torch.randn(shape, device=dev, generator=g).to(dt))
            ok &= good
        if shape in DW_MAIN_SHAPES:
            xx = x.to(torch.bfloat16)
            gg = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
            wf = w.flip((0, 1, 2))
            row["backward_kernel_ms"] = cuda_ms(lambda: dc.backward_kernels(xx, w, gg))
            row["backward_dgrad_ms"] = cuda_ms(lambda: dc.dwconv3(gg, wf))
            row["backward_wgrad_ms"] = row["backward_kernel_ms"] - row["backward_dgrad_ms"]
            row["backward_plain_ms"] = cuda_ms(lambda: dc.dwconv3_backward(xx, w, gg), iters=3)
            # dgrad reads g and writes dx, wgrad reads x and g (bf16); 2 × 27
            # multiply-adds an element
            elems = int(np.prod(shape))
            t_bytes = (4 * elems * 2 + 2 * 28 * c * 4) / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * 2 * 27 * elems / FP32_FLOPS * 1e3
            row["backward_bound_ms"] = max(t_bytes, t_ops)
            row["backward_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(json.dumps(row))
        rows.append(row)
    return ok, rows


def check_dwconv_backward(dc, x, w, g):
    """The backward kernels against `dwconv3_backward` on the same inputs,
    one dgrad and one wgrad launch on the design `dc.design` names: fp32
    sums in other orders, within 1e-5 of the terms' magnitudes (that
    backward on |x|, |w|, |g|); dx also rounded once to x's dtype (2^-8 of
    |dx| in bf16). Returns (ok, the worst error as a share of its bound)."""
    name = dc.design(x.dtype, x.shape[-1])
    before = dict(dc.backward_design_launches)
    got = dc.backward_kernels(x, w, g)
    torch.cuda.synchronize()
    ok = dc.backward_design_launches == dict(
        before, **{f"dgrad_{name}": before[f"dgrad_{name}"] + 1,
                   f"wgrad_{name}": before[f"wgrad_{name}"] + 1})
    want = dc.dwconv3_backward(x, w, g)
    mag = dc.dwconv3_backward(x.abs(), w.abs(), g.abs())
    rtol = (0.0 if x.dtype == torch.float32 else 2.0**-8, 0.0, 0.0)
    worst = max(float(((a.float() - b).abs() / (r * b.abs() + 1e-5 * m + 1e-30)).max())
                for a, b, m, r in zip(got, want, mag, rtol))
    ok &= got[0].dtype == x.dtype and worst <= 1.0
    return bool(ok), worst


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


def run_main_path(bench, ac, dc):
    # the bench protocol, built by the bench's own setup: (C, D, H, W) cases,
    # the seed-0 bf16 flagship, channels-first model and inferer
    model, predictor = bench.setup()
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


def serving_config_text(root):
    """The serving phase's YAML config, read by the port's own reader: the
    flagship network of examples/brats2023/config.yaml, bf16, 128³ roi,
    sw_batch 8, overlap 0.5, 8-way mirror TTA."""
    return f"""\
# the serving phase of chip_smoke.py
data_dir: "{root}/fullres"
logdir: "{root}/logs/"
raw_data_dir: "{root}/raw"
model_name: "chip_smoke"
data_list_path: "{root}/data_list"
split_path: "default_split"
seed: {SEED}
compute_dtype: "bfloat16"
label_mode: "brats"
prediction:
  patch_size: [128, 128, 128]
  sw_batch_size: 8
  overlap: 0.5
  mirror_axes: [0, 1, 2]
  raw_spacing: [1, 1, 1]
  prediction_save: "{root}/predictions"
logging:
  log_file: "{root}/logs/predict.log"
network:
  model_type: "Waveformer"
  in_channels: 4
  out_channels: 4
  img_size: [128, 128, 128]
  patch_size: 2
  transformer:
    embed_dims: [48, 96, 192, 384]
    depths: [2, 2, 2, 2]
    num_heads: [3, 6, 12, 24]
    decom_levels: [3, 2, 1, 0]
    multi_scale_attention: true
    hf_refinement: false
"""


def write_serving_tree(root, rng):
    """Two BraTS-shaped cases as preprocessing leaves them (raw (240, 240,
    155) ground truth in source voxel order under a non-RAS affine,
    preprocessed (4, 150, 180, 145) fp32 data with its properties), the
    YAML config and a `best_model_*.npz` written from the seed-0 flagship
    in the JAX package's format."""
    from waveformer_tpu_torch.config import Config
    from waveformer_tpu_torch.tools import synthetic_cases

    names = synthetic_cases.write_cases(root, rng, SERVING_RAW_SHAPE, SERVING_BBOXES,
                                        SERVING_AFFINE)
    config = os.path.join(root, "config.yaml")
    with open(config, "w") as f:
        f.write(serving_config_text(root))
    synthetic_cases.write_checkpoint(
        os.path.join(root, "logs", "model", "best_model_0.0000_chip_smoke.npz"),
        Config().network.model_kwargs(), seed=SEED)
    return config, names


def run_serving_path(bench, ac, dc):
    """The serving phase: `scripts.predict` at `--tta 8` on two BraTS-shaped
    cases (exact launch counts per design), each written NIfTI against
    `predict_case` + `save_to_nii` of the in-memory seed-0 model,
    `scripts.compute_metrics` on the predictions, and `dice_torch` on the
    card against the host `dice`."""
    from waveformer_tpu_torch.metrics import convert_labels_brats, dice, dice_torch
    from waveformer_tpu_torch.scripts import compute_metrics, predict
    from waveformer_tpu_torch.utils import nifti

    ok = True
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        config, names = write_serving_tree(root, np.random.default_rng(SEED))
        setup_s = time.time() - t0
        n = len(names)

        for counter in (ac, dc):
            counter.launches = 0
            for k in counter.design_launches:
                counter.design_launches[k] = 0
        torch.cuda.synchronize()
        t0 = time.time()
        summary = predict.main(["--config", config, "--tta", "8"])
        script_s = time.time() - t0
        launches = {"window_attention": ac.launches, "dwconv3": dc.launches}
        designs = {"window_attention": dict(ac.design_launches),
                   "dwconv3": dict(dc.design_launches)}
        ok &= summary["cases"] == n
        ok &= launches == {"window_attention": 112 * n, "dwconv3": 80 * n}
        ok &= designs == {"window_attention": {"fma": 0, "tma_wgmma": 112 * n},
                          "dwconv3": {"vector": 0, "tma_ring": 80 * n}}

        model, predictor = bench.setup()
        equal, case_s, save_s, dice_errs, compared = [], [], [], [], 0
        predictions = {}
        for name in names:
            base = os.path.join(root, "fullres", name)
            with open(base + ".pkl", "rb") as f:
                props = pickle.load(f)
            t0 = time.time()
            seg = predictor.predict_case(np.load(base + ".npy"), model, 4, props)
            case_s.append(time.time() - t0)
            ref_path = os.path.join(root, name + "_in_memory.nii.gz")
            t0 = time.time()
            predictor.save_to_nii(seg, ref_path, properties=props)
            save_s.append(time.time() - t0)
            got = nifti.load(os.path.join(root, "predictions", name + ".nii.gz"))
            want = nifti.load(ref_path)
            predictions[name] = (got.data, got.affine)
            equal.append(got.data.shape == SERVING_RAW_SHAPE
                         and np.array_equal(got.data, want.data)
                         and np.array_equal(got.affine, want.affine)
                         and np.array_equal(got.affine, SERVING_AFFINE))
            # dice_torch on the card against the host dice, TC/WT/ET
            gt = nifti.load(os.path.join(root, "raw", name, "seg.nii.gz")).data.T
            p, g = convert_labels_brats(got.data.T), convert_labels_brats(gt)
            on_card = dice_torch(torch.from_numpy(p).cuda(), torch.from_numpy(g).cuda())
            on_card = on_card.double().cpu().numpy()
            for c in range(3):
                if p[c].any() and g[c].any():
                    dice_errs.append(abs(float(on_card[c]) - dice(p[c], g[c])))
                    compared += 1
        ok &= all(equal) and compared > 0 and max(dice_errs) <= 1e-6
        del model, predictor
        torch.cuda.empty_cache()

        out = os.path.join(root, "result_metrics.npy")
        t0 = time.time()
        results = compute_metrics.main(["--config", config, "--out", out])
        metrics_s = time.time() - t0
        ok &= results.shape == (n, 3, 2) and bool(np.isfinite(results).all())
        ok &= np.array_equal(np.load(out), results)

    row = {"check": "serving_path", "cases": n, "case_shape": list(CASE_SHAPE),
           "raw_shape": list(SERVING_RAW_SHAPE), "setup_s": setup_s,
           "script_seconds_per_case": script_s / n,
           "script_cases_per_s": summary["cases_per_s"],
           "predict_case_seconds": case_s, "save_to_nii_seconds": save_s,
           "metrics_seconds": metrics_s,
           "launches": launches, "launches_by_design": designs,
           "files_equal_in_memory": equal,
           "dice_torch_max_abs_err": max(dice_errs, default=None),
           "dice_classes_compared": compared, "metrics": results.tolist(), "ok": bool(ok)}
    log(json.dumps(row))
    return ok, predictions


def training_config_text(root):
    """Phase 10's YAML config, read by the port's own reader: the flagship
    network (`Config()`'s defaults), bf16, roi 128³, batch 2, `train_fast`
    augmentation in 2 workers, 2 epochs of 4 steps, validation every epoch
    on 2 patches."""
    return f"""\
# the training phase of chip_smoke.py
data_dir: "{root}/fullres"
logdir: "{root}/logs/"
model_name: "chip_smoke"
data_list_path: "{root}/data_list"
split_path: "default_split"
roi_size: [128, 128, 128]
seed: {SEED}
compute_dtype: "bfloat16"
batch_size: 2
max_epoch: 2
num_steps_per_epoch: {TRAIN_STEPS_PER_EPOCH}
val_every: 1
val_patches_per_epoch: 2
train_process: 2
label_mode: "brats"
logging:
  log_file: "{root}/logs/train.log"
"""


# phase 18: SwinUNETR-V2 at 128³, batch 8 — each stage's window-attention
# call (B·nW, heads, 7³, 16) and the padded grid its shift labels cover
SWIN_STAGE_CALLS = [((8000, 3, 343, 16), 70), ((1000, 6, 343, 16), 35),
                    ((216, 12, 343, 16), 21), ((64, 24, 343, 16), 14)]
SWIN_WINDOW, SWIN_SHIFT = 7, 3


def check_masked_attention(ac):
    """Phase 18's kernel part: each stage call with its shift labels
    against the plain composition, in both dtypes, one masked launch a
    call on the design the rule names; bf16 times beside the unmasked
    launch, the plain composition and the bound."""
    from waveformer_tpu_torch.ops.window import shift_labels

    dev = torch.device("cuda")
    ok, rows = True, []
    for shape, grid in SWIN_STAGE_CALLS:
        bw, h, n, d = shape
        labels = shift_labels((grid,) * 3, (SWIN_WINDOW,) * 3, (SWIN_SHIFT,) * 3).to(dev)
        g = torch.Generator(device=dev).manual_seed(SEED)
        q, k, v = (torch.randn(shape, device=dev, generator=g) for _ in range(3))
        bias = torch.randn(h, n, n, device=dev, generator=g) * 0.5
        scale = d**-0.5
        row = {"kernel": "window_attention", "masked": True, "shape": list(shape),
               "label_windows": labels.shape[0]}
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            qq, kk, vv = (t.to(dt) for t in (q, k, v))
            design = ac.design(dt, n, d)
            before, masked = dict(ac.design_launches), ac.masked_launches
            got = ac.window_attention(qq, kk, vv, bias, scale, labels)
            torch.cuda.synchronize()
            launched = (ac.design_launches == dict(before, **{design: before[design] + 1})
                        and ac.masked_launches == masked + 1)
            want = ac.window_attention_reference(qq, kk, vv, bias, scale, labels)
            good, err = within(got, want, name)
            ok &= good and launched
            row[f"max_err_{name}"], row[f"design_{name}"] = err, design
            del got, want
        qq, kk, vv = (t.to(torch.bfloat16) for t in (q, k, v))
        row["kernel_ms"] = cuda_ms(lambda: ac.window_attention(qq, kk, vv, bias, scale, labels))
        row["unmasked_ms"] = cuda_ms(lambda: ac.window_attention(qq, kk, vv, bias, scale))
        row["plain_ms"] = cuda_ms(
            lambda: ac.window_attention_reference(qq, kk, vv, bias, scale, labels), iters=3)
        # the least time, as phase 3's, the labels' bytes added
        times = {
            "bytes": (4 * bw * h * n * d * 2 + h * n * n * 4 + labels.numel()) / HBM_BYTES_PER_S
            * 1e3,
            "operations": 4 * bw * h * n * n * d / BF16_TENSOR_FLOPS * 1e3,
            "exponentials": bw * h * n * n / EXP2_PER_S * 1e3,
        }
        row["bound_by"] = max(times, key=times.get)
        row["bound_ms"] = times[row["bound_by"]]
        log(json.dumps(row))
        rows.append(row)
        del q, k, v, qq, kk, vv
        torch.cuda.empty_cache()
    return ok, rows


def run_swin_path(ac):
    """Phase 18: the masked kernel at the stage calls, then a 128³ case
    through `Predictor` on SwinUNETR-V2 with exact launch counts. Returns
    (ok, the masked kernel's rows, the case's window-attention launches)."""
    from waveformer_tpu_torch.config import NetworkConfig
    from waveformer_tpu_torch.inference import Predictor, SlidingWindowInferer
    from waveformer_tpu_torch.models import create_model

    ok, rows = check_masked_attention(ac)
    model = create_model(NetworkConfig(model_type="SwinUNETR", use_v2=True),
                         dtype=torch.bfloat16, seed=SEED, io_layout="channels_first")
    inferer = SlidingWindowInferer(roi_size=(128,) * 3, sw_batch_size=8, overlap=0.5,
                                   mirror_axes=(0, 1, 2), layout="channels_first",
                                   tta_mode="patch")
    predictor = Predictor(inferer, upload_dtype=torch.bfloat16)
    case = np.random.default_rng(SEED).standard_normal((4, 128, 128, 128)).astype(np.float32)
    predictor.predict_case(case, model, out_channels=4)  # warm-up
    torch.cuda.synchronize()
    zero_counts(ac)
    ac.masked_launches = 0
    seg = predictor.predict_case(case, model, out_channels=4)
    forwards = forwards_per_case(inferer, case.shape[1:])
    designs, masked = dict(ac.design_launches), ac.masked_launches
    ok &= (seg.shape == case.shape[1:] and int(seg.max()) < 4
           and ac.launches == 8 * forwards and masked == 4 * forwards
           and designs == {"fma": 0, "tma_wgmma": 8 * forwards})
    log(json.dumps({"check": "swin_path_predict", "case_shape": list(case.shape),
                    "forwards": forwards, "window_attention_launches": ac.launches,
                    "masked_launches": masked, "designs": designs,
                    "label_counts": np.bincount(seg.ravel(), minlength=4).tolist()}))
    launched = ac.launches
    del model, predictor
    torch.cuda.empty_cache()
    return bool(ok), rows, launched


def masked_headline(rows):
    """The kernels line's masked entry: phase 18's call with the largest
    bound and the worst error over its calls."""
    r = max(rows, key=lambda r: r["bound_ms"])
    return {"shape": r["shape"], "ms": r["kernel_ms"], "unmasked_ms": r["unmasked_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "max_abs_err": max(v for x in rows for k, v in x.items() if k.startswith("max_err_"))}


def zero_counts(*counters):
    for counter in counters:
        counter.launches = 0
        for counts in (counter.design_launches, getattr(counter, "backward_design_launches", {})):
            for k in counts:
                counts[k] = 0


def stencil_backward(name, calls):
    """The stencil's `backward_design_launches` as `calls` dgrad and wgrad
    launches on the design `name` and none on the other."""
    from waveformer_tpu_torch.ops import dwconv_cuda as dc

    return {f"{k}_{d}": calls if d == name else 0 for k in ("dgrad", "wgrad")
            for d in dc.DESIGNS}


def check_train_step_vs_cpu(create_waveformer, ac, dc):
    """Phase 10a: one fp32 train step (DiceCE, clip at 12, AdamW) of the 32³
    example network at batch 2, drop path 0: the card (kernels) against the
    CPU (plain versions) from the same seeded weights and batch."""
    from waveformer_tpu_torch.training.losses import dice_ce_loss
    from waveformer_tpu_torch.training.state import (
        TrainState, make_optimizer, make_train_step, master_params)

    cfg = EXTRA_CONFIGS["example_32"]
    rng = np.random.default_rng(SEED)
    data = torch.from_numpy(rng.standard_normal((2, *cfg["img_size"], cfg["in_chans"]))
                            .astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, 4, (2, *cfg["img_size"], 1)).astype(np.int32))
    out = {}
    zero_counts(ac, dc)
    for dev in ("cpu", "cuda"):
        model = create_waveformer(cfg, device=dev, seed=SEED).train()
        init = {k: v.detach().clone() for k, v in master_params(model).items()}
        state = TrainState.create(master_params(model), make_optimizer(lr=1e-4))
        step = make_train_step(model, dice_ce_loss)
        state, metrics = step(state, {"data": data.to(dev), "seg": seg.to(dev)})
        out[dev] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                    {k: v.detach().cpu() for k, v in state.params.items()}, init)
    (l_cpu, n_cpu, p_cpu, init), (l_gpu, n_gpu, p_gpu, _) = out["cpu"], out["cuda"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    norm_rel = abs(n_gpu - n_cpu) / n_cpu
    master_err = max(float((p_gpu[k] - p_cpu[k]).abs().max()) for k in p_cpu)
    moved = max(float((p_cpu[k] - init[k].cpu()).abs().max()) for k in p_cpu)
    designs = {"window_attention": dict(ac.design_launches), "dwconv3": dict(dc.design_launches)}
    backward = dict(dc.backward_design_launches)
    ok = (loss_rel <= TRAIN_STEP_TOL["loss_rel"] and norm_rel <= TRAIN_STEP_TOL["grad_norm_rel"]
          and master_err <= TRAIN_STEP_TOL["master_abs"] and ac.launches > 0
          and dc.launches > 0 and np.isfinite(l_gpu) and np.isfinite(n_gpu)
          and backward == stencil_backward("vector", dc.launches))
    row = {"check": "train_step_card_vs_cpu_fp32", "config": "example_32", "batch": 2,
           "loss": [l_cpu, l_gpu], "loss_rel_err": loss_rel,
           "grad_norm": [n_cpu, n_gpu], "grad_norm_rel_err": norm_rel,
           "master_max_abs_err": master_err, "master_max_abs_update": moved,
           "tolerances": TRAIN_STEP_TOL, "launches_by_design": designs,
           "stencil_backward_launches": backward, "ok": bool(ok)}
    log(json.dumps(row))
    return ok, designs


def run_flagship_training(ac, dc):
    """Phase 10b: the flagship at full width and depth, 128³, batch 2, bf16,
    built by `scripts.train.build_model`, trained 5 steps on one resident
    batch (drop path 0.1 on, masks from the trainer's kind of generator):
    the loss after the 5 updates below the first, exactly 14 `tma_wgmma`
    attention and 10 `tma_ring` stencil launches a forward, device ms a
    step by CUDA events, peak memory."""
    from waveformer_tpu_torch.config import Config
    from waveformer_tpu_torch.scripts import train
    from waveformer_tpu_torch.tools.synthetic_cases import tumour_labels
    from waveformer_tpu_torch.training.losses import dice_ce_loss
    from waveformer_tpu_torch.training.state import (
        TrainState, make_optimizer, make_train_step, master_params)
    from waveformer_tpu_torch.training.trainer import step_seed

    torch.manual_seed(SEED)
    model = train.build_model(Config(), torch.device("cuda")).train()
    n_params = sum(p.numel() for p in model.parameters())
    # fp32 masters from the fp32 weights, then the module in bf16
    state = TrainState.create(master_params(model, torch.bfloat16), make_optimizer(lr=1e-4))
    step = make_train_step(model, dice_ce_loss)
    seg = torch.from_numpy(tumour_labels((128,) * 3, 40).astype(np.int32))
    seg = seg[None, ..., None].expand(2, -1, -1, -1, -1).contiguous().cuda()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    data = torch.randn(2, 128, 128, 128, 4, device="cuda", generator=g) + (seg > 0)
    batch = {"data": data, "seg": seg}
    gen = torch.Generator(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(ac, dc)
    losses, norms = [], []

    def one():
        gen.manual_seed(step_seed(SEED, state.step))
        _, m = step(state, batch, gen)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])

    t0 = time.time()
    one()  # the first step: cuDNN's algorithm choice, the AdamW state
    torch.cuda.synchronize()
    first_s = time.time() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * 50)
    start.record()
    for _ in range(TRAIN_RESIDENT_STEPS):
        one()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / TRAIN_RESIDENT_STEPS
    losses = [float(x) for x in losses]
    forwards = TRAIN_RESIDENT_STEPS + 1
    counts = {"window_attention": ac.launches, "dwconv3": dc.launches}
    designs = {"window_attention": dict(ac.design_launches), "dwconv3": dict(dc.design_launches)}
    backward = dict(dc.backward_design_launches)
    ok = (all(np.isfinite(losses)) and losses[-1] < losses[0]
          and counts == {"window_attention": 14 * forwards, "dwconv3": 10 * forwards}
          and designs == {"window_attention": {"fma": 0, "tma_wgmma": 14 * forwards},
                          "dwconv3": {"vector": 0, "tma_ring": 10 * forwards}}
          and backward == stencil_backward("tma_ring", 10 * forwards))
    row = {"check": "flagship_training_resident", "params": n_params, "batch": 2,
           "patch": [128, 128, 128], "dtype": "bfloat16", "steps": forwards,
           "losses": losses, "grad_norms": [float(x) for x in norms],
           "first_step_s": first_s, "device_ms_per_step": ms,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": counts, "launches_by_design": designs,
           "stencil_backward_launches": backward,
           "launches_per_forward": {k: v / forwards for k, v in counts.items()}, "ok": bool(ok)}
    log(json.dumps(row))
    del model, state, step, batch, data, seg
    torch.cuda.empty_cache()
    return ok, counts


def run_training_script(ac, dc, extra_args=()):
    """Phase 10c: `scripts.train.main` on a temporary tree of 4 synthetic
    preprocessed (4, 150, 180, 145) cases and a YAML config: finite losses,
    best and final params `.npz` written, the final one (and the best one
    where it is of the last epoch) loaded through `state_dict_from_jax`
    into a fresh model with eval logits `torch.equal` to the trainer's.
    With `extra_args=["--multihost"]` (phase 13c) the step's gradient
    all-reduces are timed by CUDA events too."""
    from waveformer_tpu_torch import runtime
    from waveformer_tpu_torch.config import load_config
    from waveformer_tpu_torch.scripts import train
    from waveformer_tpu_torch.tools import synthetic_cases
    from waveformer_tpu_torch.training.checkpoint import load_params_npz
    from waveformer_tpu_torch.utils.jax_params import state_dict_from_jax

    ok = True
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        synthetic_cases.write_training_cases(os.path.join(root, "fullres"), n=4,
                                             shape=CASE_SHAPE[1:], seed=SEED)
        config = os.path.join(root, "config.yaml")
        with open(config, "w") as f:
            f.write(training_config_text(root))
        setup_s = time.time() - t0
        zero_counts(ac, dc)
        t0 = time.time()
        trainer = train.main(["--config", config, *extra_args])
        script_s = time.time() - t0
        counts = {"window_attention": ac.launches, "dwconv3": dc.launches}
        designs = {"window_attention": dict(ac.design_launches),
                   "dwconv3": dict(dc.design_launches)}
        # 2 epochs of steps, and one validation batch an epoch
        forwards = 2 * TRAIN_STEPS_PER_EPOCH + 2
        ok &= counts == {"window_attention": 14 * forwards, "dwconv3": 10 * forwards}
        ok &= designs == {"window_attention": {"fma": 0, "tma_wgmma": 14 * forwards},
                          "dwconv3": {"vector": 0, "tma_ring": 10 * forwards}}
        # a backward each training step, none at validation
        backward = dict(dc.backward_design_launches)
        ok &= backward == stencil_backward("tma_ring", 10 * 2 * TRAIN_STEPS_PER_EPOCH)
        with open(os.path.join(root, "logs", "metrics.jsonl")) as f:
            scalars = [json.loads(line) for line in f]
        losses = [r["value"] for r in scalars if r["tag"] == "training_loss"]
        ok &= len(losses) == 2 * TRAIN_STEPS_PER_EPOCH and bool(np.isfinite(losses).all())
        model_dir = os.path.join(root, "logs", "model")
        best = sorted(f for f in os.listdir(model_dir) if f.startswith("best_model_")
                      and f.endswith(".npz"))
        final = sorted(f for f in os.listdir(model_dir) if f.startswith("final_model_")
                       and f.endswith(".npz"))
        ok &= len(best) == 1 and len(final) == 1

        cfg = load_config(config)
        t = cfg.network.transformer
        x = torch.randn(2, 128, 128, 128, 4, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(SEED))
        with torch.no_grad():
            want = trainer.model.eval()(x)
        equal = {}
        for name in best + final:
            with open(os.path.join(model_dir, name + ".json")) as f:
                epoch = json.load(f)["epoch"]
            if epoch != trainer.epoch:  # an earlier epoch's weights: loads, finite logits
                continue
            fresh = train.build_model(cfg, torch.device("cuda"))
            fresh.load_state_dict(state_dict_from_jax(
                load_params_npz(os.path.join(model_dir, name)), t.depths, t.hf_refinement),
                strict=True)
            fresh.set_compute_dtype(trainer.model.compute_dtype)
            with torch.no_grad():
                equal[name] = bool(torch.equal(fresh(x), want))
            del fresh
        ok &= len(equal) >= 1 and all(equal.values())
        (n0, s0, w0), (n1, s1, w1) = trainer.epoch_times
        reducer = trainer._train_step.reducer
        row = {"check": "training_script", "args": list(extra_args), "cases": 4, "case_shape": list(CASE_SHAPE),
               "setup_s": setup_s, "script_s": script_s, "epochs": 2,
               "steps_per_epoch": TRAIN_STEPS_PER_EPOCH, "workers": 2,
               "first_epoch_steps_per_s": n0 / s0, "warm_steps_per_s": n1 / s1,
               "warm_loader_wait_share": w1 / s1, "first_epoch_loader_wait_share": w0 / s0,
               "losses": losses, "best_mean_dice": trainer.best_mean_dice,
               "checkpoints": best + final, "logits_equal": equal,
               "launches": counts, "launches_by_design": designs,
               "stencil_backward_launches": backward,
               "runtime_available": runtime.available(), "ok": bool(ok)}
        if reducer is not None:
            ms = reducer.device_ms()
            row.update(mesh=trainer.mesh.shape, backend=torch.distributed.get_backend(),
                       grad_allreduce_ms=ms, grad_allreduce_ms_median=float(np.median(ms)),
                       grad_allreduce_bytes=4 * (1 + sum(p.numel() for p in
                                                         trainer.state.params.values())))
        del trainer
    log(json.dumps(row))
    torch.cuda.empty_cache()
    return ok, counts


def same(a, b):
    """Equal type, structure and content (arrays by dtype and value)."""
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(same, a, b))
    return type(a) is type(b) and a == b


def forwards_per_case(inferer, spatial):
    """Forwards the inferer runs on one (C, *spatial) case: its patch grid
    on the bucketed shape in chunks of `sw_batch_size`, once per mirror
    orientation."""
    from waveformer_tpu_torch.inference.sliding_window import dense_patch_starts

    n = len(dense_patch_starts(inferer.padded_shape(spatial), inferer.roi_size,
                               inferer.overlap))
    return -(-n // inferer.sw_batch_size) * 2 ** len(inferer.mirror_axes or ())


def kernel_launches(ac, dc, forwards):
    """The launches of this run against 14 `tma_wgmma` attention and 10
    `tma_ring` stencil launches per flagship forward, none on the fallback
    designs."""
    counts = {"window_attention": ac.launches, "dwconv3": dc.launches}
    designs = {"window_attention": dict(ac.design_launches),
               "dwconv3": dict(dc.design_launches)}
    ok = (counts == {"window_attention": 14 * forwards, "dwconv3": 10 * forwards}
          and designs == {"window_attention": {"fma": 0, "tma_wgmma": 14 * forwards},
                          "dwconv3": {"vector": 0, "tma_ring": 10 * forwards}})
    return ok, counts, designs


def run_front_end(ac, dc):
    """Phase 11: rename → convert_split → preprocess (2 workers) → predict
    → deploy → compute_metrics from raw BraTS-named (240, 240, 155) cases,
    each step through its script's `main`."""
    from waveformer_tpu_torch.config import load_config
    from waveformer_tpu_torch.data.planning import Plans
    from waveformer_tpu_torch.data.preprocessing import (
        MultiModalityPreprocessor, create_nonzero_mask, crop_to_bbox)
    from waveformer_tpu_torch.deploy import process
    from waveformer_tpu_torch.inference import SlidingWindowInferer
    from waveformer_tpu_torch.scripts import (
        compute_metrics, convert_split, predict, preprocess, rename_data)
    from waveformer_tpu_torch.tools import synthetic_cases
    from waveformer_tpu_torch.utils import nifti

    checks, n = {}, FRONT_END_CASES
    with tempfile.TemporaryDirectory() as root:
        raw, fullres = os.path.join(root, "raw"), os.path.join(root, "fullres")
        t0 = time.time()
        names = synthetic_cases.write_raw_cases(raw, np.random.default_rng(SEED),
                                                SERVING_RAW_SHAPE, SERVING_AFFINE, n,
                                                margin=FRONT_END_MARGIN)
        config = os.path.join(root, "config.yaml")
        with open(config, "w") as f:
            f.write(serving_config_text(root))
        cfg = load_config(config)
        ckpt = os.path.join(root, "logs", "model", "best_model_0.0000_chip_smoke.npz")
        synthetic_cases.write_checkpoint(ckpt, cfg.network.model_kwargs(), seed=SEED)
        setup_s = time.time() - t0

        # 2: the BraTS names stripped, the test list pickled
        named = sum(f.startswith(c + "-") for c in names for f in os.listdir(os.path.join(raw, c)))
        rename_data.main([raw])
        files = sorted(f"{m}.nii.gz" for m in (*synthetic_cases.BRATS_MODALITIES, "seg"))
        checks["renamed_15"] = named == 15 and all(
            sorted(os.listdir(os.path.join(raw, c))) == files for c in names)
        txt = os.path.join(root, "test_cases.txt")
        with open(txt, "w") as f:
            f.write("\n".join(names) + "\n")
        os.makedirs(os.path.join(root, "data_list"))
        convert_split.main([txt, os.path.join(root, "data_list", "test_list.pkl")])
        with open(os.path.join(root, "data_list", "test_list.pkl"), "rb") as f:
            checks["test_list"] = pickle.load(f) == names

        # 3: plan + preprocess in a 2-worker spawn pool
        t0 = time.time()
        done = preprocess.main(["--config", config, "--dataset-type", "mri",
                                "--num-processes", str(FRONT_END_WORKERS)])
        preprocess_s = time.time() - t0
        plans = Plans.load(os.path.join(fullres, "plans.json"))
        checks["plans"] = done == names and plans.normalization == "zscore"
        spatial, stored, moments = {}, {}, []
        for name in names:
            with np.load(os.path.join(fullres, name + ".npz")) as z:
                stored[name] = (z["data"], z["seg"])
            with open(os.path.join(fullres, name + ".pkl"), "rb") as f:
                props = pickle.load(f)
            data = stored[name][0].reshape(4, -1).astype(np.float64)
            moments.append(max(float(np.abs(data.mean(1)).max()),
                               float(np.abs(data.std(1) - 1).max())))
            spatial[name] = stored[name][0].shape[1:]
            locs = props["class_locations"]
            checks.setdefault("class_locations_1_2_3", True)
            checks["class_locations_1_2_3"] &= (sorted(locs) == [1, 2, 3]
                                                and all(len(v) for v in locs.values()))
        checks["zscore_1e-5"] = max(moments) <= 1e-5
        pp = MultiModalityPreprocessor(base_dir=root, image_dir="raw")
        data, seg, props = pp.read_data(names[0])
        mask = create_nonzero_mask(data)  # before run_case_npy normalises in place
        data, seg, props = pp.run_case_npy(data, seg, props)
        mask = crop_to_bbox(mask, props["bbox_used_for_cropping"])
        checks["seg_-1_outside_mask"] = (bool((seg[0][~mask] == -1).all())
                                         and bool((seg[0][mask] >= 0).all())
                                         and spatial[names[0]] != props["shape_before_cropping"])
        with open(os.path.join(fullres, names[0] + ".pkl"), "rb") as f:
            checks["worker_equals_in_process"] = (
                np.array_equal(data, stored[names[0]][0])
                and np.array_equal(seg, stored[names[0]][1]) and same(props, pickle.load(f)))
        del data, seg, stored

        inferer = SlidingWindowInferer(cfg.prediction.patch_size, cfg.prediction.sw_batch_size,
                                       cfg.prediction.overlap, mirror_axes=(0, 1, 2),
                                       tta_mode="patch", layout="channels_first")
        forwards = sum(forwards_per_case(inferer, spatial[c]) for c in names)

        # 4: scripts.predict on the artifacts
        zero_counts(ac, dc)
        t0 = time.time()
        summary = predict.main(["--config", config, "--tta", "8"])
        predict_s = time.time() - t0
        ok, predict_counts, predict_designs = kernel_launches(ac, dc, forwards)
        checks["predict_launches"] = ok and summary["cases"] == n

        # 5: the deploy wrapper on the renamed raw tree
        out = os.path.join(root, "deploy")
        zero_counts(ac, dc)
        t0 = time.time()
        algo = process.main(["--checkpoint", ckpt, "--config", config, "--input-dir", raw,
                             "--output-dir", out])
        deploy_s = time.time() - t0
        ok, deploy_counts, deploy_designs = kernel_launches(ac, dc, forwards)
        checks["deploy_launches"] = ok and len(algo.case_times) == n
        equal = []
        for name in names:
            got = nifti.load(os.path.join(out, name + ".nii.gz"))
            want = nifti.load(os.path.join(root, "predictions", name + ".nii.gz"))
            equal.append(got.data.shape == SERVING_RAW_SHAPE
                         and np.array_equal(got.affine, SERVING_AFFINE)
                         and np.array_equal(got.data, want.data)
                         and np.array_equal(got.affine, want.affine))
        checks["deploy_equals_predict"] = all(equal)
        del algo.model, algo.predictor
        torch.cuda.empty_cache()

        # 6: metrics of the deploy outputs against the raw seg
        t0 = time.time()
        results = compute_metrics.main(["--config", config, "--pred-dir", out,
                                        "--out", os.path.join(root, "result_metrics.npy")])
        metrics_s = time.time() - t0
        checks["metrics"] = results.shape == (n, 3, 2) and bool(np.isfinite(results).all())

    ok = all(checks.values())
    log(json.dumps({"check": "front_end", "cases": n, "raw_shape": list(SERVING_RAW_SHAPE),
                    "preprocessed_shapes": [list(spatial[c]) for c in names],
                    "forwards": forwards, "zscore_max_abs_err": max(moments),
                    "predict_launches": predict_counts, "predict_designs": predict_designs,
                    "deploy_launches": deploy_counts, "deploy_designs": deploy_designs,
                    "deploy_equal_predict": equal, "metrics": results.tolist(),
                    "checks": checks, "ok": ok}))
    case_times = {k: [t[k] for t in algo.case_times]
                  for k in ("read_s", "preprocess_s", "predict_s", "write_s")}
    log(json.dumps({"check": "front_end_times", "setup_s": setup_s,
                    "preprocess_script_s": preprocess_s,
                    "preprocess_host_s_per_case": preprocess_s / n,
                    "workers": FRONT_END_WORKERS, "predict_script_s_per_case": predict_s / n,
                    "deploy_s": deploy_s,
                    "deploy_s_per_case": [sum(t[k] for k in case_times) for t in algo.case_times],
                    "deploy_host_s_per_case": [t["read_s"] + t["preprocess_s"]
                                               for t in algo.case_times],
                    **{f"deploy_{k}": v for k, v in case_times.items()},
                    "metrics_s_per_case": metrics_s / n}))
    return ok, {k: predict_counts[k] + deploy_counts[k] for k in predict_counts}


# --------------------------------------------------------------------------- #
# phase 12: SSL pretraining
# --------------------------------------------------------------------------- #


def kernel_counts():
    """Every port kernel's launches so far, by kernel (and by the conv's and
    the matmul's entry points)."""
    from waveformer_tpu_torch.ops import (attention_cuda, conv_cuda, dwconv_cuda,
                                          ffn_tail_cuda, fused_conv_cuda,
                                          tiled_matmul_cuda)

    return {"window_attention": attention_cuda.launches, "dwconv3": dwconv_cuda.launches,
            **conv_cuda.launches, "conv3x3x3_fused": fused_conv_cuda.launches,
            "ffn_tail": ffn_tail_cuda.launches,
            "ln_gelu_dense": ffn_tail_cuda.ln_gelu_dense_launches,
            **tiled_matmul_cuda.launches}


def zero_kernel_counts():
    from waveformer_tpu_torch.ops import (attention_cuda, conv_cuda, dwconv_cuda,
                                          ffn_tail_cuda, fused_conv_cuda,
                                          tiled_matmul_cuda)

    zero_counts(attention_cuda, dwconv_cuda, ffn_tail_cuda)
    ffn_tail_cuda.ln_gelu_dense_launches = 0
    fused_conv_cuda.launches = 0
    for counts in (conv_cuda.launches, conv_cuda.design_launches, tiled_matmul_cuda.launches):
        for k in counts:
            counts[k] = 0


def ssl_views(batch, seed=SEED):
    """The trainer's two context-restoration views of a channels-last host
    batch, channels-last."""
    from waveformer_tpu_torch.training.ssl import make_two_views

    v1, v2 = make_two_views(batch.transpose(0, 4, 1, 2, 3), np.random.RandomState(seed))
    return [np.ascontiguousarray(v.transpose(0, 2, 3, 4, 1)) for v in (v1, v2)]


def smooth_volumes(shape, seed=SEED):
    """(B, D, H, W, C) fp32 host volumes of low-frequency structure (a 6³
    random grid resized trilinearly), which a decoder can learn to
    reconstruct in a few steps."""
    b, *spatial, c = shape
    g = torch.Generator().manual_seed(seed)
    coarse = torch.randn(b, c, 6, 6, 6, generator=g)
    vol = F.interpolate(coarse, size=tuple(spatial), mode="trilinear", align_corners=False)
    return vol.permute(0, 2, 3, 4, 1).contiguous().numpy()


def check_ssl_step_vs_cpu(device="cuda"):
    """Phase 12a: one fp32 SSL step (two views, NT-Xent × L1 + L1, AdamW
    without clipping on fp32 masters) of a 32³ SSLViT at batch 2, the card
    against the CPU from the same carried weights and views."""
    from waveformer_tpu_torch.models.ssl import create_ssl_vit
    from waveformer_tpu_torch.training.ssl import make_ssl_step
    from waveformer_tpu_torch.training.state import TrainState, make_optimizer, master_params

    cfg = SSL_STEP_CONFIG
    # phase 10a's kind of batch (standard normal). On smooth volumes some
    # patch-embedding gradients are near 0, where AdamW's first step
    # g / (|g| + eps) turns fp32 rounding into up to ±lr: two CPU runs of
    # that step, 1 and 4 threads, differ by 6.2e-5 there
    gt = np.random.default_rng(SEED).standard_normal(
        (2, *cfg["img_size"], cfg["in_channels"])).astype(np.float32)
    v1, v2 = ssl_views(gt)
    weights = create_ssl_vit(device="cpu", seed=SEED, **cfg).state_dict()
    out = {}
    for dev in ("cpu", device):
        model = create_ssl_vit(device=dev, **cfg).train()
        model.load_state_dict(weights, strict=True)
        state = TrainState.create(master_params(model), make_optimizer(
            lr=1e-4, weight_decay=1e-5, grad_clip_norm=None))
        _, m = make_ssl_step(model)(state, *(torch.from_numpy(a).to(dev) for a in (v1, v2, gt)))
        out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                    {k: v.detach().cpu() for k, v in state.params.items()})
    (l_cpu, n_cpu, p_cpu), (l_dev, n_dev, p_dev) = out["cpu"], out[device]
    loss_rel = abs(l_dev - l_cpu) / abs(l_cpu)
    norm_rel = abs(n_dev - n_cpu) / n_cpu
    master_err = max(float((p_dev[k] - p_cpu[k]).abs().max()) for k in p_cpu)
    moved = max(float((p_cpu[k] - weights[k]).abs().max()) for k in p_cpu)
    ok = (loss_rel <= TRAIN_STEP_TOL["loss_rel"] and norm_rel <= TRAIN_STEP_TOL["grad_norm_rel"]
          and master_err <= TRAIN_STEP_TOL["master_abs"] and moved > 0
          and np.isfinite(l_dev) and np.isfinite(n_dev))
    log(json.dumps({"check": "ssl_step_card_vs_cpu_fp32", "config": cfg, "batch": 2,
                    "loss": [l_cpu, l_dev], "loss_rel_err": loss_rel,
                    "grad_norm": [n_cpu, n_dev], "grad_norm_rel_err": norm_rel,
                    "master_max_abs_err": master_err, "master_max_abs_update": moved,
                    "tolerances": TRAIN_STEP_TOL, "ok": bool(ok)}))
    return ok


def run_ssl_resident(device="cuda"):
    """Phase 12b: the script's default SSLViT (ViT-B: 96³, patch 16, hidden
    768, 12 layers, 12 heads; the vae decoder) in bf16 on fp32 masters, on
    one resident batch of 2 and one resident pair of views: 2 warm-up steps,
    then device ms a step by CUDA events over 5, and peak memory. Gates:
    every loss finite, the 5th step's below the 1st."""
    from waveformer_tpu_torch.models.ssl import create_ssl_vit
    from waveformer_tpu_torch.training.ssl import SSLTrainer, make_ssl_step

    cfg = SSL_FULL_CONFIG
    steps = SSL_WARMUP_STEPS + SSL_RESIDENT_STEPS
    gt = smooth_volumes((2, *cfg["img_size"], cfg["in_channels"]))
    v1, v2 = (torch.from_numpy(a).to(device) for a in ssl_views(gt))
    gt = torch.from_numpy(gt).to(device)
    model = create_ssl_vit(device=device, seed=SEED, **cfg).train()
    with tempfile.TemporaryDirectory() as root:
        trainer = SSLTrainer(model, num_steps=steps, lr=4e-4, warmup_steps=1, logdir=root,
                             seed=SEED, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = trainer._init_state()
    n_params = sum(p.numel() for p in state.params.values())
    step = make_ssl_step(model)
    losses = []

    def one():
        _, m = step(state, v1, v2, gt)
        losses.append(m["loss"])

    t0 = time.time()
    for _ in range(SSL_WARMUP_STEPS):
        one()
    torch.cuda.synchronize()
    warmup_s = time.time() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * 50)
    start.record()
    for _ in range(SSL_RESIDENT_STEPS):
        one()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / SSL_RESIDENT_STEPS
    losses = [float(x) for x in losses]
    ok = bool(np.isfinite(losses).all()) and losses[4] < losses[0]
    row = {"check": "ssl_resident", "config": {k: list(v) if isinstance(v, tuple) else v
                                                for k, v in cfg.items()},
           "params": n_params, "batch": 2, "dtype": "bfloat16", "steps": steps,
           "losses": losses, "warmup_s": warmup_s, "device_ms_per_step": ms,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "ok": ok}
    log(json.dumps(row))
    del model, state, step, v1, v2, gt
    torch.cuda.empty_cache()
    return ok


def write_ct_volumes(root, n, shape=SSL_CT_SHAPE, seed=SEED):
    """`n` CT-like int16 volumes (HU: air at -1000 around a body ellipsoid
    of soft tissue with noise) as `.nii.gz` under `root`, and a decathlon
    JSON listing them for training only. Returns the JSON's path."""
    from waveformer_tpu_torch.utils import nifti

    rng = np.random.default_rng(seed)
    axes = np.meshgrid(*(np.linspace(-1.0, 1.0, s, dtype=np.float32) for s in shape),
                       indexing="ij", sparse=True)
    body = sum((a / r) ** 2 for a, r in zip(axes, (0.8, 0.7, 0.9))) <= 1.0
    os.makedirs(os.path.join(root, "ct"), exist_ok=True)
    for i in range(n):
        hu = 40.0 + 50.0 * rng.standard_normal(shape, dtype=np.float32)
        vol = np.where(body, hu, -1000.0).astype(np.int16)
        nifti.save(nifti.NiftiImage(data=vol), os.path.join(root, "ct", f"ct_{i}.nii.gz"))
    path = os.path.join(root, "dataset.json")
    with open(path, "w") as f:
        json.dump({"training": [f"ct/ct_{i}.nii.gz" for i in range(n)]}, f)
    return path


def run_ssl_script(device="cuda", extra=()):
    """Phase 12c: `scripts.pretrain_ssl.main` at its default (ViT-B) widths
    in a temporary directory, in both data modes: `--data-dir` over 4
    synthetic preprocessed (4, 150, 180, 145) cases with 2 loader workers,
    12 steps, validation every 6; `--datalist-json` over 3 CT-like volumes,
    cached, 4 steps, validation every 2. Gates: finite losses, best and
    final `.npz` written, the final one loaded through
    `ssl_state_dict_from_jax` into a fresh SSLViT with outputs
    `torch.equal` to the trainer's module's in fp32."""
    from waveformer_tpu_torch.models.ssl import create_ssl_vit
    from waveformer_tpu_torch.scripts import pretrain_ssl
    from waveformer_tpu_torch.tools import synthetic_cases
    from waveformer_tpu_torch.training.checkpoint import load_params_npz
    from waveformer_tpu_torch.utils.jax_params import ssl_state_dict_from_jax

    ok = True
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        synthetic_cases.write_training_cases(os.path.join(root, "fullres"), n=4,
                                             shape=CASE_SHAPE[1:], seed=SEED)
        datalist = write_ct_volumes(root, SSL_CT_VOLUMES)
        setup_s = time.time() - t0
        modes = {
            "data_dir": ["--data-dir", os.path.join(root, "fullres"), "--num-workers", "2",
                         "--batch-size", "2", "--num-steps", str(SSL_SCRIPT_STEPS),
                         "--eval-every", str(SSL_SCRIPT_STEPS // 2), "--warmup-steps", "2"],
            "datalist": ["--datalist-json", datalist, "--cache-rate", "1",
                         "--num-steps", "4", "--eval-every", "2"],
        }
        for mode, args in modes.items():
            logdir = os.path.join(root, f"logs_{mode}")
            t0 = time.time()
            trainer = pretrain_ssl.main(args + ["--logdir", logdir, "--seed", str(SEED),
                                                "--device", device, *extra])
            script_s = time.time() - t0
            with open(os.path.join(logdir, "metrics.jsonl")) as f:
                scalars = [json.loads(line) for line in f]
            losses = [r["value"] for r in scalars if r["tag"] == "loss"]
            vals = [r["value"] for r in scalars if r["tag"] == "val_recon_l1"]
            model_dir = os.path.join(logdir, "model")
            names = sorted(f for f in os.listdir(model_dir) if f.endswith(".npz"))
            good = (len(losses) >= 1 and len(vals) >= 1
                    and bool(np.isfinite(losses + vals).all()) and len(names) == 2
                    and names[0].startswith("best_model_")
                    and names[1] == "final_model_0.0000_ssl_vit.npz")
            # the final checkpoint in a fresh module against the trainer's
            # module on its fp32 masters, in fp32
            model = trainer.model
            fresh = create_ssl_vit(device=device, img_size=model.vit.img_size,
                                   patch_size=model.patch_size, in_channels=model.in_channels,
                                   hidden_size=model.hidden_size,
                                   mlp_dim=model.vit.block0.mlp_fc1.out_features,
                                   num_layers=len(model.vit.blocks), num_heads=model.num_heads,
                                   projection_size=model.proj_contrastive.out_features)
            fresh.load_state_dict(ssl_state_dict_from_jax(
                load_params_npz(os.path.join(model_dir, names[-1]))), strict=True)
            model.set_compute_dtype(torch.float32)
            trainer.state.copy_to(model)
            x = torch.from_numpy(smooth_volumes((2, *model.vit.img_size, model.in_channels)))
            with torch.no_grad():
                want, got = model(x.to(device)), fresh(x.to(device))
            equal = all(torch.equal(a, b) for a, b in zip(got, want))
            good &= equal
            # warm: every step after the first (cuDNN's choices, the first batch)
            warm = trainer.step_times[1:]
            total = sum(t for t, _ in warm)
            # the steps that end in a validation (and a best checkpoint)
            every = trainer.eval_every
            val_s = [t for i, (t, _) in enumerate(trainer.step_times) if (i + 1) % every == 0]
            other_s = [t for i, (t, _) in enumerate(warm, 1) if (i + 1) % every]
            log(json.dumps({
                "check": "ssl_script", "mode": mode, "setup_s": setup_s, "script_s": script_s,
                "steps": len(trainer.step_times), "first_step_s": trainer.step_times[0][0],
                "warm_steps_per_s": len(warm) / total,
                "warm_loader_wait_share": sum(w for _, w in warm) / total,
                "validation_step_s": val_s, "median_other_warm_step_s": float(np.median(other_s)),
                "losses": losses, "val_recon_l1": vals, "best_val": trainer.best_val,
                "checkpoints": names, "outputs_equal": equal, "ok": bool(good)}))
            ok &= good
            del trainer, model, fresh
            torch.cuda.empty_cache()
    return ok


def run_ssl():
    """Phase 12: 12a, 12b and 12c with every port kernel's launches counted
    over them: none of the TPU kernels lies on the SSL path (its attention
    is flax's plain multi-head attention, its convs `lax`'s), so every
    count must stay 0. Returns the names of the sub-phases that failed."""
    failed = []
    zero_kernel_counts()
    for name, fn in (("ssl_step_card_vs_cpu", check_ssl_step_vs_cpu),
                     ("ssl_resident", run_ssl_resident), ("ssl_script", run_ssl_script)):
        if not fn():
            failed.append(name)
    counts = kernel_counts()
    ok = not any(counts.values())
    log(json.dumps({"check": "ssl_kernel_launches", "launches": counts, "ok": ok}))
    if not ok:
        failed.append("ssl_kernel_launches")
    return failed


# --------------------------------------------------------------------------- #
# phase 13: data parallelism over torch.distributed
# --------------------------------------------------------------------------- #


def spawn_ranks(kind, world, workdir, env=None):
    """`world` child processes of this script (`--child kind rank world
    workdir`), all on card 0; returns each one's result dict. Each child
    has CHILD_TIMEOUT_S and its exit code is checked: a rank that fails or
    hangs fails the phase."""
    procs = []
    for r in range(world):
        child_env = dict(os.environ, **(env or {}), RANK=str(r), WORLD_SIZE=str(world),
                         LOCAL_RANK="0")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", kind, str(r), str(world),
             workdir], env=child_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, ok = [], True
    for p in procs:
        try:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0] + f"\n[killed after {CHILD_TIMEOUT_S} s]")
    results = []
    for r, (p, text) in enumerate(zip(procs, logs)):
        for line in text.splitlines():  # the child's result rows
            if line.startswith('{"check"'):
                log(line)
        path = os.path.join(workdir, f"{kind}_rank{r}.pt")
        if p.returncode != 0 or not os.path.exists(path):
            ok = False
            log(f"chip_smoke: {kind} rank {r} exited {p.returncode}:\n{text[-3000:]}")
            results.append(None)
        else:
            results.append(torch.load(path, weights_only=False))
    return ok, results


def child_join(kind, workdir, backend):
    """A child joins its group over `file://` in `workdir`, on card 0."""
    from datetime import timedelta

    from waveformer_tpu_torch.parallel.mesh import init_distributed

    return init_distributed("cuda", backend=backend,
                            init_method=f"file://{os.path.join(workdir, kind + '_rdzv')}",
                            timeout=timedelta(seconds=GROUP_TIMEOUT_S))


def counter_snapshot():
    from waveformer_tpu_torch.ops import attention_cuda as ac
    from waveformer_tpu_torch.ops import dwconv_cuda as dc

    return {"window_attention": ac.launches, "dwconv3": dc.launches,
            "designs": {"window_attention": dict(ac.design_launches),
                        "dwconv3": dict(dc.design_launches)},
            "dwconv3_backward": dict(dc.backward_design_launches)}


def parallel_batch():
    """13a's global batch: phase 10a's kind (standard normal data, labels
    0-3) at batch 2."""
    rng = np.random.default_rng(SEED)
    shape = PARALLEL_NET["img_size"]
    data = rng.standard_normal((2, *shape, PARALLEL_NET["in_chans"])).astype(np.float32)
    seg = rng.integers(0, 4, (2, *shape, 1)).astype(np.int32)
    return data, seg


def parallel_steps(mesh=None):
    """PARALLEL_STEPS fp32 train steps of PARALLEL_NET on the card from the
    seed-0 weights, drop-path masks from `step_seed(SEED, step)`; with a
    mesh, on this rank's rows. Returns ([(loss, grad norm)], masters on
    the host, the attention and stencil launches of the steps)."""
    from waveformer_tpu_torch.models import create_waveformer
    from waveformer_tpu_torch.parallel.mesh import shard_batch
    from waveformer_tpu_torch.training.losses import dice_ce_loss
    from waveformer_tpu_torch.training.state import (
        TrainState, make_optimizer, make_train_step, master_params)
    from waveformer_tpu_torch.training.trainer import step_seed

    data, seg = parallel_batch()
    if mesh is not None:
        data, seg = shard_batch(mesh, data), shard_batch(mesh, seg)
    model = create_waveformer(PARALLEL_NET, device="cuda", seed=SEED).train()
    state = TrainState.create(master_params(model), make_optimizer(lr=1e-4))
    step = make_train_step(model, dice_ce_loss, mesh)
    batch = {"data": torch.from_numpy(data).cuda(), "seg": torch.from_numpy(seg).cuda()}
    gen = torch.Generator(device="cuda")
    before = counter_snapshot()
    metrics = []
    for i in range(PARALLEL_STEPS):
        gen.manual_seed(step_seed(SEED, i))
        _, m = step(state, batch, gen)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    after = counter_snapshot()
    launches = {k: {d: n - before["designs"][k][d] for d, n in after["designs"][k].items()}
                for k in ("window_attention", "dwconv3")}
    return metrics, {k: v.detach().cpu() for k, v in state.params.items()}, launches


GLOO_PROBE = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
              "reduce_scatter_tensor", "all_to_all_single", "reduce", "gather", "scatter",
              "barrier")


def gloo_cuda_probe(world):
    """Which collectives gloo runs on CUDA tensors in this build: each is
    tried once on both ranks, in the same order; the answer is recorded,
    not gated."""
    x = torch.full((world * 2,), float(dist.get_rank() + 1), device="cuda")
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(world)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(world * x.numel(), device="cuda"), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(2, device="cuda"), x),
        "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x),
        "reduce": lambda: dist.reduce(x.clone(), 0),
        "gather": lambda: dist.gather(x, [torch.empty_like(x) for _ in range(world)]
                                      if dist.get_rank() == 0 else None, 0),
        "scatter": lambda: dist.scatter(torch.empty_like(x), [x.clone() for _ in range(world)]
                                        if dist.get_rank() == 0 else None, 0),
        "barrier": lambda: dist.barrier(),
    }
    out = {}
    for name in GLOO_PROBE:
        try:
            calls[name]()
            torch.cuda.synchronize()
            out[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def child_dp_steps(rank, world, workdir):
    """13a, one rank: the data-parallel steps over gloo with CUDA tensors,
    then the gloo probe."""
    from waveformer_tpu_torch.ops import _build
    from waveformer_tpu_torch.parallel.mesh import make_mesh

    _build.LIBRARIES.build_all()
    child_join("dp", workdir, "gloo")
    try:
        mesh = make_mesh()
        metrics, params, launches = parallel_steps(mesh)
        out = {"rank": mesh.rank, "mesh": mesh.shape, "metrics": metrics, "params": params,
               "launches": launches, "backend": dist.get_backend()}
        out["gloo_cuda"] = gloo_cuda_probe(world)
        torch.save(out, os.path.join(workdir, f"dp_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def child_sharded_predict(rank, world, workdir):
    """13b, one rank: `scripts.predict --sharded on --tta 8` over gloo."""
    from waveformer_tpu_torch.ops import _build
    from waveformer_tpu_torch.scripts import predict

    _build.LIBRARIES.build_all()
    child_join("predict", workdir, "gloo")
    try:
        t0 = time.time()
        summary = predict.main(["--config", os.path.join(workdir, "config.yaml"), "--tta", "8",
                                "--sharded", "on"])
        torch.cuda.synchronize()
        out = {"summary": summary, "wall_s": time.time() - t0, **counter_snapshot()}
        torch.save(out, os.path.join(workdir, f"predict_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ssl_trainer_mesh():
    """13d: `SSLTrainer(mesh=make_mesh())` at the script's ViT-B width, bf16
    on fp32 masters, batch 2, PARALLEL_SSL_STEPS steps on one resident batch
    (the views change each step), in the group this process joined: the
    NT-Xent gather and the gradient all-reduce run under its backend."""
    from waveformer_tpu_torch.models.ssl import create_ssl_vit
    from waveformer_tpu_torch.parallel.mesh import make_mesh
    from waveformer_tpu_torch.training.ssl import SSLTrainer

    cfg = SSL_FULL_CONFIG
    gt = smooth_volumes((2, *cfg["img_size"], cfg["in_channels"]))
    model = create_ssl_vit(device="cuda", seed=SEED, **cfg).train()
    zero_kernel_counts()
    with tempfile.TemporaryDirectory() as root:
        trainer = SSLTrainer(model, num_steps=PARALLEL_SSL_STEPS, lr=4e-4, warmup_steps=1,
                             eval_every=10 * PARALLEL_SSL_STEPS, logdir=root, seed=SEED,
                             mesh=make_mesh(), compute_dtype=torch.bfloat16)
        t0 = time.time()
        trainer.train(iter([gt] * PARALLEL_SSL_STEPS))
        torch.cuda.synchronize()
        seconds = time.time() - t0
    losses = [float(x) for x in trainer.losses]
    counts = kernel_counts()
    ms = trainer.step_fn.reducer.device_ms()
    ok = (len(losses) == PARALLEL_SSL_STEPS and bool(np.isfinite(losses).all())
          and losses[-1] < losses[0] and not any(counts.values()))
    row = {"check": "ssl_trainer_mesh", "mesh": trainer.mesh.shape,
           "backend": dist.get_backend(), "batch": 2, "dtype": "bfloat16",
           "steps": PARALLEL_SSL_STEPS, "losses": losses, "seconds": seconds,
           "step_times": trainer.step_times, "grad_allreduce_ms": ms,
           "kernel_launches": counts, "ok": bool(ok)}
    del trainer, model
    torch.cuda.empty_cache()
    return ok, row


def child_multihost(rank, world, workdir):
    """13c and 13d in one process: `scripts.train --multihost` joins an NCCL
    group of one from the variables torchrun would set (phase 10c's tree and
    config), then `SSLTrainer(mesh=...)` in the same group."""
    from waveformer_tpu_torch.ops import _build
    from waveformer_tpu_torch.ops import attention_cuda as ac
    from waveformer_tpu_torch.ops import dwconv_cuda as dc

    _build.LIBRARIES.build_all()
    try:
        ok_c, counts = run_training_script(ac, dc, ["--multihost"])
        ok_d, row_d = run_ssl_trainer_mesh()
        torch.save({"ok_c": ok_c, "counts": counts, "ok_d": ok_d, "row_d": row_d},
                   os.path.join(workdir, f"multihost_rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# phase 14: model parallelism (the spatial and tensor axes)
# --------------------------------------------------------------------------- #


def child_model_parallel(rank, world, workdir):
    """14, one rank: the flagship's sharded forward on the mesh in
    `workdir/spec.json`, fp32 then bf16. Per dtype a warm-up forward, then
    one timed: its launches per design, the bytes of its collectives, its
    seconds, the fp32 peak memory, and (rank 0) the gathered logits."""
    from waveformer_tpu_torch.config import Config
    from waveformer_tpu_torch.models import create_waveformer
    from waveformer_tpu_torch.ops import _build
    from waveformer_tpu_torch.parallel import (
        MeshSpec, gather_depth, make_mesh, shard_batch, shard_model)

    _build.LIBRARIES.build_all()
    child_join("mp", workdir, "gloo")
    try:
        with open(os.path.join(workdir, "spec.json")) as f:
            spec = tuple(json.load(f))
        mesh = make_mesh(MeshSpec(*spec))
        kw = dict(Config().network.model_kwargs(), io_layout="channels_first")
        x = np.random.default_rng(SEED).standard_normal((1, 4, 128, 128, 128)).astype(np.float32)
        xs = torch.from_numpy(np.ascontiguousarray(shard_batch(mesh, x, depth_axis=2))).cuda()
        out = {"coords": mesh.coords, "launches_total": {"window_attention": 0, "dwconv3": 0}}
        for dtype in (torch.float32, torch.bfloat16):
            model = shard_model(create_waveformer(kw, dtype=dtype, device="cuda", seed=SEED),
                                mesh)
            name = str(dtype).split(".")[-1]
            with torch.no_grad():
                before = counter_snapshot()
                model(xs)  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                traffic0, mid = mesh.traffic.bytes, counter_snapshot()
                t0 = time.time()
                y = model(xs)
                torch.cuda.synchronize()
                seconds = time.time() - t0
                after = counter_snapshot()
                peak = torch.cuda.max_memory_allocated()
                forward_bytes = mesh.traffic.bytes - traffic0
                logits = gather_depth(y, mesh.spatial, axis=2).float().cpu()
            for k in out["launches_total"]:
                out["launches_total"][k] += after[k] - before[k]
            out[name] = {
                "seconds": seconds, "collective_bytes": forward_bytes,
                "peak_bytes": peak, "slab": list(y.shape),
                "per_forward": {k: {d: n - mid["designs"][k][d]
                                    for d, n in after["designs"][k].items()}
                                for k in ("window_attention", "dwconv3")},
                "logits": logits if rank == 0 else None}
            del model, y
            torch.cuda.empty_cache()
        torch.save(out, os.path.join(workdir, f"mp_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_model_parallel():
    """Phase 14: the one-process forward in a child, then (a) tensor=3 and
    (b) spatial=2 at 3 and 2 ranks over gloo on the one card, each rank's
    gathered logits against the one process's. Returns (failed sub-phases,
    the attention and stencil launches of the children)."""
    failed, launches = [], {"window_attention": 0, "dwconv3": 0}
    t_phase = time.time()
    designs = {"float32": {"window_attention": {"fma": 14, "tma_wgmma": 0},
                           "dwconv3": {"vector": 10, "tma_ring": 0}},
               "bfloat16": {"window_attention": {"fma": 0, "tma_wgmma": 14},
                            "dwconv3": {"vector": 0, "tma_ring": 10}}}
    ref = None
    for sub, spec in MODEL_PARALLEL_MESHES.items():
        world = int(np.prod(spec))
        with tempfile.TemporaryDirectory() as root:
            with open(os.path.join(root, "spec.json"), "w") as f:
                json.dump(spec, f)
            t0 = time.time()
            ok, ranks = spawn_ranks("mp", world, root)
            wall = time.time() - t0
        row = {"check": f"model_parallel_{sub}", "mesh": dict(zip(("data", "spatial", "tensor"),
                                                                  spec)),
               "ranks": world, "backend": "gloo", "wall_s": wall}
        if ok:
            for r in ranks:
                for k in launches:
                    launches[k] += r["launches_total"][k]
            if ref is None:
                ref = ranks[0]
            for name in ("float32", "bfloat16"):
                got, want = ranks[0][name]["logits"], ref[name]["logits"]
                rtol, atol = MODEL_PARALLEL_TOL[name]
                err = (got - want).abs()
                use = float((err / (atol + rtol * want.abs())).max())  # of the limit
                close = bool(torch.isfinite(got).all()) and use <= 1.0
                per_forward = [r[name]["per_forward"] for r in ranks]
                row[name] = {"max_abs_err": float(err.max()), "max_abs_logit": float(
                    want.abs().max()), "rtol": rtol, "atol": atol, "worst_share_of_limit": use,
                    "rank_forward_s": [r[name]["seconds"] for r in ranks],
                    "rank_collective_bytes": [r[name]["collective_bytes"] for r in ranks],
                    "rank_slab": [r[name]["slab"] for r in ranks],
                    "launches_per_forward": per_forward[0]}
                ok &= close and all(p == designs[name] for p in per_forward)
            peaks = [r["float32"]["peak_bytes"] for r in ranks]
            row["float32"]["rank_peak_bytes"] = peaks
            row["float32"]["one_process_peak_bytes"] = ref["float32"]["peak_bytes"]
            ratio = max(peaks) / ref["float32"]["peak_bytes"]
            row["float32"]["peak_ratio"] = ratio
            if spec[1] > 1:
                row["peak_ratio_limit"] = MODEL_PARALLEL_PEAK_RATIO
                ok &= ratio <= MODEL_PARALLEL_PEAK_RATIO
        row["ok"] = bool(ok)
        log(json.dumps(row))
        if not ok:
            failed.append(f"model_parallel_{sub}")
            if ref is None:
                break
    log(json.dumps({"check": "model_parallel_phase", "seconds": time.time() - t_phase,
                    "launches": launches, "failed": failed}))
    return failed, launches


# --------------------------------------------------------------------------- #
# phase 15: model-parallel training
# --------------------------------------------------------------------------- #


def flagship_train_batch(side):
    """Phase 15's batch: one channels-last volume of side³, phase 10b's kind
    (unit normal plus the tumour mask) with its concentric labels."""
    from waveformer_tpu_torch.tools.synthetic_cases import tumour_labels

    seg = tumour_labels((side,) * 3, side * 40 // 128).astype(np.int32)[None, ..., None]
    data = np.random.default_rng(SEED).standard_normal((1, side, side, side, 4))
    return (data + (seg > 0)).astype(np.float32), seg


def digest(tensors):
    """A SHA-256 of the tensors' bytes, in order (bit-equality across ranks)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def train_two_steps(mesh, dtype_name, side, workdir, tag):
    """Two steps of the flagship at side³ in `dtype_name` on `mesh` (None:
    one process): step 1's metrics and launches, the fp32 peak over it,
    step 2's seconds, the collectives' bytes, the assembly's device ms, a
    digest of the masters after; step 1's gradients to `workdir` (rank 0)."""
    from waveformer_tpu_torch.config import Config
    from waveformer_tpu_torch.models import create_waveformer
    from waveformer_tpu_torch.parallel import shard_batch, shard_model
    from waveformer_tpu_torch.training.losses import dice_ce_loss
    from waveformer_tpu_torch.training.state import (
        TrainState, make_optimizer, make_train_step, master_params)
    from waveformer_tpu_torch.training.trainer import step_seed

    cfg = dict(Config().network.model_kwargs(), img_size=(side,) * 3)
    model = create_waveformer(cfg, device="cuda", seed=SEED).train()
    state = TrainState.create(master_params(model, getattr(torch, dtype_name)),
                              make_optimizer(lr=1e-4))
    if mesh is not None:
        shard_model(model, mesh)
    step = make_train_step(model, dice_ce_loss, mesh)
    grads = []
    apply = state.apply_gradients
    state.apply_gradients = lambda g: (grads.append([t.detach().cpu() for t in g]), apply(g))[1]
    data, seg = flagship_train_batch(side)
    if mesh is not None:
        data, seg = shard_batch(mesh, data), shard_batch(mesh, seg)
    batch = {"data": torch.from_numpy(np.ascontiguousarray(data)).cuda(),
             "seg": torch.from_numpy(np.ascontiguousarray(seg)).cuda()}
    gen = torch.Generator(device="cuda")
    traffic = (0, 0) if mesh is None else (mesh.traffic.bytes, mesh.traffic.backward_bytes)
    out = {"metrics": []}
    for i in range(2):
        gen.manual_seed(step_seed(SEED, i))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = counter_snapshot()
        t0 = time.time()
        _, m = step(state, batch, gen)
        out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
        seconds = time.time() - t0
        after = counter_snapshot()
        if i == 0:
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
            out["launches"] = {k: {d: n - before["designs"][k][d]
                                   for d, n in after["designs"][k].items()}
                               for k in ("window_attention", "dwconv3")}
            out["backward_launches"] = {d: n - before["dwconv3_backward"][d]
                                        for d, n in after["dwconv3_backward"].items()}
            if mesh is not None:
                out["forward_bytes"] = mesh.traffic.bytes - traffic[0]
                out["backward_bytes"] = mesh.traffic.backward_bytes - traffic[1]
        out["step_s"] = seconds
    reducer = step.reducer
    if reducer is not None:
        out["assembly_ms"] = {line: reducer.device_ms(line) for line in ("spatial", "tensor")}
        out["assembly_bytes"] = dict(reducer.bytes)
    out["masters_digest"] = digest(state.params.values())
    if mesh is None or mesh.is_main:
        torch.save(dict(zip(state.params, grads[0])),
                   os.path.join(workdir, f"grads_{tag}_{dtype_name}_{side}.pt"))
    del model, state, step, batch
    torch.cuda.empty_cache()
    return out


def child_mp_training(rank, world, workdir):
    """15a-b, one rank (or the one process, at world 1 without a group): the
    runs of `workdir/spec.json` on its mesh, then at spatial=2 15c-d
    (`mp_trainers`) on the tree in `workdir`."""
    from waveformer_tpu_torch.ops import _build
    from waveformer_tpu_torch.parallel import MeshSpec, make_mesh

    _build.LIBRARIES.build_all()
    with open(os.path.join(workdir, "spec.json")) as f:
        spec, runs, tag = json.load(f)
    if world > 1:
        child_join("mpt", workdir, "gloo")
    try:
        mesh = make_mesh(MeshSpec(*spec)) if world > 1 else None
        out = {"coords": (0, 0, 0) if mesh is None else mesh.coords}
        for dtype_name, side in runs:
            out[dtype_name, side] = train_two_steps(mesh, dtype_name, side, workdir, tag)
        if os.path.isdir(os.path.join(workdir, "fullres")):
            out["trainers"] = mp_trainers(rank, mesh, workdir)
        torch.save(out, os.path.join(workdir, f"mpt_rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def grad_shares(got, want, rtol, floor):
    """Each parameter's ‖Δg‖ as a share of rtol·‖g‖ + floor·max|g|·√n."""
    scale = max(float(w.abs().max()) for w in want.values())
    return {k: float((got[k].double() - w.double()).norm())
            / (rtol * float(w.double().norm()) + floor * scale * w.numel() ** 0.5)
            for k, w in want.items()}


def mp_trainers(rank, mesh, workdir):
    """15c-d, one rank of spatial=2: `Trainer(mesh=...)` on the tree in
    `workdir`, its checkpoint reloaded by a second trainer, then
    `SSLTrainer(mesh=...)` and the same steps without a mesh."""
    from waveformer_tpu_torch.config import Config
    from waveformer_tpu_torch.data.dataset import MedicalDataset
    from waveformer_tpu_torch.models import create_waveformer
    from waveformer_tpu_torch.models.ssl import create_ssl_vit
    from waveformer_tpu_torch.training.ssl import SSLTrainer
    from waveformer_tpu_torch.training.trainer import Trainer

    fullres = os.path.join(workdir, "fullres")
    names = sorted(f[:-4] for f in os.listdir(fullres) if f.endswith(".npz"))
    train_ds = MedicalDataset(fullres, names[:3], unpack=False)
    val_ds = MedicalDataset(fullres, names[3:], unpack=False)
    kw = dict(batch_size=2, val_every=1, num_steps_per_epoch=MP_TRAINER_STEPS,
              val_patches_per_epoch=2, patch_size=(128, 128, 128),
              logdir=os.path.join(workdir, "logs"), num_workers=0, seed=SEED, mesh=mesh,
              full_val_every=1, full_val_cases=1, compute_dtype=torch.bfloat16)
    kernels = counter_snapshot()
    model = create_waveformer(Config().network.model_kwargs(), device="cuda", seed=SEED)
    t0 = time.time()
    trainer = Trainer(model, max_epochs=1, resume=False, **kw)
    trainer.train(train_ds, val_ds)
    torch.cuda.synchronize()
    out = {"coords": mesh.coords, "trainer_s": time.time() - t0,
           "epoch_times": trainer.epoch_times, "best": trainer.best_mean_dice,
           "first": digest(trainer.state.params.values()),
           "assembly_ms": {line: trainer._train_step.reducer.device_ms(line)
                           for line in ("spatial",)}}
    after = counter_snapshot()
    out["launches"] = {k: after[k] - kernels[k] for k in ("window_attention", "dwconv3")}
    out["backward_launches"] = {d: n - kernels["dwconv3_backward"][d]
                                for d, n in after["dwconv3_backward"].items()}
    if mesh.is_main:
        trainer.ckpt.save_state(trainer.state, trainer.epoch)
    mesh.barrier()
    del trainer, model
    torch.cuda.empty_cache()
    model = create_waveformer(Config().network.model_kwargs(), device="cuda",
                              seed=SEED + 1 + rank)
    again = Trainer(model, max_epochs=1, resume=True, **kw)
    again.train(train_ds, val_ds)
    out["reloaded"] = digest(again.state.params.values())
    out["reloaded_step"] = again.global_step
    del again, model
    torch.cuda.empty_cache()

    gt = np.random.default_rng(SEED).standard_normal(
        (2, *SSL_STEP_CONFIG["img_size"], SSL_STEP_CONFIG["in_channels"])).astype(np.float32)
    ssl = {}
    for key, m in (("mesh", mesh), ("no_mesh", None)):
        model = create_ssl_vit(device="cuda", seed=SEED, **SSL_STEP_CONFIG)
        # two steps: the warm-up's first has lr 0
        trainer = SSLTrainer(model, num_steps=2, lr=1e-4, warmup_steps=1, eval_every=10,
                             logdir=os.path.join(workdir, f"ssl_{key}_{rank}"), seed=SEED,
                             mesh=m)
        trainer.train(iter([gt, gt]))
        ssl[key] = {k: v.detach().cpu() for k, v in trainer.state.params.items()}
    out["ssl_digest"] = digest(ssl["mesh"].values())
    out["ssl_max_abs_err"] = max(float((ssl["mesh"][k] - ssl["no_mesh"][k]).abs().max())
                                 for k in ssl["mesh"])
    out["ssl_equal_no_mesh"] = all(torch.equal(ssl["mesh"][k], ssl["no_mesh"][k])
                                   for k in ssl["mesh"])
    return out


def check_mp_trainers(ranks, launches):
    """15c-d's gates on each rank's `mp_trainers` result; adds the ranks'
    launches to `launches`. Returns (ok, the row's entry)."""
    # each rank: the steps' and one validation batch's forwards; rank 0
    # also the full-volume validation's, on the unsharded copy
    forwards = MP_TRAINER_STEPS + 1
    per_rank = [r["launches"] for r in ranks]
    for r in per_rank:
        for k in launches:
            launches[k] += r[k]
    c_ok = (len({r["first"] for r in ranks}) == 1
            and all(r["reloaded"] == r["first"] for r in ranks)
            and all(r["reloaded_step"] == MP_TRAINER_STEPS for r in ranks)
            and per_rank[1] == {"window_attention": 14 * forwards, "dwconv3": 10 * forwards}
            and per_rank[0]["window_attention"] > 14 * forwards
            and all(r["backward_launches"]
                    == stencil_backward("tma_ring", 10 * MP_TRAINER_STEPS) for r in ranks))
    d_ok = (len({r["ssl_digest"] for r in ranks}) == 1
            and all(r["ssl_max_abs_err"] <= TRAIN_STEP_TOL["master_abs"] for r in ranks))
    entry = {
        "trainer": {"ok": bool(c_ok), "rank_trainer_s": [r["trainer_s"] for r in ranks],
                    "epoch_times": ranks[0]["epoch_times"], "steps": MP_TRAINER_STEPS,
                    "masters_equal_across_ranks": len({r["first"] for r in ranks}) == 1,
                    "reloaded_equal": [r["reloaded"] == r["first"] for r in ranks],
                    "launches": per_rank, "best_mean_dice": ranks[0]["best"],
                    "stencil_backward_launches": [r["backward_launches"] for r in ranks],
                    "assembly_ms": ranks[0]["assembly_ms"]},
        "ssl_trainer": {"ok": bool(d_ok),
                        "masters_equal_across_ranks": len({r["ssl_digest"] for r in ranks}) == 1,
                        "max_abs_err_vs_no_mesh": [r["ssl_max_abs_err"] for r in ranks],
                        "equal_to_no_mesh": [r["ssl_equal_no_mesh"] for r in ranks],
                        "tolerance": TRAIN_STEP_TOL["master_abs"]}}
    return c_ok and d_ok, entry


def run_model_parallel_training():
    """Phase 15: the one process's runs in a child, then (a) spatial=2, with
    (c)-(d) the trainers in the same ranks, and (b) tensor=3, over gloo on
    the one card. Returns (failed sub-phases, the attention and stencil
    launches of the children)."""
    failed, launches = [], {"window_attention": 0, "dwconv3": 0}
    t_phase = time.time()
    designs = {"float32": {"window_attention": {"fma": 14, "tma_wgmma": 0},
                           "dwconv3": {"vector": 10, "tma_ring": 0}},
               "bfloat16": {"window_attention": {"fma": 0, "tma_wgmma": 14},
                            "dwconv3": {"vector": 0, "tma_ring": 10}}}
    design = {"float32": "vector", "bfloat16": "tma_ring"}  # the stencil's backward
    runs = sorted({run for _, rs in MP_TRAIN_RUNS.values() for run in rs})
    with tempfile.TemporaryDirectory() as root:
        with open(os.path.join(root, "spec.json"), "w") as f:
            json.dump([(1, 1, 1), runs, "one"], f)
        t0 = time.time()
        ok, (one,) = spawn_ranks("mpt", 1, root)
        row = {"check": "mp_training_one_process", "wall_s": time.time() - t0, "ok": bool(ok)}
        if ok:
            row["runs"] = {f"{d}_{n}": {k: one[d, n][k] for k in
                                        ("metrics", "step_s", "peak_bytes", "launches")}
                           for d, n in runs}
        log(json.dumps(row))
        if not ok:
            return ["mp_training_one_process"], launches
        want = {run: torch.load(os.path.join(root, f"grads_one_{run[0]}_{run[1]}.pt"))
                for run in runs}
        for run in runs:
            for k in launches:
                launches[k] += sum(one[run]["launches"][k].values())
    for sub, (spec, sub_runs) in MP_TRAIN_RUNS.items():
        world = int(np.prod(spec))
        with tempfile.TemporaryDirectory() as root:
            with open(os.path.join(root, "spec.json"), "w") as f:
                json.dump([spec, sub_runs, sub], f)
            if spec[1] > 1:  # 15c-d in the same ranks, on phase 10c's kind of tree
                from waveformer_tpu_torch.tools import synthetic_cases

                synthetic_cases.write_training_cases(os.path.join(root, "fullres"), n=4,
                                                     shape=CASE_SHAPE[1:], seed=SEED)
            t0 = time.time()
            ok, ranks = spawn_ranks("mpt", world, root)
            row = {"check": f"mp_training_{sub}", "mesh": dict(zip(("data", "spatial", "tensor"),
                                                                   spec)),
                   "ranks": world, "backend": "gloo", "wall_s": time.time() - t0}
            for dtype_name, side in (sub_runs if ok else ()):
                run = (dtype_name, side)
                got = torch.load(os.path.join(root, f"grads_{sub}_{dtype_name}_{side}.pt"))
                rtol, floor, norm_tol = MP_TRAIN_TOL[dtype_name]
                shares = grad_shares(got, want[run], rtol, floor)
                worst = max(shares, key=shares.get)
                (l1, n1), (l0, n0) = ranks[0][run]["metrics"][0], one[run]["metrics"][0]
                rs = [r[run] for r in ranks]
                for r in rs:
                    for k in launches:
                        launches[k] += sum(r["launches"][k].values())
                peaks = [r["peak_bytes"] for r in rs]
                entry = {
                    "side": side, "worst_grad_share": shares[worst], "worst_grad_param": worst,
                    "grad_tol": [rtol, floor], "loss": [l0, l1], "grad_norm": [n0, n1],
                    "grad_norm_rel_err": abs(n1 - n0) / n0, "grad_norm_tol": norm_tol,
                    "masters_equal_across_ranks": len({r["masters_digest"] for r in rs}) == 1,
                    "launches_per_step": rs[0]["launches"],
                    "stencil_backward_launches_per_step": rs[0]["backward_launches"],
                    "rank_step_s": [r["step_s"] for r in rs],
                    "one_process_step_s": one[run]["step_s"],
                    "rank_forward_bytes": [r["forward_bytes"] for r in rs],
                    "rank_backward_bytes": [r["backward_bytes"] for r in rs],
                    "rank_assembly_bytes": [r["assembly_bytes"] for r in rs],
                    "rank_assembly_ms": [r["assembly_ms"] for r in rs],
                    "rank_peak_bytes": peaks, "one_process_peak_bytes": one[run]["peak_bytes"],
                    "peak_ratio": max(peaks) / one[run]["peak_bytes"]}
                good = (shares[worst] <= 1.0 and entry["grad_norm_rel_err"] <= norm_tol
                        and np.isfinite(l1) and entry["masters_equal_across_ranks"]
                        and all(r["launches"] == designs[dtype_name] for r in rs)
                        and all(r["backward_launches"]
                                == stencil_backward(design[dtype_name], 10) for r in rs))
                if spec[1] > 1 and dtype_name == "float32":
                    entry["peak_ratio_limit"] = MODEL_PARALLEL_PEAK_RATIO
                    good &= entry["peak_ratio"] <= MODEL_PARALLEL_PEAK_RATIO
                entry["ok"] = bool(good)
                row[f"{dtype_name}_{side}"] = entry
                ok &= good
            if ok and spec[1] > 1:
                trainers_ok, row["trainers"] = check_mp_trainers(
                    [r["trainers"] for r in ranks], launches)
                ok &= trainers_ok
            row["ok"] = bool(ok)
            log(json.dumps(row))
            if not ok:
                failed.append(f"mp_training_{sub}")
    log(json.dumps({"check": "mp_training_phase", "seconds": time.time() - t_phase,
                    "launches": launches, "failed": failed}))
    return failed, launches


CHILDREN = {"dp": child_dp_steps, "predict": child_sharded_predict,
            "multihost": child_multihost, "mp": child_model_parallel,
            "mpt": child_mp_training}


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_parallel(served, step_designs):
    """Phase 13: (a) two ranks on the one card over gloo, the
    data-parallel train step against the one-process step; (b)
    `scripts.predict --sharded on` at two ranks over gloo against phase 5b's
    files; (c) `scripts.train --multihost` and (d) `SSLTrainer(mesh=...)`
    at world size 1 over NCCL. Returns (failed sub-phases, the attention
    and stencil launches of the children)."""
    failed, launches = [], {"window_attention": 0, "dwconv3": 0}
    t_phase = time.time()

    # 13a
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        ok, ranks = spawn_ranks("dp", 2, root)
        wall = time.time() - t0
        want_metrics, want_params, want_launches = parallel_steps()
    row = {"check": "dp_two_ranks_gloo", "torch": torch.__version__, "ranks": 2,
           "net": "example_32",
           "drop_path_rate": PARALLEL_NET["drop_path_rate"], "global_batch": 2,
           "steps": PARALLEL_STEPS, "wall_s": wall, "tolerances": TRAIN_STEP_TOL}
    if ok:
        p0, p1 = ranks[0]["params"], ranks[1]["params"]
        equal = all(torch.equal(p0[k], p1[k]) for k in p0)
        master_err = max(float((p0[k] - want_params[k]).abs().max()) for k in p0)
        loss_rel = max(abs(g[0] - w[0]) / abs(w[0])
                       for g, w in zip(ranks[0]["metrics"], want_metrics))
        norm_rel = max(abs(g[1] - w[1]) / w[1] for g, w in zip(ranks[0]["metrics"], want_metrics))
        # per forward, each rank exactly phase 10a's one forward, per design
        per_forward = [{k: {d: n / PARALLEL_STEPS for d, n in r["launches"][k].items()}
                        for k in r["launches"]} for r in ranks]
        ok = (equal and master_err <= TRAIN_STEP_TOL["master_abs"]
              and loss_rel <= TRAIN_STEP_TOL["loss_rel"]
              and norm_rel <= TRAIN_STEP_TOL["grad_norm_rel"]
              and all(pf == step_designs for pf in per_forward)
              and per_forward[0] == {k: {d: n / PARALLEL_STEPS for d, n in v.items()}
                                     for k, v in want_launches.items()}
              and all(r["backend"] == "gloo" for r in ranks))
        for r in ranks:
            for k in launches:
                launches[k] += sum(r["launches"][k].values())
        row.update(masters_equal_across_ranks=equal, master_max_abs_err=master_err,
                   loss_rel_err=loss_rel, grad_norm_rel_err=norm_rel,
                   metrics=[r["metrics"] for r in ranks], one_process_metrics=want_metrics,
                   launches_per_forward=per_forward, phase10a_per_forward=step_designs,
                   gloo_cuda_collectives=ranks[0]["gloo_cuda"])
    row["ok"] = bool(ok)
    log(json.dumps(row))
    if not ok:
        failed.append("dp_two_ranks_gloo")

    # 13b
    with tempfile.TemporaryDirectory() as root:
        _, names = write_serving_tree(root, np.random.default_rng(SEED))
        t0 = time.time()
        ok, ranks = spawn_ranks("predict", 2, root)
        wall = time.time() - t0
        row = {"check": "sharded_predict_gloo", "ranks": 2, "cases": len(names), "tta": 8,
               "wall_s": wall}
        if ok:
            files = sorted(os.listdir(os.path.join(root, "predictions")))
            equal = {}
            from waveformer_tpu_torch.utils import nifti

            for name in names:
                got = nifti.load(os.path.join(root, "predictions", name + ".nii.gz"))
                data, affine = served[name]
                equal[name] = (np.array_equal(got.data, data)
                               and np.array_equal(got.affine, affine))
            total = {k: sum(r[k] for r in ranks) for k in ("window_attention", "dwconv3")}
            designs = {k: {d: sum(r["designs"][k][d] for r in ranks)
                           for d in ranks[0]["designs"][k]} for k in total}
            n = len(names)
            ok = (files == sorted(n_ + ".nii.gz" for n_ in names) and all(equal.values())
                  and [r["summary"]["cases"] for r in ranks] == [1, 1]
                  and total == {"window_attention": 112 * n, "dwconv3": 80 * n}
                  and designs == {"window_attention": {"fma": 0, "tma_wgmma": 112 * n},
                                  "dwconv3": {"vector": 0, "tma_ring": 80 * n}})
            for k in launches:
                launches[k] += total[k]
            row.update(files=files, equal_to_phase_5b=equal, launches=total,
                       launches_by_design=designs,
                       rank_cases=[r["summary"]["cases"] for r in ranks],
                       rank_script_s=[r["summary"]["seconds"] for r in ranks],
                       rank_wall_s=[r["wall_s"] for r in ranks],
                       # one case a rank, both ranks on the one card at once
                       cases_per_s=n / max(r["summary"]["seconds"] for r in ranks))
        row["ok"] = bool(ok)
        log(json.dumps(row))
        if not ok:
            failed.append("sharded_predict_gloo")

    # 13c and 13d
    with tempfile.TemporaryDirectory() as root:
        ok, (res,) = spawn_ranks("multihost", 1, root, env={
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())})
        if ok:
            log(json.dumps(res["row_d"]))
            for k in launches:
                launches[k] += res["counts"][k]
            if not res["ok_c"]:
                failed.append("train_multihost_nccl")
            if not res["ok_d"]:
                failed.append("ssl_trainer_mesh_nccl")
        else:
            failed.append("multihost_child")
    log(json.dumps({"check": "parallel_phase", "seconds": time.time() - t_phase,
                    "launches": launches, "failed": failed}))
    return failed, launches


# --------------------------------------------------------------------------- #
# phase 16: the auxiliary ops (grid pull/push, bilateral filters, GMM,
# criss-cross attention, the legacy 2D modules, generic wavelets)
# --------------------------------------------------------------------------- #


def on_card(out):
    """Whether every tensor in `out` (nested tuples, lists, dicts) lies on
    the card."""
    if torch.is_tensor(out):
        return out.is_cuda
    if isinstance(out, dict):
        return all(on_card(v) for v in out.values())
    if isinstance(out, (tuple, list)):
        return all(on_card(v) for v in out)
    return True


def rel_err(got, want):
    """max |got − want| / max |want|, on the host in fp32."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


class AuxRow:
    """One sub-phase of phase 16: each card call's output is compared with
    the same call on CPU tensors, timed once more by CUDA events and its
    peak memory read; the line also carries every port kernel's launches
    over the sub-phase, which must be 0."""

    def __init__(self, check):
        self.row = {"check": check, "errors": {}, "limits": {}, "card_ms": {}, "peak_gb": {},
                    "on_card": True}
        self.ok = True
        zero_kernel_counts()

    def card(self, name, fn, time_it=True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        self.row["peak_gb"][name] = torch.cuda.max_memory_allocated() / 2**30
        if time_it:
            self.row["card_ms"][name] = cuda_ms(fn, iters=1, warmup=0)
        self.row["on_card"] = self.row["on_card"] and on_card(out)
        return out

    def compare(self, name, got, want, kind):
        err = rel_err(got, want)
        self.row["errors"][name] = err
        self.row["limits"][name] = AUX_TOL[kind]
        self.ok &= bool(np.isfinite(err)) and err <= AUX_TOL[kind]

    def check(self, name, good, value=None):
        self.row[name] = bool(good) if value is None else value
        self.ok &= bool(good)

    def finish(self):
        launches = kernel_counts()
        self.row["launches"] = launches
        self.row["card_ms_total"] = sum(self.row["card_ms"].values())
        self.row["peak_gb_max"] = max(self.row["peak_gb"].values(), default=0.0)
        self.ok &= self.row["on_card"] and not any(launches.values())
        self.row["ok"] = bool(self.ok)
        log(json.dumps(self.row))
        return self.ok


def aux_volume_and_coords(seed=SEED):
    """A (D, H, W, C) unit-normal volume and one coordinate per voxel: the
    identity grid plus a smooth seeded displacement of up to
    AUX_MAX_DISPLACEMENT voxels per axis (a sine of wavelength ~64 voxels),
    so that points leave every face."""
    g = torch.Generator().manual_seed(seed)
    d, h, w, c = AUX_VOLUME
    vol = torch.randn(d, h, w, c, generator=g)
    axes = [torch.arange(n, dtype=torch.float32) for n in (d, h, w)]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    freq = torch.randn(3, 3, generator=g) * (2 * np.pi / 64)
    phase = torch.rand(3, generator=g) * 2 * np.pi
    return vol, grid + AUX_MAX_DISPLACEMENT * torch.sin(grid @ freq.T + phase)


def pull_grads(ts, vol, crd, u, bound, order):
    v = vol.clone().requires_grad_(True)
    c = crd.clone().requires_grad_(True)
    (ts.grid_pull(v, c, bound, order) * u).sum().backward()
    return v.grad, c.grad


def run_aux_grid():
    """16a: `grid_pull` at orders 0-3 × zero/clamp/reflect and once with
    per-dimension orders and bounds, `grid_push` and `grid_count` at orders
    1 and 3, pull's gradients for the volume and the coordinates at orders 1
    and 3, the adjoint identity and `spline_prefilter` at order 3."""
    from waveformer_tpu_torch.ops import spatial as ts

    r = AuxRow("aux_grid")
    vol, crd = aux_volume_and_coords()
    u = torch.randn(crd.shape[0], vol.shape[-1], generator=torch.Generator().manual_seed(SEED + 1))
    vc, cc, uc = (t.cuda() for t in (vol, crd, u))
    hi = torch.tensor(AUX_VOLUME[:3], dtype=torch.float32) - 1
    r.row.update(volume=list(AUX_VOLUME), points=crd.shape[0],
                 outside_share=float(((crd < 0) | (crd > hi)).any(1).float().mean()))
    mixed = ("reflect", "zero", "clamp")
    for name, order, bound in ([(f"pull_{o}_{b}", o, b) for o in range(4) for b in ts.BOUND_MODES]
                               + [("pull_per_dim", (3, 1, 2), mixed)]):
        got = r.card(name, lambda: ts.grid_pull(vc, cc, bound, order))
        r.compare(name, got, ts.grid_pull(vol, crd, bound, order), "forward")
    for order in (1, 3):
        got = r.card(f"push_{order}", lambda: ts.grid_push(uc, cc, AUX_VOLUME[:3], mixed, order))
        r.compare(f"push_{order}", got, ts.grid_push(u, crd, AUX_VOLUME[:3], mixed, order),
                  "forward")
        got = r.card(f"count_{order}", lambda: ts.grid_count(cc, AUX_VOLUME[:3], mixed, order))
        r.compare(f"count_{order}", got, ts.grid_count(crd, AUX_VOLUME[:3], mixed, order),
                  "forward")
        bound = "zero" if order == 1 else "reflect"
        got = r.card(f"pull_grads_{order}", lambda: pull_grads(ts, vc, cc, uc, bound, order))
        want = pull_grads(ts, vol, crd, u, bound, order)
        r.compare(f"pull_grad_volume_{order}", got[0], want[0], "gradient")
        r.compare(f"pull_grad_coords_{order}", got[1], want[1], "gradient")
    # ⟨pull(v), u⟩ = ⟨v, push(u)⟩ on the card, against Σ|pull(v)·u|
    pulled = ts.grid_pull(vc, cc, mixed, 3)
    lhs = float((pulled.double() * uc.double()).sum())
    rhs = float((vc.double() * ts.grid_push(uc, cc, AUX_VOLUME[:3], mixed, 3).double()).sum())
    scale = float((pulled.double() * uc.double()).abs().sum())
    r.row["adjoint_rel_err"] = abs(lhs - rhs) / scale
    r.check("adjoint_ok", r.row["adjoint_rel_err"] <= AUX_TOL["adjoint"])
    del pulled
    got = r.card("prefilter_3", lambda: ts.spline_prefilter(vc, 3))
    r.compare("prefilter_3", got, ts.spline_prefilter(vol, 3), "forward")
    return r.finish()


def trainable_grads(module, x, g):
    x = x.clone().requires_grad_(True)
    module.zero_grad(set_to_none=True)
    y = module(x)
    (y * g).sum().backward()
    return y.detach(), x.grad, module.spatial_sigma.grad, module.color_sigma.grad


def run_aux_bilateral():
    """16b: `bilateral_filter` and `joint_bilateral_filter` (a 4-channel
    guide) on a (1, 128³, 4) volume at σs = 1, σc = 0.5 (125 offsets);
    `TrainableBilateralFilter` forward and backward (x and both sigmas)
    card against CPU at 64³, then its 128³ backward on the card alone
    (finite gradients, peak memory)."""
    from waveformer_tpu_torch.ops import bilateral as tb

    r = AuxRow("aux_bilateral")
    ss, cs = AUX_BILATERAL
    g = torch.Generator().manual_seed(SEED + 2)
    x = torch.randn(1, *AUX_VOLUME, generator=g)
    guide = torch.randn(1, *AUX_VOLUME, generator=g)
    cot = torch.randn(1, *AUX_VOLUME, generator=g)
    xc, gc = x.cuda(), guide.cuda()
    got = r.card("bilateral_filter", lambda: tb.bilateral_filter(xc, ss, cs))
    r.compare("bilateral_filter", got, tb.bilateral_filter(x, ss, cs), "forward")
    got = r.card("joint_bilateral_filter", lambda: tb.joint_bilateral_filter(xc, gc, ss, cs))
    r.compare("joint_bilateral_filter", got, tb.joint_bilateral_filter(x, guide, ss, cs),
              "forward")
    del got
    cpu_mod = tb.TrainableBilateralFilter(ss, cs)
    card_mod = tb.TrainableBilateralFilter(ss, cs).cuda()
    card_mod.load_state_dict(cpu_mod.state_dict())
    s = AUX_BILATERAL_GRAD_SIDE
    xs, gs = (t[:, :s, :s, :s].contiguous() for t in (x, cot))
    xsc, gsc = xs.cuda(), gs.cuda()
    got = r.card(f"trainable_{s}", lambda: trainable_grads(card_mod, xsc, gsc))
    want = trainable_grads(cpu_mod, xs, gs)
    r.compare(f"trainable_{s}_forward", got[0], want[0], "forward")
    for name, a, b in zip(("x", "spatial_sigma", "color_sigma"), got[1:], want[1:]):
        r.compare(f"trainable_{s}_grad_{name}", a, b, "gradient")
    del got
    big = r.card(f"trainable_{AUX_VOLUME[0]}_card_only",
                 lambda: trainable_grads(card_mod, xc, cot.cuda()))
    r.check("card_only_grads_finite", all(bool(torch.isfinite(t).all()) for t in big))
    r.row["card_only_sigma_grads"] = [float(big[2]), float(big[3])]
    del big
    torch.cuda.empty_cache()
    return r.finish()


def gmm_segment_case(seed=SEED):
    """An AUX_VOLUME volume whose central sphere (radius a quarter of the
    side) has its mean shifted by 2.5, and (D, H, W) seeds: AUX_GMM_SEEDS[0] voxels
    outside the sphere marked 0 and AUX_GMM_SEEDS[1] (fewer than 4096)
    inside marked 1, the rest −1."""
    g = torch.Generator().manual_seed(seed)
    d, h, w, c = AUX_VOLUME
    vol = torch.randn(d, h, w, c, generator=g)
    axes = [torch.arange(n, dtype=torch.float32) - n / 2 for n in (d, h, w)]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    inside = (zz ** 2 + yy ** 2 + xx ** 2) < (min(d, h, w) / 4) ** 2
    vol[inside] += 2.5
    seeds = torch.full((d, h, w), -1, dtype=torch.int64)
    flat, ins = seeds.reshape(-1), inside.reshape(-1)
    for cls, (where, n) in enumerate(zip((~ins, ins), AUX_GMM_SEEDS)):
        idx = torch.nonzero(where).squeeze(1)
        flat[idx[torch.randperm(idx.numel(), generator=g)[:n]]] = cls
    return vol, seeds, inside


def run_aux_gmm():
    """16c: `gmm_fit` (4096 × 4, K = 2, 20 EM steps) and `gmm_segment` of a
    128³ × 4 volume with two seeded classes, one under 4096 seeds."""
    from waveformer_tpu_torch.ops import gmm as tg

    r = AuxRow("aux_gmm")
    n, c, k, iters = AUX_GMM_FIT
    g = torch.Generator().manual_seed(SEED + 3)
    x = torch.cat([torch.randn(n // 2, c, generator=g),
                   3.0 + 0.5 * torch.randn(n - n // 2, c, generator=g)])
    xc = x.cuda()
    got = r.card("gmm_fit", lambda: tg.gmm_fit(xc, k, iters, seed=0))
    for name, a, b in zip(tg.GMMParams._fields, got, tg.gmm_fit(x, k, iters, seed=0)):
        r.compare(f"gmm_fit_{name}", a, b, "gmm_params")
    vol, seeds, inside = gmm_segment_case()
    vc, sc = vol.cuda(), seeds.cuda()
    got = r.card("gmm_segment", lambda: tg.gmm_segment(vc, sc, 2, 2, iters)).cpu()
    want = tg.gmm_segment(vol, seeds, 2, 2, iters)
    equal = float((got == want).float().mean())
    r.check("labels_equal_share", equal >= AUX_TOL["labels_equal"], equal)
    r.row["labels_equal_limit"] = AUX_TOL["labels_equal"]
    r.row["sphere_labelled_1_share"] = float((got[inside] == 1).float().mean())
    r.row["outside_labelled_0_share"] = float((got[~inside] == 0).float().mean())
    return r.finish()


def cc_grads(cca, q, k, v, g):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = cca(*leaves)
    (out * g).sum().backward()
    return (out.detach(), *(t.grad for t in leaves))


def run_aux_cc():
    """16d: criss-cross attention at CCNet's Cityscapes head (B = 2, 97 ×
    97, Cqk = 64, Cv = 512), forward and the gradients of q, k and v."""
    from waveformer_tpu_torch.ops.cc_attention import criss_cross_attention

    r = AuxRow("aux_cc_attention")
    b, h, w, cqk, cv = AUX_CC
    g = torch.Generator().manual_seed(SEED + 4)
    q, k = (torch.randn(b, h, w, cqk, generator=g) for _ in range(2))
    v, cot = (torch.randn(b, h, w, cv, generator=g) for _ in range(2))
    ins = [t.cuda() for t in (q, k, v, cot)]
    got = r.card("criss_cross", lambda: cc_grads(criss_cross_attention, *ins))
    want = cc_grads(criss_cross_attention, q, k, v, cot)
    r.compare("forward", got[0], want[0], "forward")
    for name, a, b_ in zip("qkv", got[1:], want[1:]):
        r.compare(f"grad_{name}", a, b_, "gradient")
    return r.finish()


def run_aux_legacy2d():
    """16e: the legacy 2D modules at SegFormer MiT-B2's stage 1 on 512 × 512
    images, batch 2: `OverlapPatchEmbed2D(3 → 64, 7, 4)` (128 × 128
    tokens), `Mlp2D(64, hidden 256)`, `DWConv2D(256)` and `PosCNN2D(64)` at
    strides 1 and 2, each card module loaded with its CPU twin's weights,
    eval mode, on the same inputs."""
    from waveformer_tpu_torch.models import legacy2d as tl

    r = AuxRow("aux_legacy2d")
    b, side, cin, c1, hidden = AUX_MIT_B2
    builders = {
        "patch_embed": lambda gen: tl.OverlapPatchEmbed2D(cin, c1, 7, 4, generator=gen),
        "mlp": lambda gen: tl.Mlp2D(c1, hidden, generator=gen),
        "dwconv": lambda gen: tl.DWConv2D(hidden, generator=gen),
        "poscnn_s1": lambda gen: tl.PosCNN2D(c1, 1, generator=gen),
        "poscnn_s2": lambda gen: tl.PosCNN2D(c1, 2, generator=gen),
    }
    gen = torch.Generator().manual_seed(SEED + 5)
    cpu, card = {}, {}
    for name, build in builders.items():
        cpu[name] = build(gen).eval()
        card[name] = build(None).cuda().eval()
        card[name].load_state_dict(cpu[name].state_dict())
    img = torch.randn(b, side, side, cin, generator=gen)
    with torch.no_grad():
        tokens, h, w = cpu["patch_embed"](img)
        got = r.card("patch_embed", lambda: card["patch_embed"](img.cuda()))
        r.check("grid", got[1:] == (h, w) == (side // 4, side // 4), [h, w])
        r.compare("patch_embed", got[0], tokens, "forward")
        wide = torch.randn(b, h * w, hidden, generator=gen)
        tc_, wc = tokens.cuda(), wide.cuda()
        for name, args, cargs in (("mlp", (tokens,), (tc_,)), ("dwconv", (wide, h, w), (wc, h, w)),
                                  ("poscnn_s1", (tokens, h, w), (tc_, h, w)),
                                  ("poscnn_s2", (tokens, h, w), (tc_, h, w))):
            got = r.card(name, lambda: card[name](*cargs))
            r.compare(name, got, cpu[name](*args), "forward")
    return r.finish()


def run_aux_wavelets():
    """16f: the generic FIR path at the flagship's stage-1 shape (8, 64³, 48)
    with a registered 2-tap bank: `dwt3`/`idwt3` and `wavedec3`/`waverec3`
    at level 3 against the CPU; a registered copy of db1's bank against the
    Haar path; a 4-tap bank raising ValueError."""
    from waveformer_tpu_torch.ops import wavelet as tw

    r = AuxRow("aux_wavelets")
    shape, level = AUX_WAVELET
    sq = 0.5 ** 0.5
    banks = {"aux_rot2": ([0.6, 0.8], [-0.8, 0.6], [0.8, 0.6], [0.6, -0.8]),
             "aux_db1_copy": ([sq, sq], [-sq, sq], [sq, sq], [sq, -sq]),
             "aux_db2": ([-0.1294095226, 0.2241438680, 0.8365163037, 0.4829629131],) * 4}
    for name, bank in banks.items():
        tw.register_wavelet(name, *bank)
    try:
        x = torch.randn(*shape, generator=torch.Generator().manual_seed(SEED + 6))
        xc = x.cuda()

        def compare_coeffs(tag, got, want):
            r.compare(f"{tag}_lowpass", got[0], want[0], "forward")
            for i, (gd, wd) in enumerate(zip(got[1:], want[1:])):
                r.compare(f"{tag}_details_{i}", torch.stack([gd[k] for k in tw.DETAIL_KEYS]),
                          torch.stack([wd[k] for k in tw.DETAIL_KEYS]), "forward")

        got = r.card("dwt3", lambda: tw.dwt3(xc, "aux_rot2"))
        want = tw.dwt3(x, "aux_rot2")
        compare_coeffs("dwt3", got, want)
        y = r.card("idwt3", lambda: tw.idwt3(*got, "aux_rot2"))
        r.compare("idwt3", y, tw.idwt3(*want, "aux_rot2"), "forward")
        del got, want, y
        got = r.card("wavedec3", lambda: tw.wavedec3(xc, "aux_rot2", level))
        want = tw.wavedec3(x, "aux_rot2", level)
        compare_coeffs("wavedec3", got, want)
        y = r.card("waverec3", lambda: tw.waverec3(got, "aux_rot2"))
        r.compare("waverec3", y, tw.waverec3(want, "aux_rot2"), "forward")
        r.compare("waverec3_reconstructs_x", y, xc, "forward")
        del got, want, y
        gen_c = r.card("wavedec3_db1_copy", lambda: tw.wavedec3(xc, "aux_db1_copy", level))
        compare_coeffs("db1_copy_vs_haar", gen_c, tw.wavedec3(xc, "db1", level))
        del gen_c
        try:
            tw.dwt3(xc, "aux_db2")
            raised = False
        except ValueError:
            raised = True
        r.check("four_taps_raise_value_error", raised)
    finally:
        for name in banks:
            tw._WAVELETS.pop(name, None)
    torch.cuda.empty_cache()
    return r.finish()


def run_aux_ops():
    """Phase 16: the ops the JAX package writes in plain jnp (no Pallas), on
    the card at a user's sizes, each held against the same call on CPU
    tensors (fp32, TF32 off), every port kernel's launches 0 over each
    sub-phase. Returns the names of the sub-phases that failed."""
    failed = []
    t_phase = time.time()
    for name, fn in (("aux_grid", run_aux_grid), ("aux_bilateral", run_aux_bilateral),
                     ("aux_gmm", run_aux_gmm), ("aux_cc_attention", run_aux_cc),
                     ("aux_legacy2d", run_aux_legacy2d), ("aux_wavelets", run_aux_wavelets)):
        t0 = time.time()
        ok = fn()
        log(json.dumps({"check": f"{name}_seconds", "seconds": time.time() - t0}))
        if not ok:
            failed.append(name)
        torch.cuda.empty_cache()
    log(json.dumps({"check": "aux_ops_phase", "seconds": time.time() - t_phase,
                    "failed": failed}))
    return failed


# --------------------------------------------------------------------------- #
# phase 17: the repository's drivers (bench_train, bench_tta, an example)
# --------------------------------------------------------------------------- #


def design_counts(ac, dc):
    return {"window_attention": dict(ac.design_launches), "dwconv3": dict(dc.design_launches)}


def driver_row(name, line, forwards, ac, dc, per_forward, t0, **checks):
    """One sub-phase's row: the tool's line, its launches against
    `per_forward` launches of each design a forward over `forwards`
    forwards, and its own `checks`. Returns (ok, launches by kernel)."""
    counts = {"window_attention": ac.launches, "dwconv3": dc.launches}
    got = design_counts(ac, dc)
    want = {k: {d: n * forwards for d, n in per_forward[k].items()} for k in per_forward}
    checks["launches"] = got == want
    ok = all(checks.values())
    log(json.dumps({"check": name, "seconds": time.time() - t0, "line": line,
                    "forwards": forwards, "launches_by_design": got,
                    "expected_by_design": want, "checks": checks, "ok": bool(ok)}))
    return ok, counts


def run_drivers(ac, dc):
    """Phase 17: the port's `tools/bench_train.py` (device-only and pipeline
    modes), `tools/bench_tta.py` and the liver-CT example driver, each
    through its `main` at a short length, with exact launch counts per
    design. Returns (failed sub-phases, launches by kernel)."""
    from waveformer_tpu_torch import bench
    from waveformer_tpu_torch.config import Config, load_config
    from waveformer_tpu_torch.examples import liver_ct
    from waveformer_tpu_torch.inference import SlidingWindowInferer
    from waveformer_tpu_torch.models import create_waveformer
    from waveformer_tpu_torch.tools import bench_train, bench_tta

    failed, launches = [], {"window_attention": 0, "dwconv3": 0}
    t_phase = time.time()
    # the bf16 flagship's launches a forward, all on the TMA designs
    flagship = {"window_attention": {"fma": 0, "tma_wgmma": 14},
                "dwconv3": {"vector": 0, "tma_ring": 10}}

    def add(name, result):
        ok, counts = result
        if not ok:
            failed.append(name)
        for k, n in counts.items():
            launches[k] += n
        torch.cuda.empty_cache()

    # (a) device-only: a warm-up step and DRIVER_STEPS chained steps
    zero_counts(ac, dc)
    t0 = time.time()
    line = bench_train.main(["--device-only", "--steps", str(DRIVER_STEPS)])
    add("bench_train_device_only", driver_row(
        "bench_train_device_only", line, DRIVER_STEPS + 1, ac, dc, flagship, t0,
        finite=bool(np.isfinite([line["loss_first"], line["loss_last"]]).all()),
        timed=line["device_ms_per_step"] is not None and line["peak_mem_gib"] > 0))

    # (b) pipeline mode: the Trainer over spawned loader workers
    zero_counts(ac, dc)
    t0 = time.time()
    line = bench_train.main(["--steps", str(DRIVER_PIPELINE[0]), "--epochs",
                             str(DRIVER_PIPELINE[1]), "--workers", str(DRIVER_PIPELINE[2])])
    steps = DRIVER_PIPELINE[0] * DRIVER_PIPELINE[1]
    add("bench_train_pipeline", driver_row(
        "bench_train_pipeline", line, steps, ac, dc, flagship, t0,
        finite=line["loss_count"] == steps and line["losses_finite"],
        epochs=len(line["epoch_secs"]) == DRIVER_PIPELINE[1]))

    # (c) bench_tta: per setting a warm-up case and 3 streams of the cases
    zero_counts(ac, dc)
    t0 = time.time()
    lines, labels = bench_tta.main(["--tta", *map(str, DRIVER_TTA), "--cases", "1"])
    per_case = {n: forwards_per_case(
        SlidingWindowInferer(Config().prediction.patch_size, bench.SW_BATCH_SIZE, bench.OVERLAP,
                             mirror_axes=bench_tta.AXES[n], tta_mode="patch",
                             layout="channels_first"), bench.CASE_SHAPE[1:]) for n in DRIVER_TTA}
    # a (4, 150, 180, 145) case is one batch of 8 windows an orientation
    forwards = (1 + bench.N_STREAMS) * sum(per_case.values())
    add("bench_tta", driver_row(
        "bench_tta", lines, forwards, ac, dc, flagship, t0,
        n_forwards_a_case_at_tta_n=per_case == {n: n for n in DRIVER_TTA},
        labels=all(labels[n].shape == bench.CASE_SHAPE[1:] for n in DRIVER_TTA),
        rates=all(np.isfinite(x["cases_per_s_chip"]) and x["cases_per_s_chip"] > 0
                  for x in lines)))

    # (d) the liver-CT example: preprocess, train, predict, metrics
    with tempfile.TemporaryDirectory() as root:
        workdir = os.path.join(root, "liver")
        argv = ["--workdir", workdir, "--cases", "4", "--epochs", "1", "--steps", "3"]
        # the tiny fp32 network's launches a forward, by design
        os.makedirs(workdir)
        cfg = load_config(liver_ct.write_config(workdir, os.path.join(workdir, "raw"), 1, 3))
        model = create_waveformer(cfg.network.model_kwargs(), device="cuda", seed=SEED,
                                  io_layout="channels_first")
        zero_counts(ac, dc)
        with torch.no_grad():
            model(torch.zeros(1, 1, *cfg.network.img_size, device="cuda"))
        per_forward = design_counts(ac, dc)
        del model
        zero_counts(ac, dc)
        t0 = time.time()
        results = liver_ct.main(argv)
        with open(os.path.join(workdir, "data_list", cfg.split_path, "val_list.pkl"), "rb") as f:
            val = pickle.load(f)
        inferer = SlidingWindowInferer(cfg.prediction.patch_size, cfg.prediction.sw_batch_size,
                                       cfg.prediction.overlap, mirror_axes=None,
                                       tta_mode="patch", layout="channels_first")
        predict_forwards = sum(
            forwards_per_case(inferer, np.load(os.path.join(workdir, "fullres", v + ".npy"),
                                               mmap_mode="r").shape[1:]) for v in val)
        # 3 steps, then one validation of val_patches_per_epoch / batch_size batches
        forwards = 3 + max(1, cfg.val_patches_per_epoch // cfg.batch_size) + predict_forwards
        preds = [f for f in os.listdir(os.path.join(workdir, "predictions"))
                 if f.endswith(".nii.gz")]
        add("liver_ct_example", driver_row(
            "liver_ct_example", {"metrics": results.tolist(), "val_cases": val,
                                 "predict_forwards": predict_forwards},
            forwards, ac, dc, per_forward, t0,
            metrics=results.shape == (len(val), 2, 2) and bool(np.isfinite(results).all()),
            predictions=len(preds) == len(val),
            fp32_designs=per_forward["window_attention"]["tma_wgmma"] == 0
            and per_forward["dwconv3"]["tma_ring"] == 0
            and per_forward["window_attention"]["fma"] > 0 and per_forward["dwconv3"]["vector"] > 0))
    log(json.dumps({"check": "drivers_phase", "seconds": time.time() - t_phase,
                    "failed": failed}))
    return failed, launches


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
        from waveformer_tpu_torch import bench
        from waveformer_tpu_torch.config import Config
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
    ok, launches = run_main_path(bench, ac, dc)
    if not ok:
        failed.append("main_path")
    ok, served = run_serving_path(bench, ac, dc)
    if not ok:
        failed.append("serving_path")
    ok, results["window_attention_masked"], swin_launches = run_swin_path(ac)
    if not ok:
        failed.append("swin_path")
    launches["window_attention"] += swin_launches
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
    ok, step_designs = check_train_step_vs_cpu(create_waveformer, ac, dc)
    if not ok:
        failed.append("train_step_card_vs_cpu")
    for phase, fn in (("flagship_training", run_flagship_training),
                      ("training_script", run_training_script),
                      ("front_end", run_front_end)):
        ok, counts = fn(ac, dc)
        if not ok:
            failed.append(phase)
        for name, n in counts.items():
            launches[name] += n
    failed += run_ssl()
    parallel_failed, parallel_launches = run_parallel(served, step_designs)
    failed += parallel_failed
    for name, n in parallel_launches.items():
        launches[name] += n
    for run in (run_model_parallel, run_model_parallel_training):
        mp_failed, mp_launches = run()
        failed += mp_failed
        for name, n in mp_launches.items():
            launches[name] += n
    failed += run_aux_ops()
    drivers_failed, driver_launches = run_drivers(ac, dc)
    failed += drivers_failed
    for name, n in driver_launches.items():
        launches[name] += n
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
                 design=ac.design(torch.bfloat16, *ATTN_MAIN_SHAPES[0][2:]),
                 masked=masked_headline(results["window_attention_masked"])),
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
    if sys.argv[1:2] == ["--child"]:  # one rank of phase 13 or 14
        kind, rank, world, workdir = sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        CHILDREN[kind](rank, world, workdir)
        sys.exit(0)
    sys.exit(main())
