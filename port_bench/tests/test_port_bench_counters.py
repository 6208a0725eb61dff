"""The FLOP and byte counters behind `mfu.*` and the kernels' roofline
shares, and the table of peaks."""

from __future__ import annotations

import json
import os

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import flops, peaks
from port_bench.archs import waveformer as arch
from port_bench.reference import model as ref_model
from port_bench.tests import tiny


def _config(name):
    with open(os.path.join(tiny.ROOT, "port_bench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_flagship_patch_forward_count():
    counts = flops.model_counts(arch, _config("waveformer-brats")["network"], 1)
    assert counts["forward_flops"] == 1_579_394_678_784
    assert counts["train_flops"] == 3 * counts["forward_flops"]


def test_meta_count_equals_the_count_over_real_tensors():
    torch.set_num_threads(2)
    ref = ref_model.build(tiny.NETWORK, "cpu")
    ref.load_state_dict(arch.make_state_dict(tiny.NETWORK, 1, "cpu"))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref(torch.randn(2, 32, 32, 32, 2))
    assert counter.get_total_flops() == flops.model_counts(arch, tiny.NETWORK, 2)["forward_flops"]


def test_flagship_calls_per_forward():
    """14 window-attention and 10 stencil calls a forward, as the system's
    launch counters read on the card."""
    calls = flops.model_counts(arch, _config("waveformer-brats")["network"], 8)["calls"]
    attn = [s for k, s in calls if k == "window_attention"]
    dw = [s for k, s in calls if k == "dwconv3"]
    assert len(attn) == 14 and len(dw) == 10
    assert (512, 3, 512, 16) in attn
    assert (8, 64, 64, 64, 192) in dw
    abdomen = flops.model_counts(arch, _config("waveformer-abdomen")["network"], 4)["calls"]
    assert {s[2] for k, s in abdomen if k == "window_attention"} == {216}


def test_attention_work_at_the_kernel_tables_shape():
    f, b = flops.attention_work((512, 3, 512, 16))
    assert f == 4 * 512 * 512 * 16 * 512 * 3
    assert b == 4 * 512 * 3 * 512 * 16 * 2 + 3 * 512 * 512 * 4
    # bytes bound it at the card's peaks: 53.5 MB at 3.35 TB/s
    s = flops.bound_seconds("window_attention", [("window_attention", (512, 3, 512, 16))],
                            989e12, 3.35e12)
    assert abs(s - b / 3.35e12) < 1e-15


def test_dwconv3_bytes_at_the_kernel_tables_shape():
    f, b = flops.dwconv3_work((8, 64, 64, 64, 192))
    voxels = 8 * 64 ** 3
    assert b == 2 * voxels * 192 * 2 + 28 * 192 * 4
    assert f == 54 * voxels * 192


def test_peaks_table():
    h100 = peaks.peak("NVIDIA H100 80GB HBM3")
    assert h100 == {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}
    assert peaks.peak("cpu") is None
