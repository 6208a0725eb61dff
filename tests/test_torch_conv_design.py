"""The dispatch rule of the dense 3³ conv kernel (`csrc/conv3.cu`), on the CPU.

`ops/conv_cuda.py::design` restates the library's `wft_conv3_design` in
Python, so the rule can be held here without nvcc; a card test
(`tests/test_torch_cuda.py::TestConvTmaOnCard::test_design_rule`) holds the
two equal. The rule depends on the dtype, the layout, W and C only:

  bf16, (D, H, W, C), C % 8 == 0   → tma_wgmma_cl (TMA needs 16-byte strides)
  bf16, (D, H, W, C), C % 4 == 0   → halo_mma
  bf16, (D, H, C, W), W % 8 == 0   → tma_wgmma
  everything else                  → plain
"""

import pytest
import torch

from waveformer_tpu_torch.ops import conv_cuda as tcc

# the expected design, written out per (layout, C) and (layout, W)
BF16_DHWC = {4: "halo_mma", 6: "plain", 8: "tma_wgmma_cl", 24: "tma_wgmma_cl",
             48: "tma_wgmma_cl"}
BF16_DHCW = {7: "plain", 8: "tma_wgmma", 16: "tma_wgmma"}


@pytest.mark.parametrize("c", [4, 6, 8, 24, 48])
@pytest.mark.parametrize("w_extent", [7, 8, 16])
@pytest.mark.parametrize("layout", ["dhwc", "dhcw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_design_rule(dtype, layout, w_extent, c):
    code = tcc.DHWC if layout == "dhwc" else tcc.DHCW
    if dtype == torch.float32:
        want = "plain"
    elif layout == "dhwc":
        want = BF16_DHWC[c]
    else:
        want = BF16_DHCW[w_extent]
    assert tcc.design(dtype, code, w_extent, c) == want


def test_designs_are_counted():
    assert tcc.DESIGNS == ("halo_mma", "plain", "tma_wgmma", "tma_wgmma_cl")
    assert set(tcc.design_launches) == set(tcc.DESIGNS)


def test_design_needs_no_library(monkeypatch):
    # the rule is pure Python: it must not load (or build) the kernel library
    def refuse(name):
        raise AssertionError(f"design() loaded the {name} library")

    monkeypatch.setattr(tcc._build.LIBRARIES, "get", refuse)
    assert tcc.design(torch.bfloat16, tcc.DHWC, 128, 96) == "tma_wgmma_cl"
