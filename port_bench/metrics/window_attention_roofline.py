"""The window-attention kernel's share of its roofline: over the traced
window, the least time its calls need (per call the larger of 4·N²·D
FLOPs a window and head at the bf16 peak and the bytes of q, k, v, the
output and the bias at the memory peak; `port_bench.flops`), over the
device time of the kernels named below. The calls are those the
configuration implies for each forward the window ran."""

from port_bench.metrics_util import kernel_share

KERNELS = ("window_attention_tma_kernel", "window_attention_kernel")


def read(run):
    return kernel_share(run, "window_attention", KERNELS)
