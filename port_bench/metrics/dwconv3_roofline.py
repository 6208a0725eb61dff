"""The depthwise 3³ stencil kernel's share of its roofline: over the
traced window, the least time its calls need (per call the larger of 54
FLOPs a voxel and channel at the bf16 peak and the bytes of x, the output,
the taps and the bias at the memory peak; `port_bench.flops`), over the
device time of the kernels named below. The calls are those the
configuration implies for each forward the window ran."""

from port_bench.metrics_util import kernel_share

KERNELS = ("dwconv3_ring_kernel", "dwconv3_kernel")


def read(run):
    return kernel_share(run, "dwconv3", KERNELS)
