"""Kernel E (value only, bf16): the larger of conv2..conv4_2's
operations at the bf16 peak and its bytes at the HBM rate, over the
profiler time of its kernels (convs, pools and the metrics through D),
per launch, in percent.  A launch holds three max-pools."""
from portbench.yardstick import (
    HBM, PEAK_BF16, kernel, peak, vggish_trunk_cost,
)

_E = ("conv3x3_wgmma_kernel", "conv3x3_kernel", "maxpool2_kernel",
      "unpool2_kernel", "nm_forward_kernel", "nm_backward_kernel")


def read(ctx):
    pools, _ = kernel(ctx, "maxpool2_kernel")
    _, secs = kernel(ctx, *_E)
    kind = ctx.get("device_kind", "")
    flops_peak, hbm = peak(PEAK_BF16, kind), peak(HBM, kind)
    if pools < 3 or secs <= 0 or not flops_peak:
        return None
    mix, model = ctx["cell"].traffic, ctx["cell"].config["model"]
    cost = vggish_trunk_cost(mix["batch_size"], model["image_size"])
    bound = max(cost["flops"] / flops_peak, cost["bytes"] / hbm)
    return 100.0 * (pools / 3) * bound / secs
