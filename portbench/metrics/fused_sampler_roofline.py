"""Kernel A (``kernel_a``, one launch of the fused sampler): the larger of
its operations at the bf16 peak and its bytes at the HBM rate (each
launch's ``flops`` and ``bytes``, from ``trajectory_cost``), over the
launches' CUDA event intervals on the stream, in percent; from the
program's own spans."""
from portbench.program import spans
from portbench.yardstick import HBM, PEAK_BF16, peak


def read(ctx):
    kind = ctx.get("device_kind", "")
    flops, hbm = peak(PEAK_BF16, kind), peak(HBM, kind)
    launches = [r for r in spans(ctx, "kernel_a") if r.device_ms]
    if not launches or not flops or not hbm:
        return None
    bound = sum(max(r.attrs["flops"] / flops, r.attrs["bytes"] / hbm)
                for r in launches)
    return 100.0 * bound / (1e-3 * sum(r.device_ms for r in launches))
