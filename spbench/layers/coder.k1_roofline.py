"""coder.k1_roofline: K1 (`encode_kernel`, csrc/sections.cu) as a share of
its roofline: the least time the traced batches' sections need (bytes
and operations the format fixes, spbench/work/roofline.py) over K1's
summed device time in the traced `Encoder.encode_batch` calls, in %."""

from spbench.work.roofline import least_seconds, sections_work


def read(drv, trace, ctx):
    if trace is None or not ctx.cuda:
        return None
    t = trace.device_seconds("Encoder.encode_batch", "encode_kernel")
    if t <= 0:
        return None
    return 100 * least_seconds(*sections_work(drv.traced_payloads())) / t
