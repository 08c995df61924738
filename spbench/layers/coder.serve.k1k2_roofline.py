"""coder.serve.k1k2_roofline: the stream-batched K1 and K2 together as a
share of their roofline: the least time to encode and to decode the
traced steps' sections once each (spbench/work/roofline.py) over K1's
and K2's summed device time in the traced steps, in %."""

from spbench.work.roofline import least_seconds, sections_work


def read(drv, trace, ctx):
    if trace is None or not ctx.cuda:
        return None
    t = (trace.device_seconds("window", "encode_kernel")
         + trace.device_seconds("window", "decode_kernel"))
    if t <= 0:
        return None
    nbytes, nops = sections_work(drv.traced_payloads())
    return 100 * least_seconds(2 * nbytes, 2 * nops) / t
