"""coder.window.k1k2_roofline: K1 and K2 on the window path
(`serve_windowed`) together as a share of their roofline: the least time
to encode the sections of the steps begun in the trace and to decode those
of the traced steps, once each (spbench/work/roofline.py, counted from the
payloads), over K1's and K2's summed device time in the harness's window,
in %. The steps begun in the trace are the traced ones and the window
begun before the last traced one was served, whose K1 launches the trace
holds too. The capacity-sized K1 launches read as the work their bytes
need."""

from spbench.work.roofline import least_seconds, sections_work


def read(drv, trace, ctx):
    if trace is None or not ctx.cuda or not hasattr(drv, "begun_traced_payloads"):
        return None
    t = (trace.device_seconds("window", "encode_kernel")
         + trace.device_seconds("window", "decode_kernel"))
    if t <= 0:
        return None
    enc_bytes, enc_ops = sections_work(drv.begun_traced_payloads())
    dec_bytes, dec_ops = sections_work(drv.traced_payloads())
    return 100 * least_seconds(enc_bytes + dec_bytes, enc_ops + dec_ops) / t
