"""serving.window.sync_ms_step: the wall of the program's `sync` spans
(each a host wait on the card: a device-to-host read or a blocking upload)
under its window spans `sptc.serve.window.*` (`screenpressor_tpu_torch/
parallel/serve_scan.py`), in the traced steps, over those steps, in ms.
None for a port without those spans."""


def read(drv, trace, ctx):
    try:
        from screenpressor_tpu_torch import telemetry
    except ImportError:
        return None
    units = {u["step"] for u in drv.units if u["traced"]}
    if trace is None or not units or "sptc.serve.window.begin" not in telemetry.summary(units):
        return None
    ns = sum(s.end_ns - s.start_ns for s in telemetry.syncs("sptc.serve.window.", units))
    return ns / 1e6 / len(units)
