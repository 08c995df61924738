"""serving.sync_ms_step: the wall of the program's `sync` spans (each a
host wait on the card: a device-to-host read or a blocking upload) under
its `sptc.serve.*` spans (`screenpressor_tpu_torch/parallel/serving.py`)
in the traced steps, over those steps, in ms. None for a port without
`screenpressor_tpu_torch.telemetry`."""


def read(drv, trace, ctx):
    try:
        from screenpressor_tpu_torch import telemetry
    except ImportError:
        return None
    units = {u["step"] for u in drv.units if u["traced"]}
    ns = sum(s.end_ns - s.start_ns for s in telemetry.syncs("sptc.serve.", units))
    return ns / 1e6 / len(units) if trace is not None and units and ns else None
