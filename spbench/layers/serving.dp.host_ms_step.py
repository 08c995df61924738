"""serving.dp.host_ms_step: the wall of the program's `sptc.serve.group`
spans (one a stream group and half of a step of a `devices=` split,
`screenpressor_tpu_torch/parallel/serving.py`) minus their `sync`
descendants (the host's waits on the cards), summed over the cards, in
the traced steps, over those steps, in ms. None for a port without those
spans."""


def read(drv, trace, ctx):
    try:
        from screenpressor_tpu_torch import telemetry
    except ImportError:
        return None
    units = {u["step"] for u in drv.units if u["traced"]}
    row = telemetry.summary(units).get("sptc.serve.group")
    if trace is None or not units or not row:
        return None
    return (row["wall_ns"] - row["sync_ns"]) / 1e6 / len(units)
