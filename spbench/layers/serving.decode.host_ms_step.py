"""serving.decode.host_ms_step: the wall of the program's span
`sptc.serve.decode` (`BatchedDecoder.decode`,
`screenpressor_tpu_torch/parallel/serving.py`) minus its `sync`
descendants (the host's waits on the card), in the traced steps, over
those steps, in ms. None for a port without
`screenpressor_tpu_torch.telemetry`."""


def read(drv, trace, ctx):
    try:
        from screenpressor_tpu_torch import telemetry
    except ImportError:
        return None
    units = {u["step"] for u in drv.units if u["traced"]}
    row = telemetry.summary(units).get("sptc.serve.decode")
    if trace is None or not units or not row:
        return None
    return (row["wall_ns"] - row["sync_ns"]) / 1e6 / len(units)
