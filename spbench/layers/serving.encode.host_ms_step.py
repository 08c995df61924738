"""serving.encode.host_ms_step: the wall of the program's spans
`sptc.serve.encode_begin` and `sptc.serve.encode_finish` (`BatchedEncoder`,
`screenpressor_tpu_torch/parallel/serving.py`) minus their `sync`
descendants (the host's waits on the card), in the traced steps, over
those steps, in ms. None for a port without
`screenpressor_tpu_torch.telemetry`."""


def read(drv, trace, ctx):
    try:
        from screenpressor_tpu_torch import telemetry
    except ImportError:
        return None
    units = {u["step"] for u in drv.units if u["traced"]}
    rows = telemetry.summary(units)
    ns = sum(rows[n]["wall_ns"] - rows[n]["sync_ns"]
             for n in ("sptc.serve.encode_begin", "sptc.serve.encode_finish") if n in rows)
    return ns / 1e6 / len(units) if trace is not None and units and ns else None
