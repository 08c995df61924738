"""codec.decode.syncs_frame: the program's host syncs (`telemetry.sync`
spans: blocking uploads and device-to-host reads) under its span
`sptc.codec.decode` (`TorchDecoder.decode_batch`) in the traced batches,
over their frames. None for a port without
`screenpressor_tpu_torch.telemetry`."""


def read(drv, trace, ctx):
    try:
        from screenpressor_tpu_torch import telemetry
    except ImportError:
        return None
    units = {u["batch"] * drv.n for u in drv.units if u["traced"]}
    frames = sum(len(u["payloads"]) for u in drv.units if u["traced"])
    n = len(telemetry.syncs("sptc.codec.decode", units))
    return n / frames if trace is not None and frames else None
