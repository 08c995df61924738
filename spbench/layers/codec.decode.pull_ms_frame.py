"""codec.decode.pull_ms_frame: the wall of the program's span
`sptc.codec.decode.pull` (`TorchDecoder.decode_batch` copying each decoded
frame to the host, `screenpressor_tpu_torch/codec.py`) in the traced
batches, over their frames, in ms. None for a port without
`screenpressor_tpu_torch.telemetry`."""


def read(drv, trace, ctx):
    try:
        from screenpressor_tpu_torch import telemetry
    except ImportError:
        return None
    units = {u["batch"] * drv.n for u in drv.units if u["traced"]}
    frames = sum(len(u["payloads"]) for u in drv.units if u["traced"])
    row = telemetry.summary(units).get("sptc.codec.decode.pull")
    return row["wall_ns"] / 1e6 / frames if trace is not None and row and frames else None
