"""api.decode.convert_ms_frame: the wall of the program's span
`sptc.api.decode.convert` (`Decoder.decode_batch` converting the decoded
RGB24 frames to the caller's format, `screenpressor_tpu_torch/api.py`) in
the traced batches, over their frames, in ms. None for a port without
`screenpressor_tpu_torch.telemetry`."""


def read(drv, trace, ctx):
    try:
        from screenpressor_tpu_torch import telemetry
    except ImportError:
        return None
    units = {u["batch"] * drv.n for u in drv.units if u["traced"]}
    frames = sum(len(u["payloads"]) for u in drv.units if u["traced"])
    row = telemetry.summary(units).get("sptc.api.decode.convert")
    return row["wall_ns"] / 1e6 / frames if trace is not None and row and frames else None
