"""codec.decode.kernels_per_frame: device kernels (copies and fills not
counted) that start inside the traced `Decoder.decode_batch` calls, over
the frames those calls decoded."""


def read(drv, trace, ctx):
    if trace is None or not ctx.cuda:
        return None
    frames = sum(len(u["payloads"]) for u in drv.units if u["traced"])
    n = int(trace.within("Decoder.decode_batch", kernels_only=True).sum())
    return n / frames if frames and n else None
