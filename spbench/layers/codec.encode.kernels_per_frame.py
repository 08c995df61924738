"""codec.encode.kernels_per_frame: device kernels (copies and fills not
counted) that start inside the traced `Encoder.encode_batch` calls, over
the frames those calls encoded."""


def read(drv, trace, ctx):
    if trace is None or not ctx.cuda:
        return None
    frames = sum(len(u["payloads"]) for u in drv.units if u["traced"])
    n = int(trace.within("Encoder.encode_batch", kernels_only=True).sum())
    return n / frames if frames and n else None
