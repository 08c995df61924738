"""api.encode.host_share: the share of `Encoder.encode_batch`'s wall that
lies outside its `TorchEncoder.encode_batch` call (the session API's
pixel-format conversion, format prefix and bookkeeping), over the traced
batches. From the harness's spans around both calls."""


def read(drv, trace, ctx):
    if trace is None:
        return None
    outer = trace.span_seconds("Encoder.encode_batch")
    inner = trace.span_seconds("TorchEncoder.encode_batch")
    return (outer - inner) / outer if outer > 0 and inner > 0 else None
