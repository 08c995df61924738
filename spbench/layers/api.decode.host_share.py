"""api.decode.host_share: the share of `Decoder.decode_batch`'s wall that
lies outside its `TorchDecoder.decode_batch` call (the session API's
format prefix and RGB24 to RGB32 conversion), over the traced batches.
From the harness's spans around both calls."""


def read(drv, trace, ctx):
    if trace is None:
        return None
    outer = trace.span_seconds("Decoder.decode_batch")
    inner = trace.span_seconds("TorchDecoder.decode_batch")
    return (outer - inner) / outer if outer > 0 and inner > 0 else None
