"""device.decode.idle: 1 minus the union of the card's kernel and copy
intervals inside the traced `Decoder.decode_batch` calls, over the calls'
wall."""


def read(drv, trace, ctx):
    if trace is None or not ctx.cuda:
        return None
    return trace.idle_share("Decoder.decode_batch", [0])
