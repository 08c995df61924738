"""device.serve.card_idle_max: the highest of the cards' idle shares over
the traced steps: per card, 1 minus the union of its kernel and copy
intervals over the traced steps' wall."""


def read(drv, trace, ctx):
    if trace is None or not ctx.cuda:
        return None
    shares = [trace.idle_share("window", [d]) for d in range(len(ctx.devices))]
    return None if None in shares else max(shares)
