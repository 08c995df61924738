"""device.serve.idle: 1 minus the union of each card's kernel and copy
intervals over the traced steps' wall, the mean of the cards."""


def read(drv, trace, ctx):
    if trace is None or not ctx.cuda:
        return None
    return trace.idle_share("window", list(range(len(ctx.devices))))
