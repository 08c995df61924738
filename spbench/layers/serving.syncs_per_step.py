"""serving.syncs_per_step: the program's host syncs (torch's sync debug
mode, counted over the traced run's whole window; the harness's own
uploads and step-end syncs not counted) over the window's steps."""


def read(drv, trace, ctx):
    if not ctx.cuda or not drv.units:
        return None
    return drv.syncs / len(drv.units)
