"""serving.dp.cross_card_mb_step: the bytes a `devices=` split moved
between devices in the window, the program's counters
`serving.dp.scatter_bytes` (each group's slice of a step's frames) and
`serving.dp.gather_bytes` (the decoded frames gathered onto the first
device), over the window's steps, in MB. None for a port without those
counters."""

KEYS = ("serving.dp.scatter_bytes", "serving.dp.gather_bytes")


def read(drv, trace, ctx):
    before, after = getattr(drv, "window_counts", None) or ({}, {})
    if not drv.units or not all(k in after for k in KEYS):
        return None
    return sum(after[k] - before.get(k, 0) for k in KEYS) / 1e6 / len(drv.units)
