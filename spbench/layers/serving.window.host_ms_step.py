"""serving.window.host_ms_step: the wall of the program's window spans
`sptc.serve.window.begin`, `sptc.serve.window.finish` and
`sptc.serve.window.decode` (`screenpressor_tpu_torch/parallel/
serve_scan.py`, each carrying its window's first step) minus their `sync`
descendants (the host's waits on the card), in the traced steps, over
those steps, in ms. None for a port without those spans."""

SPANS = ("sptc.serve.window.begin", "sptc.serve.window.finish", "sptc.serve.window.decode")


def read(drv, trace, ctx):
    try:
        from screenpressor_tpu_torch import telemetry
    except ImportError:
        return None
    units = {u["step"] for u in drv.units if u["traced"]}
    rows = telemetry.summary(units)
    if trace is None or not units or not any(n in rows for n in SPANS):
        return None
    ns = sum(rows[n]["wall_ns"] - rows[n]["sync_ns"] for n in SPANS if n in rows)
    return ns / 1e6 / len(units)
