"""pframe.resolve.launches: the profiler's host kernel-launch calls
(cudaLaunchKernel and kin) that start inside the program's spans
`sptc.pframe.resolve` (`decode_p_resolve_streams` in `rebuild_p_streams`,
`screenpressor_tpu_torch/pframe.py`) in the traced batches, over those
spans: launches a resolve call. Spans and the trace's host events share
the profiler's clock. None on the CPU and for a port without
`screenpressor_tpu_torch.telemetry`."""

import numpy as np

LAUNCH = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
          "cudaLaunchCooperativeKernel"}


def read(drv, trace, ctx):
    if trace is None or not ctx.cuda:
        return None
    try:
        from screenpressor_tpu_torch import telemetry
    except ImportError:
        return None
    units = {u["batch"] * drv.n for u in drv.units if u["traced"]}
    spans = [s for s in telemetry.spans() if s.name == "sptc.pframe.resolve" and s.unit in units]
    at = trace.cpu_start[np.array([n in LAUNCH for n in trace.cpu_name], bool)]
    n = sum(int(((at >= s.start_ns * 1e-9) & (at < s.end_ns * 1e-9)).sum()) for s in spans)
    return n / len(spans) if spans and n else None
