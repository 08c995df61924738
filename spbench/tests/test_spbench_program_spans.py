"""The per-layer metrics that read the program's own spans and counters
(`screenpressor_tpu_torch.telemetry`): a traced CPU run of each cell, at
the sizes of test_spbench_imports.py, gives each of them a number
(`pframe.resolve.launches` reads the card's launch calls: none on the
CPU)."""

import pytest

from spbench import run as R

SMALL = {
    "desktop-1080p-rgb32.browse": {"width": 176, "height": 96, "batch_frames": 4},
    "desktop-1080p-rgb32.pages": {"width": 176, "height": 96, "batch_frames": 4},
    "conf-64x360p.staggered": {"width": 192, "height": 96, "streams": 2},
}
NEW = {
    "desktop-1080p-rgb32.browse": ["api.encode.convert_ms_frame", "api.decode.convert_ms_frame",
                                   "codec.decode.pull_ms_frame", "codec.decode.syncs_frame"],
    "conf-64x360p.staggered": ["serving.encode.host_ms_step", "serving.decode.host_ms_step",
                               "serving.sync_ms_step"],
}
NEW["desktop-1080p-rgb32.pages"] = NEW["desktop-1080p-rgb32.browse"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_run_reads_program_spans(cell):
    from screenpressor_tpu_torch import telemetry

    telemetry.reset()  # spans of an earlier run in this process share its units
    res = R.run(cell, 2**31 + 17, 2.0, True, devices=["cpu"], config_override=SMALL[cell])
    assert res["correct"], res["compared"]
    for name in NEW[cell]:
        v = res["metrics"][name]["value"]
        assert isinstance(v, float) and v >= 0, (name, v)
    assert "pframe.resolve.launches" not in res["metrics"]
    assert res["metrics"][NEW[cell][0]]["value"] > 0
    assert telemetry.spans(), "the traced window recorded no program span"
