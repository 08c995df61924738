"""`correct` on the CPU at a test size: sound runs come out true; the
control (the program's own lower-precision path, loss 1) and each fault
planted under the timed path come out false. The card-marked cases run
the same at the same size on a CUDA card."""

import pytest

from spbench import run as R

# an 8-frame keyframe interval puts the reference's second stretch in the
# window, across a batch's end
DESKTOP = {"width": 176, "height": 96, "batch_frames": 6, "codec": {"kf_interval": 8, "loss": 0}}
SMALL = {
    "desktop-1080p-rgb32.browse": DESKTOP,
    "desktop-1080p-rgb32.pages": DESKTOP,
    # a 12-step keyframe interval puts keyframes of every stream in a short window
    "conf-64x360p.staggered": {"width": 192, "height": 96, "streams": 4,
                               "codec": {"kf_interval": 12, "loss": 0, "k_fixed": 8}},
}
FAULTS = ["stale_state", "half_batch", "altered_token"]


def one(cell, devices, **kw):
    return R.run(cell, 2**31 + 99, 2.0, False, devices=devices, config_override=SMALL[cell], **kw)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    res = one(cell, ["cpu"])
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "compared"


@pytest.mark.parametrize("cell", ["desktop-1080p-rgb32.browse", "desktop-1080p-rgb32.pages"])
def test_reference_decodes_from_a_later_keyframe(cell, capsys):
    """The reference's stretches start at the session's first keyframe and
    at the next one (frame 8 here), inside the window and across a batch's
    end."""
    res = one(cell, ["cpu"])
    assert res["correct"], res["compared"]
    n, kf = res["attempted"], SMALL[cell]["codec"]["kf_interval"]
    assert n > kf
    counts = R.load_cell(cell)[3]["reference_frames"]
    want = sum(min(c, n - k * kf) for k, c in enumerate(counts) if k * kf < n)
    assert f"the reference decoded {want} frames" in capsys.readouterr().err


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct(cell):
    res = one(cell, ["cpu"], control=True)
    assert not res["correct"]
    assert res["compared"]["frames_decoded_wrong"]["value"] > 0


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_is_not_correct(cell, fault):
    assert not one(cell, ["cpu"], fault=fault)["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_on_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert one(cell, ["cuda:0"])["correct"]
    assert not one(cell, ["cuda:0"], control=True)["correct"]
