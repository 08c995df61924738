"""The roofline arithmetic against hand counts on a tiny stream."""

import pytest

from spbench.reference import sptc
from spbench.work import roofline


def tiny_payloads():
    from screenpressor_tpu_torch import CodecConfig, Encoder, FormatParams, PixelFormat

    from spbench.generators.screen import Screen
    from spbench_support import traffic

    s = Screen(traffic("browse"), 96, 160, 4)
    enc = Encoder(CodecConfig(width=160, height=96), FormatParams(PixelFormat.RGB32), device="cpu")
    return [p for p, _ in enc.encode_batch([s.frame_rgb32(i) for i in range(6)])], s


def test_sections_hand_count():
    pays, _ = tiny_payloads()
    key = pays[0]
    assert key[0] & 0x0F == 5  # the RGB32 format prefix
    (n_rec, n_lit), pos = sptc.read_varints(key, 3, 2)
    k_rec, k_lit = sptc.lane_count(n_rec), sptc.lane_count(n_lit)
    sizes_rec, _, pos = sptc.unpack_section(key, pos, k_rec)
    sizes_lit, _, _ = sptc.unpack_section(key, pos, k_lit)
    assert roofline.sections(key) == [("rec", n_rec, int(sizes_rec.sum())),
                                      ("col", n_lit, int(sizes_lit.sum()))]
    nbytes, nops = roofline.sections_work([key])
    assert nbytes == int(sizes_rec.sum()) + int(sizes_lit.sum()) + 2 * n_rec + 3 * n_lit
    assert nops == n_rec * (6 + 256) + n_lit * 3 * 256
    # a no-change P frame codes nothing
    assert roofline.sections(bytes([0xA3, 0])) == []
    p = [q for q in pays[1:] if len(q) > 2][0]
    kinds = [k for k, _, _ in roofline.sections(p)]
    assert kinds == ["bt", "sxy", "mv", "rec", "col"]


def test_analysis_hand_count():
    nbytes, nops = roofline.analysis_work(2, 32, 48)
    assert nbytes == 2 * (2 * 3 * 32 * 48 + 10 * 2 * 3)
    assert nops == 2 * 3 * 32 * 48
    assert roofline.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)


def test_is_p():
    assert roofline.is_p(bytes([0xA3, 0]))
    assert not roofline.is_p(bytes([0xA2, 0]))
    assert not roofline.is_p(b"")
