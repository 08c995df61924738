"""Damaged streams through the port's decoders on the CPU: one-byte
corruptions and truncations of a 6-frame 48x64 synth_screencast stream.
The port's verdict (CorruptStreamError or success) equals jx's on every
payload, nothing else is raised (no index leaves its tensor: the error word
decides, as in jx), where jx, the port and the numpy spec decoder all accept
the pixels are equal, and a failed batch leaves the session as it was.
Fixed flips (torch_support.INDEX_SITE_FLIPS) reach the index sites that
raised IndexError before the error word decided."""

import numpy as np
import pytest

from screenpressor_tpu.bitstream import CorruptStreamError as RefCorrupt
from screenpressor_tpu.config import CodecConfig as RefCodecConfig
from screenpressor_tpu.jx.codec import JaxDecoder
from screenpressor_tpu.spec.codec import SpecDecoder
from screenpressor_tpu_torch import TorchDecoder, TorchEncoder
from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch.parallel.serving import BatchedDecoder, BatchedEncoder

from tests.torch_support import (INDEX_SITE_FLIPS, SERVING_SITE_FLIPS, corrupt_payloads, flip,
                                 record_index_sites)
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)

CFG, FRAMES, PAYLOADS, DAMAGED = corrupt_payloads()
REF_CFG = RefCodecConfig(width=CFG.width, height=CFG.height)


def _verdict(dec, data):
    """Decode data after the clean frames before it -> (verdict, frame)."""
    try:
        out = dec.decode_batch([data])[0]
    except (bs.CorruptStreamError, RefCorrupt):
        return "corrupt", None
    return "ok", np.asarray(out)


def _spec_verdict(i, data):
    dec = SpecDecoder(REF_CFG)
    try:
        for p in PAYLOADS[:i]:
            dec.decode(p)
        return "ok", dec.decode(data)
    except Exception:  # the spec decoder fails on damage with what it hits
        return "corrupt", None


@pytest.mark.parametrize("damage", ["flip", "truncate", "index_sites"])
def test_verdicts_match_jx(damage, monkeypatch):
    n_sites = len(INDEX_SITE_FLIPS)
    cases = {"flip": DAMAGED[:40], "truncate": DAMAGED[40:-n_sites],
             "index_sites": DAMAGED[-n_sites:]}[damage]
    hits = record_index_sites(monkeypatch)
    key = TorchEncoder(CFG, "cpu").encode(FRAMES[2], force_key=True)[0]
    verdicts, sites = set(), set()
    for c, (i, data) in enumerate(cases):
        tdec, jdec = TorchDecoder(CFG, "cpu"), JaxDecoder(REF_CFG)
        tdec.decode_batch(PAYLOADS[:i])
        jdec.decode_batch(PAYLOADS[:i])
        before = (tdec.prev, tdec.tables, tdec.last_was_flat, tdec.last_flat_color)
        hits.clear()
        got, frame = _verdict(tdec, data)
        want, ref = _verdict(jdec, data)
        if damage == "index_sites":
            assert hits, f"case {c} reaches no index site"
            sites |= hits
        assert got == want, f"case {c} (frame {i}): port {got}, jx {want}"
        verdicts.add(got)
        if got == "ok":
            if _spec_verdict(i, data)[0] == "ok":
                np.testing.assert_array_equal(frame, ref, err_msg=f"case {c}")
            continue
        after = (tdec.prev, tdec.tables, tdec.last_was_flat, tdec.last_flat_color)
        assert all(a is b for a, b in zip(after[:2], before[:2])) and after[2:] == before[2:], (
            f"case {c}: a failed batch advanced the session")
        np.testing.assert_array_equal(tdec.decode(key), FRAMES[2])
    assert "corrupt" in verdicts
    assert damage != "index_sites" or sites == {"slots", "grid"}


def test_batched_decoder_step_with_one_corrupt_stream(monkeypatch):
    """Stream 1 of 4 gets a damaged typing P frame: the step decodes or
    raises CorruptStreamError (never an index error, some through the
    device error word, among them the SERVING_SITE_FLIPS at both index
    sites), and after a failed step a keyframe step decodes losslessly."""
    cfg = CFG.__class__(width=CFG.width, height=CFG.height, k_fixed=8)
    _, frames, _, damaged = corrupt_payloads(seed=8, k_fixed=8)
    enc = BatchedEncoder(4, cfg, "cpu")
    steps = [[p for p, _ in enc.encode(np.stack([f] * 4))] for f in frames[:3]]
    sites = [(2, flip(steps[2][1], pos, x)) for pos, x in SERVING_SITE_FLIPS]
    hits = record_index_sites(monkeypatch)
    from_err_word, reached = 0, set()
    for c, (i, data) in enumerate(damaged[:12] + sites):
        assert i == 2
        dec = BatchedDecoder(4, cfg, "cpu")
        for step in steps[:2]:
            dec.decode(step)
        hits.clear()
        try:
            dec.decode([steps[2][0], data, steps[2][2], steps[2][3]])
        except bs.CorruptStreamError as e:
            from_err_word += str(e).startswith("stream 1: ")
            key = BatchedEncoder(4, cfg, "cpu").encode(np.stack([frames[2]] * 4))
            np.testing.assert_array_equal(dec.decode([p for p, _ in key]),
                                          np.stack([frames[2]] * 4))
        if c >= 12:
            assert hits, f"serving site flip {c - 12} reaches no index site"
            reached |= hits
    assert from_err_word, "no damaged payload reached the device error word"
    assert reached == {"slots", "grid"}
