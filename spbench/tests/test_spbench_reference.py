"""The plain reference decoder against streams the port encodes on the
CPU: it gives back every input frame, and a damaged payload does not."""

import numpy as np
import pytest
from spbench_support import traffic

from spbench.reference.sptc import CorruptStreamError, StreamDecoder
from spbench.generators.screen import Screen


@pytest.mark.parametrize("mix", ["browse", "pages"])
def test_session_stream(mix):
    from screenpressor_tpu_torch import CodecConfig, Encoder, FormatParams, PixelFormat

    s = Screen(traffic(mix), 96, 176, 11)
    enc = Encoder(CodecConfig(width=176, height=96, kf_interval=7),
                  FormatParams(PixelFormat.RGB32), device="cpu")
    frames = [s.frame_rgb32(i) for i in range(10)]
    pays = [p for p, _ in enc.encode_batch(frames)]
    ref = StreamDecoder(96, 176)
    for i, p in enumerate(pays):
        assert np.array_equal(ref.decode(p), frames[i][..., :3]), i
        assert ref.bpp == 32


def test_serving_streams_fixed_lanes():
    from screenpressor_tpu_torch import CodecConfig
    from screenpressor_tpu_torch.parallel.serving import BatchedEncoder

    s = Screen(traffic("staggered"), 96, 192, 5)
    cfg = CodecConfig(width=192, height=96, kf_interval=4, k_fixed=8)
    enc = BatchedEncoder(3, cfg, "cpu", kf_offsets=[0, 1, 2])
    refs = [StreamDecoder(96, 192, 8) for _ in range(3)]
    cols = s.stream_cols(3)
    for t in range(7):
        frames = np.stack([s.frame(t)[:, cols[k]] for k in range(3)])
        for k, (p, _) in enumerate(enc.encode(frames)):
            assert np.array_equal(refs[k].decode(p), frames[k]), (t, k)


def test_damaged_payload_is_caught():
    from screenpressor_tpu_torch import CodecConfig, Encoder

    s = Screen(traffic("browse"), 96, 176, 2)
    enc = Encoder(CodecConfig(width=176, height=96), device="cpu")
    frames = [s.frame(i) for i in range(3)]
    pays = [p for p, _ in enc.encode_batch(frames)]
    ref = StreamDecoder(96, 176)
    ref.decode(pays[0])
    bad = bytearray(pays[1])
    bad[len(bad) // 2] ^= 0x5A
    try:
        out = ref.decode(bytes(bad))
    except CorruptStreamError:
        return
    assert not np.array_equal(out, frames[1])
