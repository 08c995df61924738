"""The port's row-sharded mesh (screenpressor_tpu_torch/parallel/mesh.py) on
the CPU against the JAX package, tolerance 0: the dp x sp analysis step,
the chunk compaction, the fixed-capacity device encode step and the dryrun
step against `screenpressor_tpu.parallel.mesh` on the 8 virtual CPU devices
of tests/conftest.py; the sp I / P encodes and decodes against the
unsharded jx `Encoder` / `Decoder` (bytes, pixels, every table tensor). The
port's meshes are `["cpu"] * n`, so every kernel takes its plain version.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_mesh.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synth_frame
from screenpressor_tpu.api import Decoder as JaxDecoder
from screenpressor_tpu.api import Encoder as JaxEncoder
from screenpressor_tpu.config import CodecConfig as JaxConfig
from screenpressor_tpu.jx.tables import renew_tables as jax_renew_tables
from screenpressor_tpu.parallel import mesh as jm
from screenpressor_tpu_torch import TorchDecoder, TorchEncoder
from screenpressor_tpu_torch import bitstream as bs
from screenpressor_tpu_torch.convert import tables_from_jax, tables_to_numpy
from screenpressor_tpu_torch.parallel import mesh as tm
from screenpressor_tpu_torch.tables import renew_tables

from tests.test_spec_iframe import synth_desktop
from tests.torch_support import INDEX_SITE_FLIPS, flip, port_config, sp_decode, sp_encode
from tests.torch_support import sp_stage_ms
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")


def cpu_mesh(n, sp):
    return tm.make_mesh(n, sp=sp, devices=["cpu"] * n)


def assert_tables_equal(got, want, what=""):
    got, want = tables_to_numpy(got), tables_to_numpy(want)
    assert got.keys() == want.keys()
    for kd in want:
        for key in want[kd]:
            np.testing.assert_array_equal(got[kd][key], want[kd][key],
                                          err_msg=f"{what} table {kd}.{key}")


def session_frames(h=64, w=64, seed=5):
    """I + scroll (motion blocks) + data blocks with a partial sub-rect +
    no change (the reference's test_sp_encode_p_session_byte_identical)."""
    rng = np.random.default_rng(seed)
    f0 = synth_desktop(h, w, seed=seed)
    f1 = np.roll(f0, 8, axis=0)
    f2 = f1.copy()
    f2[20:27, 30:39] = rng.integers(0, 256, (7, 9, 3))
    f2[40:44, 8:12] = (1, 2, 3)
    return [f0, f1, f2, f2.copy()]


def sp_session(frames, mesh, cfg):
    """encode_i_sp, then encode_p_sp against the previous frame, tables
    chained -> (payloads, ftypes, tables after each frame)."""
    data, ftype, tabs = tm.encode_i_sp(frames[0], mesh, cfg)
    out, types, states = [data], [ftype], [tabs]
    for prev, f in zip(frames, frames[1:]):
        data, ftype, tabs = tm.encode_p_sp(f, prev, mesh, cfg, tabs)
        out.append(data)
        types.append(ftype)
        states.append(tabs)
    return out, types, states


# ---------------------------------------------------------------------------
# The mesh, its seams and the analysis step
# ---------------------------------------------------------------------------


def test_make_mesh_raises_for_missing_cuda_devices():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA devices asked for"):
        tm.make_mesh(have + 1)
    with pytest.raises(ValueError):
        tm.make_mesh(4, sp=3, devices=["cpu"] * 4)
    with pytest.raises(ValueError):
        tm.make_mesh(4, sp=2, devices=["cpu"] * 3)
    mesh = cpu_mesh(8, 2)
    assert mesh.shape == {"dp": 4, "sp": 2} and mesh.home == torch.device("cpu")


def test_collectives():
    xs = [torch.full((2, 3), i) for i in range(1, 4)]
    halos = tm.ppermute_down(xs)
    assert [int(h[0, 0]) for h in halos] == [0, 1, 2]
    assert torch.equal(tm.all_gather(xs, "cpu", dim=1)[1],
                       torch.tensor([1] * 3 + [2] * 3 + [3] * 3))
    assert torch.equal(tm.psum(xs, "cpu"), torch.full((2, 3), 6))


@pytest.mark.parametrize("h, w, sp, want", [
    (1080, 1920, 2, [(0, 544), (544, 1080)]),  # 8-row tiles: 68 + 67 units
    (80, 64, 2, [(0, 48), (48, 80)]),          # 1,024-pixel tiles: 16-row units
    (80, 64, 4, [(0, 32), (32, 48), (48, 64), (64, 80)]),
    (2160, 3840, 4, [(0, 540), (540, 1080), (1080, 1620), (1620, 2160)]),
])
def test_i_seams(h, w, sp, want):
    assert tm.i_seams(h, w, sp) == want


def test_i_seams_refuse_a_frame_too_small():
    with pytest.raises(ValueError, match="seam units"):
        tm.i_seams(32, 64, 4)  # two 16-row units


@pytest.mark.parametrize("loss", [0, 2])
@pytest.mark.parametrize("dp, sp", [(8, 1), (4, 2), (2, 4)])
def test_sharded_analysis_matches_jx(dp, sp, loss):
    s, h, w = 2 * dp, 32, 48
    frames = np.stack([synth_desktop(h, w, seed=i) for i in range(s)])
    prevs = frames.copy()
    prevs[::2] = np.roll(frames[::2], 2, axis=1)
    prevs[1, 30, 5] ^= 1  # a change in the bottom shard only
    want = jm.sharded_analysis_step(jnp.asarray(frames), jnp.asarray(prevs),
                                    jm.make_mesh(8, sp=sp), loss)
    got = tm.sharded_analysis_step(frames, prevs, cpu_mesh(8, sp), loss)
    for g, wnt, name in zip(got, want, ("fits", "changed", "flat")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt), err_msg=name)


def test_sharded_flat_detection_matches_jx():
    s, h, w = 8, 32, 32
    frames = np.stack([np.full((h, w, 3), 10 * i, np.uint8) for i in range(s)])
    frames[3] = synth_desktop(h, w)
    frames[5, 31, 31] = 7  # differs in the bottom shard only
    want = jm.sharded_analysis_step(jnp.asarray(frames), jnp.asarray(frames),
                                    jm.make_mesh(8, sp=2))
    fits, changed, flat = tm.sharded_analysis_step(torch.as_tensor(frames),
                                                   torch.as_tensor(frames), cpu_mesh(8, 2))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(changed.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(fits.numpy(), np.asarray(want[0]))
    assert flat[0] and flat[1] and not flat[3] and not flat[5]


@pytest.mark.parametrize("counts", [[5, 0, 7, 3], [0, 0, 0, 0], [16, 16, 16, 16]])
def test_compact_device_matches_jx(counts):
    rng = np.random.default_rng(sum(counts))
    cap_loc, sp = 16, 4
    stacked = rng.integers(0, 1000, (sp * cap_loc, 3)).astype(np.int32)
    cnt = np.asarray(counts, np.int32)
    for cap in (max(int(cnt.sum()), 1), 64):
        want = jm.compact_device(jnp.asarray(stacked), jnp.asarray(cnt), cap_loc, cap)
        got = tm.compact_device(torch.as_tensor(stacked), torch.as_tensor(cnt), cap_loc, cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The fixed-capacity device encode step and the dryrun step
# ---------------------------------------------------------------------------


def lane_bytes(buf, start):
    buf, start = np.asarray(buf), np.asarray(start)
    return [bytes(buf[j, start[j]:]) for j in range(buf.shape[0])]


def test_device_encode_step_matches_jx():
    """Two chained steps at 16x32, k = 8: each lane's bytes from its start,
    the lane sizes, n_records and every table tensor."""
    h, w, k = 16, 32, 8
    j_tabs, t_tabs = jax_renew_tables(), renew_tables("cpu")
    for seed in (0, 4):
        frame = _synth_frame(h, w, seed=seed)
        j_buf, j_start, j_n, j_tabs = jm.device_encode_step(jnp.asarray(frame), j_tabs, h, w, k)
        t_buf, t_start, t_n, t_tabs = tm.device_encode_step(frame, t_tabs, h, w, k)
        assert lane_bytes(t_buf, t_start) == lane_bytes(j_buf, j_start)
        np.testing.assert_array_equal(t_buf.shape[1] - t_start.numpy(),
                                      np.asarray(j_buf).shape[1] - np.asarray(j_start))
        assert int(t_n) == int(j_n)
        assert_tables_equal(t_tabs, j_tabs, f"seed {seed}")


def test_dryrun_step_matches_jx():
    """The dryrun's sizes (__graft_entry__.dryrun_multichip(8)): dp 4 x sp
    2, 2 streams of 16x32 a dp shard."""
    sp, dp = 2, 4
    s, h, w = 2 * dp, 16, 32
    frames = np.stack([_synth_frame(h, w, seed=i) for i in range(s)])
    prevs = np.roll(frames, 1, axis=1)
    tabs0 = jax.tree.map(lambda a: jnp.broadcast_to(a, (s,) + a.shape), jax_renew_tables())
    (j_fits, j_changed, j_flat), (j_buf, j_start, j_n), j_tabs = jm.dryrun_step(
        jnp.asarray(frames), jnp.asarray(prevs), tabs0, jm.make_mesh(8, sp=sp))
    t_tabs = tables_from_jax(tabs0)
    (fits, changed, flat), (buf, start, n_rec), t_out = tm.dryrun_step(
        frames, prevs, t_tabs, cpu_mesh(8, sp))
    np.testing.assert_array_equal(fits.numpy(), np.asarray(j_fits))
    np.testing.assert_array_equal(changed.numpy(), np.asarray(j_changed))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(j_flat))
    np.testing.assert_array_equal(n_rec.numpy(), np.asarray(j_n))
    for i in range(s):
        assert lane_bytes(buf[i], start[i]) == lane_bytes(j_buf[i], j_start[i]), i
    assert_tables_equal(t_out, j_tabs)
    assert_tables_equal(t_tabs, tabs0)  # the input tables are not written


# ---------------------------------------------------------------------------
# The sp I / P pipelines against the unsharded jx session
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sp", [2, 4])
def test_encode_i_sp_matches_jx_encoder(sp):
    cfg = JaxConfig(width=64, height=64, k_fixed=8)
    frame = synth_desktop(64, 64, seed=3)
    want, _ = JaxEncoder(cfg, backend="jax").encode(frame)
    got, ftype, _ = tm.encode_i_sp(frame, cpu_mesh(sp, sp), port_config(cfg))
    assert ftype == 0 and got == want


def test_encode_i_sp_flat_and_noise_match_jx_encoder():
    h, w = 32, 64
    cfg = JaxConfig(width=w, height=h, k_fixed=8)
    mesh = cpu_mesh(2, 2)
    flat = np.full((h, w, 3), 9, np.uint8)
    got, ftype, tabs = tm.encode_i_sp(flat, mesh, port_config(cfg), tables="caller's")
    assert got == JaxEncoder(cfg, backend="jax").encode(flat)[0] and len(got) == 4
    assert ftype == 0 and tabs == "caller's"
    noise = np.random.default_rng(0).integers(0, 256, (h, w, 3), dtype=np.uint8)
    got, ftype, tabs = tm.encode_i_sp(noise, mesh, port_config(cfg))
    assert got == JaxEncoder(cfg, backend="jax").encode(noise)[0]
    assert got[0] & 0x0F == 4 and ftype == 0  # the raw escape
    assert_tables_equal(tabs, renew_tables("cpu"))


@pytest.mark.parametrize("sp", [2, 4])
def test_encode_i_sp_uneven_seams_match_jx_encoder(sp):
    """80x64: 1,024-pixel tiles of 16 rows; 40- and 20-row shards would
    split tiles (the reference asserts), the port's seams do not."""
    cfg = JaxConfig(width=64, height=80, k_fixed=8)
    frame = synth_desktop(80, 64, seed=9)
    assert len({r1 - r0 for r0, r1 in tm.i_seams(80, 64, sp)}) > 1
    want, _ = JaxEncoder(cfg, backend="jax").encode(frame)
    got, _, _ = tm.encode_i_sp(frame, cpu_mesh(sp, sp), port_config(cfg))
    assert got == want


@pytest.fixture(scope="module")
def jx_session():
    """The 4-frame session through the jx Encoder, its tables after each
    frame, and the jx Decoder's frames and tables after each frame."""
    cfg = JaxConfig(width=64, height=64, k_fixed=8, msr_x=16, msr_y=16)
    frames = session_frames()
    enc, dec = JaxEncoder(cfg, backend="jax"), JaxDecoder(cfg, backend="jax")
    payloads, enc_tabs, dec_out = [], [], []
    for f in frames:
        payloads.append(enc.encode(f))
        enc_tabs.append(tables_to_numpy(enc._session.tables))
        frame = np.asarray(dec.decode(payloads[-1][0]))
        dec_out.append((frame, tables_to_numpy(dec._session.tables)))
    return cfg, frames, payloads, enc_tabs, dec_out


@pytest.mark.parametrize("sp", [1, 2, 4])
def test_sp_session_matches_jx_encoder(jx_session, sp):
    cfg, frames, payloads, enc_tabs, _ = jx_session
    got, types, states = sp_session(frames, cpu_mesh(sp, sp), port_config(cfg))
    assert got == [p for p, _ in payloads]
    assert types == [t for _, t in payloads] == [0, 1, 1, 1]
    assert len(got[3]) == 2  # the no-change frame
    for i, (st, want) in enumerate(zip(states, enc_tabs)):
        assert_tables_equal(st, want, f"frame {i}")


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_black_top_row_data_block_matches_jx_encoder(sp):
    """A data block at block row 0 whose top row holds black (0, 0, 0)
    pixels where neither LEFT nor PREVFRAME fits: the row above is outside
    the frame, so ABOVE / ABOVELEFT / GRADIENT must not count as available
    (the window's zero apron would match black)."""
    h = w = 64
    cfg = JaxConfig(width=w, height=h, k_fixed=8, msr_x=16, msr_y=16)
    f0 = synth_desktop(h, w, seed=4)
    f1 = f0.copy()
    f1[0:16, 16:32] = np.random.default_rng(1).integers(1, 256, (16, 16, 3))
    f1[0, 16:32:3] = 0
    assert not (f0[0, 16:32] == 0).all(-1).any()  # PREVFRAME does not fit
    assert not (f1[0, 15:31:3] == 0).all(-1).any()  # nor LEFT
    enc = JaxEncoder(cfg, backend="jax")
    want = [enc.encode(f) for f in (f0, f1)]
    assert want[1][1] == 1  # a coded P frame
    got, types, states = sp_session([f0, f1], cpu_mesh(sp, sp), port_config(cfg))
    assert got == [p for p, _ in want] and types == [t for _, t in want]
    assert_tables_equal(states[1], enc._session.tables)


@pytest.mark.parametrize("sp", [1, 4])
def test_sp_decode_matches_jx_decoder(jx_session, sp):
    cfg, frames, payloads, _, dec_out = jx_session
    mesh, pcfg = cpu_mesh(sp, sp), port_config(cfg)
    frame, tabs = tm.decode_i_sp(payloads[0][0], mesh, pcfg)
    got = [(frame, tabs)]
    for data, _ in payloads[1:]:
        frame, tabs = tm.decode_p_sp(data, frame, mesh, pcfg, tabs)
        got.append((frame, tabs))
    for i, ((frame, tabs), (want_f, want_t), f) in enumerate(zip(got, dec_out, frames)):
        np.testing.assert_array_equal(frame.numpy(), want_f, err_msg=f"frame {i}")
        np.testing.assert_array_equal(frame.numpy(), f)
        assert_tables_equal(tabs, want_t, f"frame {i}")


def jx_session_of(cfg, frames):
    """The jx Encoder's (payload, ftype) and tables after each frame."""
    enc = JaxEncoder(cfg, backend="jax")
    out, states = [], []
    for f in frames:
        out.append(enc.encode(f))
        states.append(tables_to_numpy(enc._session.tables))
    return out, states


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_session_uneven_shards_match_torch_encoder(sp):
    """80x64 (5 block rows: with sp 4 the last P shard is all padding and
    the I seams are uneven): the sp session's bytes and tables equal the
    unsharded jx Encoder's and the port's unsharded session's, and it
    decodes back."""
    cfg = JaxConfig(width=64, height=80, k_fixed=8, msr_x=16, msr_y=16)
    pcfg = port_config(cfg)
    frames = session_frames(80, 64, seed=2)
    mesh = cpu_mesh(sp, sp)
    got, types, states = sp_session(frames, mesh, pcfg)
    want, want_tabs = jx_session_of(cfg, frames)
    assert list(zip(got, types)) == want
    for i, (st, wt) in enumerate(zip(states, want_tabs)):
        assert_tables_equal(st, wt, f"frame {i}")
    assert got == [p for p, _ in TorchEncoder(pcfg, "cpu").encode_batch(frames)]
    frame, tabs = tm.decode_i_sp(got[0], mesh, pcfg)
    for data, f in zip(got[1:], frames[1:]):
        frame, tabs = tm.decode_p_sp(data, frame, mesh, pcfg, tabs)
        np.testing.assert_array_equal(frame.numpy(), f)


@pytest.mark.parametrize("sp", [2, 4])
def test_encode_p_sp_flat_frame_over_padded_rows(sp):
    """A flat P frame at 80x64, whose last P shards hold padding rows: the
    flat shortcut looks at the frame's rows only. Its bytes equal the jx
    Encoder's and the port's unsharded session's."""
    cfg = JaxConfig(width=64, height=80, k_fixed=8)
    pcfg = port_config(cfg)
    prev = synth_desktop(80, 64, seed=1)
    flat = np.full((80, 64, 3), (7, 8, 9), np.uint8)
    got, ftype, tabs = tm.encode_p_sp(flat, prev, cpu_mesh(sp, sp), pcfg, "caller's")
    want = jx_session_of(cfg, [prev, flat])[0][1]
    assert (got, ftype) == want and len(got) == 4 and tabs == "caller's"
    assert want == TorchEncoder(pcfg, "cpu").encode_batch([prev, flat])[1]


def test_sp_stages_are_labelled():
    """Each stage of the sp pipelines runs under its own program span
    ("sptc.sp.<stage>", recorded under torch.profiler), which sp_stage_ms
    reads (device times there: 0 on the CPU); the sessions' bytes and
    frames are those of the unprofiled run."""
    from screenpressor_tpu_torch.config import CodecConfig

    cfg = CodecConfig(width=64, height=64, k_fixed=8, msr_x=16, msr_y=16)
    frames = session_frames()
    mesh = cpu_mesh(2, 2)
    (got, dec), stages = sp_stage_ms(
        lambda: (lambda p: (p, sp_decode(p, mesh, cfg)))(sp_encode(frames, mesh, cfg)))
    assert set(stages) == {"classify shard 0", "classify shard 1", "compaction", "sections",
                           "analysis shard 0", "analysis shard 1", "block records",
                           "data blocks shard 0", "data blocks shard 1", "decode"}
    assert [p for p, _ in got] == sp_session(frames, mesh, cfg)[0]
    for f, o in zip(frames, dec):
        np.testing.assert_array_equal(o.numpy(), f)


@pytest.mark.parametrize("site", INDEX_SITE_FLIPS)
def test_damaged_p_frame_verdict_equals_torch_decoder(site):
    """A damaged P payload: decode_p_sp raises the CorruptStreamError that
    the port's session decoder raises on the same stream."""
    from tests.torch_support import corrupt_payloads

    cfg, _frames, payloads, _ = corrupt_payloads(n_flips=0, n_cuts=0)
    i, pos, x = site
    bad = flip(payloads[i], pos, x)
    with pytest.raises(bs.CorruptStreamError) as want:
        TorchDecoder(cfg, "cpu").decode_batch(payloads[:i] + [bad])
    dec = TorchDecoder(cfg, "cpu")
    dec.decode_batch(payloads[:i])
    with pytest.raises(bs.CorruptStreamError) as got:
        tm.decode_p_sp(bad, dec.prev, cpu_mesh(2, 2), cfg, dec.tables)
    assert f"frame {i}: {got.value}" == str(want.value)
