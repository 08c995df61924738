"""The port's stream-batched P encode front half on the CPU: the change
analysis, motion search and record compaction of C streams or frames in one
call (blocks.analyze_compact_streams), the classification of all their data
blocks in one (pframe.classify_assemble_streams), coder.deal_streams, and
the two encoder paths that run them (BatchedEncoder._p_stages once a step,
TorchEncoder.encode_batch once a batch). Held to the per-stream functions of
the port and to the reference's _batched_analyze_dense / _batched_analyze /
_batched_classify_eager, BatchedEncoder and JaxEncoder. Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from screenpressor_tpu.config import CodecConfig as RefCodecConfig
from screenpressor_tpu.config import next_pow2
from screenpressor_tpu.jx import pframe as jp
from screenpressor_tpu.jx.codec import JaxEncoder
from screenpressor_tpu.parallel import serving as jserving
from screenpressor_tpu_torch import TorchEncoder
from screenpressor_tpu_torch import blocks as tb
from screenpressor_tpu_torch import codec as tcodec
from screenpressor_tpu_torch import coder as tc
from screenpressor_tpu_torch import pframe as tp
from screenpressor_tpu_torch.config import ALG_FLAT, ALG_I, ALG_P, ALG_RAW
from screenpressor_tpu_torch.convert import tables_to_numpy
from screenpressor_tpu_torch.parallel import serving as ts

from tests.test_batch import H, W, session_frames
from tests.test_serving import staggered_session_batches
from tests.test_spec_iframe import synth_desktop
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_support import port_config

MH, MW, MS, MKF = 49, 67, 6, 8
MIX_OFFSETS = [0, 0, 0, 0, 0, 7]  # stream 5 keyframes at step 1
KINDS = ("idle", "flat", "scroll", "typing", "noise", "edge")


def mixed_batches(steps=6, h=MH, w=MW):
    """Six streams, one of each kind: idle (no change after step 0), flat
    (a flat frame that changes color at step 3), scroll (motion and partial
    blocks), typing (data blocks with literals), full noise after step 0
    (every block changed, no motion match, the raw escape) and edge
    (changes in the partial blocks of the right column and the bottom
    row)."""
    rng = np.random.default_rng(50)
    tall = synth_desktop(h + 3 * steps, w, seed=51)
    idle = synth_desktop(h, w, seed=52)
    typing = synth_desktop(h, w, seed=53)
    edge = synth_desktop(h, w, seed=54)
    batches = []
    for t in range(steps):
        typing, edge = typing.copy(), edge.copy()
        if t:
            y, x = (7 * t) % (h - 6), (11 * t) % (w - 8)
            typing[y:y + 4, x:x + 5] = rng.integers(0, 256, 3)
            edge[(5 * t) % h, w - 1 - t % 3] = rng.integers(0, 256, 3)
            edge[h - 1, (13 * t) % w:(13 * t) % w + 2] = rng.integers(0, 256, 3)
        flat = np.full((h, w, 3), (20, 40, 60) if t < 3 else (70, 10, 5), np.uint8)
        noise = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8) if t
                 else synth_desktop(h, w, seed=55))
        batches.append(np.stack([idle, flat, tall[3 * t:3 * t + h], typing, noise, edge]))
    return batches


CASES = {
    # name: (batches, reference config)
    "staggered": (lambda: staggered_session_batches(4, 32, 48),
                  dict(width=48, height=32, kf_interval=3, k_fixed=8, msr_x=8, msr_y=8)),
    "mixed": (mixed_batches,
              dict(width=MW, height=MH, kf_interval=MKF, k_fixed=8, msr_x=8, msr_y=8)),
    "default_msr": (lambda: mixed_batches(3, 20, 36), dict(width=36, height=20, k_fixed=8)),
}


def _pairs(name):
    """(frames, prevs) [T * S, H, W, 3] of every step after the first, and
    the reference config."""
    make, kw = CASES[name]
    batches = make()
    frames = np.concatenate(batches[1:])
    prevs = np.concatenate(batches[:-1])
    return frames, prevs, RefCodecConfig(**kw)


def _reference_analysis(frames, prevs, cfg, dense):
    cands, cols, rmax, lows = jp._cands_rmax(cfg)
    nbp = next_pow2(cfg.nbx * cfg.nby)
    fn = jserving._batched_analyze_dense if dense else jserving._batched_analyze
    arrs, counts, flat = fn(jnp.asarray(frames), jnp.asarray(prevs), cands, cols,
                            cfg.height, cfg.width, cfg.nby, cfg.nbx, rmax, nbp, cfg.msr_x,
                            cfg.msr_y, lows[0], lows[1])
    return ({k: np.asarray(v) for k, v in arrs.items()}, np.asarray(counts),
            np.asarray(flat))


def _port_analysis(frames, prevs, cfg):
    pcfg = port_config(cfg)
    cands = torch.tensor(tb.mv_candidates(pcfg), dtype=torch.int32).reshape(-1, 2)
    arrs, counts, flat = tb.analyze_compact_streams(torch.as_tensor(frames),
                                                    torch.as_tensor(prevs), cands, pcfg)
    return {k: v.numpy() for k, v in arrs.items()}, counts.numpy(), flat.numpy(), cands


def _assert_analysis_equal(got, want, tag):
    g_arrs, g_counts, g_flat = got[:3]
    w_arrs, w_counts, w_flat = want
    np.testing.assert_array_equal(g_flat, w_flat, err_msg=f"{tag}: flat")
    for s in range(g_counts.shape[0]):
        if not w_counts[s, 0]:  # no change: the reference skips the compaction
            assert not g_counts[s, 0], f"{tag} stream {s}: change map"
            continue
        np.testing.assert_array_equal(g_counts[s], w_counts[s], err_msg=f"{tag} {s}: counts")
        for name, n in (("bt", w_counts[s, 3]), ("sxy", w_counts[s, 4]),
                        ("mv", w_counts[s, 5]), ("data_rects", w_counts[s, 6])):
            np.testing.assert_array_equal(g_arrs[name][s, :n], w_arrs[name][s, :n],
                                          err_msg=f"{tag} stream {s}: {name}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_analyze_streams_matches_reference(name):
    """analyze_compact_streams over every (frame, prev) pair of a session
    equals the reference's vmapped (_batched_analyze_dense) and mapped
    (_batched_analyze) analyses and the port's per-stream analyze_compact."""
    frames, prevs, cfg = _pairs(name)
    got = _port_analysis(frames, prevs, cfg)
    for dense in (True, False):
        _assert_analysis_equal(got, _reference_analysis(frames, prevs, cfg, dense),
                               f"{name} dense={dense}")
    cands = got[3]
    for s in range(frames.shape[0]):
        arrs, counts, flat = tb.analyze_compact(torch.as_tensor(frames[s]),
                                                torch.as_tensor(prevs[s]), cands,
                                                port_config(cfg))
        one = ({k: v.numpy()[None] for k, v in arrs.items()}, counts.numpy()[None],
               flat.numpy()[None])
        _assert_analysis_equal(
            ({k: v[s:s + 1] for k, v in got[0].items()}, got[1][s:s + 1], got[2][s:s + 1]),
            one, f"{name} per-stream {s}")
    if name == "mixed":  # the fixture keeps each kind of stream it names
        counts = got[1].reshape(-1, MS, 7)
        flat = got[2].reshape(-1, MS, 4)
        assert not counts[:, KINDS.index("idle"), 0].any()
        assert flat[:, KINDS.index("flat"), 0].all()
        assert counts[:, KINDS.index("scroll"), 5].all()  # motion blocks
        assert counts[:, KINDS.index("typing"), 6].all()  # data blocks
        nb = cfg.nbx * cfg.nby
        assert (counts[:, KINDS.index("noise"), 6] == nb).all()
        assert counts[:, KINDS.index("edge"), 4].all()  # partial sub-rects


def _periodic_pair():
    """A 32x48 frame over content of vertical period 4 whose top-left block
    shows the content 2 rows further down: candidates (0, -2) (index 2)
    and (0, 2) (index 3) both match it, (0, -1) and (0, 1) do not; a data
    block below."""
    rng = np.random.default_rng(60)
    prev = synth_desktop(32, 48, seed=61)
    prev[:24] = np.tile(rng.integers(0, 256, (4, 48, 3), dtype=np.uint8), (6, 1, 1))
    cur = prev.copy()
    cur[4:14, 3:13] = prev[6:16, 3:13]
    cur[20:30, 30:40] = rng.integers(0, 256, (10, 10, 3), dtype=np.uint8)
    return cur, prev


@pytest.mark.parametrize("chunk", [1, 2, 3, 5, 7])
def test_motion_first_match_across_chunks(monkeypatch, chunk):
    """With SEARCH_CHUNK small, a block's first match lies past the first
    chunk while a later candidate also matches: the lower index wins, as in
    the reference and the unchunked search."""
    cur, prev = _periodic_pair()
    cfg = RefCodecConfig(width=48, height=32, msr_x=8, msr_y=8)
    pcfg = port_config(cfg)
    cands = torch.tensor(tb.mv_candidates(pcfg), dtype=torch.int32)
    ft, pt = torch.as_tensor(cur)[None], torch.as_tensor(prev)[None]
    changed, rects = tb.change_analysis_streams(ft, pt, cfg.nby, cfg.nbx)
    whole = tb.motion_search_streams_plain(ft, pt, rects, changed, cands)[0]
    x1, y1, x2, y2 = rects[0, 0].tolist()
    for ci in (2, 3):  # both candidates match the moved block
        dx, dy = cands[ci].tolist()
        assert (cur[y1:y2, x1:x2] == prev[y1 + dy:y2 + dy, x1 + dx:x2 + dx]).all()
    for ci in (0, 1):
        dx, dy = cands[ci].tolist()
        assert not (cur[y1:y2, x1:x2] == prev[y1 + dy:y2 + dy, x1 + dx:x2 + dx]).all()
    assert int(whole[0]) == 2
    monkeypatch.setattr(tb, "SEARCH_CHUNK", chunk)
    got = _port_analysis(cur[None], prev[None], cfg)
    chunked = tb.motion_search_streams_plain(ft, pt, rects, changed, cands)[0]
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())
    _assert_analysis_equal(got, _reference_analysis(cur[None], prev[None], cfg, True),
                           f"chunk {chunk}")
    assert tuple(got[0]["mv"][0, 0]) == (0, -2)


@pytest.mark.parametrize("cap", [0, 3])
def test_classify_streams_matches_reference(monkeypatch, cap):
    """classify_assemble_streams over the data blocks of the mixed session's
    step 1 (stream 1 is flat; stream 3 is masked out as not owned, as a
    keyframing stream is) equals the reference's _batched_classify_eager
    and the port's per-stream classify_assemble. cap: CLASSIFY_CAP (0 keeps
    the default; 3 splits the blocks into groups across stream bounds)."""
    if cap:
        monkeypatch.setattr(tp, "CLASSIFY_CAP", cap)
    batches = mixed_batches(3)
    cfg = RefCodecConfig(**CASES["mixed"][1])
    frames, prevs = batches[2], batches[1]
    frames[KINDS.index("noise")] = prevs[KINDS.index("noise")]  # keep it small
    frames[KINDS.index("noise"), 3:20, 30:60] = 7
    own = np.ones(MS, bool)
    own[KINDS.index("typing")] = False
    arrs, counts, flat, _ = _port_analysis(frames, prevs, cfg)
    n_data = np.where(own & (counts[:, 0] != 0) & (flat[:, 0] == 0), counts[:, 6], 0)
    assert n_data[KINDS.index("flat")] == 0 and counts[KINDS.index("typing"), 6]
    pix, lit, got_c, bm, off = tp.classify_assemble_streams(
        torch.as_tensor(frames), torch.as_tensor(prevs),
        torch.as_tensor(arrs["data_rects"]), n_data)
    got_c = got_c.numpy()
    w_arrs, w_counts, w_flat = _reference_analysis(frames, prevs, cfg, True)
    w_pix, w_lit, w_c, w_bm = (np.asarray(a) for a in jserving._batched_classify_eager(
        jnp.asarray(frames), jnp.asarray(prevs), jnp.asarray(w_arrs["data_rects"]),
        jnp.asarray(w_counts), jnp.asarray(w_flat), jnp.asarray(own), cfg.height, cfg.width,
        next_pow2(int(n_data.max()))))
    row0 = tc.color_touched_bitmap(torch.zeros((0, 3), dtype=torch.int32), 0).numpy()
    for s in range(MS):
        if not n_data[s]:  # skipped: the reference's zeros; here row 0 alone
            assert got_c[s].tolist() == [0, 0, 1] and row0[0] and row0.sum() == 1
            np.testing.assert_array_equal(bm[s].numpy(), row0)
            continue
        np.testing.assert_array_equal(got_c[s], w_c[s], err_msg=f"stream {s}: counts")
        np.testing.assert_array_equal(bm[s].numpy(), w_bm[s], err_msg=f"stream {s}: bitmap")
        n_pix, n_lit = got_c[s, :2]
        np.testing.assert_array_equal(pix[off[s]:off[s] + n_pix].numpy(), w_pix[s, :n_pix])
        np.testing.assert_array_equal(lit[off[s]:off[s] + n_lit].numpy(), w_lit[s, :n_lit])
        p1, l1, c1 = tp.classify_assemble(torch.as_tensor(frames[s]), torch.as_tensor(prevs[s]),
                                          torch.as_tensor(arrs["data_rects"][s]),
                                          int(n_data[s]))
        np.testing.assert_array_equal(c1.numpy(), got_c[s, :2])
        np.testing.assert_array_equal(p1[:n_pix].numpy(), pix[off[s]:off[s] + n_pix].numpy())
        np.testing.assert_array_equal(l1[:n_lit].numpy(), lit[off[s]:off[s] + n_lit].numpy())
    assert (n_data > 0).sum() >= 3


@pytest.mark.parametrize("k", [4, 8])
def test_deal_streams_matches_deal(k):
    """deal_streams of ragged records equals deal stream by stream, counts
    0, below, at and above k included; the gap rows between streams never
    show."""
    rng = np.random.default_rng(k)
    ns = [0, 3, k, 2 * k + 1, 5 * k - 1]
    offs = np.cumsum([0] + [n + 2 for n in ns[:-1]])
    recs = torch.as_tensor(rng.integers(-9, 99, (int(offs[-1]) + ns[-1] + 2, 3)),
                           dtype=torch.int32)
    t = max(tc.steps_for(n, k) for n in ns)
    got = tc.deal_streams(recs, torch.as_tensor(offs), torch.as_tensor(ns), k, t)
    for j, (o, n) in enumerate(zip(offs, ns)):
        want = tc.deal(recs[o:o + n], n, k, t)
        np.testing.assert_array_equal(got[j].numpy(), want.numpy(), err_msg=f"stream {j}")
        lens = tc.lane_lens(n, k, "cpu")
        steps = torch.arange(t)[:, None]
        assert not got[j][steps >= lens].any()


SESSIONS = {
    # name: (batches, S, config, keyframe offsets, held to the reference's
    # BatchedEncoder too)
    "staggered": (lambda: staggered_session_batches(4, 32, 48), 4, CASES["staggered"][1],
                  [0, 1, 2, 0], True),
    "mixed": (lambda: mixed_batches(5, 33, 50), MS,
              dict(width=50, height=33, kf_interval=MKF, k_fixed=8, msr_x=8, msr_y=8),
              MIX_OFFSETS, False),
}


def _run_session(name):
    """A session through the port's BatchedEncoder (counting its
    stream-form calls a step, with the per-stream P functions banned), the
    reference's BatchedEncoder where the case asks for it, and per-stream
    port TorchEncoder sessions: each step's bytes and tables."""
    make, s, kw, offsets, with_ref = SESSIONS[name]
    mp = pytest.MonkeyPatch()
    calls = []
    for fn in ("analyze_compact_streams", "classify_assemble_streams"):
        real = getattr(ts, fn)

        def counted(*args, _real=real, _fn=fn, **kws):
            calls[-1][_fn] += 1
            return _real(*args, **kws)

        mp.setattr(ts, fn, counted)

    def banned(*args, **kws):
        raise AssertionError("a per-stream P function ran in a serving step")

    for mod, fn in ((tb, "analyze_compact"), (tp, "classify_assemble")):
        mp.setattr(mod, fn, banned)
    cfg = RefCodecConfig(**kw)
    batches = make()
    jenc = jserving.BatchedEncoder(s, cfg, kf_offsets=offsets) if with_ref else None
    enc = ts.BatchedEncoder(s, port_config(cfg), "cpu", kf_offsets=offsets)
    ref, got = [], []
    try:
        for f in batches:
            if jenc is not None:
                ref.append((jenc.encode(f), tables_to_numpy(jenc.tables_b)))
            calls.append({"analyze_compact_streams": 0, "classify_assemble_streams": 0})
            got.append((enc.encode(f), tables_to_numpy(enc.tables_b)))
    finally:
        mp.undo()
    single_cfg = port_config(RefCodecConfig(**{**kw, "kf_interval": 0}))
    singles = []
    for i in range(s):
        e = TorchEncoder(single_cfg, "cpu")
        steps = []
        for t, f in enumerate(batches):
            force = t > 0 and (t + offsets[i]) % kw["kf_interval"] == 0
            steps.append((e.encode(f[i], force_key=force), tables_to_numpy(e.tables)))
        singles.append(steps)
    return ref, got, singles, calls


class _Sessions(dict):
    """Each session run once a process, when a test first asks for it (the
    test workers each run only the sessions of the tests they draw)."""

    def __missing__(self, name):
        self[name] = _run_session(name)
        return self[name]


@pytest.fixture(scope="module")
def sessions():
    return _Sessions()


def test_mixed_session_covers_each_kind(sessions):
    got = sessions["mixed"][1]
    algs = {(t, i): p[0] & 0x0F for t, (outs, _) in enumerate(got)
            for i, (p, _) in enumerate(outs)}
    assert algs[(2, KINDS.index("noise"))] == ALG_RAW
    assert algs[(2, KINDS.index("flat"))] == ALG_FLAT
    assert algs[(2, KINDS.index("scroll"))] == ALG_P
    assert algs[(1, KINDS.index("edge"))] == ALG_I  # a keyframe among P streams
    assert len(got[2][0][KINDS.index("idle")][0]) == 2  # no change


@pytest.mark.parametrize("name,step", [(nm, t) for nm in SESSIONS
                                       for t in range(len(SESSIONS[nm][0]()))])
def test_batched_encoder_matches_reference_and_singles(sessions, name, step):
    """Every stream's bytes and tables after each step equal the stream's
    own TorchEncoder session's and, on the staggered session, the reference
    BatchedEncoder's."""
    ref, got, singles, _ = sessions[name]
    g_outs, g_tabs = got[step]
    for i in range(len(g_outs)):
        if ref:
            assert g_outs[i] == ref[step][0][i], f"step {step} stream {i}: bytes differ from jx"
        assert g_outs[i] == singles[i][step][0], f"step {step} stream {i}: bytes differ"
        for kd in g_tabs:
            for key in g_tabs[kd]:
                if ref:
                    np.testing.assert_array_equal(g_tabs[kd][key], ref[step][1][kd][key],
                                                  err_msg=f"step {step}: {kd}.{key} vs jx")
                np.testing.assert_array_equal(g_tabs[kd][key][i], singles[i][step][1][kd][key],
                                              err_msg=f"step {step} stream {i}: {kd}.{key}")


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_serving_step_call_counts(sessions, name):
    """A serving P step makes one analyze_compact_streams call and at most
    one classify_assemble_streams call; no per-stream analysis or
    classification runs (the session bans them)."""
    calls = sessions[name][3]
    assert calls[0] == {"analyze_compact_streams": 0, "classify_assemble_streams": 0}
    for step in calls[1:]:
        assert step["analyze_compact_streams"] == 1, calls
        assert step["classify_assemble_streams"] <= 1, calls
    assert sum(step["classify_assemble_streams"] for step in calls) >= len(calls) - 2


def test_encode_batch_matches_jx_and_single_frames(monkeypatch):
    """TorchEncoder.encode_batch over a batch with a keyframe mid-batch makes
    one stream-batched analysis and one classification, and its bytes and
    tables equal JaxEncoder.encode_batch's and frame-by-frame encoding's."""
    frames = session_frames(10)  # test_torch_codec's batch: keyframes at 0 and 8
    kw = dict(width=W, height=H, kf_interval=4)
    jenc = JaxEncoder(RefCodecConfig(**kw))
    ref = jenc.encode_batch(frames)
    calls = {"analyze_compact_streams": 0, "classify_assemble_streams": 0}
    for name in calls:
        real = getattr(tcodec, name)

        def counted(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(tcodec, name, counted)
    cfg = port_config(RefCodecConfig(**kw))
    enc = TorchEncoder(cfg, "cpu")
    got = enc.encode_batch(frames)
    assert calls == {"analyze_compact_streams": 1, "classify_assemble_streams": 1}
    one = TorchEncoder(cfg, "cpu")
    singles = [one.encode(f) for f in frames]
    algs = [p[0] & 0x0F for p, _ in ref]
    assert algs[8] == ALG_I and algs[5] == ALG_RAW and algs[4] == ALG_FLAT
    assert len(ref[3][0]) == 2  # idle
    for i, (g, r, s) in enumerate(zip(got, ref, singles)):
        assert g == r, f"frame {i}: bytes differ from jx"
        assert g == s, f"frame {i}: bytes differ from single-frame encoding"
    want, tabs, tabs1 = (tables_to_numpy(t) for t in (jenc.tables, enc.tables, one.tables))
    for kd in want:
        for key in want[kd]:
            np.testing.assert_array_equal(tabs[kd][key], want[kd][key], err_msg=kd)
            np.testing.assert_array_equal(tabs1[kd][key], want[kd][key], err_msg=kd)
