"""The port's block analysis (blocks.analyze_blocks_streams: change map,
sub-rects, first-match motion search, flat flags; on the CPU its plain
version, analyze_blocks_streams_plain) and the P analysis around it
(blocks.analyze_compact_streams) against the reference's jx.blocks
change_analysis, motion_search and analyze_compact (whose search is
motion_search_pruned), on the fixtures of
torch_support.motion_search_fixtures at msr 8, low 2 (40x56: partial edge
blocks in both directions), whole tensors at tolerance 0; row ranges
against the sp shard composition and, through encode_p_sp, the reference's
mesh bytes. The card's K5 is held to the plain version on the same
fixtures in tests/test_torch_kernels_gpu.py."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from screenpressor_tpu.config import CodecConfig as RefCodecConfig
from screenpressor_tpu.config import next_pow2
from screenpressor_tpu.jx import blocks as jb
from screenpressor_tpu.jx import pframe as jp
from screenpressor_tpu.jx.tables import renew_tables as jax_renew_tables
from screenpressor_tpu.parallel import mesh as jm
from screenpressor_tpu_torch import _build
from screenpressor_tpu_torch import blocks as tb
from screenpressor_tpu_torch import kernels as tk
from screenpressor_tpu_torch.parallel import mesh as tm
from screenpressor_tpu_torch.tables import renew_tables

from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_support import MS_CFG, motion_search_fixtures, port_config

FIXTURES = ("noise", "last", "edges", "streams", "idle", "flat")


@pytest.fixture(scope="module")
def fixtures():
    return motion_search_fixtures()


def _setup():
    cfg = RefCodecConfig(**MS_CFG)
    pcfg = port_config(cfg)
    cands = torch.tensor(tb.mv_candidates(pcfg), dtype=torch.int32).reshape(-1, 2)
    return cfg, pcfg, cands


def _port_choice(frames, prevs, pcfg, cands, fn=tb.analyze_blocks_streams):
    return fn(torch.as_tensor(frames), torch.as_tensor(prevs), cands)[2].numpy()


def _reference_blocks(frame, prev, cfg):
    """jx.blocks.change_analysis and motion_search of one frame -> (changed
    [nb], rects [nb, 4], choice [nb])."""
    h, w, nby, nbx = cfg.height, cfg.width, cfg.nby, cfg.nbx
    changed, rects, in_sub = jb.change_analysis(jnp.asarray(frame), jnp.asarray(prev), h, w,
                                                nby, nbx)
    cands, _cols, rmax, _lows = jp._cands_rmax(cfg)
    choice = jb.motion_search(jnp.asarray(frame), jnp.asarray(prev), rects, in_sub, changed,
                              cands, h, w, nby, nbx, rmax)
    return (np.asarray(changed).reshape(-1), np.asarray(rects).reshape(-1, 4),
            np.asarray(choice).reshape(-1))


def _flat_blocks(frame, nby, nbx):
    """[nb] bool: every in-frame pixel of the block equals pixel (0, 0)."""
    eq = (frame == frame[0, 0]).all(-1)
    return np.array([eq[by * 16:by * 16 + 16, bx * 16:bx * 16 + 16].all()
                     for by in range(nby) for bx in range(nbx)])


@pytest.mark.parametrize("name", FIXTURES)
def test_motion_search_matches_reference(fixtures, name):
    """analyze_blocks_streams over every stream of the fixture in one call
    equals jx.blocks.change_analysis (changed, rects, including the values
    of unchanged blocks) and motion_search (choice) stream by stream, whole
    tensors; its flat flags equal each block's own test and, over the
    frame, analyze_compact's flat word; it gives the choices the fixture
    was built for (an edge candidate found, one past it not)."""
    frames, prevs, expect = fixtures[name]
    cfg, pcfg, cands = _setup()
    changed, rects, got, flat = (a.numpy() for a in tb.analyze_blocks_streams(
        torch.as_tensor(frames), torch.as_tensor(prevs), cands))
    n_cand = cands.shape[0]
    rc, cols, rmax, lows = jp._cands_rmax(cfg)
    for s in range(frames.shape[0]):
        for g, want, what in zip((changed[s], rects[s], got[s]),
                                 _reference_blocks(frames[s], prevs[s], cfg),
                                 ("changed", "rects", "choice")):
            np.testing.assert_array_equal(g, want, err_msg=f"{name} stream {s}: {what}")
        np.testing.assert_array_equal(flat[s], _flat_blocks(frames[s], cfg.nby, cfg.nbx))
        w_flat = jb.analyze_compact(
            jnp.asarray(frames[s]), jnp.asarray(prevs[s]), rc, cols, cfg.height, cfg.width,
            cfg.nby, cfg.nbx, rmax, next_pow2(cfg.nbx * cfg.nby), cfg.msr_x, cfg.msr_y,
            lows[0], lows[1])[2]
        assert bool(flat[s].all()) == bool(np.asarray(w_flat)[0]), (name, s)
    index = {tuple(c): i for i, c in enumerate(cands.tolist())}
    for (s, b), mv in expect.items():
        assert got[s, b] == (n_cand if mv is None else index[tuple(mv)]), (name, s, b, mv)
    if name == "noise":
        assert (got == n_cand).all()
    if name == "idle":
        assert (got == n_cand).all() and not changed.any()
    if name == "flat":
        assert flat[0].all() and flat[1].all() and not flat[2].all()
    if name == "streams":  # the scroll and the moved window resolve by motion
        assert {tuple(cands[c].tolist()) for c in got[2] if c < n_cand} >= {(0, 3), (-2, 1)}


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("name", FIXTURES)
def test_analyze_compact_matches_reference(fixtures, name, dense):
    """analyze_compact_streams over the fixture's streams equals the
    reference's analyze_compact (motion_search_pruned; dense: its
    force_dense tier, as serving runs it) stream by stream: counts, flat
    colour and every record array up to its count."""
    frames, prevs, _ = fixtures[name]
    cfg, pcfg, cands = _setup()
    arrs, counts, flat = tb.analyze_compact_streams(torch.as_tensor(frames),
                                                    torch.as_tensor(prevs), cands, pcfg)
    rc, cols, rmax, lows = jp._cands_rmax(cfg)
    nbp = next_pow2(cfg.nbx * cfg.nby)
    for s in range(frames.shape[0]):
        w_arrs, w_counts, w_flat = jb.analyze_compact(
            jnp.asarray(frames[s]), jnp.asarray(prevs[s]), rc, cols, cfg.height, cfg.width,
            cfg.nby, cfg.nbx, rmax, nbp, cfg.msr_x, cfg.msr_y, lows[0], lows[1], dense)
        w_counts = np.asarray(w_counts)
        np.testing.assert_array_equal(flat[s].numpy(), np.asarray(w_flat))
        np.testing.assert_array_equal(counts[s].numpy(), w_counts, err_msg=f"{name} {s}")
        for nm, col in (("bt", 3), ("sxy", 4), ("mv", 5), ("data_rects", 6)):
            n = w_counts[col]
            np.testing.assert_array_equal(arrs[nm][s, :n].numpy(), np.asarray(w_arrs[nm])[:n],
                                          err_msg=f"{name} stream {s}: {nm}")


@pytest.mark.parametrize("name", FIXTURES)
def test_cpu_search_is_the_plain_version(fixtures, monkeypatch, name):
    """On CPU tensors analyze_blocks_streams is analyze_blocks_streams_plain
    and never reaches K5's wrapper; the plain search in chunks of 5 windows
    gives the same choices."""
    def refuse(*args):
        raise AssertionError("K5 wrapper called on CPU tensors")

    monkeypatch.setattr(tb, "analyze_blocks_streams_kernel", refuse)
    frames, prevs, _ = fixtures[name]
    _, pcfg, cands = _setup()
    got = tb.analyze_blocks_streams(torch.as_tensor(frames), torch.as_tensor(prevs), cands)
    want = tb.analyze_blocks_streams_plain(torch.as_tensor(frames), torch.as_tensor(prevs),
                                           cands)
    for g, wnt in zip(got, want):
        assert torch.equal(g, wnt)
    monkeypatch.setattr(tb, "SEARCH_CHUNK", 5)
    np.testing.assert_array_equal(got[2].numpy(), _port_choice(frames, prevs, pcfg, cands))


def _shard_composition(frame, prev, cands, i, nby_loc, pcfg):
    """The sp shard analysis before K5 took a row range: change_analysis on
    the shard's rows (zero rows past the frame), rects moved to frame
    coordinates, the plain search on the full frames -> (changed, rects,
    choice) [nby_loc * nbx]."""
    h_loc = nby_loc * 16
    f = torch.zeros((h_loc,) + frame.shape[1:], dtype=torch.uint8)
    p = torch.zeros_like(f)
    rows = frame[i * h_loc:(i + 1) * h_loc]
    f[:rows.shape[0]] = torch.as_tensor(rows)
    p[:rows.shape[0]] = torch.as_tensor(prev[i * h_loc:(i + 1) * h_loc])
    changed, rects = tb.change_analysis_streams(f[None], p[None], nby_loc, pcfg.nbx)
    rects = rects + torch.tensor([0, i * h_loc, 0, i * h_loc], dtype=torch.int32)
    choice = tb.motion_search_streams_plain(torch.as_tensor(frame)[None],
                                            torch.as_tensor(prev)[None], rects, changed, cands)
    return changed[0], rects[0], choice[0]


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("name", ["edges", "streams", "flat"])
def test_row_range_matches_shard_composition(fixtures, name, sp):
    """analyze_blocks_streams over block rows [i * n, (i + 1) * n) of the
    full frames (n = the rows of an sp shard; at sp 4 the last shard lies
    past the frame) equals the shard composition it replaces, whole
    tensors, and the shards' flat flags join to the whole frame's."""
    frames, prevs, _ = fixtures[name]
    _, pcfg, cands = _setup()
    nby_loc = -(-pcfg.nby // sp)
    whole_flat = tb.analyze_blocks_streams(torch.as_tensor(frames), torch.as_tensor(prevs),
                                           cands)[3]
    for s in range(frames.shape[0]):
        flats = []
        for i in range(sp):
            got = tb.analyze_blocks_streams(torch.as_tensor(frames[s:s + 1]),
                                            torch.as_tensor(prevs[s:s + 1]), cands,
                                            row0=i * nby_loc, nby=nby_loc)
            want = _shard_composition(frames[s], prevs[s], cands, i, nby_loc, pcfg)
            for g, wnt, what in zip(got, want, ("changed", "rects", "choice")):
                assert torch.equal(g[0], wnt), (name, s, i, what)
            flats.append(got[3][0])
        assert torch.equal(torch.cat(flats)[:pcfg.nby * pcfg.nbx], whole_flat[s])


@pytest.mark.parametrize("sp", [2, 4])
def test_encode_p_sp_row_ranges_match_reference_mesh(fixtures, sp):
    """encode_p_sp, whose shards each make one analyze_blocks_streams call
    over their block rows of the full frames, gives the reference mesh's
    encode_p_sp bytes on the scrolled desktop with a moved window and on
    the typed block (40x56: partial edge blocks, at sp 4 a shard past the
    frame)."""
    frames, prevs, _ = fixtures["streams"]
    cfg, pcfg, _ = _setup()
    for s in (2, 3):
        want, w_type, _ = jm.encode_p_sp(jnp.asarray(frames[s]), jnp.asarray(prevs[s]),
                                         jm.make_mesh(sp, sp=sp), cfg, jax_renew_tables())
        got, g_type, _ = tm.encode_p_sp(frames[s], prevs[s],
                                        tm.make_mesh(sp, sp=sp, devices=["cpu"] * sp), pcfg,
                                        renew_tables("cpu"))
        assert (got, g_type) == (want, w_type), s
        assert g_type == 1 and len(got) > 2


def test_kernel_wrapper_refuses_cpu_tensors(fixtures):
    """K5's wrapper takes CUDA tensors only: on CPU tensors it raises
    before any build or launch."""
    frames, prevs, _ = fixtures["last"]
    _, pcfg, cands = _setup()
    ft, pt = torch.as_tensor(frames), torch.as_tensor(prevs)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="kernel input on cpu"):
        tk.analyze_blocks_streams_kernel(ft, pt, cands, 0, pcfg.nby)
    assert _build.LAUNCHES == before


def test_launch_runs_under_the_inputs_device(monkeypatch):
    """_build.launch makes the inputs' card current for the launch and
    passes that card's current stream (a wrapper called for cuda:1 while
    cuda:0 is current launches on cuda:1), then counts the launch."""
    calls, current = [], ["cuda:0"]

    class Stream:
        def __init__(self, dev):
            self.cuda_stream = {"cuda:0": 100, "cuda:1": 101}[str(dev)]

    @contextlib.contextmanager
    def device(dev):
        saved, current[0] = current[0], str(dev)
        try:
            yield
        finally:
            current[0] = saved

    class Lib:
        def sptc_analyze_blocks(self, *args):
            calls.append((current[0], args))
            return 0

    monkeypatch.setattr(_build, "library", Lib)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: Stream(dev if dev is not None else current[0]))
    n0 = _build.LAUNCHES["sptc_analyze_blocks"]
    _build.launch("sptc_analyze_blocks", 7, 8, device=torch.device("cuda", 1))
    assert calls == [("cuda:1", (7, 8, 101))]
    assert current == ["cuda:0"]
    assert _build.LAUNCHES["sptc_analyze_blocks"] == n0 + 1
    _build.LAUNCHES["sptc_analyze_blocks"] = n0


def test_c_entries_match_their_ctypes_signatures():
    """Every C entry of csrc/*.cu (K5's included) takes the arguments
    _build.SIGNATURES gives ctypes, in kind and order: a pointer as c_void_p,
    a long long as c_longlong, an int as c_int (a pointer passed as an int
    would be cut to 32 bits)."""
    import re

    kinds = {_build._P: "pointer", _build._L: "long long", _build._I: "int"}
    found = {}
    for src in _build._sources():
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[name] = ["pointer" if "*" in a else "long long" if "long long" in a else "int"
                           for a in args.split(",")]
    assert found.keys() == _build.SIGNATURES.keys()
    for name, args in _build.SIGNATURES.items():
        assert found[name] == [kinds[a] for a in args], name
