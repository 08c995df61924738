"""The port's motion search (blocks.motion_search_streams; on the CPU its
plain version, motion_search_streams_plain) and the P analysis around it
(blocks.analyze_compact_streams) against the reference's jx.blocks
motion_search and analyze_compact (whose search is motion_search_pruned),
on the fixtures of torch_support.motion_search_fixtures at msr 8, low 2.
Tolerance 0. The card's K5 is held to the plain version on the same
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
from screenpressor_tpu_torch import _build
from screenpressor_tpu_torch import blocks as tb
from screenpressor_tpu_torch import kernels as tk

from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_support import MS_CFG, motion_search_fixtures, port_config

FIXTURES = ("noise", "last", "edges", "streams", "idle")


@pytest.fixture(scope="module")
def fixtures():
    return motion_search_fixtures()


def _setup():
    cfg = RefCodecConfig(**MS_CFG)
    pcfg = port_config(cfg)
    cands = torch.tensor(tb.mv_candidates(pcfg), dtype=torch.int32).reshape(-1, 2)
    return cfg, pcfg, cands


def _port_choice(frames, prevs, pcfg, cands, fn=tb.motion_search_streams):
    ft, pt = torch.as_tensor(frames), torch.as_tensor(prevs)
    changed, rects = tb.change_analysis_streams(ft, pt, pcfg.nby, pcfg.nbx)
    return fn(ft, pt, rects, changed, cands).numpy()


def _reference_choice(frame, prev, cfg):
    h, w, nby, nbx = cfg.height, cfg.width, cfg.nby, cfg.nbx
    changed, rects, in_sub = jb.change_analysis(jnp.asarray(frame), jnp.asarray(prev), h, w,
                                                nby, nbx)
    cands, _cols, rmax, _lows = jp._cands_rmax(cfg)
    return np.asarray(jb.motion_search(jnp.asarray(frame), jnp.asarray(prev), rects, in_sub,
                                       changed, cands, h, w, nby, nbx, rmax)).reshape(-1)


@pytest.mark.parametrize("name", FIXTURES)
def test_motion_search_matches_reference(fixtures, name):
    """motion_search_streams over every stream of the fixture in one call
    equals jx.blocks.motion_search stream by stream, and gives the choices
    the fixture was built for (an edge candidate found, one past it not)."""
    frames, prevs, expect = fixtures[name]
    cfg, pcfg, cands = _setup()
    got = _port_choice(frames, prevs, pcfg, cands)
    n_cand = cands.shape[0]
    for s in range(frames.shape[0]):
        np.testing.assert_array_equal(got[s], _reference_choice(frames[s], prevs[s], cfg),
                                      err_msg=f"{name} stream {s}")
    index = {tuple(c): i for i, c in enumerate(cands.tolist())}
    for (s, b), mv in expect.items():
        assert got[s, b] == (n_cand if mv is None else index[tuple(mv)]), (name, s, b, mv)
    if name == "noise":
        assert (got == n_cand).all()
    if name == "idle":
        assert (got == n_cand).all()
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
    """On CPU tensors motion_search_streams is motion_search_streams_plain
    and never reaches K5's wrapper; the plain version in chunks of 5
    windows gives the same choices."""
    def refuse(*args):
        raise AssertionError("K5 wrapper called on CPU tensors")

    monkeypatch.setattr(tb, "motion_search_streams_kernel", refuse)
    frames, prevs, _ = fixtures[name]
    _, pcfg, cands = _setup()
    got = _port_choice(frames, prevs, pcfg, cands)
    np.testing.assert_array_equal(
        got, _port_choice(frames, prevs, pcfg, cands, tb.motion_search_streams_plain))
    monkeypatch.setattr(tb, "SEARCH_CHUNK", 5)
    np.testing.assert_array_equal(got, _port_choice(frames, prevs, pcfg, cands))


def test_kernel_wrapper_refuses_cpu_tensors(fixtures):
    """K5's wrapper takes CUDA tensors only: on CPU tensors it raises
    before any build or launch."""
    frames, prevs, _ = fixtures["last"]
    _, pcfg, cands = _setup()
    ft, pt = torch.as_tensor(frames), torch.as_tensor(prevs)
    changed, rects = tb.change_analysis_streams(ft, pt, pcfg.nby, pcfg.nbx)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="kernel input on cpu"):
        tk.motion_search_streams_kernel(tb.pack_pixels(ft), tb.pack_pixels(pt), rects,
                                        changed, cands)
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
        def sptc_motion_search(self, *args):
            calls.append((current[0], args))
            return 0

    monkeypatch.setattr(_build, "library", Lib)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: Stream(dev if dev is not None else current[0]))
    n0 = _build.LAUNCHES["sptc_motion_search"]
    _build.launch("sptc_motion_search", 7, 8, device=torch.device("cuda", 1))
    assert calls == [("cuda:1", (7, 8, 101))]
    assert current == ["cuda:0"]
    assert _build.LAUNCHES["sptc_motion_search"] == n0 + 1
    _build.LAUNCHES["sptc_motion_search"] = n0


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
