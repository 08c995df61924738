"""The port's P-decode block resolution (pframe.decode_p_resolve_streams,
kernel K8 on the card) on the CPU: CPU tensors take the plain version,
which equals jx/pframe.py `decode_p_resolve` stream by stream on the
resolve fixtures (clean streams bit for bit; a damaged stream's verdict);
K8's wrapper refuses CPU tensors, reads nothing back to the host and hands
the kernels one descriptor. Inputs from seeds with numpy; tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from screenpressor_tpu.jx import pframe as jp
from screenpressor_tpu_torch import _build
from screenpressor_tpu_torch import kernels as tk
from screenpressor_tpu_torch import pframe as tp

from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_support import resolve_fixtures, resolve_inputs

FIXTURES = resolve_fixtures()
HOST_READS = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__index__", "__float__")


def _jx_resolve(recs, rows, s, cfg):
    """jx decode_p_resolve on stream s's own records (max(n, 1) rows a
    section, as the port clamps) -> (parts, err) as numpy."""
    ns = {name: int(n) for name, n in zip(tp.SECTION_NAMES, rows[s][:5])}
    own = {name: jnp.asarray(recs[name][s, :max(ns[name], 1)].numpy())
           for name in tp.SECTION_NAMES}
    xx1, xx2, n_data = (int(v) for v in rows[s][5:])
    parts, err, _ = jp.decode_p_resolve(None, ns, xx1, xx2, n_data, None, None, cfg.height,
                                        cfg.width, cfg.nbx, cfg.nby, None, None,
                                        max(ns["mv"], 1), max(n_data, 1), recs=own)
    return [np.asarray(p) for p in parts], int(err)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_resolve_on_cpu_is_plain_and_matches_jx(name, monkeypatch):
    """decode_p_resolve_streams on CPU tensors is the plain version (it never
    reaches K8's wrapper), and each stream's slots equal jx's
    decode_p_resolve where jx finds the stream clean; a stream that either
    finds damaged, both do."""
    def refuse(*args):
        raise AssertionError("K8 wrapper called on CPU tensors")

    monkeypatch.setattr(tp, "resolve_blocks_streams_kernel", refuse)
    streams, rows, h, w = FIXTURES[name]
    recs, lay, cfg = resolve_inputs(streams, rows, h, w)
    parts, err = tp.decode_p_resolve_streams(recs, lay, cfg)
    want, want_err = tp.decode_p_resolve_streams_plain(recs, lay, cfg)
    assert all(torch.equal(a, b) for a, b in zip(parts, want)) and torch.equal(err, want_err)
    msid, bsid = lay.msid.numpy(), lay.bsid.numpy()
    for s in range(len(rows)):
        ref, ref_err = _jx_resolve(recs, rows, s, cfg)
        assert bool(err[s]) == bool(ref_err), f"{name}: stream {s}, {int(err[s])} / {ref_err}"
        if ref_err:
            continue
        sel = (msid == s,) * 2 + (bsid == s,) * 4
        for got, exp in zip((p.numpy()[m] for p, m in zip(parts, sel)), ref):
            np.testing.assert_array_equal(got, exp, err_msg=f"{name}: stream {s}")


def test_resolve_kernel_refuses_cpu_tensors():
    """K8's wrapper takes CUDA tensors only: on CPU tensors it raises
    before any build or launch."""
    recs, lay, cfg = resolve_inputs(*FIXTURES["streams"])
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="kernel input on cpu"):
        tk.resolve_blocks_streams_kernel(recs, lay, cfg.nbx, cfg.nby, cfg.height, cfg.width)
    assert _build.LAUNCHES == before


def _ban_host_reads(monkeypatch):
    def banned(*args, **kw):
        raise AssertionError("a value read back to the host")

    for attr in HOST_READS:
        monkeypatch.setattr(torch.Tensor, attr, banned)


@pytest.mark.parametrize("name", ["chunks", "damaged"])
def test_resolve_reads_nothing_back(name, monkeypatch):
    """The resolve reads no value back to the host (Tensor.item, tolist,
    numpy, cpu and the conversions to bool, int and float raise): the plain
    version, and K8's wrapper up to its one launch (the CUDA check and the
    launch replaced, on CPU tensors), whose descriptor holds the records',
    the layout's, the outputs' and the scratch's addresses, then the
    sizes; the outputs have the plain version's shapes and dtypes."""
    streams, rows, h, w = FIXTURES[name]
    recs, lay, cfg = resolve_inputs(streams, rows, h, w)
    want, want_err = tp.decode_p_resolve_streams_plain(recs, lay, cfg)
    launches = []

    def launch(entry, desc, device):
        import ctypes

        launches.append((entry, np.ctypeslib.as_array((ctypes.c_longlong * 38).from_address(desc))
                         .copy(), device))

    monkeypatch.setattr(_build, "require_cuda", lambda *t: None)
    monkeypatch.setattr(_build, "launch", launch)
    with monkeypatch.context() as mp:
        _ban_host_reads(mp)
        tp.decode_p_resolve_streams_plain(recs, lay, cfg)
        parts, err = tk.resolve_blocks_streams_kernel(recs, lay, cfg.nbx, cfg.nby, cfg.height,
                                                      cfg.width)
    assert [(e, dev) for e, _, dev in launches] == [("sptc_resolve_blocks", lay.hdr.device)]
    desc = launches[0][1]
    inputs = [recs[n] for n in tk.RESOLVE_SECTIONS] + [lay.hdr, lay.mcap, lay.bcap, lay.moff,
                                                       lay.boff, lay.bsid]
    assert list(desc[:18]) == [t.data_ptr() for t in (*inputs, *parts, err)]
    c, caps = len(rows), [recs[n].shape[1] for n in tk.RESOLVE_SECTIONS]
    n_tiles = -(-caps[3] // tk.RESOLVE_TILE)
    assert list(desc[25:]) == [c, *caps, lay.b_max, n_tiles, cfg.nbx, cfg.nby, cfg.height,
                               cfg.width, lay.bsid.shape[0]]
    # scratch: int64 run starts, area starts, tile sums; int32 run counts,
    # first records, record slots, literal rows; each region in its buffer
    bstart, nzc, astart, first_rec, tsum, jbs, litrow = (int(v) for v in desc[18:25])
    assert astart - bstart == 8 * c * caps[0] and tsum - astart == 8 * c * (lay.b_max + 1)
    assert first_rec - nzc == 4 * c * caps[0] and jbs - first_rec == 4 * c * lay.b_max
    assert litrow - jbs == 4 * c * caps[3]
    for got, ref in zip((*parts, err), (*want, want_err)):
        assert got.shape == ref.shape and got.dtype == ref.dtype == torch.int32
