"""The port's compact color-table encode (colw): the same bytes and table
state as `col` over the full table, on the plain coder (tolerance 0); the
touched-row fixture of the reference's lut clobber (row 12287) in a
two-frame session against jx (bytes and tables). The mixed session of
test_torch_codec.py holds the sessions' tables, colw active, to jx's."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from screenpressor_tpu.config import COLOR_CTX_ROWS, CodecConfig, color_ctx
from screenpressor_tpu.jx import coder as jc
from screenpressor_tpu.jx.codec import JaxEncoder
from screenpressor_tpu.jx.tables import renew_tables as jx_renew
from screenpressor_tpu_torch import TorchDecoder, TorchEncoder
from screenpressor_tpu_torch import coder as tc
from screenpressor_tpu_torch.convert import tables_to_numpy
from screenpressor_tpu_torch.tables import renew_tables

from tests.test_batch import H, W
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_support import port_config

ROW_LAST = 3 * COLOR_CTX_ROWS - 1  # 12287 under the default (8, 4) context bits


def _section(lits, k):
    n = len(lits)
    t = tc.steps_for(n, k)
    lits_t = torch.as_tensor(np.asarray(lits, np.int32))
    return tc.deal(lits_t, n, k, t), tc.lane_lens(n, k, "cpu"), t, lits_t


def _encode(lits, k, col_w):
    dealt, lens, t, lits_t = _section(lits, k)
    bm = tc.color_touched_bitmap(lits_t, len(lits))
    bufs, starts, tabs = tc.encode_sections([dealt], [lens], renew_tables("cpu"),
                                            (("col", k, t),), col_w, bm if col_w else None)
    blobs = tc.blobs_from_buf(bufs[0].numpy(), starts[0].numpy(), lens.numpy())
    return blobs, tables_to_numpy(tabs), int(bm.sum())


def _assert_tables(a, b):
    for kd in b:
        for key in b[kd]:
            np.testing.assert_array_equal(a[kd][key], b[kd][key], err_msg=f"{kd}.{key}")


def _palette_lits(n, pal, seed):
    rng = np.random.default_rng(seed)
    palette = rng.integers(0, 256, (pal, 3))
    return palette[rng.integers(0, pal, n)]


@pytest.mark.parametrize("col_w", [256, 1024])
@pytest.mark.parametrize("n,k,pal", [(700, 8, 7), (70, 4, 40), (3, 1, 3)])
def test_colw_equals_col_over_full_table(n, k, pal, col_w):
    lits = _palette_lits(n, pal, seed=n)
    blobs, tabs, n_touch = _encode(lits, k, None)
    assert n_touch <= col_w, "fixture must fit the bucket"
    blobs_w, tabs_w, _ = _encode(lits, k, col_w)
    assert blobs_w == blobs
    _assert_tables(tabs_w, tabs)


def test_bucket_rule():
    assert tc.col_compact_bucket(1) == 256
    assert tc.col_compact_bucket(256) == 256
    assert tc.col_compact_bucket(257) == 1024
    assert tc.col_compact_bucket(1025) is None


def test_touched_bitmap_matches_jx():
    lits = _palette_lits(211, 64, seed=1)
    cap = np.zeros((256, 3), np.int32)
    cap[:211] = lits
    want = np.asarray(jc.color_touched_bitmap(jnp.asarray(cap), jnp.int32(211)))
    got = tc.color_touched_bitmap(torch.as_tensor(cap), 211).numpy()
    np.testing.assert_array_equal(got, want)


def _row_last_lits():
    """A small palette whose literals touch plane 2's last row: R = 255 and
    G >= 240 give B's context row 2 * 4096 + color_ctx(255, G) = 12287."""
    lits = _palette_lits(60, 5, seed=7)
    lits[::7] = (255, 250, 17)
    return lits


def test_row_last_fixture_restores_full_table():
    """The fixture's section touches row 12287 and fits colw256. The
    port's colw leaves the same table as col; jx's colw (clamped lut) loses
    that row's updates, which is the reference fault the port avoids."""
    lits = _row_last_lits()
    assert 2 * COLOR_CTX_ROWS + int(color_ctx(255, 250)) == ROW_LAST
    k = 4
    blobs, tabs, n_touch = _encode(lits, k, None)
    assert n_touch < 256
    blobs_w, tabs_w, _ = _encode(lits, k, 256)
    assert blobs_w == blobs
    _assert_tables(tabs_w, tabs)
    assert tabs["color"]["cnt"][ROW_LAST].sum() > 0

    dealt, lens, t, _ = _section(lits, k)
    jd = jnp.asarray(dealt.numpy())
    jl = jnp.asarray(lens.numpy())
    _, _, j_full = jc.encode_sections_auto([jd], [jl], jx_renew(), (("col", k, t),))
    _, _, j_colw = jc.encode_sections_auto([jd], [jl], jx_renew(), (("col", k, t),),
                                           col_w=256)
    np.testing.assert_array_equal(tabs["color"]["cnt"], np.asarray(j_full["color"]["cnt"]))
    assert not np.array_equal(np.asarray(j_colw["color"]["cnt"][ROW_LAST]),
                              np.asarray(j_full["color"]["cnt"][ROW_LAST])), \
        "fixture no longer shows the reference's clobber"


def test_row_last_two_frame_round_trip():
    """Two frames whose literals touch row 12287, coded with colw: the
    decoder (always full-table col) stays in step, and the session equals
    jx's (full-table) bytes and tables."""
    f0 = np.full((H, W, 3), (40, 44, 52), np.uint8)
    lits = _row_last_lits()
    f0[4, 3:W:2] = lits[: len(range(3, W, 2))]
    f0[9, 1:W:3] = lits[-len(range(1, W, 3)):]
    f1 = f0.copy()
    f1[20:24, 10:30:2] = (255, 245, 3)
    f1[21, 11:31:2] = lits[:10]
    cfg = CodecConfig(width=W, height=H, kf_interval=0)
    calls = []
    real = tc.color_compact_streams

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(tc, "color_compact_streams", counted)
    try:
        enc = TorchEncoder(port_config(cfg), "cpu")
        got = enc.encode_batch([f0, f1])
    finally:
        mp.undo()
    assert len(calls) == 2, "both frames' col sections must take colw"
    jenc = JaxEncoder(cfg)
    assert got == jenc.encode_batch([f0, f1])
    _assert_tables(tables_to_numpy(enc.tables),
                   {kd: {key: np.asarray(v) for key, v in tab.items()}
                    for kd, tab in jenc.tables.items()})
    out = TorchDecoder(port_config(cfg), "cpu").decode_batch([p for p, _ in got])
    np.testing.assert_array_equal(out[0], f0)
    np.testing.assert_array_equal(out[1], f1)
