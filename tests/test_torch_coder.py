"""The port's plain section coder (screenpressor_tpu_torch.coder, the plain
versions of kernels K1/K2) against jx/coder.py's lax.scan coder: bytes,
records and table state, tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from screenpressor_tpu.config import lane_count
from screenpressor_tpu.jx import coder as jc
from screenpressor_tpu.jx.tables import renew_tables as jx_renew
from screenpressor_tpu_torch import coder as tc
from screenpressor_tpu_torch.convert import tables_to_numpy
from screenpressor_tpu_torch.tables import renew_tables, renew_tables_streams

from tests.test_jx_coder import _spec_records
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)


def _assert_tables(got, ref):
    got = tables_to_numpy(got)
    for kd in ref:
        for key in ref[kd]:
            np.testing.assert_array_equal(got[kd][key], np.asarray(ref[kd][key]),
                                          err_msg=f"{kd}.{key}")


CASES = [(name, n) for name in ("rec", "col", "bt", "sxy", "mv") for n in (5, 700)]
CASES.append(("col", 9000))  # above 8192 records: lane thinning (32 lanes)


@pytest.mark.parametrize("name,n", CASES)
def test_section_coder_matches_jx(name, n):
    rng = np.random.default_rng(sum(map(ord, name)) + n)
    records = np.asarray([list(r) for r in _spec_records(name, n, rng)], np.int32)
    k = lane_count(n)
    blobs_j, tab_j = jc.encode_section(records, k, jx_renew(), name)
    blobs_t, tab_t = tc.encode_section(records, k, renew_tables("cpu"), name, "cpu")
    assert blobs_t == blobs_j
    _assert_tables(tab_t, tab_j)

    # decode: records [T, K, W] and tables against decode_section_scan
    t_j = jc._pad_steps(-(-n // k))
    pay = tc.pad_payload(blobs_j, k)
    pay_j = np.zeros((k, max(pay.shape[1], 4)), np.uint8)
    pay_j[:, : pay.shape[1]] = pay
    recs_j, dtab_j = jc.decode_section_scan(
        jnp.asarray(pay_j), jnp.asarray(jc.lane_lengths(n, k)), jx_renew(), name, k, t_j)
    t = tc.steps_for(n, k)
    recs_t, dtab_t = tc.decode_section_scan(
        torch.as_tensor(pay), tc.lane_lens(n, k, "cpu"), renew_tables("cpu"), name, t)
    np.testing.assert_array_equal(recs_t.numpy(), np.asarray(recs_j)[:t])
    _assert_tables(dtab_t, dtab_j)
    out, _ = tc.decode_section(blobs_t, n, k, renew_tables("cpu"), name, "cpu")
    np.testing.assert_array_equal(out, records)


@pytest.mark.parametrize("n,k", [(0, 1), (1, 1), (37, 4), (700, 4), (9000, 32)])
def test_lane_geometry_matches_jx(n, k):
    t = tc.steps_for(n, k)
    np.testing.assert_array_equal(tc.lane_lens(n, k, "cpu").numpy(),
                                  np.asarray(jc.lane_lens_device(n, k)))
    lane_t, step_t = tc.gather_order(n, k)
    lane_j, step_j = jc.gather_order(n, k)
    np.testing.assert_array_equal(lane_t, lane_j)
    np.testing.assert_array_equal(step_t, step_j)
    rng = np.random.default_rng(n)
    cap = max(n, 1) + 3
    recs = rng.integers(0, 256, (cap, 3)).astype(np.int32)
    dealt_j = np.asarray(jc.deal_device(jnp.asarray(recs), n, k, t))
    dealt_t = tc.deal(torch.as_tensor(recs), n, k, t)
    np.testing.assert_array_equal(dealt_t.numpy(), dealt_j)
    back_j = np.asarray(jc.undeal_device(jnp.asarray(dealt_j), n, k, cap))
    np.testing.assert_array_equal(tc.undeal(dealt_t, n, k, cap).numpy(), back_j)


@pytest.mark.parametrize("col_w", [None, 256])
def test_single_stream_coder_is_the_one_stream_case(col_w):
    """encode_sections / decode_sections run the stream-batched coder on
    [1, ...] copies: the caller's tables are never written, and the bytes
    and tables equal the batched coder's for one stream of a larger set."""
    rng = np.random.default_rng(3)
    lits = rng.integers(0, 256, (6, 3))[rng.integers(0, 6, 300)].astype(np.int32)
    n, k = len(lits), 4
    t = tc.steps_for(n, k)
    lits_t = torch.as_tensor(lits)
    dealt, lens = tc.deal(lits_t, n, k, t), tc.lane_lens(n, k, "cpu")
    bm = tc.color_touched_bitmap(lits_t, n) if col_w else None
    kts = (("col", k, t),)
    tabs = renew_tables("cpu")
    before = tables_to_numpy(tabs)
    bufs, starts, out = tc.encode_sections([dealt], [lens], tabs, kts, col_w, bm)
    _assert_tables(tabs, before)

    tabs_b = renew_tables_streams(3, "cpu")
    bufs_b, starts_b = tc.encode_sections_streams(
        [dealt[None]], [lens[None]], tabs_b, kts, [1], col_w, None if bm is None else bm[None])
    assert torch.equal(bufs_b[0][0], bufs[0]) and torch.equal(starts_b[0][0], starts[0])
    _assert_tables({kd: {key: v[1] for key, v in tab.items()} for kd, tab in tabs_b.items()},
                   tables_to_numpy(out))

    blobs = tc.blobs_from_buf(bufs[0].numpy(), starts[0].numpy(), lens.numpy())
    pay = torch.as_tensor(tc.pad_payload(blobs, k))
    recs, dout = tc.decode_sections([pay], [lens], tabs, kts)
    _assert_tables(tabs, before)
    _assert_tables(dout, tables_to_numpy(out))
    np.testing.assert_array_equal(tc.undeal(recs[0], n, k, n).numpy(), lits)
