"""The two facts the Hopper designs of K1 and K3 rest on, pinned on the CPU
against the plain versions and, through them, against jx. Tolerance 0.

K1 (csrc/sections.cu, encode_kernel) takes the lookups of all substeps of a
step before any update of that step (rec, bt, sxy, mv), and for col computes
the three substeps' row parts at the step start and chains only the global
row. K3 (csrc/run_walk.cu) takes the start mask as the orbit of each tile's
position 0 under next(p). Inputs are made from a seed with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from screenpressor_tpu.jx import classify as jcl
from screenpressor_tpu.jx import coder as jc
from screenpressor_tpu.jx.tables import renew_tables as jx_renew
from screenpressor_tpu_torch import classify as tcl
from screenpressor_tpu_torch import coder as tc
from screenpressor_tpu_torch.config import MAX_RUN, kind_gstep, kind_step
from screenpressor_tpu_torch.substeps import SUBSTEP_CODECS as CODECS
from screenpressor_tpu_torch.tables import effective_rows, renew_tables, update_batch

from tests.test_jx_coder import _spec_records
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)

I32 = torch.int32


def merged_scan(recs, lens, tables, name):
    """model_scan with K1's schedule: per step, every substep's lookup reads
    the count rows as they were before the step; of a mixed kind's global
    row it reads the state after the substeps before it (col: three
    substeps chain it; nrun has one substep a step). Then the updates, in
    substep order."""
    codec = CODECS[name]
    t_steps, k, _ = recs.shape
    state = codec.init_state(torch.zeros(k, dtype=I32))
    tables = dict(tables)
    cums, freqs, acts = [], [], []
    for t in range(t_steps):
        rec_l = [recs[t, :, j] for j in range(codec.rec_width)]
        lane_active = t < lens
        at_start = dict(tables)  # the tables are functional: a snapshot
        for j, kind in enumerate(codec.kinds):
            row, sym, extra = codec.enc_syms(j, rec_l, state)
            active = lane_active if extra is None else (lane_active & extra)
            row = row.clamp(0, tables[kind]["cnt"].shape[0] - 1)
            symc = sym.clamp(0, tables[kind]["cnt"].shape[1] - 1)
            look = dict(at_start[kind])
            for key in ("gcnt", "gsum"):  # the global row is chained
                if key in look:
                    look[key] = tables[kind][key]
            freq_rows = effective_rows(look, row)
            cum_rows = torch.cumsum(freq_rows, dim=1, dtype=I32) - freq_rows
            sidx = symc.long()[:, None]
            cums.append(cum_rows.gather(1, sidx)[:, 0])
            freqs.append(freq_rows.gather(1, sidx)[:, 0])
            acts.append(active)
            tables[kind] = update_batch(tables[kind], row, symc, active,
                                        kind_step(kind), kind_gstep(kind))
        state = codec.enc_next_state(rec_l, state, lane_active)
    s = len(codec.kinds)

    def stack(v):
        return torch.stack(v).reshape(t_steps, s, k).transpose(1, 2).contiguous()

    return stack(cums), stack(freqs), stack(acts), tables


def orbit_walk(bits, st, tile):
    """K3's jump walk in numpy: next(p) = min(p + MAX_RUN, first q > p with
    bit st[p] of bits[q] clear, tile end); the start mask is the orbit of
    each tile's position 0."""
    n = len(bits)
    out = np.zeros(n, bool)
    for base in range(0, n, tile):
        end = min(base + tile, n)
        p = base
        while p < end:
            out[p] = True
            limit = min(p + MAX_RUN, end)
            clear = np.nonzero(((bits[p + 1: limit] >> st[p]) & 1) == 0)[0]
            p = p + 1 + int(clear[0]) if len(clear) else limit
    return out


_jx_walk = jax.jit(jcl._run_walk, static_argnums=(2, 3))

DESIGN_CASES = [("k1", name, n, k) for name, n, k in (
    ("rec", 700, 4), ("bt", 300, 4), ("sxy", 300, 2), ("mv", 500, 4), ("col", 700, 4),
    ("col", 96, 32))]
DESIGN_CASES += [("k3", "walk", n, tile) for n, tile in (
    (3000, 1024), (700, 256), (2100, 1000), (5 * 256 + 9, 256))]


@pytest.mark.parametrize("kernel,name,n,k", DESIGN_CASES)
def test_design_fact_matches_plain_and_jx(kernel, name, n, k):
    rng = np.random.default_rng(sum(map(ord, name)) + n + k)
    if kernel == "k3":
        tile = k
        bits = rng.integers(0, 64, n).astype(np.int32)
        bits[rng.random(n) < 0.8] = 63
        bits[50:50 + 2 * MAX_RUN + 7] = 63  # a streak that crosses MAX_RUN twice
        st = rng.integers(0, 6, n).astype(np.int32)
        got = orbit_walk(bits, st, tile)
        plain = tcl.run_walk_plain(torch.as_tensor(bits), torch.as_tensor(st), tile).numpy()
        np.testing.assert_array_equal(got, plain)
        ref = np.asarray(_jx_walk(jnp.asarray(bits), jnp.asarray(st), n, tile))
        np.testing.assert_array_equal(got, ref)
        return
    records = np.asarray([list(r) for r in _spec_records(name, n, rng)], np.int32)
    t = tc.steps_for(n, k)
    dealt = tc.deal(torch.as_tensor(records), n, k, t)
    lens = tc.lane_lens(n, k, "cpu")
    tabs = renew_tables("cpu")
    cum_p, freq_p, act_p, tab_p = tc.model_scan(dealt, lens, tabs, name)
    cum_m, freq_m, act_m, tab_m = merged_scan(dealt, lens, tabs, name)
    assert torch.equal(act_m, act_p)
    # the intervals of inactive lanes never reach the bytes
    assert torch.equal(torch.where(act_p, cum_m, 0), torch.where(act_p, cum_p, 0))
    assert torch.equal(torch.where(act_p, freq_m, 0), torch.where(act_p, freq_p, 0))
    for kd in tab_p:
        for key in tab_p[kd]:
            assert torch.equal(tab_m[kd][key], tab_p[kd][key]), (kd, key)
    buf, start = tc.rans_pack(cum_m, freq_m, act_m, tc.pack_cap(name, t))
    blobs = tc.blobs_from_buf(buf.numpy(), start.numpy(), lens.numpy())
    blobs_j, _ = jc.encode_section(records, k, jx_renew(), name)
    assert blobs == blobs_j
