"""The port's adaptive tables (screenpressor_tpu_torch.tables) against
jx/tables.py: same inputs from a numpy seed, tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from screenpressor_tpu.config import PROB_SCALE, STEP, TABLE_KINDS, kind_mixed
from screenpressor_tpu.jx import tables as jt
from screenpressor_tpu_torch import tables as tt
from screenpressor_tpu_torch.convert import tables_from_jax, tables_to_numpy

from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)


def _random_table(kind, rng):
    """A reachable-looking table state: counts below the rescale threshold,
    some rows near it so one more STEP triggers the rescale."""
    rows, alpha = TABLE_KINDS[kind]
    rows = min(rows, 64)
    mixed = kind_mixed(kind)
    cnt = rng.integers(0 if mixed else 1, 40, (rows, alpha)).astype(np.int32)
    hot = rng.choice(rows, max(1, rows // 4), replace=False)
    for r in hot:  # push row sums to just under PROB_SCALE - STEP
        room = PROB_SCALE - STEP - int(cnt[r].sum()) - int(rng.integers(0, STEP))
        cnt[r, int(rng.integers(alpha))] += max(room, 0)
    tab = {"cnt": cnt, "cntsum": cnt.sum(1).astype(np.int32)}
    if mixed:
        g = rng.integers(1, 60, alpha).astype(np.int32)
        g[int(rng.integers(alpha))] += max(PROB_SCALE - STEP - int(g.sum()) - 100, 0)
        tab["gcnt"] = g
        tab["gsum"] = np.int32(g.sum())
    return tab


@pytest.mark.parametrize("kind", ["nrun", "color", "ptype", "bt", "mv"])
def test_effective_rows_and_update_match_jx(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    tab_np = _random_table(kind, rng)
    rows_n, alpha = tab_np["cnt"].shape
    jtab = {k: jnp.asarray(v) for k, v in tab_np.items()}
    ttab = tables_from_jax({kind: tab_np})[kind]
    for step_i in range(6):
        k = 32
        # duplicate rows, hot rows and parked (inactive) lanes every step
        rows = rng.integers(0, rows_n, k).astype(np.int32)
        rows[: k // 4] = rows[0]
        syms = rng.integers(0, alpha, k).astype(np.int32)
        syms[: k // 8] = syms[0]
        active = rng.random(k) < 0.8
        eff_j = np.asarray(jt.effective_rows(jtab, jnp.asarray(rows)))
        eff_t = tt.effective_rows(ttab, torch.as_tensor(rows)).numpy()
        np.testing.assert_array_equal(eff_t, eff_j)
        jtab = jt.update_batch(jtab, jnp.asarray(rows), jnp.asarray(syms),
                               jnp.asarray(active), STEP, STEP)
        ttab = tt.update_batch(ttab, torch.as_tensor(rows), torch.as_tensor(syms),
                               torch.as_tensor(active), STEP, STEP)
        got = tables_to_numpy({kind: ttab})[kind]
        for key in jtab:
            np.testing.assert_array_equal(got[key], np.asarray(jtab[key]),
                                          err_msg=f"{kind}.{key} step {step_i}")


def test_renew_tables_match_jx():
    got = tables_to_numpy(tt.renew_tables("cpu"))
    ref = jt.renew_tables()
    assert got.keys() == ref.keys()
    for kd in ref:
        assert got[kd].keys() == ref[kd].keys()
        for key in ref[kd]:
            np.testing.assert_array_equal(got[kd][key], np.asarray(ref[kd][key]))


def test_renew_cache_is_per_device_and_not_written():
    a = tt.renew_tables_cached("cpu")
    assert tt.renew_tables_cached(torch.device("cpu")) is a
    before = a["color"]["gcnt"].clone()
    rows = torch.zeros(4, dtype=torch.int32)
    tt.update_batch(a["color"], rows, rows, torch.ones(4, dtype=torch.bool), STEP, STEP)
    assert torch.equal(a["color"]["gcnt"], before)
