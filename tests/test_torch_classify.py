"""The port's I-frame classification (screenpressor_tpu_torch.classify, with
the plain version of kernel K3) against jx/classify.py, whose run walk runs
its Pallas kernel in interpret mode here. Tolerance 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from screenpressor_tpu.config import seg_tile
from screenpressor_tpu.jx import classify as jcl
from screenpressor_tpu_torch import classify as tcl

from tests.test_spec_iframe import synth_desktop
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)


_jx_walk = jax.jit(jcl._run_walk, static_argnums=(2, 3))


def large_frame():
    """272x512: above the adaptive seg-tile threshold (whole-row tiles)."""
    h, w = 272, 512
    rng = np.random.default_rng(9)
    f = np.full((h, w, 3), (40, 44, 52), np.uint8)
    f[30:240, 40:470] = (250, 250, 250)
    for y in range(36, 230, 11):
        f[y: y + 5, 48: 48 + int(rng.integers(200, 400)): 2] = (20, 20, 24)
    return f


@pytest.mark.parametrize("n,tile", [(3000, 1024), (700, 256)])
def test_run_walk_plain_matches_jx(n, tile):
    rng = np.random.default_rng(n)
    bits = rng.integers(0, 64, n).astype(np.int32)
    bits[50:400] = 63  # one long streak crosses MAX_RUN
    st = rng.integers(0, 6, n).astype(np.int32)
    ref = np.asarray(_jx_walk(jnp.asarray(bits), jnp.asarray(st), n, tile))
    got = tcl.run_walk(torch.as_tensor(bits), torch.as_tensor(st), tile).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("frame", [synth_desktop(40, 56, seed=3), large_frame()],
                         ids=["40x56", "272x512"])
def test_classify_matches_jx(frame):
    h, w, _ = frame.shape
    if h * w > 128 * 1024:
        assert seg_tile(h * w, w) != 1024
    fits_j = np.asarray(jcl.fits_planes_i(jnp.asarray(frame)))
    fits_t = tcl.fits_planes_i(torch.as_tensor(frame))
    np.testing.assert_array_equal(fits_t.numpy(), fits_j)
    np.testing.assert_array_equal(tcl.start_types_i(fits_t).numpy(),
                                  np.asarray(jcl.start_types_i(jnp.asarray(fits_j))))
    rec_j, n_rec_j, lit_j, n_lit_j = jcl.classify_i(jnp.asarray(frame), h, w)
    rec_t, n_rec_t, lit_t, n_lit_t = tcl.classify_i(torch.as_tensor(frame))
    n_rec, n_lit = int(n_rec_j), int(n_lit_j)
    assert (int(n_rec_t), int(n_lit_t)) == (n_rec, n_lit)
    np.testing.assert_array_equal(rec_t.numpy()[:n_rec], np.asarray(rec_j)[:n_rec])
    np.testing.assert_array_equal(lit_t.numpy()[:n_lit], np.asarray(lit_j)[:n_lit])
    assert int(rec_t[:n_rec, 1].sum()) == h * w
