"""The port's I-frame reconstruction (screenpressor_tpu_torch.recon, with
the plain version of kernel K4) against jx/recon.py, whose Pallas kernel
runs in interpret mode here. Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from screenpressor_tpu.jx import classify as jcl
from screenpressor_tpu.jx import recon as jr
from screenpressor_tpu_torch import recon as tr
from screenpressor_tpu_torch.convert import array_from_jax, array_to_numpy

from tests.test_spec_iframe import synth_desktop
from tests.torch_support import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("h,w,seed", [(48, 64, 1), (33, 47, 7)])
def test_reconstruct_matches_jx(h, w, seed):
    frame = synth_desktop(h, w, seed=seed)
    rec, n_rec, lit, n_lit = jcl.classify_i(jnp.asarray(frame), h, w)
    n_rec, n_lit = int(n_rec), int(n_lit)
    # capacity-padded record arrays, as the decoder hands them over
    records, lits = rec[: n_rec + 5], lit[: n_lit + 2]
    ref = np.asarray(jr.reconstruct_i(records, lits, h, w))
    got = array_to_numpy(tr.reconstruct_i(array_from_jax(records), array_from_jax(lits), h, w))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, frame)
    pt_j, lit_j = jr.expand_records(records, lits, h * w)
    pt_t, lit_t = tr.expand_records(array_from_jax(records), array_from_jax(lits), h * w)
    np.testing.assert_array_equal(array_to_numpy(pt_t), np.asarray(pt_j))
    np.testing.assert_array_equal(array_to_numpy(lit_t), np.asarray(lit_j))


def test_recon_rows_plain_matches_jx_on_arbitrary_types():
    """Random ptypes and literals (gradients, above/aboveleft chains,
    unknown types carried like left) through the row recurrence."""
    rng = np.random.default_rng(5)
    h, w = 12, 40
    pt = rng.integers(0, 7, (h * w, 1)).astype(np.int32)
    records = np.concatenate([pt, np.ones_like(pt)], axis=1)
    lits = rng.integers(0, 256, (h * w, 3)).astype(np.int32)
    ref = np.asarray(jr.reconstruct_i(jnp.asarray(records), jnp.asarray(lits), h, w))
    got = tr.reconstruct_i(torch.as_tensor(records), torch.as_tensor(lits), h, w)
    np.testing.assert_array_equal(got.numpy(), ref)
