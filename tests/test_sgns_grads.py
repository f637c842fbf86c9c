"""SGNS block gradients (train.skipgram.sgns_block_grads_xla) against
the float64 numpy reference (parity.reference.sgns_block_grads)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graphembedding.parity.reference import sgns_block_grads
from graphembedding.train.skipgram import sgns_block_grads_xla


def make_inputs(G=4, PL=24, D=16, K=8, G2=None, seed=0):
    G2 = G2 or G
    rng = np.random.default_rng(seed)
    yin = rng.standard_normal((G, PL, D)) * 0.3
    yout = rng.standard_normal((G, PL, D)) * 0.3
    vn = rng.standard_normal((G2, K, D)) * 0.3
    mask = (rng.random((G, PL, PL)) < 0.2).astype(np.float32)
    neg_ok = (rng.random((G2, (G // G2) * PL, K)) < 0.9).astype(
        np.float32)
    return yin, yout, vn, mask, neg_ok


def run(inputs, neg_w):
    f32 = [jnp.asarray(a, jnp.float32) for a in inputs]
    fn = jax.jit(lambda *a: sgns_block_grads_xla(
        *a, neg_w, precision=jax.lax.Precision.HIGHEST))
    return [np.asarray(x) for x in fn(*f32)]


@pytest.mark.parametrize("G,G2", [(4, 4), (6, 2)],
                         ids=["plain", "neg_share_packs3"])
def test_block_grads_match_float64_reference(G, G2):
    inputs = make_inputs(G=G, G2=G2)
    neg_w = 5.0 / 8
    got = run(inputs, neg_w)
    want = sgns_block_grads(*inputs, neg_w)
    for g, w, name in zip(got, want, ["d_yin", "d_yout", "d_vn", "loss"]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_block_grads_zero_mask_zero_grads():
    yin, yout, vn, mask, neg_ok = make_inputs(seed=1)
    mask = np.zeros_like(mask)
    got = run((yin, yout, vn, mask, neg_ok), 1.0)
    want = sgns_block_grads(yin, yout, vn, mask, neg_ok, 1.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(w, 0, atol=0)
        np.testing.assert_allclose(g, 0, atol=1e-6)
