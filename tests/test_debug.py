"""Sanitizer-layer tests (SURVEY.md §6, race-detection row).

The reference has no sanitizers (its gensim hot loop is intentionally
racy hogwild); here the equivalents are host-side invariant validators
plus a checkify harness proving the hot kernels stay in-bounds — and
that corrupted inputs are actually caught, since XLA clamps OOB gathers
silently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graphembedding.graph import Graph
from graphembedding.utils.debug import (
    checked,
    debug_guard,
    validate_graph,
    validate_walks,
)


def _ring(n=12):
    src = np.arange(n)
    return Graph(src, (src + 1) % n, directed=False)


class TestValidateGraph:
    def test_valid_graph_passes(self):
        validate_graph(_ring())

    def test_nx_graph_passes(self):
        nx = pytest.importorskip("networkx")
        g = Graph.from_nx(nx.karate_club_graph())
        validate_graph(g)

    def test_col_idx_out_of_range(self):
        g = _ring()
        g.col_idx = g.col_idx.copy()
        g.col_idx[3] = g.num_nodes + 7
        with pytest.raises(ValueError, match="out of range"):
            validate_graph(g)

    def test_row_ptr_decreasing(self):
        g = _ring()
        g.row_ptr = g.row_ptr.copy()
        g.row_ptr[2] = g.row_ptr[1] - 1
        with pytest.raises(ValueError, match="decreases|degree"):
            validate_graph(g)

    def test_unsorted_row(self):
        g = Graph(np.array([0, 0, 1]), np.array([2, 1, 0]),
                  num_nodes=3)
        # constructor sorts; corrupt the order within row 0
        g.col_idx = g.col_idx.copy()
        g.col_idx[0], g.col_idx[1] = g.col_idx[1], g.col_idx[0]
        with pytest.raises(ValueError, match="sorted"):
            validate_graph(g)

    def test_nan_weight(self):
        g = _ring()
        g.edge_weight = g.edge_weight.copy()
        g.edge_weight[0] = np.nan
        with pytest.raises(ValueError, match="NaN"):
            validate_graph(g)


class TestValidateWalks:
    def test_valid_corpus(self):
        walks = np.array([[0, 1, 2, -1], [3, 2, 1, 0]], np.int32)
        validate_walks(walks, num_nodes=4)

    def test_token_too_large(self):
        walks = np.array([[0, 9, 2, -1]], np.int32)
        with pytest.raises(ValueError, match="outside"):
            validate_walks(walks, num_nodes=4)

    def test_non_trailing_pad(self):
        walks = np.array([[0, -1, 2, 3]], np.int32)
        with pytest.raises(ValueError, match="trailing"):
            validate_walks(walks, num_nodes=4)


class TestChecked:
    def test_walk_kernel_in_bounds(self):
        from graphembedding.ops.walk import uniform_walks

        g = _ring()
        dg = g.device
        starts = jnp.arange(g.num_nodes, dtype=jnp.int32)
        walks = checked(uniform_walks)(
            dg.row_ptr, dg.col_idx, dg.degree, starts,
            jax.random.PRNGKey(0), length=8,
        )
        validate_walks(np.asarray(walks), g.num_nodes)

    def test_sgns_chunk_in_bounds(self):
        from graphembedding.train.skipgram import sgns_block_chunk

        V, D, L = 16, 8, 6
        rng = np.random.default_rng(0)
        walks = jnp.asarray(rng.integers(0, V, (32, L)), jnp.int32)
        table = jnp.asarray(rng.integers(0, V, 128), jnp.int32)
        w_in = jnp.asarray(rng.standard_normal((V, D)) * 0.01,
                           jnp.float32)
        w_out = jnp.zeros((V, D), jnp.float32)
        run = checked(sgns_block_chunk)
        w_in, w_out, losses, _ = run(
            w_in, w_out, walks, table, jax.random.PRNGKey(1),
            jnp.float32(0.025), jnp.float32(1e-4), jnp.int32(0),
            jnp.float32(64.0), chunk_steps=2, block_walks=8,
            window=3, negative=3, k_shared=4, neg_share_walks=2,
        )
        assert np.isfinite(np.asarray(losses)).all()

    def test_corrupt_corpus_caught(self):
        """A token >= V silently clamps under XLA; checkify flags it."""
        from jax.experimental import checkify

        def gather(table, idx):
            return table[idx].sum()

        table = jnp.ones((8, 4), jnp.float32)
        ok = jnp.array([0, 7], jnp.int32)
        bad = jnp.array([0, 12], jnp.int32)
        run = checked(gather)
        run(table, ok)  # in-bounds: no error
        with pytest.raises(checkify.JaxRuntimeError):
            run(table, bad)


def test_debug_guard_restores_config():
    prev = jax.config.jax_debug_nans
    with debug_guard(nans=True):
        assert jax.config.jax_debug_nans is True
    assert jax.config.jax_debug_nans == prev
    # NaN actually trips inside the guard
    with pytest.raises(FloatingPointError):
        with debug_guard(nans=True):
            jnp.log(jnp.float32(-1.0)).block_until_ready()


def test_env_gated_validation(monkeypatch):
    """GE_VALIDATE wires the validators into Graph + trainers."""
    monkeypatch.setenv("GE_VALIDATE", "1")
    g = _ring()  # constructs cleanly under validation

    from graphembedding.train.skipgram import (
        SkipGramConfig,
        SkipGramTrainer,
    )

    bad = np.array([[0, 99, 1, -1]], np.int32)  # token >= V
    tr = SkipGramTrainer(SkipGramConfig(embed_size=4, epochs=1))
    with pytest.raises(ValueError, match="outside"):
        tr.fit(bad, g.num_nodes)
