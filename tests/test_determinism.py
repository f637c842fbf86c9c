"""Golden-seed determinism (SURVEY.md §6: JAX is functional — no data
races by construction; determinism tests replace sanitizers).

Same seed => bit-identical walks and bit-identical trained tables,
run-to-run. This is the property the reference could never offer
(gensim hogwild is deliberately racy)."""

import jax
import numpy as np

from graphembedding.data.datasets import synthetic_wiki
from graphembedding.models import DeepWalk, Node2Vec
from graphembedding.ops.walk import simulate_walks


def _ds():
    return synthetic_wiki(num_nodes=120, num_classes=4, seed=3)


def test_walks_bit_identical_across_runs():
    g = _ds().graph
    w1 = np.asarray(simulate_walks(g, 5, 8, jax.random.PRNGKey(9)))
    w2 = np.asarray(simulate_walks(g, 5, 8, jax.random.PRNGKey(9)))
    np.testing.assert_array_equal(w1, w2)
    w3 = np.asarray(simulate_walks(g, 5, 8, jax.random.PRNGKey(10)))
    assert not np.array_equal(w1, w3)


def test_deepwalk_training_bit_identical_across_runs():
    ds = _ds()
    tables = []
    for _ in range(2):
        m = DeepWalk(ds.graph, walk_length=8, num_walks=5, seed=7)
        m.train(embed_size=16, window_size=3, iter=1)
        tables.append(np.asarray(m.w_in))
    np.testing.assert_array_equal(tables[0], tables[1])


def test_node2vec_walk_indices_in_bounds():
    ds = _ds()
    g = ds.graph
    w = np.asarray(
        simulate_walks(g, 3, 8, jax.random.PRNGKey(1), kind="node2vec",
                       p=0.25, q=4.0)
    )
    assert w.min() >= -1 and w.max() < g.num_nodes
    m = Node2Vec(ds.graph, walk_length=8, num_walks=3, p=0.25, q=4.0,
                 seed=1)
    assert np.asarray(m.walks).max() < g.num_nodes
