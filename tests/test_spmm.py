import jax.numpy as jnp
import numpy as np

from graphembedding.data.datasets import synthetic_wiki
from graphembedding.graph import Graph
from graphembedding.models import SDNE
from graphembedding.ops.spmm import (
    adjacency_bcoo,
    laplacian_quadratic,
    sddmm,
    spmm,
    sym_edges,
)


def toy():
    # directed: 0->1 (2.0), 1->2 (1.0), 2->0 (3.0), plus 0->2 (1.0)
    return Graph(np.array([0, 1, 2, 0]), np.array([1, 2, 0, 2]),
                 np.array([2.0, 1.0, 3.0, 1.0], dtype=np.float32),
                 num_nodes=3, directed=True)


def dense_A(g, sym=False):
    V = g.num_nodes
    A = np.zeros((V, V), dtype=np.float32)
    src, dst, w = g.edges()
    np.add.at(A, (src, dst), w)
    if sym:
        A = A + A.T
    return A


def test_spmm_matches_dense():
    g = toy()
    X = np.arange(12, dtype=np.float32).reshape(3, 4)
    got = np.asarray(spmm(adjacency_bcoo(g), jnp.asarray(X)))
    np.testing.assert_allclose(got, dense_A(g) @ X, rtol=1e-6)


def test_spmm_sym_matches_dense():
    g = toy()
    X = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    got = np.asarray(spmm(adjacency_bcoo(g, sym=True), jnp.asarray(X)))
    np.testing.assert_allclose(got, dense_A(g, sym=True) @ X, rtol=1e-5)


def test_sddmm():
    g = toy()
    Y = np.random.default_rng(1).standard_normal((3, 4)).astype(np.float32)
    src, dst, w, deg = sym_edges(g)
    got = np.asarray(sddmm(src, dst, jnp.asarray(Y)))
    want = np.sum(Y[np.asarray(src)] * Y[np.asarray(dst)], axis=-1)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_laplacian_quadratic_matches_trace():
    g = toy()
    Y = np.random.default_rng(2).standard_normal((3, 6)).astype(np.float32)
    A_sym = dense_A(g, sym=True)
    L = np.diag(A_sym.sum(1)) - A_sym
    want = np.trace(Y.T @ L @ Y)
    src, dst, w, deg = sym_edges(g)
    got = float(laplacian_quadratic(src, dst, w, deg, jnp.asarray(Y)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_sdne_sparse_trainer_matches_objective():
    ds = synthetic_wiki(num_nodes=70, num_classes=2, avg_degree=5,
                        seed=31)
    m = SDNE(ds.graph, hidden_size=[16, 8])
    m.train_sparse(epochs=25, row_chunk=32)
    assert np.isfinite(np.asarray(m.losses)).all()
    # losses should broadly decrease
    assert float(m.losses[-1]) < float(m.losses[0])
    emb = m.get_embeddings()
    assert next(iter(emb.values())).shape == (8,)


def test_sdne_sparse_never_materializes_dense():
    """After train_sparse + get_embeddings, the dense [V, V] A/L must
    never have been built (the sparse mode's memory contract)."""
    ds = synthetic_wiki(num_nodes=60, num_classes=2, avg_degree=5,
                        seed=7)
    m = SDNE(ds.graph, hidden_size=[16, 8])
    m.train_sparse(epochs=5, row_chunk=32)
    emb = m.get_embeddings()
    assert next(iter(emb.values())).shape == (8,)
    assert m._A is None and m._L is None
    # dense-path encode agrees with the sparse-layer encode
    import jax.numpy as jnp
    sparse_table = np.asarray(m.embedding_table)
    dense_table = np.asarray(
        __import__("graphembedding.models.sdne",
                   fromlist=["encode"]).encode(m.params, m.A)
    )
    np.testing.assert_allclose(sparse_table, dense_table, rtol=1e-4,
                               atol=1e-5)


def test_sym_edges_no_double_count_for_undirected():
    """Undirected graphs already list both directions; symmetrization
    must not double weights (code-review regression)."""
    from graphembedding.graph import Graph

    g = Graph(np.array([0, 1]), np.array([1, 2]), directed=False)
    src, dst, w, deg_w = sym_edges(g)
    A = np.zeros((3, 3))
    np.add.at(A, (np.asarray(src), np.asarray(dst)), np.asarray(w))
    np.testing.assert_array_equal(A, [[0, 1, 0], [1, 0, 1], [0, 1, 0]])
    np.testing.assert_array_equal(np.asarray(deg_w), [1, 2, 1])
    # SDNE dense L agrees
    m = SDNE(g, hidden_size=[4, 2])
    L = np.asarray(m.L)
    np.testing.assert_array_equal(L, np.diag([1, 2, 1]) - A)
