import jax
import numpy as np
import pytest

from graphembedding.graph import Graph
from graphembedding.ops.walk import (
    csr_contains,
    node2vec_walks,
    node2vec_walks_rejection,
    simulate_walks,
    uniform_walks,
    weighted_walks,
)


def line_graph():
    # path 0-1-2-3 (undirected)
    src = np.array([0, 1, 2])
    dst = np.array([1, 2, 3])
    return Graph(src, dst, directed=False)


def star_graph(k=5):
    # hub 0 connected to 1..k (undirected)
    src = np.zeros(k, dtype=int)
    dst = np.arange(1, k + 1)
    return Graph(src, dst, directed=False)


def triangle_with_tail():
    # triangle 0-1-2 plus tail 2-3 (undirected)
    src = np.array([0, 1, 2, 2])
    dst = np.array([1, 2, 0, 3])
    return Graph(src, dst, directed=False)


def test_uniform_walks_shape_and_validity():
    g = star_graph()
    dg = g.device
    starts = jax.numpy.zeros(64, dtype=jax.numpy.int32)
    walks = np.asarray(
        uniform_walks(dg.row_ptr, dg.col_idx, dg.degree, starts,
                      jax.random.PRNGKey(0), length=8)
    )
    assert walks.shape == (64, 8)
    assert np.all(walks[:, 0] == 0)
    # star: walk alternates hub <-> leaf
    assert np.all(walks[:, 1] >= 1)
    assert np.all(walks[:, 2] == 0)


def test_uniform_walks_dead_end():
    # directed path 0 -> 1 -> 2, stops at 2
    g = Graph(np.array([0, 1]), np.array([1, 2]), num_nodes=3,
              directed=True)
    dg = g.device
    starts = jax.numpy.zeros(8, dtype=jax.numpy.int32)
    walks = np.asarray(
        uniform_walks(dg.row_ptr, dg.col_idx, dg.degree, starts,
                      jax.random.PRNGKey(1), length=6)
    )
    np.testing.assert_array_equal(walks[0], [0, 1, 2, -1, -1, -1])


def test_uniform_transition_distribution():
    g = triangle_with_tail()
    dg = g.device
    starts = jax.numpy.full((20000,), 2, dtype=jax.numpy.int32)
    walks = np.asarray(
        uniform_walks(dg.row_ptr, dg.col_idx, dg.degree, starts,
                      jax.random.PRNGKey(2), length=2)
    )
    # from node 2: neighbors {0, 1, 3}, uniform
    counts = np.bincount(walks[:, 1], minlength=4)
    freq = counts / counts.sum()
    assert counts[2] == 0
    np.testing.assert_allclose(freq[[0, 1, 3]], 1 / 3, atol=0.02)


def test_weighted_walk_distribution():
    # 0 -> 1 (w=3), 0 -> 2 (w=1)
    g = Graph(np.array([0, 0]), np.array([1, 2]),
              np.array([3.0, 1.0], dtype=np.float32), num_nodes=3,
              directed=True)
    dg = g.device
    at = g.alias
    starts = jax.numpy.zeros(20000, dtype=jax.numpy.int32)
    walks = np.asarray(
        weighted_walks(dg.row_ptr, dg.col_idx, dg.degree, at.accept,
                       at.alias, starts, jax.random.PRNGKey(3), length=2)
    )
    freq = np.bincount(walks[:, 1], minlength=3) / walks.shape[0]
    np.testing.assert_allclose(freq[1], 0.75, atol=0.02)
    np.testing.assert_allclose(freq[2], 0.25, atol=0.02)


def test_csr_contains():
    g = triangle_with_tail()
    dg = g.device
    rows = jax.numpy.array([0, 0, 2, 3, 1], dtype=jax.numpy.int32)
    vals = jax.numpy.array([1, 3, 3, 2, 0], dtype=jax.numpy.int32)
    out = np.asarray(
        csr_contains(dg.row_ptr, dg.col_idx, dg.degree, rows, vals,
                     max_degree=dg.max_degree)
    )
    # N(0)={1,2}, N(2)={0,1,3}, N(3)={2}, N(1)={0,2}
    np.testing.assert_array_equal(out, [True, False, True, True, True])


def exact_pq_second_step_dist(g, prev, cur, p, q):
    """Exact (p,q) transition probs from (prev, cur) on a Graph."""
    nbrs = g.neighbors(cur)
    w = g.out_weights(cur)
    prev_nbrs = set(g.neighbors(prev).tolist())
    probs = []
    for x, wx in zip(nbrs, w):
        if x == prev:
            probs.append(wx / p)
        elif int(x) in prev_nbrs:
            probs.append(wx)
        else:
            probs.append(wx / q)
    probs = np.array(probs, dtype=np.float64)
    return nbrs, probs / probs.sum()


@pytest.mark.parametrize("p,q", [(0.25, 4.0), (4.0, 0.25), (1.0, 1.0)])
def test_node2vec_exact_distribution(p, q):
    g = triangle_with_tail()
    dg = g.device
    nm = g.neighbor_matrix
    n = 40000
    starts = jax.numpy.full((n,), 0, dtype=jax.numpy.int32)
    walks = np.asarray(
        node2vec_walks(dg.row_ptr, dg.col_idx, dg.degree, nm.nbr, nm.nbr_w,
                       starts, jax.random.PRNGKey(4), p, q,
                       length=3, max_degree=dg.max_degree)
    )
    # condition on second token, check third-step distribution
    for mid in [1, 2]:
        sel = walks[walks[:, 1] == mid]
        if len(sel) < 1000:
            continue
        nbrs, target = exact_pq_second_step_dist(g, 0, mid, p, q)
        freq = np.bincount(sel[:, 2], minlength=g.num_nodes)[nbrs]
        freq = freq / freq.sum()
        np.testing.assert_allclose(freq, target, atol=0.03)


@pytest.mark.parametrize("p,q", [(0.25, 4.0), (2.0, 0.5)])
def test_node2vec_rejection_matches_exact(p, q):
    g = triangle_with_tail()
    dg = g.device
    at = g.alias
    n = 40000
    starts = jax.numpy.full((n,), 0, dtype=jax.numpy.int32)
    walks = np.asarray(
        node2vec_walks_rejection(
            dg.row_ptr, dg.col_idx, dg.degree, at.accept, at.alias,
            starts, jax.random.PRNGKey(5), p, q,
            length=3, max_degree=dg.max_degree)
    )
    for mid in [1, 2]:
        sel = walks[walks[:, 1] == mid]
        if len(sel) < 1000:
            continue
        nbrs, target = exact_pq_second_step_dist(g, 0, mid, p, q)
        freq = np.bincount(sel[:, 2], minlength=g.num_nodes)[nbrs]
        freq = freq / freq.sum()
        np.testing.assert_allclose(freq, target, atol=0.03)


def test_simulate_walks_covers_all_nodes():
    g = triangle_with_tail()
    walks = np.asarray(
        simulate_walks(g, num_walks=3, walk_length=5,
                       key=jax.random.PRNGKey(6))
    )
    assert walks.shape == (12, 5)
    np.testing.assert_array_equal(
        np.sort(walks[:, 0]), np.repeat([0, 1, 2, 3], 3)
    )


def test_select_pq_kernel_heuristic():
    """Auto-selection: exact through Dpad=384, dense-membership
    rejection past it (both bias regimes), csr membership when the
    nbr-id matrix overflows the memory budget."""
    from graphembedding.ops.walk import select_pq_kernel

    assert select_pq_kernel(20000, 8, 0.25, 4.0) == "exact"
    assert select_pq_kernel(20000, 300, 0.25, 4.0) == "exact"
    assert select_pq_kernel(20000, 512, 0.25, 4.0) == "rejection_dense"
    assert select_pq_kernel(20000, 2048, 0.25, 4.0) == "rejection_dense"
    assert select_pq_kernel(20000, 128, 1.0, 1.0) == "exact"
    assert select_pq_kernel(20000, 512, 1.0, 1.0) == "rejection_dense"
    # memory gates: 5M x 1152-pad x 8B = 46 GB kills exact; x 4B =
    # 23 GB also kills dense membership -> csr rejection
    assert select_pq_kernel(5_000_000, 1100, 0.25, 4.0) == "rejection"
    # dense membership survives where only the weights half overflows
    assert select_pq_kernel(900_000, 1100, 0.25, 4.0) == "rejection_dense"
    # forced-override plumbing: Node2Vec(use_rejection_sampling=...)
    # keeps the flag; None resolves via the heuristic
    import networkx as nx

    from graphembedding.models import Node2Vec

    g = nx.relabel_nodes(
        nx.path_graph(12), {i: str(i) for i in range(12)}
    )
    m = Node2Vec(g, walk_length=4, num_walks=2)
    assert m.use_rejection_sampling is False  # auto -> exact here
    m2 = Node2Vec(g, walk_length=4, num_walks=2,
                  use_rejection_sampling=True)
    assert m2.use_rejection_sampling is True


@pytest.mark.parametrize("p,q", [(4.0, 1.0), (0.25, 4.0)])
def test_node2vec_rejection_envelope_weighted(p, q):
    # weighted triangle-with-tail: the prev-envelope mixture needs the
    # cur->prev edge weight and per-row weight sums; wrong wiring would
    # skew exactly these conditionals (round-5 envelope sampler)
    src = np.array([0, 1, 2, 2])
    dst = np.array([1, 2, 0, 3])
    w = np.array([3.0, 1.0, 2.0, 0.5], dtype=np.float32)
    g = Graph(src, dst, w, directed=False)
    dg = g.device
    at = g.alias
    import jax.numpy as jnp
    csum = jnp.concatenate(
        [jnp.zeros((1,), jnp.float32), jnp.cumsum(dg.edge_weight)])
    wsum = csum[dg.row_ptr[1:]] - csum[dg.row_ptr[:-1]]
    n = 60000
    starts = jax.numpy.full((n,), 0, dtype=jax.numpy.int32)
    walks = np.asarray(
        node2vec_walks_rejection(
            dg.row_ptr, dg.col_idx, dg.degree, at.accept, at.alias,
            starts, jax.random.PRNGKey(7), p, q,
            length=3, max_degree=dg.max_degree,
            edge_weight=dg.edge_weight, wsum=wsum)
    )
    for mid in [1, 2]:
        sel = walks[walks[:, 1] == mid]
        if len(sel) < 1000:
            continue
        nbrs, target = exact_pq_second_step_dist(g, 0, mid, p, q)
        freq = np.bincount(sel[:, 2], minlength=g.num_nodes)[nbrs]
        freq = freq / freq.sum()
        np.testing.assert_allclose(freq, target, atol=0.03)


def test_node2vec_rejection_envelope_matches_ub_form():
    # the round-4 ub form is the oracle: same graph, same (p,q), both
    # forms must land on the same conditional distribution
    g = triangle_with_tail()
    dg = g.device
    at = g.alias
    n = 60000
    p, q = 0.25, 4.0
    starts = jax.numpy.full((n,), 0, dtype=jax.numpy.int32)
    freqs = {}
    for env in (False, True):
        walks = np.asarray(
            node2vec_walks_rejection(
                dg.row_ptr, dg.col_idx, dg.degree, at.accept, at.alias,
                starts, jax.random.PRNGKey(8), p, q,
                length=3, max_degree=dg.max_degree, envelope=env)
        )
        sel = walks[walks[:, 1] == 1]
        f = np.bincount(sel[:, 2], minlength=g.num_nodes).astype(float)
        freqs[env] = f / f.sum()
    np.testing.assert_allclose(freqs[True], freqs[False], atol=0.03)


@pytest.mark.parametrize("p,q", [(0.25, 4.0), (2.0, 0.5)])
def test_node2vec_rejection_dense_membership(p, q):
    # nbr= dense-membership mode must match the csr mode's distribution
    g = triangle_with_tail()
    dg = g.device
    at = g.alias
    nm = g.neighbor_matrix
    n = 40000
    starts = jax.numpy.full((n,), 0, dtype=jax.numpy.int32)
    walks = np.asarray(
        node2vec_walks_rejection(
            dg.row_ptr, dg.col_idx, dg.degree, at.accept, at.alias,
            starts, jax.random.PRNGKey(9), p, q,
            length=3, max_degree=dg.max_degree, nbr=nm.nbr)
    )
    for mid in [1, 2]:
        sel = walks[walks[:, 1] == mid]
        if len(sel) < 1000:
            continue
        nbrs, target = exact_pq_second_step_dist(g, 0, mid, p, q)
        freq = np.bincount(sel[:, 2], minlength=g.num_nodes)[nbrs]
        freq = freq / freq.sum()
        np.testing.assert_allclose(freq, target, atol=0.03)


@pytest.mark.parametrize("p,q", [(0.25, 4.0), (2.0, 0.5)])
def test_node2vec_rejection_uniform_rows(p, q):
    # unweighted fast path (slot-draw proposals from resident nbr rows)
    # must match the exact conditional law
    g = triangle_with_tail()
    dg = g.device
    at = g.alias
    nm = g.neighbor_matrix
    n = 40000
    starts = jax.numpy.full((n,), 0, dtype=jax.numpy.int32)
    walks = np.asarray(
        node2vec_walks_rejection(
            dg.row_ptr, dg.col_idx, dg.degree, at.accept, at.alias,
            starts, jax.random.PRNGKey(10), p, q,
            length=3, max_degree=dg.max_degree, nbr=nm.nbr,
            uniform_rows=True)
    )
    for mid in [1, 2]:
        sel = walks[walks[:, 1] == mid]
        if len(sel) < 1000:
            continue
        nbrs, target = exact_pq_second_step_dist(g, 0, mid, p, q)
        freq = np.bincount(sel[:, 2], minlength=g.num_nodes)[nbrs]
        freq = freq / freq.sum()
        np.testing.assert_allclose(freq, target, atol=0.03)
