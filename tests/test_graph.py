import numpy as np
import pytest

from graphembedding.graph import Graph
from graphembedding.utils.vocab import Vocab


def toy_graph(directed=True):
    # 0->1, 0->2, 1->2, 2->0, 3 isolated-ish (3->0)
    src = np.array([0, 0, 1, 2, 3])
    dst = np.array([1, 2, 2, 0, 0])
    w = np.array([1.0, 2.0, 1.0, 1.0, 1.0], dtype=np.float32)
    return Graph(src, dst, w, num_nodes=4, directed=directed)


def test_csr_build():
    g = toy_graph()
    assert g.num_nodes == 4
    assert g.num_edges == 5
    np.testing.assert_array_equal(g.row_ptr, [0, 2, 3, 4, 5])
    np.testing.assert_array_equal(g.neighbors(0), [1, 2])
    np.testing.assert_array_equal(g.neighbors(2), [0])
    np.testing.assert_array_equal(g.out_weights(0), [1.0, 2.0])


def test_csr_columns_sorted():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 50, 500)
    dst = rng.integers(0, 50, 500)
    g = Graph(src, dst, num_nodes=50)
    for v in range(50):
        nbrs = g.neighbors(v)
        assert np.all(np.diff(nbrs) >= 0)


def test_undirected_doubles_edges():
    g = toy_graph(directed=False)
    assert g.num_edges == 10
    assert 0 in g.neighbors(1)  # reverse edge exists


def test_device_padding():
    g = toy_graph()
    dg = g.device
    assert dg.col_idx.shape[0] % 128 == 0
    assert int(dg.col_idx[g.num_edges]) == -1  # padding marker


def test_neighbor_matrix():
    g = toy_graph()
    nm = g.neighbor_matrix
    nbr = np.asarray(nm.nbr)
    w = np.asarray(nm.nbr_w)
    assert set(nbr[0][w[0] > 0].tolist()) == {1, 2}
    assert np.all(nbr[0][w[0] == 0] == -1)


def test_from_nx_matches_reference_order():
    nx = pytest.importorskip("networkx")
    G = nx.DiGraph()
    G.add_weighted_edges_from([("a", "b", 2.0), ("b", "c", 1.0),
                               ("c", "a", 1.0)])
    g = Graph.from_nx(G)
    assert g.vocab.idx2node == list(G.nodes())
    assert g.num_edges == 3
    assert g.directed


def test_vocab_roundtrip():
    v = Vocab(["x", "y", "z"])
    assert v["y"] == 1
    assert v.names([2, 0]) == ["z", "x"]
    assert len(v) == 3


def test_undirected_self_loop_not_duplicated():
    """A self-loop (u, u) in an undirected graph must appear ONCE in
    row u (code-review regression: reversed-edge concat doubled it)."""
    g = Graph(np.array([0, 1]), np.array([0, 2]), directed=False)
    assert g.degree[0] == 1  # just the loop
    np.testing.assert_array_equal(np.sort(g.neighbors(1)), [2])
    np.testing.assert_array_equal(g.neighbors(0), [0])
    assert g.num_edges == 3  # loop once + (1,2) both ways


def test_from_edgelist_csv_and_csv_labels(tmp_path):
    """The public BlogCatalog dump is CSV (`node,node` edges and
    `node,group` multi-label rows) — both readers must accept it
    the day the mount populates."""
    e = tmp_path / "edges.csv"
    e.write_text("1,2\n2,3\n3,1\n")
    g = Graph.from_edgelist(str(e), directed=False)
    assert g.num_nodes == 3 and g.num_edges == 6  # symmetrized

    from graphembedding.data.datasets import _labels_from_file

    lab = tmp_path / "group-edges.csv"
    lab.write_text("1,5\n1,7\n2,5\n3,9\n")
    d = _labels_from_file(str(lab))
    assert d["1"] == ["5", "7"]  # multi-label accumulates
    assert d["2"] == ["5"] and d["3"] == ["9"]
