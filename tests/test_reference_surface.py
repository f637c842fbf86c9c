"""Reference-API surface parity: everything a user of
kangzf/GraphEmbedding expects to find (SURVEY.md §3.1).

(Previously tests/test_reference_api.py; renamed in round 4 when that
filename was taken over by the constructor/train DEFAULTS pins —
VERDICT r3 item 5. This file keeps the behavioral surface tests:
walker classes, partition shims, alias API, the verbatim migration
path.)"""

import numpy as np
import pytest

import graphembedding as ge
from graphembedding.data.datasets import synthetic_wiki
from graphembedding.utils.vocab import (
    partition_dict,
    partition_list,
    partition_num,
    preprocess_nxgraph,
)


def test_package_exports():
    for name in ["DeepWalk", "Node2Vec", "LINE", "SDNE", "Struc2Vec",
                 "Graph", "RandomWalker", "BiasedWalker"]:
        assert hasattr(ge, name), name


def test_random_walker_sentences():
    ds = synthetic_wiki(num_nodes=50, num_classes=2, avg_degree=5,
                        seed=12)
    w = ge.RandomWalker(ds.graph, p=1, q=1)
    sentences = w.simulate_walks(num_walks=2, walk_length=6)
    assert len(sentences) == 100
    assert all(isinstance(s, list) for s in sentences)
    # node names, not indices
    assert all(tok in ds.graph.vocab.node2idx for s in sentences
               for tok in s)
    # biased variant needs preprocessing hook to exist
    w2 = ge.RandomWalker(ds.graph, p=0.5, q=2)
    w2.preprocess_transition_probs()
    s2 = w2.simulate_walks(num_walks=1, walk_length=4)
    assert len(s2) == 50


def test_biased_walker_sentences(tmp_path):
    """BiasedWalker reads the Struc2Vec layer cache from temp_path and
    returns node-name sentences (`ge/walker.py — BiasedWalker (~L185)
    [U]`)."""
    ds = synthetic_wiki(num_nodes=24, num_classes=2, avg_degree=4,
                        seed=15)
    tp = str(tmp_path) + "/"
    # builds + caches the context graph into temp_path
    ge.Struc2Vec(ds.graph, walk_length=4, num_walks=1, temp_path=tp)
    vocab = ds.graph.vocab
    idx2node = [vocab.idx2node[i] for i in range(ds.graph.num_nodes)]
    bw = ge.BiasedWalker(idx2node, tp)
    sentences = bw.simulate_walks(num_walks=2, walk_length=5)
    assert len(sentences) == 48
    assert all(len(s) == 5 for s in sentences)
    assert all(tok in vocab.node2idx for s in sentences for tok in s)


def test_walker_seeding(tmp_path):
    """VERDICT r2 item 8: same seed reproduces, different seeds differ,
    and repeated default calls draw fresh corpora (reference behavior:
    its RNG advances between simulate_walks calls)."""
    ds = synthetic_wiki(num_nodes=40, num_classes=2, avg_degree=5,
                        seed=21)
    w = ge.RandomWalker(ds.graph, p=1, q=1, seed=7)
    a = w.simulate_walks(num_walks=2, walk_length=6, seed=3)
    b = w.simulate_walks(num_walks=2, walk_length=6, seed=3)
    c = w.simulate_walks(num_walks=2, walk_length=6, seed=4)
    assert a == b
    assert a != c
    # default (no seed=) advances call-to-call
    d1 = w.simulate_walks(num_walks=2, walk_length=6)
    d2 = w.simulate_walks(num_walks=2, walk_length=6)
    assert d1 != d2

    # BiasedWalker: same contract over the struc2vec layer cache
    tp = str(tmp_path) + "/"
    ge.Struc2Vec(ds.graph, walk_length=4, num_walks=1, temp_path=tp)
    vocab = ds.graph.vocab
    idx2node = [vocab.idx2node[i] for i in range(ds.graph.num_nodes)]
    bw = ge.BiasedWalker(idx2node, tp)
    a = bw.simulate_walks(num_walks=2, walk_length=5, seed=3)
    b = bw.simulate_walks(num_walks=2, walk_length=5, seed=3)
    c = bw.simulate_walks(num_walks=2, walk_length=5, seed=4)
    assert a == b
    assert a != c
    d1 = bw.simulate_walks(num_walks=2, walk_length=5)
    d2 = bw.simulate_walks(num_walks=2, walk_length=5)
    assert d1 != d2


def test_train_accepts_gensim_parity_kwargs():
    """ADVICE r2 (medium): train(window_size=5, seed=42) must not raise
    'multiple values' — explicit caller kwargs override defaults."""
    ds = synthetic_wiki(num_nodes=30, num_classes=2, avg_degree=4,
                        seed=22)
    m = ge.DeepWalk(ds.graph, walk_length=4, num_walks=2)
    m.train(embed_size=8, window_size=2, iter=1, block_walks=16,
            k_shared=4, seed=42, window=2, epochs=1)
    assert len(m.get_embeddings()) == 30


def test_partition_helpers():
    assert partition_num(10, 2) == [5, 5]
    assert partition_num(10, 3) == [3, 3, 3, 1]
    parts = partition_dict({i: [i] for i in range(7)}, 2)
    assert sum(len(p) for p in parts) == 7
    parts2 = partition_list(list(range(7)), 3)
    assert sum(len(p) for p in parts2) == 7


def test_preprocess_nxgraph():
    nx = pytest.importorskip("networkx")
    G = nx.path_graph(4)
    idx2node, node2idx = preprocess_nxgraph(G)
    assert idx2node == list(G.nodes())
    assert all(node2idx[n] == i for i, n in enumerate(idx2node))


def test_sdne_evaluate():
    ds = synthetic_wiki(num_nodes=40, num_classes=2, avg_degree=4,
                        seed=13)
    m = ge.SDNE(ds.graph, hidden_size=[16, 8])
    res = m.evaluate()
    assert set(res) == {"loss", "l_2nd", "l_1st"}
    assert np.isfinite(res["loss"])


def test_models_accept_reference_kwargs():
    """workers/verbose/etc. accepted (ignored) for drop-in migration."""
    ds = synthetic_wiki(num_nodes=30, num_classes=2, avg_degree=4,
                        seed=14)
    m = ge.DeepWalk(ds.graph, walk_length=4, num_walks=2, workers=4)
    m.train(embed_size=8, window_size=2, workers=4, iter=1,
            block_walks=16, k_shared=4)
    assert len(m.get_embeddings()) == 30


def test_full_reference_migration_path():
    """The exact code a reference user writes (SURVEY.md §1 snippet):
    nx.read_edgelist -> Model(G) -> train -> get_embeddings -> Classifier."""
    import os
    import tempfile

    import networkx as nx

    from graphembedding.eval.classify import (
        Classifier,
        read_node_label,
    )

    rng = np.random.default_rng(4)
    with tempfile.TemporaryDirectory() as d:
        epath = os.path.join(d, "edges.txt")
        lpath = os.path.join(d, "labels.txt")
        with open(epath, "w") as f:
            for _ in range(400):
                a, b = rng.integers(0, 60, 2)
                if a != b:
                    f.write(f"{a} {b} 1\n")
        with open(lpath, "w") as f:
            for v in range(60):
                f.write(f"{v} {v % 3}\n")

        G = nx.read_edgelist(epath, create_using=nx.DiGraph(),
                             nodetype=None, data=[("weight", int)])
        model = ge.DeepWalk(G, walk_length=6, num_walks=4, workers=1)
        model.train(embed_size=16, window_size=3, iter=1)
        embeddings = model.get_embeddings()
        assert set(embeddings) == set(G.nodes())
        X, Y = read_node_label(lpath)
        X = [x for x in X if x in embeddings]
        Y = [y for x, y in zip(*read_node_label(lpath)) if x in embeddings]
        res = Classifier(embeddings).split_train_evaluate(X, Y, 0.5)
        assert "micro" in res and 0.0 <= res["micro"] <= 1.0


def test_reference_alias_api():
    """`ge.alias`-signature shims: list-in/list-out build + single draw."""
    import numpy as np

    from graphembedding.ops.alias import alias_sample, create_alias_table

    probs = [0.5, 0.3, 0.2]
    accept, alias = create_alias_table(probs)
    assert isinstance(accept, list) and isinstance(alias, list)
    assert len(accept) == len(alias) == 3
    np.random.seed(0)
    draws = np.array([alias_sample(accept, alias) for _ in range(20000)])
    emp = np.bincount(draws, minlength=3) / draws.size
    assert np.abs(emp - np.asarray(probs)).max() < 0.02


def test_ge_import_shim_verbatim():
    """The reference's own import lines work verbatim via the `ge`
    shim package (docs/MIGRATION.md: zero-line migration)."""
    import networkx as nx

    from ge import DeepWalk
    from ge.classify import Classifier

    g = nx.relabel_nodes(
        nx.path_graph(10), {i: str(i) for i in range(10)}
    )
    model = DeepWalk(g, walk_length=4, num_walks=2, workers=1)
    model.train(window_size=2, iter=1, embed_size=8, block_walks=16)
    emb = model.get_embeddings()
    assert set(emb) == {str(i) for i in range(10)}
    assert Classifier(emb) is not None
