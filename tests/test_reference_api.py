"""Pin every model's constructor/train defaults to the reference's.

VERDICT r3 missing #5: a verbatim-migrated caller that relies on
defaults must get the reference's behavior — e.g. `SDNE(G)` must train
a 128-d embedding ([256, 128] hidden stack, `ge/models/sdne.py —
create_model (~L35) [U]`), not a silently smaller one.

Canonical values: SURVEY.md §3.1 rows 3–7 (class signatures) and
row 12 (example hyperparameters). Documented deviations (SURVEY §9)
are pinned AS deviations so a future change is deliberate:
DeepWalk/Node2Vec train SGNS by default (hs=0) while Struc2Vec keeps
the reference's hs=1.
"""

import inspect

import numpy as np
import pytest

from graphembedding import LINE, SDNE, DeepWalk, Node2Vec, Struc2Vec


def defaults_of(fn):
    return {
        name: p.default
        for name, p in inspect.signature(fn).parameters.items()
        if p.default is not inspect.Parameter.empty
    }


def test_deepwalk_defaults():
    # SURVEY §3.1 row 3 / row 12: DeepWalk(G, walk_length=10,
    # num_walks=80, workers=1); train(embed_size=128, window_size=5,
    # iter=5) — iter default from the reference train() signature
    # (the example passes iter=3 explicitly).
    d = defaults_of(DeepWalk.__init__)
    assert d["walk_length"] == 10
    assert d["num_walks"] == 80
    assert d["workers"] == 1
    t = defaults_of(DeepWalk.train)
    assert t["embed_size"] == 128
    assert t["window_size"] == 5
    assert t["iter"] == 5


def test_node2vec_defaults():
    # SURVEY §3.1 row 4: Node2Vec(graph, walk_length, num_walks,
    # p=1.0, q=1.0, workers=1, use_rejection_sampling=0). The example
    # (row 12) passes p=0.25, q=4 explicitly.
    d = defaults_of(Node2Vec.__init__)
    assert d["p"] == 1.0
    assert d["q"] == 1.0
    assert d["workers"] == 1
    # deliberate deviation (VERDICT r3 item 3): None = auto-select by
    # degree profile/memory — falsy like the reference's 0, and at
    # reference scales the auto pick IS the exact formulation
    assert not d["use_rejection_sampling"]
    t = defaults_of(Node2Vec.train)
    assert t["embed_size"] == 128
    assert t["window_size"] == 5
    assert t["iter"] == 5


def test_line_defaults():
    # SURVEY §3.1 row 5: LINE(graph, embedding_size=8,
    # negative_ratio=5, order='second'); train(batch_size=1024,
    # epochs=…, times=1). §9 notes embedding_size=8 is the class
    # default even though the example uses 128.
    d = defaults_of(LINE.__init__)
    assert d["embedding_size"] == 8
    assert d["negative_ratio"] == 5
    assert d["order"] == "second"
    t = defaults_of(LINE.train)
    assert t["batch_size"] == 1024
    assert t["times"] == 1


def test_sdne_defaults():
    # SURVEY §3.1 row 6: alpha=1e-6, beta=5., nu1=1e-5, nu2=1e-4;
    # hidden stack [256, 128] (create_model default + example value).
    d = defaults_of(SDNE.__init__)
    assert d["alpha"] == 1e-6
    assert d["beta"] == 5.0
    assert d["nu1"] == 1e-5
    assert d["nu2"] == 1e-4
    t = defaults_of(SDNE.train)
    assert t["batch_size"] == 1024


def test_sdne_default_hidden_size_is_reference_sized(line_graph):
    # The behavioral half of the pin: SDNE(G) with NO hidden_size
    # must produce the reference's 128-d embedding.
    m = SDNE(line_graph)
    assert m.hidden_size == [256, 128]


def test_struc2vec_defaults():
    # SURVEY §3.1 row 7: walk_length=10, num_walks=100, workers=1,
    # verbose=0, stay_prob=0.3, opt1_reduce_len=True,
    # opt2_reduce_sim_calc=True, opt3_num_layers=None,
    # temp_path='./temp_struc2vec/', reuse=False; train keeps the
    # reference's hs=1 objective (`Word2Vec(sg=1, hs=1)`).
    d = defaults_of(Struc2Vec.__init__)
    assert d["walk_length"] == 10
    assert d["num_walks"] == 100
    assert d["workers"] == 1
    assert d["stay_prob"] == 0.3
    assert d["opt1_reduce_len"] is True
    assert d["opt2_reduce_sim_calc"] is True
    assert d["opt3_num_layers"] is None
    assert d["temp_path"] == "./temp_struc2vec/"
    assert d["reuse"] is False
    t = defaults_of(Struc2Vec.train)
    assert t["embed_size"] == 128
    assert t["window_size"] == 5
    assert t["iter"] == 5
    # hs='auto' resolves to the reference's hs=1 objective at
    # reference scale (<= HS_AUTO_MAX_NODES) and to SGNS above it
    # (the hs tree walk is ~25x at V=1M — VERDICT r4 next-6)
    assert t["hs"] == "auto"
    assert Struc2Vec.HS_AUTO_MAX_NODES >= 100_000


def test_walk_family_sgns_deviation_is_pinned():
    # SURVEY §9 deviation, kept deliberate: DeepWalk trains SGNS
    # (hs=0 through the shared base) though the reference uses hs=1 —
    # SGNS is the performance path and F1 parity is verified
    # elsewhere. If hs ever becomes a DeepWalk.train parameter with a
    # different default, this pin forces the change to be reviewed.
    base_defaults = defaults_of(
        DeepWalk._fit_skipgram  # noqa: SLF001 — pinning internals
    )
    assert base_defaults["hs"] == 0
    assert base_defaults["negative"] == 5  # gensim Word2Vec default
    assert base_defaults["alpha"] == 0.025
    assert base_defaults["min_alpha"] == 1e-4
    assert base_defaults["sample"] == 1e-3


@pytest.fixture
def line_graph():
    import networkx as nx

    g = nx.path_graph(8, create_using=nx.Graph())
    return nx.relabel_nodes(g, {i: str(i) for i in g.nodes()})


def test_get_embeddings_return_type(line_graph):
    # Reference contract: get_embeddings() -> {node_str: np.ndarray}.
    m = DeepWalk(line_graph, walk_length=4, num_walks=2)
    m.train(embed_size=8, window_size=2, iter=1, block_walks=16)
    emb = m.get_embeddings()
    assert set(emb) == {str(i) for i in range(8)}
    v = emb["0"]
    assert isinstance(v, np.ndarray) and v.shape == (8,)
