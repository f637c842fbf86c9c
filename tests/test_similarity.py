"""Embedding similarity queries (gensim wv.most_similar role)."""

import numpy as np
import pytest

from graphembedding.utils import most_similar, similarity


def toy_embeddings():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((4, 8)).astype(np.float32)
    emb = {
        "a": base[0],
        "a2": base[0] * 2.0 + 1e-3,  # same direction as a
        "b": base[1],
        "c": base[2],
        "d": -base[0],  # opposite of a
    }
    return emb


def test_most_similar_orders_by_cosine():
    emb = toy_embeddings()
    out = most_similar(emb, "a", topn=4)
    names = [n for n, _ in out]
    assert names[0] == "a2"           # colinear wins
    assert names[-1] == "d"           # anti-colinear loses
    assert "a" not in names           # query excluded
    scores = [s for _, s in out]
    assert scores == sorted(scores, reverse=True)
    assert scores[0] == pytest.approx(1.0, abs=1e-3)
    assert scores[-1] == pytest.approx(-1.0, abs=1e-3)


def test_most_similar_by_vector_and_pairs():
    emb = toy_embeddings()
    v = emb["a"]
    out = most_similar(emb, vector=v, topn=2)
    assert out[0][0] in ("a", "a2")  # raw vector: query not excluded
    assert similarity(emb, "a", "a2") == pytest.approx(1.0, abs=1e-3)
    assert similarity(emb, "a", "d") == pytest.approx(-1.0, abs=1e-3)


def test_most_similar_matrix_input_and_errors():
    names = ["x", "y", "z"]
    table = np.eye(3, dtype=np.float32)
    out = most_similar((names, table), "x", topn=2)
    assert {n for n, _ in out} == {"y", "z"}
    with pytest.raises(KeyError):
        most_similar((names, table), "nope")
    with pytest.raises(ValueError):
        most_similar((names, table))


def test_most_similar_device_path_matches_numpy():
    from graphembedding.utils import simquery as simmod

    rng = np.random.default_rng(1)
    V, D = 512, 16
    names = [str(i) for i in range(V)]
    table = rng.standard_normal((V, D)).astype(np.float32)
    ref = most_similar((names, table), "7", topn=5)
    old = simmod._DEVICE_MIN_ROWS
    try:
        simmod._DEVICE_MIN_ROWS = 1  # force the accelerator path
        got = most_similar((names, table), "7", topn=5)
    finally:
        simmod._DEVICE_MIN_ROWS = old
    assert [n for n, _ in ref] == [n for n, _ in got]
    np.testing.assert_allclose(
        [s for _, s in ref], [s for _, s in got], rtol=1e-5
    )
