"""Embedding import/export (utils/io.py): word2vec text + npz."""

import numpy as np
import pytest

from graphembedding.utils.io import (
    load_npz,
    load_word2vec_format,
    save_npz,
    save_word2vec_format,
)


def _emb(n=7, d=5, seed=0):
    rng = np.random.default_rng(seed)
    return {f"node{i}": rng.standard_normal(d).astype(np.float32)
            for i in range(n)}


def test_word2vec_roundtrip(tmp_path):
    emb = _emb()
    p = str(tmp_path / "emb.txt")
    save_word2vec_format(emb, p)
    back = load_word2vec_format(p)
    assert set(back) == set(emb)
    for k in emb:
        # repr() of float32-as-float round-trips exactly
        np.testing.assert_array_equal(back[k], emb[k])


def test_word2vec_header(tmp_path):
    emb = _emb(n=3, d=4)
    p = str(tmp_path / "emb.txt")
    save_word2vec_format(emb, p)
    with open(p) as f:
        assert f.readline().strip() == "3 4"


def test_word2vec_rejects_whitespace_names(tmp_path):
    with pytest.raises(ValueError, match="whitespace"):
        save_word2vec_format(
            {"bad name": np.zeros(3, np.float32)},
            str(tmp_path / "x.txt"),
        )


def test_npz_roundtrip(tmp_path):
    emb = _emb(n=4, d=8, seed=1)
    emb["name with spaces"] = np.ones(8, np.float32)
    p = str(tmp_path / "emb.npz")
    save_npz(emb, p)
    back = load_npz(p)
    assert set(back) == set(emb)
    for k in emb:
        np.testing.assert_array_equal(back[k], emb[k])


def test_gensim_compat(tmp_path):
    """gensim reads our text format (if gensim is available)."""
    gensim = pytest.importorskip("gensim")
    emb = _emb()
    p = str(tmp_path / "emb.txt")
    save_word2vec_format(emb, p)
    kv = gensim.models.KeyedVectors.load_word2vec_format(p, binary=False)
    for k in emb:
        np.testing.assert_allclose(kv[k], emb[k], rtol=1e-6)


def test_model_embeddings_roundtrip(tmp_path):
    """End-to-end: a trained model's dict survives the text format."""
    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.models import DeepWalk

    ds = synthetic_wiki(num_nodes=60, num_classes=3, avg_degree=6, seed=0)
    m = DeepWalk(ds.graph, walk_length=5, num_walks=4)
    m.train(embed_size=16, window_size=2, iter=1)
    emb = m.get_embeddings()
    p = str(tmp_path / "emb.txt")
    save_word2vec_format(emb, p)
    back = load_word2vec_format(p)
    assert set(back) == set(emb)
    k = next(iter(emb))
    np.testing.assert_array_equal(back[k], np.asarray(emb[k]))


def test_word2vec_failed_save_leaves_no_file(tmp_path):
    """Validation happens before writing: a rejected dict must not
    leave a truncated artifact behind."""
    p = str(tmp_path / "x.txt")
    emb = {"ok": np.zeros(3, np.float32),
           "bad name": np.zeros(3, np.float32)}
    with pytest.raises(ValueError):
        save_word2vec_format(emb, p)
    import os

    assert not os.path.exists(p)
    assert not os.path.exists(p + ".tmp")  # validation precedes writing
