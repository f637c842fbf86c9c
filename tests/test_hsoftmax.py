import heapq

import numpy as np
import pytest

from graphembedding.train.hsoftmax import (
    HSTrainer,
    build_huffman,
)


def test_huffman_tree_structure():
    counts = np.array([10.0, 5.0, 3.0, 1.0, 1.0])
    points, codes, depth = build_huffman(counts)
    V = 5
    assert points.shape == (V, depth)
    # paths are prefix-free and frequent words get shorter codes
    lens = [(points[v] >= 0).sum() for v in range(V)]
    assert lens[0] == min(lens)
    assert max(lens) == depth
    # expected Huffman codeword lengths sum (optimality check):
    # weighted path length is minimal; compare against a direct heap sim
    heap = list(map(float, counts))
    heapq.heapify(heap)
    total = 0.0
    while len(heap) > 1:
        a, b = heapq.heappop(heap), heapq.heappop(heap)
        total += a + b
        heapq.heappush(heap, a + b)
    got = sum(counts[v] * lens[v] for v in range(V))
    assert got == pytest.approx(total)


def test_hs_trainer_two_cliques():
    rng = np.random.default_rng(2)
    V = 20
    walks = []
    for _ in range(400):
        side = rng.integers(0, 2)
        walks.append(rng.integers(side * 10, side * 10 + 10, size=8))
    walks = np.asarray(walks, dtype=np.int32)
    tr = HSTrainer(embed_size=16, window=3, epochs=4, block_walks=64,
                   alpha=0.05, chunk_steps=8)
    w_in, w_tree, losses = tr.fit(walks, V)
    assert np.isfinite(np.asarray(losses)).all()
    emb = np.array(np.asarray(w_in))
    emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sims = emb @ emb.T
    within = ((sims[:10, :10].sum() - 10) / 90
              + (sims[10:, 10:].sum() - 10) / 90) / 2
    across = sims[:10, 10:].mean()
    assert within > across + 0.2


def test_hs_loss_decreases():
    rng = np.random.default_rng(3)
    walks = rng.integers(0, 30, (256, 8)).astype(np.int32)
    tr = HSTrainer(embed_size=8, window=2, epochs=6, block_walks=32,
                   alpha=0.1, chunk_steps=8)
    w_in, w_tree, losses = tr.fit(walks, 30)
    l = np.asarray(losses)
    assert np.isfinite(l).all()
    assert l[-8:].mean() < l[:8].mean()


def test_deepwalk_hs_model_path():
    """DeepWalk(...).train(hs=1) — the reference's Word2Vec(hs=1)
    objective through the model API."""
    import numpy as np

    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.eval.classify import Classifier
    from graphembedding.models import DeepWalk

    ds = synthetic_wiki(num_nodes=120, num_classes=3, avg_degree=8,
                        p_in=0.85, seed=3)
    m = DeepWalk(ds.graph, walk_length=10, num_walks=20, seed=0)
    m.train(embed_size=32, window_size=5, iter=3, hs=1)
    emb = m.get_embeddings()
    assert np.isfinite(next(iter(emb.values()))).all()
    res = Classifier(emb).split_train_evaluate(ds.X, ds.Y, 0.8)
    assert res["micro"] > 0.6, res["micro"]


def test_hs_sparse_cap_matches_dense():
    """sparse_cap is a bookkeeping change, not a math change: one
    chunk from identical state must produce identical tables (the cap
    scale per row is constant, so pre-scaling contributions equals
    scaling the row sum)."""
    import jax
    import jax.numpy as jnp

    from graphembedding.train.hsoftmax import (
        build_huffman,
        hs_block_chunk,
    )

    rng = np.random.default_rng(5)
    V, D, L = 30, 16, 8
    walks = jnp.asarray(rng.integers(0, V, (64, L)).astype(np.int32))
    counts = np.bincount(np.asarray(walks).ravel(), minlength=V)
    points, codes, _ = build_huffman(counts.astype(np.float64))
    points, codes = jnp.asarray(points), jnp.asarray(codes)
    k = jax.random.PRNGKey(0)
    w_in0 = jax.random.normal(k, (V, D)) * 0.1
    w_tr0 = jnp.zeros((V - 1, D), jnp.float32)
    outs = {}
    for sparse in (False, True):
        w_in, w_tr, loss = hs_block_chunk(
            w_in0.copy(), w_tr0.copy(), walks, points, codes,
            jax.random.PRNGKey(1), jnp.float32(0.025),
            jnp.float32(1e-4), jnp.int32(0), jnp.float32(100.0),
            chunk_steps=4, block_walks=32, window=3, update_cap=2.0,
            sparse_cap=sparse,
        )
        outs[sparse] = (np.asarray(w_in), np.asarray(w_tr),
                        np.asarray(loss))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(outs[0][2], outs[1][2], rtol=1e-5)


def test_hs_trainer_big_corpus_switch_trains():
    """cap_mode='sparse' end-to-end (the large-V path) still learns."""
    rng = np.random.default_rng(7)
    V = 20
    walks = []
    for _ in range(300):
        side = rng.integers(0, 2)
        walks.append(rng.integers(side * 10, side * 10 + 10, size=8))
    walks = np.asarray(walks, dtype=np.int32)
    tr = HSTrainer(embed_size=16, window=2, epochs=3, block_walks=64,
                   cap_mode="sparse")
    w_in, w_tree, losses = tr.fit(walks, V)
    emb = np.asarray(w_in)
    emb = emb / np.maximum(
        np.linalg.norm(emb, axis=1, keepdims=True), 1e-9
    )
    sims = emb @ emb.T
    same = (sims[:10, :10].sum() - 10) / 90 + (
        sims[10:, 10:].sum() - 10
    ) / 90
    cross = sims[:10, 10:].mean() * 2
    assert same / 2 > cross + 0.1
