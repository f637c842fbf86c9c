import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graphembedding.graph import Graph
from graphembedding.parallel.mesh import make_mesh
from graphembedding.parallel.sgns import sharded_sgns_chunk
from graphembedding.parallel.walks import (
    partition_csr,
    simulate_walks_distributed,
)


def ring_graph(n=32):
    src = np.arange(n)
    dst = (src + 1) % n
    return Graph(src, dst, directed=False)


def test_mesh_shapes():
    mesh = make_mesh()
    assert mesh.shape["data"] * mesh.shape["model"] == len(jax.devices())
    mesh2 = make_mesh((2, 4))
    assert mesh2.shape == {"data": 2, "model": 4}


def test_partition_csr_roundtrip():
    g = ring_graph(10)
    parts = partition_csr(g, 4)
    vp = parts["vp"]
    # reassemble neighbor sets from shards
    for v in range(g.num_nodes):
        s, lv = divmod(v, vp)
        lo = parts["row_ptr"][s][lv]
        hi = parts["row_ptr"][s][lv + 1]
        nbrs = parts["col_idx"][s][lo:hi]
        np.testing.assert_array_equal(np.sort(nbrs), np.sort(g.neighbors(v)))
        assert parts["degree"][s][lv] == g.degree[v]


def test_distributed_walks_match_structure():
    g = ring_graph(32)
    mesh = make_mesh((len(jax.devices()), 1))
    walks, overflow = simulate_walks_distributed(
        g, mesh, num_walks=4, walk_length=6, key=jax.random.PRNGKey(0),
        slack=8,
    )
    assert overflow == 0
    assert walks.shape == (32 * 4, 6)
    # every consecutive pair is a real edge of the ring
    for row in walks[:50]:
        for a, b in zip(row[:-1], row[1:]):
            if a < 0 or b < 0:
                continue
            assert abs(a - b) in (1, 31)
    # all nodes walked
    assert set(walks[:, 0].tolist()) == set(range(32))


def test_distributed_walk_distribution_uniform():
    # star graph: hub 0, leaves 1..9 — from hub, next is uniform leaf
    k = 9
    src = np.zeros(k, dtype=int)
    dst = np.arange(1, k + 1)
    g = Graph(src, dst, directed=False)
    mesh = make_mesh((len(jax.devices()), 1))
    walks, overflow = simulate_walks_distributed(
        g, mesh, num_walks=400, walk_length=2, key=jax.random.PRNGKey(1),
        slack=16,
    )
    hub_rows = walks[walks[:, 0] == 0]
    freq = np.bincount(hub_rows[:, 1], minlength=k + 1)[1:]
    freq = freq / freq.sum()
    np.testing.assert_allclose(freq, 1 / k, atol=0.05)


def test_sharded_sgns_runs_and_learns():
    devs = len(jax.devices())
    shape = (devs // 2, 2) if devs % 2 == 0 and devs > 1 else (devs, 1)
    mesh = make_mesh(shape)
    V, D, L = 20, 16, 8
    rng = np.random.default_rng(2)
    walks = []
    for _ in range(256):
        side = rng.integers(0, 2)
        walks.append(rng.integers(side * 10, side * 10 + 10, size=L))
    walks = jnp.asarray(np.asarray(walks, dtype=np.int32))
    table = jnp.asarray(
        rng.integers(0, V, 1 << 12).astype(np.int32)
    )
    w_in = jnp.asarray(rng.uniform(-0.03, 0.03, (V, D)), jnp.float32)
    w_out = jnp.zeros((V, D), jnp.float32)

    bw = 8 * shape[0]
    fn = sharded_sgns_chunk(
        mesh, chunk_steps=8, block_walks=bw, window=3, negative=5,
        k_shared=8, neg_share_walks=4, sync_every=4,
    )
    # DP syncs SUM per-replica deltas (hogwild parity); on this
    # degenerate 20-row table every row is hot on every replica, so the
    # effective LR scales with the data-axis size — divide it back out
    # (real vocabularies are Zipf-sparse and don't need this)
    alpha = 0.05 / shape[0]
    t = 0
    with mesh:
        for c in range(8):
            w_in, w_out, losses = fn(
                w_in, w_out, walks, table, jax.random.PRNGKey(3),
                jnp.float32(alpha), jnp.float32(1e-4), jnp.int32(t),
                jnp.float32(64.0),
            )
            t += 8
    emb = np.array(np.asarray(w_in))
    assert np.isfinite(emb).all()
    emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sims = emb @ emb.T
    within = ((sims[:10, :10].sum() - 10) / 90
              + (sims[10:, 10:].sum() - 10) / 90) / 2
    across = sims[:10, 10:].mean()
    assert within > across + 0.3


def test_dryrun_multichip():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(len(jax.devices()))


def test_rowshard_fetch_and_push():
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from graphembedding.parallel.rowshard import fetch_rows, push_grads

    devs = len(jax.devices())
    mesh = make_mesh((devs, 1))
    V, C = devs * 4, 8
    w = jnp.arange(V * C, dtype=jnp.float32).reshape(V, C)
    rng = np.random.default_rng(0)
    T = 16
    # each device requests its own id set
    ids = jnp.asarray(rng.integers(0, V, (devs, T)).astype(np.int32))

    def body(w_local, ids_local):
        lo = jax.lax.axis_index("data") * (V // devs)
        rows = fetch_rows(w_local, ids_local[0], lo, "data")
        buf = push_grads(w_local, ids_local[0], rows, lo, "data")
        return rows[None], buf

    fn = shard_map(
        body, mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False,
    )
    with mesh:
        rows, buf = fn(w, ids)
    rows = np.asarray(rows).reshape(devs, T, C)
    ids_np = np.asarray(ids)
    for d in range(devs):
        np.testing.assert_array_equal(rows[d], np.asarray(w)[ids_np[d]])
    # push: every requested row was pushed back with its own value;
    # owner accumulates value * multiplicity
    buf = np.asarray(buf)
    expect = np.zeros((V, C), np.float32)
    for d in range(devs):
        np.add.at(expect, ids_np[d], np.asarray(w)[ids_np[d]])
    np.testing.assert_allclose(buf, expect, rtol=1e-6)


def test_rowsharded_sgns_runs_and_learns():
    from graphembedding.parallel.rowshard import rowsharded_sgns_chunk

    devs = len(jax.devices())
    mesh = make_mesh((devs, 1))
    D, L = 16, 8
    V = ((20 + devs - 1) // devs) * devs  # pad to divisibility
    rng = np.random.default_rng(2)
    walks = []
    for _ in range(256):
        side = rng.integers(0, 2)
        walks.append(rng.integers(side * 10, side * 10 + 10, size=L))
    walks = jnp.asarray(np.asarray(walks, dtype=np.int32))
    table = jnp.asarray(rng.integers(0, 20, 1 << 12).astype(np.int32))
    w_cat = jnp.concatenate(
        [
            jnp.asarray(rng.uniform(-0.03, 0.03, (V, D)), jnp.float32),
            jnp.zeros((V, D), jnp.float32),
        ],
        axis=1,
    )
    # the global step trains block_walks walks at once over only 20
    # distinct vertices; keep lr/block gentle at this toy density
    bw = 4 * devs
    fn = rowsharded_sgns_chunk(
        mesh, chunk_steps=8, block_walks=bw, window=3, negative=5,
        k_shared=8,
    )
    t = 0
    first = last = None
    with mesh:
        for c in range(8):
            w_cat, losses = fn(
                w_cat, walks, table, jax.random.PRNGKey(3),
                jnp.float32(0.02), jnp.float32(1e-4), jnp.int32(t),
                jnp.float32(64.0),
            )
            if first is None:
                first = float(jnp.mean(losses))
            last = float(jnp.mean(losses))
            t += 8
    assert np.isfinite(first) and np.isfinite(last)
    emb = np.asarray(w_cat)[:20, :D]
    assert np.isfinite(emb).all()
    emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sims = emb @ emb.T
    within = ((sims[:10, :10].sum() - 10) / 90
              + (sims[10:, 10:].sum() - 10) / 90) / 2
    across = sims[:10, 10:].mean()
    assert within > across + 0.3


def test_deepwalk_trains_over_mesh():
    """Model API multi-chip path: DeepWalk(...).train(mesh=...) via
    DistributedSkipGramTrainer (rowshard mode), end to end."""
    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.eval.classify import Classifier
    from graphembedding.models import DeepWalk

    ds = synthetic_wiki(num_nodes=120, num_classes=3, avg_degree=8,
                        seed=5)
    mesh = make_mesh((len(jax.devices()), 1))
    m = DeepWalk(ds.graph, walk_length=10, num_walks=20, seed=0)
    m.train(embed_size=32, window_size=5, iter=3, block_walks=64,
            mesh=mesh)
    res = Classifier(m.get_embeddings()).split_train_evaluate(
        ds.X, ds.Y, 0.8
    )
    assert res["micro"] >= 0.7, res["micro"]


def test_deepwalk_dp_mode_quality_gate():
    """dp-mode (replicated tables, delta-SUM hogwild sync) must hold
    the >= 0.9 community-test gate (VERDICT r1 item 10). Replica
    staleness was the round-1 gap (0.58 at once-per-chunk sync); the
    dp_sync_every=4 default closes it."""
    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.eval.classify import Classifier
    from graphembedding.models import DeepWalk

    ds = synthetic_wiki(num_nodes=120, num_classes=3, avg_degree=8,
                        seed=5)
    mesh = make_mesh((len(jax.devices()), 1))
    m = DeepWalk(ds.graph, walk_length=10, num_walks=20, seed=0)
    m.train(embed_size=32, window_size=5, iter=3, block_walks=64,
            mesh=mesh, parallel_mode="dp")
    res = Classifier(m.get_embeddings()).split_train_evaluate(
        ds.X, ds.Y, 0.8
    )
    assert res["micro"] >= 0.9, res["micro"]


@pytest.mark.parametrize("mode", ["rowshard", "dp"])
def test_distributed_trainer_checkpoint_resume(tmp_path, mode):
    from graphembedding.parallel.trainer import (
        DistributedSkipGramTrainer,
    )
    from graphembedding.train.skipgram import SkipGramConfig

    rng = np.random.default_rng(0)
    walks = rng.integers(0, 30, (128, 8)).astype(np.int32)
    mesh = make_mesh((len(jax.devices()), 1))
    cfg = SkipGramConfig(embed_size=8, epochs=2, chunk_steps=4,
                         block_walks=32)
    tr = DistributedSkipGramTrainer(mesh, cfg, mode=mode)
    ck = str(tmp_path / "ck")
    w_in, w_out, losses = tr.fit(walks, 30, jax.random.PRNGKey(0),
                                 checkpoint_dir=ck, checkpoint_every=1)
    assert np.isfinite(np.asarray(w_in)).all()
    n_chunks = losses.shape[0] // cfg.chunk_steps
    # resume: the saved step should skip all chunks => empty losses
    w_in2, w_out2, losses2 = tr.fit(walks, 30, jax.random.PRNGKey(0),
                                    checkpoint_dir=ck)
    assert losses2.shape[0] == 0
    np.testing.assert_allclose(np.asarray(w_in2), np.asarray(w_in),
                               rtol=1e-6)
    # MID-RUN resume: simulate a crash after the second chunk trains
    # but before it checkpoints (only chunk 1's state is on disk); the
    # resumed fit must retrain from chunk 2 and reproduce the
    # uninterrupted run bit-for-bit (chunk RNG is keyed by t0)
    class _Crash(Exception):
        pass

    class _CrashAfter:
        def __init__(self, at_step):
            self.at_step = at_step

        def log(self, **kw):
            if kw["step"] > self.at_step:
                raise _Crash()

    tr2 = DistributedSkipGramTrainer(mesh, cfg, mode=mode)
    ck2 = str(tmp_path / "ck2")
    with pytest.raises(_Crash):
        tr2.fit(walks, 30, jax.random.PRNGKey(0), checkpoint_dir=ck2,
                checkpoint_every=1,
                metrics=_CrashAfter(cfg.chunk_steps))
    w_res, _, l_res = tr2.fit(walks, 30, jax.random.PRNGKey(0),
                              checkpoint_dir=ck2)
    assert l_res.shape[0] == losses.shape[0] - cfg.chunk_steps
    np.testing.assert_allclose(np.asarray(w_res), np.asarray(w_in),
                               rtol=1e-6)


def test_distributed_trainer_rejects_foreign_checkpoint(tmp_path):
    from graphembedding.parallel.trainer import (
        DistributedSkipGramTrainer,
    )
    from graphembedding.train.skipgram import SkipGramConfig
    from graphembedding.utils.checkpoint import save_state

    ck = str(tmp_path / "ck")
    save_state(ck, {"w_in": np.zeros((4, 4), np.float32),
                    "w_out": np.zeros((4, 4), np.float32),
                    "step": np.asarray(4)})
    rng = np.random.default_rng(0)
    walks = rng.integers(0, 30, (64, 8)).astype(np.int32)
    mesh = make_mesh((len(jax.devices()), 1))
    cfg = SkipGramConfig(embed_size=8, epochs=1, chunk_steps=4,
                         block_walks=32)
    tr = DistributedSkipGramTrainer(mesh, cfg, mode="rowshard")
    with pytest.raises(ValueError, match="lacks keys"):
        tr.fit(walks, 30, jax.random.PRNGKey(0), checkpoint_dir=ck)


def test_sharded_hs_runs_and_learns():
    """DP×TP hierarchical-softmax chunk separates two communities."""
    from graphembedding.parallel.hsoftmax import sharded_hs_chunk
    from graphembedding.train.hsoftmax import build_huffman

    devs = len(jax.devices())
    shape = (devs // 2, 2) if devs % 2 == 0 and devs > 1 else (devs, 1)
    mesh = make_mesh(shape)
    V, D, L = 20, 16, 8
    rng = np.random.default_rng(2)
    walks = []
    for _ in range(256):
        side = rng.integers(0, 2)
        walks.append(rng.integers(side * 10, side * 10 + 10, size=L))
    walks_np = np.asarray(walks, dtype=np.int32)
    walks = jnp.asarray(walks_np)
    counts = np.bincount(walks_np.ravel(), minlength=V)
    points, codes, _ = build_huffman(counts)
    points, codes = jnp.asarray(points), jnp.asarray(codes)

    w_in = jnp.asarray(rng.uniform(-0.03, 0.03, (V, D)), jnp.float32)
    w_tree = jnp.zeros((V - 1, D), jnp.float32)

    bw = 8 * shape[0]
    fn = sharded_hs_chunk(
        mesh, chunk_steps=8, block_walks=bw, window=3, sync_every=4
    )
    t = 0
    with mesh:
        for c in range(8):
            w_in, w_tree, losses = fn(
                w_in, w_tree, walks, points, codes, jax.random.PRNGKey(3),
                jnp.float32(0.08), jnp.float32(1e-4), jnp.int32(t),
                jnp.float32(64.0),
            )
            t += 8
    assert np.isfinite(np.asarray(losses)).all()
    emb = np.array(np.asarray(w_in))
    assert np.isfinite(emb).all()
    emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sims = emb @ emb.T
    within = ((sims[:10, :10].sum() - 10) / 90
              + (sims[10:, 10:].sum() - 10) / 90) / 2
    across = sims[:10, 10:].mean()
    assert within > across + 0.3


def test_sharded_hs_matches_single_device_quality():
    """HSTrainer(mesh=...) reaches the single-device trainer's F1 on a
    small community graph (same walks, same budget)."""
    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.eval.classify import Classifier
    from graphembedding.models import DeepWalk

    ds = synthetic_wiki(num_nodes=120, num_classes=3, avg_degree=8,
                        seed=5)
    mesh = make_mesh((len(jax.devices()), 1))
    m = DeepWalk(ds.graph, walk_length=10, num_walks=20, seed=0)
    m.train(embed_size=32, window_size=5, iter=3, hs=1, mesh=mesh)
    res = Classifier(m.get_embeddings()).split_train_evaluate(
        ds.X, ds.Y, 0.8
    )
    assert res["micro"] >= 0.7, res["micro"]


def test_line_trains_over_mesh():
    """LINE(...).train(mesh=...) — DP edge batches — reaches the
    single-device quality gate on a small community graph."""
    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.eval.classify import Classifier
    from graphembedding.models import LINE

    ds = synthetic_wiki(num_nodes=120, num_classes=3, avg_degree=8,
                        seed=5)
    mesh = make_mesh((len(jax.devices()), 1))
    m = LINE(ds.graph, embedding_size=32, order="second")
    m.train(batch_size=256, epochs=60, mesh=mesh, sync_every=16)
    res = Classifier(m.get_embeddings()).split_train_evaluate(
        ds.X, ds.Y, 0.8
    )
    assert res["micro"] >= 0.6, res["micro"]


def test_line_mesh_rejects_model_axis():
    from graphembedding.parallel.line import sharded_line_chunk

    devs = len(jax.devices())
    if devs < 2:
        pytest.skip("needs >= 2 devices")
    mesh = make_mesh((devs // 2, 2))
    with pytest.raises(ValueError, match="data axis only"):
        sharded_line_chunk(mesh, chunk_steps=4, batch_size=64,
                           negative=5, order_first=False)


def test_sdne_mesh_matches_single_device():
    """Row-sharded SDNE is EXACT: same per-epoch losses and embeddings
    as the single-device full-batch run (modulo f32 reduction order)."""
    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.models import SDNE

    ds = synthetic_wiki(num_nodes=100, num_classes=3, avg_degree=8,
                        seed=3)
    kw = dict(hidden_size=[32, 16], seed=0)
    m1 = SDNE(ds.graph, **kw)
    m1.train(batch_size=1024, epochs=8)
    m2 = SDNE(ds.graph, **kw)
    mesh = make_mesh((len(jax.devices()), 1))
    m2.train(batch_size=1024, epochs=8, mesh=mesh)

    l1 = np.asarray(m1.losses)
    l2 = np.asarray(m2.losses)
    np.testing.assert_allclose(l1, l2, rtol=2e-3)
    e1 = np.asarray(m1.embedding_table)
    e2 = np.asarray(m2.embedding_table)
    # cosine similarity per node ~ 1
    num = (e1 * e2).sum(-1)
    den = np.linalg.norm(e1, axis=-1) * np.linalg.norm(e2, axis=-1)
    assert (num / np.maximum(den, 1e-9)).min() > 0.99


def test_sdne_sparse_mesh_matches_single_device():
    """Row-sharded train_sparse is EXACT: same per-epoch losses and
    embeddings as the single-device sparse run (modulo f32 reduction
    order) — the dense [V, V] A/L are never built on either path."""
    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.models import SDNE

    ds = synthetic_wiki(num_nodes=100, num_classes=3, avg_degree=8,
                        seed=3)
    kw = dict(hidden_size=[32, 16], seed=0)
    m1 = SDNE(ds.graph, **kw)
    m1.train_sparse(epochs=8, row_chunk=8)
    m2 = SDNE(ds.graph, **kw)
    mesh = make_mesh((len(jax.devices()), 1))
    m2.train_sparse(epochs=8, row_chunk=8, mesh=mesh)

    assert m1._A is None and m2._A is None  # stayed sparse
    np.testing.assert_allclose(
        np.asarray(m1.losses), np.asarray(m2.losses), rtol=2e-3
    )
    e1 = np.asarray(m1.embedding_table)
    e2 = np.asarray(m2.embedding_table)
    num = (e1 * e2).sum(-1)
    den = np.linalg.norm(e1, axis=-1) * np.linalg.norm(e2, axis=-1)
    assert (num / np.maximum(den, 1e-9)).min() > 0.99


def test_sdne_sparse_mesh_matches_dense_objective():
    """The sharded sparse loss equals the dense full-batch loss on the
    same params (the sparse rewrite is the identical objective)."""
    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.models import SDNE

    ds = synthetic_wiki(num_nodes=70, num_classes=3, avg_degree=6,
                        seed=7)
    m_dense = SDNE(ds.graph, hidden_size=[24, 12], seed=1)
    m_dense.train(batch_size=1024, epochs=3)
    m_sparse = SDNE(ds.graph, hidden_size=[24, 12], seed=1)
    mesh = make_mesh((len(jax.devices()), 1))
    m_sparse.train_sparse(epochs=3, row_chunk=4, mesh=mesh)
    np.testing.assert_allclose(
        np.asarray(m_dense.losses), np.asarray(m_sparse.losses),
        rtol=2e-3,
    )


def test_sdne_mesh_rejects_minibatch():
    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.models import SDNE

    ds = synthetic_wiki(num_nodes=100, num_classes=3, avg_degree=8,
                        seed=3)
    mesh = make_mesh((len(jax.devices()), 1))
    m = SDNE(ds.graph, hidden_size=[32, 16])
    with pytest.raises(NotImplementedError, match="full-batch"):
        m.train(batch_size=10, epochs=1, mesh=mesh)


def test_struc2vec_trains_over_mesh(tmp_path):
    """Struc2Vec's default hs=1 trainer composes with mesh= end to end
    (context graph on host, multilayer walks + sharded HS on devices)."""
    from graphembedding.data.datasets import synthetic_flight
    from graphembedding.eval.classify import Classifier
    from graphembedding.models import Struc2Vec

    ds = synthetic_flight(num_nodes=60, seed=1)
    mesh = make_mesh((len(jax.devices()), 1))
    m = Struc2Vec(ds.graph, walk_length=8, num_walks=12,
                  temp_path=str(tmp_path) + "/", seed=0)
    m.train(embed_size=24, window_size=3, iter=2, mesh=mesh)
    res = Classifier(m.get_embeddings()).split_train_evaluate(
        ds.X, ds.Y, 0.8
    )
    assert np.isfinite(np.asarray(m.losses)).all()
    assert res["micro"] >= 0.4, res["micro"]  # smoke gate (tiny graph)


def test_mesh_trainers_reject_tiny_corpora():
    """A corpus with fewer walks than data-axis devices must error
    loudly (a clamped dynamic_slice would silently duplicate rows)."""
    from graphembedding.parallel.trainer import (
        DistributedSkipGramTrainer,
    )
    from graphembedding.train.hsoftmax import HSTrainer

    devs = len(jax.devices())
    if devs < 2:
        pytest.skip("needs >= 2 devices")
    mesh = make_mesh((devs, 1))
    walks = np.zeros((devs - 1, 5), dtype=np.int32)
    with pytest.raises(ValueError, match="data axis"):
        DistributedSkipGramTrainer(mesh).fit(walks, 10)
    with pytest.raises(ValueError, match="data axis"):
        HSTrainer(mesh=mesh).fit(walks, 10)


def test_line_mesh_rejects_ragged_batch():
    from graphembedding.parallel.line import sharded_line_chunk

    devs = len(jax.devices())
    if devs < 2:
        pytest.skip("needs >= 2 devices")
    mesh = make_mesh((devs, 1))
    with pytest.raises(ValueError, match="divide evenly"):
        sharded_line_chunk(mesh, chunk_steps=4,
                           batch_size=devs * 3 + 1, negative=5,
                           order_first=False)


# --------------------------------------------------------------------------- #
# distributed non-uniform walk engines (round-2: weighted / node2vec /
# multilayer) — distribution-tested against the exact probabilities and
# the replicated single-chip kernels, per the tests/test_walks.py pattern
# --------------------------------------------------------------------------- #


def test_distributed_weighted_walk_distribution():
    """Weighted star: hub next-hop frequency tracks the edge weights."""
    k = 6
    src = np.zeros(k, dtype=int)
    dst = np.arange(1, k + 1)
    w = np.arange(1, k + 1, dtype=np.float32)
    g = Graph(src, dst, weight=w, directed=False)
    mesh = make_mesh((len(jax.devices()), 1))
    walks, overflow = simulate_walks_distributed(
        g, mesh, num_walks=800, walk_length=2,
        key=jax.random.PRNGKey(2), kind="weighted", slack=16,
    )
    assert overflow == 0
    hub_rows = walks[walks[:, 0] == 0]
    assert len(hub_rows) == 800
    freq = np.bincount(hub_rows[:, 1], minlength=k + 1)[1:]
    freq = freq / freq.sum()
    target = w / w.sum()
    np.testing.assert_allclose(freq, target, atol=0.045)


@pytest.mark.parametrize("p,q", [(0.25, 4.0), (4.0, 0.25)])
def test_distributed_node2vec_exact_distribution(p, q):
    """Second-order (p,q) step matches the exact transition probs even
    when prev's neighbor row lives on another shard (halo fetch)."""
    from tests.test_walks import (
        exact_pq_second_step_dist,
        triangle_with_tail,
    )

    g = triangle_with_tail()  # V=4: one vertex per shard at 8 devices
    mesh = make_mesh((len(jax.devices()), 1))
    walks, overflow = simulate_walks_distributed(
        g, mesh, num_walks=6000, walk_length=3,
        key=jax.random.PRNGKey(3), kind="node2vec", p=p, q=q, slack=4,
    )
    assert overflow == 0
    start0 = walks[walks[:, 0] == 0]
    for mid in [1, 2]:
        sel = start0[start0[:, 1] == mid]
        if len(sel) < 1000:
            continue
        nbrs, target = exact_pq_second_step_dist(g, 0, mid, p, q)
        freq = np.bincount(sel[:, 2], minlength=g.num_nodes)[nbrs]
        freq = freq / freq.sum()
        np.testing.assert_allclose(freq, target, atol=0.035)


def zipf_hub_graph(V=64, seed=0):
    """Power-law-ish graph: ring for connectivity + geometric hub fans.

    Shard 0 owns all four hubs, so its stationary walker load is ~2.3x
    the uniform share — the shape that overflow-killed the round-1
    bucketed router."""
    rng = np.random.default_rng(seed)
    edges = {(i, (i + 1) % V) for i in range(V)}
    for hub, fan in enumerate([V // 2, V // 4, V // 8, V // 16]):
        for t in rng.choice(V, fan, replace=False):
            t = int(t)
            if t != hub:
                edges.add((min(hub, t), max(hub, t)))
    src, dst = map(np.asarray, zip(*sorted(edges)))
    return Graph(src, dst, directed=False)


def test_distributed_walks_zipf_hub_no_overflow():
    """VERDICT r1 item 2: Zipf-degree 8-shard run with overflow == 0 and
    token distribution matching the replicated single-chip engine."""
    from graphembedding.ops.walk import simulate_walks

    g = zipf_hub_graph()
    mesh = make_mesh((len(jax.devices()), 1))
    walks_d, overflow = simulate_walks_distributed(
        g, mesh, num_walks=30, walk_length=10,
        key=jax.random.PRNGKey(4), slack=8,
    )
    assert overflow == 0
    walks_r = np.asarray(
        simulate_walks(g, num_walks=30, walk_length=10,
                       key=jax.random.PRNGKey(5))
    )
    f_d = np.bincount(walks_d[walks_d >= 0], minlength=g.num_nodes)
    f_r = np.bincount(walks_r[walks_r >= 0], minlength=g.num_nodes)
    np.testing.assert_allclose(
        f_d / f_d.sum(), f_r / f_r.sum(), atol=0.02
    )


def test_distributed_multilayer_matches_replicated():
    """Distributed struc2vec walks match the single-chip multilayer
    kernel's visit distribution on the same layer stack."""
    from graphembedding.models.struc2vec import (
        build_context_graph,
        build_layer_csr,
        multilayer_walks,
    )
    from graphembedding.parallel.walks import (
        simulate_multilayer_walks_distributed,
    )

    g = zipf_hub_graph(V=24, seed=1)
    layer_edges, _ = build_context_graph(g)
    layers = build_layer_csr(layer_edges, g.num_nodes)
    mesh = make_mesh((len(jax.devices()), 1))
    nw, L = 60, 8
    walks_d, overflow = simulate_multilayer_walks_distributed(
        layers, g.num_nodes, mesh, num_walks=nw, walk_length=L,
        key=jax.random.PRNGKey(6), slack=8,
    )
    assert overflow == 0
    assert walks_d.shape == (nw * g.num_nodes, L)
    assert (walks_d >= 0).all() and (walks_d < g.num_nodes).all()
    starts = jnp.tile(jnp.arange(g.num_nodes, dtype=jnp.int32), nw)
    walks_r = np.asarray(multilayer_walks(
        jnp.asarray(layers["row_ptr"]), jnp.asarray(layers["col_idx"]),
        jnp.asarray(layers["accept"]), jnp.asarray(layers["alias"]),
        jnp.asarray(layers["gamma"]), starts, jax.random.PRNGKey(7),
        jnp.float32(0.3), length=L,
    ))
    f_d = np.bincount(walks_d.ravel(), minlength=g.num_nodes)
    f_r = np.bincount(walks_r.ravel(), minlength=g.num_nodes)
    np.testing.assert_allclose(
        f_d / f_d.sum(), f_r / f_r.sum(), atol=0.03
    )


def test_batched_walk_engine_correctness():
    """Round-3 locality-batched engine (hop_batch > 0): every recorded
    hop is a real edge, no token holes, zero drops (backpressure), and
    visit distribution matches the plain per-hop engine."""
    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.parallel.walks import DistributedWalker

    ds = synthetic_wiki(num_nodes=200, num_classes=4, avg_degree=6,
                        seed=3)
    g = ds.graph
    mesh = make_mesh((len(jax.devices()), 1))
    wb = DistributedWalker(g, mesh, 12, kind="uniform", num_walks=20,
                           hop_batch=4)
    walks, ov = wb.run(jax.random.PRNGKey(0))
    assert ov == 0
    assert walks.shape[0] == 20 * g.num_nodes
    assert wb.last_rounds is not None and wb.last_rounds >= 1
    nbrs = {v: set(g.neighbors(v).tolist())
            for v in range(g.num_nodes)}
    for row in walks:
        toks = row[row >= 0]
        assert (row[: len(toks)] >= 0).all()  # contiguous prefix
        for a, b in zip(toks[:-1], toks[1:]):
            assert b in nbrs[int(a)]
    wp = DistributedWalker(g, mesh, 12, kind="uniform", num_walks=40)
    pw, _ = wp.run(jax.random.PRNGKey(1))
    bw2, _ = wb.run(jax.random.PRNGKey(2))
    fb = np.bincount(bw2[bw2 >= 0].ravel(), minlength=g.num_nodes)
    fp = np.bincount(pw[pw >= 0].ravel(), minlength=g.num_nodes)
    l1 = np.abs(fb / fb.sum() - fp / fp.sum()).sum()
    assert l1 < 0.08, l1


def test_batched_walk_engine_zipf_backpressure():
    """Hub graph: the batched engine's backpressure must never drop a
    walker at send; overflow stays 0 where the plain engine's
    receiver-cap rule also holds."""
    from graphembedding.parallel.walks import DistributedWalker

    g = zipf_hub_graph()
    mesh = make_mesh((len(jax.devices()), 1))
    w = DistributedWalker(g, mesh, 10, kind="uniform", num_walks=30,
                          hop_batch=4, slack=8, send_slack=1.0)
    walks, ov = w.run(jax.random.PRNGKey(4))
    assert ov == 0
    assert walks.shape[0] == 30 * g.num_nodes


def test_locality_order_and_relabel():
    """RCM relabeling: valid permutation, and walks come back in the
    caller's original ids (every hop a real edge of the ORIGINAL
    graph)."""
    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.parallel.walks import (
        DistributedWalker,
        locality_order,
        relabel_graph,
    )

    ds = synthetic_wiki(num_nodes=150, num_classes=3, avg_degree=5,
                        seed=9)
    g = ds.graph
    perm = locality_order(g)
    assert sorted(perm.tolist()) == list(range(g.num_nodes))
    g2 = relabel_graph(g, perm)
    assert g2.num_edges == g.num_edges
    mesh = make_mesh((len(jax.devices()), 1))
    w = DistributedWalker(g, mesh, 8, kind="uniform", num_walks=5,
                          hop_batch=2, relabel="locality")
    walks, ov = w.run(jax.random.PRNGKey(5))
    nbrs = {v: set(g.neighbors(v).tolist())
            for v in range(g.num_nodes)}
    for row in walks[:200]:
        toks = row[row >= 0]
        for a, b in zip(toks[:-1], toks[1:]):
            assert b in nbrs[int(a)]


def test_distributed_node2vec_rejection_dmax_safe():
    """VERDICT r2 item 4: the CSR-only rejection engine handles a
    Dmax >> mean-degree graph with O(E/n) memory (no [Vp, Dmax]
    matrix), zero overflow, and a visit distribution matching the
    replicated exact kernel within the exact-vs-exact noise floor."""
    from graphembedding.graph import Graph
    from graphembedding.ops.walk import simulate_walks
    from graphembedding.parallel.walks import DistributedWalker

    rng = np.random.default_rng(0)
    V = 400
    src = list(range(V))
    dst = [(i + 1) % V for i in range(V)]
    for t in rng.choice(V, 300, replace=False):
        if t != 0:
            src += [0, int(t)]
            dst += [int(t), 0]
    g = Graph(np.array(src + dst), np.array(dst + src), num_nodes=V,
              directed=False)
    assert g.degree.max() > 50 * np.median(g.degree)
    mesh = make_mesh((len(jax.devices()), 1))
    w = DistributedWalker(g, mesh, 10, kind="node2vec_rejection",
                          num_walks=40, p=0.25, q=4.0, slack=8)
    walks, ov = w.run(jax.random.PRNGKey(1))
    assert ov == 0
    # every hop a real edge
    nbrs = {v: set(g.neighbors(v).tolist()) for v in range(V)}
    for row in walks[:300]:
        toks = row[row >= 0]
        for a, b in zip(toks[:-1], toks[1:]):
            assert b in nbrs[int(a)]
    rep = np.asarray(simulate_walks(g, 40, 10, jax.random.PRNGKey(2),
                                    kind="node2vec", p=0.25, q=4.0))
    f_d = np.bincount(walks[walks >= 0].ravel(), minlength=V)
    f_r = np.bincount(rep[rep >= 0].ravel(), minlength=V)
    l1 = np.abs(f_d / f_d.sum() - f_r / f_r.sum()).sum()
    # measured exact-vs-exact noise floor on this graph/budget: 0.062
    assert l1 < 0.1, l1


@pytest.mark.parametrize("model_name", ["deepwalk", "node2vec",
                                        "struc2vec"])
def test_model_mesh_end_to_end(model_name, tmp_path):
    """VERDICT r2 item 3: Model(G, mesh=...) runs the WALK phase
    sharded (edge-partitioned engines) AND training sharded, end to
    end through the reference API, and clears the community /
    structural quality gate."""
    from graphembedding.data.datasets import (
        synthetic_flight,
        synthetic_wiki,
    )
    from graphembedding.eval.classify import Classifier
    from graphembedding.models import DeepWalk, Node2Vec, Struc2Vec

    mesh = make_mesh((len(jax.devices()), 1))
    if model_name == "struc2vec":
        ds = synthetic_flight(num_nodes=40, seed=2)
        m = Struc2Vec(ds.graph, walk_length=8, num_walks=30,
                      temp_path=str(tmp_path) + "/", mesh=mesh)
        m.train(embed_size=24, window_size=4, iter=4, hs=1)
        gate = 0.5  # structural-role task, tiny graph
    else:
        ds = synthetic_wiki(num_nodes=120, num_classes=3, avg_degree=8,
                            seed=5)
        cls = DeepWalk if model_name == "deepwalk" else Node2Vec
        kw = {} if model_name == "deepwalk" else {"p": 0.5, "q": 2.0}
        m = cls(ds.graph, walk_length=10, num_walks=20, mesh=mesh, **kw)
        assert m.walk_overflow == 0
        m.train(embed_size=32, window_size=5, iter=3, block_walks=64,
                parallel_mode="dp")
        gate = 0.9
    res = Classifier(m.get_embeddings()).split_train_evaluate(
        ds.X, ds.Y, 0.8
    )
    assert res["micro"] >= gate, (model_name, res["micro"])


def test_rowshard_prefetch_quality_gate():
    """SURVEY §8.4-6 double-buffered halo: rowshard with one-step-stale
    prefetched rows must score within a small margin of the EXACT
    synchronous rowshard run on the community test (measured cost of
    the one-step staleness at this config: ~0.04 micro-F1)."""
    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.eval.classify import Classifier
    from graphembedding.models import DeepWalk

    ds = synthetic_wiki(num_nodes=120, num_classes=3, avg_degree=8,
                        seed=5)
    mesh = make_mesh((len(jax.devices()), 1))
    scores = {}
    for pf in (False, True):
        m = DeepWalk(ds.graph, walk_length=10, num_walks=20, seed=0)
        m.train(embed_size=32, window_size=5, iter=3, block_walks=64,
                mesh=mesh, parallel_mode="rowshard",
                rowshard_prefetch=pf)
        scores[pf] = Classifier(m.get_embeddings()).split_train_evaluate(
            ds.X, ds.Y, 0.8
        )["micro"]
    assert scores[True] >= scores[False] - 0.1, scores
    assert scores[True] >= 0.65, scores
