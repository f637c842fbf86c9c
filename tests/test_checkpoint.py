import os

import numpy as np

from graphembedding.train.skipgram import SkipGramConfig, SkipGramTrainer
from graphembedding.utils.checkpoint import (
    cache_artifact,
    content_key,
    load_artifact,
    load_state,
    save_state,
)
from graphembedding.utils.metrics import MetricsLogger


def test_save_load_state_roundtrip(tmp_path):
    state = {
        "w": np.arange(12, dtype=np.float32).reshape(3, 4),
        "step": np.asarray(7),
    }
    p = str(tmp_path / "ckpt")
    save_state(p, state)
    got = load_state(p)
    np.testing.assert_array_equal(got["w"], state["w"])
    assert int(got["step"]) == 7


def test_artifact_cache_roundtrip(tmp_path):
    key = content_key(np.arange(5), extra="v1")
    assert load_artifact(str(tmp_path), key) is None
    cache_artifact(str(tmp_path), key, {"x": [1, 2, 3]})
    assert load_artifact(str(tmp_path), key) == {"x": [1, 2, 3]}
    # different content -> different key
    assert content_key(np.arange(6), extra="v1") != key


def test_trainer_checkpoint_resume(tmp_path):
    rng = np.random.default_rng(0)
    walks = rng.integers(0, 30, (128, 6)).astype(np.int32)
    cfg = SkipGramConfig(embed_size=8, window=2, epochs=4,
                         block_walks=32, k_shared=8, chunk_steps=4)
    ckpt = str(tmp_path / "sgns")

    # full run with checkpointing
    tr = SkipGramTrainer(cfg)
    w_in_full, _, _ = tr.fit(walks, 30, checkpoint_dir=ckpt,
                             checkpoint_every=1)
    state = load_state(ckpt)
    assert int(state["step"]) > 0

    # resume: a fresh fit with an existing checkpoint skips done chunks
    # and produces finite tables
    w_in2, _, losses2 = SkipGramTrainer(cfg).fit(
        walks, 30, checkpoint_dir=ckpt, checkpoint_every=0
    )
    assert np.isfinite(np.asarray(w_in2)).all()
    # resumed run trains fewer chunks than a cold run
    assert losses2.shape[0] < cfg.epochs * (128 // 32)


def test_metrics_logger(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with MetricsLogger(path, quiet=True) as m:
        m.log(kind="test", loss=1.5)
        m.log(kind="test", loss=1.2)
    lines = open(path).read().strip().split("\n")
    assert len(lines) == 2
    import json

    rec = json.loads(lines[0])
    assert rec["kind"] == "test" and rec["loss"] == 1.5


def test_trainer_metrics_integration(tmp_path):
    rng = np.random.default_rng(1)
    walks = rng.integers(0, 20, (64, 5)).astype(np.int32)
    cfg = SkipGramConfig(embed_size=8, window=2, epochs=1,
                         block_walks=16, k_shared=8, chunk_steps=2)
    path = str(tmp_path / "train.jsonl")
    with MetricsLogger(path, quiet=True) as m:
        SkipGramTrainer(cfg).fit(walks, 20, metrics=m)
    assert os.path.getsize(path) > 0


def test_line_checkpoint_resume(tmp_path):
    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.models import LINE

    ds = synthetic_wiki(num_nodes=80, avg_degree=6)
    ckpt = str(tmp_path / "line")
    m = LINE(ds.graph, embedding_size=8, order="second", seed=3)
    m.train(batch_size=64, epochs=20, checkpoint_dir=ckpt,
            checkpoint_every=1)
    n_full = int(np.asarray(m.losses).shape[0])
    assert os.path.exists(os.path.join(ckpt, "second"))

    # a fresh model resumes from the saved chunk and trains less
    m2 = LINE(ds.graph, embedding_size=8, order="second", seed=3)
    m2.train(batch_size=64, epochs=20, checkpoint_dir=ckpt,
             checkpoint_every=0)
    assert int(np.asarray(m2.losses).shape[0]) < n_full
    assert np.isfinite(
        next(iter(m2.get_embeddings().values()))
    ).all()


def test_sdne_checkpoint_resume(tmp_path):
    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.models import SDNE

    ds = synthetic_wiki(num_nodes=60, avg_degree=5)
    ckpt = str(tmp_path / "sdne")
    m = SDNE(ds.graph, hidden_size=[16, 8])
    m.train(batch_size=1024, epochs=6, checkpoint_dir=ckpt,
            checkpoint_every=2)
    assert int(np.asarray(m.losses).shape[0]) == 6

    # fresh model resumes at epoch 6 -> zero additional epochs
    m2 = SDNE(ds.graph, hidden_size=[16, 8])
    m2.train(batch_size=1024, epochs=6, checkpoint_dir=ckpt,
             checkpoint_every=2)
    assert int(np.asarray(m2.losses).shape[0]) == 0
    # and its restored params produce finite embeddings
    assert np.isfinite(
        next(iter(m2.get_embeddings().values()))
    ).all()


def test_try_restore_sharded_roundtrip(tmp_path):
    """Sharded arrays round-trip WITH their shardings (the multi-host
    global-array checkpoint path used by the distributed trainer)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from graphembedding.parallel.mesh import make_mesh
    from graphembedding.utils.checkpoint import (
        save_state,
        try_restore_sharded,
    )

    mesh = make_mesh((len(jax.devices()), 1))
    sh = NamedSharding(mesh, P("data", None))
    V = len(jax.devices()) * 4
    w = jax.device_put(
        jnp.arange(V * 8, dtype=jnp.float32).reshape(V, 8), sh
    )
    path = str(tmp_path / "ck")
    save_state(path, {"w_cat": w, "step": np.asarray(7)})

    template = {"w_cat": jax.device_put(jnp.zeros_like(w), sh),
                "step": np.asarray(0)}
    state = try_restore_sharded(path, template)
    assert state["w_cat"].sharding.is_equivalent_to(sh, 2)
    np.testing.assert_array_equal(np.asarray(state["w_cat"]),
                                  np.asarray(w))
    assert int(state["step"]) == 7
    # schema guard: a template with a foreign key refuses to restore
    import pytest

    with pytest.raises(ValueError, match="lacks keys"):
        try_restore_sharded(path, {"w_in": w, "step": np.asarray(0)})


def test_try_restore_sharded_missing_dir(tmp_path):
    from graphembedding.utils.checkpoint import try_restore_sharded

    assert try_restore_sharded(str(tmp_path / "nope"), {"a": 1}) is None


def test_hs_trainer_checkpoint_resume_and_metrics(tmp_path):
    """HSTrainer mirrors SkipGramTrainer's checkpoint/metrics hooks."""
    from graphembedding.train.hsoftmax import HSTrainer

    rng = np.random.default_rng(0)
    walks = rng.integers(0, 30, (128, 6)).astype(np.int32)
    ckpt = str(tmp_path / "hs")
    mpath = str(tmp_path / "hs.jsonl")
    kw = dict(embed_size=8, window=2, epochs=4, block_walks=32,
              chunk_steps=4)

    with MetricsLogger(mpath, quiet=True) as m:
        w_in_full, _, losses = HSTrainer(**kw).fit(
            walks, 30, checkpoint_dir=ckpt, checkpoint_every=1,
            metrics=m,
        )
    assert np.isfinite(np.asarray(w_in_full)).all()
    state = load_state(ckpt)
    assert int(state["step"]) > 0
    lines = open(mpath).read().strip().split("\n")
    assert len(lines) == losses.shape[0] // 4  # one line per chunk

    # resume: fewer chunks than a cold run, finite tables
    w_in2, _, losses2 = HSTrainer(**kw).fit(
        walks, 30, checkpoint_dir=ckpt, checkpoint_every=0
    )
    assert np.isfinite(np.asarray(w_in2)).all()
    assert losses2.shape[0] < losses.shape[0]


def test_deepwalk_model_checkpoint_kwargs(tmp_path):
    """checkpoint_dir/-every thread through the model-layer train()."""
    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.models import DeepWalk

    ds = synthetic_wiki(num_nodes=60, num_classes=3, avg_degree=6,
                        seed=0)
    ckpt = str(tmp_path / "dw")
    m = DeepWalk(ds.graph, walk_length=5, num_walks=4)
    m.train(embed_size=16, window_size=2, iter=2,
            checkpoint_dir=ckpt, checkpoint_every=1)
    state = load_state(ckpt)
    assert int(state["step"]) > 0
    m2 = DeepWalk(ds.graph, walk_length=5, num_walks=4)
    m2.train(embed_size=16, window_size=2, iter=2, hs=1,
             checkpoint_dir=str(tmp_path / "dw_hs"),
             checkpoint_every=1)
    assert int(load_state(str(tmp_path / "dw_hs"))["step"]) > 0


def test_sdne_sparse_checkpoint_resume_large_v(tmp_path):
    """train_sparse resume at V >= 10k (VERDICT r1 item 7): an
    interrupted run resumed from its Orbax checkpoint reproduces the
    uninterrupted run's remaining per-epoch losses exactly (the sparse
    path is deterministic and Adam state is checkpointed)."""
    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.models import SDNE

    ds = synthetic_wiki(num_nodes=10_000, num_classes=4, avg_degree=4,
                        seed=11)
    kw = dict(hidden_size=[16, 8], seed=0)

    m_full = SDNE(ds.graph, **kw)
    m_full.train_sparse(epochs=4, row_chunk=64)
    assert m_full._A is None  # dense [V, V] never built

    ckpt = str(tmp_path / "sdne_sparse")
    m_a = SDNE(ds.graph, **kw)
    m_a.train_sparse(epochs=2, row_chunk=64, checkpoint_dir=ckpt,
                     checkpoint_every=1)
    m_b = SDNE(ds.graph, **kw)  # fresh process stand-in
    m_b.train_sparse(epochs=4, row_chunk=64, checkpoint_dir=ckpt,
                     checkpoint_every=1)
    # resumed run executed only epochs 3..4
    lb = np.asarray(m_b.losses)
    assert lb.shape[0] == 2
    np.testing.assert_allclose(
        np.asarray(m_full.losses)[2:], lb, rtol=1e-4
    )


def test_sdne_sparse_mesh_checkpoint_resume(tmp_path):
    """checkpoint/resume composes with the row-sharded sparse mesh
    path (replicated params checkpoint + restore)."""
    import jax

    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.models import SDNE
    from graphembedding.parallel.mesh import make_mesh

    ds = synthetic_wiki(num_nodes=80, num_classes=3, avg_degree=6,
                        seed=2)
    mesh = make_mesh((len(jax.devices()), 1))
    ckpt = str(tmp_path / "sdne_sparse_mesh")
    kw = dict(hidden_size=[16, 8], seed=0)
    m = SDNE(ds.graph, **kw)
    m.train_sparse(epochs=2, row_chunk=4, mesh=mesh,
                   checkpoint_dir=ckpt, checkpoint_every=1)
    m2 = SDNE(ds.graph, **kw)
    m2.train_sparse(epochs=4, row_chunk=4, mesh=mesh,
                    checkpoint_dir=ckpt, checkpoint_every=1)
    assert np.asarray(m2.losses).shape[0] == 2
    assert np.isfinite(
        next(iter(m2.get_embeddings().values()))
    ).all()
