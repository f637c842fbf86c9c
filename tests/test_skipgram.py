import jax
import jax.numpy as jnp
import numpy as np

from graphembedding.train.skipgram import (
    SkipGramConfig,
    SkipGramTrainer,
    corpus_counts,
    negative_table,
    sgns_block_chunk,
)


def test_corpus_counts_masks_padding():
    walks = np.array([[0, 1, 2, -1], [1, 1, -1, -1]])
    counts = corpus_counts(walks, 4)
    np.testing.assert_array_equal(counts, [1, 3, 1, 0])


def test_negative_table_distribution():
    counts = np.array([10.0, 90.0, 0.0, 1.0])
    table = negative_table(counts, exponent=0.75, size=1 << 16)
    freq = np.bincount(table, minlength=4) / table.shape[0]
    p = counts**0.75
    p /= p.sum()
    np.testing.assert_allclose(freq, p, atol=2e-3)
    assert freq[2] == 0  # zero-count node never sampled


def test_sgns_chunk_runs_and_decreases_loss():
    rng = np.random.default_rng(0)
    V, NW, L = 50, 256, 8
    # structured corpus: walks alternate within two communities
    comm = rng.integers(0, 2, V)
    walks = np.stack([
        rng.choice(np.where(comm == rng.integers(0, 2))[0], size=L)
        for _ in range(NW)
    ]).astype(np.int32)
    table = jnp.asarray(negative_table(corpus_counts(walks, V), size=4096))
    w_in = (jax.random.uniform(jax.random.PRNGKey(0), (V, 16)) - 0.5) / 16
    w_out = jnp.zeros((V, 16))
    losses = []
    t = 0
    for c in range(6):
        w_in, w_out, l, pairs = sgns_block_chunk(
            w_in, w_out, jnp.asarray(walks), table,
            jax.random.PRNGKey(1), jnp.float32(0.05), jnp.float32(1e-4),
            jnp.int32(t), jnp.float32(6 * 16),
            chunk_steps=16, block_walks=32, window=3, negative=5,
            k_shared=16, neg_share_walks=8,
        )
        losses.append(float(l.mean()))
        t += 16
        assert float(pairs.min()) > 0
    # stability: no divergence (batched SGD overshoot would blow past 1e3)
    assert np.isfinite(losses).all() and max(losses) < 50
    assert np.isfinite(np.asarray(w_in)).all()
    assert float(jnp.abs(w_in).max()) < 10.0


def test_sgns_gradient_matches_autodiff():
    """One block step's table delta == autodiff gradient of the
    (masked positive + weighted shared negative) objective."""
    V, D, Bw, L, W, K = 12, 8, 4, 5, 2, 6
    key = jax.random.PRNGKey(3)
    walks = jax.random.randint(key, (Bw, L), 0, V, dtype=jnp.int32)
    w_in = jax.random.normal(key, (V, D)) * 0.1
    w_out = jax.random.normal(jax.random.fold_in(key, 1), (V, D)) * 0.1
    negs = jax.random.randint(jax.random.fold_in(key, 2), (K,), 0, V,
                              dtype=jnp.int32)
    eff = jnp.full((Bw, L), W, jnp.int32)
    lr = 0.1

    def objective(params):
        w_in, w_out = params
        tok = walks
        yin = w_in[tok]
        yout = w_out[tok]
        vn = w_out[negs]
        logits = jnp.einsum("bld,bmd->blm", yin, yout)
        lg = jax.lax.broadcasted_iota(jnp.int32, (L, L), 0)
        mg = jax.lax.broadcasted_iota(jnp.int32, (L, L), 1)
        dm = jnp.abs(mg - lg)
        mask = ((dm >= 1) & (dm <= W))[None].astype(jnp.float32)
        mask = mask * (dm[None] <= eff[:, :, None])
        nlog = jnp.einsum("bld,kd->blk", yin, vn)
        n_pairs = mask.sum(2)
        neg_ok = (negs[None, None, :] != tok[:, :, None]).astype(
            jnp.float32
        )
        neg_w = 5.0 / K
        return -(
            jnp.sum(jax.nn.log_sigmoid(logits) * mask)
            + jnp.sum(jax.nn.log_sigmoid(-nlog)
                      * (n_pairs * neg_w)[:, :, None] * neg_ok)
        )

    grads = jax.grad(objective)((w_in, w_out))
    expected_in = w_in - lr * grads[0]
    expected_out = w_out - lr * grads[1]

    # drive the production chunk with fixed eff/negs via monkeyed RNG:
    # easiest faithful check — recompute its update manually mirroring
    # sgns_block_chunk's step body on the same inputs.
    tok_ok = walks >= 0
    yin = w_in[walks]
    yout = w_out[walks]
    vn = w_out[negs]
    logits = jnp.einsum("bld,bmd->blm", yin, yout)
    lg = jax.lax.broadcasted_iota(jnp.int32, (L, L), 0)
    mg = jax.lax.broadcasted_iota(jnp.int32, (L, L), 1)
    dm = jnp.abs(mg - lg)
    mask = (((dm >= 1) & (dm <= W))[None]
            & (dm[None] <= eff[:, :, None])
            & tok_ok[:, :, None] & tok_ok[:, None, :]).astype(jnp.float32)
    g_pos = (jax.nn.sigmoid(logits) - 1.0) * mask
    nlog = jnp.einsum("bld,kd->blk", yin, vn)
    n_pairs = mask.sum(2)
    neg_ok = (negs[None, None, :] != walks[:, :, None]).astype(jnp.float32)
    g_neg = jax.nn.sigmoid(nlog) * (n_pairs * (5.0 / K))[:, :, None] * neg_ok
    d_yin = (jnp.einsum("blm,bmd->bld", g_pos, yout)
             + jnp.einsum("blk,kd->bld", g_neg, vn))
    d_yout = jnp.einsum("blm,bld->bmd", g_pos, yin)
    d_vn = jnp.einsum("blk,bld->kd", g_neg, yin)
    got_in = w_in.at[walks.reshape(-1)].add(-lr * d_yin.reshape(-1, D))
    got_out = w_out.at[walks.reshape(-1)].add(-lr * d_yout.reshape(-1, D))
    got_out = got_out.at[negs].add(-lr * d_vn)

    np.testing.assert_allclose(np.asarray(got_in),
                               np.asarray(expected_in), atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_out),
                               np.asarray(expected_out), atol=1e-5)


def test_trainer_end_to_end_two_cliques():
    """Embeddings separate two cliques after a few epochs."""
    rng = np.random.default_rng(1)
    V = 20
    walks = []
    for _ in range(400):
        side = rng.integers(0, 2)
        walks.append(rng.integers(side * 10, side * 10 + 10, size=8))
    walks = np.asarray(walks, dtype=np.int32)
    cfg = SkipGramConfig(embed_size=16, window=3, epochs=4,
                         block_walks=64, k_shared=16, alpha=0.05,
                         chunk_steps=8)
    trainer = SkipGramTrainer(cfg)
    w_in, w_out, losses = trainer.fit(walks, V)
    assert trainer.trained_pairs_ > 0  # observability for benchmarks
    emb = np.asarray(w_in)
    emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sims = emb @ emb.T
    within = (sims[:10, :10].sum() - 10) / 90 + (sims[10:, 10:].sum() - 10) / 90
    across = sims[:10, 10:].mean()
    assert within / 2 > across + 0.2


def test_sgns_chunk_rounds_nondivisible_block():
    """block_walks not a multiple of the packing factor P=128//L must
    work when calling the chunk directly (bench.py regression)."""
    rng = np.random.default_rng(2)
    V, NW, L = 40, 300, 10  # P = 12; Bw=256 is not a multiple of 12
    walks = rng.integers(0, V, (NW, L)).astype(np.int32)
    table = jnp.asarray(negative_table(corpus_counts(walks, V), size=2048))
    w_in = (jax.random.uniform(jax.random.PRNGKey(0), (V, 8)) - 0.5) / 8
    w_out = jnp.zeros((V, 8))
    w_in, w_out, l, pairs = sgns_block_chunk(
        w_in, w_out, jnp.asarray(walks), table,
        jax.random.PRNGKey(1), jnp.float32(0.05), jnp.float32(1e-4),
        jnp.int32(0), jnp.float32(64),
        chunk_steps=4, block_walks=256, window=3, negative=5,
        k_shared=16, neg_share_walks=8,
    )
    assert np.isfinite(np.asarray(l)).all()
    assert float(pairs.min()) > 0


def test_sgns_chunk_block_larger_than_corpus():
    """Direct call with block_walks > NW (e.g. the 2016 default on a
    small corpus) must clamp, not crash (code-review regression)."""
    rng = np.random.default_rng(3)
    V, NW, L = 30, 100, 10
    walks = rng.integers(0, V, (NW, L)).astype(np.int32)
    table = jnp.asarray(negative_table(corpus_counts(walks, V), size=1024))
    w_in = (jax.random.uniform(jax.random.PRNGKey(0), (V, 8)) - 0.5) / 8
    w_out = jnp.zeros((V, 8))
    w_in, w_out, l, pairs = sgns_block_chunk(
        w_in, w_out, jnp.asarray(walks), table,
        jax.random.PRNGKey(1), jnp.float32(0.05), jnp.float32(1e-4),
        jnp.int32(0), jnp.float32(8),
        chunk_steps=2, block_walks=2016, window=3, negative=5,
        k_shared=8, neg_share_walks=8,
    )
    assert np.isfinite(np.asarray(l)).all()
    assert float(pairs.min()) > 0


def test_subsample_keep_probs_word2vec_rule():
    from graphembedding.train.skipgram import subsample_keep_probs

    counts = np.array([500.0, 5.0, 0.0, 495.0])  # total 1000
    s = 1e-2
    p = subsample_keep_probs(counts, s)
    # rare node (f=0.005 < sample): always kept
    assert p[1] == 1.0
    # zero-count node: probability 0 (never appears anyway)
    assert p[2] == 0.0
    # frequent node: (sqrt(f/s)+1)*s/f, clipped to 1
    f = 0.5
    np.testing.assert_allclose(p[0], (np.sqrt(f / s) + 1) * s / f,
                               rtol=1e-6)
    assert subsample_keep_probs(counts, 0.0) is None


def test_neg_share_packs_trains():
    """nsp>1 shares one negative set across packing groups; training
    still runs and reduces loss, and a non-divisible nsp falls back."""
    rng = np.random.default_rng(1)
    V, NW, L = 60, 512, 8
    # structured corpus (two communities) so the loss can move
    comm = rng.integers(0, 2, V)
    walks = np.stack([
        rng.choice(np.where(comm == rng.integers(0, 2))[0], size=L)
        for _ in range(NW)
    ]).astype(np.int32)
    table = jnp.asarray(negative_table(corpus_counts(walks, V), size=2048))
    w_in = (jax.random.uniform(jax.random.PRNGKey(0), (V, 16)) - 0.5) / 16
    w_out = jnp.zeros((V, 16))
    losses = []
    for nsp in (2, 3):  # block 64 walks -> G=4 packs; nsp=3 falls to 2
        wi, wo = jnp.array(w_in), jnp.array(w_out)
        t = 0
        ls = []
        for c in range(4):
            wi, wo, l, pairs = sgns_block_chunk(
                wi, wo, jnp.asarray(walks), table,
                jax.random.PRNGKey(1), jnp.float32(0.05),
                jnp.float32(1e-4), jnp.int32(t), jnp.float32(4 * 16),
                chunk_steps=16, block_walks=64, window=3, negative=5,
                k_shared=16, neg_share_walks=8, neg_share_packs=nsp,
            )
            ls.append(np.asarray(l))
            t += 16
        ls = np.concatenate(ls)
        assert np.isfinite(ls).all()
        assert ls[-8:].mean() < ls[:8].mean()
        losses.append(ls)


def test_device_prep_matches_host_builders():
    """_device_prep reproduces the numpy negative table + keep probs."""
    from graphembedding.train.skipgram import (
        _device_prep,
        subsample_keep_probs,
    )

    rng = np.random.default_rng(3)
    V, NW, L = 300, 500, 10
    walks = rng.integers(0, V, (NW, L)).astype(np.int32)
    walks[rng.random((NW, L)) < 0.1] = -1  # pads must be ignored
    size = 1 << 14
    counts_d, table_d, keep_d = _device_prep(
        jnp.asarray(walks), num_nodes=V, size=size, exponent=0.75,
        sample=1e-3,
    )
    counts = corpus_counts(walks, V)
    np.testing.assert_array_equal(np.asarray(counts_d), counts)
    table = negative_table(counts, exponent=0.75, size=size)
    # slot-for-slot agreement modulo f32 cumsum rounding at boundaries
    agree = float(np.mean(np.asarray(table_d) == table))
    assert agree > 0.999, agree
    keep = subsample_keep_probs(counts, 1e-3)
    np.testing.assert_allclose(np.asarray(keep_d), keep, atol=1e-5)
    # sample=0 disables subsampling in both paths
    _, _, keep_none = _device_prep(
        jnp.asarray(walks), num_nodes=V, size=size, exponent=0.75,
        sample=0.0,
    )
    assert keep_none is None


def test_inverse_cdf_table_edge_cases():
    from graphembedding.train.skipgram import inverse_cdf_table

    # all-zero weights: uniform fallback
    t = np.asarray(inverse_cdf_table(jnp.zeros(4), 1 << 10))
    freq = np.bincount(t, minlength=4) / t.shape[0]
    np.testing.assert_allclose(freq, 0.25, atol=0.01)
    # single node: every slot points at it
    t1 = np.asarray(inverse_cdf_table(jnp.ones(1), 64))
    assert (t1 == 0).all()
    # one dominant weight owns almost all slots
    t2 = np.asarray(inverse_cdf_table(jnp.asarray([1e-6, 1.0]), 1 << 12))
    assert (t2 == 1).mean() > 0.99


def test_subsample_walks_compacts_left():
    from graphembedding.train.skipgram import subsample_walks

    walks = jnp.array([[3, 7, 3, 5, -1], [7, 7, 7, 7, 7]], jnp.int32)
    # drop node 7 always, keep everything else always
    keep = jnp.array([1.0] * 7 + [0.0], jnp.float32)
    out = np.asarray(
        subsample_walks(walks, keep, jax.random.PRNGKey(0))
    )
    # survivors adjacent (windows span dropped tokens), -1 padded tail
    np.testing.assert_array_equal(out[0], [3, 3, 5, -1, -1])
    np.testing.assert_array_equal(out[1], [-1] * 5)


def test_subsample_walks_statistics():
    from graphembedding.train.skipgram import subsample_walks

    rng = np.random.default_rng(0)
    walks = jnp.asarray(rng.integers(0, 2, (2000, 10)).astype(np.int32))
    keep = jnp.array([1.0, 0.25], jnp.float32)
    out = np.asarray(
        subsample_walks(walks, keep, jax.random.PRNGKey(1))
    )
    n0 = int((out == 0).sum())
    n1 = int((out == 1).sum())
    assert n0 == int((np.asarray(walks) == 0).sum())  # kept fully
    expected = 0.25 * float((np.asarray(walks) == 1).sum())
    assert abs(n1 - expected) / expected < 0.05


def test_sparse_cap_matches_dense():
    # the sparse-cap path must compute the same update as the dense
    # path (per-row cap scale is constant per row, so pre-scaling each
    # contribution is the same sum, up to float association)
    rng = np.random.default_rng(3)
    V, NW, L, D = 60, 128, 8, 16
    walks = rng.integers(0, V, (NW, L)).astype(np.int32)
    table = jnp.asarray(
        negative_table(corpus_counts(walks, V), size=4096)
    )
    key = jax.random.PRNGKey(7)
    w_in0 = (jax.random.uniform(key, (V, D)) - 0.5) / D
    w_out0 = jax.random.normal(jax.random.PRNGKey(8), (V, D)) * 0.01
    outs = []
    for sparse in (False, True):
        w_in, w_out, losses, _ = sgns_block_chunk(
            jnp.array(w_in0), jnp.array(w_out0), jnp.asarray(walks),
            table, jax.random.PRNGKey(5), jnp.float32(0.025),
            jnp.float32(1e-4), jnp.int32(0), jnp.float32(64),
            chunk_steps=8, block_walks=32, window=3, negative=4,
            k_shared=16, neg_share_walks=4, update_cap=2.0,
            sparse_cap=sparse,
        )
        outs.append((np.asarray(w_in), np.asarray(w_out),
                     np.asarray(losses)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], atol=1e-5)
    np.testing.assert_allclose(outs[0][1], outs[1][1], atol=1e-5)
    np.testing.assert_allclose(outs[0][2], outs[1][2], atol=1e-5)


def test_trainer_blocked_shuffle_quality():
    """shuffle_mode='block' (corpus-order row clustering for large-V
    locality) must hold the same two-clique separation as the full
    shuffle — block-preserving permutation is a quality-neutral
    option (RESULTS.md round 3)."""
    rng = np.random.default_rng(1)
    V = 20
    walks = []
    for _ in range(400):
        side = rng.integers(0, 2)
        walks.append(rng.integers(side * 10, side * 10 + 10, size=8))
    walks = np.asarray(walks, dtype=np.int32)
    cfg = SkipGramConfig(embed_size=16, window=3, epochs=4,
                         block_walks=64, k_shared=16, alpha=0.05,
                         chunk_steps=8, shuffle_mode="block")
    trainer = SkipGramTrainer(cfg)
    w_in, _, _ = trainer.fit(walks, V)
    emb = np.asarray(w_in)
    emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sims = emb @ emb.T
    within = (sims[:10, :10].sum() - 10) / 90 \
        + (sims[10:, 10:].sum() - 10) / 90
    across = sims[:10, 10:].mean()
    assert within / 2 > across + 0.2


def test_plan_block_walks_policy():
    """Block policy: packing-rounded, tiny-corpus clamped, large-corpus
    upscaled (4x at >=128 blocks, 8x at >=256), never upscaled when
    the table dominates HBM (RESULTS.md round 4)."""
    from graphembedding.train.skipgram import (
        SkipGramConfig,
        plan_block_walks,
    )

    cfg = SkipGramConfig()
    L = 10
    # wiki scale: 192k walks = 48 blocks -> default, rounded to P=12
    assert plan_block_walks(192_400, L, 2405, cfg) == 4032
    # tiny corpus: >= 4 sequential blocks per epoch
    assert plan_block_walks(100, L, 120, cfg) == 24  # 100//4 -> P-mult
    # >=128 blocks -> 4x
    assert plan_block_walks(128 * 4032, L, 100_000, cfg) == 4 * 4032
    # >=256 blocks -> 8x
    assert plan_block_walks(2_000_000, L, 1_000_000, cfg) == 8 * 4032
    # 10M-node table (10 GB > 6 GB budget): no upscale
    assert plan_block_walks(20_000_000, L, 10_000_000, cfg) == 4032


def test_sgns_trace_classifies_block_grad_ops():
    """The trace reduction attributes to the block gradients the HLO
    ops of the `sgns_block_grads` scope and the fusions whose bodies
    are mostly in it; fusions holding any such op bound it above."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmarks.sgns_trace import classify_hlo_ops

    scoped = 'metadata={op_name="jit(f)/sgns_block_grads/mul"}'
    other = 'metadata={op_name="jit(f)/scatter-add"}'
    hlo = (
        "%fused_a (p: f32[4]) -> f32[4] {\n"
        f"  ROOT %m = f32[4] multiply(%p, %p), {scoped}\n"
        "}\n"
        "%fused_b (p: f32[4]) -> f32[4] {\n"
        f"  %n = f32[4] negate(%p), {scoped}\n"
        f"  %s1 = f32[4] sine(%n), {other}\n"
        f"  ROOT %s2 = f32[4] sine(%s1), {other}\n"
        "}\n"
        "ENTRY %main (x: f32[4]) -> f32[4] {\n"
        "  %fusion.1 = f32[4] fusion(%x), kind=kLoop, calls=%fused_a\n"
        "  %fusion.2 = f32[4] fusion(%fusion.1), kind=kLoop, "
        "calls=%fused_b\n"
        f"  ROOT %d = f32[4] add(%fusion.2, %x), {scoped}\n"
        "}\n"
    )
    majority, anyone = classify_hlo_ops(hlo)
    assert majority == {"m", "n", "fusion.1", "d"}
    assert anyone == majority | {"fusion.2"}


def test_sgns_trace_busy_time_is_interval_union():
    """Busy time counts overlapping kernel intervals once."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmarks.sgns_trace import _union_ns

    assert _union_ns([]) == 0
    assert _union_ns([(10, 20), (0, 5), (15, 30), (18, 25)]) == 25
    assert _union_ns([(0, 10), (10, 12)]) == 12
