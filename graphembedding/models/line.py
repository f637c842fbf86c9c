"""LINE (Tang et al., WWW'15) — first/second-order proximity embeddings.

Reference counterpart: `ge/models/line.py [U]`: a Keras model fed by a
Python generator that alias-samples edges (by weight) and negatives (by
degree^0.75), alternating a positive batch (sign +1) with `negative_ratio`
negative batches (sign -1), loss `-mean(log sigma(sign * <e_i, e_j>))`.

Device redesign: sampling moves on device (edge alias table over E + a
pre-sampled degree^0.75 lookup table), and each compiled step fuses one positive
pair AND its K negatives per sampled edge — mathematically the same
objective as the reference's sign-alternated batches, without the
per-batch Python/TF boundary (the reference's actual bottleneck,
SURVEY.md §4.3). The whole epoch loop is one `lax.scan` jit.

Orders: 'first' trains first_emb with symmetric dots; 'second' trains
second_emb against context_emb; 'all' trains both and concatenates.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from graphembedding.models.base import as_graph
from graphembedding.ops.alias import build_alias_table


@partial(
    jax.jit,
    static_argnames=("chunk_steps", "batch_size", "negative",
                     "order_first", "k_shared", "update_cap"),
    donate_argnums=(0, 1),
)
def line_train_chunk(
    emb,
    ctx,
    edge_src,
    edge_dst,
    edge_accept,
    edge_alias,
    neg_table,
    key,
    lr0,
    t0,
    total_steps,
    *,
    chunk_steps,
    batch_size,
    negative,
    order_first,
    k_shared=0,
    update_cap=8.0,
):
    """One fixed-size compiled chunk of LINE SGD over sampled edges.

    For order='first' the ctx table is unused (symmetric dot on emb).
    All sampling is hoisted out of the scan in bulk, as in
    `train.skipgram.sgns_block_chunk_cat`. Negatives
    come from a pre-sampled degree^0.75 inverse-CDF table (one int
    gather per draw), replacing a per-draw `searchsorted` over the
    cumulative weights — the word2vec table trick, as in
    `train.skipgram`.

    k_shared > 0: one K-row negative set per GROUP of
    `neg_group` consecutive pairs, scored against the group by a dense
    matmul, each event weighted `negative/K` — same expected gradient
    as the per-pair draws at (B/neg_group)*K negative rows per step
    instead of B*negative (the dominant row-issue cost; see
    train.skipgram's negative sharing). Group size is chosen so the
    per-row accumulated event weight (neg_group*negative/K ~= 1 at
    the default shapes) stays at about one sequential-update
    magnitude — step-wide sharing
    (weight ~80 with the cap compressing negatives 10x while
    positives run uncapped) measured a micro-F1 collapse 0.76 -> 0.57
    on wiki. `update_cap` still guards the tail. k_shared=0 (default)
    keeps the per-pair reference formulation — measured FASTER than
    grouped sharing at LINE's shapes (BlogCatalog-scale warm epoch
    0.64 vs 0.83 s; the grouped path's extra small einsums cost more
    than the saved row issues, unlike the walk-block trainer where
    negatives dominate row traffic), and slightly better micro-F1
    (0.7609 vs 0.7568 seed 0)."""
    hs, tposs, tnegs, lrs = _line_bulk_samples(
        edge_src, edge_dst, edge_accept, edge_alias, neg_table, key,
        lr0, t0, total_steps, chunk_steps=chunk_steps,
        batch_size=batch_size, negative=negative, k_shared=k_shared,
    )
    step = _make_line_step(
        batch_size=batch_size, negative=negative,
        order_first=order_first, k_shared=k_shared,
        update_cap=update_cap,
    )
    (emb, ctx), losses = jax.lax.scan(
        step, (emb, ctx), (hs, tposs, tnegs, lrs)
    )
    return emb, ctx, losses


def _neg_grouping(batch_size, negative, k_shared):
    """Pairs-per-shared-set (NG) and groups-per-step (Bg); see
    `line_train_chunk`'s negative-sharing docstring."""
    B, K, K2 = batch_size, negative, k_shared
    NG = max(min(K2 // max(K, 1), B), 1)
    while B % NG:
        NG -= 1
    return NG, B // NG


def _line_bulk_samples(
    edge_src, edge_dst, edge_accept, edge_alias, neg_table, key, lr0,
    t0, total_steps, *, chunk_steps, batch_size, negative, k_shared,
):
    """Hoisted bulk sampling for one chunk: edges via the weight alias
    table, negatives via the pre-sampled degree^0.75 table, linear-decay
    LRs. Returns per-step scan inputs (hs, tposs, tnegs, lrs)."""
    n_edges = edge_src.shape[0]
    S, B, K = chunk_steps, batch_size, negative
    K2 = k_shared
    if K2:
        _, Bg = _neg_grouping(B, K, K2)

    k1, k2, k3 = jax.random.split(jax.random.fold_in(key, t0), 3)
    u1 = jax.random.uniform(k1, (S, B))
    u2 = jax.random.uniform(k2, (S, B))
    pick = jnp.minimum((u1 * n_edges).astype(jnp.int32), n_edges - 1)
    take = u2 < edge_accept[pick]
    eidx = jnp.where(take, pick, edge_alias[pick])
    hs = edge_src[eidx]
    tposs = edge_dst[eidx]
    neg_shape = (S, Bg, K2) if K2 else (S, B, K)
    tnegs = neg_table[
        jax.random.randint(
            k3, neg_shape, 0, neg_table.shape[0], dtype=jnp.int32
        )
    ]
    lrs = lr0 * jnp.maximum(
        1.0
        - (t0 + jnp.arange(S, dtype=jnp.int32)).astype(jnp.float32)
        / total_steps,
        1e-4,
    )
    return hs, tposs, tnegs, lrs


def _make_line_step(*, batch_size, negative, order_first, k_shared,
                    update_cap):
    """Build the per-step scan body shared by the single-device chunk
    and the sharded chunk (parallel/line.py)."""
    B, K, K2 = batch_size, negative, k_shared
    if K2:
        # pairs per shared-negative set: per-row accumulated event
        # weight = NG*(K/K2) ~= 1 with NG = K2//K — each shared row
        # moves about one sequential-update magnitude per step, so
        # the cap below is pure tail insurance
        NG, Bg = _neg_grouping(B, K, K2)

    def step(carry, xs):
        emb, ctx = carry
        h, tpos, tneg, lr = xs

        u = emb[h]  # [B, D]
        if order_first:
            v = emb[tpos]
            vn = emb[tneg]
        else:
            v = ctx[tpos]
            vn = ctx[tneg]

        pos_logit = jnp.sum(u * v, axis=-1)
        g_pos = jax.nn.sigmoid(pos_logit) - 1.0
        d_v = g_pos[:, None] * u

        if K2:
            # grouped shared negatives: vn [Bg, K2, D]
            ug = u.reshape(Bg, NG, -1)
            neg_logit = jnp.einsum("gbd,gkd->gbk", ug, vn)
            w = jnp.float32(negative) / K2
            g_neg = jax.nn.sigmoid(neg_logit) * w
            d_u = g_pos[:, None] * v + jnp.einsum(
                "gbk,gkd->gbd", g_neg, vn
            ).reshape(B, -1)
            # per-row accumulated event weight is NG*w (~1 by
            # construction); the cap only guards the tail
            scale = jnp.minimum(
                1.0, update_cap / jnp.maximum(NG * w, 1.0)
            )
            d_vn = jnp.einsum("gbk,gbd->gkd", g_neg, ug) * scale
            # per-pair expected negative loss: w * sum over its set
            neg_loss = (
                w * jnp.sum(jax.nn.log_sigmoid(-neg_logit), axis=2)
            ).reshape(B)
        else:
            neg_logit = jnp.einsum("bd,bkd->bk", u, vn)
            g_neg = jax.nn.sigmoid(neg_logit)
            d_u = g_pos[:, None] * v + jnp.einsum(
                "bk,bkd->bd", g_neg, vn
            )
            d_vn = g_neg[:, :, None] * u[:, None, :]
            neg_loss = jnp.sum(jax.nn.log_sigmoid(-neg_logit), axis=-1)

        emb = emb.at[h].add(-lr * d_u)
        tgt_neg = tneg.reshape(-1)
        d_vn_flat = d_vn.reshape(-1, u.shape[1])
        if order_first:
            emb = emb.at[tpos].add(-lr * d_v)
            emb = emb.at[tgt_neg].add(-lr * d_vn_flat)
        else:
            ctx = ctx.at[tpos].add(-lr * d_v)
            ctx = ctx.at[tgt_neg].add(-lr * d_vn_flat)

        loss = -(
            jnp.mean(jax.nn.log_sigmoid(pos_logit))
            + jnp.mean(neg_loss)
        )
        return (emb, ctx), loss

    return step


def line_train(
    emb,
    ctx,
    edge_src,
    edge_dst,
    edge_accept,
    edge_alias,
    neg_table,
    key,
    lr0,
    *,
    n_steps,
    batch_size,
    negative,
    order_first,
    chunk_steps=512,
    k_shared=0,
    update_cap=8.0,
    checkpoint_dir=None,
    checkpoint_every=0,
    mesh=None,
    sync_every=None,
):
    """Full LINE run as a Python loop of fixed-size compiled chunks.

    checkpoint_dir/-every: Orbax-checkpoint (emb, ctx, chunk) every N
    chunks and resume from the latest checkpoint if present — the same
    restartable loop as the skip-gram trainers (SURVEY.md §6). Chunk
    RNG is keyed by the step counter, so a resumed run replays the
    exact remaining schedule.

    mesh: train data-parallel over the mesh's data axis (batch_size is
    global; see parallel/line.py).
    """
    if mesh is not None:
        from graphembedding.parallel.line import sharded_line_chunk

        sharded_fn = sharded_line_chunk(
            mesh, chunk_steps=chunk_steps, batch_size=batch_size,
            negative=negative, order_first=order_first,
            k_shared=k_shared, update_cap=update_cap,
            sync_every=sync_every,
        )
    n_chunks = max((n_steps + chunk_steps - 1) // chunk_steps, 1)
    resume_chunk = 0
    if checkpoint_dir:
        from graphembedding.utils.checkpoint import try_restore

        state = try_restore(checkpoint_dir, ("emb", "ctx", "chunk"))
        if state is not None:
            emb = jnp.asarray(state["emb"])
            ctx = jnp.asarray(state["ctx"])
            resume_chunk = int(state["chunk"])
    losses = []
    total_steps = jnp.float32(n_steps)
    for c in range(n_chunks):
        if c < resume_chunk:
            continue
        if mesh is not None:
            with mesh:
                emb, ctx, l = sharded_fn(
                    emb, ctx, edge_src, edge_dst, edge_accept,
                    edge_alias, neg_table, key, lr0,
                    jnp.int32(c * chunk_steps), total_steps,
                )
        else:
            emb, ctx, l = line_train_chunk(
                emb,
                ctx,
                edge_src,
                edge_dst,
                edge_accept,
                edge_alias,
                neg_table,
                key,
                lr0,
                jnp.int32(c * chunk_steps),
                total_steps,
                chunk_steps=chunk_steps,
                batch_size=batch_size,
                negative=negative,
                order_first=order_first,
                k_shared=k_shared,
                update_cap=update_cap,
            )
        losses.append(l)
        if checkpoint_dir and checkpoint_every:
            from graphembedding.utils.checkpoint import maybe_save

            maybe_save(
                checkpoint_dir, checkpoint_every, c + 1,
                lambda: {
                    "emb": np.asarray(emb),
                    "ctx": np.asarray(ctx),
                    "chunk": np.asarray(c + 1),
                },
            )
    if not losses:  # fully resumed past the end
        losses = [jnp.zeros((0,), jnp.float32)]
    return emb, ctx, jnp.concatenate(losses)


class LINE:
    def __init__(
        self,
        graph,
        embedding_size=8,
        negative_ratio=5,
        order="second",
        seed=0,
        k_shared=0,
        update_cap=8.0,
    ):
        # k_shared/update_cap: negative-sharing knobs beyond the
        # reference signature (see line_train_chunk); the default 0 is
        # the per-pair reference formulation — measured fastest AND
        # best-F1 for LINE (see line_train_chunk docstring)
        if order not in ("first", "second", "all"):
            raise ValueError("order must be first / second / all")
        self.graph = as_graph(graph)
        self.embedding_size = embedding_size
        self.negative_ratio = negative_ratio
        self.order = order
        self.seed = seed
        self.k_shared = k_shared
        self.update_cap = update_cap
        self._embeddings: Dict | None = None

        g = self.graph
        src, dst, w = g.edges()
        self._edge_src = jnp.asarray(src.astype(np.int32))
        self._edge_dst = jnp.asarray(dst.astype(np.int32))
        # edge alias table by weight (reference `_gen_sampling_table [U]`)
        acc, alias = build_alias_table(w.astype(np.float64))
        self._edge_accept = jnp.asarray(acc)
        self._edge_alias = jnp.asarray(alias)
        # negative table: degree^0.75 over *weighted out-degree* (the
        # reference uses sum of outgoing weights per node), pre-sampled
        # into an inverse-CDF lookup table on device
        from graphembedding.train.skipgram import inverse_cdf_table

        wdeg = np.zeros(g.num_nodes, dtype=np.float64)
        np.add.at(wdeg, src, w.astype(np.float64))
        self._neg_table = jax.jit(
            inverse_cdf_table, static_argnums=1
        )(jnp.asarray(np.power(wdeg, 0.75), jnp.float32), 1 << 20)

        key = jax.random.PRNGKey(seed)
        k1, k2, k3 = jax.random.split(key, 3)
        V, D = g.num_nodes, embedding_size
        scale = 1.0 / D
        self.first_emb = jax.random.uniform(k1, (V, D), minval=-scale,
                                            maxval=scale)
        self.second_emb = jax.random.uniform(k2, (V, D), minval=-scale,
                                             maxval=scale)
        self.context_emb = jax.random.uniform(k3, (V, D), minval=-scale,
                                              maxval=scale)
        self.losses = None

    def train(self, batch_size=1024, epochs=1, initial_lr=0.025,
              verbose=0, times=1, checkpoint_dir=None,
              checkpoint_every=0, mesh=None, sync_every=None,
              trainer="sampled", steps=300, lr=0.1):
        """Reference signature plus checkpoint_dir/-every (Orbax
        checkpoint + resume per trained order, subdirectories
        'first' / 'second' under checkpoint_dir) and mesh= (data-
        parallel edge batches over the mesh — parallel/line.py;
        batch_size is global).

        `trainer='dense'` optimizes LINE's EXPECTED objective in
        closed form (train/dense.py): the positive-pair expectation of
        edge sampling is just the weighted adjacency, negatives are
        the rank-1 wdeg^0.75 expectation, so each Adam step is a
        couple of [V,V]x[V,D] matmuls — no sampling noise, small
        graphs only (V <= ~32k)."""
        del verbose
        import os
        g = self.graph
        if trainer == "dense":
            return self._train_dense(steps=steps, lr=lr)
        if trainer != "sampled":
            raise ValueError(f"unknown trainer {trainer!r}")
        # reference steps/epoch: ceil(E*times*(1+neg_ratio)/batch) —
        # `times` multiplies per-epoch samples (`reset_training_config
        # [U]`); our fused step covers 1 positive + K negatives at
        # once, so E*times/batch steps per epoch visits the same
        # number of samples.
        n_steps = max(
            int(round(epochs * times * g.num_edges / batch_size)), 1
        )
        key = jax.random.PRNGKey(self.seed + 1)
        if self.order in ("first", "all"):
            # ctx table is unused for first-order (symmetric dot); pass a
            # dummy so the donated buffers stay distinct
            self.first_emb, _, l1 = line_train(
                self.first_emb,
                jnp.zeros((1, self.embedding_size), jnp.float32),
                self._edge_src,
                self._edge_dst,
                self._edge_accept,
                self._edge_alias,
                self._neg_table,
                key,
                jnp.float32(initial_lr),
                n_steps=n_steps,
                batch_size=batch_size,
                negative=self.negative_ratio,
                order_first=True,
                k_shared=min(self.k_shared, self.graph.num_nodes),
                update_cap=self.update_cap,
                checkpoint_dir=(os.path.join(checkpoint_dir, "first")
                                if checkpoint_dir else None),
                checkpoint_every=checkpoint_every,
                mesh=mesh,
                sync_every=sync_every,
            )
            self.losses = l1
        if self.order in ("second", "all"):
            self.second_emb, self.context_emb, l2 = line_train(
                self.second_emb,
                self.context_emb,
                self._edge_src,
                self._edge_dst,
                self._edge_accept,
                self._edge_alias,
                self._neg_table,
                jax.random.fold_in(key, 1),
                jnp.float32(initial_lr),
                n_steps=n_steps,
                batch_size=batch_size,
                negative=self.negative_ratio,
                order_first=False,
                k_shared=min(self.k_shared, self.graph.num_nodes),
                update_cap=self.update_cap,
                checkpoint_dir=(os.path.join(checkpoint_dir, "second")
                                if checkpoint_dir else None),
                checkpoint_every=checkpoint_every,
                mesh=mesh,
                sync_every=sync_every,
            )
            self.losses = l2
        self._embeddings = None
        return self

    def _train_dense(self, *, steps, lr):
        """Closed-form expected-LINE (see train docstring)."""
        from graphembedding.train.dense import (
            DenseSGNSConfig,
            _dense_fit,
        )

        # one source of truth for the size cap and Adam constants
        dcfg = DenseSGNSConfig(steps=steps, lr=lr, seed=self.seed)
        g = self.graph
        V = g.num_nodes
        if V > dcfg.max_nodes:
            raise ValueError(
                f"trainer='dense' is for V <= {dcfg.max_nodes}; use "
                "the sampled trainer at scale"
            )
        src, dst, w = g.edges()

        @jax.jit
        def adjacency(src, dst, w):
            A = jnp.zeros((V * V,), jnp.float32)
            return A.at[src * V + dst].add(w).reshape(V, V)

        A = adjacency(jnp.asarray(src.astype(np.int64)),
                      jnp.asarray(dst.astype(np.int64)),
                      jnp.asarray(w, jnp.float32))
        wdeg = A.sum(axis=1)
        q = jnp.power(jnp.maximum(wdeg, 0.0), 0.75)
        key = jax.random.PRNGKey(self.seed + 1)
        losses = []
        def fit(k, tied):
            return _dense_fit(
                A, k, jnp.float32(self.negative_ratio),
                jnp.float32(dcfg.ns_exponent), jnp.float32(dcfg.lr),
                jnp.float32(dcfg.b1), jnp.float32(dcfg.b2),
                jnp.float32(dcfg.eps),
                num_nodes=V, embed_size=self.embedding_size,
                steps=dcfg.steps, q=q, tied=tied,
            )

        if self.order in ("first", "all"):
            self.first_emb, _, l1 = fit(key, True)
            losses.append(l1)
        if self.order in ("second", "all"):
            self.second_emb, self.context_emb, l2 = fit(
                jax.random.fold_in(key, 1), False
            )
            losses.append(l2)
        self.losses = jnp.concatenate(losses)
        self._embeddings = None
        return self

    def get_embeddings(self) -> Dict:
        if self._embeddings is None:
            if self.order == "first":
                table = np.asarray(self.first_emb)
            elif self.order == "second":
                table = np.asarray(self.second_emb)
            else:
                table = np.hstack(
                    [np.asarray(self.first_emb), np.asarray(self.second_emb)]
                )
            vocab = self.graph.vocab
            self._embeddings = {
                vocab.idx2node[i]: table[i]
                for i in range(self.graph.num_nodes)
            }
        return self._embeddings
