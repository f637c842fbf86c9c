"""Hierarchical-softmax skip-gram (the reference's hs=1 trainer).

Reference counterpart: gensim `Word2Vec(hs=1)` as used by the reference's
DeepWalk and Struc2Vec (`sg=1, hs=1`, SURVEY.md §9). SGNS remains the
throughput path (the BASELINE north-star kernel) and DeepWalk's default;
this trainer is **Struc2Vec's default** (structural-role embeddings
measure 0.96-1.00 micro-F1 under hs vs ~0.70 under SGNS on
flight-brazil) and the exact-objective option everywhere:

    loss(center c, context m) = Σ_{t in path(m)}
        -log σ( (1 - code_t) ? ⟨u_c, w_t⟩ : -⟨u_c, w_t⟩ )

with a Huffman tree built over corpus frequencies (word2vec semantics:
label = 1 - code, gradient g = (label - σ)·x on both the input row and
the traversed inner-node rows).

Device layout mirrors the SGNS walk-block design: packed walk groups,
all pair×path logits as batched matmuls, bulk RNG, per-row update caps.
Tree paths are static-depth padded arrays (`points` [V, depth] i32 with
-1 padding, `codes` [V, depth] f32).
"""

from __future__ import annotations

import heapq
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def build_huffman(counts: np.ndarray):
    """Huffman tree over node frequencies -> (points, codes, depth).

    points[v, t]: inner-node ids (0..V-2) on the path root->leaf v,
    -1 padded; codes[v, t]: 0/1 branch codes aligned with points.
    Matches word2vec's `create_binary_tree` semantics.
    """
    V = counts.shape[0]
    if V == 1:
        return (np.full((1, 1), -1, np.int32),
                np.zeros((1, 1), np.float32), 1)
    heap = [(float(max(c, 1e-9)), i, None, None) for i, c in
            enumerate(counts)]
    heapq.heapify(heap)
    next_inner = 0
    nodes = {}
    while len(heap) > 1:
        a = heapq.heappop(heap)
        b = heapq.heappop(heap)
        nid = V + next_inner
        next_inner += 1
        nodes[nid] = (a[1], b[1])
        heapq.heappush(heap, (a[0] + b[0], nid, a[1], b[1]))

    # walk the tree collecting paths
    points = [[] for _ in range(V)]
    codes = [[] for _ in range(V)]
    root = heap[0][1]

    stack = [(root, [], [])]
    while stack:
        nid, pth, cds = stack.pop()
        if nid < V:
            points[nid] = pth
            codes[nid] = cds
            continue
        inner_id = nid - V
        left, right = nodes[nid]
        stack.append((left, pth + [inner_id], cds + [0]))
        stack.append((right, pth + [inner_id], cds + [1]))

    depth = max(1, max(len(p) for p in points))
    P = np.full((V, depth), -1, np.int32)
    C = np.zeros((V, depth), np.float32)
    for v in range(V):
        P[v, : len(points[v])] = points[v]
        C[v, : len(codes[v])] = codes[v]
    return P, C, depth


@partial(
    jax.jit,
    static_argnames=("chunk_steps", "block_walks", "window",
                     "update_cap", "sparse_cap"),
    donate_argnums=(0, 1),
)
def hs_block_chunk(
    w_in,
    w_tree,
    walks,
    points,
    codes,
    key,
    alpha,
    min_alpha,
    t0,
    total_steps,
    *,
    chunk_steps,
    block_walks,
    window,
    update_cap=8.0,
    sparse_cap=False,
):
    """`chunk_steps` hierarchical-softmax steps over walk blocks."""
    S, Bw, W = chunk_steps, block_walks, window
    NW, L = walks.shape
    V, D = w_in.shape
    T = points.shape[1]  # tree depth
    Bw = min(Bw, NW)  # clamp + round for direct callers (see skipgram)

    P = max(min(max(128 // L, 1), Bw), 1)
    G = Bw // P
    PL = P * L
    Bw = G * P
    n_blocks = max(NW // Bw, 1)

    k1 = jax.random.fold_in(key, t0)
    eff = W - (
        jax.random.uniform(k1, (S, G, PL)) * W
    ).astype(jnp.int32).clip(0, W - 1)
    steps = t0 + jnp.arange(S, dtype=jnp.int32)
    lrs = jnp.maximum(
        min_alpha, alpha * (1.0 - steps.astype(jnp.float32) / total_steps)
    )
    offs = (steps % n_blocks) * Bw

    igrid = jax.lax.broadcasted_iota(jnp.int32, (PL, PL), 0)
    jgrid = jax.lax.broadcasted_iota(jnp.int32, (PL, PL), 1)
    same_walk = (igrid // L) == (jgrid // L)
    dm = jnp.abs(jgrid % L - igrid % L)
    window_ok = same_walk & (dm >= 1) & (dm <= W)

    n_inner = w_tree.shape[0]

    def step(carry, xs):
        w_in, w_tree = carry
        off, eff_b, lr = xs

        tok = jax.lax.dynamic_slice(walks, (off, 0), (Bw, L))
        tok = tok.reshape(G, PL)
        tok_ok = tok >= 0
        tok_safe = jnp.where(tok_ok, tok, 0)

        yin = w_in[tok_safe]  # [G, PL, D] centers
        pts = points[tok_safe]  # [G, PL, T] context paths
        cds = codes[tok_safe]  # [G, PL, T]
        pts_ok = (pts >= 0) & tok_ok[:, :, None]
        pts_safe = jnp.where(pts_ok, pts, 0)
        ptv = w_tree[pts_safe]  # [G, PL, T, D]

        mask = (
            window_ok[None]
            & (dm[None] <= eff_b[:, :, None])
            & tok_ok[:, :, None]
            & tok_ok[:, None, :]
        ).astype(jnp.float32)  # [G, PL(center l), PL(context m)]

        # logits for every (center l, context m, tree level t), with
        # (m, t) FLATTENED to one n = m*T + t axis: a T-minor tensor
        # (depth ~13-19) pads a 128-wide minor tile wherever XLA
        # materializes it; n ≈ PL·T pads to within ~1%
        N = PL * T
        ptv_n = ptv.reshape(G, N, D)
        logits = jnp.einsum(
            "gld,gnd->gln", yin, ptv_n,
            preferred_element_type=jnp.float32,
        )
        label = 1.0 - cds  # [G, PL, T]
        gate_n = (  # context-path validity, broadcast over centers
            mask[:, :, :, None] * pts_ok[:, None, :, :]
        ).reshape(G, PL, N)
        gmat = (
            label.reshape(G, 1, N) - jax.nn.sigmoid(logits)
        ) * gate_n  # [G, l, n]

        d_yin = jnp.einsum(
            "gln,gnd->gld", gmat, ptv_n,
            preferred_element_type=jnp.float32,
        )
        d_tree = jnp.einsum(
            "gln,gld->gnd", gmat, yin,
            preferred_element_type=jnp.float32,
        ).reshape(G, PL, T, D)  # per (context m, level t)

        # per-row accumulation cap. Occupancy goes through SEPARATE 1-D
        # [V]/[n_inner] scatters (the fast scatter pattern — see
        # skipgram's sparse_cap note) rather than riding the gradient
        # scatter as an extra column: the riding column forces a
        # concatenate COPY of the [G·PL·T, D] gradient tensor (~49 MB
        # at wiki shapes, twice per step); this form avoids the copy
        # (same math — the cap scale is constant per row either way)
        cap = jnp.float32(update_cap)
        flat = tok_safe.reshape(-1)
        n_pairs_ctx = jnp.sum(mask, axis=1)  # pairs per context
        tflat = pts_safe.reshape(-1)
        tweight = jnp.broadcast_to(
            n_pairs_ctx[:, :, None], pts_safe.shape
        ).reshape(-1) * pts_ok.reshape(-1)
        occ_t = jnp.zeros((V,), jnp.float32).at[flat].add(1.0)
        occ_r = jnp.zeros((n_inner,), jnp.float32).at[tflat].add(tweight)
        if sparse_cap:
            # large-V path (mirrors sgns_block_chunk's sparse_cap): no
            # O(V·D)/O(n_inner·D) gradient buffers — gather the per-row
            # scale back per contribution and scatter PRE-SCALED grads
            # straight into the donated tables. Same math: the cap
            # scale is constant per row, so scaling each contribution
            # equals scaling the row's sum.
            tok_scale = jnp.minimum(
                1.0, cap / jnp.maximum(occ_t[flat], 1.0)
            )
            tree_scale = jnp.minimum(
                1.0, cap / jnp.maximum(occ_r[tflat], 1.0)
            )
            w_in = w_in.at[flat].add(
                lr * d_yin.reshape(-1, D) * tok_scale[:, None]
            )
            w_tree = w_tree.at[tflat].add(
                lr * d_tree.reshape(-1, D) * tree_scale[:, None]
            )
        else:
            tbuf = jnp.zeros((V, D), jnp.float32).at[flat].add(
                d_yin.reshape(-1, D)
            )
            tok_scale = jnp.minimum(
                1.0, cap / jnp.maximum(occ_t, 1.0)
            )[:, None]
            rbuf = jnp.zeros((n_inner, D), jnp.float32).at[tflat].add(
                d_tree.reshape(-1, D)
            )
            tree_scale = jnp.minimum(
                1.0, cap / jnp.maximum(occ_r, 1.0)
            )[:, None]

            w_in = w_in + lr * tbuf * tok_scale
            w_tree = w_tree + lr * rbuf * tree_scale

        # loss: -log sigmoid((2·label - 1) · logit) summed over path
        sgn = 2.0 * label.reshape(G, 1, N) - 1.0
        ll = jax.nn.log_sigmoid(sgn * logits)
        loss = -jnp.sum(ll * gate_n) / jnp.maximum(jnp.sum(mask), 1.0)
        return (w_in, w_tree), loss

    (w_in, w_tree), losses = jax.lax.scan(
        step, (w_in, w_tree), (offs, eff, lrs)
    )
    return w_in, w_tree, losses


class HSTrainer:
    """Hierarchical-softmax skip-gram fit (reference hs=1 semantics)."""

    def __init__(self, embed_size=128, window=5, epochs=5,
                 block_walks=504, alpha=0.025, min_alpha=1e-4,
                 chunk_steps=64, update_cap=8.0, sample=1e-3, seed=0,
                 mesh=None, sync_every=None, cap_mode="auto"):
        self.embed_size = embed_size
        self.window = window
        self.epochs = epochs
        self.block_walks = block_walks
        self.alpha = alpha
        self.min_alpha = min_alpha
        self.chunk_steps = chunk_steps
        self.update_cap = update_cap
        self.sample = sample  # gensim-default frequent-node subsampling
        self.seed = seed
        self.mesh = mesh  # jax.sharding.Mesh -> DP×TP sharded chunks
        self.sync_every = sync_every  # DP replica-averaging period
        # 'dense' | 'sparse' | 'auto': cap bookkeeping, as in
        # SkipGramConfig.cap_mode — auto switches to the sparse
        # (no [V,D]/[n_inner,D] buffer) form at V >= 2^16, the same
        # crossover the SGNS trainer measured (benchmarks/table_scale)
        self.cap_mode = cap_mode

    def fit(self, walks, num_nodes, key=None, checkpoint_dir=None,
            checkpoint_every=0, metrics=None):
        """Train (w_in, w_tree) over the corpus.

        checkpoint_dir/-every and metrics mirror SkipGramTrainer.fit:
        Orbax-checkpoint (tables, step) every N chunks with resume,
        and per-chunk loss lines to a utils.metrics.MetricsLogger.
        """
        import numpy as np

        from graphembedding.train.skipgram import (
            _gather_keep,
            corpus_counts,
            subsample_keep_probs,
        )

        if key is None:
            key = jax.random.PRNGKey(self.seed)
        from graphembedding.utils.debug import validation_enabled

        if validation_enabled():
            from graphembedding.utils.debug import validate_walks

            validate_walks(np.asarray(walks), num_nodes)
        counts = corpus_counts(walks, num_nodes)
        # Huffman tree over RAW counts (gensim builds the vocab first)
        keep = subsample_keep_probs(counts, self.sample)
        points, codes, depth = build_huffman(counts)
        points = jnp.asarray(points)
        codes = jnp.asarray(codes)

        walks = jnp.asarray(walks)
        NW, L = walks.shape
        if self.mesh is not None:
            # per-device slices must be whole packs (mirrors
            # parallel.trainer.DistributedSkipGramTrainer's rounding),
            # and every device must own at least one REAL walk — a
            # bw > NW block would make dynamic_slice clamp trailing
            # devices onto duplicated rows silently
            n = self.mesh.shape["data"]
            if NW < n:
                raise ValueError(
                    f"corpus has {NW} walks but the mesh data axis has "
                    f"{n} devices — use a smaller mesh or more walks"
                )
            per = max(min(self.block_walks, max(NW // 4, n)) // n, 1)
            per = min(per, NW // n)
            pk = max(min(max(128 // L, 1), per), 1)
            bw = max((per // pk) * pk, pk) * n
        else:
            P = max(min(max(128 // L, 1), NW), 1)
            bw = max(
                (min(self.block_walks, max(NW // 4, P)) // P) * P, P
            )
        n_blocks = max(NW // bw, 1)
        chunks_per_epoch = max(
            (n_blocks + self.chunk_steps - 1) // self.chunk_steps, 1
        )
        # LR decays over steps actually executed (see train.skipgram)
        n_steps = self.epochs * chunks_per_epoch * self.chunk_steps

        k_init, k_shuf, k_train, k_sub = jax.random.split(key, 4)
        resume_step = 0
        w_in = w_tree = None
        if checkpoint_dir:
            from graphembedding.utils.checkpoint import try_restore

            state = try_restore(
                checkpoint_dir, ("w_in", "w_tree", "step")
            )
            if state is not None:
                w_in = jnp.asarray(state["w_in"])
                w_tree = jnp.asarray(state["w_tree"])
                resume_step = int(state["step"])
        if w_in is None:
            w_in = (
                jax.random.uniform(k_init, (num_nodes, self.embed_size))
                - 0.5
            ) / self.embed_size
            w_tree = jnp.zeros((max(num_nodes - 1, 1), self.embed_size),
                               jnp.float32)

        from graphembedding.train.skipgram import (
            _prepare_epoch,
            _shuffle_walks,
        )

        # hoisted per-token keep buffer below ~512 MB, else re-gather
        # per epoch (mirrors train.skipgram's big_corpus switch: the
        # hoisted [NW, L] buffer is faster at 1M nodes but OOMs first
        # at 10M-node corpora)
        big_corpus = walks.size * 4 > (512 << 20)
        keep_dev = None if keep is None else jnp.asarray(keep)
        keep_tok = (
            None if (keep_dev is None or big_corpus)
            else _gather_keep(walks, keep_dev)
        )
        sparse_cap = (
            num_nodes >= (1 << 16) if self.cap_mode == "auto"
            else self.cap_mode == "sparse"
        )
        if self.mesh is not None:
            from graphembedding.parallel.hsoftmax import (
                sharded_hs_chunk,
            )

            chunk_fn = sharded_hs_chunk(
                self.mesh, chunk_steps=self.chunk_steps, block_walks=bw,
                window=self.window, update_cap=self.update_cap,
                sync_every=self.sync_every,
            )

            def run_chunk(w_in, w_tree, shuffled, t):
                with self.mesh:
                    return chunk_fn(
                        w_in, w_tree, shuffled, points, codes, k_train,
                        jnp.float32(self.alpha),
                        jnp.float32(self.min_alpha),
                        jnp.int32(t), jnp.float32(n_steps),
                    )
        else:

            def run_chunk(w_in, w_tree, shuffled, t):
                return hs_block_chunk(
                    w_in, w_tree, shuffled, points, codes, k_train,
                    jnp.float32(self.alpha), jnp.float32(self.min_alpha),
                    jnp.int32(t), jnp.float32(n_steps),
                    chunk_steps=self.chunk_steps, block_walks=bw,
                    window=self.window, update_cap=self.update_cap,
                    sparse_cap=sparse_cap,
                )

        losses = []
        t = 0
        n_chunk_calls = 0
        epoch_steps = chunks_per_epoch * self.chunk_steps
        for epoch in range(self.epochs):
            if t + epoch_steps <= resume_step:
                t += epoch_steps  # fully-resumed epoch: skip the
                continue  # corpus shuffle too
            if keep_tok is not None:
                shuffled = _prepare_epoch(
                    walks, keep_tok, jax.random.fold_in(k_sub, epoch)
                )
            elif keep_dev is not None:  # big corpus: re-gather keeps
                from graphembedding.train.skipgram import (
                    _prepare_epoch_regather,
                )

                shuffled = _prepare_epoch_regather(
                    walks, keep_dev, jax.random.fold_in(k_sub, epoch)
                )
            else:
                shuffled = _shuffle_walks(
                    walks, jax.random.fold_in(k_shuf, epoch)
                )
            for c in range(chunks_per_epoch):
                if t < resume_step:
                    t += self.chunk_steps
                    continue
                w_in, w_tree, l = run_chunk(w_in, w_tree, shuffled, t)
                losses.append(l)
                t += self.chunk_steps
                n_chunk_calls += 1
                if metrics is not None:
                    metrics.log(
                        kind="hs_chunk", epoch=epoch, step=t,
                        loss=round(float(l.mean()), 5),
                    )
                if checkpoint_dir and checkpoint_every:
                    from graphembedding.utils.checkpoint import (
                        maybe_save,
                    )

                    maybe_save(
                        checkpoint_dir, checkpoint_every, n_chunk_calls,
                        lambda: {
                            "w_in": np.asarray(w_in),
                            "w_tree": np.asarray(w_tree),
                            "step": np.asarray(t),
                        },
                    )
        if not losses:  # fully resumed past the end
            losses = [jnp.zeros((0,), jnp.float32)]
        return w_in, w_tree, jnp.concatenate(losses)
