"""End-to-end DeepWalk at million-node scale on one card.

Builds a synthetic power-lawish random graph at the requested vertex
count, runs the batched uniform-walk kernel for the full corpus, then
one SGNS training pass — reporting walked edges/s and trained pairs/s
as JSON lines. This is the single-card scale story: the reference
(pure-Python walks + gensim) does not run at this scale at all.

Usage: python -m benchmarks.million [--nodes 1000000] [--avg-degree 10]
       [--num-walks 5] [--epochs 1]
"""

from __future__ import annotations

import argparse
import json
import time
from functools import partial

import jax
import numpy as np

from graphembedding.graph import Graph
from graphembedding.ops.walk import simulate_walks
from graphembedding.train.skipgram import (
    SkipGramConfig,
    SkipGramTrainer,
)


def synthetic_graph(V: int, avg_degree: int, seed: int = 0) -> Graph:
    """Ring (connectivity) + random edges with a mild hub skew.

    Generated and CSR-sorted ON DEVICE (one jitted program: edge RNG,
    symmetrization, key sort, degree scatter) — this build host's
    numpy path costs minutes at 10M nodes vs seconds here; `Graph.from_csr` adopts the
    sorted arrays without re-sorting.
    """
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("V", "n_rand"))
    def build(key, *, V, n_rand):
        k1, k2 = jax.random.split(key)
        ring_src = jnp.arange(V, dtype=jnp.int32)
        ring_dst = (ring_src + 1) % V
        src = jax.random.randint(k1, (n_rand,), 0, V, dtype=jnp.int32)
        # quadratic skew toward low ids -> heavy-tailed degrees
        dst = (
            jax.random.uniform(k2, (n_rand,)) ** 2 * V
        ).astype(jnp.int32) % V
        s = jnp.concatenate([ring_src, src])
        d = jnp.concatenate([ring_dst, dst])
        # undirected: append reverses. Self-loops would double-count
        # if reversed, but none exist by construction (ring edges
        # never loop; random loops are remapped below), so the
        # reverse list is exact.
        loop = s == d
        d = jnp.where(loop, (d + 1) % V, d)
        s2 = jnp.concatenate([s, d])
        d2 = jnp.concatenate([d, s])
        # two-key lexicographic sort -> CSR with sorted in-row columns
        s2, d2 = jax.lax.sort((s2, d2), num_keys=2)
        counts = jnp.zeros((V,), jnp.int32).at[s2].add(1)
        row_ptr = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32),
             jnp.cumsum(counts).astype(jnp.int32)]
        )
        return row_ptr, d2

    n_rand = V * max(avg_degree - 2, 1) // 2
    row_ptr, col_idx = build(
        jax.random.PRNGKey(seed), V=V, n_rand=n_rand
    )
    return Graph.from_csr(
        np.asarray(row_ptr), np.asarray(col_idx), directed=False
    )


def clustered_graph(V: int, avg_degree: int, seed: int = 0,
                    spread: int = 4096) -> Graph:
    """Small-world graph WITH vertex locality: ring + random edges
    whose endpoints fall within `spread` ids of the source (heavy-tail
    offsets), plus a sparse long-range tail. Real graphs have strong
    clustering; under a locality-preserving id order their walks stay
    in narrow id ranges — the workload the windowed-scatter path
    (`SkipGramConfig.cap_window_rows`) is built for. Same edge count
    and degree shape as `synthetic_graph`."""
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("V", "n_rand"))
    def build(key, *, V, n_rand):
        k1, k2, k3 = jax.random.split(key, 3)
        ring_src = jnp.arange(V, dtype=jnp.int32)
        ring_dst = (ring_src + 1) % V
        src = jax.random.randint(k1, (n_rand,), 0, V, dtype=jnp.int32)
        # offsets heavy-tailed within +-spread; ~2% long-range rewires
        off = (
            jax.random.uniform(k2, (n_rand,)) ** 2 * spread
        ).astype(jnp.int32) + 1
        sign = jax.random.rademacher(k3, (n_rand,), dtype=jnp.int32)
        dst = (src + sign * off) % V
        far = jax.random.uniform(
            jax.random.fold_in(k2, 1), (n_rand,)
        ) < 0.02
        dst = jnp.where(
            far,
            jax.random.randint(jax.random.fold_in(k3, 1), (n_rand,),
                               0, V, dtype=jnp.int32),
            dst,
        )
        s = jnp.concatenate([ring_src, src])
        d = jnp.concatenate([ring_dst, dst])
        loop = s == d
        d = jnp.where(loop, (d + 1) % V, d)
        s2 = jnp.concatenate([s, d])
        d2 = jnp.concatenate([d, s])
        s2, d2 = jax.lax.sort((s2, d2), num_keys=2)
        counts = jnp.zeros((V,), jnp.int32).at[s2].add(1)
        row_ptr = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32),
             jnp.cumsum(counts).astype(jnp.int32)]
        )
        return row_ptr, d2

    n_rand = V * max(avg_degree - 2, 1) // 2
    row_ptr, col_idx = build(
        jax.random.PRNGKey(seed), V=V, n_rand=n_rand
    )
    return Graph.from_csr(
        np.asarray(row_ptr), np.asarray(col_idx), directed=False
    )


def sparse_cap_chunks(V=1_000_000, n_rep=3, chunks_per_rep=4):
    """Steady-state pairs/s of the sparse-cap fused-table SGNS chunk
    at V nodes, on a locality corpus (2 walks of length 10 per node of
    `clustered_graph(V, 10)`), with the trainer's own table init and
    shipped block policy.

    Returns (pairs_per_s, losses, w_cat): the best rep's rate, every
    timed chunk's per-step losses [n_rep * chunks_per_rep, S], and the
    final [V, 2D] table, for callers that check the result.
    """
    import jax.numpy as jnp

    from graphembedding.train.skipgram import (
        corpus_counts,
        negative_table,
        plan_block_walks,
        sgns_block_chunk_cat,
    )

    g = clustered_graph(V, 10)
    walks = simulate_walks(g, 2, 10, jax.random.PRNGKey(0))
    table = jnp.asarray(negative_table(corpus_counts(np.asarray(walks), V)))
    g.free_device()
    cfg = SkipGramConfig()
    w_cat = SkipGramTrainer(cfg)._init_cat(V, jax.random.PRNGKey(1))
    NW, L = walks.shape
    S, Bw = cfg.chunk_steps, plan_block_walks(NW, L, V, cfg)

    def chunk(w_cat, t):
        return sgns_block_chunk_cat(
            w_cat, walks, table, jax.random.PRNGKey(2),
            jnp.float32(cfg.alpha), jnp.float32(cfg.min_alpha),
            jnp.int32(t), jnp.float32(1e5),
            chunk_steps=S, block_walks=Bw, window=cfg.window,
            negative=cfg.negative, k_shared=cfg.k_shared,
            neg_share_walks=cfg.neg_share_walks,
            neg_share_packs=cfg.neg_share_packs,
            sparse_cap=True,
        )

    w_cat, l, _ = chunk(w_cat, 0)  # compile + warm
    float(l.mean())
    t = S
    best, best_pairs, losses = float("inf"), 0.0, []
    for _ in range(n_rep):
        t0 = time.perf_counter()
        acc = []
        for _ in range(chunks_per_rep):
            w_cat, l, pairs = chunk(w_cat, t)
            acc.append(pairs)
            losses.append(l)
            t += S
        total_pairs = float(jnp.sum(jnp.stack([p.sum() for p in acc])))
        dt = time.perf_counter() - t0
        if dt < best:
            best, best_pairs = dt, total_pairs
    return best_pairs / best, np.asarray(jnp.stack(losses)), w_cat


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--avg-degree", type=int, default=10)
    ap.add_argument("--num-walks", type=int, default=5)
    ap.add_argument("--walk-length", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--clustered", action="store_true",
                    help="locality-bearing small-world graph")
    ap.add_argument("--blocked", action="store_true",
                    help="block-preserving epoch shuffle (corpus-order "
                         "row clustering; SkipGramConfig.shuffle_mode)")
    args = ap.parse_args()
    V = args.nodes

    t0 = time.perf_counter()
    if args.clustered:
        g = clustered_graph(V, args.avg_degree)
    else:
        g = synthetic_graph(V, args.avg_degree)
    t_build = time.perf_counter() - t0
    print(json.dumps({
        "bench": "million_build",
        "nodes": V,
        "edges": g.num_edges,
        "seconds": round(t_build, 2),
    }), flush=True)

    # warm the walk program on the same shapes, then time a fresh key
    t0 = time.perf_counter()
    walks = simulate_walks(
        g, args.num_walks, args.walk_length, jax.random.PRNGKey(0)
    )
    float(walks.sum())
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    walks = simulate_walks(
        g, args.num_walks, args.walk_length, jax.random.PRNGKey(1)
    )
    float(walks.sum())
    t_walk = time.perf_counter() - t0
    edges = walks.shape[0] * (walks.shape[1] - 1)
    print(json.dumps({
        "bench": "million_walks",
        "nodes": V,
        "walkers": walks.shape[0],
        "walked_edges_per_s": round(edges / t_walk),
        "seconds_warm": round(t_walk, 2),
        "seconds_cold": round(t_cold, 2),
    }), flush=True)

    # the fit never touches the graph — drop its ~1 GB of device CSR
    # buffers so the table has the chip to itself
    g.free_device()

    kw = dict(shuffle_mode="block") if args.blocked else {}
    cfg = SkipGramConfig(epochs=args.epochs, **kw)
    trainer = SkipGramTrainer(cfg)
    t0 = time.perf_counter()
    trainer.fit(walks, V)  # cold pass: compiles + one-time host builds
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    w_in, w_out, losses = trainer.fit(walks, V)
    float(w_in.sum())
    t_train = time.perf_counter() - t0
    print(json.dumps({
        "bench": "million_train",
        "nodes": V,
        "epochs": args.epochs,
        "seconds_warm": round(t_train, 2),
        "seconds_cold": round(t_cold, 2),
        "pairs_per_s": round(trainer.trained_pairs_ / t_train),
        "mean_loss_tail": round(float(np.asarray(losses)[-20:].mean()), 4),
    }), flush=True)


if __name__ == "__main__":
    main()
