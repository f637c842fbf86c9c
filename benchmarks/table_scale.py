"""Single-card SGNS throughput vs vertex count and cap mode.

Measures `train.skipgram.sgns_block_chunk` pairs/s on synthetic walk
corpora at increasing node counts, for both per-row-cap
implementations (`cap_mode` in SkipGramConfig):

- dense: scatter into a [V, 2D+1] buffer + full-table rowwise cap
  passes (optimal while V is small);
- sparse: occupancy scatter [V, 2] -> per-token scale gather ->
  pre-scaled gradient scatter into the donated table (no O(V·D)
  streams; wins at large V).

Usage: python -m benchmarks.table_scale [--nodes 100000 1000000]
Each rep folds the step counter into the chunk inputs, so no two timed
calls see the same inputs.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from graphembedding.train.skipgram import (
    corpus_counts,
    negative_table,
    sgns_block_chunk,
)


def bench_one(V: int, NW: int, sparse: bool, reps: int = 3,
              L: int = 10, D: int = 128) -> float:
    rng = np.random.default_rng(0)
    walks = jnp.asarray(
        rng.integers(0, V, (NW, L), dtype=np.int64).astype(np.int32)
    )
    table = jnp.asarray(negative_table(corpus_counts(walks, V)))
    key = jax.random.PRNGKey(0)
    w_in = (jax.random.uniform(key, (V, D)) - 0.5) / D
    w_out = jnp.zeros((V, D), jnp.float32)
    kw = dict(
        chunk_steps=64, block_walks=4032, window=5, negative=5,
        k_shared=64, neg_share_walks=8, neg_share_packs=4,
        update_cap=8.0, sparse_cap=sparse,
    )

    def run(t0, w_in, w_out):
        return sgns_block_chunk(
            w_in, w_out, walks, table, key, jnp.float32(0.025),
            jnp.float32(1e-4), jnp.int32(t0), jnp.float32(1e7), **kw
        )

    w_in, w_out, l, p = run(0, w_in, w_out)  # compile + warm
    float(l.sum())
    pairs = 0.0
    t_start = time.perf_counter()
    for r in range(1, reps + 1):
        w_in, w_out, l, p = run(r * 64, w_in, w_out)
        pairs += float(p.sum())
    dt = time.perf_counter() - t_start
    return pairs / dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, nargs="+",
                    default=[10_000, 100_000, 1_000_000])
    ap.add_argument("--walks-per-node", type=float, default=5.0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    for V in args.nodes:
        NW = int(V * args.walks_per_node)
        for sparse in (False, True):
            rate = bench_one(V, NW, sparse, reps=args.reps)
            print(json.dumps({
                "bench": "sgns_table_scale",
                "nodes": V,
                "cap_mode": "sparse" if sparse else "dense",
                "pairs_per_s": round(rate),
            }), flush=True)


if __name__ == "__main__":
    main()
