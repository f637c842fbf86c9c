"""Exact-vs-rejection (p,q) kernel crossover vs max degree (one card).

The exact Gumbel-max kernel does O(B·Dpad²/C) vector compares per step
and needs the [V, Dpad] neighbor matrix in device memory; the rejection
kernel is O(B·tries·log Dmax) element gathers with O(E) memory. This
harness measures both on the SAME d-regular graphs at a sweep of
degrees and prints JSONL rows; the resulting table drives
`ops.walk.select_pq_kernel` (auto mode).

Run: `python -m benchmarks.pq_crossover` (each new shape compiles
once, so first reps are discarded).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def regular_graph(V, d, seed=0):
    """d-out-regular multigraph (collisions allowed — timing only)."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(V, dtype=np.int64), d)
    dst = rng.integers(0, V, V * d).astype(np.int64)
    from graphembedding.graph import Graph

    return Graph(src, dst, directed=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=20000)
    ap.add_argument("--length", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--degrees", type=int, nargs="+",
                    default=[8, 32, 128, 512])
    ap.add_argument("--p", type=float, default=0.25)
    ap.add_argument("--q", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from graphembedding.ops.walk import (
        node2vec_walks,
        node2vec_walks_rejection,
    )

    rows = []
    for d in args.degrees:
        g = regular_graph(args.nodes, d)
        dg = g.device
        starts = jnp.arange(dg.num_nodes, dtype=jnp.int32)
        B = int(starts.shape[0])

        def time_kernel(fn, *a, **kw):
            best = float("inf")
            for r in range(args.reps + 1):
                key = jax.random.PRNGKey(100 + r)  # vary inputs
                t0 = time.time()
                w = fn(*a, key, jnp.float32(args.p),
                       jnp.float32(args.q), length=args.length,
                       max_degree=max(dg.max_degree, 1), **kw)
                _ = float(jnp.sum(w >= 0))  # force
                dt = time.time() - t0
                if r > 0:  # rep 0 pays compile
                    best = min(best, dt)
            return best

        nm = g.neighbor_matrix
        t_exact = time_kernel(
            node2vec_walks, dg.row_ptr, dg.col_idx, dg.degree,
            nm.nbr, nm.nbr_w, starts,
        )
        at = g.alias
        # wire wsum as production simulate_walks does (envelope auto
        # rule keys on it; bench graphs are unweighted so wsum = deg)
        wsum = dg.degree.astype(jnp.float32)
        t_rej = time_kernel(
            node2vec_walks_rejection, dg.row_ptr, dg.col_idx,
            dg.degree, at.accept, at.alias, starts, wsum=wsum,
        )
        # dense-membership rejection (nbr-id matrix resident;
        # the bench graphs are unweighted, so the slot-draw proposal
        # fast path applies — as auto-selection would)
        t_rej_dense = time_kernel(
            node2vec_walks_rejection, dg.row_ptr, dg.col_idx,
            dg.degree, at.accept, at.alias, starts, nbr=nm.nbr,
            uniform_rows=True, wsum=wsum,
        )  # proposals/max_tries auto-sized from the acceptance floor
        edges = B * (args.length - 1)
        row = {
            "max_degree": d,
            "dpad": int(nm.max_degree),
            "nodes": args.nodes,
            "p": args.p,
            "q": args.q,
            "exact_s": round(t_exact, 4),
            "rejection_s": round(t_rej, 4),
            "exact_edges_per_s": round(edges / t_exact),
            "rejection_edges_per_s": round(edges / t_rej),
            "rejection_dense_s": round(t_rej_dense, 4),
            "rejection_dense_edges_per_s": round(edges / t_rej_dense),
            "winner": min(
                (("exact", t_exact), ("rejection", t_rej),
                 ("rejection_dense", t_rej_dense)),
                key=lambda kv: kv[1])[0],
            "nbr_matrix_mb": round(
                args.nodes * int(nm.max_degree) * 8 / 1e6, 1
            ),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
