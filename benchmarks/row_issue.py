"""Measure the per-row gather / scatter-add issue cost on this device.

Random row traffic on the fused [V, 2D] table is a large part of the
walk-block SGNS step. This microbenchmark isolates that primitive at the
step's exact shapes — gather N random rows from a [V, C] table, and
scatter-add N gradient rows back — so the roofline in
`utils/profiling.py` uses a *measured* per-row cost of the device it
runs on instead of a guessed constant.

Run: `python -m benchmarks.row_issue [--v 2405] [--rows 45696]`
Prints one JSON line {gather_ns_per_row, scatter_ns_per_row, ...}.
"""

from __future__ import annotations

import argparse
import json
import time


def measure_row_issue(v=2405, c=256, n_rows=45696, reps=4, window=64):
    """Return (gather_ns_per_row, scatter_ns_per_row) measured warm.

    Shapes default to the bench headline step: V=wiki vocab, C=2D=256,
    n_rows = tokens + shared negatives per step (G*PL + G2*K at
    Bw=4032, L=10, K=64, neg_share_packs=4).
    """
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(0)
    table = jax.random.uniform(key, (v, c), jnp.float32)
    grads = jax.random.uniform(jax.random.fold_in(key, 1),
                               (n_rows, c), jnp.float32)

    # `window` iterations inside ONE compiled scan per timed call, so
    # per-dispatch overhead amortizes exactly as it does in the real
    # 64-step training chunk. ALL ids are pre-generated and scanned
    # over, so no RNG runs inside the timed program. Distinct ids per
    # iteration and per call.
    @jax.jit
    def ids_for(key):
        return jax.random.randint(
            key, (window, n_rows), 0, v, jnp.int32
        )

    @jax.jit
    def gather_scan(table, ids):
        def step(acc, ids_i):
            # consume every gathered row (a [0, :1] probe lets XLA DCE
            # the gather down to one element); the reduction fuses into
            # the gather so the measured cost is the row reads
            return acc + table[ids_i].sum(axis=0)[:1], None

        acc, _ = jax.lax.scan(
            step, jnp.zeros((1,), jnp.float32), ids
        )
        return acc

    @jax.jit
    def scatter_scan(table, ids, grads):
        def step(tbl, ids_i):
            return tbl.at[ids_i].add(grads), None

        tbl, _ = jax.lax.scan(step, table, ids)
        return tbl

    @jax.jit
    def scatter_sorted_scan(table, ids, grads):
        # sort ids (payload follows via one extra gather) before the
        # scatter — probes whether scatter cost at large V is locality
        def step(tbl, ids_i):
            order = jnp.argsort(ids_i)
            return tbl.at[ids_i[order]].add(grads[order]), None

        tbl, _ = jax.lax.scan(step, table, ids)
        return tbl

    ids0 = ids_for(key)
    _ = float(gather_scan(table, ids0)[0])
    _ = float(scatter_scan(table, ids0, grads)[0, 0])
    _ = float(scatter_sorted_scan(table, ids0, grads)[0, 0])

    def time_best(fn, *extra):
        best = float("inf")
        for r in range(reps):
            ids = ids_for(jax.random.fold_in(key, 1000 + r))
            _ = int(ids[0, 0])  # ids materialized OUTSIDE the window
            t0 = time.time()
            out = fn(table, ids, *extra)
            _ = float(jnp.asarray(out).reshape(-1)[0])
            best = min(best, (time.time() - t0) / window)
        return best

    t_g = time_best(gather_scan)
    t_s = time_best(scatter_scan, grads)
    t_ss = time_best(scatter_sorted_scan, grads)
    return (t_g / n_rows * 1e9, t_s / n_rows * 1e9,
            t_ss / n_rows * 1e9, 0.0)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--v", type=int, default=2405)
    p.add_argument("--c", type=int, default=256)
    p.add_argument("--rows", type=int, default=45696)
    args = p.parse_args()
    g_ns, s_ns, ss_ns, _ = measure_row_issue(
        args.v, args.c, args.rows
    )
    print(json.dumps({
        "v": args.v, "c": args.c, "rows": args.rows,
        "gather_ns_per_row": round(g_ns, 2),
        "scatter_ns_per_row": round(s_ns, 2),
        "scatter_sorted_ns_per_row": round(ss_ns, 2),
    }))


if __name__ == "__main__":
    main()
