"""Scaling-efficiency harness (BASELINE report deliverable).

Measures walked-edges/s and trained-pairs/s of the SHARDED paths at
1..N devices and reports efficiency vs linear scaling, as JSONL.

What a virtual CPU mesh can and cannot measure
----------------------------------------------
On a virtual CPU mesh (`--xla_force_host_platform_device_count`) the N
virtual devices TIME-SHARE the host's physical cores: once aggregate
compute saturates the cores, raw weak-scaling efficiency is bounded by
cores/devices no matter how good the communication is — a property of
the host, not of the sharded design.

So this harness reports BOTH:

- `scaling_efficiency` (raw): rate(n) / (n * rate(1)). Honest but
  host-bound above n ≈ physical cores; on real cards each device is
  its own chip.
- `comm_efficiency`: t_nocomm(n) / t_full(n) at the SAME n — the same
  per-device program with cross-device exchanges removed (training:
  no mid-chunk replica syncs; walks: routing skipped, a
  semantics-free timing control). Core contention hits numerator and
  denominator equally, so this isolates the quantity the virtual mesh
  CAN validate: the fraction of step time spent in the sharded
  exchange. This is the number engineered against BASELINE's >=0.8
  target; the raw row is kept so nothing is hidden.

Weak scaling (per-device work constant) is the default; pass
`--scaling strong` to hold TOTAL work constant and report speedup
instead. On real cards the same harness runs unchanged:
`python -m benchmarks.scaling --devices 0`.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, default=0,
                   help="force N virtual CPU devices (0 = use real)")
    p.add_argument("--walkers", type=int, default=4096,
                   help="walkers per device (weak) / total//n (strong)")
    p.add_argument("--length", type=int, default=10)
    p.add_argument("--chunks", type=int, default=8)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--scaling", choices=("weak", "strong"),
                   default="weak")
    p.add_argument("--relabel", choices=("none", "locality"),
                   default="locality",
                   help="vertex relabeling for the walk engine")
    p.add_argument("--out", default=None, help="JSONL output path")
    args = p.parse_args()

    if args.devices:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()

    import jax

    if args.devices:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from graphembedding.data import load_dataset
    from graphembedding.ops.walk import simulate_walks
    from graphembedding.parallel.mesh import make_mesh
    from graphembedding.parallel.sgns import sharded_sgns_chunk
    from graphembedding.train.skipgram import (
        corpus_counts,
        negative_table,
    )

    ds = load_dataset("wiki")
    g = ds.graph
    n_all = len(jax.devices())
    rows = []

    walks = simulate_walks(g, 10, args.length, jax.random.PRNGKey(0))
    walks_np = np.asarray(walks)
    table = jnp.asarray(negative_table(corpus_counts(walks_np,
                                                     g.num_nodes)))

    sizes = sorted(set(n for n in [1, 2, 4, 8, n_all] if n <= n_all))
    S = 16

    def time_train(mesh, n, bw, sync_every):
        fn = sharded_sgns_chunk(
            mesh, chunk_steps=S, block_walks=bw, window=5, negative=5,
            k_shared=32, sync_every=sync_every,
        )
        w_in = (jax.random.uniform(jax.random.PRNGKey(1),
                                   (g.num_nodes, 128)) - 0.5) / 128
        w_out = jnp.zeros((g.num_nodes, 128))
        with mesh:
            w_in, w_out, l = fn(w_in, w_out, walks, table,
                                jax.random.PRNGKey(2),
                                jnp.float32(0.025), jnp.float32(1e-4),
                                jnp.int32(0), jnp.float32(1e4))
            _ = float(l.mean())
            best = float("inf")
            for r in range(args.reps):
                t0 = time.time()
                t = S
                for c in range(args.chunks):
                    w_in, w_out, l = fn(
                        w_in, w_out, walks, table, jax.random.PRNGKey(2),
                        jnp.float32(0.025), jnp.float32(1e-4),
                        jnp.int32(t), jnp.float32(1e4))
                    t += S
                _ = float(l.mean())
                best = min(best, time.time() - t0)
        pk = max(min(128 // args.length, bw // n), 1)
        bw_used = ((bw // n) // pk) * pk * n
        pairs = args.chunks * S * bw_used * 56
        return pairs / best, best

    base_rate = None
    total_bw = 32 * (sizes[-1] if args.scaling == "strong" else 1)
    for n in sizes:
        mesh = make_mesh((n, 1), devices=jax.devices()[:n])
        bw = total_bw * n if args.scaling == "weak" else total_bw
        rate, t_full = time_train(mesh, n, bw, sync_every=4)
        # comm control: no mid-chunk syncs (sync_every = S keeps only
        # the end-of-chunk sync + the losses pmean — the floor the
        # exchange design is measured against)
        _, t_ctl = time_train(mesh, n, bw, sync_every=S)
        if base_rate is None:
            base_rate = rate
        denom = base_rate * (n if args.scaling == "weak" else 1)
        row = {
            "devices": n,
            "mode": f"train_dp_{args.scaling}",
            "pairs_per_s": round(rate),
            "scaling_efficiency": round(rate / denom, 3),
            "comm_efficiency": round(min(t_ctl / t_full, 1.0), 3),
            "seconds": round(t_full, 3),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    # row-sharded mode (one global table, exchange per step) at full n
    from graphembedding.parallel.rowshard import rowsharded_sgns_chunk

    n = sizes[-1]
    mesh = make_mesh((n, 1), devices=jax.devices()[:n])
    bw = 32 * n
    Vp = ((g.num_nodes + n - 1) // n) * n
    w_cat0 = jnp.zeros((Vp, 256), jnp.float32)
    w_cat0 = w_cat0.at[: g.num_nodes, :128].set(
        (jax.random.uniform(jax.random.PRNGKey(1),
                            (g.num_nodes, 128)) - 0.5) / 128
    )
    fn = rowsharded_sgns_chunk(
        mesh, chunk_steps=S, block_walks=bw, window=5, negative=5,
        k_shared=32,
    )
    with mesh:
        w_cat, l = fn(w_cat0, walks, table, jax.random.PRNGKey(2),
                      jnp.float32(0.025), jnp.float32(1e-4),
                      jnp.int32(0), jnp.float32(1e4))
        _ = float(l.mean())
        best = float("inf")
        for r in range(args.reps):
            t0 = time.time()
            t = S
            for c in range(args.chunks):
                w_cat, l = fn(w_cat, walks, table, jax.random.PRNGKey(2),
                              jnp.float32(0.025), jnp.float32(1e-4),
                              jnp.int32(t), jnp.float32(1e4))
                t += S
            _ = float(l.mean())
            best = min(best, time.time() - t0)
    pk = max(min(128 // args.length, bw // n), 1)
    bw_used = ((bw // n) // pk) * pk * n
    pairs = args.chunks * S * bw_used * 56
    row = {
        "devices": n,
        "mode": "rowshard",
        "pairs_per_s": round(pairs / best),
        "seconds": round(best, 3),
    }
    rows.append(row)
    print(json.dumps(row), flush=True)

    # distributed walk engine: walked-edges/s at 1..N devices — the
    # BASELINE edges/s scaling deliverable. The engine is built and
    # partitioned ONCE per n (DistributedWalker); the timed region is
    # exactly the steady-state jitted walk call, as in real use.
    from graphembedding.parallel.walks import DistributedWalker

    engines = {
        "": {},  # plain all_gather engine (the default path)
        "_a2a": {"exchange": "a2a"},  # crossers-only exact exchange
    }
    per_dev = args.walkers
    for eng_tag, eng_kw in engines.items():
        base_perdev = None
        for n in sizes:
            mesh = make_mesh((n, 1), devices=jax.devices()[:n])
            # num_walks granularity is per-node; rounding makes the
            # realized walkers/device drift a few % across n, so
            # efficiency below is computed on the measured per-device
            # edge rate, not the requested sizes
            if args.scaling == "weak":
                nw = max(round(per_dev * n / g.num_nodes), 1)
            else:
                nw = max(round(per_dev * sizes[-1] / g.num_nodes), 1)
            relabel = None if args.relabel == "none" else args.relabel
            for control in (False, True):
                w = DistributedWalker(
                    g, mesh, args.length, kind="uniform", num_walks=nw,
                    route_off=control, relabel=relabel, **eng_kw,
                )
                walks_d, ov_warm = w.run(jax.random.PRNGKey(3))  # warm
                # rate from MATCHED (edges, time) pairs per rep: each
                # key walks a slightly different edge count (dead
                # ends), so pairing the warm corpus's count with
                # another key's time would bias the rate
                best = float("inf")
                best_rate = 0.0
                ov_max = ov_warm
                for r in range(args.reps):
                    t0 = time.time()
                    wd, ov2 = w.run_device(jax.random.PRNGKey(4 + r))
                    _ = int(jnp.sum(wd[-1] >= 0))
                    dt = time.time() - t0
                    best = min(best, dt)
                    if not control:  # control rate is never consumed
                        ov_max = max(ov_max, int(ov2))
                        wd_np = np.asarray(wd)
                        # run_device keeps filler walker rows (start
                        # -1): count edges only on real rows, or the
                        # filler subtracts one edge each, skewing
                        # with n
                        e_r = int(np.sum(wd_np >= 0)
                                  - np.sum(wd_np[:, 0] >= 0))
                        best_rate = max(best_rate, e_r / dt)
                if control:
                    t_ctl = best
                else:
                    t_full = best
                    rounds_full = w.last_rounds
                    crossed_full = w.last_crossed
                    rate = best_rate
                    # overflow from the MEASURED engine's runs (the
                    # control clamps hops local and always reports 0)
                    ov = ov_max
            # perdev(n)/perdev(1) = weak eff AND strong eff (speedup/n)
            perdev = rate / n
            if base_perdev is None:
                base_perdev = perdev
            row = {
                "devices": n,
                "mode": f"distributed_walks{eng_tag}_{args.scaling}",
                "walked_edges_per_s": round(rate),
                "scaling_efficiency": round(perdev / base_perdev, 3),
                "comm_efficiency": round(min(t_ctl / t_full, 1.0), 3),
                "routing_rounds": rounds_full,
                "overflow": ov,
                "seconds": round(t_full, 3),
            }
            if crossed_full is not None:
                # measured exchange occupancy: rows actually crossing
                # per shard per round vs the n*(bcap+1) dense frame —
                # the wire-byte accounting inputs
                row["crossed_rows_total"] = crossed_full
                if rounds_full:
                    row["crossed_per_shard_round"] = round(
                        crossed_full / (rounds_full * n)
                    )
            rows.append(row)
            print(json.dumps(row), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
