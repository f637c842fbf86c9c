"""DeepWalk under `jax.distributed` — the multi-host launch example.

Run ONE copy of this script per process, and pass the coordinator
explicitly. On GPUs each process drives its own card(s) — e.g. four
processes on a 4-card host, one card each:

    CUDA_VISIBLE_DEVICES=$i python examples/deepwalk_multihost.py \
        --coordinator localhost:9955 --num-processes 4 --process-id $i

(One process can also drive all four cards with `mesh=` and no
`jax.distributed` at all; that is the simpler form on one host.) For a
local CPU smoke test, two processes with two virtual devices each:

    XLA_FLAGS=--xla_force_host_platform_device_count=2 \
    JAX_PLATFORMS=cpu \
    python examples/deepwalk_multihost.py \
        --coordinator localhost:9955 --num-processes 2 --process-id 0 &
    ... same with --process-id 1 ...

Every process executes the SAME program: builds the same graph (same
seed), constructs the global (data, model) mesh over ALL processes'
devices, and runs sharded walks + sharded training; the global-array
plumbing (`parallel.mesh.put_global`) assembles each process's slice.
Per-host data handling: hosts read/generate the same corpus
deterministically here; for corpora too big to replicate, feed each
host its shard and use rowshard/dp exactly the same way — the specs
already describe the layout (docs/MULTIHOST.md).

Reference counterpart: none — the reference is single-host joblib
(`ge/walker.py — simulate_walks (~L100) [U]`); this is SURVEY.md §3.3's
mesh/distributed-init row end to end.
"""

from __future__ import annotations

import argparse
import json


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--nodes", type=int, default=120)
    p.add_argument("--walk-length", type=int, default=10)
    p.add_argument("--num-walks", type=int, default=20)
    p.add_argument("--iter", type=int, default=3)
    p.add_argument("--mode", default="dp",
                   choices=("dp", "rowshard"),
                   help="sharded training mode (parallel/trainer.py)")
    p.add_argument("--walk-engine", default="default",
                   choices=("default", "a2a"),
                   help="distributed walk exchange: all_gather router "
                        "(default) or the crossers-only exact "
                        "all_to_all (parallel/walks.py)")
    p.add_argument("--json", action="store_true")
    args = p.parse_args()

    from graphembedding.parallel.mesh import init_distributed

    kw = {}
    if args.coordinator:
        kw = dict(coordinator_address=args.coordinator,
                  num_processes=args.num_processes,
                  process_id=args.process_id)
    init_distributed(**kw)

    import jax

    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.eval.classify import Classifier
    from graphembedding.models import DeepWalk
    from graphembedding.parallel.mesh import make_mesh

    # same seed on every process -> identical graph/corpus everywhere
    ds = synthetic_wiki(num_nodes=args.nodes, num_classes=3,
                        avg_degree=8, seed=5)
    mesh = make_mesh((len(jax.devices()), 1))
    if jax.process_index() == 0:
        print(f"processes={jax.process_count()} "
              f"global_devices={len(jax.devices())} "
              f"local_devices={len(jax.local_devices())}")

    m = DeepWalk(ds.graph, walk_length=args.walk_length,
                 num_walks=args.num_walks, mesh=mesh,
                 walk_exchange=(None if args.walk_engine == "default"
                                else args.walk_engine))
    m.train(embed_size=32, window_size=5, iter=args.iter,
            block_walks=8 * len(jax.devices()),
            parallel_mode=args.mode)

    # evaluation is host-side numpy; every process holds the full
    # table (dp tables are replicated) — rank 0 reports
    if jax.process_index() == 0:
        res = Classifier(m.get_embeddings()).split_train_evaluate(
            ds.X, ds.Y, 0.8
        )
        out = {"micro_f1": round(res["micro"], 4),
               "walk_overflow": m.walk_overflow,
               "processes": jax.process_count()}
        print(json.dumps(out) if args.json else out)


if __name__ == "__main__":
    main()
