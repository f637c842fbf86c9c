"""Shared example plumbing: CLI, evaluation, and t-SNE plotting.

Reference counterpart: the per-example `evaluate_embeddings` /
`plot_embeddings` helpers duplicated in each `examples/*.py [U]`
(SURVEY.md §3.1 row 12). Same semantics, one place, plus a small CLI
(the reference hard-codes paths and has no flags — SURVEY.md §6).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# run examples straight from a checkout without installing
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from graphembedding.data import load_dataset
from graphembedding.eval.classify import Classifier


def make_parser(name: str, dataset_default: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=name)
    p.add_argument("--dataset", default=dataset_default,
                   help="dataset name (wiki, flight-brazil, blogcatalog)")
    p.add_argument("--embed-size", type=int, default=128)
    p.add_argument("--train-frac", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--plot", default=None, metavar="PNG",
                   help="write a t-SNE scatter to this file")
    p.add_argument("--json", action="store_true",
                   help="print results as one JSON line")
    p.add_argument("--trainer", default="block",
                   choices=("block", "dense"),
                   help="'dense' = closed-form expected-SGNS "
                        "(train/dense.py; small graphs, ~0.2 s at "
                        "wiki scale)")
    p.add_argument("--mesh", default=None, metavar="DATA[xMODEL]",
                   help="train over a device mesh, e.g. '8' or '4x2' "
                        "(data x model axes; needs that many JAX "
                        "devices — set JAX_PLATFORMS=cpu and "
                        "XLA_FLAGS=--xla_force_host_platform_device_"
                        "count=N for a virtual mesh)")
    return p


def mesh_from_args(args):
    """None, or a (data, model) Mesh parsed from --mesh."""
    if not getattr(args, "mesh", None):
        return None
    from graphembedding.parallel import make_mesh

    parts = str(args.mesh).lower().split("x")
    shape = (int(parts[0]), int(parts[1]) if len(parts) > 1 else 1)
    return make_mesh(shape)


def evaluate_embeddings(embeddings, ds, train_frac=0.8, seed=0):
    clf = Classifier(embeddings)
    return clf.split_train_evaluate(ds.X, ds.Y, train_frac, seed=seed)


def plot_embeddings(embeddings, ds, path):
    """t-SNE scatter colored by (first) label — reference plot parity."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np
    from sklearn.manifold import TSNE

    X = ds.X
    emb = np.asarray([embeddings[x] for x in X])
    pos = TSNE(n_components=2, random_state=0).fit_transform(emb)
    labels = [ds.labels[x][0] for x in X]
    uniq = sorted(set(labels))
    plt.figure(figsize=(7, 6))
    for c in uniq:
        idx = [i for i, l in enumerate(labels) if l == c]
        plt.scatter(pos[idx, 0], pos[idx, 1], s=6, label=c)
    if len(uniq) <= 20:
        plt.legend(markerscale=2, fontsize=7)
    plt.tight_layout()
    plt.savefig(path, dpi=150)
    plt.close()


def report(name, ds, results, t_train, args):
    if args.json:
        print(json.dumps({
            "model": name,
            "dataset": ds.name,
            "train_s": round(t_train, 2),
            **{k: round(v, 4) for k, v in results.items()},
        }))
    else:
        print(f"[{name}] {ds.name}: train {t_train:.1f}s  " + "  ".join(
            f"{k}={v:.4f}" for k, v in results.items()))


def run(name, dataset_default, build_and_train, parser=None):
    """Generic example main: parse args -> train -> evaluate -> plot."""
    args = (parser or make_parser(name, dataset_default)).parse_args()
    ds = load_dataset(args.dataset)
    t0 = time.time()
    model = build_and_train(ds, args)
    t_train = time.time() - t0
    emb = model.get_embeddings()
    results = evaluate_embeddings(emb, ds, args.train_frac, args.seed)
    report(name, ds, results, t_train, args)
    if args.plot:
        plot_embeddings(emb, ds, args.plot)
    return results
