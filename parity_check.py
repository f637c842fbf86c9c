"""Reference-mount parity readiness — run this at every round start.

The reference mount `/root/reference/` was EMPTY in rounds 1–2
(SURVEY.md §0 documents the evidence). Everything quality-related is
therefore anchored to SURVEY's reconstruction and synthetic datasets.
This script is the one-command re-baseline for the session where the
mount appears:

1. **Mount detection** — file count + expected layout (`ge/`, `data/`,
   `examples/`). Empty mount → one JSON status line, exit 0.
2. **SURVEY citation spot-check** — verifies the `[U]`-marked file
   paths SURVEY.md relies on actually exist, so its line-number
   citations can be trusted (or flagged) before building against them.
3. **Copy-check spot-check** — line-overlap similarity of every
   first-party source file against same-named reference files (the
   mechanical detector only runs post-round; this catches accidental
   convergence immediately).
4. **BASELINE.md protocol** — runs each canonical config (SURVEY §3.1
   row 12) through `load_dataset`, which searches the mount's `data/`
   first, and records micro/macro-F1 + per-phase wall-clock. The
   report says per-config whether it ran on REAL or synthetic data.

Usage:
    python parity_check.py [--root /root/reference] [--quick]
        [--out PARITY_RUN] [--skip-baseline]

`make parity` wraps the default invocation. Tested against a mock
mount layout in tests/test_parity_check.py.
"""

from __future__ import annotations

import argparse
import json
import os
import time


# SURVEY.md's load-bearing [U] citations (paths only; line numbers are
# declared approximate there). If these exist, SURVEY's symbol-level
# reconstruction can be spot-checked; whatever is missing means the
# kangzf fork diverges from upstream shenweichen and SURVEY §0's
# reconciliation instruction applies.
SURVEY_CITED_PATHS = [
    "ge/__init__.py",
    "ge/models/__init__.py",
    "ge/models/deepwalk.py",
    "ge/models/node2vec.py",
    "ge/models/line.py",
    "ge/models/sdne.py",
    "ge/models/struc2vec.py",
    "ge/utils.py",
    "ge/alias.py",
    "ge/walker.py",
    "ge/classify.py",
    "examples/deepwalk_wiki.py",
    "data/wiki/Wiki_edgelist.txt",
    "data/flight/brazil-airports.edgelist",
]

# canonical configs: SURVEY §3.1 row 12 hyperparameters
CONFIGS = [
    ("deepwalk", "wiki",
     dict(walk_length=10, num_walks=80),
     dict(window_size=5, iter=3)),
    ("node2vec", "wiki",
     dict(walk_length=10, num_walks=80, p=0.25, q=4),
     dict(window_size=5, iter=3)),
    ("line", "wiki",
     dict(embedding_size=128, order="second"),
     dict(batch_size=1024, epochs=50)),
    ("sdne", "wiki",
     dict(hidden_size=[256, 128]),
     dict(batch_size=3000, epochs=40)),
    ("struc2vec", "flight-brazil",
     dict(walk_length=10, num_walks=80, workers=4),
     dict(window_size=5, iter=5)),
]

QUICK_CONFIGS = [
    ("deepwalk", "wiki",
     dict(walk_length=5, num_walks=20),
     dict(window_size=3, iter=3, embed_size=16)),
    ("struc2vec", "flight-brazil",
     dict(walk_length=5, num_walks=8),
     dict(window_size=3, iter=1, embed_size=16)),
]


def mount_status(root: str) -> dict:
    """File count + layout detection for the reference mount."""
    n_files = 0
    if os.path.isdir(root):
        for _, _, files in os.walk(root):
            n_files += len(files)
    layout = {
        d: os.path.isdir(os.path.join(root, d))
        for d in ("ge", "data", "examples")
    }
    return {
        "root": root,
        "files": n_files,
        "layout": layout,
        "populated": n_files > 0,
    }


def spot_check_citations(root: str) -> dict:
    found, missing = [], []
    for rel in SURVEY_CITED_PATHS:
        (found if os.path.exists(os.path.join(root, rel))
         else missing).append(rel)
    return {"found": found, "missing": missing}


def _sig_lines(path: str) -> set:
    """Non-trivial stripped source lines (the copy-check unit)."""
    out = set()
    try:
        with open(path, errors="replace") as f:
            for ln in f:
                s = "".join(ln.split())
                if len(s) > 12 and not s.startswith("#"):
                    out.add(s)
    except OSError:
        pass
    return out


def copycheck(root: str, repo: str) -> list:
    """Line-overlap similarity of our sources vs same-named reference
    files. Returns [{ours, theirs, similarity}] sorted desc; anything
    >= 0.6 deserves the judge-style manual look."""
    ref_by_name = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                ref_by_name.setdefault(f, []).append(
                    os.path.join(dirpath, f)
                )
    results = []
    pkg = os.path.join(repo, "graphembedding")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            ours = os.path.join(dirpath, f)
            mine = _sig_lines(ours)
            if not mine:
                continue
            for theirs in ref_by_name.get(f, []):
                ref = _sig_lines(theirs)
                if not ref:
                    continue
                sim = len(mine & ref) / len(mine)
                results.append({
                    "ours": os.path.relpath(ours, repo),
                    "theirs": os.path.relpath(theirs, root),
                    "similarity": round(sim, 3),
                })
    return sorted(results, key=lambda r: -r["similarity"])


def run_baseline(quick: bool = False) -> list:
    """BASELINE.md protocol: canonical configs, seed-0 split,
    tr_frac 0.8, per-phase wall-clock. `load_dataset` picks real
    reference data when the mount (or GE_REFERENCE_ROOT) has it."""
    from graphembedding.data import load_dataset
    from graphembedding.eval.classify import Classifier
    from graphembedding.models import (
        LINE,
        SDNE,
        DeepWalk,
        Node2Vec,
        Struc2Vec,
    )

    classes = {
        "deepwalk": DeepWalk,
        "node2vec": Node2Vec,
        "line": LINE,
        "sdne": SDNE,
        "struc2vec": Struc2Vec,
    }
    rows = []
    for name, dsname, ctor_kw, train_kw in (
        QUICK_CONFIGS if quick else CONFIGS
    ):
        ds = load_dataset(dsname)
        t0 = time.perf_counter()
        model = classes[name](ds.graph, **ctor_kw)
        t1 = time.perf_counter()
        model.train(**train_kw)
        t2 = time.perf_counter()
        emb = model.get_embeddings()
        res = Classifier(emb).split_train_evaluate(ds.X, ds.Y, 0.8)
        rows.append({
            "model": name,
            "dataset": ds.name,
            "real_data": not ds.synthetic,
            "micro_f1": round(float(res["micro"]), 4),
            "macro_f1": round(float(res["macro"]), 4),
            "setup_s": round(t1 - t0, 2),
            "train_s": round(t2 - t1, 2),
        })
    return rows


def write_report(out: str, status: dict, citations: dict,
                 copies: list, baseline: list) -> None:
    with open(out + ".json", "w") as f:
        json.dump({
            "mount": status,
            "citations": citations,
            "copycheck_top": copies[:20],
            "baseline": baseline,
        }, f, indent=1)
    lines = [
        "# PARITY RUN — reference-mount re-baseline",
        "",
        f"Mount: `{status['root']}` — {status['files']} files, "
        f"layout {status['layout']}.",
        "",
        f"## SURVEY citation spot-check: {len(citations['found'])}"
        f"/{len(SURVEY_CITED_PATHS)} paths present",
        "",
    ]
    if citations["missing"]:
        lines.append("Missing (fork diverges from upstream — reconcile "
                     "per SURVEY §0):")
        lines += [f"- `{m}`" for m in citations["missing"]]
        lines.append("")
    flagged = [c for c in copies if c["similarity"] >= 0.6]
    lines.append(f"## Copy-check: {len(flagged)} file(s) ≥ 0.6 "
                 "line-overlap similarity")
    for c in (flagged or copies[:5]):
        lines.append(f"- {c['ours']} vs {c['theirs']}: "
                     f"{c['similarity']}")
    lines += ["", "## BASELINE.md protocol", "",
              "| model | dataset | real data | micro-F1 | macro-F1 "
              "| setup s | train s |",
              "|---|---|---|---|---|---|---|"]
    for r in baseline:
        lines.append(
            f"| {r['model']} | {r['dataset']} | "
            f"{'YES' if r['real_data'] else 'no (synthetic)'} | "
            f"{r['micro_f1']} | {r['macro_f1']} | {r['setup_s']} | "
            f"{r['train_s']} |"
        )
    with open(out + ".md", "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=os.environ.get(
        "GE_REFERENCE_ROOT", "/root/reference"))
    ap.add_argument("--out", default="PARITY_RUN")
    ap.add_argument("--quick", action="store_true",
                    help="reduced hyperparameters (mock-mount tests)")
    ap.add_argument("--skip-baseline", action="store_true")
    args = ap.parse_args(argv)

    status = mount_status(args.root)
    if not status["populated"]:
        print(json.dumps({"mount": "empty", **status}))
        return 0

    os.environ["GE_REFERENCE_ROOT"] = args.root
    citations = spot_check_citations(args.root)
    copies = copycheck(args.root, os.path.dirname(
        os.path.abspath(__file__)))
    baseline = [] if args.skip_baseline else run_baseline(args.quick)
    write_report(args.out, status, citations, copies, baseline)
    print(json.dumps({
        "mount": "populated",
        "files": status["files"],
        "citations_found": len(citations["found"]),
        "citations_missing": len(citations["missing"]),
        "copycheck_flagged": len(
            [c for c in copies if c["similarity"] >= 0.6]
        ),
        "baseline_rows": len(baseline),
        "report": args.out + ".md",
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
