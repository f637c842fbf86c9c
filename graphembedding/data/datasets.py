"""Dataset loaders + synthetic stand-ins.

Reference counterpart: `data/wiki/` (~2,405 nodes / ~17,981 directed edges,
multi-class labels), `data/flight/{brazil,europe,usa}-airports` (4
activity-quartile classes), consumed via `networkx.read_edgelist` in the
examples (SURVEY.md §3.1 rows 12-13). BlogCatalog (10,312 / 333,983 / 39
labels) is named by BASELINE.json but absent from the reference's data.

Because this build environment has no network egress and the reference
mount was empty (SURVEY.md §0), each loader:

1. reads the real files when a path is provided/found (same text formats
   as the reference: `src dst` edgelists, `node label...` label files);
2. otherwise generates a deterministic **synthetic graph of the same
   scale and task structure**:
   - `synthetic_wiki`: degree-corrected stochastic block model — planted
     communities are the labels, so community-preserving embeddings
     (DeepWalk/Node2Vec/LINE/SDNE) score high micro-F1;
   - `synthetic_flight`: a hub-and-spoke network whose labels are degree
     quartiles — *structural role* labels, the task Struc2Vec targets
     (proximity methods do poorly, structure methods well, mirroring the
     airport benchmarks).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from graphembedding.eval.classify import read_node_label
from graphembedding.graph import Graph
from graphembedding.utils.vocab import Vocab

_SEARCH_DIRS = [
    "/root/reference/data",
    os.path.join(os.path.dirname(__file__), "files"),
    "./data",
]


@dataclass
class Dataset:
    name: str
    graph: Graph
    labels: Dict[str, List[str]]  # node name -> label list
    synthetic: bool = False

    @property
    def X(self):
        return list(self.labels.keys())

    @property
    def Y(self):
        return [self.labels[x] for x in self.X]


def _find(*relpaths) -> Optional[str]:
    # GE_REFERENCE_ROOT points at an alternate reference checkout
    # (e.g. the mock mount in tools/parity tests); its data/ dir is
    # searched FIRST so a populated mount always wins over synthetics
    dirs = _SEARCH_DIRS
    env_root = os.environ.get("GE_REFERENCE_ROOT")
    if env_root:
        dirs = [os.path.join(env_root, "data")] + dirs
    for d in dirs:
        for rel in relpaths:
            p = os.path.join(d, rel)
            if os.path.exists(p):
                return p
    return None


def _labels_from_file(path) -> Dict[str, List[str]]:
    # the reference's flight label files carry a "node label" header
    # row (its examples pass skip_head=True); auto-detect it so
    # load_dataset works on the real mount files unmodified
    with open(path) as f:
        head = f.readline()
    if "," in head:
        # the public BlogCatalog dump's group-edges.csv: one
        # `node,group` row per membership (multi-label accumulates)
        out: Dict[str, List[str]] = {}
        with open(path) as f:
            for line in f:
                parts = line.strip().split(",")
                if len(parts) < 2 or parts[0].lower() == "node":
                    continue
                out.setdefault(parts[0], []).append(parts[1])
        return out
    first = head.split()
    skip = bool(first) and first[0].lower() == "node"
    X, Y = read_node_label(path, skip_head=skip)
    return dict(zip(X, Y))


# --------------------------------------------------------------------------- #
# synthetic generators (deterministic; numpy RNG with fixed seed)
# --------------------------------------------------------------------------- #


def synthetic_wiki(
    num_nodes: int = 2405,
    num_classes: int = 17,
    avg_degree: float = 7.5,
    p_in: float = 0.75,
    seed: int = 7,
) -> Dataset:
    """Degree-corrected SBM at Wiki scale; labels = planted communities.

    Directed (like the reference's Wiki DiGraph), integer weights in
    {1..3} mimicking the reference's weighted edgelist.
    """
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, num_classes, size=num_nodes)
    # heterogeneous expected degrees (Zipf-ish like real Wiki)
    theta = rng.pareto(2.5, size=num_nodes) + 0.25
    theta /= theta.mean()

    n_edges = int(num_nodes * avg_degree)
    # sample sources proportional to theta
    src = rng.choice(num_nodes, size=n_edges, p=theta / theta.sum())
    dst = np.empty(n_edges, dtype=np.int64)
    # for each source, pick dst within community w.p. p_in else anywhere,
    # proportional to theta within the chosen pool
    in_comm = rng.random(n_edges) < p_in
    # precompute per-class member lists and per-class theta distributions
    members = [np.where(comm == c)[0] for c in range(num_classes)]
    probs = [theta[m] / theta[m].sum() for m in members]
    global_p = theta / theta.sum()
    for c in range(num_classes):
        sel = in_comm & (comm[src] == c)
        k = int(sel.sum())
        if k:
            dst[sel] = rng.choice(members[c], size=k, p=probs[c])
    k_out = int((~in_comm).sum())
    if k_out:
        dst[~in_comm] = rng.choice(num_nodes, size=k_out, p=global_p)
    # drop self loops, dedupe
    keep = src != dst
    src, dst = src[keep], dst[keep]
    uniq = np.unique(src * num_nodes + dst)
    src, dst = uniq // num_nodes, uniq % num_nodes
    w = rng.integers(1, 4, size=src.shape[0]).astype(np.float32)

    vocab = Vocab(str(i) for i in range(num_nodes))
    graph = Graph(src, dst, w, num_nodes=num_nodes, vocab=vocab,
                  directed=True)
    labels = {str(i): [str(comm[i])] for i in range(num_nodes)}
    return Dataset("wiki-synthetic", graph, labels, synthetic=True)


def synthetic_wiki_hard(
    num_nodes: int = 600,
    num_classes: int = 6,
    avg_degree: float = 8.0,
    p_in: float = 0.45,
    seed: int = 7,
) -> Dataset:
    """Near-detectability-threshold SBM.

    The planted-community gates (`synthetic_wiki` at p_in=0.75)
    saturate at micro-F1 ~1.0, so regressions that would cost points
    on real data can hide under them. This variant sets the mixing
    close to the detectability threshold — classification lands in a
    discriminative 0.6-0.8 band instead (DeepWalk 3-seed calibration
    in tests/test_models.py's gate) — restoring gate sensitivity
    until the real reference datasets are available.
    """
    base = synthetic_wiki(num_nodes=num_nodes, num_classes=num_classes,
                          avg_degree=avg_degree, p_in=p_in, seed=seed)
    return Dataset("wiki-synthetic-hard", base.graph, base.labels,
                   synthetic=True)


def synthetic_flight(
    num_nodes: int = 131, seed: int = 11
) -> Dataset:
    """Hub-and-spoke airport-like network; labels = degree quartiles.

    Built as a Barabási–Albert-style preferential attachment graph
    (undirected, like the reference's flight edgelists); the 4-class
    labels follow the reference's activity-quartile labeling, which
    correlates with structural role rather than community.
    """
    rng = np.random.default_rng(seed)
    m = 3
    src_l, dst_l = [], []
    targets = list(range(m))
    repeated: List[int] = list(range(m))
    for v in range(m, num_nodes):
        for t in set(targets):
            src_l.append(v)
            dst_l.append(t)
            repeated.extend([v, t])
        targets = [repeated[rng.integers(0, len(repeated))] for _ in range(m)]
    src = np.array(src_l)
    dst = np.array(dst_l)

    vocab = Vocab(str(i) for i in range(num_nodes))
    graph = Graph(src, dst, None, num_nodes=num_nodes, vocab=vocab,
                  directed=False)
    deg = graph.degree
    quart = np.searchsorted(
        np.quantile(deg, [0.25, 0.5, 0.75]), deg, side="right"
    )
    labels = {str(i): [str(quart[i])] for i in range(num_nodes)}
    return Dataset("flight-synthetic", graph, labels, synthetic=True)


def synthetic_flight_hard(num_nodes: int = 200, seed: int = 11,
                          flip: float = 0.35) -> Dataset:
    """Structural-role variant near its discriminative band: same BA-style graph and degree-quartile labels as
    `synthetic_flight`, but a seeded `flip` fraction of nodes carries a
    RANDOM other label. Degree-derived labels are exactly what a role
    embedding nails, so the clean task saturates (~0.95 on 200 nodes);
    the flips cap the ceiling near (1-flip)*acc + flip*chance ~ 0.65,
    restoring a band where a quality regression moves the score. (An
    octile variant was tried first and rejected: BA degree ties make
    octile bins degenerate — 40% of nodes share one bin.)"""
    base = synthetic_flight(num_nodes=num_nodes, seed=seed)
    deg = base.graph.degree
    quart = np.searchsorted(
        np.quantile(deg, [0.25, 0.5, 0.75]), deg, side="right"
    )
    rng = np.random.default_rng(seed + 1)
    flip_mask = rng.random(num_nodes) < flip
    offs = rng.integers(1, 4, size=num_nodes)
    noisy = np.where(flip_mask, (quart + offs) % 4, quart)
    labels = {str(i): [str(noisy[i])] for i in range(num_nodes)}
    return Dataset("flight-synthetic-hard", base.graph, labels,
                   synthetic=True)


def synthetic_blogcatalog(seed: int = 13) -> Dataset:
    """BlogCatalog-scale SBM (10,312 nodes / ~333k edges / 39 classes)."""
    ds = synthetic_wiki(
        num_nodes=10312, num_classes=39, avg_degree=32.0, p_in=0.7,
        seed=seed,
    )
    ds.name = "blogcatalog-synthetic"
    return ds


# --------------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------------- #


def load_dataset(name: str) -> Dataset:
    """Load a named dataset: real files if present, synthetic otherwise.

    Names: 'wiki', 'flight-brazil', 'flight-europe', 'flight-usa',
    'blogcatalog'.
    """
    name = name.lower()
    if name == "wiki":
        edges = _find("wiki/Wiki_edgelist.txt")
        labels = _find("wiki/wiki_labels.txt", "wiki/Wiki_labels.txt")
        if edges and labels:
            g = Graph.from_edgelist(edges, directed=True, weighted=True)
            return Dataset("wiki", g, _labels_from_file(labels))
        return synthetic_wiki()
    if name.startswith("flight"):
        region = name.split("-")[-1] if "-" in name else "brazil"
        edges = _find(f"flight/{region}-airports.edgelist")
        labels = _find(f"flight/labels-{region}-airports.txt")
        if edges and labels:
            g = Graph.from_edgelist(edges, directed=False, weighted=False)
            return Dataset(name, g, _labels_from_file(labels))
        # synthetic fallback at the region's real node count
        sizes = {"brazil": 131, "europe": 399, "usa": 1190}
        return synthetic_flight(num_nodes=sizes.get(region, 131))
    if name == "blogcatalog":
        edges = _find("blogcatalog/bc_edgelist.txt",
                      "blogcatalog/edges.csv")
        labels = _find("blogcatalog/bc_labels.txt",
                       "blogcatalog/group-edges.csv")
        if edges and labels:
            g = Graph.from_edgelist(edges, directed=False)
            return Dataset("blogcatalog", g, _labels_from_file(labels))
        return synthetic_blogcatalog()
    raise ValueError(f"unknown dataset {name!r}")
