"""Device-resident graph: padded CSR adjacency + derived sampling structures.

This is the L1 of the framework (reference counterpart: `ge/utils.py`'s
node<->idx maps plus the implicit networkx adjacency; see SURVEY.md §2). The
design is device-first rather than a translation:

- The canonical graph is a **CSR** (`row_ptr`, `col_idx`, `edge_weight`) in
  int32/float32 host numpy, built once from an edge list. Columns are sorted
  within each row so membership tests (needed by the rejection-sampling
  (p,q) walk) are binary searches.
- Device views are **padded to lane multiples (128)** and cached: XLA wants
  static shapes, and all walk kernels gather from these arrays.
- Derived sampling structures are built lazily and cached:
    * per-node neighbor **alias tables** aligned to CSR offsets (weighted
      first-order sampling in O(1));
    * a **padded neighbor matrix** `[V, max_degree]` for the exact
      second-order (p,q) walk (dense Gumbel-max categorical per step).
- Node names never touch the device (`utils.vocab.Vocab`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from graphembedding.utils.vocab import Vocab

_LANE = 128


def _pad_to(x: np.ndarray, multiple: int, fill) -> np.ndarray:
    n = x.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x
    pad = np.full((target - n,) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, pad], axis=0)


@dataclass
class DeviceGraph:
    """jnp views of the CSR, padded to lane multiples. All int32/float32."""

    row_ptr: object  # i32 [V+1]
    col_idx: object  # i32 [E_pad], pad = -1
    edge_weight: object  # f32 [E_pad], pad = 0
    degree: object  # i32 [V]
    num_nodes: int
    num_edges: int
    max_degree: int


@dataclass
class NeighborMatrix:
    """Dense padded neighbor view for the exact (p,q) second-order walk."""

    nbr: object  # i32 [V, Dmax], pad = -1
    nbr_w: object  # f32 [V, Dmax], pad = 0
    max_degree: int


@dataclass
class AliasTables:
    """Per-node neighbor alias tables aligned to CSR offsets.

    `accept[row_ptr[v] + k]` / `alias[row_ptr[v] + k]` describe node v's
    k-th neighbor slot; `alias` holds *local* neighbor indices so a sample
    is `col_idx[row_ptr[v] + pick]`.
    """

    accept: object  # f32 [E_pad]
    alias: object  # i32 [E_pad]


class Graph:
    """Host-canonical CSR graph with cached device views.

    Parameters
    ----------
    src, dst : int arrays of edge endpoints (vocab indices)
    weight : float array of edge weights
    num_nodes : total vertex count (isolated vertices allowed)
    vocab : optional node-name vocabulary
    directed : whether (src, dst) already lists each direction explicitly.
        If False, reversed edges are added automatically.
    """

    def __init__(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        weight: Optional[np.ndarray] = None,
        *,
        num_nodes: Optional[int] = None,
        vocab: Optional[Vocab] = None,
        directed: bool = True,
    ):
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if weight is None:
            weight = np.ones(src.shape[0], dtype=np.float32)
        weight = np.asarray(weight, dtype=np.float32)
        if not directed:
            # add each edge's reverse, but not for self-loops (a loop
            # (u, u) must appear ONCE in row u, or degrees/walk
            # probabilities/edge sampling all double-count it)
            m = src != dst
            src, dst = (
                np.concatenate([src, dst[m]]),
                np.concatenate([dst, src[m]]),
            )
            weight = np.concatenate([weight, weight[m]])

        if num_nodes is None:
            num_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
        self.num_nodes = int(num_nodes)
        self.directed = directed
        # lazy identity vocab by default: a materialized dict+list at
        # 10M nodes costs minutes on host (see utils.vocab)
        if vocab is None:
            from graphembedding.utils.vocab import IdentityVocab

            vocab = IdentityVocab(self.num_nodes)
        self.vocab = vocab

        # CSR build: stable sort by (src, dst) so columns are sorted in-row.
        order = np.lexsort((dst, src))
        src, dst, weight = src[order], dst[order], weight[order]
        self.num_edges = int(src.shape[0])
        counts = np.bincount(src, minlength=self.num_nodes)
        self.row_ptr = np.zeros(self.num_nodes + 1, dtype=np.int32)
        np.cumsum(counts, out=self.row_ptr[1:])
        self.col_idx = dst.astype(np.int32)
        self.edge_weight = weight
        self.degree = counts.astype(np.int32)
        self.max_degree = int(counts.max(initial=0))

        self._device: Optional[DeviceGraph] = None
        self._nbr_matrix: Optional[NeighborMatrix] = None
        self._alias: Optional[AliasTables] = None
        self._host_alias = None

        # opt-in sanitizer (utils.debug): every constructed graph is
        # invariant-checked when GE_VALIDATE is set — XLA clamps
        # bad indices silently, so corruption is otherwise invisible
        from graphembedding.utils.debug import validation_enabled

        if validation_enabled():
            from graphembedding.utils.debug import validate_graph

            validate_graph(self)

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #

    @classmethod
    def from_nx(cls, graph) -> "Graph":
        """Build from a networkx (Di)Graph — the reference's input type.

        Reference parity: indices follow `graph.nodes()` order
        (`ge/utils.py — preprocess_nxgraph [U]`), and an undirected nx.Graph
        contributes both edge directions.
        """
        vocab = Vocab(graph.nodes())
        n_edges = graph.number_of_edges()
        src = np.empty(n_edges, dtype=np.int64)
        dst = np.empty(n_edges, dtype=np.int64)
        w = np.empty(n_edges, dtype=np.float32)
        for i, (u, v, data) in enumerate(graph.edges(data=True)):
            src[i] = vocab[u]
            dst[i] = vocab[v]
            w[i] = float(data.get("weight", 1.0))
        return cls(
            src,
            dst,
            w,
            num_nodes=len(vocab),
            vocab=vocab,
            directed=graph.is_directed(),
        )

    @classmethod
    def from_csr(
        cls,
        row_ptr: np.ndarray,
        col_idx: np.ndarray,
        edge_weight: Optional[np.ndarray] = None,
        *,
        vocab: Optional[Vocab] = None,
        directed: bool = True,
    ) -> "Graph":
        """Adopt an already-built CSR without re-sorting on host.

        For callers that construct the graph on DEVICE (e.g. the
        synthetic scale benchmarks, where a 10M-node host CSR build
        costs minutes and the device build seconds). `col_idx` must be sorted
        within each row; `directed` is metadata only (the CSR is
        adopted as-is — pass both edge directions for an undirected
        graph).
        """
        g = cls.__new__(cls)
        row_ptr = np.asarray(row_ptr, dtype=np.int32)
        g.num_nodes = int(row_ptr.shape[0] - 1)
        g.directed = directed
        if vocab is None:
            from graphembedding.utils.vocab import IdentityVocab

            vocab = IdentityVocab(g.num_nodes)
        g.vocab = vocab
        g.row_ptr = row_ptr
        g.col_idx = np.asarray(col_idx, dtype=np.int32)
        g.num_edges = int(g.col_idx.shape[0])
        if edge_weight is None:
            edge_weight = np.ones(g.num_edges, dtype=np.float32)
        g.edge_weight = np.asarray(edge_weight, dtype=np.float32)
        counts = np.diff(row_ptr)
        g.degree = counts.astype(np.int32)
        g.max_degree = int(counts.max(initial=0))
        g._device = None
        g._nbr_matrix = None
        g._alias = None
        g._host_alias = None
        return g

    @classmethod
    def from_edgelist(
        cls, path: str, *, directed: bool = True, weighted: bool = False
    ) -> "Graph":
        """Load an edgelist file (`src dst [weight]` per line).

        Whitespace- or comma-separated (the public BlogCatalog dump
        named in BASELINE ships `edges.csv` as `node,node` rows)."""
        vocab = Vocab()
        srcs, dsts, ws = [], [], []
        with open(path) as f:
            for line in f:
                parts = line.replace(",", " ").split()
                if not parts or parts[0].startswith("#"):
                    continue
                u, v = parts[0], parts[1]
                w = float(parts[2]) if weighted and len(parts) > 2 else 1.0
                srcs.append(vocab.add(u))
                dsts.append(vocab.add(v))
                ws.append(w)
        return cls(
            np.array(srcs),
            np.array(dsts),
            np.array(ws, dtype=np.float32),
            num_nodes=len(vocab),
            vocab=vocab,
            directed=directed,
        )

    # ------------------------------------------------------------------ #
    # device views (lazy, cached)
    # ------------------------------------------------------------------ #

    def free_device(self) -> None:
        """Drop cached device views (rebuilt lazily on next use).

        At 10M nodes the CSR+alias device buffers are ~1 GB of device
        memory a training fit never touches — freeing them between the
        walk phase and training leaves that room to the tables.
        """
        self._device = None
        self._nbr_matrix = None
        self._alias = None

    @property
    def device(self) -> DeviceGraph:
        if self._device is None:
            import jax.numpy as jnp

            col = _pad_to(self.col_idx, _LANE, -1)
            w = _pad_to(self.edge_weight, _LANE, 0.0)
            self._device = DeviceGraph(
                row_ptr=jnp.asarray(self.row_ptr),
                col_idx=jnp.asarray(col),
                edge_weight=jnp.asarray(w),
                degree=jnp.asarray(self.degree),
                num_nodes=self.num_nodes,
                num_edges=self.num_edges,
                max_degree=self.max_degree,
            )
        return self._device

    @property
    def neighbor_matrix(self) -> NeighborMatrix:
        """Dense `[V, max_degree]` padded neighbor ids + weights (lazy)."""
        if self._nbr_matrix is None:
            import jax.numpy as jnp

            dmax = max(self.max_degree, 1)
            # round the neighbor axis up to a lane multiple for clean tiling
            dpad = ((dmax + _LANE - 1) // _LANE) * _LANE
            nbr = np.full((self.num_nodes, dpad), -1, dtype=np.int32)
            nbr_w = np.zeros((self.num_nodes, dpad), dtype=np.float32)
            # vectorized O(E) assembly (the per-vertex Python loop this
            # replaces took minutes at 10^6 vertices): edge e of
            # vertex v lands at column
            # e - row_ptr[v], row v
            deg = np.diff(self.row_ptr)
            rows = np.repeat(
                np.arange(self.num_nodes, dtype=np.int64), deg
            )
            cols = (
                np.arange(self.num_edges, dtype=np.int64)
                - np.repeat(self.row_ptr[:-1].astype(np.int64), deg)
            )
            nbr[rows, cols] = self.col_idx
            nbr_w[rows, cols] = self.edge_weight
            self._nbr_matrix = NeighborMatrix(
                nbr=jnp.asarray(nbr), nbr_w=jnp.asarray(nbr_w), max_degree=dpad
            )
        return self._nbr_matrix

    @property
    def neighbor_ids(self):
        """Padded neighbor IDS only (i32 [V, Dpad], pad -1) — device.

        The dense-membership rejection kernel needs only the ids; the
        full `neighbor_matrix` ALSO materializes the f32 weight plane,
        doubling memory to the exact kernel's footprint and defeating the
        V*Dpad*4 gate (`select_pq_kernel`). Reuses `neighbor_matrix`'s
        arrays when they already exist; otherwise builds ids alone.
        """
        if self._nbr_matrix is not None:
            return self._nbr_matrix.nbr
        import jax.numpy as jnp

        dmax = max(self.max_degree, 1)
        dpad = ((dmax + _LANE - 1) // _LANE) * _LANE
        nbr = np.full((self.num_nodes, dpad), -1, dtype=np.int32)
        deg = np.diff(self.row_ptr)
        rows = np.repeat(np.arange(self.num_nodes, dtype=np.int64), deg)
        cols = (np.arange(self.num_edges, dtype=np.int64)
                - np.repeat(self.row_ptr[:-1].astype(np.int64), deg))
        nbr[rows, cols] = self.col_idx
        return jnp.asarray(nbr)

    def host_alias(self):
        """(accept f32[E], alias i32[E]) per-node alias tables, host numpy."""
        if self._host_alias is None:
            from graphembedding.ops.alias import build_row_alias

            self._host_alias = build_row_alias(
                self.row_ptr, self.edge_weight
            )
        return self._host_alias

    @property
    def alias(self) -> AliasTables:
        """Device per-node alias tables aligned to (padded) CSR offsets."""
        if self._alias is None:
            import jax.numpy as jnp

            accept, alias = self.host_alias()
            self._alias = AliasTables(
                accept=jnp.asarray(_pad_to(accept, _LANE, 1.0)),
                alias=jnp.asarray(_pad_to(alias, _LANE, 0)),
            )
        return self._alias

    # ------------------------------------------------------------------ #
    # host-side helpers
    # ------------------------------------------------------------------ #

    def neighbors(self, v: int) -> np.ndarray:
        return self.col_idx[self.row_ptr[v] : self.row_ptr[v + 1]]

    def out_weights(self, v: int) -> np.ndarray:
        return self.edge_weight[self.row_ptr[v] : self.row_ptr[v + 1]]

    def edges(self):
        """(src, dst, weight) int64/int64/f32 arrays in CSR order."""
        src = np.repeat(np.arange(self.num_nodes, dtype=np.int64),
                        np.diff(self.row_ptr))
        return src, self.col_idx.astype(np.int64), self.edge_weight

    def __repr__(self):
        return (
            f"Graph(V={self.num_nodes}, E={self.num_edges}, "
            f"directed={self.directed}, max_degree={self.max_degree})"
        )
