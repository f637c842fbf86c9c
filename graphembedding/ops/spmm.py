"""Sparse matrix ops: SpMM and SDDMM over the graph adjacency.

Reference counterpart: SDNE's dense `A.todense()` matmuls and the
`tr(Y^T L Y)` term (`ge/models/sdne.py [U]`). BASELINE.json names
"SpMM/SDDMM ... kernels at speed-of-light per chip" for the SDNE path.

For Wiki-scale graphs the dense [V, V] matmul is cheap (2405² in
microseconds on a matrix unit; sparse formats only win when A no
longer fits or density << 1/8). The sparse path here is
**BCOO-based** (`jax.experimental.sparse`), with the Laplacian trace
term rewritten to avoid materializing L at all:

    tr(Y^T L Y) = sum_i d_i ||y_i||² - sum_{(i,j)∈E} w_ij <y_i, y_j>

i.e. a degree-weighted row-norm reduction minus an SDDMM over the edge
list — O(E·D) instead of O(V²·D). `sdne.py` uses this whenever
`sparse=True` (auto for V > threshold).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def adjacency_bcoo(graph, sym: bool = False):
    """Graph adjacency as a jax BCOO matrix (optionally symmetrized)."""
    from jax.experimental import sparse as jsparse

    src, dst, w = graph.edges()
    if sym and graph.directed:
        # A + A^T with duplicate-entry summation (BCOO matmul sums
        # duplicate indices, matching scipy's coo semantics in the
        # reference's `_create_A_L`); undirected graphs already list
        # both directions
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    idx = np.stack([src, dst], axis=1).astype(np.int32)
    return jsparse.BCOO(
        (jnp.asarray(w), jnp.asarray(idx)),
        shape=(graph.num_nodes, graph.num_nodes),
    )


def spmm(A_bcoo, X):
    """Sparse [V,V] x dense [V,D] -> dense [V,D]."""
    return A_bcoo @ X


def sddmm(src, dst, Y):
    """Sampled dense-dense matmul: <y_src_e, y_dst_e> per edge."""
    return jnp.sum(Y[src] * Y[dst], axis=-1)


def laplacian_quadratic(src, dst, w, deg_w, Y):
    """tr(Y^T L Y) with L = D - W(sym), WITHOUT materializing L.

    Args: edge list of the SYMMETRIZED adjacency (each undirected edge
    once per direction, or pass halved weights), deg_w = weighted degree
    per node (row sums of W_sym).
    """
    row_term = jnp.sum(deg_w[:, None] * jnp.square(Y))
    edge_term = jnp.sum(w * sddmm(src, dst, Y))
    return row_term - edge_term


def sym_edges(graph):
    """(src, dst, w, deg_w) of the symmetrized adjacency, as in the
    reference's `_create_A_L` (A_ = A + A^T with duplicate sum).
    Undirected graphs already list both directions in edges() — adding
    the transpose again would double every weight."""
    src, dst, w = graph.edges()
    if graph.directed:
        src2 = np.concatenate([src, dst]).astype(np.int32)
        dst2 = np.concatenate([dst, src]).astype(np.int32)
        w2 = np.concatenate([w, w]).astype(np.float32)
    else:
        src2 = src.astype(np.int32)
        dst2 = dst.astype(np.int32)
        w2 = w.astype(np.float32)
    deg_w = np.zeros(graph.num_nodes, np.float32)
    np.add.at(deg_w, src2, w2)
    return (
        jnp.asarray(src2),
        jnp.asarray(dst2),
        jnp.asarray(w2),
        jnp.asarray(deg_w),
    )
