"""Runtime validation / sanitizer harness (SURVEY.md §6, race-detection row).

Reference counterpart: none — the reference ships no sanitizers, and its
delegated gensim hot loop (`word2vec_inner.pyx [U]`) is *intentionally*
racy (hogwild). This framework is functional JAX, so data races are
impossible by construction; what CAN silently corrupt a run instead are

- out-of-range indices flowing into gather/scatter kernels — XLA *clamps*
  out-of-bounds gathers and *drops* out-of-bounds scatters rather than
  crashing, so a corrupted corpus trains on the wrong embedding rows with
  no error anywhere;
- NaN/Inf escaping into the tables (bad edge weights, exploding LR).

This module provides the SURVEY-promised equivalents of the sanitizer
layer:

- :func:`validate_graph` / :func:`validate_walks` — host-side structural
  invariants for CSR graphs and walk corpora; cheap (vectorized numpy),
  exact, raise ``ValueError`` naming the first violated invariant.
- :func:`checked` — a `jax.experimental.checkify` harness (index + NaN +
  div checks) around any jittable kernel; the functionalized checks run
  on device and raise host-side with the failing check's location.
- :func:`debug_guard` — context manager toggling `jax_debug_nans` /
  `jax_disable_jit` and restoring the previous configuration.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import numpy as np


def validation_enabled() -> bool:
    """Single home for the GE_VALIDATE opt-in gate.

    Read at each call site (not import time) so tests and long-lived
    sessions can toggle validation without reimporting.
    """
    return bool(os.environ.get("GE_VALIDATE"))


def validate_graph(g) -> None:
    """Check the CSR invariants every walk/train kernel relies on.

    Raises ValueError on the first violation. Invariants:
    row_ptr is a [V+1] nondecreasing int array starting at 0 and ending
    at num_edges; degree == diff(row_ptr); col_idx values are vertex ids
    in [0, V); columns are sorted within each row (the rejection-sampling
    (p,q) walk binary-searches them); edge weights are finite and >= 0.
    """
    V, E = g.num_nodes, g.num_edges
    rp = np.asarray(g.row_ptr)
    ci = np.asarray(g.col_idx)
    w = np.asarray(g.edge_weight)
    deg = np.asarray(g.degree)

    if rp.shape != (V + 1,):
        raise ValueError(f"row_ptr shape {rp.shape} != ({V + 1},)")
    if rp[0] != 0 or rp[-1] != E:
        raise ValueError(
            f"row_ptr endpoints ({rp[0]}, {rp[-1]}) != (0, {E})"
        )
    d = np.diff(rp)
    if (d < 0).any():
        r = int(np.argmax(d < 0))
        raise ValueError(f"row_ptr decreases at row {r}")
    if deg.shape != (V,) or (d != deg).any():
        raise ValueError("degree != diff(row_ptr)")
    if ci.shape[0] != E:
        raise ValueError(f"col_idx has {ci.shape[0]} entries != E={E}")
    if E and (bad := (ci < 0) | (ci >= V)).any():
        i = int(np.argmax(bad))
        raise ValueError(
            f"col_idx[{i}] = {ci[i]} out of range [0, {V})"
        )
    # in-row sorted columns (vectorized: the only allowed descents in
    # the flat array are at row boundaries)
    if E > 1:
        desc = np.flatnonzero(ci[1:] < ci[:-1]) + 1
        boundaries = rp[1:-1]
        if desc.size and not np.isin(desc, boundaries).all():
            i = int(desc[~np.isin(desc, boundaries)][0])
            raise ValueError(
                f"col_idx not sorted within its row at edge {i}"
            )
    if w.shape[0] != E:
        raise ValueError(f"edge_weight has {w.shape[0]} entries != {E}")
    if E and not np.isfinite(w).all():
        raise ValueError("edge_weight contains NaN/Inf")
    if E and (w < 0).any():
        raise ValueError("edge_weight contains negative weights")


def validate_walks(walks, num_nodes: int) -> None:
    """Check a walk corpus: int tokens in [-1, V), -1 only as pads.

    The trainers mask -1 and clamp for gathers, so a token >= V would
    silently train row V-1 (XLA clamps); this catches it eagerly.
    Also checks pads are trailing per walk — every producer (dead-end
    termination, subsample compaction) leaves live tokens contiguous
    at the front, and the window mask assumes it.
    """
    wk = np.asarray(walks)
    if wk.ndim != 2:
        raise ValueError(f"walks must be [NW, L], got shape {wk.shape}")
    if not np.issubdtype(wk.dtype, np.integer):
        raise ValueError(f"walks must be integer, got {wk.dtype}")
    if wk.size == 0:
        return
    lo, hi = int(wk.min()), int(wk.max())
    if lo < -1 or hi >= num_nodes:
        raise ValueError(
            f"walk tokens span [{lo}, {hi}] outside [-1, {num_nodes})"
        )
    alive = wk >= 0
    # pads trailing: once a walk hits -1 it must stay -1
    if (alive[:, 1:] & ~alive[:, :-1]).any():
        r = int(np.argmax((alive[:, 1:] & ~alive[:, :-1]).any(axis=1)))
        raise ValueError(
            f"walk {r} has a live token after a -1 pad (pads must be "
            "trailing)"
        )


def checked(fn, *, index=True, nan=True, div=True):
    """Wrap a jittable function with device-side checkify checks.

    Returns a callable with the same signature that raises
    ``jax.experimental.checkify.JaxRuntimeError`` (host-side, after the
    computation) if any enabled check fired — out-of-bounds gather or
    scatter indices, NaN production, division by zero. Usage::

        from graphembedding.ops.walk import uniform_walks
        walks = checked(uniform_walks)(rp, ci, deg, starts, key, length=10)

    Static/keyword arguments pass through. The checks functionalize into
    the program (modest overhead) — a debugging tool and a test harness,
    not a production default.
    """
    from jax.experimental import checkify

    errors = frozenset()
    if index:
        errors = errors | checkify.index_checks
    if nan:
        errors = errors | checkify.nan_checks
    if div:
        errors = errors | checkify.div_checks
    cfn = checkify.checkify(fn, errors=errors)

    def run(*args, **kw):
        err, out = cfn(*args, **kw)
        err.throw()
        return out

    return run


@contextmanager
def debug_guard(nans: bool = True, disable_jit: bool = False):
    """Temporarily enable jax_debug_nans (and optionally disable jit).

    `jax_debug_nans` re-runs any primitive that produced a NaN un-jitted
    to pinpoint it — the interactive complement to `checked`'s
    in-program checks.
    """
    import jax

    prev_nans = jax.config.jax_debug_nans
    prev_jit = jax.config.jax_disable_jit
    try:
        jax.config.update("jax_debug_nans", nans)
        if disable_jit:
            jax.config.update("jax_disable_jit", True)
        yield
    finally:
        jax.config.update("jax_debug_nans", prev_nans)
        jax.config.update("jax_disable_jit", prev_jit)
