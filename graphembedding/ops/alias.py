"""Alias-method sampling: O(n) host construction, O(1) device draws.

Reference counterpart: `ge/alias.py — create_alias_table / alias_sample [U]`
(Walker's alias method). The construction is a one-time host-side
preprocessing step (optionally accelerated by the C++ native helper); the
*draw* is what runs on device, vectorized over an entire batch of walkers:

    pick  = floor(u1 * n)                       # uniform slot
    take  = u2 < accept[pick]                   # accept or redirect
    out   = where(take, pick, alias[pick])

All tables for per-node neighbor sampling are stored flat, aligned to CSR
row offsets (`AliasTables` in graph.py), so a walker at vertex v samples its
next local neighbor slot with two uniforms and two gathers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def build_alias_table(probs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Build (accept, alias) for one categorical distribution.

    `probs` need not be normalized. Returns accept (f32[n]) and alias
    (i32[n], local indices). Empty input returns empty tables.
    """
    probs = np.asarray(probs, dtype=np.float64)
    n = probs.shape[0]
    if n == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int32)
    total = probs.sum()
    if total <= 0:
        # degenerate: uniform
        area = np.ones(n, dtype=np.float64)
    else:
        area = probs * (n / total)

    accept = np.zeros(n, dtype=np.float64)
    alias = np.zeros(n, dtype=np.int32)
    small = [i for i in range(n) if area[i] < 1.0]
    large = [i for i in range(n) if area[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        accept[s] = area[s]
        alias[s] = l
        area[l] = area[l] - (1.0 - area[s])
        if area[l] < 1.0:
            small.append(l)
        else:
            large.append(l)
    for i in large:
        accept[i] = 1.0
    for i in small:
        accept[i] = 1.0  # numerical leftovers
    return accept.astype(np.float32), alias


def build_row_alias(
    row_ptr: np.ndarray, weights: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row alias tables over a CSR weight array, flat-aligned to it.

    Tries the C++ native builder first (graphembedding.native); falls
    back to the pure-numpy loop. Rows are independent categorical
    distributions over each vertex's out-neighbors.
    """
    try:
        from graphembedding.native import native_build_row_alias

        return native_build_row_alias(row_ptr, weights)
    except Exception:
        pass

    accept = np.ones(weights.shape[0], dtype=np.float32)
    alias = np.zeros(weights.shape[0], dtype=np.int32)
    nrows = row_ptr.shape[0] - 1
    for v in range(nrows):
        s, e = int(row_ptr[v]), int(row_ptr[v + 1])
        if e > s:
            a, al = build_alias_table(weights[s:e])
            accept[s:e] = a
            alias[s:e] = al
    return accept, alias


def create_alias_table(area_ratio) -> Tuple[list, list]:
    """Reference-signature alias construction (`ge.alias.create_alias_table [U]`).

    Takes a normalized probability list and returns `(accept, alias)` as
    Python lists, exactly the shape reference callers expect. Thin shim
    over `build_alias_table` for verbatim user migration.
    """
    accept, alias = build_alias_table(np.asarray(area_ratio))
    return accept.tolist(), alias.tolist()


def alias_sample(accept, alias) -> int:
    """Reference-signature single draw (`ge.alias.alias_sample [U]`).

    Two `np.random.random()` draws against global numpy RNG state, like
    the reference; device paths use `alias_draw` instead.
    """
    n = len(accept)
    i = int(np.random.random() * n)
    return i if np.random.random() < accept[i] else int(alias[i])


def alias_sample_host(
    accept: np.ndarray, alias: np.ndarray, rng: np.random.Generator, size=None
):
    """Host-side draw(s) from one alias table (used by tests/oracles)."""
    n = accept.shape[0]
    pick = rng.integers(0, n, size=size)
    u = rng.random(size=size)
    return np.where(u < accept[pick], pick, alias[pick])


# --------------------------------------------------------------------------- #
# device-side draws (jnp; shapes fully static, used inside walk kernels)
# --------------------------------------------------------------------------- #


def alias_draw(accept, alias, offsets, sizes, u1, u2):
    """Vectorized alias draw from flat per-row tables.

    Parameters (all same leading batch shape [B]):
      offsets : i32 — row start in the flat tables (CSR row_ptr[v])
      sizes   : i32 — row length (degree[v]); caller guarantees sizes >= 1
      u1, u2  : f32 uniforms in [0, 1)

    Returns local slot index i32 [B] in [0, sizes).
    """
    import jax.numpy as jnp

    pick = jnp.minimum((u1 * sizes.astype(jnp.float32)).astype(jnp.int32),
                       sizes - 1)
    flat = offsets + pick
    take = u2 < accept[flat]
    return jnp.where(take, pick, alias[flat])
