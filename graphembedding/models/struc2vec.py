"""Struc2Vec (Ribeiro et al., KDD'17) — structural-role embeddings.

Reference counterpart: `ge/models/struc2vec.py [U]`: per-node BFS degree
sequences per layer (opt1: run-length compressed), DTW structural distances
between ~log n degree-similar node pairs (opt2), cumulative over layers ->
multilayer context graph with weights exp(-f_k), per-layer alias tables,
biased multilayer walks (`BiasedWalker [U]`), then skip-gram. Every stage
pickled to `temp_path` (the reference's only checkpointing).

Host/device split (SURVEY.md §4.5): the context-graph construction is a one-time
host-side preprocessing pipeline (numpy, optionally the C++ native DTW) and
is cached to disk keyed by graph hash; the **multilayer walk runs on
device** — the K layer graphs are K stacked CSRs + alias tables and all
walkers advance in lockstep, emitting one vertex per scan step with a
bounded in-step layer-move loop (the reference's unbounded
while-no-neighbor-step loop, truncated at 16 layer moves per emission —
stay_prob 0.3 makes deeper excursions ~1e-8 likely). Training is SGNS.
"""

from __future__ import annotations

import hashlib
import math
import os
import pickle
from functools import partial
import jax
import jax.numpy as jnp
import numpy as np

from graphembedding.models.base import WalkEmbeddingModel

# --------------------------------------------------------------------------- #
# host-side pipeline
# --------------------------------------------------------------------------- #


def _bfs_degree_lists(row_ptr, col_idx, degree, num_nodes, max_layers,
                      opt1=True):
    """Per node: list over layers of degree sequences of the BFS ring.

    opt1 compresses each ring to sorted (degree, count) pairs, else a
    sorted degree array. Uses the symmetrized adjacency (reference treats
    the graph as undirected for structural identity).
    """
    out = []
    for root in range(num_nodes):
        seen = np.zeros(num_nodes, dtype=bool)
        seen[root] = True
        frontier = np.array([root], dtype=np.int64)
        layers = []
        for _ in range(max_layers):
            if frontier.size == 0:
                break
            degs = np.sort(degree[frontier])
            if opt1:
                vals, counts = np.unique(degs, return_counts=True)
                layers.append(
                    np.stack([vals.astype(np.float64),
                              counts.astype(np.float64)], axis=1)
                )
            else:
                layers.append(degs.astype(np.float64))
            nxt = []
            for v in frontier:
                nxt.append(col_idx[row_ptr[v]: row_ptr[v + 1]])
            if nxt:
                nxt = np.unique(np.concatenate(nxt))
                nxt = nxt[~seen[nxt]]
                seen[nxt] = True
            else:
                nxt = np.array([], dtype=np.int64)
            frontier = nxt
        out.append(layers)
    return out


def _dtw(seq_a, seq_b, opt1=True):
    """Exact DTW with the struc2vec ground cost.

    opt1 sequences are (degree, count) pairs with cost
    (max/min - 1) * max(count_a, count_b) (reference `cost_max [U]`);
    plain sequences use max/min - 1 (reference `cost [U]`).
    Exact O(nm) DP — the ORACLE for `dtw_mode='exact'`. The default
    pipeline mode is `_fastdtw` below (radius-1, what the reference
    actually computes and O(n) per pair — deep-ring RLE sequences
    reach hundreds of distinct degrees, where the exact DP is slower
    at scale).
    """
    if opt1:
        a_deg, a_cnt = seq_a[:, 0], seq_a[:, 1]
        b_deg, b_cnt = seq_b[:, 0], seq_b[:, 1]
        mx = np.maximum.outer(a_deg, b_deg)
        mn = np.minimum.outer(a_deg, b_deg)
        cost = (mx / np.maximum(mn, 1e-12) - 1.0) * np.maximum.outer(
            a_cnt, b_cnt
        )
    else:
        mx = np.maximum.outer(seq_a, seq_b)
        mn = np.minimum.outer(seq_a, seq_b)
        cost = mx / np.maximum(mn, 1e-12) - 1.0
    n, m = cost.shape
    D = np.full((n + 1, m + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, n + 1):
        D[i, 1:] = cost[i - 1]
        for j in range(1, m + 1):
            D[i, j] += min(D[i - 1, j], D[i, j - 1], D[i - 1, j - 1])
    return float(D[n, m])


def _fastdtw(seq_a, seq_b, radius=1):
    """fastdtw (Salvador & Chan) on (degree, count) RLE pairs.

    Pure-Python mirror of the C++ `fastdtw_rle` (native/graphnative.cpp)
    for the no-native fallback path: componentwise half-reduction (odd
    tail dropped, as in the pip package the reference calls), coarse
    solve, radius-expanded window, windowed fine DTW. Overestimates the
    exact DTW by construction (banded); tests pin C++/Python agreement.
    """
    def cost(pa, pb):
        mx = max(pa[0], pb[0])
        mn = max(min(pa[0], pb[0]), 1e-12)
        return (mx / mn - 1.0) * max(pa[1], pb[1])

    def windowed(a, b, band, want_path):
        n, m = len(a), len(b)
        INF = float("inf")
        vals = [{0: 0.0}]
        for i in range(1, n + 1):
            lo, hi = band[i - 1]
            row = {}
            for j in range(max(lo, 1), hi + 1):
                best = min(
                    vals[i - 1].get(j, INF),
                    row.get(j - 1, INF),
                    vals[i - 1].get(j - 1, INF),
                )
                if best < INF:
                    row[j] = cost(a[i - 1], b[j - 1]) + best
            vals.append(row)
        if not want_path:
            return vals[n].get(m, INF), None
        path, i, j = [], n, m
        while i >= 1 and j >= 1:
            path.append((i, j))
            if i == 1 and j == 1:
                break
            opts = [
                (vals[i - 1].get(j - 1, INF), i - 1, j - 1),
                (vals[i - 1].get(j, INF), i - 1, j),
                (vals[i].get(j - 1, INF), i, j - 1),
            ]
            _, i, j = min(opts, key=lambda t: t[0])
        return vals[n].get(m, INF), path[::-1]

    def rec(a, b, want_path):
        n, m = len(a), len(b)
        if n == 0 or m == 0:
            return 0.0, []
        if n <= radius + 2 or m <= radius + 2:
            return windowed(a, b, [(1, m)] * n, want_path)
        ha = [((a[2 * i][0] + a[2 * i + 1][0]) / 2.0,
               (a[2 * i][1] + a[2 * i + 1][1]) / 2.0)
              for i in range(n // 2)]
        hb = [((b[2 * j][0] + b[2 * j + 1][0]) / 2.0,
               (b[2 * j][1] + b[2 * j + 1][1]) / 2.0)
              for j in range(m // 2)]
        _, cpath = rec(ha, hb, True)
        cn, cm = len(ha), len(hb)
        coarse = [(cm + 1, 0)] * cn
        for ci, cj in cpath:
            for i in range(max(ci - radius, 1), min(ci + radius, cn) + 1):
                lo, hi = coarse[i - 1]
                coarse[i - 1] = (
                    min(lo, max(cj - radius, 1)),
                    max(hi, min(cj + radius, cm)),
                )
        band = []
        for i in range(1, n + 1):
            ci = min((i + 1) // 2, cn)
            lo, hi = coarse[ci - 1]
            band.append((max(2 * lo - 1, 1), min(2 * hi, m)))
        band[0] = (1, band[0][1])
        band[-1] = (band[-1][0], m)
        for i in range(1, n):
            lo, hi = band[i]
            plo, phi = band[i - 1]
            band[i] = (min(lo, phi + 1), max(hi, phi))
        return windowed(a, b, band, want_path)

    a = [tuple(p) for p in np.asarray(seq_a).reshape(-1, 2)]
    b = [tuple(p) for p in np.asarray(seq_b).reshape(-1, 2)]
    d, _ = rec(a, b, False)
    return float(d)


def _depth_bound(row_ptr, col_idx, V):
    """Upper bound on BFS ring depth: max over components of
    2*ecc(seed)+1 (>= that component's diameter+1). O(V+E), fully
    vectorized per BFS level (a per-edge Python loop costs minutes
    at 10^5 nodes)."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    col_idx = np.asarray(col_idx, dtype=np.int64)
    seen = np.zeros(V, dtype=bool)
    bound = 1
    for s in range(V):
        if seen[s]:
            continue
        seen[s] = True
        frontier = np.array([s], dtype=np.int64)
        depth = 0
        while frontier.size:
            starts = row_ptr[frontier]
            ln = row_ptr[frontier + 1] - starts
            total = int(ln.sum())
            if total == 0:
                break
            # flat indices of every frontier vertex's neighbor slice
            pos = (
                np.arange(total, dtype=np.int64)
                - np.repeat(np.cumsum(ln) - ln, ln)
                + np.repeat(starts, ln)
            )
            nbrs = col_idx[pos]
            nbrs = nbrs[~seen[nbrs]]
            if nbrs.size == 0:
                break
            frontier = np.unique(nbrs)
            seen[frontier] = True
            depth += 1
        bound = max(bound, 2 * depth + 1)
    return bound


def _similar_degree_pairs(degree, num_nodes):
    """opt2: unique (u < v) pairs where each node is compared to
    ~2 log n nodes of closest degree (reference `get_vertices [U]`,
    log BASE 2). Fully vectorized — a per-node Python list/set
    comprehension walls at ~10^5 nodes.
    """
    V = num_nodes
    order = np.argsort(degree, kind="stable")
    k = max(int(2 * math.log2(max(V, 2))), 2)
    pos_of = np.empty(V, dtype=np.int64)
    pos_of[order] = np.arange(V)
    offs = np.arange(-k, k + 1, dtype=np.int64)
    cand_pos = pos_of[:, None] + offs[None, :]  # [V, 2k+1]
    valid = (cand_pos >= 0) & (cand_pos < V)
    cand = order[np.clip(cand_pos, 0, V - 1)]
    me = np.arange(V, dtype=np.int64)[:, None]
    valid &= cand != me
    u = np.broadcast_to(me, cand.shape)[valid]
    v = cand[valid]
    key = np.unique(np.minimum(u, v) * V + np.maximum(u, v))
    return key // V, key % V


def build_context_graph(graph, max_layers=None, opt1=True, opt2=True,
                        workers=1, dtw_mode="fastdtw",
                        dtw_early_stop=35.0):
    """Structural distances -> per-layer edge lists with weights exp(-f_k).

    Returns (layer_edges, num_layers) where layer_edges[k] is an array
    triple (u, v, w) of the layer's undirected edges with u < v. Tries
    the C++ native DTW batch first; `workers` threads its BFS +
    per-pair DTW loops (the reference's joblib `workers=N` role;
    None/0 -> all hardware threads).

    ``dtw_mode='fastdtw'`` (default) computes radius-1 fastdtw per
    ring — WHAT THE REFERENCE ACTUALLY COMPUTES
    (`ge/models/struc2vec.py — fastdtw(..., radius=1, dist=cost_max)
    [U]`) and O(n) per pair, the preprocessing scale fix
    (100k-node full-depth builds minutes -> tens of seconds on the
    host).
    ``'exact'`` keeps the O(nm) oracle DP (rounds 1-4 behavior).

    The whole host path is vectorized numpy / C++ — no per-node or
    per-pair Python containers (a dict-of-sets adjacency and pair-set
    comprehension wall at ~10^5 nodes).
    """
    workers = workers if workers else 0  # 0 -> all threads (native)
    # symmetrized adjacency for structural identity: dedup directed
    # pairs via a packed (u*V+v) key; np.unique also leaves each CSR
    # row's neighbors sorted
    src, dst, _ = graph.edges()
    V = graph.num_nodes
    mask = src != dst
    u_all = np.concatenate([src[mask], dst[mask]]).astype(np.int64)
    v_all = np.concatenate([dst[mask], src[mask]]).astype(np.int64)
    key = np.unique(u_all * V + v_all)
    u_sym, col_idx = key // V, key % V
    deg = np.bincount(u_sym, minlength=V)
    row_ptr = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(deg, out=row_ptr[1:])

    if max_layers is None:
        # the distance buffers are [n_pairs, max_layers]: cap by a
        # BFS-depth bound (2*ecc(seed)+1 >= diameter per component)
        # instead of V, which allocated O(n_pairs * V) at scale
        max_layers = _depth_bound(row_ptr, col_idx, V)

    if opt2:
        pu, pv = _similar_degree_pairs(deg, V)
    else:
        iu, iv = np.triu_indices(V, k=1)
        pu, pv = iu.astype(np.int64), iv.astype(np.int64)
    n_pairs = pu.shape[0]
    ml = min(max_layers, V)

    # cumulative layer distances f_k(u,v) = f_{k-1} + dtw(ring_k),
    # as [chunk, ml] buffers with per-pair valid layer counts. Pairs
    # are processed in CHUNKS so the f64 distance buffer stays bounded
    # (at 1M nodes opt2 yields ~40M pairs; an unchunked
    # [n_pairs, ml] f64 buffer would wall host RAM)
    native_fn = None
    if opt1 and n_pairs:
        # C++ fast path: BFS + RLE + DTW in one call (minutes -> ms)
        try:
            from graphembedding.native import (
                native_struc2vec_distances,
            )

            native_fn = native_struc2vec_distances
        except Exception:
            native_fn = None

    degree_lists = None

    def _warn_slow():
        import warnings

        warnings.warn(
            "struc2vec native library unavailable (or opt1 disabled) "
            "— using the pure-Python BFS/DTW pipeline, which is "
            "orders of magnitude slower at scale (build "
            "graphembedding/native, see tests/test_native.py).",
            stacklevel=3,
        )

    if native_fn is None and n_pairs:
        _warn_slow()
        degree_lists = _bfs_degree_lists(
            row_ptr, col_idx, deg, V, max_layers, opt1=opt1
        )

    chunk = 2_000_000
    # per-layer edge pieces, built as each chunk finishes so the f64
    # [chunk, ml] distance buffer is FREED before the next chunk runs
    # — retained peak is the per-layer OUTPUT (u/v i64 + w f32 per
    # surviving pair-layer), not O(n_pairs*ml*8)
    pieces = {}  # k -> list of (u, v, w_f32)
    n_layers_used = 0
    for lo in range(0, n_pairs, chunk):
        hi = min(lo + chunk, n_pairs)
        pu_c, pv_c = pu[lo:hi], pv[lo:hi]
        if native_fn is not None:
            try:
                dist_c, nlay_c = native_fn(
                    row_ptr, col_idx, pu_c, pv_c, ml, workers=workers,
                    dtw_mode=dtw_mode, early_stop=dtw_early_stop,
                )
            except Exception:
                native_fn = None  # degrade loudly, then fall back
                _warn_slow()
                degree_lists = _bfs_degree_lists(
                    row_ptr, col_idx, deg, V, max_layers, opt1=opt1
                )
        if native_fn is None:
            m = hi - lo
            dist_c = np.zeros((m, ml), dtype=np.float64)
            nlay_c = np.zeros(m, dtype=np.int64)
            for i in range(m):
                lu = degree_lists[pu_c[i]]
                lv = degree_lists[pv_c[i]]
                common = min(len(lu), len(lv), ml)
                acc = 0.0
                used = 0
                for k in range(common):
                    if dtw_early_stop and acc >= dtw_early_stop:
                        break
                    if dtw_mode == "fastdtw" and opt1:
                        acc += _fastdtw(lu[k], lv[k])
                    else:
                        acc += _dtw(lu[k], lv[k], opt1=opt1)
                    dist_c[i, k] = acc
                    used = k + 1
                common = used
                nlay_c[i] = common
        k_max = int(nlay_c.max()) if hi > lo else 0
        n_layers_used = max(n_layers_used, k_max)
        for k in range(k_max):
            sel = nlay_c > k
            pieces.setdefault(k, []).append(
                (pu_c[sel], pv_c[sel],
                 np.exp(-dist_c[sel, k]).astype(np.float32))
            )
        del dist_c, nlay_c  # free the chunk buffer before the next

    layer_edges = []
    for k in range(n_layers_used):
        us, vs, ws = zip(*pieces.pop(k))
        layer_edges.append(
            (np.concatenate(us), np.concatenate(vs),
             np.concatenate(ws))
        )
    return layer_edges, n_layers_used


def build_layer_csr(layer_edges, num_nodes):
    """Stack per-layer CSRs + alias tables + gamma into padded arrays.

    `layer_edges[k]` is an (u, v, w) array triple (u < v, one entry per
    undirected edge) as returned by `build_context_graph`; legacy
    `(u, v) -> w` dicts are accepted too. Per-layer assembly is
    vectorized (lexsort CSR + bincount gamma) with the per-row alias
    build in `ops.alias.build_row_alias` (C++ when available) — the
    per-vertex Python loops would be a second ~10^5-node wall.

    Returns dict of numpy arrays:
      row_ptr [K, V+1] i32 ; col/accept/alias [K, E_max] ; gamma [K, V] f32
    """
    from graphembedding.ops.alias import build_row_alias

    K = len(layer_edges)
    V = num_nodes
    row_ptrs, cols, accepts, aliases, gammas = [], [], [], [], []
    e_max = 1
    for k in range(K):
        item = layer_edges[k]
        if isinstance(item, dict):
            n = len(item)
            eu = np.fromiter((p[0] for p in item), np.int64, n)
            ev = np.fromiter((p[1] for p in item), np.int64, n)
            ew = np.fromiter(item.values(), np.float64, n)
        else:
            eu, ev, ew = item
            eu = np.asarray(eu, dtype=np.int64)
            ev = np.asarray(ev, dtype=np.int64)
            ew = np.asarray(ew, dtype=np.float64)
        # symmetrize and sort into CSR (neighbors sorted per row)
        U = np.concatenate([eu, ev])
        C = np.concatenate([ev, eu])
        W = np.concatenate([ew, ew])
        order = np.lexsort((C, U))
        U, C, W = U[order], C[order], W[order]
        deg = np.bincount(U, minlength=V)
        rp = np.zeros(V + 1, dtype=np.int32)
        np.cumsum(deg, out=rp[1:])
        avg = float(W.mean()) if W.size else 0.0
        gamma = np.bincount(
            U[W > avg], minlength=V
        ).astype(np.float32)
        acc, ali = build_row_alias(rp.astype(np.int64), W)
        row_ptrs.append(rp)
        cols.append(C.astype(np.int32))
        accepts.append(acc.astype(np.float32))
        aliases.append(ali.astype(np.int32))
        gammas.append(gamma)
        e_max = max(e_max, C.shape[0])

    col_p = np.zeros((K, e_max), dtype=np.int32)
    acc_p = np.ones((K, e_max), dtype=np.float32)
    ali_p = np.zeros((K, e_max), dtype=np.int32)
    for k in range(K):
        n = cols[k].shape[0]
        col_p[k, :n] = cols[k]
        acc_p[k, :n] = accepts[k]
        ali_p[k, :n] = aliases[k]
    return {
        "row_ptr": np.stack(row_ptrs),
        "col_idx": col_p,
        "accept": acc_p,
        "alias": ali_p,
        "gamma": np.stack(gammas),
    }


# --------------------------------------------------------------------------- #
# device multilayer walk
# --------------------------------------------------------------------------- #


@partial(jax.jit, static_argnames=("length", "max_moves"))
def multilayer_walks(
    row_ptr, col_idx, accept, alias, gamma, starts, key, stay_prob,
    *, length, max_moves=16
):
    """Biased multilayer walks (reference `BiasedWalker._exec_random_walk`).

    State per walker: (vertex, layer). Per emitted token, an inner bounded
    loop: with prob `stay_prob` take a neighbor step in the current layer
    (via that layer's alias table) and emit; otherwise move up a layer with
    prob log(gamma+e)/(log(gamma+e)+1) (if the vertex exists there) or down
    (if above layer 0) and retry, up to `max_moves` times, after which a
    neighbor step is forced.
    """
    K, Vp1 = row_ptr.shape
    e_cols = col_idx.shape[1]

    def flat_rp(layer, v):
        return row_ptr.reshape(-1)[layer * Vp1 + v]

    def deg_at(layer, v):
        return flat_rp(layer, v + 1) - flat_rp(layer, v)

    def neighbor_step(layer, v, k):
        d = deg_at(layer, v)
        off = flat_rp(layer, v)
        k1, k2 = jax.random.split(k)
        u1 = jax.random.uniform(k1, v.shape)
        u2 = jax.random.uniform(k2, v.shape)
        pick = jnp.minimum(
            (u1 * d.astype(jnp.float32)).astype(jnp.int32),
            jnp.maximum(d - 1, 0),
        )
        flat = layer * e_cols + off + pick
        take = u2 < accept.reshape(-1)[flat]
        slot = jnp.where(take, pick, alias.reshape(-1)[flat])
        nxt = col_idx.reshape(-1)[layer * e_cols + off + slot]
        return jnp.where(d > 0, nxt, v)

    def emit_one(carry, k):
        v, layer = carry

        def move_body(i, state):
            v, layer, stepped, kk = state
            kk, kr, km, kn = jax.random.split(kk, 4)
            r = jax.random.uniform(kr, v.shape)
            do_step = (r < stay_prob) & ~stepped
            v_next = neighbor_step(layer, v, kn)
            v = jnp.where(do_step, v_next, v)
            stepped = stepped | do_step

            # layer move for walkers that did not step
            g = gamma.reshape(-1)[layer * (Vp1 - 1) + v]
            x = jnp.log(g + jnp.e)
            p_up = x / (x + 1.0)
            r2 = jax.random.uniform(km, v.shape)
            # clamped probe: keep the flat index in bounds at layer+1==K
            # (masked by layer+1 < K, but don't rely on gather clamping)
            up_probe = deg_at(jnp.minimum(layer + 1, K - 1), v)
            can_up = (layer + 1 < K) & (up_probe > 0)
            go_up = (r2 <= p_up) & can_up
            go_down = (r2 > p_up) & (layer > 0)
            moving = ~stepped & ~do_step
            layer = jnp.where(
                moving & go_up,
                layer + 1,
                jnp.where(moving & go_down, layer - 1, layer),
            )
            return v, layer, stepped, kk

        stepped0 = jnp.zeros_like(v, dtype=bool)
        v, layer, stepped, kk = jax.lax.fori_loop(
            0, max_moves, move_body, (v, layer, stepped0, k)
        )
        # force a step if the bounded loop never stepped
        k_force = jax.random.fold_in(k, 999)
        v_forced = neighbor_step(layer, v, k_force)
        v = jnp.where(stepped, v, v_forced)
        return (v, layer), v

    layer0 = jnp.zeros_like(starts)
    keys = jax.random.split(key, length - 1)
    (_, _), trail = jax.lax.scan(emit_one, (starts, layer0), keys)
    return jnp.concatenate(
        [starts[:, None], jnp.moveaxis(trail, 0, 1)], axis=1
    )


# --------------------------------------------------------------------------- #
# model
# --------------------------------------------------------------------------- #


class Struc2Vec(WalkEmbeddingModel):
    def __init__(
        self,
        graph,
        walk_length=10,
        num_walks=100,
        workers=1,
        verbose=0,
        stay_prob=0.3,
        opt1_reduce_len=True,
        opt2_reduce_sim_calc=True,
        opt3_num_layers=None,
        temp_path="./temp_struc2vec/",
        reuse=False,
        seed=0,
        mesh=None,
        dtw_mode="fastdtw",
        dtw_early_stop=35.0,
    ):
        # opt3_num_layers: the reference's layer cap — ALSO the scale
        # lever: deep BFS rings of a small-world graph contain most
        # vertices, so their DTW dominates (at 100k nodes the full
        # depth bound, 9, costs ~90x the host time of 3 layers).
        # Default None = full depth (reference parity); pass 3-5 for
        # graphs past ~10^4 nodes.
        del verbose
        super().__init__(graph, walk_length, num_walks, seed)
        self.stay_prob = stay_prob
        self.mesh = mesh

        cache_file = None
        if temp_path:
            os.makedirs(temp_path, exist_ok=True)
            h = hashlib.sha1()
            h.update(self.graph.row_ptr.tobytes())
            h.update(self.graph.col_idx.tobytes())
            h.update(
                f"{opt1_reduce_len}-{opt2_reduce_sim_calc}-"
                f"{opt3_num_layers}-{dtw_mode}-{dtw_early_stop}".encode()
            )
            cache_file = os.path.join(
                temp_path, f"context_{h.hexdigest()[:16]}.pkl"
            )

        if reuse and cache_file and os.path.exists(cache_file):
            with open(cache_file, "rb") as f:
                layers = pickle.load(f)
        else:
            layer_edges, _ = build_context_graph(
                self.graph,
                max_layers=opt3_num_layers,
                opt1=opt1_reduce_len,
                opt2=opt2_reduce_sim_calc,
                workers=workers,
                dtw_mode=dtw_mode,
                dtw_early_stop=dtw_early_stop,
            )
            layers = build_layer_csr(layer_edges, self.graph.num_nodes)
            if cache_file:
                with open(cache_file, "wb") as f:
                    pickle.dump(layers, f)

        self._layers = {k: jnp.asarray(v) for k, v in layers.items()}
        if mesh is not None:
            # sharded multilayer walks: layer CSRs vertex-partitioned,
            # in-layer hops routed (parallel.walks); the walk corpus
            # for context graphs beyond one card's memory is generated
            # here, then train(mesh=...) shards training too
            from graphembedding.parallel.walks import (
                DistributedWalker,
            )

            walker = DistributedWalker(
                None, mesh, walk_length, kind="multilayer",
                num_walks=num_walks, stay_prob=stay_prob,
                layers=layers, num_nodes=self.graph.num_nodes,
            )
            self.walks, self.walk_overflow = walker.run(
                jax.random.PRNGKey(seed)
            )
        else:
            starts = jnp.tile(
                jnp.arange(self.graph.num_nodes, dtype=jnp.int32),
                num_walks,
            )
            self.walks = multilayer_walks(
                self._layers["row_ptr"],
                self._layers["col_idx"],
                self._layers["accept"],
                self._layers["alias"],
                self._layers["gamma"],
                starts,
                jax.random.PRNGKey(seed),
                jnp.float32(stay_prob),
                length=walk_length,
            )

    # hs='auto' routes to sampled SGNS above this node count: the hs
    # trainer is tree-depth-bound, an order of magnitude slower than
    # SGNS at V=1M; below it hs=1 keeps reference parity and its
    # measured quality edge at reference scale. Set before any H100
    # measurement.
    HS_AUTO_MAX_NODES = 200_000

    def train(self, embed_size=128, window_size=5, workers=None, iter=5,
              hs="auto", **kwargs):
        """hs='auto' (default): hierarchical softmax — the reference's
        `Word2Vec(sg=1, hs=1)` objective — up to `HS_AUTO_MAX_NODES`
        nodes, sampled SGNS above (the hs tree walk costs an order of
        magnitude more at V=1M). Explicit hs=1/hs=0 always wins.

        Why hs at reference scale: on flight-brazil, hs=1 scores
        micro-F1 0.93 (3-seed mean) vs ~0.70 for SAMPLED SGNS. Round 3
        found the gap is sampling noise, not the objective —
        `train(hs=0, trainer='dense')` (closed-form EXPECTED SGNS,
        train/dense.py) matches hs=1 exactly (0.9259 3-seed mean) and
        is faster; hs stays the small-V default for reference parity."""
        if hs == "auto":
            hs = 1 if self.graph.num_nodes <= self.HS_AUTO_MAX_NODES else 0
        return self._fit_skipgram(
            embed_size=embed_size,
            window_size=window_size,
            workers=workers,
            iter=iter,
            hs=hs,
            **kwargs,
        )
