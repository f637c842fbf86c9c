"""Edge-partitioned distributed random walks (multi-host scaling path).

BASELINE north star: "graph edge-partitioned per host, boundary vertex
[state] exchanged all-to-all over the interconnect and overlapped with
the walk step".
The reference has no analogue (joblib processes over a shared nx graph;
`ge/walker.py — simulate_walks (~L100) [U]`).

Design
------
- Vertices are range-partitioned: shard s owns ids [s·Vp, (s+1)·Vp).
  Each shard holds ONLY the CSR rows (and alias tables / neighbor-matrix
  rows / layer CSRs) of its owned vertices, padded to the max shard size
  so shapes are uniform.
- Invariant: a walker always resides on the shard that owns its current
  vertex, so every next-hop gather is purely local.
- **Hub-safe routing**: after each local step, walker state is exchanged
  with ONE `all_gather` of the [cap, F] int32 state block and each shard
  compacts the walkers destined to it into its `cap` slots with a
  cumsum-rank + 1-D scatter (O(n·cap) work — no [cap, n] one_hot
  materialization, no per-(src,dst) bucket capacities to overflow). A
  walker is lost ONLY if more than `cap = walkers_per_shard · slack`
  walkers genuinely occupy one shard at once — a property of the graph's
  stationary distribution, not of which source shards they came from, so
  power-law hubs no longer overflow-kill walkers (the first bucketed
  all_to_all dropped walkers whenever one source sent more than cap/n to
  one destination). Overflow is still counted and returned. The
  destination shard is derived on the receiver from the vertex id
  (range test), so no dest column crosses the wire.

Routing-cost model and the all_to_all crossover (8-device CPU mesh)
-------------------------------------------------------------------
Per step each shard ingests the full gathered block: O(n·cap) rows of
both WIRE bytes and COMPACTION compute, for ~wl walkers' worth of
useful routing — an n·slack× fan-in overhead that is the engine's
dominant cost once walkers are plentiful (measured on the 8-device CPU
mesh: route ≈ 55-85% of step time; `benchmarks/scaling.py` reports it
as 1 - comm_efficiency). Options, in increasing order of wire
optimality:

* `slack` (default 4) trades receiver hub-tolerance for a linear
  factor of both costs — slack=2 measured ~1.8x faster end-to-end at
  wiki scale with zero overflow (use 4+ for power-law graphs).
* `hop_batch > 0` (DistributedWalker) switches to the locality-batched
  engine below: crossers-only channel (send_cap = wl·send_slack wire
  rows instead of cap) with BACKPRESSURE instead of drops, and up to H
  local hops between exchanges. Rounds are bounded below by the MAX
  per-walk crossing count, which for walk_length=10 on anything but an
  extremely well-partitioned graph is ≈ walk_length (measured: 10
  rounds at L=10 under an RCM ordering of the wiki SBM — the tail
  walker crosses every hop even when the mean crossing rate is low),
  so on the CPU mesh the plain engine WINS at reference walk lengths;
  the batched engine is the right shape for long walks over
  locality-ordered graphs and for real interconnects, where its
  fewer, smaller collectives amortize latency (unmeasured on H100s).
* `distributed_uniform_walks_a2a` is the LARGE-MESH engine:
  crossers-only dense-bucketed tiled all_to_all — per-shard routed
  volume n·(bcap+1) rows is CONSTANT in mesh size (bcap is sized to
  the per-pair crossing peak, a property of the graph, not of n)
  vs the all_gather's n·cap. Measured occupancy at n=8 on the wiki
  SBM: 2,740 real crossing rows/shard/round (33 KB) inside a 16.8k
  row (202 KB) dense frame vs the all_gather's 134k rows (1.08 MB).
  On the CPU mesh the plain engine still wins wall-clock (routing is
  dispatch/sync-bound there — a property of 8 virtual devices on a
  few cores, not of the design); four H100s over NVLink are
  unmeasured (ROADMAP R7).
* `jax.lax.ragged_all_to_all` (zero-padding exact exchange) remains
  UNIMPLEMENTED on XLA:CPU (re-probed every test run,
  tests/test_walks_a2a.py); when a backend supports it the a2a
  engine's buckets are already sorted-by-destination, so the ragged
  form drops in as a frame-compression of the same exchange.
- Each shard records tokens for walkers it hosts into a (walk_id, t)
  buffer; buffers are summed across shards at the end (each cell is
  written by exactly one shard).

Engines sharing the scheme (the all_gather router), plus the
`*_a2a` exact-exchange variants of the uniform/weighted/multilayer
kinds (`exchange='a2a'` on DistributedWalker):
  * first-order (uniform / weighted-alias)   — DeepWalk, weighted walks
  * exact (p,q) second-order                 — Node2Vec. The bias needs
    N(prev), which may live on another shard: prev's padded neighbor row
    is fetched per step with the same all_gather(ids) → owner-contribute
    → psum_scatter halo exchange the row-sharded trainer uses for
    embedding rows (parallel/rowshard.py) — SURVEY §3.3's
    boundary-vertex exchange, applied to adjacency rows.
  * multilayer (struc2vec)                   — K layer CSRs + alias
    tables partitioned by the same vertex ranges; layer moves stay local
    (the vertex doesn't change), only the in-layer hop routes.

For corpora/graphs at the reference's scale the replicated engine in
`ops.walk` is faster (no routing); this engine is the scale-out path and
is validated on the 8-device CPU mesh in tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

_LANE = 128


# --------------------------------------------------------------------------- #
# host-side partitioners
# --------------------------------------------------------------------------- #


def partition_csr(graph, n_shards, edge_arrays=None):
    """Range-partition the CSR by vertex; pad shards to common sizes.

    Returns dict of numpy arrays stacked over shards:
      row_ptr [n, Vp+1] (local offsets), col_idx [n, Emax], degree [n, Vp]
    plus vp (vertices per shard). `edge_arrays` — optional dict
    name -> (array [E], fill) of edge-aligned arrays (alias tables,
    weights) to partition alongside col_idx.
    """
    V = graph.num_nodes
    vp = (V + n_shards - 1) // n_shards
    edge_arrays = edge_arrays or {}
    row_ptrs, degs = [], []
    cols = []
    extra = {name: [] for name in edge_arrays}
    e_max = 1
    for s in range(n_shards):
        lo, hi = min(s * vp, V), min((s + 1) * vp, V)
        rp_global = graph.row_ptr[lo : hi + 1].astype(np.int64)
        if rp_global.size == 0:  # shard owns no vertices (V < n·vp)
            rp_global = graph.row_ptr[-1:].astype(np.int64)
        local_rp = (rp_global - rp_global[0]).astype(np.int32)
        # pad vertex range to vp
        if hi - lo < vp:
            pad = np.full(vp - (hi - lo), local_rp[-1], dtype=np.int32)
            local_rp = np.concatenate([local_rp, pad])
        sl = slice(int(rp_global[0]), int(rp_global[-1]))
        cols.append(graph.col_idx[sl].astype(np.int32))
        for name, (arr, _fill) in edge_arrays.items():
            extra[name].append(np.asarray(arr[sl]))
        row_ptrs.append(local_rp)
        degs.append(np.diff(local_rp).astype(np.int32))
        e_max = max(e_max, cols[-1].shape[0])
    col_p = np.full((n_shards, e_max), -1, dtype=np.int32)
    for s in range(n_shards):
        col_p[s, : cols[s].shape[0]] = cols[s]
    out = {
        "row_ptr": np.stack(row_ptrs),
        "col_idx": col_p,
        "degree": np.stack(degs),
        "vp": vp,
    }
    for name, (arr, fill) in edge_arrays.items():
        buf = np.full((n_shards, e_max), fill, dtype=arr.dtype)
        for s in range(n_shards):
            buf[s, : extra[name][s].shape[0]] = extra[name][s]
        out[name] = buf
    return out


def partition_neighbor_matrix(graph, n_shards):
    """Vertex-range partition of the padded dense neighbor matrix.

    Returns (nbr [n, Vp, Dpad] i32 pad -1, nbr_w [n, Vp, Dpad] f32
    pad 0, degree [n, Vp] i32, vp). Used by the distributed exact (p,q)
    engine: each shard holds only its owned rows, and remote rows are
    fetched through the halo exchange.
    """
    V = graph.num_nodes
    vp = (V + n_shards - 1) // n_shards
    nm = graph.neighbor_matrix
    nbr = np.asarray(nm.nbr)
    nbr_w = np.asarray(nm.nbr_w)
    dpad = nbr.shape[1]
    nbr_p = np.full((n_shards, vp, dpad), -1, dtype=np.int32)
    w_p = np.zeros((n_shards, vp, dpad), dtype=np.float32)
    deg_p = np.zeros((n_shards, vp), dtype=np.int32)
    for s in range(n_shards):
        lo, hi = min(s * vp, V), min((s + 1) * vp, V)
        nbr_p[s, : hi - lo] = nbr[lo:hi]
        w_p[s, : hi - lo] = nbr_w[lo:hi]
        deg_p[s, : hi - lo] = graph.degree[lo:hi]
    return nbr_p, w_p, deg_p, vp, dpad


def partition_layers(layers, num_nodes, n_shards):
    """Vertex-range partition of a struc2vec layer-CSR stack.

    `layers` is the `models.struc2vec.build_layer_csr` dict (numpy or
    jnp): row_ptr [K, V+1], col_idx/accept/alias [K, E], gamma [K, V].
    Returns dict stacked over shards: row_ptr [n, K, Vp+1] (local
    offsets), col_idx/accept/alias [n, K, Emax], gamma [n, K, Vp], vp.
    """
    rp = np.asarray(layers["row_ptr"])
    col = np.asarray(layers["col_idx"])
    acc = np.asarray(layers["accept"])
    ali = np.asarray(layers["alias"])
    gam = np.asarray(layers["gamma"])
    K = rp.shape[0]
    V = num_nodes
    vp = (V + n_shards - 1) // n_shards
    e_max = 1
    parts = []
    for s in range(n_shards):
        lo, hi = min(s * vp, V), min((s + 1) * vp, V)
        rows, cs, accs, alis, gs = [], [], [], [], []
        for k in range(K):
            rg = rp[k, lo : hi + 1].astype(np.int64)
            if rg.size == 0:
                rg = rp[k, -1:].astype(np.int64)
            lrp = (rg - rg[0]).astype(np.int32)
            if hi - lo < vp:
                lrp = np.concatenate(
                    [lrp, np.full(vp - (hi - lo), lrp[-1], np.int32)]
                )
            sl = slice(int(rg[0]), int(rg[-1]))
            rows.append(lrp)
            cs.append(col[k, sl])
            accs.append(acc[k, sl])
            alis.append(ali[k, sl])
            g = np.zeros(vp, np.float32)
            g[: hi - lo] = gam[k, lo:hi]
            gs.append(g)
            e_max = max(e_max, cs[-1].shape[0])
        parts.append((rows, cs, accs, alis, gs))
    out_rp = np.zeros((n_shards, K, vp + 1), np.int32)
    out_c = np.zeros((n_shards, K, e_max), np.int32)
    out_a = np.ones((n_shards, K, e_max), np.float32)
    out_l = np.zeros((n_shards, K, e_max), np.int32)
    out_g = np.zeros((n_shards, K, vp), np.float32)
    for s, (rows, cs, accs, alis, gs) in enumerate(parts):
        for k in range(K):
            out_rp[s, k] = rows[k]
            out_c[s, k, : cs[k].shape[0]] = cs[k]
            out_a[s, k, : accs[k].shape[0]] = accs[k]
            out_l[s, k, : alis[k].shape[0]] = alis[k]
            out_g[s, k] = gs[k]
    return {
        "row_ptr": out_rp,
        "col_idx": out_c,
        "accept": out_a,
        "alias": out_l,
        "gamma": out_g,
        "vp": vp,
    }


# --------------------------------------------------------------------------- #
# in-body collectives (shared by all engines)
# --------------------------------------------------------------------------- #


def _route(fields, lo, vp, cap, n, axis):
    """Hub-safe walker routing: all_gather state + rank-compaction.

    fields: list of [cap] i32 walker-state arrays with the INVARIANT
    that fields[0] is the walker's next vertex (-1 = dead/empty slot)
    — the destination shard is derived ON THE RECEIVER as a range test
    against [lo, lo+vp), so no dest column crosses the wire (25-33%
    fewer routed bytes than an explicit-dest form). Returns
    (new_fields, overflow): each shard's compacted [cap] view of the
    walkers destined to it (-1 filled), and the count of walkers it
    had to drop because more than `cap` landed on it at once.
    """
    F = len(fields)
    send = jnp.stack(fields, axis=1)  # [cap, F]
    allw = jax.lax.all_gather(send, axis).reshape(n * cap, F)
    v = allw[:, 0]
    mine = (v >= lo) & (v < lo + vp)
    rank = jnp.cumsum(mine.astype(jnp.int32)) - 1
    ok = mine & (rank < cap)
    slot = jnp.where(ok, rank, cap)  # cap = trash row
    buf = jnp.full((cap + 1, F), -1, jnp.int32)
    buf = buf.at[slot].set(
        jnp.where(ok[:, None], allw, -1), mode="drop"
    )
    overflow = jnp.sum(mine) - jnp.sum(ok)
    return [buf[:cap, i] for i in range(F)], overflow


def _fetch_rows_i32(local_rows, ids, lo, vp, axis):
    """Halo fetch of int32 rows from their owner shards.

    local_rows [Vp, W]: this shard's row slice; ids [cap]: global row
    ids needed by this shard (-1 → zeros row). Same all_gather(ids) →
    owner-contribute → psum_scatter exchange as
    parallel/rowshard.fetch_rows, for adjacency rows instead of
    embedding rows. Returns [cap, W] i32.
    """
    ids_all = jax.lax.all_gather(ids, axis)  # [n, cap]
    local = ids_all - lo
    owned = (local >= 0) & (local < vp)
    rows = jnp.where(
        owned[..., None],
        local_rows[jnp.clip(local, 0, vp - 1)],
        0,
    )  # [n, cap, W]
    return jax.lax.psum_scatter(
        rows, axis, scatter_dimension=0, tiled=True
    )[0]


def _record(out, cur, wid, t):
    alive = wid >= 0
    safe_wid = jnp.where(alive, wid, 0)
    add = jnp.where(alive, cur + 1, 0)
    return out.at[safe_wid, t].add(add)


def locality_order(graph):
    """Locality-preserving vertex permutation (reverse Cuthill-McKee).

    Returns `perm` with perm[new_id] = old_id. Relabeling a graph by
    this order makes neighbors land near each other in id space, so a
    range partition keeps most hops shard-local — the lever behind the
    hop-batched engine (fewer routing rounds) and behind dense-window
    table updates at large V. O(E) via scipy's C implementation.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    V = graph.num_nodes
    A = sp.csr_matrix(
        (np.ones(graph.col_idx.shape[0], np.int8), graph.col_idx,
         graph.row_ptr), shape=(V, V),
    )
    A = A + A.T  # RCM wants symmetric structure
    return np.asarray(reverse_cuthill_mckee(A), dtype=np.int64)


def relabel_graph(graph, perm):
    """Relabeled copy of `graph` under perm (perm[new_id] = old_id)."""
    from graphembedding.graph import Graph

    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    src, dst, w = graph.edges()
    return Graph(inv[src], inv[dst], w, num_nodes=graph.num_nodes,
                 directed=True)


# --------------------------------------------------------------------------- #
# engines
# --------------------------------------------------------------------------- #


def _make_first_order(mesh, *, length, vp, n_walkers, slack, weighted,
                      route_off=False):
    """First-order walk engine: uniform or weighted-alias next hops.

    Returns fn(row_ptr [n,Vp+1], col_idx [n,E], degree [n,Vp],
    [accept [n,E], alias [n,E] when weighted,] starts [n,wl], key)
    -> (walks [n_walkers, length], overflow).

    `route_off=True` is a SEMANTICS-FREE timing control for the
    scaling harness: the cross-shard exchange is skipped and walkers
    are clamped onto their current shard, so the produced walks are
    wrong but the per-step compute/shape structure is identical —
    t_control/t_full isolates the routing cost.
    """
    n = mesh.shape["data"]
    wl = n_walkers // n
    cap = wl * slack

    def core(row_ptr, col_idx, degree, accept, alias, starts, key):
        me = jax.lax.axis_index("data")
        lo = me * vp
        cur = jnp.full((cap,), -1, jnp.int32)
        wid = jnp.full((cap,), -1, jnp.int32)
        cur = cur.at[:wl].set(starts.reshape(-1))
        wid = wid.at[:wl].set(me * wl + jnp.arange(wl, dtype=jnp.int32))
        # filler starts (-1) are empty slots
        wid = jnp.where(cur >= 0, wid, -1)

        out = jnp.zeros((n_walkers, length), jnp.int32)
        out = _record(out, cur, wid, 0)

        def step(carry, xs):
            cur, wid, out = carry
            t, k = xs
            alive = wid >= 0
            lv = jnp.where(alive, cur - lo, 0)
            deg = jnp.where(alive, degree[lv], 0)
            kk = jax.random.fold_in(k, me)
            u1 = jax.random.uniform(kk, (cap,))
            if weighted:
                from graphembedding.ops.alias import alias_draw

                u2 = jax.random.uniform(
                    jax.random.fold_in(kk, 1), (cap,)
                )
                pick = alias_draw(
                    accept, alias, row_ptr[lv], jnp.maximum(deg, 1),
                    u1, u2,
                )
            else:
                pick = jnp.minimum(
                    (u1 * deg.astype(jnp.float32)).astype(jnp.int32),
                    jnp.maximum(deg - 1, 0),
                )
            nxt = col_idx[row_ptr[lv] + pick]
            nxt = jnp.where(alive & (deg > 0), nxt, -1)
            wid = jnp.where(nxt >= 0, wid, -1)
            if route_off:  # timing control — see docstring
                cur = jnp.where(
                    wid >= 0, jnp.clip(nxt - lo, 0, vp - 1) + lo, -1
                )
                overflow = jnp.int32(0)
            else:
                (cur, wid), overflow = _route(
                    [nxt, wid], lo, vp, cap, n, "data"
                )
            out = _record(out, cur, wid, t)
            return (cur, wid, out), overflow

        keys = jax.random.split(key, length - 1)
        ts = jnp.arange(1, length, dtype=jnp.int32)
        (cur, wid, out), overflows = jax.lax.scan(
            step, (cur, wid, out), (ts, keys)
        )
        out = jax.lax.psum(out, "data")
        return out - 1, jax.lax.psum(overflows.sum(), "data")

    if weighted:
        def body(row_ptr, col_idx, degree, accept, alias, starts, key):
            return core(row_ptr[0], col_idx[0], degree[0], accept[0],
                        alias[0], starts, key)

        in_specs = (P("data"),) * 5 + (P("data"), P())
    else:
        def body(row_ptr, col_idx, degree, starts, key):
            return core(row_ptr[0], col_idx[0], degree[0], None, None,
                        starts, key)

        in_specs = (P("data"),) * 3 + (P("data"), P())

    fn = shard_map(
        body, mesh=mesh, in_specs=in_specs, out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def distributed_uniform_walks(mesh, *, length, vp, n_walkers, slack=4,
                              route_off=False):
    """Uniform-next-hop distributed walks (original API, hub-safe core).

    Returns fn(row_ptr, col_idx, degree, starts, key) ->
    (walks [n_walkers, length], overflow).
    """
    return _make_first_order(
        mesh, length=length, vp=vp, n_walkers=n_walkers, slack=slack,
        weighted=False, route_off=route_off,
    )


def distributed_weighted_walks(mesh, *, length, vp, n_walkers, slack=4):
    """Weighted first-order walks via partitioned per-node alias tables.

    Reference counterpart: the weighted branch of
    `ge/walker.py — node2vec_walk with p=q=1 [U]`. Returns
    fn(row_ptr, col_idx, degree, accept, alias, starts, key).
    """
    return _make_first_order(
        mesh, length=length, vp=vp, n_walkers=n_walkers, slack=slack,
        weighted=True,
    )


def distributed_uniform_walks_batched(
    mesh, *, length, vp, n_walkers, slack=4, hop_batch=4,
    send_slack=1.0, route_off=False,
):
    """Locality-batched uniform walks: route only actual shard crossers.

    The plain engine exchanges the FULL [cap, F] walker state every hop
    (`_route`), so the per-step collective moves n*cap rows even though
    only the walkers whose next vertex lives on another shard need to
    cross. This engine instead:

    - lets each walker take up to `hop_batch` LOCAL hops per round
      (vertices inside its shard's range advance with zero
      communication — with a locality-preserving vertex order
      (`locality_order`) most hops are local);
    - rank-compacts the walkers that DID cross into a
      [send_cap = wl*send_slack] send buffer, all_gathers only that
      (n*send_cap rows vs n*cap — send_slack=1 vs slack=4 is 4x fewer
      bytes before counting the hop batching);
    - rounds run under `lax.while_loop` with a psum'd "anyone alive"
      predicate, so the number of COLLECTIVE rounds per corpus is
      ~crossings+1, not walk_length.

    Token bookkeeping: each walker carries its own position t; local
    hops record immediately, crossers are recorded by the receiving
    shard on arrival. Walk distribution is identical to the plain
    engine (same per-hop draw). Hub safety is by BACKPRESSURE, not
    slack: crossers beyond send_cap in a round are never dropped —
    they hold their slot and retry next round (the while_loop just
    runs more rounds during a surge), so the only loss mode is the
    plain engine's receiver-capacity rule (arrivals beyond cap hosted
    walkers, counted in `overflow`).

    Reference counterpart: `ge/walker.py — simulate_walks (~L100) [U]`,
    scaled; SURVEY §8.4-6's "overlap the exchange" goal is met here by
    *eliding* exchanges rather than hiding them.
    """
    n = mesh.shape["data"]
    wl = n_walkers // n
    cap = wl * slack
    send_cap = max(int(wl * send_slack), 1)
    H = hop_batch

    def body(row_ptr, col_idx, degree, starts, key):
        row_ptr = row_ptr[0]
        col_idx = col_idx[0]
        degree = degree[0]
        me = jax.lax.axis_index("data")
        lo = me * vp

        cur = jnp.full((cap,), -1, jnp.int32)
        wid = jnp.full((cap,), -1, jnp.int32)
        cur = cur.at[:wl].set(starts.reshape(-1))
        wid = wid.at[:wl].set(me * wl + jnp.arange(wl, dtype=jnp.int32))
        wid = jnp.where(cur >= 0, wid, -1)
        t = jnp.where(wid >= 0, 1, length).astype(jnp.int32)

        out = jnp.zeros((n_walkers, length), jnp.int32)
        out = _record(out, cur, wid, 0)

        def round_body(state):
            cur, wid, t, pend, out, key, ov, _gl, r = state
            key, kr = jax.random.split(key)
            kr = jax.random.fold_in(kr, me)

            def hop(h, st):
                cur, wid, t, pend, out = st
                k = jax.random.fold_in(kr, h)
                active = (wid >= 0) & (pend < 0) & (t < length)
                lv = jnp.where(active, cur - lo, 0)
                deg = jnp.where(active, degree[lv], 0)
                u1 = jax.random.uniform(k, (cap,))
                pick = jnp.minimum(
                    (u1 * deg.astype(jnp.float32)).astype(jnp.int32),
                    jnp.maximum(deg - 1, 0),
                )
                nxt = col_idx[row_ptr[lv] + pick]
                # dead end: die now
                wid = jnp.where(active & (deg == 0), -1, wid)
                nxt_ok = active & (deg > 0)
                if route_off:
                    # timing control (semantics-free, harness only):
                    # clamp crossers onto this shard so the exchange
                    # below never sees them
                    nxt = jnp.where(
                        nxt_ok, jnp.clip(nxt, lo, lo + vp - 1), nxt
                    )
                local = nxt_ok & (nxt >= lo) & (nxt < lo + vp)
                cur = jnp.where(local, nxt, cur)
                safe_w = jnp.where(local, wid, 0)
                safe_t = jnp.where(local, jnp.minimum(t, length - 1), 0)
                out = out.at[safe_w, safe_t].add(
                    jnp.where(local, cur + 1, 0)
                )
                t = jnp.where(local, t + 1, t)
                wid = jnp.where(t >= length, -1, wid)  # finished
                pend = jnp.where(nxt_ok & ~local, nxt, pend)
                return cur, wid, t, pend, out

            cur, wid, t, pend, out = jax.lax.fori_loop(
                0, H, hop, (cur, wid, t, pend, out)
            )

            # live count BEFORE extracting sends, so in-flight walkers
            # keep the loop alive (a stale overcount costs at most one
            # cheap extra round; an undercount would truncate walks)
            live_here = jnp.sum((wid >= 0).astype(jnp.int32))

            # compact crossers into the send buffer; walkers beyond
            # send_cap HOLD their slot and retry next round
            # (backpressure — no send-side drops, ever)
            is_pend = (wid >= 0) & (pend >= 0)
            rank = jnp.cumsum(is_pend.astype(jnp.int32)) - 1
            ok_send = is_pend & (rank < send_cap)
            slot = jnp.where(ok_send, rank, send_cap)
            sbuf = jnp.full((send_cap + 1, 3), -1, jnp.int32)
            payload = jnp.stack([pend, wid, t], axis=1)
            sbuf = sbuf.at[slot].set(
                jnp.where(ok_send[:, None], payload, -1), mode="drop"
            )
            # sent walkers leave this shard; held ones keep pend set
            wid = jnp.where(ok_send, -1, wid)
            pend = jnp.where(ok_send, -1, pend)

            # the send buffer's trailing row carries this shard's live
            # count, so the loop predicate needs no extra collective
            sbuf = sbuf.at[send_cap, 0].set(live_here)
            allw = jax.lax.all_gather(sbuf, "data")  # [n, send_cap+1, 3]
            global_live = jnp.sum(allw[:, send_cap, 0])
            allw = allw[:, :send_cap].reshape(n * send_cap, 3)
            v_a, w_a, t_a = allw[:, 0], allw[:, 1], allw[:, 2]
            mine = (v_a >= lo) & (v_a < lo + vp)
            arr_rank = jnp.cumsum(mine.astype(jnp.int32)) - 1
            free = wid < 0
            n_free = jnp.sum(free.astype(jnp.int32))
            ok_arr = mine & (arr_rank < n_free)
            ov = ov + jnp.sum(mine) - jnp.sum(ok_arr)
            # index of the k-th free slot by scatter (no sort): free
            # slot j with free-rank k writes j into fidx[k]
            free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1
            fidx = jnp.full((cap + 1,), cap, jnp.int32)
            fidx = fidx.at[jnp.where(free, free_rank, cap)].set(
                jnp.arange(cap, dtype=jnp.int32), mode="drop"
            )
            dslot = jnp.where(
                ok_arr, fidx[jnp.clip(arr_rank, 0, cap - 1)], cap
            )
            cur = cur.at[dslot].set(jnp.where(ok_arr, v_a, -1),
                                    mode="drop")
            wid = wid.at[dslot].set(jnp.where(ok_arr, w_a, -1),
                                    mode="drop")
            t = t.at[dslot].set(
                jnp.where(ok_arr, t_a + 1, length), mode="drop"
            )
            pend = pend.at[dslot].set(-1, mode="drop")
            # the receiving shard records the crossing hop's token
            safe_w = jnp.where(ok_arr, w_a, 0)
            safe_t = jnp.where(ok_arr, jnp.clip(t_a, 0, length - 1), 0)
            out = out.at[safe_w, safe_t].add(
                jnp.where(ok_arr, v_a + 1, 0)
            )
            # arrivals that just finished die in place
            wid = jnp.where(t >= length, -1, wid)
            return cur, wid, t, pend, out, key, ov, global_live, r + 1

        def cond(state):
            return state[7] > 0

        pend0 = jnp.full((cap,), -1, jnp.int32)
        live0 = jax.lax.psum(
            jnp.sum((wid >= 0).astype(jnp.int32)), "data"
        )
        state = (cur, wid, t, pend0, out, key, jnp.int32(0), live0,
                 jnp.int32(0))
        cur, wid, t, _p, out, key, ov, _gl, rounds = jax.lax.while_loop(
            cond, round_body, state
        )
        out = jax.lax.psum(out, "data")
        return out - 1, jax.lax.psum(ov, "data"), rounds

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P("data"),) * 3 + (P("data"), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def bucket_by_dest(v, w, t, vp, n, bcap, send_cap=None,
                   method="auto"):
    """Compact crossing walkers into per-destination-shard buckets.

    Pure routing math of the crossers-only exact-exchange engine
    (`distributed_uniform_walks_a2a`), kept collective-free so it is
    unit-testable on any backend.

    v, w, t: [cap] i32 walker state; a CROSSER is an entry with
    w >= 0 and v >= 0 (v = the next vertex, known to live on another
    shard — the caller only passes pending crossers here, non-crossers
    hold v = -1). Destination shard is v // vp (range partition).

    Returns (sbuf [n*bcap, 3], sent [cap] bool): sbuf rows
    [d*bcap : (d+1)*bcap] are the crossers destined to shard d
    (-1-padded), ready for a tiled `all_to_all`; `sent` marks walkers
    that got a slot. Crossers beyond `bcap` for their destination —
    or beyond `send_cap` in total — are NOT dropped: `sent` stays
    False and the caller holds them for the next round (backpressure,
    same rule as the batched engine).

    Two implementations, selected by `method` (the engine passes
    'auto' = 'cumsum' for n <= 32, 'sort' above):

    - 'cumsum': one [n, cap] masked-cumsum pass — O(n*cap) work but
      every op is a vectorized scan (measured 3.5x faster than the
      sort at n=8 on XLA:CPU, where a [8.4k] argsort alone costs
      1.8 ms — a third of the whole routing round).
    - 'sort': O(cap) compaction cumsum, then a stable sort of only
      [send_cap] candidate rows + segment ranking + scatters — work
      independent of n, the large-mesh form.
    """
    cap = v.shape[0]
    smax = cap if send_cap is None else min(send_cap, cap)
    if method == "auto":
        method = "cumsum" if n <= 32 else "sort"
    is_x = (w >= 0) & (v >= 0)
    payload3 = jnp.stack([v, w, t], axis=1)
    if method == "cumsum":
        dest = jnp.where(is_x, v // vp, n)
        xr = jnp.cumsum(is_x.astype(jnp.int32)) - 1
        under = is_x & (xr < smax)
        m = under[None, :] & (
            dest[None, :] == jnp.arange(n, dtype=jnp.int32)[:, None]
        )  # [n, cap]
        r = jnp.cumsum(m.astype(jnp.int32), axis=1) - 1
        okm = m & (r < bcap)
        slot_m = jnp.arange(n, dtype=jnp.int32)[:, None] * bcap + r
        sent = jnp.any(okm, axis=0)
        slot = jnp.where(
            sent, jnp.sum(jnp.where(okm, slot_m, 0), axis=0),
            n * bcap,
        )
        flat = jnp.full((n * bcap + 1, 3), -1, jnp.int32)
        flat = flat.at[slot].set(
            jnp.where(sent[:, None], payload3, -1), mode="drop"
        )
        return flat[: n * bcap], sent
    # method == 'sort': compact crossers into [smax] candidate rows
    # (cheap cumsum; the sort then runs on smax ≪ cap rows)
    xr = jnp.cumsum(is_x.astype(jnp.int32)) - 1
    ok_c = is_x & (xr < smax)
    cslot = jnp.where(ok_c, xr, smax)
    cand = jnp.full((smax + 1, 4), -1, jnp.int32)
    idx0 = jnp.arange(cap, dtype=jnp.int32)
    payload0 = jnp.concatenate([payload3, idx0[:, None]], axis=1)
    cand = cand.at[cslot].set(
        jnp.where(ok_c[:, None], payload0, -1), mode="drop"
    )
    cand = cand[:smax]
    dest = jnp.where(cand[:, 1] >= 0, cand[:, 0] // vp, n)
    order = jnp.argsort(dest)  # stable by default
    dsorted = dest[order]
    idx = jnp.arange(smax, dtype=jnp.int32)
    # rank within destination segment: position - segment start
    change = jnp.concatenate(
        [jnp.ones((1,), bool), dsorted[1:] != dsorted[:-1]]
    )
    seg_start = jax.lax.cummax(jnp.where(change, idx, 0))
    rank = idx - seg_start
    ok = (dsorted < n) & (rank < bcap)
    slot = jnp.where(ok, dsorted * bcap + rank, n * bcap)
    payload = cand[order]
    flat = jnp.full((n * bcap + 1, 3), -1, jnp.int32)
    flat = flat.at[slot].set(
        jnp.where(ok[:, None], payload[:, :3], -1), mode="drop"
    )
    sent = jnp.zeros((cap + 1,), bool).at[
        jnp.where(ok, payload[:, 3], cap)
    ].set(ok, mode="drop")
    return flat[: n * bcap], sent[:cap]


def place_arrivals(cur, wid, t, pend, out, arrivals, length,
                   extra=None, extra_arrivals=None):
    """Place exchanged walkers into this shard's free slots.

    Pure receiver half of the exact-exchange round (unit-testable —
    no collectives). `arrivals` [m, 3] rows are (vertex, walk_id,
    t_of_crossing-hop) with -1 padding; every arrival row already
    belongs to this shard (the all_to_all delivered only our bucket).
    Arrivals beyond the free-slot count are dropped and counted
    (receiver-capacity rule, identical to `_route`). The receiving
    shard records the crossing hop's token.

    `extra`/`extra_arrivals` optionally scatter one more per-walker
    i32 state column (the multilayer engine's `layer`) into the same
    slots. Returns (cur, wid, t, pend, out, overflow) — plus the
    updated `extra` appended when given.
    """
    cap = cur.shape[0]
    v_a, w_a, t_a = arrivals[:, 0], arrivals[:, 1], arrivals[:, 2]
    mine = w_a >= 0
    arr_rank = jnp.cumsum(mine.astype(jnp.int32)) - 1
    free = wid < 0
    n_free = jnp.sum(free.astype(jnp.int32))
    ok_arr = mine & (arr_rank < n_free)
    overflow = jnp.sum(mine) - jnp.sum(ok_arr)
    # index of the k-th free slot by scatter (no sort)
    free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1
    fidx = jnp.full((cap + 1,), cap, jnp.int32)
    fidx = fidx.at[jnp.where(free, free_rank, cap)].set(
        jnp.arange(cap, dtype=jnp.int32), mode="drop"
    )
    dslot = jnp.where(
        ok_arr, fidx[jnp.clip(arr_rank, 0, cap - 1)], cap
    )
    cur = cur.at[dslot].set(jnp.where(ok_arr, v_a, -1), mode="drop")
    wid = wid.at[dslot].set(jnp.where(ok_arr, w_a, -1), mode="drop")
    t = t.at[dslot].set(
        jnp.where(ok_arr, t_a + 1, length), mode="drop"
    )
    pend = pend.at[dslot].set(-1, mode="drop")
    safe_w = jnp.where(ok_arr, w_a, 0)
    safe_t = jnp.where(ok_arr, jnp.clip(t_a, 0, length - 1), 0)
    out = out.at[safe_w, safe_t].add(jnp.where(ok_arr, v_a + 1, 0))
    wid = jnp.where(t >= length, -1, wid)  # arrivals that finished
    if extra is not None:
        extra = extra.at[dslot].set(
            jnp.where(ok_arr, extra_arrivals, 0), mode="drop"
        )
        return cur, wid, t, pend, out, overflow, extra
    return cur, wid, t, pend, out, overflow


def distributed_uniform_walks_a2a(
    mesh, *, length, vp, n_walkers, slack=4, hop_batch=1,
    bucket_cap=None, route_off=False, weighted=False,
):
    """Crossers-only exact-exchange uniform walks (large-mesh engine).

    The plain engine's `_route` all_gathers the FULL [cap, F] state
    block, so every shard ingests n*cap rows per hop — wire bytes and
    compaction compute both grow LINEARLY with the mesh, which is why
    its comm_efficiency measured on the CPU mesh collapses with n
    (0.19 at 8 CPU devices). This engine exchanges
    ONLY the walkers that actually cross a shard boundary, through a
    dense-bucketed tiled `all_to_all`:

    - each shard compacts its crossers into per-destination buckets of
      `bcap` rows (`bucket_by_dest` — sort + segment rank, O(cap log
      cap) sender work independent of n);
    - one `all_to_all` moves bucket d to shard d: each shard sends AND
      receives exactly n*(bcap+1) rows. With the default
      bcap = max(ceil(4*wl/n), 64), that is ~4*wl rows per shard per
      round — CONSTANT in n (vs the all_gather's n*slack*wl), the
      property that makes the exchange scale: adding shards adds
      wire links without adding per-shard routed volume. The 4x
      headroom over the mean per-pair load wl*cross_rate/n absorbs
      destination skew; per-pair traffic beyond bcap costs
      BACKPRESSURE retry rounds, never drops — graphs whose crossers
      concentrate on few destinations (e.g. strongly locality-ordered
      rings) should raise `bucket_cap` toward wl/2 per pair, trading
      wire for rounds (measured on the wiki SBM at n=8, where
      4*wl/n = wl/2 so the two regimes coincide: bcap=wl/2 -> 10
      rounds, wl/4 -> 19, wl/8 -> 29);
    - receivers place arrivals into free slots (`place_arrivals`,
      O(n*bcap) = O(wl) work).

    Hub safety: per-(src,dst) bucket overflow is BACKPRESSURE (the
    crosser holds its slot and retries next round — never dropped);
    receiver-capacity overflow (arrivals beyond cap hosted walkers)
    is counted in `overflow`, the same rule as every other engine.
    `hop_batch` > 1 additionally lets walkers take local hops between
    exchanges (locality-ordered graphs cross rarely; see the batched
    engine's docstring for the rounds lower bound).

    The per-round loop predicate ("anyone alive") rides ON the
    all_to_all: each bucket carries one extra row with the sender's
    live count, so a round has exactly ONE collective.
    `route_off=True` (timing control, semantics-free) clamps crossers
    onto their shard and skips bucket+a2a+placement entirely; with
    every hop local, the round count is static, so the control runs
    ZERO collectives — pure per-device compute. Note the plain
    engine's control is the same (its `_route` is skipped) but the
    BATCHED engine's control still pays its all_gather each round, so
    comm_efficiency numbers are comparable between this engine and
    the plain one, and conservative (biased low) for this engine
    versus the batched one.

    `jax.lax.ragged_all_to_all` (the zero-padding exact form) remains
    unimplemented on XLA:CPU (tests/test_walks_a2a.py probes it each
    run; on the GPU it is unprobed, ROADMAP R7), so the dense-bucketed
    form is the portable implementation; the bucket padding costs at
    most the 2x slack in bcap over the true crossing count, against
    which the ragged form would save <2x wire — the per-shard volume
    stays constant in n either way.

    Reference counterpart being scaled:
    `ge/walker.py — simulate_walks (~L100) [U]`; SURVEY §3.3
    walk-engine row, §8.4-6.

    Returns fn(row_ptr, col_idx, degree, starts, key) ->
    (walks [n_walkers, length], overflow, rounds, crossed) — `crossed`
    is the GLOBAL number of exchanged walker rows over the whole run,
    the measured occupancy that feeds the wire-byte accounting:
    routed rows per shard per round =
    n*(bcap+1) dense vs crossed/(rounds*n) actually occupied.
    """
    n = mesh.shape["data"]
    wl = n_walkers // n
    cap = wl * slack
    # constant-total-volume default (see docstring): ~4*wl routed rows
    # per shard per round at ANY n; the 4x-over-mean headroom absorbs
    # destination skew (undersizing is never incorrect — backpressure
    # pays retry rounds: wl/2 -> 10 rounds, wl/4 -> 19, wl/8 -> 29
    # measured at n=8 on the wiki SBM, where 4*wl/n equals wl/2)
    bcap = bucket_cap or max(-(-4 * wl // n), 64)
    send_cap = 2 * wl  # total crossers compacted per round (sort size)
    H = hop_batch

    def core(row_ptr, col_idx, degree, accept, alias, starts, key):
        me = jax.lax.axis_index("data")
        lo = me * vp

        cur = jnp.full((cap,), -1, jnp.int32)
        wid = jnp.full((cap,), -1, jnp.int32)
        cur = cur.at[:wl].set(starts.reshape(-1))
        wid = wid.at[:wl].set(me * wl + jnp.arange(wl, dtype=jnp.int32))
        wid = jnp.where(cur >= 0, wid, -1)
        t = jnp.where(wid >= 0, 1, length).astype(jnp.int32)

        out = jnp.zeros((n_walkers, length), jnp.int32)
        out = _record(out, cur, wid, 0)

        def round_body(state):
            cur, wid, t, pend, out, key, ov, _gl, r, xs = state
            key, kr = jax.random.split(key)
            kr = jax.random.fold_in(kr, me)

            def hop(h, st):
                cur, wid, t, pend, out = st
                k = jax.random.fold_in(kr, h)
                active = (wid >= 0) & (pend < 0) & (t < length)
                lv = jnp.where(active, cur - lo, 0)
                deg = jnp.where(active, degree[lv], 0)
                u1 = jax.random.uniform(k, (cap,))
                if weighted:
                    from graphembedding.ops.alias import alias_draw

                    u2 = jax.random.uniform(
                        jax.random.fold_in(k, 1), (cap,)
                    )
                    pick = alias_draw(
                        accept, alias, row_ptr[lv],
                        jnp.maximum(deg, 1), u1, u2,
                    )
                else:
                    pick = jnp.minimum(
                        (u1 * deg.astype(jnp.float32)).astype(
                            jnp.int32),
                        jnp.maximum(deg - 1, 0),
                    )
                nxt = col_idx[row_ptr[lv] + pick]
                wid = jnp.where(active & (deg == 0), -1, wid)
                nxt_ok = active & (deg > 0)
                if route_off:
                    nxt = jnp.where(
                        nxt_ok, jnp.clip(nxt, lo, lo + vp - 1), nxt
                    )
                local = nxt_ok & (nxt >= lo) & (nxt < lo + vp)
                cur = jnp.where(local, nxt, cur)
                safe_w = jnp.where(local, wid, 0)
                safe_t = jnp.where(local, jnp.minimum(t, length - 1), 0)
                out = out.at[safe_w, safe_t].add(
                    jnp.where(local, cur + 1, 0)
                )
                t = jnp.where(local, t + 1, t)
                wid = jnp.where(t >= length, -1, wid)
                pend = jnp.where(nxt_ok & ~local, nxt, pend)
                return cur, wid, t, pend, out

            cur, wid, t, pend, out = jax.lax.fori_loop(
                0, H, hop, (cur, wid, t, pend, out)
            )

            # live count BEFORE extracting sends (in-flight walkers
            # must keep the loop alive)
            live_here = jnp.sum((wid >= 0).astype(jnp.int32))

            if not route_off:
                sbuf, sent = bucket_by_dest(
                    jnp.where((wid >= 0) & (pend >= 0), pend, -1),
                    wid, t, vp, n, bcap, send_cap=send_cap,
                )
                xs = xs + jnp.sum(sent.astype(jnp.int32))
                # sent walkers leave this shard; held ones retry
                wid = jnp.where(sent, -1, wid)
                pend = jnp.where(sent, -1, pend)
                # piggyback this shard's live count as one extra row
                # per destination bucket — the a2a then doubles as the
                # loop-termination reduction (no separate psum)
                sbuf = jnp.concatenate(
                    [sbuf.reshape(n, bcap, 3),
                     jnp.broadcast_to(
                         jnp.asarray([live_here, -1, -1], jnp.int32),
                         (n, 1, 3))],
                    axis=1,
                ).reshape(n * (bcap + 1), 3)
                recv = jax.lax.all_to_all(
                    sbuf, "data", split_axis=0, concat_axis=0,
                    tiled=True,
                ).reshape(n, bcap + 1, 3)
                global_live = jnp.sum(recv[:, bcap, 0])
                arrivals = recv[:, :bcap].reshape(n * bcap, 3)
                cur, wid, t, pend, out, ov_r = place_arrivals(
                    cur, wid, t, pend, out, arrivals, length
                )
                ov = ov + ov_r
            else:
                # control: no collectives at all — rounds are exactly
                # ceil((length-1)/H) since every (clamped) hop is
                # local, so termination is static (see cond below)
                global_live = live_here
            return (cur, wid, t, pend, out, key, ov, global_live,
                    r + 1, xs)

        R_ctl = -(-(length - 1) // H)

        def cond(state):
            if route_off:
                return state[8] < R_ctl
            return state[7] > 0

        pend0 = jnp.full((cap,), -1, jnp.int32)
        live0 = jnp.sum((wid >= 0).astype(jnp.int32))
        if not route_off:
            live0 = jax.lax.psum(live0, "data")
        state = (cur, wid, t, pend0, out, key, jnp.int32(0), live0,
                 jnp.int32(0), jnp.int32(0))
        (cur, wid, t, _p, out, key, ov, _gl, rounds,
         xs) = jax.lax.while_loop(cond, round_body, state)
        out = jax.lax.psum(out, "data")
        return (out - 1, jax.lax.psum(ov, "data"), rounds,
                jax.lax.psum(xs, "data"))

    if weighted:
        def body(row_ptr, col_idx, degree, accept, alias, starts,
                 key):
            return core(row_ptr[0], col_idx[0], degree[0], accept[0],
                        alias[0], starts, key)

        in_specs = (P("data"),) * 5 + (P("data"), P())
    else:
        def body(row_ptr, col_idx, degree, starts, key):
            return core(row_ptr[0], col_idx[0], degree[0], None, None,
                        starts, key)

        in_specs = (P("data"),) * 3 + (P("data"), P())

    fn = shard_map(
        body, mesh=mesh, in_specs=in_specs,
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def distributed_node2vec_walks(
    mesh, *, length, vp, dpad, n_walkers, p, q, slack=4
):
    """Exact (p,q) second-order distributed walks.

    Reference counterpart: `ge/walker.py — node2vec_walk (~L35) [U]`.
    The bias class of each candidate x ∈ N(cur) w.r.t. prev needs
    N(prev), whose owner may be another shard: prev's padded
    neighbor-matrix row is halo-fetched each step (`_fetch_rows_i32`),
    then the same blocked dense membership compare as the single-card
    kernel (`ops.walk.node2vec_walks`) scores candidates and Gumbel-max
    draws exactly. The first hop is a plain weighted draw, as in the
    single-card kernel.

    Returns fn(nbr [n,Vp,Dpad], nbr_w [n,Vp,Dpad], degree [n,Vp],
    starts [n,wl], key) -> (walks, overflow).
    """
    n = mesh.shape["data"]
    wl = n_walkers // n
    cap = wl * slack
    inv_p = jnp.float32(1.0 / p)
    inv_q = jnp.float32(1.0 / q)

    def body(nbr, nbr_w, degree, starts, key):
        nbr = nbr[0]  # [Vp, Dpad]
        nbr_w = nbr_w[0]
        degree = degree[0]
        me = jax.lax.axis_index("data")
        lo = me * vp
        cur = jnp.full((cap,), -1, jnp.int32)
        wid = jnp.full((cap,), -1, jnp.int32)
        prev = jnp.full((cap,), -1, jnp.int32)
        cur = cur.at[:wl].set(starts.reshape(-1))
        wid = wid.at[:wl].set(me * wl + jnp.arange(wl, dtype=jnp.int32))
        wid = jnp.where(cur >= 0, wid, -1)

        out = jnp.zeros((n_walkers, length), jnp.int32)
        out = _record(out, cur, wid, 0)

        def step(carry, xs):
            prev, cur, wid, out = carry
            t, k = xs
            alive = wid >= 0
            lv = jnp.where(alive, cur - lo, 0)
            cand = nbr[lv]  # [cap, Dpad]
            w = nbr_w[lv]
            valid = w > 0

            # halo-fetch prev's neighbor row from its owner shard
            prev_row = _fetch_rows_i32(nbr, prev, lo, vp, "data")

            is_prev = cand == prev[:, None]
            # blocked dense membership compare (see the ops.walk note on
            # per-element CSR binary search)
            C = min(8, dpad)
            n_chunks = (dpad + C - 1) // C

            def mem_chunk(j, acc):
                chunk = jax.lax.dynamic_slice_in_dim(
                    prev_row, j * C, C, axis=1
                )
                return acc | jnp.any(
                    cand[:, :, None] == chunk[:, None, :], axis=2
                )

            in_prev = jax.lax.fori_loop(
                0, n_chunks, mem_chunk,
                jnp.zeros((cap, dpad), bool),
            )
            bias = jnp.where(
                is_prev, inv_p, jnp.where(in_prev, 1.0, inv_q)
            )
            # first hop (t == 1) is an unbiased weighted draw
            bias = jnp.where(t == 1, 1.0, bias)
            w2 = w * bias
            g = -jnp.log(-jnp.log(jax.random.uniform(
                jax.random.fold_in(k, me), (cap, dpad),
                minval=1e-20, maxval=1.0) + 1e-20))
            score = jnp.where(
                valid, jnp.log(jnp.maximum(w2, 1e-30)) + g, -jnp.inf
            )
            pick = jnp.argmax(score, axis=1)
            nxt = cand[jnp.arange(cap), pick]
            deg = jnp.where(alive, degree[lv], 0)
            nxt = jnp.where(alive & (deg > 0), nxt, -1)
            wid = jnp.where(nxt >= 0, wid, -1)
            (cur2, wid, prev2), overflow = _route(
                [nxt, wid, cur], lo, vp, cap, n, "data"
            )
            out = _record(out, cur2, wid, t)
            return (prev2, cur2, wid, out), overflow

        keys = jax.random.split(key, length - 1)
        ts = jnp.arange(1, length, dtype=jnp.int32)
        (prev, cur, wid, out), overflows = jax.lax.scan(
            step, (prev, cur, wid, out), (ts, keys)
        )
        out = jax.lax.psum(out, "data")
        return out - 1, jax.lax.psum(overflows.sum(), "data")

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data"), P("data"), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def distributed_node2vec_rejection_walks(
    mesh, *, length, vp, n_walkers, p, q, max_degree, slack=4,
    proposals=32, envelope=False,
):
    """Dmax-safe distributed (p,q) walks: CSR-only rejection sampling.

    The exact engine (`distributed_node2vec_walks`) materializes
    [Vp, Dmax] dense neighbor rows per shard and halo-fetches Dmax-wide
    rows per walker per step — with a scale-free Dmax of 10^3-10^5 both
    blow up. This variant partitions ONLY the CSR
    + per-node alias tables (O(E/n) memory, like the weighted
    first-order engine) and mirrors the single-card rejection kernel
    (`ops.walk.node2vec_walks_rejection`, reference `node2vec_walk2
    [U]`), with one distributed twist: the membership test
    "candidate ∈ N(prev)" must run on prev's OWNER shard.

    Instead of a sequential retry loop (which would cost one exchange
    per retry), each walker proposes `proposals` candidates UP FRONT
    (proposals are i.i.d., so batching them is exactly equivalent);
    ONE query exchange per step resolves all memberships — all_gather
    of the [cap, T] (prev, cand) queries, local vectorized binary
    search on the owner, psum_scatter of the 0/1 answers back — and
    the first accepted candidate wins locally (on full rejection the
    last proposal is taken, the single-card kernel's documented bias).
    Comm per step: n·cap·(T+1) i32 + the usual state routing — no
    Dmax term anywhere.

    Returns fn(row_ptr [n,Vp+1], col_idx [n,E], degree [n,Vp],
    accept [n,E], alias [n,E], starts [n,wl], key)
    -> (walks, overflow).
    """
    from graphembedding.ops.alias import alias_draw
    from graphembedding.ops.walk import csr_contains

    n = mesh.shape["data"]
    wl = n_walkers // n
    cap = wl * slack
    T = proposals
    inv_p = jnp.float32(1.0 / p)
    inv_q = jnp.float32(1.0 / q)
    ub = float(max(1.0 / p, 1.0, 1.0 / q))
    # prev-point envelope (mirrors ops.walk's single-card
    # form): acceptance floor min(q, 1/q, 1) instead of min/max over
    # all three classes — at the canonical strong bias the overflow-
    # accept bias at T=32 upfront proposals drops (15/16)^32 ~ 13% ->
    # (3/4)^32 ~ 1e-4. UNWEIGHTED graphs only (the engine has no edge
    # weights; the mixture mass needs them) — the caller gates.
    beta = float(max(1.0, 1.0 / q))
    a_coef = float(max(1.0 / p - beta, 0.0))

    def body(row_ptr, col_idx, degree, acc_t, ali_t, starts, key):
        row_ptr = row_ptr[0]
        col_idx = col_idx[0]
        degree = degree[0]
        acc_t = acc_t[0]
        ali_t = ali_t[0]
        me = jax.lax.axis_index("data")
        lo = me * vp

        cur = jnp.full((cap,), -1, jnp.int32)
        wid = jnp.full((cap,), -1, jnp.int32)
        prev = jnp.full((cap,), -1, jnp.int32)
        cur = cur.at[:wl].set(starts.reshape(-1))
        wid = wid.at[:wl].set(me * wl + jnp.arange(wl, dtype=jnp.int32))
        wid = jnp.where(cur >= 0, wid, -1)

        out = jnp.zeros((n_walkers, length), jnp.int32)
        out = _record(out, cur, wid, 0)

        def step(carry, xs):
            prev, cur, wid, out = carry
            t, k = xs
            kk = jax.random.fold_in(k, me)
            alive = wid >= 0
            lv = jnp.where(alive, cur - lo, 0)
            deg = jnp.where(alive, degree[lv], 0)

            # T weighted proposals per walker from the LOCAL alias row
            k1, k2, k3, km = jax.random.split(kk, 4)
            u1 = jax.random.uniform(k1, (cap, T))
            u2 = jax.random.uniform(k2, (cap, T))
            offs = jnp.broadcast_to(row_ptr[lv][:, None], (cap, T))
            degb = jnp.broadcast_to(
                jnp.maximum(deg, 1)[:, None], (cap, T)
            )
            slot = alias_draw(
                acc_t, ali_t, offs.reshape(-1), degb.reshape(-1),
                u1.reshape(-1), u2.reshape(-1),
            )
            cand = col_idx[offs.reshape(-1) + slot].reshape(cap, T)

            if envelope:
                # prev-point mixture: w_prev = [prev in N(cur)] (cur is
                # LOCAL, so one local membership test), wsum = deg
                pfound = csr_contains(
                    row_ptr, col_idx, degree, lv,
                    jnp.maximum(prev, 0), max_degree=max_degree,
                ) & (prev >= 0) & alive
                a_mass = a_coef * pfound.astype(jnp.float32)
                p_point = a_mass / jnp.maximum(
                    a_mass + beta * deg.astype(jnp.float32), 1e-30)
                take_point = (jax.random.uniform(km, (cap, T))
                              < p_point[:, None])
                cand = jnp.where(
                    take_point, jnp.maximum(prev, 0)[:, None], cand)

            # ONE membership exchange for all T proposals:
            # queries (prev, cand) answered by prev's owner
            qry = jnp.concatenate(
                [prev[:, None], cand], axis=1
            )  # [cap, 1+T]
            qall = jax.lax.all_gather(qry, "data")  # [n, cap, 1+T]
            qp = qall[:, :, 0].reshape(-1)  # [n*cap]
            qc = qall[:, :, 1:].reshape(-1, T)
            owned = (qp >= lo) & (qp < lo + vp)
            qlv = jnp.where(owned, qp - lo, 0)
            rows = jnp.broadcast_to(qlv[:, None], qc.shape).reshape(-1)
            found = csr_contains(
                row_ptr, col_idx, degree, rows, qc.reshape(-1),
                max_degree=max_degree,
            ).reshape(-1, T)
            found = jnp.where(owned[:, None], found, False)
            ans = jax.lax.psum_scatter(
                found.reshape(n, cap, T).astype(jnp.int32), "data",
                scatter_dimension=0, tiled=True,
            )[0]  # [cap, T] 0/1 — unique owner, sum = select

            is_prev = cand == prev[:, None]
            factor = jnp.where(
                is_prev, inv_p, jnp.where(ans > 0, 1.0, inv_q)
            )
            if envelope:
                env = beta + jnp.where(is_prev, a_coef, 0.0)
            else:
                env = ub
            # first hop (t == 1): unbiased weighted draw — accept #0
            acc_u = jax.random.uniform(k3, (cap, T))
            accepted = acc_u < factor / env
            accepted = accepted | (t == 1)
            # first accepted proposal; last proposal on full rejection
            first = jnp.argmax(accepted, axis=1)
            pick = jnp.where(jnp.any(accepted, axis=1), first, T - 1)
            nxt = cand[jnp.arange(cap), pick]
            nxt = jnp.where(alive & (deg > 0), nxt, -1)
            wid = jnp.where(nxt >= 0, wid, -1)
            (cur2, wid, prev2), overflow = _route(
                [nxt, wid, cur], lo, vp, cap, n, "data"
            )
            out = _record(out, cur2, wid, t)
            return (prev2, cur2, wid, out), overflow

        keys = jax.random.split(key, length - 1)
        ts = jnp.arange(1, length, dtype=jnp.int32)
        (prev, cur, wid, out), overflows = jax.lax.scan(
            step, (prev, cur, wid, out), (ts, keys)
        )
        out = jax.lax.psum(out, "data")
        return out - 1, jax.lax.psum(overflows.sum(), "data")

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P("data"),) * 5 + (P("data"), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def _multilayer_local_steps(row_ptr, col_idx, accept, alias_t):
    """Shared per-shard step closures of the two multilayer engines.

    row_ptr [K, Vp+1], col_idx/accept/alias [K, E] are one shard's
    stacked layer structures. Returns (flat_rp, deg_at,
    neighbor_step): flat offset/degree lookups and the alias-table
    in-layer hop (`neighbor_step(layer, lv, v_global, k)` — stays at
    v_global on a zero-degree row). Factored so a semantics fix
    applies to the all_gather and a2a engines at once.
    """
    K, Vp1 = row_ptr.shape
    e_cols = col_idx.shape[1]
    rp_f = row_ptr.reshape(-1)
    col_f = col_idx.reshape(-1)
    acc_f = accept.reshape(-1)
    ali_f = alias_t.reshape(-1)

    def flat_rp(layer, lv):
        return rp_f[layer * Vp1 + lv]

    def deg_at(layer, lv):
        return flat_rp(layer, lv + 1) - flat_rp(layer, lv)

    def neighbor_step(layer, lv, v_global, k):
        d = deg_at(layer, lv)
        off = flat_rp(layer, lv)
        k1, k2 = jax.random.split(k)
        u1 = jax.random.uniform(k1, lv.shape)
        u2 = jax.random.uniform(k2, lv.shape)
        pick = jnp.minimum(
            (u1 * d.astype(jnp.float32)).astype(jnp.int32),
            jnp.maximum(d - 1, 0),
        )
        flat = layer * e_cols + off + pick
        take = u2 < acc_f[flat]
        slot = jnp.where(take, pick, ali_f[flat])
        nxt = col_f[layer * e_cols + off + slot]
        return jnp.where(d > 0, nxt, v_global)

    return flat_rp, deg_at, neighbor_step


def distributed_multilayer_walks(
    mesh, *, length, vp, n_walkers, stay_prob, max_moves=16, slack=4
):
    """Struc2Vec biased multilayer walks over partitioned layer CSRs.

    Reference counterpart: `ge/walker.py — BiasedWalker._exec_random_walk
    (~L200) [U]`; device semantics identical to the single-card
    `models.struc2vec.multilayer_walks` (bounded in-step layer-move
    loop, forced step on loop exhaustion). Layer moves keep the vertex,
    so they are always shard-local; only the in-layer neighbor hop
    routes the walker.

    Returns fn(row_ptr [n,K,Vp+1], col_idx [n,K,E], accept [n,K,E],
    alias [n,K,E], gamma [n,K,Vp], starts [n,wl], key)
    -> (walks, overflow).
    """
    n = mesh.shape["data"]
    wl = n_walkers // n
    cap = wl * slack
    sp = jnp.float32(stay_prob)

    def body(row_ptr, col_idx, accept, alias, gamma, starts, key):
        row_ptr = row_ptr[0]  # [K, Vp+1]
        col_idx = col_idx[0]  # [K, E]
        accept = accept[0]
        alias_t = alias[0]
        gamma = gamma[0]  # [K, Vp]
        K, Vp1 = row_ptr.shape
        me = jax.lax.axis_index("data")
        lo = me * vp

        flat_rp, deg_at, neighbor_step = _multilayer_local_steps(
            row_ptr, col_idx, accept, alias_t
        )
        gam_f = gamma.reshape(-1)

        cur = jnp.full((cap,), -1, jnp.int32)
        wid = jnp.full((cap,), -1, jnp.int32)
        layer = jnp.zeros((cap,), jnp.int32)
        cur = cur.at[:wl].set(starts.reshape(-1))
        wid = wid.at[:wl].set(me * wl + jnp.arange(wl, dtype=jnp.int32))
        wid = jnp.where(cur >= 0, wid, -1)

        out = jnp.zeros((n_walkers, length), jnp.int32)
        out = _record(out, cur, wid, 0)

        def emit(carry, xs):
            cur, layer, wid, out = carry
            t, k = xs
            alive = wid >= 0
            lv = jnp.where(alive, cur - lo, 0)

            def move_body(i, state):
                layer, stepped, nxt, kk = state
                kk, kr, km, kn = jax.random.split(kk, 4)
                r = jax.random.uniform(kr, lv.shape)
                do_step = (r < sp) & ~stepped
                v_next = neighbor_step(layer, lv, cur, kn)
                nxt = jnp.where(do_step, v_next, nxt)
                stepped = stepped | do_step

                g = gam_f[layer * (Vp1 - 1) + lv]
                x = jnp.log(g + jnp.e)
                p_up = x / (x + 1.0)
                r2 = jax.random.uniform(km, lv.shape)
                # clamp the probe layer so the flat rp_f index stays in
                # bounds when layer+1 == K (the result is masked by
                # layer+1 < K either way, but correctness must not rest
                # on XLA's silent out-of-bounds gather clamp)
                up_probe = deg_at(jnp.minimum(layer + 1, K - 1), lv)
                can_up = (layer + 1 < K) & (up_probe > 0)
                go_up = (r2 <= p_up) & can_up
                go_down = (r2 > p_up) & (layer > 0)
                moving = ~stepped & ~do_step
                layer = jnp.where(
                    moving & go_up,
                    layer + 1,
                    jnp.where(moving & go_down, layer - 1, layer),
                )
                return layer, stepped, nxt, kk

            stepped0 = jnp.zeros_like(lv, dtype=bool)
            layer, stepped, nxt, kk = jax.lax.fori_loop(
                0, max_moves, move_body,
                (layer, stepped0, cur, jax.random.fold_in(k, me)),
            )
            k_force = jax.random.fold_in(jax.random.fold_in(k, me), 999)
            v_forced = neighbor_step(layer, lv, cur, k_force)
            nxt = jnp.where(stepped, nxt, v_forced)
            nxt = jnp.where(alive, nxt, -1)
            wid = jnp.where(nxt >= 0, wid, -1)
            (cur, wid, layer), overflow = _route(
                [nxt, wid, layer], lo, vp, cap, n, "data"
            )
            layer = jnp.maximum(layer, 0)  # -1 fill on empty slots
            out = _record(out, cur, wid, t)
            return (cur, layer, wid, out), overflow

        keys = jax.random.split(key, length - 1)
        ts = jnp.arange(1, length, dtype=jnp.int32)
        (cur, layer, wid, out), overflows = jax.lax.scan(
            emit, (cur, layer, wid, out), (ts, keys)
        )
        out = jax.lax.psum(out, "data")
        return out - 1, jax.lax.psum(overflows.sum(), "data")

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P("data"),) * 5 + (P("data"), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def distributed_multilayer_walks_a2a(
    mesh, *, length, vp, n_walkers, stay_prob, max_moves=16, slack=4,
    bucket_cap=None,
):
    """Struc2Vec multilayer walks through the crossers-only exchange.

    Same walk semantics as `distributed_multilayer_walks` (bounded
    in-step layer-move loop, forced step on exhaustion — reference
    `BiasedWalker._exec_random_walk [U]`), with the exact
    exchange instead of the all_gather router: walkers carry their own
    position t, crossers are bucketed per destination and moved by ONE
    tiled all_to_all per round (constant ~4*wl routed rows per shard —
    see `distributed_uniform_walks_a2a`), bucket overflow is
    backpressure. The (layer, t) pair rides the exchange PACKED into
    the third payload column (layer*2^16 + t — both are < 2^16 by
    construction: layers are BFS depths, t < walk length), so
    `bucket_by_dest`'s 3-column frame is reused unchanged.

    Returns fn(row_ptr [n,K,Vp+1], col_idx [n,K,E], accept [n,K,E],
    alias [n,K,E], gamma [n,K,Vp], starts [n,wl], key)
    -> (walks, overflow, rounds, crossed).
    """
    n = mesh.shape["data"]
    wl = n_walkers // n
    cap = wl * slack
    bcap = bucket_cap or max(-(-4 * wl // n), 64)
    send_cap = 2 * wl
    sp = jnp.float32(stay_prob)
    if length >= (1 << 16):
        raise ValueError(
            f"walk_length {length} >= 2^16 would corrupt the packed "
            "(layer, t) exchange column — use the all_gather "
            "multilayer engine for such walks"
        )

    def body(row_ptr, col_idx, accept, alias, gamma, starts, key):
        row_ptr = row_ptr[0]  # [K, Vp+1]
        col_idx = col_idx[0]  # [K, E]
        accept = accept[0]
        alias_t = alias[0]
        gamma = gamma[0]  # [K, Vp]
        K, Vp1 = row_ptr.shape
        e_cols = col_idx.shape[1]
        me = jax.lax.axis_index("data")
        lo = me * vp

        flat_rp, deg_at, neighbor_step = _multilayer_local_steps(
            row_ptr, col_idx, accept, alias_t
        )
        gam_f = gamma.reshape(-1)

        cur = jnp.full((cap,), -1, jnp.int32)
        wid = jnp.full((cap,), -1, jnp.int32)
        layer = jnp.zeros((cap,), jnp.int32)
        cur = cur.at[:wl].set(starts.reshape(-1))
        wid = wid.at[:wl].set(me * wl + jnp.arange(wl, dtype=jnp.int32))
        wid = jnp.where(cur >= 0, wid, -1)
        t = jnp.where(wid >= 0, 1, length).astype(jnp.int32)

        out = jnp.zeros((n_walkers, length), jnp.int32)
        out = _record(out, cur, wid, 0)

        def round_body(state):
            cur, layer, wid, t, pend, out, key, ov, _gl, r, xs = state
            key, kr = jax.random.split(key)
            k = jax.random.fold_in(kr, me)

            active = (wid >= 0) & (pend < 0) & (t < length)
            lv = jnp.where(active, cur - lo, 0)

            def move_body(i, st):
                layer, stepped, nxt, kk = st
                kk, kr2, km, kn = jax.random.split(kk, 4)
                rr = jax.random.uniform(kr2, lv.shape)
                do_step = (rr < sp) & ~stepped
                v_next = neighbor_step(layer, lv, cur, kn)
                nxt = jnp.where(do_step, v_next, nxt)
                stepped = stepped | do_step

                g = gam_f[layer * (Vp1 - 1) + lv]
                x = jnp.log(g + jnp.e)
                p_up = x / (x + 1.0)
                r2 = jax.random.uniform(km, lv.shape)
                up_probe = deg_at(jnp.minimum(layer + 1, K - 1), lv)
                can_up = (layer + 1 < K) & (up_probe > 0)
                go_up = (r2 <= p_up) & can_up
                go_down = (r2 > p_up) & (layer > 0)
                moving = ~stepped & ~do_step & active
                layer = jnp.where(
                    moving & go_up,
                    layer + 1,
                    jnp.where(moving & go_down, layer - 1, layer),
                )
                return layer, stepped, nxt, kk

            stepped0 = jnp.zeros_like(lv, dtype=bool)
            layer, stepped, nxt, _kk = jax.lax.fori_loop(
                0, max_moves, move_body, (layer, stepped0, cur, k)
            )
            k_force = jax.random.fold_in(k, 999)
            v_forced = neighbor_step(layer, lv, cur, k_force)
            nxt = jnp.where(stepped, nxt, v_forced)

            local = active & (nxt >= lo) & (nxt < lo + vp)
            cur = jnp.where(local, nxt, cur)
            safe_w = jnp.where(local, wid, 0)
            safe_t = jnp.where(local, jnp.minimum(t, length - 1), 0)
            out = out.at[safe_w, safe_t].add(
                jnp.where(local, cur + 1, 0)
            )
            t = jnp.where(local, t + 1, t)
            wid = jnp.where(t >= length, -1, wid)
            pend = jnp.where(active & ~local, nxt, pend)

            live_here = jnp.sum((wid >= 0).astype(jnp.int32))

            packed = layer * (1 << 16) + t
            sbuf, sent = bucket_by_dest(
                jnp.where((wid >= 0) & (pend >= 0), pend, -1),
                wid, packed, vp, n, bcap, send_cap=send_cap,
            )
            xs = xs + jnp.sum(sent.astype(jnp.int32))
            wid = jnp.where(sent, -1, wid)
            pend = jnp.where(sent, -1, pend)
            sbuf = jnp.concatenate(
                [sbuf.reshape(n, bcap, 3),
                 jnp.broadcast_to(
                     jnp.asarray([live_here, -1, -1], jnp.int32),
                     (n, 1, 3))],
                axis=1,
            ).reshape(n * (bcap + 1), 3)
            recv = jax.lax.all_to_all(
                sbuf, "data", split_axis=0, concat_axis=0, tiled=True,
            ).reshape(n, bcap + 1, 3)
            global_live = jnp.sum(recv[:, bcap, 0])
            arr = recv[:, :bcap].reshape(n * bcap, 3)
            x_a = jnp.maximum(arr[:, 2], 0)
            # unpack (layer, t) and hand the standard receiver half
            # (place_arrivals — the unit-tested path) a plain
            # (v, wid, t) frame plus the layer as the extra column
            arr3 = jnp.stack(
                [arr[:, 0], arr[:, 1], x_a & 0xFFFF], axis=1
            )
            (cur, wid, t, pend, out, ov_r,
             layer) = place_arrivals(
                cur, wid, t, pend, out, arr3, length,
                extra=layer, extra_arrivals=x_a >> 16,
            )
            ov = ov + ov_r
            return (cur, layer, wid, t, pend, out, key, ov,
                    global_live, r + 1, xs)

        def cond(state):
            return state[8] > 0

        pend0 = jnp.full((cap,), -1, jnp.int32)
        live0 = jax.lax.psum(
            jnp.sum((wid >= 0).astype(jnp.int32)), "data"
        )
        state = (cur, layer, wid, t, pend0, out, key, jnp.int32(0),
                 live0, jnp.int32(0), jnp.int32(0))
        (cur, layer, wid, t, _p, out, key, ov, _gl, rounds,
         xs) = jax.lax.while_loop(cond, round_body, state)
        out = jax.lax.psum(out, "data")
        return (out - 1, jax.lax.psum(ov, "data"), rounds,
                jax.lax.psum(xs, "data"))

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P("data"),) * 5 + (P("data"), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


# --------------------------------------------------------------------------- #
# high-level wrappers
# --------------------------------------------------------------------------- #


class DistributedWalker:
    """Reusable distributed walk engine: partition + compile ONCE.

    `simulate_walks_distributed` used to re-partition the CSR on host,
    re-transfer it, and re-trace the shard_map engine on every call —
    fine for a one-shot corpus, but it put O(V+E) host work and a full
    retrace in the steady-state path (and in the scaling harness's
    timed region). This object is the steady-state API: construct once
    per (graph, mesh, kind, length), then `run(key)` as many times as
    needed — each run is exactly one jitted call on device-resident
    partitioned state.

    Reference counterpart being scaled:
    `ge/walker.py — simulate_walks (~L100) [U]`.
    """

    def __init__(self, graph, mesh, walk_length, *, kind="uniform",
                 num_walks=1, p=1.0, q=1.0, slack=4, stay_prob=0.3,
                 max_moves=16, layers=None, num_nodes=None,
                 route_off=False, hop_batch=0, send_slack=2.0,
                 relabel=None, proposals=32, exchange=None,
                 bucket_cap=None):
        import jax.numpy as jnp  # local: keep module import surface

        self.mesh = mesh
        self.kind = kind
        n = mesh.shape["data"]
        self._perm = None
        if relabel is not None:
            if kind != "uniform":
                raise ValueError(
                    "relabel= is currently wired for kind='uniform'"
                )
            if relabel == "locality":
                perm = locality_order(graph)
            else:
                perm = np.asarray(relabel, dtype=np.int64)
            graph = relabel_graph(graph, perm)
            self._perm = perm  # perm[new_id] = old_id
        V = graph.num_nodes if graph is not None else num_nodes
        vp = (V + n - 1) // n
        self.num_nodes = V
        starts, n_walkers = _group_starts(V, num_walks, n, vp)

        if route_off and kind != "uniform":
            raise ValueError("route_off is a uniform-kind timing "
                             "control (scaling harness only)")
        if exchange not in (None, "a2a"):
            raise ValueError(f"unknown exchange {exchange!r} "
                             "(None = all_gather engines, 'a2a' = "
                             "crossers-only exact exchange)")
        if exchange == "a2a":
            if kind not in ("uniform", "weighted", "multilayer"):
                raise ValueError(
                    "exchange='a2a' is wired for the first-order "
                    "kinds ('uniform'/'weighted') and 'multilayer'"
                )
            if kind == "multilayer":
                parts = partition_layers(layers, V, n)
                self._fn = distributed_multilayer_walks_a2a(
                    mesh, length=walk_length, vp=vp,
                    n_walkers=n_walkers, stay_prob=stay_prob,
                    max_moves=max_moves, slack=slack,
                    bucket_cap=bucket_cap,
                )
                self._args = (
                    jnp.asarray(parts["row_ptr"]),
                    jnp.asarray(parts["col_idx"]),
                    jnp.asarray(parts["accept"]),
                    jnp.asarray(parts["alias"]),
                    jnp.asarray(parts["gamma"]),
                )
            else:
                if kind == "weighted":
                    accept, alias = graph.host_alias()
                    parts = partition_csr(
                        graph, n,
                        edge_arrays={
                            "accept": (accept.astype(np.float32), 1.0),
                            "alias": (alias.astype(np.int32), 0),
                        },
                    )
                else:
                    parts = partition_csr(graph, n)
                self._fn = distributed_uniform_walks_a2a(
                    mesh, length=walk_length, vp=vp,
                    n_walkers=n_walkers, slack=slack,
                    hop_batch=max(hop_batch, 1),
                    bucket_cap=bucket_cap, route_off=route_off,
                    weighted=(kind == "weighted"),
                )
                self._args = (
                    jnp.asarray(parts["row_ptr"]),
                    jnp.asarray(parts["col_idx"]),
                    jnp.asarray(parts["degree"]),
                ) + (
                    (jnp.asarray(parts["accept"]),
                     jnp.asarray(parts["alias"]))
                    if kind == "weighted" else ()
                )
        elif kind == "uniform" and hop_batch:
            parts = partition_csr(graph, n)
            self._fn = distributed_uniform_walks_batched(
                mesh, length=walk_length, vp=vp, n_walkers=n_walkers,
                slack=slack, hop_batch=hop_batch,
                send_slack=send_slack, route_off=route_off,
            )
            self._args = (
                jnp.asarray(parts["row_ptr"]),
                jnp.asarray(parts["col_idx"]),
                jnp.asarray(parts["degree"]),
            )
        elif kind == "uniform":
            parts = partition_csr(graph, n)
            self._fn = distributed_uniform_walks(
                mesh, length=walk_length, vp=vp, n_walkers=n_walkers,
                slack=slack, route_off=route_off,
            )
            self._args = (
                jnp.asarray(parts["row_ptr"]),
                jnp.asarray(parts["col_idx"]),
                jnp.asarray(parts["degree"]),
            )
        elif kind == "weighted":
            accept, alias = graph.host_alias()
            parts = partition_csr(
                graph, n,
                edge_arrays={
                    "accept": (accept.astype(np.float32), 1.0),
                    "alias": (alias.astype(np.int32), 0),
                },
            )
            self._fn = distributed_weighted_walks(
                mesh, length=walk_length, vp=vp, n_walkers=n_walkers,
                slack=slack,
            )
            self._args = (
                jnp.asarray(parts["row_ptr"]),
                jnp.asarray(parts["col_idx"]),
                jnp.asarray(parts["degree"]),
                jnp.asarray(parts["accept"]),
                jnp.asarray(parts["alias"]),
            )
        elif kind == "node2vec":
            nbr, nbr_w, deg, vp2, dpad = partition_neighbor_matrix(
                graph, n
            )
            assert vp2 == vp
            self._fn = distributed_node2vec_walks(
                mesh, length=walk_length, vp=vp, dpad=dpad,
                n_walkers=n_walkers, p=p, q=q, slack=slack,
            )
            self._args = (
                jnp.asarray(nbr), jnp.asarray(nbr_w), jnp.asarray(deg),
            )
        elif kind == "node2vec_rejection":
            accept, alias = graph.host_alias()
            parts = partition_csr(
                graph, n,
                edge_arrays={
                    "accept": (accept.astype(np.float32), 1.0),
                    "alias": (alias.astype(np.int32), 0),
                },
            )
            self._fn = distributed_node2vec_rejection_walks(
                mesh, length=walk_length, vp=vp, n_walkers=n_walkers,
                p=p, q=q, slack=slack, proposals=proposals,
                max_degree=int(graph.degree.max()),
                # envelope needs edge weights for the mixture mass;
                # enable on unweighted graphs (w identically 1)
                envelope=bool(
                    np.all(graph.edge_weight[:graph.num_edges] == 1.0)),
            )
            self._args = (
                jnp.asarray(parts["row_ptr"]),
                jnp.asarray(parts["col_idx"]),
                jnp.asarray(parts["degree"]),
                jnp.asarray(parts["accept"]),
                jnp.asarray(parts["alias"]),
            )
        elif kind == "multilayer":
            parts = partition_layers(layers, V, n)
            self._fn = distributed_multilayer_walks(
                mesh, length=walk_length, vp=vp, n_walkers=n_walkers,
                stay_prob=stay_prob, max_moves=max_moves, slack=slack,
            )
            self._args = (
                jnp.asarray(parts["row_ptr"]),
                jnp.asarray(parts["col_idx"]),
                jnp.asarray(parts["accept"]),
                jnp.asarray(parts["alias"]),
                jnp.asarray(parts["gamma"]),
            )
        else:
            raise ValueError(f"unknown distributed walk kind: {kind!r}")

        # multi-process meshes (jax.distributed): assemble the
        # partitioned state + starts into GLOBAL arrays; single-process
        # this is a plain device put (parallel.mesh.put_global)
        from graphembedding.parallel.mesh import put_global

        self._args = tuple(
            put_global(a, mesh, P("data")) for a in self._args
        )
        self._starts = put_global(starts, mesh, P("data"))

    last_rounds = None  # routing rounds of the last batched/a2a run
    last_crossed = None  # exchanged rows of the last a2a-engine run

    def run_device(self, key):
        """One engine call; returns device (walks, overflow) with
        filler walker rows still present (first token -1)."""
        out = self._fn(*self._args, self._starts, key)
        if len(out) == 4:  # a2a engine: rounds + crossing occupancy
            walks, ov, rounds, crossed = out
            self.last_rounds = int(rounds)
            self.last_crossed = int(crossed)
            return walks, ov
        if len(out) == 3:  # batched engine also reports its rounds
            walks, ov, rounds = out
            self.last_rounds = int(rounds)
            return walks, ov
        return out

    def run(self, key):
        """Walk corpus as numpy with filler rows dropped; returns
        (walks [kept, length], overflow count). Tokens are in the
        caller's original vertex ids (relabeling is undone here)."""
        walks, overflow = self.run_device(key)
        walks = np.asarray(walks)
        keep = walks[:, 0] >= 0
        walks = walks[keep]
        if self._perm is not None:
            mapped = self._perm[np.clip(walks, 0, None)]
            walks = np.where(walks >= 0, mapped, -1).astype(np.int32)
        return walks, int(overflow)


def _group_starts(num_nodes, num_walks, n, vp):
    """Group walker start vertices by owner shard, pad with -1."""
    starts_per_shard = []
    for s in range(n):
        lo, hi = s * vp, min((s + 1) * vp, num_nodes)
        ids = np.arange(lo, hi, dtype=np.int32)
        starts_per_shard.append(np.tile(ids, num_walks))
    wl = max(len(x) for x in starts_per_shard)
    starts = np.full((n, wl), -1, dtype=np.int32)
    for s, x in enumerate(starts_per_shard):
        starts[s, : len(x)] = x
    return starts, n * wl


def simulate_walks_distributed(
    graph, mesh, num_walks, walk_length, key, *, kind="uniform",
    p=1.0, q=1.0, slack=4,
):
    """One-shot distributed walk corpus (grouped by owner shard).

    kind: 'uniform' | 'weighted' | 'node2vec' — the distributed
    counterparts of `ops.walk.simulate_walks`. Returns
    (walks [kept, length] numpy, overflow count). For repeated corpora
    over the same graph/mesh build a `DistributedWalker` once and call
    `run(key)` — this wrapper pays host partitioning + engine trace on
    every call.
    """
    return DistributedWalker(
        graph, mesh, walk_length, kind=kind, num_walks=num_walks,
        p=p, q=q, slack=slack,
    ).run(key)


def simulate_multilayer_walks_distributed(
    layers, num_nodes, mesh, num_walks, walk_length, key, *,
    stay_prob=0.3, max_moves=16, slack=4,
):
    """One-shot distributed struc2vec multilayer walk corpus.

    `layers` is the `build_layer_csr` dict. Returns (walks, overflow).
    See `DistributedWalker(kind='multilayer')` for the reusable form.
    """
    return DistributedWalker(
        None, mesh, walk_length, kind="multilayer",
        num_walks=num_walks, stay_prob=stay_prob, max_moves=max_moves,
        slack=slack, layers=layers, num_nodes=num_nodes,
    ).run(key)
