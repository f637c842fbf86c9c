"""Batched device random-walk kernels.

Reference counterpart: `ge/walker.py — RandomWalker.deepwalk_walk /
node2vec_walk / node2vec_walk2 [U]`, which advance ONE walker at a time in
pure Python (joblib processes for parallelism). Here every walker in a batch
advances in lockstep on device under `lax.scan`; a walk step is a handful of
gathers + a sample, all static-shaped so XLA fuses the whole walk into one
program.

Three samplers:
  * `uniform_walks`     — DeepWalk: uniform over out-neighbors.
  * `weighted_walks`    — first-order weighted via per-node alias tables
                          (two uniforms + two gathers, O(1) per step).
  * `node2vec_walks`    — exact second-order (p,q) walk: per step, score all
                          of cur's (padded) neighbors with {w/p, w, w/q} by
                          membership test against prev's sorted neighbor row
                          and draw via Gumbel-max. No O(E·d) alias_edges
                          table (the reference's memory cliff) and no
                          rejection-failure bias.
  * `node2vec_walks_rejection` — KnightKing-style rejection sampler
                          (reference `node2vec_walk2`): O(1) proposals with
                          a bounded retry loop; cheaper per step for small
                          max-degree graphs, biased only on retry overflow.

Dead ends (out-degree 0) terminate a walk; remaining positions are -1
(consumers mask them). Walk buffers are int32 `[B, L]`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from graphembedding.ops.alias import alias_draw

_INT32_MAX = jnp.iinfo(jnp.int32).max
_LANE = 128


def _safe(cur):
    """Clamp dead (-1) walker ids to 0 for gathers; callers mask."""
    return jnp.maximum(cur, 0)


def csr_find(row_ptr, col_idx, degree, rows, values, *, max_degree):
    """Vectorized lookup: position of `values[b]` in CSR row `rows[b]`.

    Binary search over the sorted columns of each CSR row, fixed
    `ceil(log2(max_degree)) + 1` iterations. rows must be valid (>= 0).
    Returns (found bool, idx i32) where `idx` is the global CSR slot
    of the match (valid only where found).
    """
    lo = row_ptr[rows]
    hi = lo + degree[rows]
    steps = max(int(max_degree).bit_length(), 1)

    def body(_, lohi):
        lo, hi = lohi
        active = lo < hi
        mid = (lo + hi) // 2
        mid_val = col_idx[jnp.minimum(mid, col_idx.shape[0] - 1)]
        go_right = mid_val < values
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
    found = (lo < row_ptr[rows] + degree[rows]) & (
        col_idx[jnp.minimum(lo, col_idx.shape[0] - 1)] == values
    )
    return found, lo


def csr_contains(row_ptr, col_idx, degree, rows, values, *, max_degree):
    """Vectorized membership test: is `values[b]` in row `rows[b]`?"""
    found, _ = csr_find(row_ptr, col_idx, degree, rows, values,
                        max_degree=max_degree)
    return found


@partial(jax.jit, static_argnames=("length",))
def uniform_walks(row_ptr, col_idx, degree, starts, key, *, length):
    """DeepWalk walks: uniform next-hop. Returns i32 [B, length]."""
    # row_ptr and degree are both indexed by `cur` every step; packing
    # them as one [V, 2] table halves the per-walker row-issue count
    # for the offset/degree lookups (gather issue overhead, not
    # bandwidth, bounds the walk step)
    rpd = jnp.stack([row_ptr[: degree.shape[0]], degree], axis=1)

    def step(carry, k):
        cur = carry
        rd = rpd[_safe(cur)]  # [B, 2]
        deg = jnp.where(cur >= 0, rd[:, 1], 0)
        u = jax.random.uniform(k, cur.shape)
        pick = jnp.minimum((u * deg.astype(jnp.float32)).astype(jnp.int32),
                           jnp.maximum(deg - 1, 0))
        nxt = col_idx[rd[:, 0] + pick]
        nxt = jnp.where(deg > 0, nxt, -1)
        return nxt, cur

    keys = jax.random.split(key, length - 1)
    last, trail = jax.lax.scan(step, starts, keys)
    return jnp.concatenate(
        [jnp.moveaxis(trail, 0, 1), last[:, None]], axis=1
    )


@partial(jax.jit, static_argnames=("length",))
def weighted_walks(
    row_ptr, col_idx, degree, accept, alias, starts, key, *, length
):
    """First-order weighted walks via per-node alias tables."""

    rpd = jnp.stack([row_ptr[: degree.shape[0]], degree], axis=1)

    def step(carry, k):
        cur = carry
        rd = rpd[_safe(cur)]  # [B, 2] — offset + degree in one gather
        rp = rd[:, 0]
        deg = jnp.where(cur >= 0, rd[:, 1], 0)
        k1, k2 = jax.random.split(k)
        u1 = jax.random.uniform(k1, cur.shape)
        u2 = jax.random.uniform(k2, cur.shape)
        slot = alias_draw(
            accept, alias, rp, jnp.maximum(deg, 1), u1, u2
        )
        nxt = col_idx[rp + slot]
        nxt = jnp.where(deg > 0, nxt, -1)
        return nxt, cur

    keys = jax.random.split(key, length - 1)
    last, trail = jax.lax.scan(step, starts, keys)
    return jnp.concatenate(
        [jnp.moveaxis(trail, 0, 1), last[:, None]], axis=1
    )


@partial(jax.jit, static_argnames=("length", "max_degree"))
def node2vec_walks(
    row_ptr,
    col_idx,
    degree,
    nbr,
    nbr_w,
    starts,
    key,
    p,
    q,
    *,
    length,
    max_degree,
):
    """Exact (p,q)-biased second-order walks (Grover & Leskovec 2016).

    Per step, for walker at `cur` having arrived from `prev`:
      weight(x) = w(cur,x) * { 1/p  if x == prev
                               1    if x in N(prev)   (distance 1)
                               1/q  otherwise }       (distance 2)
    sampled exactly via Gumbel-max over the padded neighbor row of `cur`.
    Membership in N(prev) is a blocked dense equality test against prev's
    padded neighbor row (vector compares; see the note in `step`).
    """
    inv_p = jnp.float32(1.0 / p)
    inv_q = jnp.float32(1.0 / q)
    B = starts.shape[0]
    D = nbr.shape[1]

    def first_step(cur, k):
        # first hop: plain weighted first-order sample over nbr_w
        w = nbr_w[_safe(cur)]
        valid = w > 0
        g = -jnp.log(-jnp.log(jax.random.uniform(
            k, (B, D), minval=1e-20, maxval=1.0) + 1e-20))
        score = jnp.where(valid, jnp.log(jnp.maximum(w, 1e-30)) + g, -jnp.inf)
        pick = jnp.argmax(score, axis=1)
        nxt = nbr[_safe(cur), pick]
        deg = jnp.where(cur >= 0, degree[_safe(cur)], 0)
        return jnp.where(deg > 0, nxt, -1)

    def step(carry, k):
        prev, cur = carry
        safe = _safe(cur)
        cand = nbr[safe]  # [B, D]
        w = nbr_w[safe]
        valid = w > 0

        is_prev = cand == prev[:, None]
        # membership of each candidate in N(prev): blocked all-pairs
        # equality against prev's padded neighbor row. A per-candidate
        # CSR binary search (csr_contains) costs B·Dmax·log2(Dmax)
        # random ELEMENT gathers per step; the dense compare is
        # B·Dmax²/C chunked vector compares with one extra row gather.
        # Pad candidates (-1) equal pad neighbors (-1) harmlessly:
        # `valid` masks them out of the score below.
        nbr_prev = nbr[_safe(prev)]  # [B, D]
        # chunk width never exceeds the neighbor-matrix width, so the
        # dynamic_slice below stays in-bounds even for callers passing
        # an unpadded narrow matrix (Graph.neighbor_matrix lane-pads to
        # 128, but this kernel is public API)
        C = min(8, D)
        n_chunks = (D + C - 1) // C

        def mem_chunk(j, acc):
            chunk = jax.lax.dynamic_slice_in_dim(
                nbr_prev, j * C, C, axis=1
            )  # clamped at the edge; re-reading rows is harmless for OR
            return acc | jnp.any(
                cand[:, :, None] == chunk[:, None, :], axis=2
            )

        in_prev_nbrs = jax.lax.fori_loop(
            0, n_chunks, mem_chunk, jnp.zeros((B, D), bool)
        )

        bias = jnp.where(
            is_prev, inv_p, jnp.where(in_prev_nbrs, 1.0, inv_q)
        )
        w2 = w * bias
        g = -jnp.log(-jnp.log(jax.random.uniform(
            k, (B, D), minval=1e-20, maxval=1.0) + 1e-20))
        score = jnp.where(
            valid, jnp.log(jnp.maximum(w2, 1e-30)) + g, -jnp.inf
        )
        pick = jnp.argmax(score, axis=1)
        nxt = cand[jnp.arange(B), pick]
        deg = jnp.where(cur >= 0, degree[safe], 0)
        nxt = jnp.where(deg > 0, nxt, -1)
        return (cur, nxt), cur

    k0, krest = jax.random.split(key)
    second = first_step(starts, k0)
    if length == 1:
        return starts[:, None]
    keys = jax.random.split(krest, max(length - 2, 1))[: length - 2]
    (prev, last), trail = jax.lax.scan(step, (starts, second), keys)
    cols = [starts[:, None]]
    if length > 2:
        cols.append(jnp.moveaxis(trail, 0, 1))
    cols.append(last[:, None])
    return jnp.concatenate(cols, axis=1)


def node2vec_walks_rejection(
    row_ptr,
    col_idx,
    degree,
    accept,
    alias,
    starts,
    key,
    p,
    q,
    *,
    length,
    max_degree,
    max_tries=None,
    proposals=None,
    edge_weight=None,
    wsum=None,
    envelope=None,
    nbr=None,
    uniform_rows=False,
):
    """Rejection-sampling (p,q) walks (reference `node2vec_walk2 [U]`).

    Proposal: weighted first-order draw from N(cur) via alias tables.
    Accept with prob factor(y)/envelope(y), factor in {1/p, 1, 1/q} by
    the class of y w.r.t. prev. Bounded retries; on overflow the last
    proposal is accepted.

    ``envelope=True`` tightens the proposal with the
    prev-point mixture: the only class whose mass is KNOWN without an
    intersection is {prev} (its weight is the cur->prev edge weight, a
    single `csr_find`), so propose prev explicitly with the excess
    mass a = max(1/p - beta, 0) * w_prev (beta = max(1, 1/q)) and
    everything else from the plain alias draw at envelope beta. The
    per-class acceptance becomes {prev: 1, shared: 1/beta, other:
    (1/q)/beta} — i.e. min(q, 1/q, 1) worst-case, INDEPENDENT of p.
    At the canonical strong bias (p=.25, q=4) the old ub = max(1/p,
    1, 1/q) = 4 form accepted "other" proposals at 1/16; the envelope
    form accepts at 1/4, so the proposal-bound regime needs ~4x fewer
    proposals. ``envelope=False`` keeps the ub form (test oracle).

    ``edge_weight``/``wsum`` (f32 [E_pad] / [V]) feed the prev-mass
    lookup; None means unweighted (w=1, wsum=degree) — callers with
    weighted graphs must pass both or the mixture is mis-weighted.

    Bias note: on retry overflow (all `max_tries` rejected) the last
    proposal stands. ``max_tries=None`` (default) computes the cap
    from the ANALYTIC per-proposal acceptance floor of the active form
    (envelope: min(q, 1/q, 1); ub: min over classes of factor/ub),
    sized for overflow probability <= 1e-3 and clamped to [proposals,
    64]. This is where the envelope's acceptance gain cashes out: at
    the canonical strong bias the ub form needed 107 tries for 1e-3
    overflow (the old fixed 32 ran at ~13% overflow); the envelope
    form needs 24 — fewer retry rounds AND two orders of magnitude
    less overflow bias.

    Round-4 structure (mirrors the distributed rejection engine):
    each retry round draws `proposals` i.i.d. candidates per walker and
    takes the FIRST accepted one — identical distribution to one-at-a-
    time rejection (first acceptance over an i.i.d. proposal stream),
    but the candidate factor evaluation vectorizes across the proposal
    axis and the retry loop is a `while_loop` that exits as soon as
    every walker has accepted: under (p=1, q=1) one round accepts
    everyone; under strong bias (p=.25, q=4: mean ~16 proposals) the
    work is proposal-bound either way.
    """
    # envelope auto rule: the mixture mass needs the cur->prev edge
    # weight, so it is only unbiased when the caller wires
    # edge_weight/wsum (simulate_walks always does) OR the graph is
    # unweighted. Default None enables it exactly when wsum is wired;
    # a bare call on a weighted graph therefore keeps
    # the (weight-agnostic, unbiased) ub form instead of silently
    # mis-weighting the mixture. Explicit True/False always wins.
    if envelope is None:
        envelope = wsum is not None
    # auto-size the proposal batch and retry budget from the active
    # form's ANALYTIC per-proposal acceptance floor, targeting overflow
    # <= ~2e-3 per hop. Preference order: ONE round wide enough to
    # cover the budget (fewer while_loop rounds), else more rounds,
    # capped at 64 total tries. Needs concrete p/q — this wrapper is
    # NOT jitted; the traced core below is.
    import math

    fp, fq = float(p), float(q)
    inv_p_f, inv_q_f = 1.0 / fp, 1.0 / fq
    if envelope:
        beta_f = max(1.0, inv_q_f)
        # per-class acceptance: prev inv_p/max(inv_p, beta), shared
        # 1/beta, other inv_q/beta. The prev term matters when
        # inv_p < beta (p > max(1, q)): the envelope cannot exceed
        # the proposal's own mass there, so prev proposals accept at
        # inv_p/beta < 1 and the budget must cover it (a min(q, 1/q, 1)
        # floor would omit it)
        floor = min(inv_p_f / max(inv_p_f, beta_f),
                    1.0 / beta_f, inv_q_f / beta_f)
    else:
        u = max(inv_p_f, 1.0, inv_q_f)
        floor = min(inv_p_f, 1.0, inv_q_f) / u
    floor = min(max(floor, 1e-6), 1.0 - 1e-9)
    need = max(1, math.ceil(math.log(2e-3) / math.log(1.0 - floor)))
    if proposals is None:
        Pp = int(min(max(need, 8), 32))
    else:
        Pp = max(int(proposals), 1)
    if max_tries is None:
        rounds = max(1, math.ceil(
            math.log(2e-3) / (Pp * math.log(1.0 - floor))))
        max_tries = int(min(rounds * Pp, 64))
    return _node2vec_rejection_core(
        row_ptr, col_idx, degree, accept, alias, starts, key,
        jnp.float32(p), jnp.float32(q), length=length,
        max_degree=max_degree, max_tries=int(max_tries),
        proposals=Pp, edge_weight=edge_weight, wsum=wsum,
        envelope=envelope, nbr=nbr, uniform_rows=bool(uniform_rows))


@partial(jax.jit, static_argnames=("length", "max_degree", "max_tries",
                                   "proposals", "envelope",
                                   "uniform_rows"))
def _node2vec_rejection_core(
    row_ptr, col_idx, degree, accept, alias, starts, key, p, q, *,
    length, max_degree, max_tries, proposals, edge_weight, wsum,
    envelope, nbr, uniform_rows,
):
    inv_p = jnp.float32(1.0 / p)
    inv_q = jnp.float32(1.0 / q)
    ub = jnp.maximum(jnp.maximum(inv_p, 1.0), inv_q)
    beta = jnp.maximum(1.0, inv_q)
    a_coef = jnp.maximum(inv_p - beta, 0.0)
    if wsum is None:
        wsum = degree.astype(jnp.float32)
    Pp = max(int(proposals), 1)
    n_rounds = -(-int(max_tries) // Pp)

    def propose(cur, deg, k):
        k1, k2 = jax.random.split(k)
        u1 = jax.random.uniform(k1, cur.shape)
        u2 = jax.random.uniform(k2, cur.shape)
        slot = alias_draw(
            accept, alias, row_ptr[_safe(cur)], jnp.maximum(deg, 1),
            u1, u2,
        )
        return col_idx[row_ptr[_safe(cur)] + slot]

    def step(carry, k):
        prev, cur = carry
        safe = _safe(cur)
        deg = jnp.where(cur >= 0, degree[safe], 0)
        B = cur.shape[0]
        offs = jnp.broadcast_to(row_ptr[safe][:, None], (B, Pp))
        degb = jnp.broadcast_to(jnp.maximum(deg, 1)[:, None], (B, Pp))
        prevb = jnp.broadcast_to(_safe(prev)[:, None], (B, Pp))

        if envelope:
            # prev-point mixture mass: a = max(1/p - beta, 0) * w_prev,
            # w_prev = weight of the cur->prev edge (0 if absent, e.g.
            # directed graphs) — one csr_find per walker per step
            pfound, ppos = csr_find(
                row_ptr, col_idx, degree, safe, _safe(prev),
                max_degree=max_degree)
            pfound = pfound & (prev >= 0)
            if edge_weight is None:
                w_prev = pfound.astype(jnp.float32)
            else:
                w_prev = jnp.where(
                    pfound,
                    edge_weight[jnp.minimum(
                        ppos, edge_weight.shape[0] - 1)],
                    0.0)
            a = a_coef * w_prev
            denom = a + beta * wsum[safe]
            p_point = a / jnp.maximum(denom, 1e-30)  # [B]

        if nbr is not None:
            # dense-membership mode: ONE padded-row gather of prev's
            # neighbors per STEP, then each round's membership test is
            # pure vector compares. The csr mode costs B*Pp*log2(Dmax)
            # random ELEMENT gathers per ROUND; the dense form trades
            # that for V*Dpad*4 bytes of device memory (ids only, half
            # the exact kernel's footprint).
            nbr_prev = nbr[_safe(prev)]  # [B, Dpad]
        else:
            nbr_prev = None
        if uniform_rows and nbr is not None:
            # unweighted graphs: the alias proposal is uniform over the
            # row, so draw the slot directly and read the candidate
            # from cur's resident neighbor row — 1 element access per
            # proposal instead of the alias path's 3 (accept, alias,
            # col_idx), which dominated the dense round's residual cost
            nbr_cur = nbr[safe]  # [B, Dpad]
        else:
            nbr_cur = None

        def dense_member(cand):
            # any(cand[b, j] == nbr_prev[b, :]) via chunked compares
            D = nbr_prev.shape[1]
            Cc = min(256, D)
            n_chunks = (D + Cc - 1) // Cc

            def chunk(i, acc):
                sl = jax.lax.dynamic_slice_in_dim(
                    nbr_prev, i * Cc, Cc, axis=1)
                return acc | jnp.any(
                    cand[:, :, None] == sl[:, None, :], axis=2)

            return jax.lax.fori_loop(
                0, n_chunks, chunk,
                jnp.zeros(cand.shape, bool))

        def round_body(state):
            done, y, kk, r = state
            kk, kp1, kp2, ka, km = jax.random.split(kk, 5)
            u1 = jax.random.uniform(kp1, (B, Pp))
            if nbr_cur is not None:
                slot = jnp.minimum(
                    (u1 * degb.astype(jnp.float32)).astype(jnp.int32),
                    degb - 1)
                cand = jnp.take_along_axis(nbr_cur, slot, axis=1)
            else:
                u2 = jax.random.uniform(kp2, (B, Pp))
                slot = alias_draw(accept, alias, offs, degb, u1, u2)
                cand = col_idx[offs + slot]  # [B, Pp]
            if envelope:
                take_point = (jax.random.uniform(km, (B, Pp))
                              < p_point[:, None])
                cand = jnp.where(take_point, prevb, cand)
            is_prev = cand == prev[:, None]
            if nbr is not None:
                in_prev = dense_member(cand)
            else:
                in_prev = csr_contains(
                    row_ptr, col_idx, degree, prevb, cand,
                    max_degree=max_degree,
                )
            factor = jnp.where(is_prev, inv_p,
                               jnp.where(in_prev, 1.0, inv_q))
            if envelope:
                env = beta + jnp.where(is_prev, a_coef, 0.0)
            else:
                env = ub
            acc = jax.random.uniform(ka, (B, Pp)) < factor / env
            # first accepted proposal this round; if none accepted,
            # keep the LAST proposal as the overflow fallback
            first = jnp.argmax(acc, axis=1)
            any_acc = jnp.any(acc, axis=1)
            pick = jnp.where(any_acc, first, Pp - 1)
            cand_b = cand[jnp.arange(B), pick]
            y = jnp.where(done, y, cand_b)
            done = done | any_acc
            return done, y, kk, r + 1

        def cond(state):
            done, _y, _k, r = state
            return (r < n_rounds) & ~jnp.all(done)

        done0 = jnp.zeros_like(cur, dtype=bool)
        _, y, _, _ = jax.lax.while_loop(
            cond, round_body,
            (done0, jnp.zeros_like(cur), k, jnp.int32(0)),
        )
        nxt = jnp.where(deg > 0, y, -1)
        return (cur, nxt), cur

    # first hop: plain weighted draw
    k0, krest = jax.random.split(key)
    deg0 = degree[_safe(starts)]
    second = propose(starts, deg0, k0)
    second = jnp.where(deg0 > 0, second, -1)
    if length == 1:
        return starts[:, None]
    keys = jax.random.split(krest, max(length - 2, 1))[: length - 2]
    (prev, last), trail = jax.lax.scan(step, (starts, second), keys)
    cols = [starts[:, None]]
    if length > 2:
        cols.append(jnp.moveaxis(trail, 0, 1))
    cols.append(last[:, None])
    return jnp.concatenate(cols, axis=1)


# --------------------------------------------------------------------------- #
# high-level corpus generation
# --------------------------------------------------------------------------- #


def select_pq_kernel(num_nodes, max_degree, p=1.0, q=1.0,
                     hbm_budget_bytes=4 << 30) -> str:
    """Auto-select the (p,q) kernel: 'exact' or 'rejection'.

    The exact Gumbel-max kernel's cost grows with the padded degree
    Dpad (its membership test is Dpad^2 per hop); the rejection
    kernel's cost is set by how many proposals acceptance needs and is
    near-flat in Dpad. Exact is chosen through Dpad=384, then
    rejection with dense membership (neighbor ids resident), then
    rejection with CSR membership (O(E) memory) once the dense ids
    pass the budget.

    Memory term: the exact kernel needs the [V, Dpad] i32+f32
    neighbor matrix resident (8 bytes/slot); above `hbm_budget_bytes`
    (default 4 GB, leaving room for the corpus and tables) the
    rejection kernels win regardless of speed.

    The Dpad=384 threshold and the 4 GB budget were set before any
    H100 measurement and are unmeasured there
    (`benchmarks/pq_crossover.py` re-measures them; ROADMAP S5, R5).
    """
    dpad = ((max(max_degree, 1) + _LANE - 1) // _LANE) * _LANE
    if dpad <= 384 and num_nodes * dpad * 8 <= hbm_budget_bytes:
        return "exact"
    # past the exact kernel's regime, rejection with DENSE membership
    # (nbr ids resident, V*Dpad*4 bytes — half the exact kernel's
    # footprint since weights stay home) avoids the csr-binary-search
    # membership's B*Pp*log2(Dmax) random element gathers per round;
    # csr mode remains the O(1)-memory fallback
    if num_nodes * dpad * 4 <= hbm_budget_bytes:
        return "rejection_dense"
    return "rejection"


def simulate_walks(
    graph,
    num_walks: int,
    walk_length: int,
    key,
    *,
    kind: str = "uniform",
    p: float = 1.0,
    q: float = 1.0,
    use_rejection_sampling: bool | None = None,
):
    """Generate the full walk corpus `[num_walks * V, walk_length]` (i32).

    Reference counterpart: `RandomWalker.simulate_walks [U]` (joblib over
    nodes). Here all `num_walks × V` walkers run as one batched device
    program; start nodes are every vertex repeated `num_walks` times
    (ordering is irrelevant — the trainer shuffles pairs).

    `use_rejection_sampling=None` (default) auto-selects the (p,q)
    kernel by degree profile and memory (`select_pq_kernel`); True /
    False force the choice (reference flag override).
    """
    dg = graph.device
    starts = jnp.tile(jnp.arange(dg.num_nodes, dtype=jnp.int32), num_walks)

    if kind == "uniform":
        return uniform_walks(
            dg.row_ptr, dg.col_idx, dg.degree, starts, key,
            length=walk_length,
        )
    if kind == "weighted":
        at = graph.alias
        return weighted_walks(
            dg.row_ptr, dg.col_idx, dg.degree, at.accept, at.alias,
            starts, key, length=walk_length,
        )
    if kind == "node2vec":
        dpad = ((max(dg.max_degree, 1) + _LANE - 1) // _LANE) * _LANE
        if use_rejection_sampling is None:
            choice = select_pq_kernel(dg.num_nodes, dg.max_degree, p, q)
        elif not use_rejection_sampling:
            choice = "exact"
        else:
            # explicit rejection (reference flag): still pick the
            # membership mode by the same memory budget auto uses.
            # (Single-card budget: mesh-sharded walks route through
            # parallel.walks' engines, not this kernel, so no n_parts
            # scaling applies here.)
            choice = ("rejection_dense"
                      if dg.num_nodes * dpad * 4 <= (4 << 30)
                      else "rejection")
        if choice in ("rejection", "rejection_dense"):
            at = graph.alias
            # per-node weight sums for the prev-envelope mixture:
            # cumsum + row_ptr boundary gathers (no scatter)
            csum = jnp.concatenate([
                jnp.zeros((1,), jnp.float32),
                jnp.cumsum(dg.edge_weight)])
            wsum = (csum[dg.row_ptr[1:]] - csum[dg.row_ptr[:-1]])
            # ids-only view: materializing the full neighbor_matrix
            # would ALSO put the f32 weight plane in memory, doubling to
            # the exact kernel's footprint and defeating the V*Dpad*4
            # budget gate
            nbr = (graph.neighbor_ids
                   if choice == "rejection_dense" else None)
            # unweighted graph + resident nbr rows: slot-draw proposals
            # (1 element access) replace the alias path (3) — host-side
            # one-time check on the un-padded weights
            import numpy as np

            uniform_rows = nbr is not None and bool(
                np.all(np.asarray(
                    graph.edge_weight[:graph.num_edges]) == 1.0))
            return node2vec_walks_rejection(
                dg.row_ptr, dg.col_idx, dg.degree, at.accept, at.alias,
                starts, key, jnp.float32(p), jnp.float32(q),
                length=walk_length, max_degree=max(dg.max_degree, 1),
                edge_weight=dg.edge_weight, wsum=wsum, nbr=nbr,
                uniform_rows=uniform_rows,
            )
        nm = graph.neighbor_matrix
        return node2vec_walks(
            dg.row_ptr, dg.col_idx, dg.degree, nm.nbr, nm.nbr_w,
            starts, key, jnp.float32(p), jnp.float32(q),
            length=walk_length, max_degree=max(dg.max_degree, 1),
        )
    raise ValueError(f"unknown walk kind: {kind!r}")
