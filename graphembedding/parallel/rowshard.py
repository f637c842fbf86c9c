"""Row-sharded SGNS: one global embedding table, partitioned by vertex.

SURVEY.md §3.3's third gradient-sync mode — "sharded tables +
all-to-all of (index, grad) pairs for embedding rows owned elsewhere" —
and the mode that scales the VERTEX dimension: each device owns rows
[lo, hi) of the fused [V, 2D] table, so a table that exceeds one card's
memory spreads over the mesh. The reference has no analogue (its largest
table is KBs; SURVEY.md §3.3).

Exchange pattern (all static shapes, collectives only):

- fetch: every device `all_gather`s its needed row ids (int32 — cheap),
  each owner contributes its owned rows for every requester, and one
  `psum_scatter` returns to each device exactly its requested rows
  (each row has a unique owner, so the sum is a select).
- update: gradients for the same ids (plus the occupancy-count column
  riding along, see train.skipgram) are `all_gather`ed back; each owner
  scatter-adds the entries it owns and applies the per-row cap as a
  dense rowwise multiply over its shard — the cap therefore sees the
  GLOBAL per-row occupancy, and every step is an exact synchronous
  update of the single global table (no replica drift, no pmean):
  semantically identical to the single-chip trainer at n× the block
  throughput.

Comm volume per step per device: O(n·T) int32 ids + O(n·T·D) floats
(T = tokens + negatives per device). The id-bucketed variant would cut
the float volume to O(T·D) at the price of dynamic bucketing + overflow
bias (the distributed-walk engine in parallel/walks.py shows that
pattern); at D=128 the gathered form is expected to stay comm-light
over NVLink for four cards (unmeasured; ROADMAP R7), and XLA can
overlap the all_gather with the preceding step's compute.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P


def gather_ids(ids, lo, Vp, axis_name):
    """all_gather row ids once; precompute owner-local views.

    Returns (local [n, T], owned [n, T]) — reused by fetch and push so
    the int32 id exchange crosses the mesh exactly once per step.
    """
    ids_all = jax.lax.all_gather(ids, axis_name)  # [n, T]
    local = ids_all - lo
    owned = (local >= 0) & (local < Vp)
    return local, owned


def fetch_rows_with(w_local, local, owned, axis_name):
    """Fetch global table rows from their owner shards.

    w_local: [Vp, C] this device's row shard; (local, owned) from
    `gather_ids`. Returns [T, C] rows of the global table for THIS
    device's requested ids.
    """
    Vp = w_local.shape[0]
    rows = jnp.where(
        owned[..., None], w_local[jnp.clip(local, 0, Vp - 1)], 0.0
    )  # [n, T, C]
    # device j's block of the scatter = sum over owners of rows[j]
    # — exactly its requested rows (each id has one owner); tiled
    # scatter leaves a leading block axis of size 1 to squeeze
    return jax.lax.psum_scatter(
        rows, axis_name, scatter_dimension=0, tiled=True
    )[0]


def push_grads_with(Vp, dtype, local, owned, grads, axis_name):
    """Scatter-add every device's gradient rows into the owners' shards.

    grads: [T, C] this device's gradient rows, aligned with the ids
    passed to `gather_ids`. Returns ONLY the [Vp, C] accumulation
    buffer — callers apply lr/cap scaling densely and add it to the
    shard themselves.
    """
    grads_all = jax.lax.all_gather(grads, axis_name)  # [n, T, C]
    flat = jnp.where(owned, local, Vp).reshape(-1)  # Vp = drop slot
    buf = jnp.zeros((Vp + 1, grads.shape[-1]), dtype)
    buf = buf.at[flat].add(grads_all.reshape(flat.shape[0], -1))
    return buf[:Vp]


def fetch_rows(w_local, ids, lo, axis_name):
    """One-shot fetch (see fetch_rows_with)."""
    local, owned = gather_ids(ids, lo, w_local.shape[0], axis_name)
    return fetch_rows_with(w_local, local, owned, axis_name)


def push_grads(w_local, ids, grads, lo, axis_name):
    """One-shot push (see push_grads_with). Returns ONLY the buffer."""
    local, owned = gather_ids(ids, lo, w_local.shape[0], axis_name)
    return push_grads_with(
        w_local.shape[0], w_local.dtype, local, owned, grads, axis_name
    )


def rowsharded_sgns_chunk(
    mesh,
    *,
    chunk_steps,
    block_walks,
    window,
    negative,
    k_shared,
    update_cap=8.0,
    neg_share_packs=4,
    prefetch=False,
):
    """Build the jitted row-sharded chunk fn over `mesh`'s data axis.

    Returns fn(w_cat [V, 2D] sharded P('data', None), walks, neg_table,
    key, alpha, min_alpha, t0, total_steps) -> (w_cat, losses).
    Requires V divisible by the data-axis size (pad the vocab).
    Each device consumes its own slice of every walk block; the
    requested block is clamped to the corpus and rounded down to whole
    packing groups per device, and block offsets stride by the rounded
    global size, so every corpus walk is trained (nothing is dropped to
    rounding).

    `prefetch=True` is SURVEY §8.4-6's double-buffered halo: step t+1's
    row FETCH (the all_gather(ids) + psum_scatter exchange) is issued
    against the table BEFORE step t's update lands, so it carries no
    data dependence on step t's push and the scheduler can hide the
    fetch under step t's einsums. The cost is one step of row
    staleness (the hogwild trade, bounded like dp-mode's sync_every=1
    — quality-gated on the community test in tests/test_parallel.py).
    On the shared-memory CPU mesh collectives and compute use the same
    cores, so no speedup is measurable there; the flag exists for real
    interconnects, where async collectives overlap compute (unmeasured
    on H100s). Default off: the exact
    synchronous update is rowshard's contract.
    """
    S, W, K = chunk_steps, window, k_shared
    n = mesh.shape["data"]
    if block_walks // n == 0:
        raise ValueError("block_walks must be >= data-axis size")

    def body(w_cat, walks, neg_table, key, alpha, min_alpha, t0,
             total_steps):
        di = jax.lax.axis_index("data")
        NW, L = walks.shape
        Vp, C = w_cat.shape  # local shard; C = 2D
        D = C // 2
        lo = di * Vp
        if NW < n:
            raise ValueError(
                f"walk corpus ({NW}) smaller than data axis ({n})"
            )
        # clamp the requested block to the corpus, pack, and stride the
        # block offsets by the USED sizes so no walk is ever dropped
        bw_local = max(min(block_walks, NW) // n, 1)
        Pk = max(min(max(128 // L, 1), bw_local), 1)
        G = bw_local // Pk
        PL = Pk * L
        bw_used = G * Pk  # per-device walks actually trained per step
        global_bw = n * bw_used
        n_blocks = max(NW // global_bw, 1)
        nsp = max(int(neg_share_packs), 1)
        while G % nsp:  # whole sharing groups only; fall back toward 1
            nsp -= 1
        G2 = G // nsp  # negative-sharing groups (see train.skipgram)

        k1, k2 = jax.random.split(jax.random.fold_in(key, t0))
        eff = W - (
            jax.random.uniform(jax.random.fold_in(k1, di), (S, G, PL)) * W
        ).astype(jnp.int32).clip(0, W - 1)
        neg_idx = jax.random.randint(
            jax.random.fold_in(k2, di), (S, G2, K), 0,
            neg_table.shape[0], dtype=jnp.int32,
        )
        negs = neg_table[neg_idx]
        steps = t0 + jnp.arange(S, dtype=jnp.int32)
        lrs = jnp.maximum(
            min_alpha,
            alpha * (1.0 - steps.astype(jnp.float32) / total_steps),
        )
        offs = (steps % n_blocks) * global_bw + di * bw_used

        igrid = jax.lax.broadcasted_iota(jnp.int32, (PL, PL), 0)
        jgrid = jax.lax.broadcasted_iota(jnp.int32, (PL, PL), 1)
        same_walk = (igrid // L) == (jgrid // L)
        dm = jnp.abs(jgrid % L - igrid % L)
        window_ok = same_walk & (dm >= 1) & (dm <= W)
        neg_w = jnp.float32(negative) / K

        from graphembedding.train.skipgram import (
            sgns_block_grads_xla,
        )

        def ids_of(off, neg):
            """Token block + id exchange prep for one step (the id
            exchange is shared by the row fetch and both pushes)."""
            tok = jax.lax.dynamic_slice(walks, (off, 0), (bw_used, L))
            tok = tok.reshape(G, PL)
            tok_safe = jnp.where(tok >= 0, tok, 0)
            ids = jnp.concatenate(
                [tok_safe.reshape(-1), neg.reshape(-1)]
            )  # [T]
            local, owned = gather_ids(ids, lo, Vp, "data")
            return tok, local, owned

        def compute_push(w_cat, tok, local, owned, rows, eff_b, neg,
                         lr):
            """Gradients from (possibly prefetched) rows; exact pushes."""
            tok_ok = tok >= 0
            tok_safe = jnp.where(tok_ok, tok, 0)
            Tt = G * PL
            y = rows[: G * PL].reshape(G, PL, C)
            yin = y[..., :D]
            yout = y[..., D:]
            vn = rows[G * PL :, D:].reshape(G2, K, D)

            mask = (
                window_ok[None]
                & (dm[None] <= eff_b[:, :, None])
                & tok_ok[:, :, None]
                & tok_ok[:, None, :]
            ).astype(jnp.float32)
            n_pairs = jnp.sum(mask, axis=2)
            tok_n = tok_safe.reshape(G2, nsp * PL)
            neg_ok = (neg[:, None, :] != tok_n[:, :, None]).astype(
                jnp.float32
            )

            d_yin, d_yout, d_vn, loss_g = sgns_block_grads_xla(
                yin, yout, vn, mask, neg_ok, neg_w
            )

            # (grad, occupancy-weight) rows back to their owners —
            # token and negative events pushed separately because each
            # carries its own cap statistic (same as train.skipgram's
            # tbuf/nbuf split)
            cap = jnp.float32(update_cap)
            g_tok = jnp.concatenate(
                [
                    d_yin.reshape(-1, D),
                    d_yout.reshape(-1, D),
                    jnp.ones((G * PL, 1), jnp.float32),
                ],
                axis=1,
            )
            tbuf = push_grads_with(
                Vp, w_cat.dtype, local[:, :Tt], owned[:, :Tt], g_tok,
                "data",
            )  # [Vp, 2D+1]
            tok_scale = jnp.minimum(
                1.0, cap / jnp.maximum(tbuf[:, C], 1.0)
            )[:, None]
            w_cat = w_cat + (-lr) * tbuf[:, :C] * tok_scale

            neg_weight = jnp.broadcast_to(
                jnp.sum(
                    n_pairs.reshape(G2, nsp * PL) * neg_w, axis=1
                )[:, None],
                (G2, K),
            ).reshape(-1)
            g_neg = jnp.concatenate(
                [d_vn.reshape(-1, D), neg_weight[:, None]], axis=1
            )
            nbuf = push_grads_with(
                Vp, w_cat.dtype, local[:, Tt:], owned[:, Tt:], g_neg,
                "data",
            )  # [Vp, D+1]
            neg_scale = jnp.minimum(
                1.0, cap / jnp.maximum(nbuf[:, D], 1.0)
            )[:, None]
            w_cat = w_cat.at[:, D:].add(
                (-lr) * nbuf[:, :D] * neg_scale
            )

            n_tot = jnp.maximum(jnp.sum(mask), 1.0)
            loss = jax.lax.psum(jnp.sum(loss_g), "data") / jax.lax.psum(
                n_tot, "data"
            )
            return w_cat, loss

        if not prefetch:
            def one_step(carry, xs):
                w_cat = carry
                off, eff_b, neg, lr = xs
                tok, local, owned = ids_of(off, neg)
                rows = fetch_rows_with(w_cat, local, owned, "data")
                return compute_push(
                    w_cat, tok, local, owned, rows, eff_b, neg, lr
                )

            w_cat, losses = jax.lax.scan(
                one_step, w_cat, (offs, eff, negs, lrs)
            )
            return w_cat, losses

        # double-buffered halo (see docstring): the fetch for step t+1
        # is issued against w_cat BEFORE step t's pushes land — no data
        # dependence on the update, so it can hide under the einsums;
        # rows are one step stale (quality-gated)
        def one_step_pf(carry, xs):
            w_cat, tok, local, owned, rows = carry
            eff_b, neg, lr, off_n, neg_n = xs
            tok_n, local_n, owned_n = ids_of(off_n, neg_n)
            rows_n = fetch_rows_with(w_cat, local_n, owned_n, "data")
            w_cat, loss = compute_push(
                w_cat, tok, local, owned, rows, eff_b, neg, lr
            )
            return (w_cat, tok_n, local_n, owned_n, rows_n), loss

        tok0, local0, owned0 = ids_of(offs[0], negs[0])
        rows0 = fetch_rows_with(w_cat, local0, owned0, "data")
        offs_n = jnp.roll(offs, -1)
        negs_n = jnp.roll(negs, -1, axis=0)
        (w_cat, _t, _l, _o, _r), losses = jax.lax.scan(
            one_step_pf,
            (w_cat, tok0, local0, owned0, rows0),
            (eff, negs, lrs, offs_n, negs_n),
        )
        return w_cat, losses

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P("data"), P(), P(), P(), P(), P(), P(), P()),
        out_specs=(P("data"), P()),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0,))
