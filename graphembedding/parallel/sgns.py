"""Sharded SGNS training step: DP over walk blocks × TP over embed dim.

New surface area vs the reference (its only parallelism was hogwild
threads inside gensim, SURVEY.md §3.3). Mapping to the mesh:

- **model axis (TP, exact):** tables are column-sharded `[V, D/tp]`.
  Pair/negative logits need the full-D dot product, so each device
  computes its partial `[G, PL, PL]` / `[G, PL, K]` logits and a
  `psum` over `model` completes them — the only TP communication,
  O(G·PL·(PL+K)) floats per step, riding the interconnect. All gradient outer
  products then use the *full* logits with *local* columns, so table
  updates are exact and local.

- **data axis (DP, hogwild-style):** each data group consumes a
  different slice of the walk block and scatter-updates its own table
  replica; every `sync_every` steps the replicas' accumulated deltas
  since the last sync are SUMMED (`base + psum(local - base)`). This
  is the cross-device analogue of the reference's lock-free hogwild
  (gensim threads race on one table and every thread's update lands):
  exact sequential mass on rows touched by one replica, hogwild-style
  racing sums on rows hot across replicas. Exactness is deliberately
  traded the same way hogwild trades it; quality is validated in
  tests (`tests/test_parallel.py`).

The per-device compute body uses the same packed walk-block
formulation as the single-chip path (`train.skipgram.sgns_block_chunk`
— P=128//L walks per packed tile, group-shared negatives, per-row update
caps); see that module for the performance rationale.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from graphembedding.train.skipgram import MATMUL_PRECISION


def sharded_sgns_chunk(
    mesh,
    *,
    chunk_steps,
    block_walks,
    window,
    negative,
    k_shared,
    neg_share_walks=8,
    sync_every=None,
    update_cap=8.0,
    neg_share_packs=4,
):
    """Build the jitted sharded chunk fn for a given mesh.

    Returns fn(w_in, w_out, walks, neg_table, key, alpha, min_alpha, t0,
    total_steps) -> (w_in, w_out, losses). Table specs: P(None, 'model')
    (replicated over data, column-sharded over model). Walks/neg_table
    replicated (wiki-scale corpora are MBs; the edge-partitioned walk
    path in parallel/walks.py covers graphs that don't fit).
    """
    del neg_share_walks  # superseded by the packing group (see below)
    S, W, K = chunk_steps, window, k_shared
    n_data = mesh.shape["data"]
    bw_local = block_walks // n_data
    if bw_local == 0:
        raise ValueError("block_walks must be >= data-axis size")
    # replica staleness is the dp quality lever: on the 120-node
    # community test, once-per-chunk(64) sync measured micro-F1 0.54
    # vs 0.98 at cadence 4 or 1 (and LINE at wiki scale collapsed to
    # 0.09 at chunk cadence). Default 4 = no measured loss vs 1, with
    # the table allreduce amortized 4x
    sync_every = min(sync_every or 4, S)

    def body(w_in, w_out, walks, neg_table, key, alpha, min_alpha, t0,
             total_steps):
        di = jax.lax.axis_index("data")
        NW, L = walks.shape
        V, Dl = w_in.shape
        n_blocks = NW // block_walks

        # packed layout: P walks per packed tile (see train.skipgram)
        Pk = max(min(max(128 // L, 1), bw_local), 1)
        G = bw_local // Pk
        PL = Pk * L
        bw_used = G * Pk
        nsp = max(int(neg_share_packs), 1)
        while G % nsp:  # whole sharing groups only; fall back toward 1
            nsp -= 1
        G2 = G // nsp  # negative-sharing groups (see train.skipgram)

        k1, k2 = jax.random.split(jax.random.fold_in(key, t0))
        eff = W - (
            jax.random.uniform(k1, (S, G, PL)) * W
        ).astype(jnp.int32).clip(0, W - 1)
        k2 = jax.random.fold_in(k2, di)  # independent negs per shard
        neg_idx = jax.random.randint(
            k2, (S, G2, K), 0, neg_table.shape[0], dtype=jnp.int32
        )
        negs = neg_table[neg_idx]
        steps = t0 + jnp.arange(S, dtype=jnp.int32)
        lrs = jnp.maximum(
            min_alpha,
            alpha * (1.0 - steps.astype(jnp.float32) / total_steps),
        )
        offs = (steps % n_blocks) * block_walks + di * bw_local

        igrid = jax.lax.broadcasted_iota(jnp.int32, (PL, PL), 0)
        jgrid = jax.lax.broadcasted_iota(jnp.int32, (PL, PL), 1)
        same_walk = (igrid // L) == (jgrid // L)
        dm = jnp.abs(jgrid % L - igrid % L)
        window_ok = same_walk & (dm >= 1) & (dm <= W)
        neg_w = jnp.float32(negative) / K

        # fused [V, 2Dl] local table — one gather/scatter per token
        # instead of two, occupancy counts riding the gradient scatter;
        # same row-issue economy as train.skipgram (see there)
        w_cat0 = jnp.concatenate([w_in, w_out], axis=1)

        def one_step(carry, xs):
            w_cat, w_base = carry  # w_base: table at the last DP sync
            off, eff_b, neg, lr, i = xs  # neg: [G2, K]

            tok = jax.lax.dynamic_slice(walks, (off, 0), (bw_used, L))
            tok = tok.reshape(G, PL)
            tok_ok = tok >= 0
            tok_safe = jnp.where(tok_ok, tok, 0)

            y = w_cat[tok_safe]  # [G, PL, 2Dl]
            yin = y[..., :Dl]
            yout = y[..., Dl:]
            vn = w_cat[neg][..., Dl:]  # [G2, K, Dl]

            # partial logits over local columns; psum over model
            logits = jax.lax.psum(
                jnp.einsum("gld,gmd->glm", yin, yout,
                           preferred_element_type=jnp.float32,
                           precision=MATMUL_PRECISION),
                "model",
            )
            yin_n = yin.reshape(G2, nsp * PL, Dl)
            nlog = jax.lax.psum(
                jnp.einsum("gld,gkd->glk", yin_n, vn,
                           preferred_element_type=jnp.float32,
                           precision=MATMUL_PRECISION),
                "model",
            )
            mask = (
                window_ok[None]
                & (dm[None] <= eff_b[:, :, None])
                & tok_ok[:, :, None]
                & tok_ok[:, None, :]
            ).astype(jnp.float32)
            g_pos = (jax.nn.sigmoid(logits) - 1.0) * mask
            n_pairs = jnp.sum(mask, axis=2)
            np_n = n_pairs.reshape(G2, nsp * PL)
            tok_n = tok_safe.reshape(G2, nsp * PL)
            neg_ok = (neg[:, None, :] != tok_n[:, :, None]).astype(
                jnp.float32
            )
            g_neg = (
                jax.nn.sigmoid(nlog)
                * (np_n * neg_w)[:, :, None]
                * neg_ok
            )

            d_yin = jnp.einsum("glm,gmd->gld", g_pos, yout,
                               preferred_element_type=jnp.float32,
                               precision=MATMUL_PRECISION)
            d_yin = d_yin + jnp.einsum(
                "glk,gkd->gld", g_neg, vn,
                preferred_element_type=jnp.float32,
                precision=MATMUL_PRECISION,
            ).reshape(G, PL, Dl)
            d_yout = jnp.einsum("glm,gld->gmd", g_pos, yin,
                                preferred_element_type=jnp.float32,
                                precision=MATMUL_PRECISION)
            d_vn = jnp.einsum("glk,gld->gkd", g_neg, yin_n,
                              preferred_element_type=jnp.float32,
                              precision=MATMUL_PRECISION)

            # per-row accumulation cap — see train.skipgram
            cap = jnp.float32(update_cap)
            flat = tok_safe.reshape(-1)
            d_tok = jnp.concatenate(
                [
                    d_yin.reshape(-1, Dl),
                    d_yout.reshape(-1, Dl),
                    jnp.ones((G * PL, 1), jnp.float32),
                ],
                axis=1,
            )
            tbuf = (
                jnp.zeros((V, 2 * Dl + 1), jnp.float32).at[flat].add(d_tok)
            )
            tok_scale = jnp.minimum(
                1.0, cap / jnp.maximum(tbuf[:, 2 * Dl], 1.0)
            )[:, None]
            nflat = neg.reshape(-1)
            neg_weight = jnp.broadcast_to(
                jnp.sum(np_n * neg_w, axis=1)[:, None], (G2, K)
            ).reshape(-1)
            d_neg = jnp.concatenate(
                [d_vn.reshape(-1, Dl), neg_weight[:, None]], axis=1
            )
            nbuf = (
                jnp.zeros((V, Dl + 1), jnp.float32).at[nflat].add(d_neg)
            )
            neg_scale = jnp.minimum(
                1.0, cap / jnp.maximum(nbuf[:, Dl], 1.0)
            )[:, None]

            w_cat = w_cat + (-lr) * tbuf[:, : 2 * Dl] * tok_scale
            w_cat = w_cat.at[:, Dl:].add(
                (-lr) * nbuf[:, :Dl] * neg_scale
            )

            # periodic DP sync with hogwild-parity SUM semantics:
            # every replica's accumulated delta since the last sync
            # lands in full (psum), exactly like gensim's racing
            # threads. Plain pmean of tables instead would divide each
            # sparse row delta by n_data (only the replicas that
            # touched a row contribute non-stale values) — measured as
            # a quality collapse on sparse workloads (parallel/line.py)
            def _sync(wb):
                w_cat, w_base = wb
                w_cat = w_base + jax.lax.psum(w_cat - w_base, "data")
                return w_cat, w_cat

            do_sync = (i + 1) % sync_every == 0
            w_cat, w_base = jax.lax.cond(
                do_sync, _sync, lambda wb: wb, (w_cat, w_base)
            )

            n_tot = jnp.maximum(jnp.sum(mask), 1.0)
            loss = -(
                jnp.sum(jax.nn.log_sigmoid(logits) * mask)
                + jnp.sum(jax.nn.log_sigmoid(-nlog)
                          * (np_n * neg_w)[:, :, None] * neg_ok)
            ) / n_tot
            return (w_cat, w_base), loss

        (w_cat, w_base), losses = jax.lax.scan(
            one_step,
            (w_cat0, w_cat0),
            (offs, eff, negs, lrs, jnp.arange(S, dtype=jnp.int32)),
        )
        # final sync (same sum semantics) so returned replicas agree
        w_cat = w_base + jax.lax.psum(w_cat - w_base, "data")
        losses = jax.lax.pmean(losses, "data")
        return w_cat[:, :Dl], w_cat[:, Dl:], losses

    table_spec = P(None, "model")
    rep = P()
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(table_spec, table_spec, rep, rep, rep, rep, rep, rep,
                  rep),
        out_specs=(table_spec, table_spec, rep),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0, 1))
