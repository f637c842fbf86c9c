"""Sharded hierarchical-softmax training step: DP over walk blocks × TP
over the embedding dimension.

Closes the hs=1 + mesh gap: the reference's exact DeepWalk/Struc2Vec
objective (`Word2Vec(sg=1, hs=1)`, SURVEY.md §9) previously trained
single-chip only. Mapping to the mesh mirrors `parallel/sgns.py`:

- **model axis (TP, exact):** `w_in` [V, D/tp] and the inner-node table
  `w_tree` [V-1, D/tp] are column-sharded. The (center, context-path)
  logits need full-D dots, so each device computes partial
  `[G, PL, PL·T]` logits and a `psum` over `model` completes them — the
  only TP communication. Gradient outer products then use full logits
  with local columns, so updates are exact and local.

- **data axis (DP, hogwild-style):** each data group consumes a
  different slice of the walk block and updates its own table replica;
  every `sync_every` steps the replicas' accumulated deltas since the
  last sync are SUMMED (`base + psum(local - base)`) — hogwild-parity
  semantics: every replica's update lands in full, exactly like
  gensim's racing threads (see parallel/line.py for why plain table
  averaging dilutes sparse row updates by n_data). Validated in
  tests/test_parallel.py.

The per-device compute body is `train.hsoftmax.hs_block_chunk`'s packed
walk-block formulation (P=128//L walks per packed tile, flattened
(context, tree-level) logits axis, per-row update caps); see that
module for the layout rationale.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P


def sharded_hs_chunk(
    mesh,
    *,
    chunk_steps,
    block_walks,
    window,
    update_cap=8.0,
    sync_every=None,
):
    """Build the jitted sharded HS chunk fn for a given mesh.

    Returns fn(w_in, w_tree, walks, points, codes, key, alpha,
    min_alpha, t0, total_steps) -> (w_in, w_tree, losses). Table specs:
    P(None, 'model'); walks/points/codes replicated.
    """
    S, W = chunk_steps, window
    n_data = mesh.shape["data"]
    bw_local = block_walks // n_data
    if bw_local == 0:
        raise ValueError("block_walks must be >= data-axis size")
    # default cadence 4: HS at chunk cadence measured 0.83-0.88
    # micro-F1 on the 120-node community test vs 0.96-1.00 at 4
    sync_every = min(sync_every or 4, S)

    def body(w_in, w_tree, walks, points, codes, key, alpha, min_alpha,
             t0, total_steps):
        di = jax.lax.axis_index("data")
        NW, L = walks.shape
        V, Dl = w_in.shape
        n_inner = w_tree.shape[0]
        T = points.shape[1]
        n_blocks = jnp.maximum(NW // block_walks, 1)

        Pk = max(min(max(128 // L, 1), bw_local), 1)
        G = bw_local // Pk
        PL = Pk * L
        bw_used = G * Pk

        k1 = jax.random.fold_in(jax.random.fold_in(key, t0), di)
        eff = W - (
            jax.random.uniform(k1, (S, G, PL)) * W
        ).astype(jnp.int32).clip(0, W - 1)
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

        def one_step(carry, xs):
            (w_in, w_tree), (w_in_b, w_tree_b) = carry  # _b: last sync
            off, eff_b, lr, i = xs

            tok = jax.lax.dynamic_slice(walks, (off, 0), (bw_used, L))
            tok = tok.reshape(G, PL)
            tok_ok = tok >= 0
            tok_safe = jnp.where(tok_ok, tok, 0)

            yin = w_in[tok_safe]  # [G, PL, Dl] centers
            pts = points[tok_safe]  # [G, PL, T] context paths
            cds = codes[tok_safe]
            pts_ok = (pts >= 0) & tok_ok[:, :, None]
            pts_safe = jnp.where(pts_ok, pts, 0)
            ptv = w_tree[pts_safe]  # [G, PL, T, Dl]

            mask = (
                window_ok[None]
                & (dm[None] <= eff_b[:, :, None])
                & tok_ok[:, :, None]
                & tok_ok[:, None, :]
            ).astype(jnp.float32)

            # flattened (context m, level t) logits axis (see
            # train.hsoftmax); partial over local columns, psum over
            # model completes the full-D dot
            N = PL * T
            ptv_n = ptv.reshape(G, N, Dl)
            logits = jax.lax.psum(
                jnp.einsum("gld,gnd->gln", yin, ptv_n,
                           preferred_element_type=jnp.float32),
                "model",
            )
            label = 1.0 - cds
            gate_n = (
                mask[:, :, :, None] * pts_ok[:, None, :, :]
            ).reshape(G, PL, N)
            gmat = (
                label.reshape(G, 1, N) - jax.nn.sigmoid(logits)
            ) * gate_n

            d_yin = jnp.einsum("gln,gnd->gld", gmat, ptv_n,
                               preferred_element_type=jnp.float32)
            d_tree = jnp.einsum(
                "gln,gld->gnd", gmat, yin,
                preferred_element_type=jnp.float32,
            ).reshape(G, PL, T, Dl)

            # per-row accumulation cap, occupancy through separate 1-D
            # scatters (identical math to train.hsoftmax; the riding-
            # column form paid two gradient-tensor concatenate copies
            # per step — see the note there. The occupancy vectors are
            # computed from indices/mask only, so the scales agree
            # across model shards)
            cap = jnp.float32(update_cap)
            flat = tok_safe.reshape(-1)
            occ_t = jnp.zeros((V,), jnp.float32).at[flat].add(1.0)
            tbuf = jnp.zeros((V, Dl), jnp.float32).at[flat].add(
                d_yin.reshape(-1, Dl)
            )
            tok_scale = jnp.minimum(
                1.0, cap / jnp.maximum(occ_t, 1.0)
            )[:, None]
            n_pairs_ctx = jnp.sum(mask, axis=1)
            tflat = pts_safe.reshape(-1)
            tweight = jnp.broadcast_to(
                n_pairs_ctx[:, :, None], pts_safe.shape
            ).reshape(-1) * pts_ok.reshape(-1)
            occ_r = jnp.zeros((n_inner,), jnp.float32).at[tflat].add(
                tweight
            )
            rbuf = jnp.zeros((n_inner, Dl), jnp.float32).at[tflat].add(
                d_tree.reshape(-1, Dl)
            )
            tree_scale = jnp.minimum(
                1.0, cap / jnp.maximum(occ_r, 1.0)
            )[:, None]

            w_in = w_in + lr * tbuf * tok_scale
            w_tree = w_tree + lr * rbuf * tree_scale

            # hogwild-parity sum of per-replica deltas (see module
            # docstring)
            def _sync(state):
                (w_in, w_tree), (w_in_b, w_tree_b) = state
                w_in = w_in_b + jax.lax.psum(w_in - w_in_b, "data")
                w_tree = w_tree_b + jax.lax.psum(
                    w_tree - w_tree_b, "data"
                )
                return (w_in, w_tree), (w_in, w_tree)

            do_sync = (i + 1) % sync_every == 0
            (w_in, w_tree), (w_in_b, w_tree_b) = jax.lax.cond(
                do_sync, _sync, lambda s: s,
                ((w_in, w_tree), (w_in_b, w_tree_b)),
            )

            sgn = 2.0 * label.reshape(G, 1, N) - 1.0
            ll = jax.nn.log_sigmoid(sgn * logits)
            loss = -jnp.sum(ll * gate_n) / jnp.maximum(
                jnp.sum(mask), 1.0
            )
            return ((w_in, w_tree), (w_in_b, w_tree_b)), loss

        ((w_in, w_tree), (w_in_b, w_tree_b)), losses = jax.lax.scan(
            one_step, ((w_in, w_tree), (w_in, w_tree)),
            (offs, eff, lrs, jnp.arange(S, dtype=jnp.int32)),
        )
        # final sync (same sum semantics) so returned replicas agree
        w_in = w_in_b + jax.lax.psum(w_in - w_in_b, "data")
        w_tree = w_tree_b + jax.lax.psum(w_tree - w_tree_b, "data")
        losses = jax.lax.pmean(losses, "data")
        return w_in, w_tree, losses

    table_spec = P(None, "model")
    rep = P()
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(table_spec, table_spec, rep, rep, rep, rep, rep, rep,
                  rep, rep),
        out_specs=(table_spec, table_spec, rep),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0, 1))
