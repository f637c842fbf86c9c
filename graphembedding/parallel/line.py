"""Sharded LINE training step: data parallelism over sampled edge
batches.

New surface area vs the reference (single-host Keras generator,
SURVEY.md §4.3). Each data-axis device draws its own edge/negative
batch (RNG folded by axis index) and scatter-updates its table
replica; every `sync_every` steps the replicas' accumulated deltas
since the last sync are SUMMED (`base + psum(local - base)`) — the
same hogwild-parity semantics as the DP skip-gram mode
(parallel/sgns.py), validated in tests/test_parallel.py. Plain table
averaging instead measured micro-F1 0.375 vs 0.77 on the 120-node
community test: LINE's row updates are sparse, so a pmean divides
each row's delta by n_data (the replicas that never touched the row
contribute stale values).

No tensor-parallel axis: LINE tables are [V, D<=256] — KBs to MBs —
so column-sharding buys nothing; a mesh with model>1 is rejected.
The per-device step body is the single-chip one
(`models.line._make_line_step`), so the math (grouped negative
sharing, update caps, loss) is identical by construction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P


def sharded_line_chunk(
    mesh,
    *,
    chunk_steps,
    batch_size,
    negative,
    order_first,
    k_shared=0,
    update_cap=8.0,
    sync_every=None,
):
    """Build the jitted sharded LINE chunk fn for a given mesh.

    `batch_size` is the GLOBAL batch; each data-axis device runs
    batch_size // n_data pairs per step. Returns fn(emb, ctx, edge_src,
    edge_dst, edge_accept, edge_alias, neg_table, key, lr0, t0,
    total_steps) -> (emb, ctx, losses) with tables replicated.
    """
    from graphembedding.models.line import (
        _line_bulk_samples,
        _make_line_step,
    )

    S = chunk_steps
    n_data = mesh.shape["data"]
    if mesh.shape.get("model", 1) != 1:
        raise ValueError(
            "LINE shards over the data axis only; use a (n, 1) mesh"
        )
    b_local = batch_size // n_data
    if b_local == 0:
        raise ValueError("batch_size must be >= data-axis size")
    if batch_size % n_data:
        # silently shrinking the global batch would desync the
        # steps-per-epoch accounting in LINE.train (n_steps is
        # computed from the requested batch_size)
        raise ValueError(
            f"batch_size ({batch_size}) must divide evenly across the "
            f"data axis ({n_data} devices)"
        )
    # default cadence 4, NOT once-per-chunk: replica staleness over a
    # whole 64-step chunk collapsed wiki-scale LINE to micro-F1 0.09
    # (vs 0.744 at cadence 4, 0.751 at 1, 0.761 single-device)
    sync_every = min(sync_every or 4, S)

    def body(emb, ctx, edge_src, edge_dst, edge_accept, edge_alias,
             neg_table, key, lr0, t0, total_steps):
        di = jax.lax.axis_index("data")
        hs, tposs, tnegs, lrs = _line_bulk_samples(
            edge_src, edge_dst, edge_accept, edge_alias, neg_table,
            jax.random.fold_in(key, di), lr0, t0, total_steps,
            chunk_steps=S, batch_size=b_local, negative=negative,
            k_shared=k_shared,
        )
        inner = _make_line_step(
            batch_size=b_local, negative=negative,
            order_first=order_first, k_shared=k_shared,
            update_cap=update_cap,
        )

        def step(carry, xs):
            (emb, ctx), (emb_b, ctx_b) = carry  # _b: last-sync tables
            h, tpos, tneg, lr, i = xs
            (emb, ctx), loss = inner((emb, ctx), (h, tpos, tneg, lr))

            # hogwild-parity sum of per-replica deltas (see module
            # docstring)
            def _sync(state):
                (emb, ctx), (emb_b, ctx_b) = state
                emb = emb_b + jax.lax.psum(emb - emb_b, "data")
                ctx = ctx_b + jax.lax.psum(ctx - ctx_b, "data")
                return (emb, ctx), (emb, ctx)

            do_sync = (i + 1) % sync_every == 0
            (emb, ctx), (emb_b, ctx_b) = jax.lax.cond(
                do_sync, _sync, lambda s: s,
                ((emb, ctx), (emb_b, ctx_b)),
            )
            return ((emb, ctx), (emb_b, ctx_b)), loss

        ((emb, ctx), (emb_b, ctx_b)), losses = jax.lax.scan(
            step, ((emb, ctx), (emb, ctx)),
            (hs, tposs, tnegs, lrs, jnp.arange(S, dtype=jnp.int32)),
        )
        # final sync (same sum semantics) so returned replicas agree
        emb = emb_b + jax.lax.psum(emb - emb_b, "data")
        ctx = ctx_b + jax.lax.psum(ctx - ctx_b, "data")
        losses = jax.lax.pmean(losses, "data")
        return emb, ctx, losses

    rep = P()
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(rep,) * 11,
        out_specs=(rep, rep, rep),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0, 1))
