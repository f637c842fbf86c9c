"""User-facing distributed SGNS trainer over a device mesh.

Bridges the model layer to the sharded training chunks so the
reference-shaped API runs multi-chip with one extra argument:

    mesh = make_mesh()                      # (data, model) over devices
    DeepWalk(G, ...).train(mesh=mesh)       # trains over the mesh

Two modes (see parallel/sgns.py and parallel/rowshard.py for the
designs and their exchange patterns):

- 'rowshard' (default): ONE global table partitioned by vertex across
  the data axis; exact synchronous updates. The right mode when the
  table is large or exactness matters.
- 'dp': per-replica tables, periodic averaging (hogwild analogue),
  optional column-TP over the model axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from graphembedding.train.skipgram import (
    SkipGramConfig,
    _device_prep,
    _shuffle_walks,
)


class DistributedSkipGramTrainer:
    """SkipGramTrainer equivalent running on a `jax.sharding.Mesh`."""

    def __init__(self, mesh, config: SkipGramConfig | None = None,
                 mode: str = "rowshard", **kw):
        if mode not in ("rowshard", "dp"):
            raise ValueError("mode must be 'rowshard' or 'dp'")
        self.mesh = mesh
        self.mode = mode
        self.config = config or SkipGramConfig(**kw)

    def fit(self, walks, num_nodes, key=None, checkpoint_dir=None,
            checkpoint_every=0, metrics=None):
        """Train over the mesh; supports the single-chip trainer's
        checkpoint/resume and metrics hooks (SURVEY.md §6)."""
        cfg = self.config
        mesh = self.mesh
        n = mesh.shape["data"]
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        k_init, k_shuf, k_train, k_sub = jax.random.split(key, 4)

        from graphembedding.parallel.mesh import put_global
        from jax.sharding import PartitionSpec as _P

        # multi-process meshes: corpus must be a GLOBAL (replicated)
        # array; single-process this is a device-side put/reshard
        walks = put_global(walks, mesh, _P())
        NW, L = walks.shape
        if NW < n:
            raise ValueError(
                f"corpus has {NW} walks but the mesh data axis has "
                f"{n} devices — use a smaller mesh or more walks"
            )
        # large-corpus block upscale as in the single-chip trainer
        # (plan_block_walks: 4x/8x blocks hide scatter latency at big
        # V — quality-validated; conservative here too:
        # the 6 GB table gate uses the FULL table even though rowshard
        # only holds V/n rows per chip), then the mesh caps: at least
        # the data axis, and (NW//n)*n so every device's slice holds
        # REAL walks (dynamic_slice would silently clamp onto
        # duplicated rows)
        from graphembedding.train.skipgram import block_upscale

        bw = min(block_upscale(NW, num_nodes, cfg),
                 max(NW // 4, n), (NW // n) * n)
        from graphembedding.train.skipgram import (
            _gather_keep,
            _prepare_epoch,
        )

        # device-resident prep (counts/table/keep never cross to host
        # — see train.skipgram._device_prep)
        _, table, keep = _device_prep(
            walks,
            num_nodes=num_nodes,
            size=cfg.neg_table_size,
            exponent=cfg.ns_exponent,
            sample=cfg.sample,
        )
        keep_tok = None if keep is None else _gather_keep(walks, keep)
        # steps per epoch from the per-device packing actually used
        pk = max(min(max(128 // L, 1), max(bw // n, 1)), 1)
        bw_used = max((max(bw // n, 1) // pk) * pk, pk) * n
        steps_per_epoch = max(NW // bw_used, 1)
        chunks_per_epoch = max(
            (steps_per_epoch + cfg.chunk_steps - 1) // cfg.chunk_steps, 1
        )
        # LR decays over steps actually executed (each chunk runs
        # chunk_steps steps, wrapping over blocks — see train.skipgram)
        n_steps = cfg.epochs * chunks_per_epoch * cfg.chunk_steps
        total_steps = jnp.float32(n_steps)

        D = cfg.embed_size
        w_in = (
            jax.random.uniform(k_init, (num_nodes, D)) - 0.5
        ) / D
        w_out = jnp.zeros((num_nodes, D), jnp.float32)

        if self.mode == "rowshard":
            from graphembedding.parallel.rowshard import (
                rowsharded_sgns_chunk,
            )

            Vp = ((num_nodes + n - 1) // n) * n
            w_cat = jnp.zeros((Vp, 2 * D), jnp.float32)
            w_cat = w_cat.at[:num_nodes, :D].set(w_in)
            fn = rowsharded_sgns_chunk(
                mesh, chunk_steps=cfg.chunk_steps, block_walks=bw,
                window=cfg.window, negative=cfg.negative,
                k_shared=min(cfg.k_shared, num_nodes),
                update_cap=cfg.update_cap,
                neg_share_packs=cfg.neg_share_packs,
                prefetch=cfg.rowshard_prefetch,
            )
        else:
            from graphembedding.parallel.sgns import (
                sharded_sgns_chunk,
            )

            fn = sharded_sgns_chunk(
                mesh, chunk_steps=cfg.chunk_steps, block_walks=bw,
                window=cfg.window, negative=cfg.negative,
                k_shared=min(cfg.k_shared, num_nodes),
                neg_share_walks=cfg.neg_share_walks,
                update_cap=cfg.update_cap,
                neg_share_packs=cfg.neg_share_packs,
                sync_every=cfg.dp_sync_every or None,
            )

        # sharded (global-array) checkpointing: tables are saved and
        # restored WITH their shardings via Orbax — each process
        # touches only its own shards, so the same code path is
        # multi-host-correct (no host gather)
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        if self.mode == "rowshard":
            # match rowsharded_sgns_chunk's specs: rows over 'data'
            # (put_global: multi-process safe, device put single-proc)
            w_cat = put_global(w_cat, mesh, P("data", None))
        else:
            # match sharded_sgns_chunk's table spec: columns over
            # 'model', replicated over 'data'
            w_in = put_global(w_in, mesh, P(None, "model"))
            w_out = put_global(w_out, mesh, P(None, "model"))

        resume_step = 0
        if checkpoint_dir:
            from graphembedding.utils.checkpoint import (
                try_restore_sharded,
            )

            if self.mode == "rowshard":
                template = {"w_cat": w_cat, "step": np.asarray(0)}
            else:
                template = {"w_in": w_in, "w_out": w_out,
                            "step": np.asarray(0)}
            state = try_restore_sharded(checkpoint_dir, template)
            if state is not None:
                if self.mode == "rowshard":
                    w_cat = state["w_cat"]
                else:
                    w_in = state["w_in"]
                    w_out = state["w_out"]
                resume_step = int(state["step"])


        losses = []
        t = 0
        n_calls = 0
        epoch_steps = chunks_per_epoch * cfg.chunk_steps
        with mesh:
            for epoch in range(cfg.epochs):
                if t + epoch_steps <= resume_step:
                    t += epoch_steps  # fully-resumed epoch: skip the
                    continue  # corpus shuffle too
                if keep_tok is not None:
                    shuffled = _prepare_epoch(
                        walks, keep_tok, jax.random.fold_in(k_sub, epoch)
                    )
                else:
                    shuffled = _shuffle_walks(
                        walks, jax.random.fold_in(k_shuf, epoch)
                    )
                for _ in range(chunks_per_epoch):
                    if t < resume_step:
                        t += cfg.chunk_steps
                        continue
                    if self.mode == "rowshard":
                        w_cat, l = fn(
                            w_cat, shuffled, table, k_train,
                            jnp.float32(cfg.alpha),
                            jnp.float32(cfg.min_alpha),
                            jnp.int32(t), total_steps,
                        )
                    else:
                        w_in, w_out, l = fn(
                            w_in, w_out, shuffled, table, k_train,
                            jnp.float32(cfg.alpha),
                            jnp.float32(cfg.min_alpha),
                            jnp.int32(t), total_steps,
                        )
                    losses.append(l)
                    t += cfg.chunk_steps
                    n_calls += 1
                    if metrics is not None:
                        metrics.log(
                            kind="sgns_chunk_dist", epoch=epoch, step=t,
                            loss=round(float(l.mean()), 5),
                        )
                    if checkpoint_dir and checkpoint_every:
                        from graphembedding.utils.checkpoint import (
                            maybe_save,
                        )

                        def _state():
                            # device arrays saved WITH their shardings
                            # (see the restore path above)
                            s = {"step": np.asarray(t)}
                            if self.mode == "rowshard":
                                s["w_cat"] = w_cat
                            else:
                                s["w_in"] = w_in
                                s["w_out"] = w_out
                            return s

                        maybe_save(checkpoint_dir, checkpoint_every,
                                   n_calls, _state)
        if not losses:
            losses = [jnp.zeros((0,), jnp.float32)]
        if self.mode == "rowshard":
            if jax.process_count() > 1:
                from jax.experimental import multihost_utils

                w_cat = multihost_utils.process_allgather(
                    w_cat, tiled=True
                )
            else:
                w_cat = jax.device_get(w_cat)
            w_in = jnp.asarray(w_cat[:num_nodes, :D])
            w_out = jnp.asarray(w_cat[:num_nodes, D:])
        return w_in, w_out, jnp.concatenate(losses)
