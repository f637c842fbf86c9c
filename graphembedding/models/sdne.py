"""SDNE (Wang et al., KDD'16) — deep autoencoder over adjacency rows.

Reference counterpart: `ge/models/sdne.py [U]` (Keras/TF1): encoder
`A_row -> Dense(256) relu -> Dense(128) relu = Y`, decoder mirrored back to
`V` with relu, trained with
  - `l_2nd`: B-weighted reconstruction `mean_b sum((A-A_hat)*b)^2` with
    b = beta where A != 0 else 1,
  - `l_1st`: `alpha * 2 * tr(Y^T L Y) / batch`, L = D - W on the
    *symmetrized* adjacency,
  - L1+L2 weight regularization (nu1, nu2),
  full-batch `fit` when batch_size >= V else a manual `train_on_batch`
  loop over row chunks with the `L[idx][:,idx]` sub-block.

Device redesign: the model is a pure-JAX MLP (params pytree + optax.adam)
whose whole epoch loop is jit-compiled; the adjacency lives on device once
(dense for wiki-scale; `ops.spmm` BCOO path for larger graphs) and batches
are device-side row gathers — no host round-trip per batch. The first
encoder layer consumes adjacency rows directly, so full-batch mode is one
[V,V]x[V,256] matmul.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np
import optax

from graphembedding.models.base import as_graph

# SDNE's dense float32 products run at DEFAULT precision: TF32 on the
# H100's tensor cores (10-bit mantissa, float32 accumulation), full
# float32 on the CPU. The per-layer parity forward below takes HIGHEST.
MATMUL_PRECISION = jax.lax.Precision.DEFAULT


def _dense(x, layer, precision=MATMUL_PRECISION):
    """relu(x @ w + b) of one Dense layer."""
    return jax.nn.relu(
        jnp.matmul(x, layer["w"], precision=precision) + layer["b"]
    )


def _init_mlp(key, sizes: List[int]):
    """Glorot-uniform Dense stack params (matches Keras Dense defaults)."""
    params = []
    for i in range(len(sizes) - 1):
        key, k = jax.random.split(key)
        fan_in, fan_out = sizes[i], sizes[i + 1]
        limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
        w = jax.random.uniform(
            k, (fan_in, fan_out), minval=-limit, maxval=limit
        )
        params.append({"w": w, "b": jnp.zeros((fan_out,), jnp.float32)})
    return params


def _mlp(params, x):
    for layer in params:
        x = _dense(x, layer)
    return x


def mlp_activations(params, x):
    """Per-layer activations at HIGHEST precision (for allclose parity
    vs the numpy reference in `parity.reference.mlp_forward`)."""
    acts = []
    for layer in params:
        x = _dense(x, layer, jax.lax.Precision.HIGHEST)
        acts.append(x)
    return acts


def encode(params, a_rows):
    return _mlp(params["enc"], a_rows)


def decode(params, y):
    return _mlp(params["dec"], y)


def _run_checkpointed(run_epochs, params, opt_state, epochs,
                      checkpoint_dir, checkpoint_every):
    """Shared chunked-epoch driver with Orbax checkpoint/resume: a
    single compiled scan when not checkpointing, otherwise chunked at
    the checkpoint cadence (one compiled program per distinct chunk
    length). `run_epochs(params, opt_state, start, n)` runs n epochs.
    Used by both the dense `SDNE.train` and `SDNE.train_sparse`."""
    import os

    from graphembedding.utils.checkpoint import (
        load_state,
        save_state,
    )

    start = 0
    if checkpoint_dir and os.path.exists(
        os.path.abspath(checkpoint_dir)
    ):
        template = {
            "params": params,
            "opt_state": opt_state,
            "epoch": np.asarray(0),
        }
        st = load_state(checkpoint_dir, template)
        params = st["params"]
        opt_state = st["opt_state"]
        start = int(st["epoch"])
    all_losses = []
    chunk = (
        checkpoint_every
        if (checkpoint_dir and checkpoint_every)
        else max(epochs - start, 1)
    )
    e = start
    while e < epochs:
        n = min(chunk, epochs - e)
        params, opt_state, losses = run_epochs(
            params, opt_state, e, n
        )
        all_losses.append(losses)
        e += n
        if checkpoint_dir and checkpoint_every:
            save_state(checkpoint_dir, {
                "params": params,
                "opt_state": opt_state,
                "epoch": np.asarray(e),
            })
    losses = (
        jnp.concatenate(all_losses) if all_losses
        else jnp.zeros((0,), jnp.float32)
    )
    return params, opt_state, losses


def sdne_loss(params, a_rows, l_block, alpha, beta, nu1, nu2):
    """Reference-exact objective on one batch (rows of A + L sub-block)."""
    y = encode(params, a_rows)
    a_hat = decode(params, y)
    b_ = jnp.where(a_rows != 0, beta, 1.0)
    l2nd = jnp.mean(jnp.sum(jnp.square((a_rows - a_hat) * b_), axis=-1))
    batch = a_rows.shape[0]
    mm = partial(jnp.matmul, precision=MATMUL_PRECISION)
    l1st = alpha * 2.0 * jnp.trace(mm(mm(y.T, l_block), y)) / batch
    reg = 0.0
    for stack in (params["enc"], params["dec"]):
        for layer in stack:
            reg = reg + nu1 * jnp.sum(jnp.abs(layer["w"])) + nu2 * jnp.sum(
                jnp.square(layer["w"])
            )
    return l2nd + l1st + reg, (l2nd, l1st)


class SDNE:
    def __init__(
        self,
        graph,
        hidden_size=None,
        alpha=1e-6,
        beta=5.0,
        nu1=1e-5,
        nu2=1e-4,
        seed=0,
    ):
        # default [256, 128] — the reference's canonical size
        # (`ge/models/sdne.py — create_model (~L35) [U]` default AND
        # the example's explicit value, SURVEY §3.1 rows 6+12), so a
        # defaults-relying migrated caller gets a 128-d embedding
        self.graph = as_graph(graph)
        self.hidden_size = list(hidden_size or [256, 128])
        self.alpha = alpha
        self.beta = beta
        self.nu1 = nu1
        self.nu2 = nu2
        self.seed = seed
        self._embeddings: Dict | None = None

        V = self.graph.num_nodes
        # dense [V, V] A and L are built LAZILY (properties below):
        # train_sparse / sparse get_embeddings never touch them, which
        # is the whole point of the sparse mode at large V
        self._A = None
        self._L = None

        sizes = [V] + self.hidden_size
        key = jax.random.PRNGKey(seed)
        k1, k2 = jax.random.split(key)
        self.params = {
            "enc": _init_mlp(k1, sizes),
            "dec": _init_mlp(k2, list(reversed(self.hidden_size)) + [V]),
        }
        self.losses = None

    @property
    def A(self):
        """Dense [V, V] adjacency (reference `_create_A_L [U]`
        semantics: `A[src, dst] = w`). Built on first use."""
        if self._A is None:
            V = self.graph.num_nodes
            src, dst, w = self.graph.edges()
            A = np.zeros((V, V), dtype=np.float32)
            A[src, dst] = w
            self._A = jnp.asarray(A)
        return self._A

    @property
    def L(self):
        """Dense Laplacian L = D − A_sym with duplicate-sum (scipy-coo)
        semantics. Built on first use. For graphs constructed
        undirected, edges() already lists both directions — adding the
        transpose again would double every weight (and diverge from
        the reference's `_create_A_L [U]`, which symmetrizes a
        single-direction listing)."""
        if self._L is None:
            V = self.graph.num_nodes
            src, dst, w = self.graph.edges()
            A_sym = np.zeros((V, V), dtype=np.float32)
            np.add.at(A_sym, (src, dst), w)
            if self.graph.directed:
                np.add.at(A_sym, (dst, src), w)
            D = np.diag(A_sym.sum(axis=1))
            self._L = jnp.asarray((D - A_sym).astype(np.float32))
        return self._L

    def train(self, batch_size=1024, epochs=1, initial_epoch=0, verbose=0,
              learning_rate=1e-3, checkpoint_dir=None,
              checkpoint_every=0, mesh=None):
        """Reference signature plus checkpoint_dir/-every (Orbax
        checkpoint of (params, optimizer state, epoch) every N epochs
        with resume — the epoch scan is chunked at the checkpoint
        cadence, one compiled program per distinct chunk length) and
        mesh= (EXACT row-sharded data parallelism for the full-batch
        mode — parallel/sdne.py; same objective and updates as the
        single-device run)."""
        del initial_epoch, verbose
        V = self.graph.num_nodes
        tx = optax.adam(learning_rate)
        opt_state = tx.init(self.params)
        alpha, beta = jnp.float32(self.alpha), jnp.float32(self.beta)
        nu1, nu2 = jnp.float32(self.nu1), jnp.float32(self.nu2)

        grad_fn = jax.value_and_grad(sdne_loss, has_aux=True)
        # materialize the lazy dense A/L OUTSIDE any jit trace (a
        # first build inside jit would cache a tracer)
        A, L = self.A, self.L

        if mesh is not None:
            if batch_size < V:
                raise NotImplementedError(
                    "mesh= shards the full-batch mode (batch_size >= "
                    "node count); the reference-exact minibatch loop's "
                    "L[idx][:, idx] coupling is batch-composition-"
                    "dependent and stays single-device"
                )
            from graphembedding.parallel.sdne import (
                pad_rows,
                sharded_sdne_train,
            )

            n_data = mesh.shape["data"]
            padded = pad_rows(jnp.asarray(A), jnp.asarray(L), V, n_data)
            _fns = {}

            def run_epochs(params, opt_state, start, n):
                if n not in _fns:
                    _fns[n] = sharded_sdne_train(
                        mesh, tx, num_nodes=V, alpha=self.alpha,
                        beta=self.beta, nu1=self.nu1, nu2=self.nu2,
                        n_epochs=n,
                    )
                A_pad, L_pad, ok = padded
                with mesh:
                    return _fns[n](params, opt_state, A_pad, L_pad, ok)
        elif batch_size >= V:
            # full-batch: one [V,V] matmul per step. ALL epochs run
            # inside one compiled scan — no per-epoch dispatch, which
            # at wiki scale would rival the epoch's own compute
            @partial(jax.jit, static_argnames="n_epochs",
                     donate_argnums=(0, 1))
            def run_full(params, opt_state, A_d, L_d, n_epochs):
                def step(carry, _):
                    params, opt_state = carry
                    (loss, aux), grads = grad_fn(
                        params, A_d, L_d, alpha, beta, nu1, nu2
                    )
                    updates, opt_state = tx.update(
                        grads, opt_state, params
                    )
                    params = optax.apply_updates(params, updates)
                    return (params, opt_state), loss

                (params, opt_state), losses = jax.lax.scan(
                    step, (params, opt_state), None, length=n_epochs
                )
                return params, opt_state, losses

            # A/L as device ARGUMENTS, not closure constants — 23 MB
            # [V, V] constants baked into a scanned executable blew
            # compile time up ~10x (measured)
            A_d, L_d = jnp.asarray(A), jnp.asarray(L)

            def run_epochs(params, opt_state, start, n):
                return run_full(params, opt_state, A_d, L_d, n)
        else:
            steps = (V + batch_size - 1) // batch_size

            def epoch_mini_body(params, opt_state, A_d, L_d, key):
                perm = jax.random.permutation(key, V)
                pad = steps * batch_size - V
                idx_all = jnp.concatenate(
                    [perm, perm[:pad]]
                ).reshape(steps, batch_size)

                def step(carry, idx):
                    params, opt_state = carry
                    a_rows = A_d[idx]
                    l_block = L_d[idx][:, idx]
                    (loss, aux), grads = grad_fn(
                        params, a_rows, l_block, alpha, beta, nu1, nu2
                    )
                    updates, opt_state = tx.update(
                        grads, opt_state, params
                    )
                    params = optax.apply_updates(params, updates)
                    return (params, opt_state), loss

                (params, opt_state), losses = jax.lax.scan(
                    step, (params, opt_state), idx_all
                )
                return params, opt_state, losses

            key = jax.random.PRNGKey(self.seed + 2)
            # run all epochs in one compiled call (outer scan over the
            # per-epoch shuffle keys) — see the full-batch note
            @partial(jax.jit, static_argnames="n_epochs",
                     donate_argnums=(0, 1))
            def run_mini(params, opt_state, A_d, L_d, key, n_epochs):
                def epoch(carry, e):
                    params, opt_state = carry
                    params, opt_state, losses = epoch_mini_body(
                        params, opt_state, A_d, L_d,
                        jax.random.fold_in(key, e)
                    )
                    return (params, opt_state), losses

                (params, opt_state), losses = jax.lax.scan(
                    epoch, (params, opt_state),
                    jnp.arange(n_epochs, dtype=jnp.int32),
                )
                return params, opt_state, losses.reshape(-1)
            # NOTE: run_mini is keyed per-chunk via fold_in(key, start)
            # so resumed runs draw fresh (not replayed-from-0) shuffles

            # A/L as device args, not closure constants (see above)
            A_d, L_d = jnp.asarray(A), jnp.asarray(L)

            def run_epochs(params, opt_state, start, n):
                return run_mini(
                    params, opt_state, A_d, L_d,
                    jax.random.fold_in(key, start), n
                )

        self.params, opt_state, self.losses = _run_checkpointed(
            run_epochs, self.params, opt_state, epochs,
            checkpoint_dir, checkpoint_every,
        )
        self._embeddings = None
        return self

    def train_sparse(self, epochs=1, learning_rate=1e-3, row_chunk=512,
                     checkpoint_dir=None, checkpoint_every=0,
                     mesh=None):
        """Memory-scalable trainer: never materializes dense [V, V].

        - encoder input layer = SpMM(A_bcoo, W1) (ops.spmm);
        - reconstruction loss computed in row chunks under lax.scan,
          rebuilding each adjacency row chunk from the padded neighbor
          matrix on the fly;
        - Laplacian term via the edge-based identity
          tr(Y^T L Y) = Σ_i d_i||y_i||² − Σ_e w_e⟨y_s, y_d⟩
          (ops.spmm.laplacian_quadratic) — L itself never exists.

        Equivalent objective to full-batch `train` (same losses); use
        when V is too large for the dense path. Operational parity
        with the dense trainer: checkpoint_dir/-every give Orbax
        checkpoint + resume (chunked epoch scan), and mesh= runs the
        EXACT row-sharded epoch over the 'data' axis
        (parallel/sdne.sharded_sdne_sparse_train — neighbor-slab rows
        plus edge-partitioned Laplacian, same objective and updates).
        """
        from graphembedding.ops.spmm import (
            adjacency_bcoo,
            laplacian_quadratic,
            sym_edges,
        )

        V = self.graph.num_nodes
        nm = self.graph.neighbor_matrix
        src, dst, w, deg_w = sym_edges(self.graph)
        tx = optax.adam(learning_rate)
        opt_state = tx.init(self.params)

        if mesh is not None:
            from graphembedding.parallel.sdne import (
                pad_sparse_inputs,
                sharded_sdne_sparse_train,
            )

            n_data = mesh.shape["data"]
            padded = pad_sparse_inputs(
                nm, deg_w, src, dst, w, V, n_data, row_chunk
            )
            _fns = {}

            def run_epochs(params, opt_state, start, n):
                if n not in _fns:
                    _fns[n] = sharded_sdne_sparse_train(
                        mesh, tx, num_nodes=V, alpha=self.alpha,
                        beta=self.beta, nu1=self.nu1, nu2=self.nu2,
                        n_epochs=n, row_chunk=row_chunk,
                    )
                with mesh:
                    return _fns[n](params, opt_state, *padded)

            self.params, opt_state, self.losses = _run_checkpointed(
                run_epochs, self.params, opt_state, epochs,
                checkpoint_dir, checkpoint_every,
            )
            self._embeddings = None
            return self

        A_bcoo = adjacency_bcoo(self.graph)
        alpha, beta = jnp.float32(self.alpha), jnp.float32(self.beta)
        nu1, nu2 = jnp.float32(self.nu1), jnp.float32(self.nu2)
        n_chunks = (V + row_chunk - 1) // row_chunk

        # graph arrays enter as jit ARGUMENTS, not closure constants —
        # baked-in constants make the serialized program O(E) bytes
        # (the dense path's [V,V] A/L likewise, see train)
        @partial(jax.jit, static_argnames="n_epochs",
                 donate_argnums=(0, 1))
        def run_steps(params, opt_state, A_d, nbr, nbr_w_m, src_d,
                      dst_d, w_d, deg_d, n_epochs):
            def loss_fn(params):
                # encoder first layer via SpMM, rest dense
                h = jax.nn.relu(
                    A_d @ params["enc"][0]["w"] + params["enc"][0]["b"]
                )
                for layer in params["enc"][1:]:
                    h = _dense(h, layer)
                y = h  # [V, d]
                l1st = alpha * 2.0 * laplacian_quadratic(
                    src_d, dst_d, w_d, deg_d, y
                ) / V

                def chunk_l2(carry, c):
                    lo = c * row_chunk
                    idx = lo + jnp.arange(row_chunk)
                    ok = (idx < V).astype(jnp.float32)
                    idx_s = jnp.minimum(idx, V - 1)
                    a_hat = decode(params, y[idx_s])  # [C, V]
                    nb = nbr[idx_s]
                    nb_w = nbr_w_m[idx_s]
                    rows = jnp.zeros((row_chunk, V + 1))
                    rows = rows.at[
                        jnp.arange(row_chunk)[:, None],
                        jnp.where(nb >= 0, nb, V),
                    ].add(nb_w)[:, :V]
                    b_ = jnp.where(rows != 0, beta, 1.0)
                    l2 = jnp.sum(
                        jnp.sum(
                            jnp.square((rows - a_hat) * b_), axis=-1
                        ) * ok
                    )
                    return carry + l2, None

                # remat: without it autodiff saves every chunk's
                # [C, V] reconstruction as a scan residual —
                # O(n_chunks·C·V) = 40 GB at V=100k. Recomputing a_hat
                # in the backward pass keeps residuals O(carry)
                l2nd, _ = jax.lax.scan(
                    jax.checkpoint(chunk_l2), 0.0, jnp.arange(n_chunks)
                )
                l2nd = l2nd / V
                reg = 0.0
                for stack in (params["enc"], params["dec"]):
                    for layer in stack:
                        reg = reg + nu1 * jnp.sum(
                            jnp.abs(layer["w"])
                        ) + nu2 * jnp.sum(jnp.square(layer["w"]))
                return l2nd + l1st + reg, (l2nd, l1st)

            grad_fn = jax.value_and_grad(loss_fn, has_aux=True)

            def step(carry, _):
                params, opt_state = carry
                (loss, aux), grads = grad_fn(params)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), loss

            (params, opt_state), losses = jax.lax.scan(
                step, (params, opt_state), None, length=n_epochs
            )
            return params, opt_state, losses

        def run_epochs(params, opt_state, start, n):
            return run_steps(
                params, opt_state, A_bcoo, nm.nbr, nm.nbr_w,
                src, dst, w, deg_w, n
            )

        self.params, opt_state, self.losses = _run_checkpointed(
            run_epochs, self.params, opt_state, epochs,
            checkpoint_dir, checkpoint_every,
        )
        self._embeddings = None
        return self

    def evaluate(self):
        """Reference-API parity (`SDNE.evaluate [U]`): full-batch loss
        components on the current parameters."""
        import jax.numpy as jnp

        loss, (l2nd, l1st) = sdne_loss(
            self.params, self.A, self.L, jnp.float32(self.alpha),
            jnp.float32(self.beta), jnp.float32(self.nu1),
            jnp.float32(self.nu2),
        )
        return {
            "loss": float(loss),
            "l_2nd": float(l2nd),
            "l_1st": float(l1st),
        }

    def _encode_table(self):
        """Encoder output for all nodes; sparse first layer when the
        dense adjacency was never materialized (post-train_sparse)."""
        if self._A is not None:
            return encode(self.params, self.A)
        from graphembedding.ops.spmm import adjacency_bcoo

        A_bcoo = adjacency_bcoo(self.graph)
        h = jax.nn.relu(
            A_bcoo @ self.params["enc"][0]["w"]
            + self.params["enc"][0]["b"]
        )
        for layer in self.params["enc"][1:]:
            h = _dense(h, layer)
        return h

    def get_embeddings(self) -> Dict:
        if self._embeddings is None:
            y = np.asarray(self._encode_table())
            vocab = self.graph.vocab
            self._embeddings = {
                vocab.idx2node[i]: y[i] for i in range(self.graph.num_nodes)
            }
        return self._embeddings

    @property
    def embedding_table(self):
        return self._encode_table()
