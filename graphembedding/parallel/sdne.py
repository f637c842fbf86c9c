"""Sharded SDNE training: exact data parallelism over adjacency rows.

New surface area vs the reference (single-host TF1, SURVEY.md §3.3).
Unlike the embedding-table trainers there is no hogwild trade here —
the MLP parameters are replicated and gradients are `psum`'d every
step, so the sharded run computes the *same* full-batch objective and
updates as the single-device `SDNE.train` (batch_size >= V mode):

- rows of A (and the matching rows of L) are sharded over the `data`
  axis — each device encodes/decodes its row block ([V/n, V] x W1 is
  the dominant matmul, now 1/n per card;
- the Laplacian term tr(YᵀLY) = Σ_i ⟨y_i, (LY)_i⟩ needs every row's
  embedding: the [V, d] Y is assembled with `all_gather` over `data`
  (d <= 128, KBs-MBs — cheap on the interconnect) and each device contracts its
  local L rows; the all_gather's transpose (psum_scatter) routes the
  cross-device cotangents back, so autodiff through it yields the
  exact global gradient;
- the weight-regularization term is divided by the data-axis size so
  the gradient psum counts it once.

Rows are zero-padded to a multiple of the axis size; a row-validity
mask keeps padded rows out of the losses.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P


def sharded_sdne_train(
    mesh,
    tx,
    *,
    num_nodes,
    alpha,
    beta,
    nu1,
    nu2,
    n_epochs,
):
    """Build the jitted sharded full-batch epoch runner.

    Returns fn(params, opt_state, A_pad, L_pad, ok) ->
    (params, opt_state, losses[n_epochs]) with A_pad [Vp, V] and
    L_pad [Vp, Vp] row-sharded over 'data', ok [Vp] the row mask.
    """
    import optax

    from graphembedding.models.sdne import (
        MATMUL_PRECISION,
        decode,
        encode,
    )

    n_data = mesh.shape["data"]
    if mesh.shape.get("model", 1) != 1:
        raise ValueError(
            "SDNE shards over the data axis only; use a (n, 1) mesh"
        )
    V = num_nodes
    a, b = jnp.float32(alpha), jnp.float32(beta)
    r1, r2 = jnp.float32(nu1), jnp.float32(nu2)

    def body(params, opt_state, a_rows, l_rows, ok):
        # a_rows: [Vp/n, V]; l_rows: [Vp/n, Vp]; ok: [Vp/n]

        def loss_local(params):
            y = encode(params, a_rows)  # [Vl, d]
            a_hat = decode(params, y)
            b_ = jnp.where(a_rows != 0, b, 1.0)
            l2nd = jnp.sum(
                jnp.sum(jnp.square((a_rows - a_hat) * b_), axis=-1)
                * ok
            ) / V
            y_full = jax.lax.all_gather(y, "data", tiled=True)  # [Vp,d]
            l1st = a * 2.0 * jnp.sum(y * jnp.matmul(
                l_rows, y_full, precision=MATMUL_PRECISION)) / V
            reg = 0.0
            for stack in (params["enc"], params["dec"]):
                for layer in stack:
                    reg = reg + r1 * jnp.sum(jnp.abs(layer["w"])) + (
                        r2 * jnp.sum(jnp.square(layer["w"]))
                    )
            # replicated term: counted once after the gradient psum
            return l2nd + l1st + reg / n_data

        grad_fn = jax.value_and_grad(loss_local)

        def step(carry, _):
            params, opt_state = carry
            loss_l, grads = grad_fn(params)
            grads = jax.lax.psum(grads, "data")
            loss = jax.lax.psum(loss_l, "data")
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            step, (params, opt_state), None, length=n_epochs
        )
        return params, opt_state, losses

    rep = P()
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(rep, rep, P("data", None), P("data", None),
                  P("data")),
        out_specs=(rep, rep, rep),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0, 1))


def pad_rows(A, L, num_nodes, n_data):
    """Zero-pad A [V, V] -> [Vp, V], L -> [Vp, Vp], mask [Vp]."""
    V = num_nodes
    Vp = ((V + n_data - 1) // n_data) * n_data
    pad = Vp - V
    A_pad = jnp.pad(A, ((0, pad), (0, 0)))
    L_pad = jnp.pad(L, ((0, pad), (0, pad)))
    ok = jnp.pad(jnp.ones((V,), jnp.float32), (0, pad))
    return A_pad, L_pad, ok


def sharded_sdne_sparse_train(
    mesh,
    tx,
    *,
    num_nodes,
    alpha,
    beta,
    nu1,
    nu2,
    n_epochs,
    row_chunk,
):
    """Build the jitted ROW-SHARDED sparse epoch runner (the mesh path
    of `SDNE.train_sparse` — same objective, never materializes the
    dense [V, V] A or L).

    Each device owns a `[Vp/n, D]` slab of the padded neighbor matrix
    plus `1/n` of the symmetrized edge list:

    - encoder first layer = per-chunk gather-einsum SpMM
      (`W1[nbr] · nbr_w`) over the local rows, under a rematerialized
      `lax.scan` exactly like the single-device sparse path;
    - reconstruction rows are rebuilt chunk-at-a-time from the local
      neighbor slab (scatter into `[C, V]`), so the full adjacency
      never exists anywhere;
    - the Laplacian term uses the edge identity
      `tr(YᵀLY) = Σ_i d_i‖y_i‖² − Σ_e w_e⟨y_s, y_d⟩`: the `[Vp, d]` Y
      is assembled with `all_gather` over `data` (its transpose routes
      cross-device cotangents back, so the psum'd gradient is exact)
      and each device contracts its local edges;
    - weight regularization divided by the axis size so the gradient
      psum counts it once.

    Returns fn(params, opt_state, nbr, nbr_w, ok, deg_w, src, dst, w)
    -> (params, opt_state, losses[n_epochs]) with nbr/nbr_w [Vp, D]
    and ok/deg_w [Vp] row-sharded over 'data' (Vp a multiple of
    n·row_chunk, pad rows all -1/0), and src/dst/w [Ep] edge-sharded
    (pad edges w=0).
    """
    import optax

    from graphembedding.models.sdne import (
        MATMUL_PRECISION,
        _dense,
        decode,
    )

    n_data = mesh.shape["data"]
    if mesh.shape.get("model", 1) != 1:
        raise ValueError(
            "SDNE shards over the data axis only; use a (n, 1) mesh"
        )
    V = num_nodes
    a_, b_ = jnp.float32(alpha), jnp.float32(beta)
    r1, r2 = jnp.float32(nu1), jnp.float32(nu2)

    def body(params, opt_state, nbr, nbr_w, ok, deg_w, src, dst, w):
        Vl = nbr.shape[0]  # Vp / n
        n_chunks = Vl // row_chunk
        d_emb = params["enc"][-1]["w"].shape[1]

        def loss_local(params):
            W1 = params["enc"][0]["w"]
            b1 = params["enc"][0]["b"]

            def enc_chunk(carry, c):
                lo = c * row_chunk
                nb = jax.lax.dynamic_slice_in_dim(nbr, lo, row_chunk)
                nw = jax.lax.dynamic_slice_in_dim(nbr_w, lo, row_chunk)
                okc = jax.lax.dynamic_slice_in_dim(ok, lo, row_chunk)
                wmask = jnp.where(nb >= 0, nw, 0.0)
                h = jnp.einsum(
                    "cd,cdh->ch", wmask, W1[jnp.maximum(nb, 0)],
                    precision=MATMUL_PRECISION,
                ) + b1
                h = jax.nn.relu(h)
                for layer in params["enc"][1:]:
                    h = _dense(h, layer)
                y_c = h  # [C, d]
                a_hat = decode(params, y_c)  # [C, V]
                rows = jnp.zeros((row_chunk, V + 1))
                rows = rows.at[
                    jnp.arange(row_chunk)[:, None],
                    jnp.where(nb >= 0, nb, V),
                ].add(nw)[:, :V]
                bmask = jnp.where(rows != 0, b_, 1.0)
                l2 = jnp.sum(
                    jnp.sum(jnp.square((rows - a_hat) * bmask), -1)
                    * okc
                )
                return carry + l2, y_c

            # remat: recompute a_hat in the backward pass instead of
            # saving every chunk's [C, V] reconstruction (see the
            # single-device train_sparse note)
            l2_local, y_chunks = jax.lax.scan(
                jax.checkpoint(enc_chunk), 0.0, jnp.arange(n_chunks)
            )
            y_local = y_chunks.reshape(Vl, d_emb)
            l2nd = l2_local / V
            y_full = jax.lax.all_gather(
                y_local, "data", tiled=True
            )  # [Vp, d]
            row_term = jnp.sum(deg_w[:, None] * jnp.square(y_local))
            edge_term = jnp.sum(
                w * jnp.sum(y_full[src] * y_full[dst], -1)
            )
            l1st = a_ * 2.0 * (row_term - edge_term) / V
            reg = 0.0
            for stack in (params["enc"], params["dec"]):
                for layer in stack:
                    reg = reg + r1 * jnp.sum(jnp.abs(layer["w"])) + (
                        r2 * jnp.sum(jnp.square(layer["w"]))
                    )
            return l2nd + l1st + reg / n_data

        grad_fn = jax.value_and_grad(loss_local)

        def step(carry, _):
            params, opt_state = carry
            loss_l, grads = grad_fn(params)
            grads = jax.lax.psum(grads, "data")
            loss = jax.lax.psum(loss_l, "data")
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            step, (params, opt_state), None, length=n_epochs
        )
        return params, opt_state, losses

    rep = P()
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(rep, rep, P("data", None), P("data", None),
                  P("data"), P("data"), P("data"), P("data"),
                  P("data")),
        out_specs=(rep, rep, rep),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0, 1))


def pad_sparse_inputs(nm, deg_w, src, dst, w, num_nodes, n_data,
                      row_chunk):
    """Pad the neighbor matrix / degree vector to a multiple of
    n·row_chunk rows (pad rows nbr=-1, weight 0) and the edge list to a
    multiple of n (pad edges weight 0), for `sharded_sdne_sparse_train`.
    """
    V = num_nodes
    gran = n_data * row_chunk
    Vp = ((V + gran - 1) // gran) * gran
    rpad = Vp - V
    nbr = jnp.pad(nm.nbr, ((0, rpad), (0, 0)), constant_values=-1)
    nbr_w = jnp.pad(nm.nbr_w, ((0, rpad), (0, 0)))
    ok = jnp.pad(jnp.ones((V,), jnp.float32), (0, rpad))
    deg_p = jnp.pad(deg_w, (0, rpad))
    E = src.shape[0]
    Ep = ((E + n_data - 1) // n_data) * n_data
    epad = Ep - E
    src_p = jnp.pad(src, (0, epad))
    dst_p = jnp.pad(dst, (0, epad))
    w_p = jnp.pad(w, (0, epad))
    return nbr, nbr_w, ok, deg_p, src_p, dst_p, w_p
