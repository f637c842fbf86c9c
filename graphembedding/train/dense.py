"""Dense expected-SGNS trainer — small-graph full-batch factorization.

A device-first alternative the reference has no analogue for: at
reference scale the whole co-occurrence structure of the walk corpus
fits in a few dense [V, V] matmuls, so instead of streaming (center, context, negatives)
samples, train the EXPECTED skip-gram-negative-sampling objective in
closed form:

    L(U, V) = - sum_{c,x} C[c,x] * log sigma(u_c . v_x)
              - sum_{c,x} negative * occ[c] * q[x] * log sigma(-u_c . v_x)

where C is the expected window-pair count matrix of the corpus (the
dynamic-window shrink enters as its exact expectation P(eff >= d) =
(W-d+1)/W — no RNG), occ[c] = sum_x C[c,x], and q is the unigram^0.75
negative distribution. This is the sampled trainer's objective (Levy
& Goldberg's implicit-MF view of SGNS) with ZERO sampling variance,
modulo one deliberate omission: frequent-node SUBSAMPLING
(`sample=1e-3` in the sampled trainer) is not folded into C — its
exact expectation under window compaction has no clean closed form,
and it measured F1-neutral at wiki scale. Gradients are three
[V,V]x[V,D] matmuls per step.

Scope: tables up to V ~ 2e4 (the [V, V] activations are V^2 * 4 B * ~3
buffers). The walk-block trainer remains the scale path; this one
turns reference-scale training into milliseconds per full-corpus pass.

Reference counterpart: none — `ge/models/deepwalk.py — train [U]`
delegates to gensim's sampled SGD; this closed form only makes sense
on a matrix unit.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Float32 products run at DEFAULT precision: TF32 on the H100's tensor
# cores (10-bit mantissa, float32 accumulation), full float32 on the
# CPU. Used by the dense SGNS trainer and by LINE's dense trainer.
MATMUL_PRECISION = jax.lax.Precision.DEFAULT
mm = partial(jnp.matmul, precision=MATMUL_PRECISION)


@partial(jax.jit, static_argnames=("num_nodes", "window"))
def cooccurrence(walks, *, num_nodes, window):
    """Expected window-pair count matrix C [V, V] (f32).

    Ordered pairs at distance d in the same walk contribute
    P(eff >= d) = (W-d+1)/W each way — exactly the sampled trainer's
    dynamic-window expectation. Pad tokens (-1) contribute nothing.
    """
    V, W = num_nodes, window
    NW, L = walks.shape
    idxs, vals = [], []
    for d in range(1, min(W, L - 1) + 1):
        w_d = jnp.float32((W - d + 1) / W)
        a = walks[:, : L - d].reshape(-1)
        b = walks[:, d:].reshape(-1)
        ok = (a >= 0) & (b >= 0)
        idxs.append(jnp.where(ok, a * V + b, 0))
        idxs.append(jnp.where(ok, b * V + a, 0))
        val = jnp.where(ok, w_d, 0.0)
        vals.extend([val, val])
    # ONE scatter for all distances/directions. Measured cost-neutral
    # vs 2W separate scatters (XLA scatter is per-element-bound, and
    # it dominates the warm dense fit at BlogCatalog scale — ~0.6 s of
    # 0.8 s); kept for the single-kernel form.
    C = jnp.zeros((V * V,), jnp.float32).at[
        jnp.concatenate(idxs)
    ].add(jnp.concatenate(vals))
    return C.reshape(V, V)


@dataclass
class DenseSGNSConfig:
    embed_size: int = 128
    window: int = 5
    negative: int = 5
    ns_exponent: float = 0.75
    steps: int = 300
    lr: float = 0.1  # Adam on a noise-free full-batch gradient
    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-8
    seed: int = 0
    max_nodes: int = 1 << 15  # [V,V] buffers bound the method


class DenseSGNSTrainer:
    """Full-batch expected-SGNS via Adam on the closed-form gradient."""

    def __init__(self, config: DenseSGNSConfig | None = None, **kw):
        self.config = config or DenseSGNSConfig(**kw)

    def fit(self, walks, num_nodes, key=None):
        cfg = self.config
        if num_nodes > cfg.max_nodes:
            raise ValueError(
                f"dense trainer is for V <= {cfg.max_nodes} (got "
                f"{num_nodes}); use the walk-block trainer at scale"
            )
        if num_nodes > 46340:
            # the co-occurrence scatter flattens to a*V+b in int32
            # (jax's default itype); beyond floor(sqrt(2^31)) the flat
            # index overflows and the scatter silently drops entries —
            # error rather than corrupt, whatever max_nodes was set to
            raise ValueError(
                "dense trainer's flat co-occurrence index overflows "
                f"int32 above V=46340 (got {num_nodes})"
            )
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        walks = jnp.asarray(walks)
        C = cooccurrence(
            walks, num_nodes=num_nodes, window=cfg.window
        )
        w_in, w_out, losses = _dense_fit(
            C, key,
            jnp.float32(cfg.negative), jnp.float32(cfg.ns_exponent),
            jnp.float32(cfg.lr), jnp.float32(cfg.b1),
            jnp.float32(cfg.b2), jnp.float32(cfg.eps),
            num_nodes=num_nodes, embed_size=cfg.embed_size,
            steps=cfg.steps,
        )
        return w_in, w_out, losses


@partial(
    jax.jit,
    static_argnames=("num_nodes", "embed_size", "steps", "tied"),
)
def _dense_fit(C, key, negative, ns_exponent, lr, b1, b2, eps, *,
               num_nodes, embed_size, steps, q=None, tied=False):
    """Adam on the closed-form expected-SGNS gradient.

    C [V, V]: expected positive-pair weights (co-occurrence counts for
    walk corpora; the weighted adjacency for LINE's edge sampling).
    q (optional [V]): the negative-sampling distribution; defaults to
    the walk-corpus unigram^ns_exponent. `tied=True` trains one shared
    table (LINE first-order's symmetric dot): the gradient becomes
    (G + G^T) @ U.
    """
    V, D = num_nodes, embed_size
    occ = C.sum(axis=1)  # expected pair count per center
    if q is None:
        counts = C.sum(axis=1) + C.sum(axis=0)
        q = jnp.power(jnp.maximum(counts, 0.0), ns_exponent)
    q = q / jnp.maximum(q.sum(), 1e-12)
    # keep only the rank-1 FACTORS (occ, q); materializing the [V, V]
    # product here would hold a second V^2 buffer live across the whole
    # scan — inside the step it fuses into G's elementwise chain
    occ_n = (negative * occ)[:, None]
    q_row = q[None, :]
    scale = 1.0 / jnp.maximum(C.sum(), 1.0)  # per-pair normalization

    U0 = (jax.random.uniform(key, (V, D)) - 0.5) / D
    W0 = jnp.zeros((V, D), jnp.float32)

    def step(carry, _):
        U, W, mU, vU, mW, vW, t = carry
        logits = mm(U, U.T if tied else W.T)  # [V, V]
        S = jax.nn.sigmoid(logits)
        G = (C * (S - 1.0) + occ_n * q_row * S) * scale
        if tied:
            dU = mm(G + G.T, U)
            dW = jnp.zeros_like(W)
        else:
            dU = mm(G, W)
            dW = mm(G.T, U)
        t = t + 1

        def adam(p, g, m, v):
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / (1 - b1 ** t)
            vhat = v / (1 - b2 ** t)
            return p - lr * mhat / (jnp.sqrt(vhat) + eps), m, v

        U, mU, vU = adam(U, dU, mU, vU)
        W, mW, vW = adam(W, dW, mW, vW)
        return (U, W, mU, vU, mW, vW, t), None

    init = (U0, W0, jnp.zeros_like(U0), jnp.zeros_like(U0),
            jnp.zeros_like(W0), jnp.zeros_like(W0), jnp.int32(0))
    (U, W, *_), _ = jax.lax.scan(step, init, None, length=steps)
    # loss as ONE final evaluation, not per step: the two [V, V]
    # log-sigmoid reductions per step would cost more than the step's
    # own matmuls at BlogCatalog scale
    logits = mm(U, U.T if tied else W.T)
    final_loss = -(
        jnp.sum(C * jax.nn.log_sigmoid(logits))
        + jnp.sum(occ_n * q_row * jax.nn.log_sigmoid(-logits))
    ) * scale
    return U, W, final_loss[None]
