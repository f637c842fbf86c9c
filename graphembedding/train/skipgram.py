"""Skip-gram with negative sampling (SGNS) over walk corpora.

Reference counterpart: gensim `Word2Vec` (`word2vec_inner.pyx`), the Cython
hogwild hot loop that `DeepWalk.train` / `Node2Vec.train` / `Struc2Vec.train`
delegate to (SURVEY.md §3.2). This is a redesign for an accelerator, not a
translation — the trainer is built around batched matmuls and contiguous
slices and away from per-element random gathers and small per-step RNG
kernels:

**Walk-block formulation.** Each step consumes a contiguous block of `Bw`
walks from the (per-epoch shuffled) corpus buffer. The block's token
embeddings are gathered ONCE (`[Bw, L, D]`), and *all* intra-walk
(center, context) window pairs are scored in one batched matmul
`[Bw, L, D] x [Bw, D, L] -> [Bw, L, L]`, masked to the window.
Per trained pair this costs ~0.3 embedding-row touches vs ~14 for a
pair-at-a-time layout, and row gathers/scatters are a large part of the
step's device time.

**Group-shared negatives.** Negatives are drawn from a pre-sampled
unigram^0.75 table (the original word2vec C trick — one int32 table, no
per-sample binary search) and
are shared by *groups of `neg_share_walks` walks*: each group gathers
`k_shared` negative rows once and scores them against all its centers via
a dense batched matmul. Each center's negative gradient is weighted
`n_pairs * negative / k_shared`, so the expected gradient equals gensim's
`negative` i.i.d. draws per pair with lower variance. Sharing is
per-group rather than per-step deliberately: with step-wide sharing a
single negative row accumulates the whole block's negative gradient at
stale logits (thousands of gradient units on one row) and SGD diverges;
group sharing bounds per-row accumulation at `neg_share_walks * L *
negative / k_shared` — a few units — matching the magnitude a popular
row sees under the reference's sequential/hogwild updates.

**gensim semantics preserved** where they matter for quality
(SURVEY.md §8.4-1): dynamic window shrink drawn per center occurrence
(`eff = window - U{0..window-1}`, exactly gensim's `reduced_window`),
unigram^0.75 negative distribution, linear LR decay alpha -> min_alpha,
both tables trained, per-epoch corpus shuffle, `min_count=0` implicit
(node ids are the vocabulary). hogwild is replaced by batched
deterministic SGD. The SURVEY.md §9 hs-vs-SGNS question was settled
empirically: SGNS holds F1 parity for the homophily models (DeepWalk
0.96 vs 0.97 on wiki) and is their default; Struc2Vec's structural
embeddings need the exact softmax (hs=1 default, train/hsoftmax.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@dataclass
class SkipGramConfig:
    embed_size: int = 128
    window: int = 5
    negative: int = 5  # gensim-equivalent negatives per pair (expectation)
    k_shared: int = 64  # shared negative rows drawn per walk group
    neg_share_packs: int = 4  # packing groups sharing one negative
    # set: r>1 divides the negative row gathers/scatters by r, raising
    # each negative row's per-step event weight r x (bounded by the
    # update cap). Wiki micro-F1 over 4 seeds: 0.9600 at r=4 vs 0.9595
    # at r=1; r=8 dips to 0.9577. Chosen before any H100 measurement;
    # its speed there is unmeasured (ROADMAP S4)
    neg_share_walks: int = 8  # walks per negative-sharing group
    epochs: int = 5
    block_walks: int = 4032  # walks per step (Bw); large blocks amortize
    # per-step gather/scatter overhead and, with the per-row update cap
    # bounding staleness, also measure *better* micro-F1 (0.941 @ 252
    # -> 0.965 @ 4032, 2-seed mean); clamped to the corpus for small
    # graphs. Speed on the H100 unmeasured (ROADMAP S4)
    alpha: float = 0.025
    min_alpha: float = 1e-4
    ns_exponent: float = 0.75
    neg_table_size: int = 1 << 20
    sample: float = 1e-3  # frequent-node subsampling threshold — the
    # gensim `Word2Vec(sample=1e-3)` default the reference inherits
    # (its models never override it); 0 disables
    chunk_steps: int = 64  # scan steps per compiled chunk
    update_cap: float = 8.0  # per-row accumulation cap (sequential-
    # update magnitudes a row may move per step; see the step fn)
    cap_mode: str = "auto"  # 'dense' | 'sparse' | 'auto': how the cap
    # is applied. dense scatters into a [V, 2D+1] buffer and applies the
    # cap as full-table rowwise passes — cheapest while V is small
    # (buffers stream at memory bandwidth, scatter rows are the minimum
    # possible). sparse never touches O(V·D) buffers: scatter occupancy
    # [V, 2] -> gather per-token scales -> scatter PRE-SCALED grads
    # straight into the donated table; ~3x the row issues but no
    # V-proportional streams, so it wins once V·D streams out-cost the
    # extra issues. auto picks by table size (see SkipGramTrainer.fit)
    shuffle_mode: str = "full"  # 'full' | 'block': per-epoch corpus
    # shuffle. 'block' permutes fixed walk blocks and rows within them
    # but keeps block membership, preserving per-step vertex locality
    # (blocks are consecutive start ranges when walks come from the
    # tiled-arange corpus generators) — corpus-order row clustering
    # for large-V runs; measured quality-neutral at 1M nodes
    rowshard_prefetch: bool = False  # rowshard mode: fetch step t+1's
    # rows before step t's update lands (SURVEY §8.4-6 double-buffered
    # halo; parallel/rowshard.py docstring). One step of row staleness
    # for fetch/compute overlap on real interconnects; default off — exact
    # synchronous updates are rowshard's contract
    dp_sync_every: int = 4  # 'dp'-mode replica sync cadence in steps
    # (parallel/sgns.py delta-SUM sync); 0 -> the module default (4).
    # Replica staleness was the dp quality gap: on the 120-node
    # community test micro-F1 is 0.54 syncing once per 64-step chunk,
    # 0.77 at 16, 0.98 at 4 and at 1 (2-seed mean, 8 devices). 4 keeps
    # the table allreduce amortized 4x with no measured loss vs 1.
    matmul_bf16: bool = False  # run the six gradient einsums with
    # bfloat16 operands + f32 accumulation; unmeasured on the H100
    # (ROADMAP S4 gives it an A/B under the quality gate)
    seed: int = 0


def corpus_counts(walks, num_nodes: int) -> np.ndarray:
    """Node frequency in the walk corpus (pads masked).

    Device corpora are counted with a jitted scatter-add (one compiled
    program, not an eager op-by-op scatter) so only the [V] counts
    cross to host, not the whole corpus.
    """
    if isinstance(walks, np.ndarray):
        ids = walks.reshape(-1)
        ids = ids[ids >= 0]
        return np.bincount(ids, minlength=num_nodes).astype(np.float64)
    return np.asarray(
        _device_counts(jnp.asarray(walks), num_nodes), dtype=np.float64
    )


@partial(jax.jit, static_argnames=("num_nodes",))
def _device_counts(walks, num_nodes):
    ids = walks.reshape(-1)
    valid = ids >= 0
    return jnp.zeros((num_nodes,), jnp.float32).at[
        jnp.where(valid, ids, 0)
    ].add(valid.astype(jnp.float32))


def negative_table(
    counts: np.ndarray, exponent: float = 0.75, size: int = 1 << 20
) -> np.ndarray:
    """Pre-sampled unigram^exponent table (word2vec's int lookup table).

    `table[i]` holds node ids so that sampling `table[U{0..size}]` draws
    from the unigram^exponent distribution with 1/size granularity.
    """
    p = np.power(np.maximum(counts, 0.0), exponent)
    total = p.sum()
    if total <= 0:
        p = np.ones_like(p)
        total = p.sum()
    cum = np.cumsum(p) / total
    return np.searchsorted(
        cum, (np.arange(size) + 0.5) / size, side="left"
    ).astype(np.int32)


def subsample_keep_probs(
    counts: np.ndarray, sample: float
) -> np.ndarray | None:
    """word2vec frequent-word downsampling keep-probabilities.

    gensim/word2vec.c rule: a node with corpus frequency f = count/total
    is kept with probability (sqrt(f/sample) + 1) * sample/f, clipped to
    1 (nodes rarer than `sample` are always kept). Returns None when
    sample <= 0 (subsampling disabled).
    """
    if sample <= 0:
        return None
    total = max(float(counts.sum()), 1.0)
    f = counts / total
    with np.errstate(divide="ignore", invalid="ignore"):
        p = (np.sqrt(f / sample) + 1.0) * (sample / f)
    return np.where(f > 0, np.minimum(p, 1.0), 0.0).astype(np.float32)


@jax.jit
def subsample_walks(walks, keep, key):
    """Drop tokens i.i.d. by keep[token] and compact each walk left.

    Compaction (stable argsort on the drop mask) reproduces gensim's
    semantics exactly: surviving tokens become adjacent, so skip-gram
    windows span across removed frequent nodes. Dropped tail positions
    are -1 (the corpus pad id). Redrawn every epoch, like gensim's
    per-pass sentence subsampling.
    """
    ok = walks >= 0
    kp = keep[jnp.where(ok, walks, 0)]
    km = ok & (jax.random.uniform(key, walks.shape) < kp)
    order = jnp.argsort(jnp.logical_not(km), axis=1, stable=True)
    return jnp.take_along_axis(jnp.where(km, walks, -1), order, axis=1)


def inverse_cdf_table(p, size: int):
    """Pre-sampled inverse-CDF lookup table, built on device.

    `table[j]` for grid points q_j = (j+0.5)/size equals
    `searchsorted(cumsum(p)/sum(p), q_j, 'left')` — word2vec's unigram
    table generalized to any positive weight vector — computed with a
    scatter+cumsum instead of searchsorted: weight i's CDF boundary
    lands at slot m_i = floor(cum_i*size + 0.5) and
    table[j] = #{i : m_i <= j}. Traceable (use inside jit).
    """
    n = p.shape[0]
    total = jnp.sum(p)
    p = jnp.where(total > 0, p, jnp.ones_like(p))
    cum = jnp.cumsum(p) / jnp.maximum(jnp.sum(p), 1.0)
    m = jnp.floor(cum * size + 0.5).astype(jnp.int32)
    # boundaries at/after the end contribute to no slot: park them in
    # an overflow slot and drop it
    m = jnp.where(m < size, jnp.clip(m, 0, size - 1), size)
    marks = jnp.zeros((size + 1,), jnp.int32).at[m].add(1)
    # inclusive cumsum over slots counts the CDF boundaries passed by
    # grid point j — exactly the searchsorted index. The final
    # weight's boundary sits at slot `size` (cum = 1.0), so in-range
    # slots top out at n-1; the clip only guards f32 edge rounding.
    return jnp.clip(jnp.cumsum(marks[:-1]), 0, n - 1)


@partial(
    jax.jit,
    static_argnames=("num_nodes", "size", "exponent", "sample"),
)
def _device_prep(walks, *, num_nodes, size, exponent, sample):
    """Fused on-device fit prep: counts -> negative table -> keep probs.

    The host path (pull counts to host, numpy power/cumsum/searchsorted,
    push the table back) moves [V] counts and a 4 MB table across the
    host boundary every fit; here nothing crosses it. The table is built
    exactly like `negative_table` (inverse CDF of unigram^exponent at
    (j+0.5)/size grid points) but with a scatter+cumsum instead of
    searchsorted: node i's boundary
    lands at m_i = floor(cum_i*size + 0.5), and
    table[j] = #{i : m_i <= j} reproduces `searchsorted(cum, q,
    'left')` slot-for-slot (modulo f32 rounding of the cumsum, ~1e-4
    relative — under the table's own 1/size granularity).
    """
    ids = walks.reshape(-1)
    valid = ids >= 0
    counts = jnp.zeros((num_nodes,), jnp.float32).at[
        jnp.where(valid, ids, 0)
    ].add(valid.astype(jnp.float32))

    table = inverse_cdf_table(
        jnp.power(jnp.maximum(counts, 0.0), exponent), size
    )

    if sample > 0:
        total_c = jnp.maximum(jnp.sum(counts), 1.0)
        f = counts / total_c
        kp = (jnp.sqrt(f / sample) + 1.0) * (sample / jnp.maximum(f, 1e-30))
        keep = jnp.where(f > 0, jnp.minimum(kp, 1.0), 0.0)
    else:
        keep = None
    return counts, table, keep


@jax.jit
def _gather_keep(walks, keep):
    """Per-token keep-probabilities [NW, L], gathered once per fit.

    Hoisting this gather out of the per-epoch pass (the corpus is fixed
    across epochs; only the row order changes) and shuffling it with the
    same permutation replaces a per-epoch random gather of every corpus
    token from keep[V] by one gather per fit.
    """
    return keep[jnp.maximum(walks, 0)]


def _subsample_compact(w, kprob, ks):
    """Drop tokens i.i.d. by kprob and left-compact each walk.

    Shared body of both per-epoch prep variants — the gensim-parity
    semantics (keyed stable sort so windows span dropped tokens,
    -1 pads) must stay bit-identical between them.
    """
    km = (w >= 0) & (jax.random.uniform(ks, w.shape) < kprob)
    dropped = jnp.logical_not(km).astype(jnp.uint8)
    _, out = jax.lax.sort(
        (dropped, jnp.where(km, w, -1)),
        dimension=1, is_stable=True, num_keys=1,
    )
    return out


@jax.jit
def _prepare_epoch(walks, keep_tok, key):
    """Fused per-epoch corpus pass: shuffle + subsample + compact.

    One compiled program replacing `_shuffle_walks` then
    `subsample_walks`: permute rows, drop tokens i.i.d. by the
    pre-gathered keep probabilities, and left-compact each walk with a
    keyed `lax.sort` (payload rides the sort — no argsort +
    take_along_axis gather round). Dropped positions become -1 pads.
    """
    kp, ks = jax.random.split(key)
    perm = jax.random.permutation(kp, walks.shape[0])
    return _subsample_compact(walks[perm], keep_tok[perm], ks)


# Float32 products of the block gradients run at DEFAULT precision:
# TF32 on the H100's tensor cores (10-bit mantissa, float32
# accumulation), full float32 on the CPU. SGNS is stochastic SGD and the
# wiki quality gate holds at TF32 (chip_smoke.py); comparisons against
# the float64 reference pass `precision=HIGHEST`.
MATMUL_PRECISION = jax.lax.Precision.DEFAULT


@jax.named_scope("sgns_block_grads")
def sgns_block_grads_xla(yin, yout, vn, mask, neg_ok, neg_w,
                         bf16=False, precision=MATMUL_PRECISION):
    """Block gradients and loss of packed SGNS groups (plain XLA).

    Shapes: yin/yout [G, PL, D], mask [G, PL, PL]; vn [G2, K, D] and
    neg_ok [G2, (G//G2)*PL, K] where G2 divides G — when G2 < G,
    r = G // G2 consecutive packing groups share one negative set
    (`neg_share_packs`). Returns (d_yin [G, PL, D], d_yout [G, PL, D],
    d_vn [G2, K, D], loss [G]); each sharing group's negative loss is
    spread evenly over its r members. Its operations carry the
    `sgns_block_grads` name scope, which a device trace reads.

    bf16=True runs the six einsums with bfloat16 operands and f32
    accumulation; logits land in f32, so only the ~3-decimal-digit
    rounding of the embedding rows themselves differs. The tables,
    gradients, and SGD update stay f32.
    """
    cd = jnp.bfloat16 if bf16 else jnp.float32
    ein = partial(jnp.einsum, preferred_element_type=jnp.float32,
                  precision=precision)
    G, PL, D = yin.shape
    G2 = vn.shape[0]
    r = G // G2
    yin_c, yout_c, vn_c = yin.astype(cd), yout.astype(cd), vn.astype(cd)
    logits = ein("gld,gmd->glm", yin_c, yout_c)
    g_pos = (jax.nn.sigmoid(logits) - 1.0) * mask
    yin_n = yin_c.reshape(G2, r * PL, D)
    nlog = ein("gld,gkd->glk", yin_n, vn_c)
    n_pairs = jnp.sum(mask, axis=2)
    np_n = n_pairs.reshape(G2, r * PL)
    g_neg = jax.nn.sigmoid(nlog) * (np_n * neg_w)[:, :, None] * neg_ok
    d_yin = ein("glm,gmd->gld", g_pos.astype(cd), yout_c)
    d_yin = d_yin + ein("glk,gkd->gld", g_neg.astype(cd),
                        vn_c).reshape(G, PL, D)
    d_yout = ein("glm,gld->gmd", g_pos.astype(cd), yin_c)
    d_vn = ein("glk,gld->gkd", g_neg.astype(cd), yin_n)
    loss = -(
        jnp.sum(jnp.where(mask > 0, jax.nn.log_sigmoid(logits), 0.0)
                * mask, axis=(1, 2))
        + jnp.sum(jax.nn.log_sigmoid(-nlog)
                  * (np_n * neg_w)[:, :, None] * neg_ok,
                  axis=(1, 2)).reshape(G2).repeat(r) / r
    )
    return d_yin, d_yout, d_vn, loss


@partial(
    jax.jit,
    static_argnames=(
        "chunk_steps",
        "block_walks",
        "window",
        "negative",
        "k_shared",
        "neg_share_walks",
        "neg_share_packs",
        "update_cap",
        "sparse_cap",
        "matmul_bf16",
        "stale_groups",
    ),
    donate_argnums=(0,),
)
def sgns_block_chunk_cat(
    w_cat,
    walks,
    neg_table,
    key,
    alpha,
    min_alpha,
    t0,
    total_steps,
    *,
    chunk_steps,
    block_walks,
    window,
    negative,
    k_shared,
    neg_share_walks,
    neg_share_packs=1,
    update_cap=8.0,
    sparse_cap=False,
    matmul_bf16=False,
    stale_groups=1,
):
    """`chunk_steps` SGNS steps over consecutive walk blocks (one scan).

    Step t trains on walks [((t0+t) % n_blocks)*Bw : +Bw]. All RNG is
    bulk-generated before the scan (no small RNG kernels per step); the
    loop body is gathers, batched matmuls, and scatter-adds.
    """
    S, Bw, W, K = chunk_steps, block_walks, window, k_shared
    NW, L = walks.shape
    V, C = w_cat.shape
    D = C // 2
    Bw = min(Bw, NW)  # direct callers may pass a block larger than the
    # corpus (the default is tuned for wiki scale); clamp before packing

    # --- walk packing (matmul tile efficiency) ------------------------
    # A [L, L] window-logit matmul (L = 10 typically) is far below any
    # matrix unit's tile. Packing P = 128 // L walks into one
    # [P·L, P·L] tile with a block-diagonal mask computes the same
    # pairs in ~P× fewer, larger products. The 128 was chosen before
    # any H100 measurement; unmeasured there (ROADMAP S4). The packing
    # group doubles as the negative-sharing group (`neg_share_walks` is
    # treated as a lower bound folded into P).
    P = max(min(max(128 // L, 1), Bw), 1)
    G = Bw // P  # packed groups per step
    PL = P * L
    Bw = G * P  # round the block down to whole packing groups so a
    # caller-supplied block_walks that P doesn't divide still works
    # (the trainer pre-rounds; direct callers like bench.py may not)
    n_blocks = max(NW // Bw, 1)
    del neg_share_walks  # superseded by the packing group
    nsp = max(int(neg_share_packs), 1)
    while G % nsp:  # need whole sharing groups; fall back toward 1
        nsp -= 1
    G2 = G // nsp

    k1, k2 = jax.random.split(jax.random.fold_in(key, t0))
    # dynamic window shrink per center occurrence: eff in {1..W}
    eff = W - (
        jax.random.uniform(k1, (S, G, PL)) * W
    ).astype(jnp.int32).clip(0, W - 1)
    # group-shared negatives: table lookup, no searchsorted
    neg_idx = jax.random.randint(
        k2, (S, G2, K), 0, neg_table.shape[0], dtype=jnp.int32
    )
    negs = neg_table[neg_idx]  # [S, G2, K]
    steps = t0 + jnp.arange(S, dtype=jnp.int32)
    lrs = jnp.maximum(
        min_alpha,
        alpha * (1.0 - steps.astype(jnp.float32) / total_steps),
    )
    offs = (steps % n_blocks) * Bw

    # static packed-window geometry on [PL, PL]: position i is walk
    # i//L, offset i%L; pairs valid only within the same walk
    igrid = jax.lax.broadcasted_iota(jnp.int32, (PL, PL), 0)
    jgrid = jax.lax.broadcasted_iota(jnp.int32, (PL, PL), 1)
    same_walk = (igrid // L) == (jgrid // L)
    dm = jnp.abs(jgrid % L - igrid % L)
    window_ok = same_walk & (dm >= 1) & (dm <= W)  # [PL, PL]

    neg_w = float(negative) / K

    # --- fused table layout (row-issue economy) -----------------------
    # The step is designed to minimize row gathers and scatters:
    #   * w_in and w_out live in ONE [V, 2D] table — each token costs
    #     one gather and one scatter instead of two of each;
    #   * the per-row occupancy counts needed by the update cap ride
    #     along as an extra column of the SAME gradient scatter (into a
    #     zeroed buffer), replacing two scalar scatter+gather rounds;
    #     the cap is then applied as a dense rowwise multiply, exactly
    #     equivalent since the cap scale is constant per row.
    # The caller passes the fused [V, 2D] table directly: a per-chunk
    # concatenate+split would transiently DOUBLE the table footprint
    # (10 GB at 10M nodes).

    def gather_block(wc, off, neg):
        """Token + negative rows for the block at `off` from table `wc`."""
        tok = jax.lax.dynamic_slice(walks, (off, 0), (Bw, L))
        tok = tok.reshape(G, PL)
        y = wc[jnp.where(tok >= 0, tok, 0)]  # [G, PL, 2D] — one gather
        vn = wc[neg][..., D:]  # [G2, K, D]
        return tok, y, vn

    def apply_block(w_cat, tok, y, vn, eff_b, neg, lr):
        # eff_b: [G, PL], neg: [G2, K]
        tok_ok = tok >= 0
        tok_safe = jnp.where(tok_ok, tok, 0)
        yin = y[..., :D]
        yout = y[..., D:]

        mask = (
            window_ok[None]
            & (dm[None] <= eff_b[:, :, None])
            & tok_ok[:, :, None]
            & tok_ok[:, None, :]
        ).astype(jnp.float32)

        n_pairs = jnp.sum(mask, axis=2)  # [G, PL]
        # skip negatives that equal the center (gensim's collision skip)
        tok_n = tok_safe.reshape(G2, nsp * PL)
        neg_ok = (neg[:, None, :] != tok_n[:, :, None]).astype(
            jnp.float32
        )

        d_yin, d_yout, d_vn, loss_g = sgns_block_grads_xla(
            yin, yout, vn, mask, neg_ok, neg_w, bf16=matmul_bf16
        )

        # --- per-row accumulation cap (stability) ------------------------
        # Within a batched step, a row touched by R occurrences/events
        # accumulates R× the gradient at STALE logits; sequential SGD
        # (gensim) interleaves re-reads and self-limits, batched SGD
        # overshoots and diverges (measured). Scale each row's summed
        # update by min(1, cap/R): rows move at most `cap`
        # sequential-update magnitudes per step, matching hogwild's
        # effective staleness (~thread count) while keeping full-rate
        # learning for the typical R ≤ cap row.
        cap = jnp.float32(update_cap)
        flat = tok_safe.reshape(-1)
        nflat = neg.reshape(-1)
        # negative rows: accumulated event weight = n_pairs·neg_w summed
        # over the sharing group's centers (σ ≤ 1), plus cross-group
        # collisions
        neg_weight = jnp.broadcast_to(
            jnp.sum(
                n_pairs.reshape(G2, nsp * PL) * neg_w, axis=1
            )[:, None],
            (G2, K),
        ).reshape(-1)
        if sparse_cap:
            # large-V path: no O(V·D) buffer. Occupancy first (two
            # [V]-sized f32 vectors — 1-D scatters rather than 2-D
            # element scatters like .at[idx, col]), then scales are
            # gathered back per token/negative and the grads scattered
            # PRE-SCALED into the donated table in ONE full-width row
            # scatter. Same
            # math: the cap scale is constant per row, so scaling each
            # contribution equals scaling the row's sum.
            occ_t = jnp.zeros((V,), jnp.float32).at[flat].add(1.0)
            occ_n = jnp.zeros((V,), jnp.float32).at[nflat].add(
                neg_weight
            )
            tok_scale = jnp.minimum(
                1.0, cap / jnp.maximum(occ_t[flat], 1.0)
            )
            neg_scale = jnp.minimum(
                1.0, cap / jnp.maximum(occ_n[nflat], 1.0)
            )
            d_tok = jnp.concatenate(
                [d_yin.reshape(-1, D), d_yout.reshape(-1, D)], axis=1
            ) * tok_scale[:, None]
            d_neg_full = jnp.concatenate(
                [
                    jnp.zeros((G2 * K, D), jnp.float32),
                    d_vn.reshape(-1, D) * neg_scale[:, None],
                ],
                axis=1,
            )
            upd = jnp.concatenate([d_tok, d_neg_full], axis=0)
            idx = jnp.concatenate([flat, nflat], axis=0)
            w_cat = w_cat.at[idx].add((-lr) * upd)
        else:
            # token-gradient buffer: [.., :2D] grads, [.., 2D] occupancy
            d_tok = jnp.concatenate(
                [
                    d_yin.reshape(-1, D),
                    d_yout.reshape(-1, D),
                    jnp.ones((G * PL, 1), jnp.float32),
                ],
                axis=1,
            )
            tbuf = jnp.zeros((V, 2 * D + 1), jnp.float32).at[flat].add(
                d_tok
            )
            tok_scale = jnp.minimum(
                1.0, cap / jnp.maximum(tbuf[:, 2 * D], 1.0)
            )[:, None]
            d_neg = jnp.concatenate(
                [d_vn.reshape(-1, D), neg_weight[:, None]], axis=1
            )
            nbuf = jnp.zeros((V, D + 1), jnp.float32).at[nflat].add(
                d_neg
            )
            neg_scale = jnp.minimum(
                1.0, cap / jnp.maximum(nbuf[:, D], 1.0)
            )[:, None]

            w_cat = w_cat + (-lr) * tbuf[:, : 2 * D] * tok_scale
            w_cat = w_cat.at[:, D:].add(
                (-lr) * nbuf[:, :D] * neg_scale
            )

        n_tot = jnp.maximum(jnp.sum(mask), 1.0)
        loss = jnp.sum(loss_g) / n_tot
        pairs = jnp.sum(mask)
        return w_cat, loss, pairs

    # --- cross-step pipelining (stale_groups) -------------------------
    # With A = stale_groups > 1, each scan iteration gathers A blocks
    # from the SAME table state up front, then applies their updates
    # sequentially. Step i+1's gather no longer depends on step i's
    # scatter+add inside a group, so XLA is free to run the gather
    # stream concurrently with the scatter stream — the overlap the
    # steady-state roofline (pairs / max(t_gather, t_scatter),
    # utils/profiling.py) prices in. Cost: updates within a group see
    # a table up to A-1 steps stale — the same staleness class as
    # gensim's hogwild threads (whose effective staleness is the
    # thread count), bounded by the per-row update cap. A must divide
    # the chunk; it is clamped down to the nearest divisor.
    A = max(int(stale_groups), 1)
    while S % A:
        A -= 1

    if A == 1:
        def step(carry, xs):
            w_cat = carry
            off, eff_b, neg, lr = xs
            tok, y, vn = gather_block(w_cat, off, neg)
            w_cat, loss, pairs = apply_block(
                w_cat, tok, y, vn, eff_b, neg, lr
            )
            return w_cat, (loss, pairs)

        w_cat, (losses, pairs) = jax.lax.scan(
            step, w_cat, (offs, eff, negs, lrs)
        )
        return w_cat, losses, pairs

    def step_group(carry, xs):
        w_cat = carry
        off_a, eff_a, neg_a, lr_a = xs  # leading dim A
        gathered = [
            gather_block(w_cat, off_a[i], neg_a[i]) for i in range(A)
        ]
        losses, pairs = [], []
        for i in range(A):
            tok, y, vn = gathered[i]
            w_cat, loss, p = apply_block(
                w_cat, tok, y, vn, eff_a[i], neg_a[i], lr_a[i]
            )
            losses.append(loss)
            pairs.append(p)
        return w_cat, (jnp.stack(losses), jnp.stack(pairs))

    xs = (
        offs.reshape(S // A, A),
        eff.reshape(S // A, A, G, PL),
        negs.reshape(S // A, A, G2, K),
        lrs.reshape(S // A, A),
    )
    w_cat, (losses, pairs) = jax.lax.scan(step_group, w_cat, xs)
    return w_cat, losses.reshape(S), pairs.reshape(S)


def sgns_block_chunk(w_in, w_out, walks, neg_table, key, alpha,
                     min_alpha, t0, total_steps, **kw):
    """Split-table wrapper over `sgns_block_chunk_cat`.

    Kept for direct callers (bench.py, tests) at small V; the trainer
    itself carries the fused [V, 2D] table across chunks and never
    pays the concat/split copies.
    """
    w_cat = jnp.concatenate([jnp.asarray(w_in), jnp.asarray(w_out)],
                            axis=1)
    D = w_cat.shape[1] // 2
    w_cat, losses, pairs = sgns_block_chunk_cat(
        w_cat, walks, neg_table, key, alpha, min_alpha, t0,
        total_steps, **kw
    )
    return w_cat[:, :D], w_cat[:, D:], losses, pairs


@partial(jax.jit, donate_argnums=())
def _shuffle_walks(walks, key):
    return walks[jax.random.permutation(key, walks.shape[0])]


@partial(jax.jit, static_argnames=("bw",))
def _blocked_perm(walks, key, bw):
    """Block-preserving shuffle: permute whole bw-row blocks and rows
    within each block, never across blocks — keeps each training
    block's vertex locality (cfg.shuffle_mode='block').

    The corpus is first ROLLED by a per-epoch random offset so the
    NW mod bw remainder rows (which the step loop never trains) are
    different rows each epoch — without the roll the same walks would
    get zero gradient in every epoch. Rolling keeps rows consecutive,
    so block locality survives (one wrap block excepted)."""
    NW = walks.shape[0]
    bw = min(bw, NW)  # corpus smaller than one block: shrink the block
    nb = max(NW // bw, 1)
    k1, k2, k3 = jax.random.split(key, 3)
    walks = jnp.roll(
        walks, jax.random.randint(k3, (), 0, NW), axis=0
    )
    main = walks[: nb * bw].reshape(nb, bw, -1)
    main = main[jax.random.permutation(k1, nb)]
    idx = jnp.argsort(jax.random.uniform(k2, (nb, bw)), axis=1)
    main = jnp.take_along_axis(main, idx[:, :, None], axis=1)
    return jnp.concatenate(
        [main.reshape(nb * bw, walks.shape[1]), walks[nb * bw:]], axis=0
    )


@partial(jax.jit, static_argnames=("bw",))
def _prepare_epoch_blocked(walks, keep, key, bw):
    """Blocked shuffle + subsample in ONE compiled program (no eager
    per-epoch gathers, each its own dispatch)."""
    k1, k2 = jax.random.split(key)
    w = _blocked_perm(walks, k1, bw)
    return _subsample_compact(w, keep[jnp.maximum(w, 0)], k2)


@partial(jax.jit, static_argnames=("n", "embed_size"),
         donate_argnums=(0,))
def _fill_rows(w, key, lo, n, embed_size):
    # lo is TRACED (dynamic_update_slice takes dynamic starts): only
    # the block shape keys the compile cache, so the init compiles at
    # most twice (full blocks + remainder) however many blocks run
    blk = (jax.random.uniform(key, (n, embed_size)) - 0.5) / embed_size
    return jax.lax.dynamic_update_slice(
        w, jnp.concatenate(
            [blk, jnp.zeros((n, embed_size), jnp.float32)], axis=1
        ), (lo, 0),
    )


@jax.jit
def _prepare_epoch_regather(walks, keep, key):
    """Per-epoch shuffle+subsample that re-gathers keep-probs.

    Same semantics as `_prepare_epoch`, but reads keep[V] per token
    instead of a pre-gathered per-token buffer. The hoisted buffer
    saves a per-epoch random gather, but at 10M nodes its [NW, L] f32
    (plus the permuted copy inside the fused pass) is the difference
    between fitting in device memory and OOM — the trainer switches on
    corpus size.
    """
    kp, ks = jax.random.split(key)
    perm = jax.random.permutation(kp, walks.shape[0])
    w = walks[perm]
    return _subsample_compact(w, keep[jnp.maximum(w, 0)], ks)


def plan_block_walks(NW, L, num_nodes, cfg) -> int:
    """Block-size policy for a corpus of NW walks of length L.

    - round the block to a multiple of the packing factor P = 128//L
      (see sgns_block_chunk) so every walk in a block trains;
    - cap at NW//4 so tiny corpora keep >= 4 sequential blocks per
      epoch (a single whole-corpus block loses the sequential
      structure SGD needs — measured on 120-node graphs);
    - LARGE corpora run bigger blocks: scattered row WRITES on
      GB-scale tables are latency-bound, and more rows in flight per
      step hide more of it. Larger blocks are QUALITY-SAFE under the
      per-row update cap (100k-node 40-class SBM, 2 seeds: micro-F1
      0.957 @4032, 0.956 @16128, 0.965 @32256). >=128 blocks of corpus
      work gates the 4x step, >=256 the 8x; never upscale when the
      table passes 6 GB (its chunk temporaries must fit beside it).
      Small corpora keep the default. These tiers and the 6 GB gate
      were set before any H100 measurement and are unmeasured there
      (ROADMAP R5, S4).
    """
    P = max(min(max(128 // L, 1), NW), 1)
    bw = min(block_upscale(NW, num_nodes, cfg), max(NW // 4, P))
    return max((bw // P) * P, P)


def block_upscale(NW, num_nodes, cfg) -> int:
    """The large-corpus tier of the block policy alone (no packing
    rounding) — shared with the distributed trainer, whose per-device
    packing rounds differently."""
    bw_req = cfg.block_walks
    table_bytes = num_nodes * 2 * cfg.embed_size * 4
    if table_bytes <= (6 << 30):
        if NW >= 256 * cfg.block_walks:
            bw_req = 8 * cfg.block_walks
        elif NW >= 128 * cfg.block_walks:
            bw_req = 4 * cfg.block_walks
    return bw_req


class SkipGramTrainer:
    """High-level SGNS fit over a walk corpus."""

    def __init__(self, config: SkipGramConfig | None = None, **kw):
        self.config = config or SkipGramConfig(**kw)

    def init_tables(self, num_nodes, key):
        cfg = self.config
        # gensim init: input ~ U(-0.5/D, 0.5/D), output zeros
        w_in = (
            jax.random.uniform(key, (num_nodes, cfg.embed_size)) - 0.5
        ) / cfg.embed_size
        w_out = jnp.zeros((num_nodes, cfg.embed_size), jnp.float32)
        return w_in, w_out

    def _init_cat(self, num_nodes, key):
        """Fused [V, 2D] table init — one allocation, no concat.

        Filled in row blocks with donation so the peak is the table
        plus one block-sized RNG temp (a whole-table uniform temp is
        another V*D*4 bytes — 5 GB at 10M nodes, the difference
        between fitting and OOM next to the 10 GB table itself).
        """
        D = self.config.embed_size
        w = jnp.zeros((num_nodes, 2 * D), jnp.float32)
        block = max(min(num_nodes, (1 << 27) // max(2 * D, 1)), 1)
        for i, lo in enumerate(range(0, num_nodes, block)):
            n = min(block, num_nodes - lo)
            w = _fill_rows(
                w, jax.random.fold_in(key, i), jnp.int32(lo), n, D
            )
        return w

    def fit(self, walks, num_nodes, key=None, checkpoint_dir=None,
            checkpoint_every=0, metrics=None):
        """Train tables over the corpus; returns (w_in, w_out, losses).

        checkpoint_dir/-every: Orbax-checkpoint (tables, step) every N
        chunks and resume from the latest checkpoint if one exists —
        the restartable step loop of SURVEY.md §6. `metrics`: optional
        utils.metrics.MetricsLogger for per-chunk loss/pairs lines.
        """
        cfg = self.config
        if key is None:
            key = jax.random.PRNGKey(cfg.seed)
        k_init, k_shuf, k_train, k_sub = jax.random.split(key, 4)

        from graphembedding.utils.debug import validation_enabled

        if validation_enabled():
            from graphembedding.utils.debug import validate_walks

            validate_walks(np.asarray(walks), num_nodes)
        walks = jnp.asarray(walks)
        NW, L = walks.shape
        bw = plan_block_walks(NW, L, num_nodes, cfg)
        n_blocks = max(NW // bw, 1)
        steps_per_epoch = n_blocks
        chunks_per_epoch = max(
            (steps_per_epoch + cfg.chunk_steps - 1) // cfg.chunk_steps, 1
        )
        # LR decays over steps actually EXECUTED: every chunk runs
        # chunk_steps steps (wrapping over blocks), so small corpora
        # run many more steps than n_blocks per epoch
        n_steps = cfg.epochs * chunks_per_epoch * cfg.chunk_steps

        # negative table from RAW counts (gensim builds it from the
        # vocab, before subsampling) and the subsampling keep-probs,
        # built fully on device — the host build + table upload cost
        # ~2.5 s per fit at 1M nodes (see _device_prep)
        _, table, keep = _device_prep(
            walks,
            num_nodes=num_nodes,
            size=cfg.neg_table_size,
            exponent=cfg.ns_exponent,
            sample=cfg.sample,
        )
        # hoisted per-token keep buffer below ~512 MB, else re-gather
        # per epoch (see _prepare_epoch_regather); a budget set before
        # any H100 measurement, unmeasured there (ROADMAP R5)
        big_corpus = walks.size * 4 > (512 << 20)
        keep_tok = (
            None if (keep is None or big_corpus)
            else _gather_keep(walks, keep)
        )

        # tables are allocated AFTER the corpus prep: at 10M nodes
        # they are ~10 GB, and prep's whole-corpus temporaries need
        # the room while the tables don't exist yet.
        # Restore is checked FIRST so a resume never also builds the
        # init table (init + two uploaded halves + device concat would
        # peak ~3x the table)
        resume_step = 0
        w_cat = None
        if checkpoint_dir:
            from graphembedding.utils.checkpoint import try_restore

            state = try_restore(
                checkpoint_dir, ("w_in", "w_out", "step")
            )
            if state is not None:
                # concat on HOST, upload once: device peak = one table
                w_cat = jnp.asarray(np.concatenate(
                    [np.asarray(state["w_in"]),
                     np.asarray(state["w_out"])], axis=1,
                ))
                resume_step = int(state["step"])
        if w_cat is None:
            w_cat = self._init_cat(num_nodes, k_init)

        if cfg.cap_mode == "auto":
            # dense cap passes stream ~3.5 × V×(2D+1) f32 per step;
            # sparse swaps them for ~2 extra row-gather/scatter rounds
            # over the ~Bw·(L+K/P) touched rows, so sparse wins at
            # large V. The 2^16 cut-over was set before any H100
            # measurement (benchmarks/table_scale.py re-measures it;
            # ROADMAP S4)
            sparse_cap = num_nodes >= (1 << 16)
        else:
            sparse_cap = cfg.cap_mode == "sparse"

        losses = []
        pairs_seen = []
        t = 0
        n_chunk_calls = 0
        total_steps = jnp.float32(n_steps)
        epoch_steps = chunks_per_epoch * cfg.chunk_steps
        for epoch in range(cfg.epochs):
            if t + epoch_steps <= resume_step:
                t += epoch_steps  # fully-resumed epoch: skip its
                continue  # corpus shuffle too
            if cfg.shuffle_mode == "block":
                # block-preserving shuffle (windowed-scatter locality);
                # subsampling still applies, AFTER the permutation, so
                # compaction never crosses block rows
                if keep is not None:
                    shuffled = _prepare_epoch_blocked(
                        walks, keep, jax.random.fold_in(k_sub, epoch),
                        bw,
                    )
                else:
                    shuffled = _blocked_perm(
                        walks, jax.random.fold_in(k_shuf, epoch), bw
                    )
            elif keep_tok is not None:
                shuffled = _prepare_epoch(
                    walks, keep_tok, jax.random.fold_in(k_sub, epoch)
                )
            elif keep is not None:
                shuffled = _prepare_epoch_regather(
                    walks, keep, jax.random.fold_in(k_sub, epoch)
                )
            else:
                shuffled = _shuffle_walks(
                    walks, jax.random.fold_in(k_shuf, epoch)
                )
            for c in range(chunks_per_epoch):
                if t < resume_step:
                    t += cfg.chunk_steps
                    continue
                w_cat, l, p = sgns_block_chunk_cat(
                    w_cat,
                    shuffled,
                    table,
                    k_train,
                    jnp.float32(cfg.alpha),
                    jnp.float32(cfg.min_alpha),
                    jnp.int32(t),
                    total_steps,
                    chunk_steps=cfg.chunk_steps,
                    block_walks=bw,
                    window=cfg.window,
                    negative=cfg.negative,
                    k_shared=min(cfg.k_shared, num_nodes),
                    neg_share_walks=cfg.neg_share_walks,
                    neg_share_packs=cfg.neg_share_packs,
                    update_cap=cfg.update_cap,
                    sparse_cap=sparse_cap,
                    matmul_bf16=cfg.matmul_bf16,
                )
                losses.append(l)
                pairs_seen.append(p)
                t += cfg.chunk_steps
                n_chunk_calls += 1
                if metrics is not None:
                    metrics.log(
                        kind="sgns_chunk", epoch=epoch, step=t,
                        loss=round(float(l.mean()), 5),
                    )
                if checkpoint_dir and checkpoint_every:
                    from graphembedding.utils.checkpoint import (
                        maybe_save,
                    )

                    D = cfg.embed_size
                    maybe_save(
                        checkpoint_dir, checkpoint_every, n_chunk_calls,
                        lambda: {
                            "w_in": np.asarray(w_cat[:, :D]),
                            "w_out": np.asarray(w_cat[:, D:]),
                            "step": np.asarray(t),
                        },
                    )
        if not losses:  # fully resumed past the end
            losses = [jnp.zeros((0,), jnp.float32)]
        # observability: total (center, context) pairs actually trained
        # this fit — benchmarks read this for exact pairs/s
        self.trained_pairs_ = (
            float(jnp.concatenate(pairs_seen).sum()) if pairs_seen
            else 0.0
        )
        D = cfg.embed_size
        if w_cat.size * 4 > (2 << 30):
            # huge tables: splitting on device would transiently hold
            # w_cat + BOTH half-copies (20 GB at 10M nodes); the 2 GB
            # switch is unmeasured on the H100 (ROADMAP R5);
            # pull each half to host sequentially instead (peak =
            # w_cat + one half). Callers np.asarray the result anyway.
            w_in = np.asarray(w_cat[:, :D])
            w_out = np.asarray(w_cat[:, D:])
            return w_in, w_out, jnp.concatenate(losses)
        return w_cat[:, :D], w_cat[:, D:], jnp.concatenate(losses)
