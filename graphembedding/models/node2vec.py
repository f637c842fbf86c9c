"""Node2Vec (Grover & Leskovec, KDD'16) — (p,q)-biased second-order walks.

Reference counterpart: `ge/models/node2vec.py [U]`:
`RandomWalker(G, p, q, use_rejection_sampling)` with either per-edge alias
tables (O(E·d) memory) or rejection sampling, then gensim
`Word2Vec(sg=1, hs=0)` (negative sampling). Device redesign: the default walk
kernel is the *exact* dense second-order sampler (`ops.walk.node2vec_walks`
— Gumbel-max over the padded neighbor row with membership tests by binary
search), which needs no O(E·d) table at all; `use_rejection_sampling=True`
selects the KnightKing-style bounded-retry kernel instead (cheaper per step
on low-degree graphs).
"""

from __future__ import annotations

import jax

from graphembedding.models.base import WalkEmbeddingModel
from graphembedding.ops.walk import simulate_walks


class Node2Vec(WalkEmbeddingModel):
    def __init__(
        self,
        graph,
        walk_length=10,
        num_walks=80,
        p=1.0,
        q=1.0,
        workers=1,
        use_rejection_sampling=None,
        seed=0,
        mesh=None,
    ):
        """`mesh=` runs the (p,q) walk phase sharded (partitioned
        neighbor matrix + halo row fetch, or CSR-only rejection
        sampling on the rejection path — the Dmax-safe variant for
        power-law graphs); `train()` then defaults to the same mesh.

        `use_rejection_sampling=None` (default) picks the kernel
        automatically from the graph's degree profile and memory
        footprint (`ops.walk.select_pq_kernel`: by padded degree, or
        when the [V, Dpad] neighbor matrix would exceed its memory
        budget). Pass True/False to force
        (reference flag semantics: 0/False = the exact formulation)."""
        del workers
        super().__init__(graph, walk_length, num_walks, seed)
        self.p = p
        self.q = q
        if use_rejection_sampling is None:
            from graphembedding.ops.walk import select_pq_kernel

            # the mesh path partitions the [V, Dpad] neighbor matrix
            # across the data axis, so the per-card memory gate scales
            # with the mesh (a 10M-node graph that busts one card's
            # budget fits fine across 8)
            n_parts = (
                mesh.shape.get("data", 1) if mesh is not None else 1
            )
            use_rejection_sampling = select_pq_kernel(
                self.graph.num_nodes, self.graph.max_degree, p, q,
                hbm_budget_bytes=(4 << 30) * n_parts,
            ) in ("rejection", "rejection_dense")
        self.use_rejection_sampling = bool(use_rejection_sampling)
        self.mesh = mesh
        if mesh is not None:
            from graphembedding.parallel.walks import (
                DistributedWalker,
            )

            walker = DistributedWalker(
                self.graph, mesh, walk_length,
                kind=("node2vec_rejection"
                      if self.use_rejection_sampling else "node2vec"),
                num_walks=num_walks, p=p, q=q,
            )
            self.walks, self.walk_overflow = walker.run(
                jax.random.PRNGKey(seed)
            )
        else:
            self.walks = simulate_walks(
                self.graph,
                num_walks,
                walk_length,
                jax.random.PRNGKey(seed),
                kind="node2vec",
                p=p,
                q=q,
                use_rejection_sampling=self.use_rejection_sampling,
            )

    def train(self, embed_size=128, window_size=5, workers=None, iter=5,
              **kwargs):
        return self._fit_skipgram(
            embed_size=embed_size,
            window_size=window_size,
            workers=workers,
            iter=iter,
            **kwargs,
        )
