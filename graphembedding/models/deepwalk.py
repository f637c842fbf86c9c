"""DeepWalk (Perozzi et al., KDD'14) — uniform walks + skip-gram.

Reference counterpart: `ge/models/deepwalk.py [U]`: eager
`RandomWalker(G, p=1, q=1).simulate_walks(...)` then gensim
`Word2Vec(sg=1, hs=1, min_count=0)`. Device redesign: walks are one batched
device kernel (`ops.walk.uniform_walks`); training is SGNS (see
SURVEY.md §9 on the hs=1 -> negative-sampling decision).
"""

from __future__ import annotations

import jax

from graphembedding.models.base import WalkEmbeddingModel
from graphembedding.ops.walk import simulate_walks


class DeepWalk(WalkEmbeddingModel):
    def __init__(self, graph, walk_length=10, num_walks=80, workers=1,
                 seed=0, mesh=None, walk_exchange=None):
        """`mesh=` runs the WALK phase sharded too (edge-partitioned
        CSR + hub-safe routed walkers, `parallel.walks`) — the scale
        path for graphs that exceed one card's memory; `train()` then
        defaults to the same mesh. Without it the replicated
        single-card kernel is used (faster at reference scale).

        `walk_exchange='a2a'` selects the crossers-only exact-exchange
        engine (constant per-shard wire in mesh size — the large-mesh
        form); default None = the all_gather engine,
        which wins on small meshes."""
        del workers  # reference API parity; device parallelism instead
        super().__init__(graph, walk_length, num_walks, seed)
        self.mesh = mesh
        if mesh is not None:
            from graphembedding.parallel.walks import (
                DistributedWalker,
            )

            walker = DistributedWalker(
                self.graph, mesh, walk_length, kind="uniform",
                num_walks=num_walks, exchange=walk_exchange,
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
                kind="uniform",
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
