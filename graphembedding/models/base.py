"""Shared machinery for the walk + skip-gram model family.

Reference counterpart: the `__init__(graph,…)/train(…)/get_embeddings()`
surface every model class exposes (`ge/models/*.py [U]`). Models accept
either a networkx graph (reference API) or a `graphembedding.Graph`.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import numpy as np

from graphembedding.graph import Graph
from graphembedding.train.skipgram import SkipGramConfig, SkipGramTrainer


def as_graph(graph) -> Graph:
    if isinstance(graph, Graph):
        return graph
    return Graph.from_nx(graph)


class WalkEmbeddingModel:
    """Base for DeepWalk / Node2Vec / Struc2Vec: walks -> SGNS -> table."""

    def __init__(self, graph, walk_length: int, num_walks: int, seed: int = 0):
        self.graph = as_graph(graph)
        self.walk_length = walk_length
        self.num_walks = num_walks
        self.seed = seed
        self.mesh = None  # set by subclasses that took mesh=
        self.walk_overflow = 0  # distributed-walk drops (mesh paths)
        self.walks = None  # device i32 [num_walks * V, walk_length]
        self.w_in = None
        self.w_out = None
        self.losses = None
        self._embeddings: Optional[Dict] = None

    # subclasses set self.walks in __init__ (mirroring the reference's
    # eager walk generation) or lazily before train().

    def _fit_skipgram(
        self,
        embed_size=128,
        window_size=5,
        workers=None,  # accepted for reference API parity; unused
        iter=5,
        negative=5,
        alpha=0.025,
        min_alpha=1e-4,
        block_walks=None,  # None -> SkipGramConfig default
        k_shared=64,
        neg_share_walks=8,
        sample=1e-3,  # frequent-node subsampling threshold (gensim's
        # Word2Vec default, which the reference never overrides); 0 off
        mesh=None,  # jax.sharding.Mesh -> train over the mesh;
        # defaults to the mesh given at model construction (which also
        # shards the WALK phase), so Model(G, mesh=m).train() is
        # sharded end to end
        parallel_mode="rowshard",  # 'rowshard' | 'dp' (parallel/trainer)
        hs=0,  # 1 -> hierarchical softmax (the reference's
        # Word2Vec(hs=1) objective for DeepWalk/Struc2Vec; SGNS is the
        # default performance path per SURVEY.md §9)
        trainer="block",  # 'block' (sampled walk-block SGNS, the
        # scale path) | 'dense' (closed-form expected-SGNS
        # factorization, train/dense.py — small graphs only, trains
        # reference-scale corpora in ~0.2 s at equal-or-better F1)
        checkpoint_dir=None,  # Orbax checkpoint/resume (SURVEY.md §6)
        checkpoint_every=0,
        metrics=None,  # utils.metrics.MetricsLogger
        **kwargs,
    ):
        del workers
        if mesh is None:
            mesh = getattr(self, "mesh", None)
        # forward kwargs that name SkipGramConfig fields (update_cap,
        # chunk_steps, dp_sync_every, matmul_bf16, ...); anything else
        # is accepted-and-ignored for gensim-kwarg API parity (the
        # reference forwards **kwargs to Word2Vec). Keys that are ALSO
        # explicit parameters of this method (seed/window/epochs arrive
        # via self.seed/window_size/iter) deliberately override the
        # explicit value — a gensim-parity call like
        # train(window_size=5, seed=42) must not raise, and the caller's
        # explicit kwarg is the stronger signal.
        import dataclasses

        cfg_fields = {f.name for f in dataclasses.fields(SkipGramConfig)}
        cfg_extra = {k: v for k, v in kwargs.items() if k in cfg_fields}
        if trainer == "dense":
            if hs:
                raise ValueError("trainer='dense' trains the SGNS "
                                 "objective; use hs=0")
            if mesh is not None or checkpoint_dir or metrics:
                raise ValueError(
                    "trainer='dense' is the single-card small-graph "
                    "path and does not support mesh=, checkpoint_dir= "
                    "or metrics= (a silent downgrade would be worse "
                    "than an error; use the walk-block trainer for "
                    "those)"
                )
            from graphembedding.train.dense import DenseSGNSTrainer

            dtr = DenseSGNSTrainer(
                embed_size=embed_size,
                window=kwargs.get("window", window_size),
                negative=negative,
                seed=kwargs.get("seed", self.seed),
                **{k: kwargs[k] for k in ("steps", "lr", "max_nodes")
                   if k in kwargs},
            )
            self.w_in, self.w_out, self.losses = dtr.fit(
                self.walks, self.graph.num_nodes,
                jax.random.PRNGKey(kwargs.get("seed", self.seed) + 1),
            )
            self._embeddings = None
            return self
        if trainer != "block":
            raise ValueError(f"unknown trainer {trainer!r}")
        fit_kw = dict(checkpoint_dir=checkpoint_dir,
                      checkpoint_every=checkpoint_every,
                      metrics=metrics)
        if hs:
            from graphembedding.train.hsoftmax import HSTrainer

            trainer = HSTrainer(
                embed_size=embed_size,
                window=kwargs.get("window", window_size),
                epochs=kwargs.get("epochs", iter),
                alpha=alpha, min_alpha=min_alpha, sample=sample,
                seed=kwargs.get("seed", self.seed), mesh=mesh,
            )
            self.w_in, self.w_out, self.losses = trainer.fit(
                self.walks, self.graph.num_nodes,
                jax.random.PRNGKey(kwargs.get("seed", self.seed) + 1),
                **fit_kw,
            )
            self._embeddings = None
            return self
        cfg_kw = dict(
            embed_size=embed_size,
            window=window_size,
            negative=negative,
            epochs=iter,
            k_shared=k_shared,
            neg_share_walks=neg_share_walks,
            alpha=alpha,
            min_alpha=min_alpha,
            sample=sample,
            seed=self.seed,
        )
        if block_walks is not None:
            cfg_kw["block_walks"] = block_walks
        cfg_kw.update(cfg_extra)  # explicit caller kwargs win (see above)
        cfg = SkipGramConfig(**cfg_kw)
        if mesh is not None:
            from graphembedding.parallel.trainer import (
                DistributedSkipGramTrainer,
            )

            trainer = DistributedSkipGramTrainer(
                mesh, cfg, mode=parallel_mode
            )
        else:
            trainer = SkipGramTrainer(cfg)
        key = jax.random.PRNGKey(cfg.seed + 1)
        self.w_in, self.w_out, self.losses = trainer.fit(
            self.walks, self.graph.num_nodes, key, **fit_kw
        )
        self._embeddings = None
        return self

    def get_embeddings(self) -> Dict:
        """{node_name: np.ndarray[embed_size]} — reference return type."""
        if self._embeddings is None:
            if self.w_in is None:
                raise RuntimeError("call train() before get_embeddings()")
            table = np.asarray(self.w_in)
            vocab = self.graph.vocab
            self._embeddings = {
                vocab.idx2node[i]: table[i]
                for i in range(self.graph.num_nodes)
            }
        return self._embeddings

    @property
    def embedding_table(self):
        """Raw device table [V, D] (index order = vocab order)."""
        return self.w_in
