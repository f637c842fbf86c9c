"""Reference-API walker classes (`ge/walker.py [U]` surface parity).

The framework's real walk engines are the batched device kernels in
`ops/walk.py`; these wrappers reproduce the reference's `RandomWalker` /
`BiasedWalker` classes for users migrating from it — same constructor
signatures, and `simulate_walks` returns walks as **lists of node-name
lists** (the reference's return type, fed to gensim as "sentences").
"""

from __future__ import annotations

from typing import List

import jax
import numpy as np

from graphembedding.models.base import as_graph
from graphembedding.ops.walk import simulate_walks as _device_walks


def _to_sentences(walks_np: np.ndarray, vocab) -> List[List]:
    out = []
    for row in walks_np:
        out.append([vocab.idx2node[i] for i in row if i >= 0])
    return out


class RandomWalker:
    def __init__(self, G, p=1.0, q=1.0, use_rejection_sampling=0,
                 seed=0):
        self.graph = as_graph(G)
        self.p = p
        self.q = q
        self.use_rejection_sampling = use_rejection_sampling
        self.seed = seed
        self._calls = 0  # advances the default seed call-to-call

    def preprocess_transition_probs(self):
        """Build alias tables (device-resident; O(1)-draw, no O(E·d)
        alias_edges — the exact kernel needs none)."""
        _ = self.graph.alias
        return self

    def simulate_walks(self, num_walks, walk_length, workers=1,
                       verbose=0, seed=None):
        """Generate the walk corpus (reference return type: sentences).

        `seed=None` draws a fresh corpus per call (the reference's
        repeated `simulate_walks` calls differ too — its RNG advances);
        pass `seed=` for a reproducible corpus.
        """
        del workers, verbose
        if seed is None:
            # fold the call counter into the instance key: seed+calls
            # would collide walker(seed=s) call k with walker(seed=s+k)
            # call 0 — "independent" walkers sharing corpus blocks
            key = jax.random.fold_in(
                jax.random.PRNGKey(self.seed), self._calls
            )
            self._calls += 1
        else:
            key = jax.random.PRNGKey(seed)
        kind = "uniform" if (self.p == 1.0 and self.q == 1.0) else \
            "node2vec"
        walks = _device_walks(
            self.graph, num_walks, walk_length,
            key, kind=kind, p=self.p, q=self.q,
            use_rejection_sampling=bool(self.use_rejection_sampling),
        )
        return _to_sentences(np.asarray(walks), self.graph.vocab)


class BiasedWalker:
    """Struc2Vec multilayer walker (reference surface).

    Reference counterpart: `ge/walker.py — BiasedWalker (~L175) [U]`,
    which reads pickled per-layer alias tables from `temp_path`. Here
    the context-graph layers are the stacked-CSR dict built by
    `models.struc2vec.build_layer_csr` (and cached by the `Struc2Vec`
    model as `context_*.pkl` under `temp_path`); `simulate_walks` runs
    the same biased multilayer walk as the reference, but batched on
    device (`models.struc2vec.multilayer_walks`).

    Layers are resolved in order: an explicit `layers=` dict passed to
    the constructor, else the newest `context_*.pkl` cache file in
    `temp_path`.
    """

    def __init__(self, idx2node, temp_path, layers=None, seed=0):
        self.idx2node = idx2node
        self.temp_path = temp_path
        self._layers = layers
        self.seed = seed
        self._calls = 0  # advances the default seed call-to-call

    def _resolve_layers(self):
        if self._layers is not None:
            return self._layers
        import glob
        import os
        import pickle

        cands = sorted(
            glob.glob(os.path.join(self.temp_path, "context_*.pkl")),
            key=os.path.getmtime,
        )
        if not cands:
            raise FileNotFoundError(
                f"no context_*.pkl layer cache under {self.temp_path!r}; "
                "construct Struc2Vec(graph, temp_path=...) first (it "
                "builds and caches the context graph), or pass layers= "
                "(the models.struc2vec.build_layer_csr dict) directly"
            )
        with open(cands[-1], "rb") as f:
            self._layers = pickle.load(f)
        return self._layers

    def simulate_walks(self, num_walks, walk_length, stay_prob=0.3,
                       workers=1, verbose=0, seed=None):
        """Multilayer walk corpus as sentences.

        `seed=None` draws a fresh corpus per call (matching the
        reference, whose RNG advances between calls); pass `seed=` for
        a reproducible corpus.
        """
        del workers, verbose
        import jax.numpy as jnp

        from graphembedding.models.struc2vec import multilayer_walks

        if seed is None:
            # fold_in, not seed+calls (see RandomWalker.simulate_walks)
            key = jax.random.fold_in(
                jax.random.PRNGKey(self.seed), self._calls
            )
            self._calls += 1
        else:
            key = jax.random.PRNGKey(seed)
        layers = {
            k: jnp.asarray(v) for k, v in self._resolve_layers().items()
        }
        V = int(layers["row_ptr"].shape[1]) - 1
        starts = jnp.tile(jnp.arange(V, dtype=jnp.int32), num_walks)
        walks = multilayer_walks(
            layers["row_ptr"],
            layers["col_idx"],
            layers["accept"],
            layers["alias"],
            layers["gamma"],
            starts,
            key,
            jnp.float32(stay_prob),
            length=walk_length,
        )
        idx2node = self.idx2node
        return [
            [idx2node[i] for i in row if i >= 0]
            for row in np.asarray(walks)
        ]
