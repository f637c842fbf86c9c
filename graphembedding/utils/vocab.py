"""Node-name <-> integer-index vocabulary.

Node names (strings in the reference's edgelist files) never touch the
device: everything on-device is int32 indices. This module is the only place
that maps back and forth.

Reference parity: `ge/utils.py — preprocess_nxgraph` returns
`(idx2node, node2idx)` with indices assigned in `graph.nodes()` iteration
order; we reproduce that exactly so embeddings dictionaries line up.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Tuple


class Vocab:
    """Bidirectional node<->index mapping with stable insertion order."""

    __slots__ = ("idx2node", "node2idx")

    def __init__(self, nodes: Iterable[Hashable] = ()):  # noqa: D107
        self.idx2node: List[Hashable] = []
        self.node2idx: Dict[Hashable, int] = {}
        for n in nodes:
            self.add(n)

    def add(self, node: Hashable) -> int:
        idx = self.node2idx.get(node)
        if idx is None:
            idx = len(self.idx2node)
            self.node2idx[node] = idx
            self.idx2node.append(node)
        return idx

    def __len__(self) -> int:
        return len(self.idx2node)

    def __contains__(self, node: Hashable) -> bool:
        return node in self.node2idx

    def __getitem__(self, node: Hashable) -> int:
        return self.node2idx[node]

    def names(self, indices: Iterable[int]) -> List[Hashable]:
        return [self.idx2node[i] for i in indices]


class IdentityVocab:
    """Lazy node<->index vocabulary where node i IS index i.

    The default for integer graphs built without names: materializing
    a 10M-entry Python dict + list costs minutes and GBs
    (`Vocab(range(2M))` measured 43 s in this environment) for a
    mapping that is the identity. `idx2node` is a `range` and
    `node2idx` is the vocab itself (it implements the mapping
    protocol), so `vocab.idx2node[i]`, `vocab.node2idx[n]`, `len`,
    `in`, and iteration all behave like the dict-backed `Vocab`;
    lookups validate bounds and accept numpy integer ids.
    """

    __slots__ = ("idx2node",)

    def __init__(self, num_nodes: int):  # noqa: D107
        self.idx2node = range(num_nodes)

    @property
    def node2idx(self) -> "IdentityVocab":
        return self

    def __len__(self) -> int:
        return len(self.idx2node)

    @staticmethod
    def _as_index(node):
        import numpy as _np

        if isinstance(node, bool) or not isinstance(
            node, (int, _np.integer)
        ):
            return None
        return int(node)

    def __contains__(self, node) -> bool:
        i = self._as_index(node)
        return i is not None and 0 <= i < len(self.idx2node)

    def __getitem__(self, node) -> int:
        if node not in self:
            raise KeyError(node)
        return int(node)

    def add(self, node) -> int:
        """Identity vocab is fixed-size: known ids return themselves."""
        if node not in self:
            raise KeyError(
                f"IdentityVocab({len(self.idx2node)}) cannot add {node!r}"
            )
        return int(node)

    def names(self, indices: Iterable[int]) -> List:
        n = len(self.idx2node)
        out = []
        for i in indices:
            if not 0 <= i < n:
                raise IndexError(i)
            out.append(int(i))
        return out


def preprocess_nxgraph(graph) -> Tuple[List, Dict]:
    """Reference-API shim: (idx2node, node2idx) in graph.nodes() order."""
    vocab = Vocab(graph.nodes())
    return vocab.idx2node, vocab.node2idx


# ---------------------------------------------------------------------- #
# reference work-partition helpers (`ge/utils.py — partition_* [U]`).
# They sliced work for joblib processes; here all parallelism is
# device-side, but the helpers are kept for users' migration scripts.
# ---------------------------------------------------------------------- #


def partition_num(num: int, workers: int) -> List[int]:
    if num % workers == 0:
        return [num // workers] * workers
    return [num // workers] * workers + [num % workers]


def partition_dict(vertices: Dict, workers: int):
    batch_size = (len(vertices) - 1) // workers + 1
    part_list, part = [], []
    for v1, nbs in vertices.items():
        part.append((v1, nbs))
        if len(part) == batch_size:
            part_list.append(part)
            part = []
    if part:
        part_list.append(part)
    return part_list


def partition_list(vertices: List, workers: int):
    batch_size = (len(vertices) - 1) // workers + 1
    part_list, part = [], []
    for v1, nbs in enumerate(vertices):
        part.append((v1, nbs))
        if len(part) == batch_size:
            part_list.append(part)
            part = []
    if part:
        part_list.append(part)
    return part_list
