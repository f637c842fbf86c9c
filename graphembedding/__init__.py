"""graphembedding — a graph-embedding framework on JAX.

A from-scratch JAX/XLA/Pallas implementation of the classical shallow
graph-embedding family (DeepWalk, Node2Vec, LINE, SDNE, Struc2Vec) behind the
same user-facing API as the reference library (`kangzf/GraphEmbedding`,
see SURVEY.md):

    import networkx as nx
    from graphembedding import DeepWalk

    G = nx.read_edgelist("Wiki_edgelist.txt", create_using=nx.DiGraph(),
                         nodetype=None, data=[("weight", int)])
    model = DeepWalk(G, walk_length=10, num_walks=80)
    model.train(window_size=5, iter=3)
    embeddings = model.get_embeddings()   # {node: np.ndarray[128]}

Internally nothing is shared with the reference's design: the graph lives on
device as a padded CSR, random walks are batched device kernels advancing all
walkers in lockstep, and skip-gram/LINE/SDNE train as jit-compiled XLA (and
Pallas) programs sharded over a `jax.sharding.Mesh`.
"""

from graphembedding.utils.compile_cache import enable_persistent_cache

enable_persistent_cache()

from graphembedding.graph import Graph
from graphembedding.models import LINE, SDNE, DeepWalk, Node2Vec, Struc2Vec
from graphembedding.walker import BiasedWalker, RandomWalker

__version__ = "0.1.0"

__all__ = [
    "Graph",
    "DeepWalk",
    "Node2Vec",
    "LINE",
    "SDNE",
    "Struc2Vec",
    "RandomWalker",
    "BiasedWalker",
    "__version__",
]
