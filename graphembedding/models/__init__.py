from graphembedding.models.deepwalk import DeepWalk
from graphembedding.models.line import LINE
from graphembedding.models.node2vec import Node2Vec
from graphembedding.models.sdne import SDNE
from graphembedding.models.struc2vec import Struc2Vec

__all__ = ["DeepWalk", "Node2Vec", "LINE", "SDNE", "Struc2Vec"]
