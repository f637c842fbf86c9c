"""`ge.classify` shim -> graphembedding.eval.classify."""

from graphembedding.eval.classify import (  # noqa: F401
    Classifier,
    TopKRanker,
    read_node_label,
)
