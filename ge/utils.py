"""`ge.utils` shim -> graphembedding.utils.vocab."""

from graphembedding.utils.vocab import (  # noqa: F401
    partition_dict,
    partition_list,
    partition_num,
    preprocess_nxgraph,
)
