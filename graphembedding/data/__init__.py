from graphembedding.data.datasets import (
    Dataset,
    load_dataset,
    synthetic_flight,
    synthetic_wiki,
)

__all__ = ["Dataset", "load_dataset", "synthetic_wiki", "synthetic_flight"]
