from graphembedding.parallel.mesh import (
    init_distributed,
    make_mesh,
    put_global,
)
from graphembedding.parallel.trainer import DistributedSkipGramTrainer
from graphembedding.parallel.walks import DistributedWalker

__all__ = [
    "make_mesh",
    "init_distributed",
    "put_global",
    "DistributedSkipGramTrainer",
    "DistributedWalker",
]
