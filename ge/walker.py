"""`ge.walker` shim -> graphembedding.walker."""

from graphembedding.walker import (  # noqa: F401
    BiasedWalker,
    RandomWalker,
)
