"""`ge.alias` shim -> graphembedding.ops.alias."""

from graphembedding.ops.alias import (  # noqa: F401
    alias_sample,
    create_alias_table,
)
