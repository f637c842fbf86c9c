"""Drop-in import shim for code written against the reference package.

The reference is imported as `from ge import DeepWalk` (its package
root re-exports the model classes — `ge/__init__.py [U]`). This shim
makes that line work VERBATIM against this framework, so a
migrating script needs zero changes; new code should import
`graphembedding` directly. Do not install this package alongside
the original reference in one environment — the module name is shared
by design.
"""

from graphembedding import (  # noqa: F401
    LINE,
    SDNE,
    DeepWalk,
    Node2Vec,
    Struc2Vec,
)

from . import alias, classify, utils, walker  # noqa: F401

__all__ = ["DeepWalk", "Node2Vec", "LINE", "SDNE", "Struc2Vec"]
