"""LINE on BlogCatalog — the BASELINE.json LINE config.

The reference ships only Wiki + flight data; BASELINE.json names
BlogCatalog (10,312 nodes / 333,983 edges / 39 labels — the LINE
paper's benchmark) for LINE, so this entry point is new surface area
(SURVEY.md §3.1 "BlogCatalog caveat"). Uses `order='all'` (the LINE
paper's first+second concatenation) by default; pass --order to
override. Falls back to the synthetic BlogCatalog-scale SBM when no
real edgelist is present (the reference mount was empty all round).
"""

from common import make_parser, mesh_from_args, run

from graphembedding.models import LINE


def build_and_train(ds, args):
    model = LINE(ds.graph, embedding_size=args.embed_size,
                 order=args.order, seed=args.seed)
    trainer = getattr(args, "trainer", "block")
    model.train(batch_size=1024, epochs=args.epochs,
                mesh=mesh_from_args(args),
                trainer="dense" if trainer == "dense" else "sampled")
    return model


if __name__ == "__main__":
    extra = make_parser("LINE-BlogCatalog", "blogcatalog")
    extra.add_argument("--order", default="all",
                       choices=["first", "second", "all"])
    extra.add_argument("--epochs", type=int, default=50)
    run("LINE", "blogcatalog", build_and_train, parser=extra)
