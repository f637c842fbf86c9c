"""DeepWalk on Wiki — reference `examples/deepwalk_wiki.py [U]` parity.

Canonical hyperparameters (SURVEY.md §3.1 row 12):
DeepWalk(walk_length=10, num_walks=80), train(window_size=5, iter=3).
"""

from common import mesh_from_args, run

from graphembedding.models import DeepWalk


def build_and_train(ds, args):
    model = DeepWalk(ds.graph, walk_length=10, num_walks=80,
                     seed=args.seed)
    model.train(embed_size=args.embed_size, window_size=5, iter=3,
                mesh=mesh_from_args(args),
                trainer=getattr(args, "trainer", "block"))
    return model


if __name__ == "__main__":
    run("DeepWalk", "wiki", build_and_train)
