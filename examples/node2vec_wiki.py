"""Node2Vec on Wiki — reference `examples/node2vec_wiki.py [U]` parity.

Canonical hyperparameters: Node2Vec(walk_length=10, num_walks=80,
p=0.25, q=4), train(window_size=5, iter=3).
"""

from common import mesh_from_args, run

from graphembedding.models import Node2Vec


def build_and_train(ds, args):
    model = Node2Vec(ds.graph, walk_length=10, num_walks=80, p=0.25,
                     q=4.0, seed=args.seed)
    model.train(embed_size=args.embed_size, window_size=5, iter=3,
                mesh=mesh_from_args(args),
                trainer=getattr(args, "trainer", "block"))
    return model


if __name__ == "__main__":
    run("Node2Vec", "wiki", build_and_train)
