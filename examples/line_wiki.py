"""LINE on Wiki — reference `examples/line_wiki.py [U]` parity.

Canonical hyperparameters: LINE(embedding_size=128, order='second'),
train(batch_size=1024, epochs=50).
"""

from common import mesh_from_args, run

from graphembedding.models import LINE


def build_and_train(ds, args):
    model = LINE(ds.graph, embedding_size=args.embed_size,
                 order="second", seed=args.seed)
    # LINE's trainer values are 'sampled' | 'dense' (the CLI's 'block'
    # means the sampled default)
    trainer = getattr(args, "trainer", "block")
    model.train(batch_size=1024, epochs=50,
                mesh=mesh_from_args(args),
                trainer="dense" if trainer == "dense" else "sampled")
    return model


if __name__ == "__main__":
    run("LINE", "wiki", build_and_train)
