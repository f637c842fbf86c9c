"""SDNE on Wiki — reference `examples/sdne_wiki.py [U]` parity.

Canonical hyperparameters: SDNE(hidden_size=[256, 128]),
train(batch_size=3000, epochs=40).
"""

from common import mesh_from_args, run

from graphembedding.models import SDNE


def build_and_train(ds, args):
    if getattr(args, "trainer", "block") == "dense":
        raise SystemExit("SDNE has no dense-SGNS mode (autoencoder "
                         "objective); drop --trainer dense")
    model = SDNE(ds.graph, hidden_size=[256, 128], seed=args.seed)
    model.train(batch_size=3000, epochs=40,
                mesh=mesh_from_args(args))
    return model


if __name__ == "__main__":
    run("SDNE", "wiki", build_and_train)
