"""Struc2Vec on the Brazil flight network — reference
`examples/struc2vec_flight.py [U]` parity.

Canonical hyperparameters: Struc2Vec(10, 80, workers=4, verbose=40),
train default; brazil-airports edgelist, 4 activity-quartile classes.
"""

from common import mesh_from_args, run

from graphembedding.models import Struc2Vec


def build_and_train(ds, args):
    import os

    # dtw_mode: 'fastdtw' (radius-1 — what the reference computes;
    # default) or 'exact' (the O(nm) oracle); env override keeps the
    # reference-parity CLI surface untouched
    model = Struc2Vec(ds.graph, walk_length=10, num_walks=80,
                      workers=4, verbose=40, seed=args.seed,
                      dtw_mode=os.environ.get("GE_DTW_MODE",
                                              "fastdtw"))
    trainer = getattr(args, "trainer", "block")
    # the dense expected-SGNS trainer matches hs=1 quality
    # but trains the SGNS objective — switch hs off when selected
    model.train(embed_size=args.embed_size, window_size=5, iter=5,
                mesh=mesh_from_args(args), trainer=trainer,
                **({"hs": 0} if trainer == "dense" else {}))
    return model


if __name__ == "__main__":
    run("Struc2Vec", "flight-brazil", build_and_train)
