"""Smoke run of the main path on the GPU, in one process.

    python chip_smoke.py          # one card: phases 1-5
    python chip_smoke.py --four   # four cards: the mesh paths only

One card, in order (any failure ends the run with a traceback and a
nonzero exit; no phase is skipped):

1. device    — JAX's devices are GPUs; the card's name and power limit
               (nvidia-smi) are printed.
2. deepwalk  — DeepWalk(wiki, walk_length=10, num_walks=80)
               .train(window_size=5, iter=3), get_embeddings(),
               Classifier.split_train_evaluate; gated on micro-F1.
               Wall time is split into compile (cold minus warm run)
               and warm train.
3. sgns      — the trainer's SGNS block gradients at its real shapes
               (D=128, PL=120, K=64, neg_share_packs=4, one 4032-walk
               block) against the float64 numpy reference, at the
               trainer's precision and at HIGHEST.
4. families  — Node2Vec (exact and rejection walks), LINE (second
               order), SDNE (dense full batch and train_sparse) on wiki
               and Struc2Vec on the synthetic flight graph, each through
               its model API, with a finite-loss check and a micro-F1
               gate no lower than the family's CPU gate in
               tests/test_models.py.
5. million   — the sparse-cap fused-table SGNS chunk at V = 1M (a 1 GB
               [V, 2D] table) with the trainer's shipped block policy.

With --four, only the paths that exist across cards, on a flat (4, 1)
data mesh whose shards are checked to sit on four distinct cards:
rowshard fetch_rows/push_grads exactness, DeepWalk-wiki with
mesh=make_mesh() against the one-card run from the same seed, and
sharded SDNE against one card.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}},
printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# micro-F1 gates on the wiki graph (flight graph for Struc2Vec). Each is
# at or above the family's CPU gate in tests/test_models.py; DeepWalk's
# is the expectation recorded for this graph in the verify notes.
GATES = {
    "deepwalk": 0.93,
    "node2vec": 0.90,
    "node2vec_rejection": 0.90,
    "line": 0.65,
    "sdne": 0.60,
    "sdne_sparse": 0.60,
    "struc2vec": 0.70,
}
# SGNS block gradients vs the float64 reference: max |got - ref| over
# max |ref|, per output. The trainer's DEFAULT precision runs float32
# products in TF32 on the H100 (operands rounded to 10 mantissa bits,
# unit roundoff 2^-11 ~ 4.9e-4); sums of ~120 signed products cancel,
# so the bound is ~20 units. HIGHEST keeps float32 operands (unit
# roundoff 6e-8).
SGNS_TOL = {"trainer": 1e-2, "highest": 1e-5}
# --four: |micro-F1(mesh) - micro-F1(one card)| for DeepWalk-wiki from
# the same seed. The mesh run draws its walks with the distributed
# walker's own random stream, so the two corpora differ; seed-to-seed
# spread of this score on wiki is under 0.01.
MESH_F1_TOL = 0.03
# --four: sharded SDNE vs one card (tests/test_parallel.py): per-epoch
# losses to rtol 2e-3, per-node cosine of the embeddings above 0.99.
SDNE_LOSS_RTOL = 2e-3
SDNE_MIN_COS = 0.99


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def require_gpu(count: int) -> dict:
    """Exit nonzero unless JAX sees at least `count` GPUs; returns the
    device as JAX reports it."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        print(f"chip_smoke needs {count} GPU(s); JAX found {devs}",
              file=sys.stderr)
        raise SystemExit(2)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _log(phase: str, **kw) -> None:
    print(f"[{phase}] " + "  ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def _micro_f1(ds, emb) -> float:
    from graphembedding.eval.classify import Classifier

    return Classifier(emb).split_train_evaluate(ds.X, ds.Y, 0.8)["micro"]


def _check_gate(name: str, f1: float, gate: float) -> None:
    if not f1 >= gate:
        raise AssertionError(f"{name}: micro-F1 {f1:.4f} < gate {gate}")


def _check_finite(name: str, losses) -> None:
    losses = np.asarray(losses)
    if losses.size == 0 or not np.isfinite(losses).all():
        raise AssertionError(f"{name}: non-finite or empty losses")


def phase_deepwalk(ds, walk_length=10, num_walks=80, iters=3,
                   gate=GATES["deepwalk"], mesh=None, seed=0, **train_kw):
    """DeepWalk through the model API, cold run then warm run (seed+1).

    Returns the cold run's micro-F1. Both runs must pass the gate."""
    import jax

    from graphembedding.models import DeepWalk

    times, f1s = [], []
    for s in (seed, seed + 1):
        t0 = time.perf_counter()
        m = DeepWalk(ds.graph, walk_length=walk_length,
                     num_walks=num_walks, seed=s, mesh=mesh)
        m.train(window_size=5, iter=iters, **train_kw)
        emb = m.get_embeddings()
        jax.block_until_ready(m.losses)
        times.append(time.perf_counter() - t0)
        _check_finite("deepwalk", m.losses)
        f1s.append(_micro_f1(ds, emb))
        _check_gate("deepwalk", f1s[-1], gate)
    _log("deepwalk", nodes=ds.graph.num_nodes, mesh=mesh is not None,
         micro_f1=f"{f1s[0]:.4f}/{f1s[1]:.4f}",
         cold_s=f"{times[0]:.2f}", warm_s=f"{times[1]:.2f}",
         compile_s=f"{max(times[0] - times[1], 0.0):.2f}")
    return f1s[0]


def phase_sgns(G=336, P=12, L=10, D=128, K=64, nsp=4, window=5, seed=0):
    """SGNS block gradients on the device vs the float64 reference.

    Inputs follow the trainer: G packing groups of P walks of length L
    (PL = P*L positions), the packed window mask with a per-center
    shrunken window, K shared negatives per `nsp` groups."""
    import jax
    import jax.numpy as jnp

    from graphembedding.parity.reference import sgns_block_grads
    from graphembedding.train.skipgram import (
        MATMUL_PRECISION,
        sgns_block_grads_xla,
    )

    rng = np.random.default_rng(seed)
    PL, G2 = P * L, G // nsp
    i, j = np.meshgrid(np.arange(PL), np.arange(PL), indexing="ij")
    dm = np.abs(j % L - i % L)
    eff = window - rng.integers(0, window, (G, PL))
    mask = ((i // L == j // L) & (dm >= 1))[None] & (dm[None]
                                                     <= eff[:, :, None])
    mask = mask.astype(np.float32)
    yin = (rng.standard_normal((G, PL, D)) * 0.3).astype(np.float32)
    yout = (rng.standard_normal((G, PL, D)) * 0.3).astype(np.float32)
    vn = (rng.standard_normal((G2, K, D)) * 0.3).astype(np.float32)
    neg_ok = (rng.random((G2, nsp * PL, K)) < 0.98).astype(np.float32)
    neg_w = 5.0 / K
    want = sgns_block_grads(yin, yout, vn, mask, neg_ok, neg_w)
    args = [jnp.asarray(a) for a in (yin, yout, vn, mask, neg_ok)]
    for label, prec in (("trainer", MATMUL_PRECISION),
                        ("highest", jax.lax.Precision.HIGHEST)):
        fn = jax.jit(lambda *a, p=prec: sgns_block_grads_xla(
            *a, neg_w, precision=p))
        got = [np.asarray(x) for x in fn(*args)]
        errs = {}
        for name, g, w in zip(("d_yin", "d_yout", "d_vn"), got, want):
            errs[name] = float(np.abs(g - w).max() / np.abs(w).max())
        errs["loss"] = float(abs(got[3].sum() - want[3].sum())
                             / abs(want[3].sum()))
        _log("sgns", precision=f"{label}({prec})",
             shapes=f"G={G},PL={PL},D={D},K={K},r={nsp}",
             tol=SGNS_TOL[label],
             **{k: f"{v:.2e}" for k, v in errs.items()})
        bad = {k: v for k, v in errs.items() if not v <= SGNS_TOL[label]}
        if bad:
            raise AssertionError(f"sgns {label}: {bad} > "
                                 f"{SGNS_TOL[label]}")


def phase_families(ds, flight, walk_length=10, num_walks=80, iters=3,
                   line_epochs=50, sdne_epochs=40, sdne_hidden=(256, 128),
                   s2v_num_walks=80, temp_dir=None, gates=GATES):
    """Node2Vec, LINE, SDNE and Struc2Vec through their model APIs."""
    import tempfile

    import jax

    from graphembedding import native
    from graphembedding.models import LINE, SDNE, Node2Vec, Struc2Vec

    def timed(name, build, data=ds):
        t0 = time.perf_counter()
        m = build()
        emb = m.get_embeddings()
        jax.block_until_ready(m.losses)
        dt = time.perf_counter() - t0
        _check_finite(name, m.losses)
        f1 = _micro_f1(data, emb)
        _log(name, nodes=data.graph.num_nodes, micro_f1=f"{f1:.4f}",
             gate=gates[name], seconds=f"{dt:.2f}")
        _check_gate(name, f1, gates[name])

    def node2vec(rejection):
        def build():
            m = Node2Vec(ds.graph, walk_length=walk_length,
                         num_walks=num_walks, p=0.25, q=4,
                         use_rejection_sampling=rejection)
            m.train(window_size=5, iter=iters)
            return m
        return build

    def line():
        m = LINE(ds.graph, embedding_size=128, order="second")
        m.train(batch_size=1024, epochs=line_epochs)
        return m

    def sdne(sparse):
        def build():
            m = SDNE(ds.graph, hidden_size=list(sdne_hidden))
            if sparse:
                m.train_sparse(epochs=sdne_epochs)
            else:
                m.train(batch_size=3000, epochs=sdne_epochs)
            return m
        return build

    def struc2vec():
        if not native.available():
            raise AssertionError("struc2vec: the C++ helpers did not "
                                 "build; the numpy fallback would run")
        with tempfile.TemporaryDirectory(dir=temp_dir) as td:
            m = Struc2Vec(flight.graph, walk_length=walk_length,
                          num_walks=s2v_num_walks, temp_path=td)
            m.train(window_size=5, iter=iters)
        return m

    timed("node2vec", node2vec(False))
    timed("node2vec_rejection", node2vec(True))
    timed("line", line)
    timed("sdne", sdne(False))
    timed("sdne_sparse", sdne(True))
    timed("struc2vec", struc2vec, flight)


def phase_million(V=1_000_000, n_rep=2):
    """Sparse-cap fused-table chunk at V nodes: finite losses, a finite
    table that moved, and its steady-state pairs/s."""
    from benchmarks.million import sparse_cap_chunks

    t0 = time.perf_counter()
    pairs_per_s, losses, w_cat = sparse_cap_chunks(V, n_rep=n_rep)
    _check_finite("million", losses)
    D = w_cat.shape[1] // 2
    out_abs = float(np.abs(np.asarray(w_cat[:, D:])).max())
    if not (np.isfinite(out_abs) and out_abs > 0):
        raise AssertionError(f"million: output table max {out_abs}")
    _log("million", nodes=V, table_gb=f"{w_cat.nbytes / 2**30:.2f}",
         pairs_per_s=f"{pairs_per_s:.0f}",
         loss_first=f"{losses[0].mean():.4f}",
         loss_last=f"{losses[-1].mean():.4f}",
         seconds=f"{time.perf_counter() - t0:.2f}")


def four_mesh(devices):
    """A flat (n, 1) data mesh over `devices`, checked to hold n
    distinct devices."""
    from graphembedding.parallel.mesh import make_mesh

    mesh = make_mesh((len(devices), 1), devices=devices)
    ids = {d.id for d in mesh.devices.flat}
    if len(ids) != len(devices):
        raise AssertionError(f"mesh devices not distinct: {mesh.devices}")
    return mesh


def phase_rowshard(mesh, rows_per_device=1024, C=257, T=8192, seed=0):
    """fetch_rows returns each requested row exactly; push_grads
    accumulates value x multiplicity at the owner (exact in f32: every
    value is an integer below 2^24)."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from graphembedding.parallel.rowshard import fetch_rows, push_grads

    n = mesh.shape["data"]
    V = n * rows_per_device
    w_np = (np.arange(V * C) % 4093).astype(np.float32).reshape(V, C)
    rng = np.random.default_rng(seed)
    ids_np = rng.integers(0, V, (n, T)).astype(np.int32)
    w = jax.device_put(w_np, NamedSharding(mesh, P("data")))
    ids = jax.device_put(ids_np, NamedSharding(mesh, P("data")))
    shard_devs = {s.device.id for s in w.addressable_shards}
    if len(shard_devs) != n:
        raise AssertionError(f"table shards on {shard_devs}, not {n} "
                             "distinct devices")

    def body(w_local, ids_local):
        lo = jax.lax.axis_index("data") * (V // n)
        rows = fetch_rows(w_local, ids_local[0], lo, "data")
        buf = push_grads(w_local, ids_local[0], rows, lo, "data")
        return rows[None], buf

    fn = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False,
    ))
    rows, buf = fn(w, ids)
    out_devs = {s.device.id for s in buf.addressable_shards}
    rows = np.asarray(rows).reshape(n, T, C)
    for d in range(n):
        np.testing.assert_array_equal(rows[d], w_np[ids_np[d]])
    expect = np.zeros((V, C), np.float32)
    for d in range(n):
        np.add.at(expect, ids_np[d], w_np[ids_np[d]])
    np.testing.assert_array_equal(np.asarray(buf), expect)
    _log("rowshard", devices=sorted(shard_devs), out_devices=sorted(
        out_devs), V=V, C=C, ids_per_device=T, exact=True)


def phase_deepwalk_mesh(ds, mesh, single_f1=None, tol=MESH_F1_TOL,
                        **kw):
    """DeepWalk with mesh= against the one-card run from the same seed."""
    import jax

    if single_f1 is None:
        with jax.default_device(mesh.devices.flat[0]):
            single_f1 = phase_deepwalk(ds, **kw)
    mesh_f1 = phase_deepwalk(ds, mesh=mesh, **kw)
    _log("deepwalk_mesh", one_card=f"{single_f1:.4f}",
         mesh=f"{mesh_f1:.4f}", tol=tol)
    if not abs(mesh_f1 - single_f1) <= tol:
        raise AssertionError(f"deepwalk mesh F1 {mesh_f1:.4f} vs one "
                             f"card {single_f1:.4f} > {tol}")


def phase_sdne_mesh(ds, mesh, hidden=(256, 128), epochs=8):
    """Row-sharded full-batch SDNE reproduces the one-card run."""
    import jax

    from graphembedding.models import SDNE

    kw = dict(hidden_size=list(hidden), seed=0)
    with jax.default_device(mesh.devices.flat[0]):
        m1 = SDNE(ds.graph, **kw)
        m1.train(batch_size=ds.graph.num_nodes + 1, epochs=epochs)
        l1 = np.asarray(m1.losses)
        e1 = np.asarray(m1.embedding_table)
    m2 = SDNE(ds.graph, **kw)
    m2.train(batch_size=ds.graph.num_nodes + 1, epochs=epochs, mesh=mesh)
    l2 = np.asarray(m2.losses)
    e2 = np.asarray(m2.embedding_table)
    rel = float(np.max(np.abs(l1 - l2) / np.abs(l1)))
    cos = (e1 * e2).sum(-1) / np.maximum(
        np.linalg.norm(e1, axis=-1) * np.linalg.norm(e2, axis=-1), 1e-9)
    _log("sdne_mesh", nodes=ds.graph.num_nodes, loss_rel_max=f"{rel:.2e}",
         rtol=SDNE_LOSS_RTOL, min_cos=f"{cos.min():.6f}",
         cos_gate=SDNE_MIN_COS)
    np.testing.assert_allclose(l2, l1, rtol=SDNE_LOSS_RTOL)
    if not cos.min() > SDNE_MIN_COS:
        raise AssertionError(f"sdne mesh: min cosine {cos.min()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh checks")
    args = ap.parse_args(argv)
    count = 4 if args.four else 1
    device = require_gpu(count)
    print(card_line(), flush=True)
    _log("device", **device)

    import jax

    from graphembedding.data import load_dataset

    wiki = load_dataset("wiki")
    if args.four:
        mesh = four_mesh(jax.devices()[:4])
        phase_rowshard(mesh)
        phase_deepwalk_mesh(wiki, mesh)
        phase_sdne_mesh(wiki, mesh)
    else:
        from graphembedding.data.datasets import synthetic_flight

        phase_deepwalk(wiki)
        phase_sgns()
        phase_families(wiki, synthetic_flight())
        phase_million()
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
