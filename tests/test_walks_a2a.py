"""Crossers-only exact-exchange walk engine (VERDICT r3 item 1).

The routing math (`bucket_by_dest` / `place_arrivals`) is pure and
collective-free, so it is unit-tested directly; the engine itself is
validated on the 8-virtual-device CPU mesh against edge validity,
visit distribution vs the plain engine, hub backpressure, and walker
accounting. `jax.lax.ragged_all_to_all` support is probed each run so
its XLA:CPU status is re-verified, not assumed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graphembedding.graph import Graph
from graphembedding.parallel.mesh import make_mesh
from graphembedding.parallel.walks import (
    DistributedWalker,
    bucket_by_dest,
    place_arrivals,
)


def ring_graph(n=32):
    src = np.arange(n)
    dst = (src + 1) % n
    return Graph(src, dst, directed=False)


def zipf_hub_graph(V=64, seed=0):
    rng = np.random.default_rng(seed)
    edges = {(i, (i + 1) % V) for i in range(V)}
    for hub, fan in enumerate([V // 2, V // 4, V // 8, V // 16]):
        for t in rng.choice(V, fan, replace=False):
            t = int(t)
            if t != hub:
                edges.add((min(hub, t), max(hub, t)))
    src, dst = map(np.asarray, zip(*sorted(edges)))
    return Graph(src, dst, directed=False)


# --------------------------------------------------------------------------- #
# pure routing math
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("method", ["cumsum", "sort"])
def test_bucket_by_dest_groups_and_pads(method):
    vp, n, bcap = 10, 4, 3
    # crossers to shards 2, 0, 2, 3; one dead slot; one non-crosser
    v = jnp.asarray([25, 5, 29, 31, -1, -1], jnp.int32)
    w = jnp.asarray([7, 8, 9, 10, -1, 11], jnp.int32)
    t = jnp.asarray([3, 4, 5, 6, 0, 2], jnp.int32)
    sbuf, sent = bucket_by_dest(v, w, t, vp, n, bcap, method=method)
    sbuf = np.asarray(sbuf).reshape(n, bcap, 3)
    assert np.asarray(sent).tolist() == [
        True, True, True, True, False, False
    ]
    # bucket 0: walker 8; bucket 2: walkers 7 and 9 (stable order);
    # bucket 3: walker 10; bucket 1 empty
    assert sbuf[0, 0].tolist() == [5, 8, 4]
    assert sbuf[0, 1].tolist() == [-1, -1, -1]
    assert {tuple(r) for r in sbuf[2, :2]} == {(25, 7, 3), (29, 9, 5)}
    assert sbuf[3, 0].tolist() == [31, 10, 6]
    assert (sbuf[1] == -1).all()


@pytest.mark.parametrize("method", ["cumsum", "sort"])
def test_bucket_by_dest_backpressure_beyond_bcap(method):
    vp, n, bcap = 10, 2, 2
    # four crossers all destined to shard 1: only bcap=2 may go
    v = jnp.asarray([15, 16, 17, 18], jnp.int32)
    w = jnp.asarray([0, 1, 2, 3], jnp.int32)
    t = jnp.asarray([1, 1, 1, 1], jnp.int32)
    sbuf, sent = bucket_by_dest(v, w, t, vp, n, bcap, method=method)
    assert int(np.asarray(sent).sum()) == 2  # two held, zero dropped
    sbuf = np.asarray(sbuf).reshape(n, bcap, 3)
    assert (sbuf[1, :, 1] >= 0).all()
    assert (sbuf[0] == -1).all()


@pytest.mark.parametrize("method", ["cumsum", "sort"])
def test_bucket_by_dest_send_cap_backpressure(method):
    vp, n, bcap = 10, 4, 8
    # six crossers, send_cap=3: only the first three (in index order
    # for cumsum; any three for sort) get slots, rest held
    v = jnp.asarray([15, 25, 35, 15, 25, 35], jnp.int32)
    w = jnp.arange(6, dtype=jnp.int32)
    t = jnp.ones((6,), jnp.int32)
    sbuf, sent = bucket_by_dest(v, w, t, vp, n, bcap, send_cap=3,
                                method=method)
    assert int(np.asarray(sent).sum()) == 3
    sbuf = np.asarray(sbuf).reshape(n, bcap, 3)
    assert int((sbuf[:, :, 1] >= 0).sum()) == 3


def test_bucket_by_dest_methods_agree():
    # both implementations produce the same buckets on random state
    rng = np.random.default_rng(0)
    cap, vp, n, bcap = 64, 5, 8, 4
    v = rng.integers(-1, vp * n, cap).astype(np.int32)
    w = rng.integers(-1, 100, cap).astype(np.int32)
    t = rng.integers(0, 10, cap).astype(np.int32)
    ref, sent_ref = bucket_by_dest(
        jnp.asarray(v), jnp.asarray(w), jnp.asarray(t), vp, n, bcap,
        method="cumsum",
    )
    got, sent_got = bucket_by_dest(
        jnp.asarray(v), jnp.asarray(w), jnp.asarray(t), vp, n, bcap,
        method="sort",
    )
    # bucket CONTENTS agree as sets per destination (order within a
    # bucket is an implementation detail)
    ref = np.asarray(ref).reshape(n, bcap, 3)
    got = np.asarray(got).reshape(n, bcap, 3)
    for d in range(n):
        assert ({tuple(r) for r in ref[d]} == {tuple(r) for r in got[d]})
    np.testing.assert_array_equal(
        np.asarray(sent_ref), np.asarray(sent_got)
    )


def test_place_arrivals_fills_free_slots_and_records():
    length = 8
    cap = 4
    cur = jnp.asarray([5, -1, 7, -1], jnp.int32)
    wid = jnp.asarray([0, -1, 1, -1], jnp.int32)
    t = jnp.asarray([3, length, 2, length], jnp.int32)
    pend = jnp.full((cap,), -1, jnp.int32)
    out = jnp.zeros((4, length), jnp.int32)
    arrivals = jnp.asarray(
        [[12, 2, 4], [-1, -1, -1], [13, 3, 7]], jnp.int32
    )
    cur2, wid2, t2, pend2, out2, ov = place_arrivals(
        cur, wid, t, pend, out, arrivals, length
    )
    assert int(ov) == 0
    cur2, wid2, t2 = map(np.asarray, (cur2, wid2, t2))
    # walker 2 landed in a free slot at vertex 12, t advanced to 5
    i2 = int(np.where(wid2 == 2)[0][0])
    assert cur2[i2] == 12 and t2[i2] == 5
    # walker 3 crossed at its LAST hop (t=7=length-1): recorded, then
    # finished — must not stay alive
    assert 3 not in wid2.tolist()
    out2 = np.asarray(out2)
    assert out2[2, 4] == 13  # vertex+1 encoding
    assert out2[3, 7] == 14


def test_place_arrivals_receiver_capacity_overflow():
    length = 8
    cur = jnp.asarray([5, 6], jnp.int32)   # no free slots
    wid = jnp.asarray([0, 1], jnp.int32)
    t = jnp.asarray([3, 3], jnp.int32)
    pend = jnp.full((2,), -1, jnp.int32)
    out = jnp.zeros((4, length), jnp.int32)
    arrivals = jnp.asarray([[12, 2, 4]], jnp.int32)
    *_, ov = place_arrivals(cur, wid, t, pend, out, arrivals, length)
    assert int(ov) == 1  # counted, resident walkers untouched


# --------------------------------------------------------------------------- #
# engine on the CPU mesh
# --------------------------------------------------------------------------- #


def test_a2a_engine_correctness():
    """Every recorded hop is a real edge, contiguous tokens, zero
    drops on a well-provisioned run, and full walker accounting."""
    from graphembedding.data.datasets import synthetic_wiki

    ds = synthetic_wiki(num_nodes=200, num_classes=4, avg_degree=6,
                        seed=3)
    g = ds.graph
    mesh = make_mesh((len(jax.devices()), 1))
    w = DistributedWalker(g, mesh, 12, kind="uniform", num_walks=20,
                          exchange="a2a")
    walks, ov = w.run(jax.random.PRNGKey(0))
    assert ov == 0
    assert walks.shape[0] == 20 * g.num_nodes
    assert w.last_rounds is not None and w.last_rounds >= 11
    nbrs = {v: set(g.neighbors(v).tolist()) for v in range(g.num_nodes)}
    for row in walks:
        toks = row[row >= 0]
        assert (row[: len(toks)] >= 0).all()  # contiguous prefix
        for a, b in zip(toks[:-1], toks[1:]):
            assert b in nbrs[int(a)]
    # truncation happens ONLY at dead ends (the graph is directed and
    # has zero-out-degree nodes): a shorter-than-length walk must end
    # on a vertex with no outgoing edge
    deg = np.asarray(g.degree)
    lens = (walks >= 0).sum(1)
    for row, ln in zip(walks[lens < 12], lens[lens < 12]):
        assert deg[row[ln - 1]] == 0
    # start coverage: every node starts num_walks walks
    counts = np.bincount(walks[:, 0], minlength=g.num_nodes)
    assert (counts == 20).all()


def test_a2a_engine_distribution_matches_plain():
    from graphembedding.data.datasets import synthetic_wiki

    ds = synthetic_wiki(num_nodes=200, num_classes=4, avg_degree=6,
                        seed=3)
    g = ds.graph
    mesh = make_mesh((len(jax.devices()), 1))
    wa = DistributedWalker(g, mesh, 12, kind="uniform", num_walks=40,
                           exchange="a2a")
    wp = DistributedWalker(g, mesh, 12, kind="uniform", num_walks=40)
    aw, _ = wa.run(jax.random.PRNGKey(1))
    pw, _ = wp.run(jax.random.PRNGKey(2))
    fa = np.bincount(aw[aw >= 0].ravel(), minlength=g.num_nodes)
    fp = np.bincount(pw[pw >= 0].ravel(), minlength=g.num_nodes)
    l1 = np.abs(fa / fa.sum() - fp / fp.sum()).sum()
    assert l1 < 0.08, l1


def test_a2a_engine_ring_uniformity():
    # star graph from the plain-engine test: hub fan-out is uniform
    k = 9
    src = np.zeros(k, dtype=int)
    dst = np.arange(1, k + 1)
    g = Graph(src, dst, directed=False)
    mesh = make_mesh((len(jax.devices()), 1))
    w = DistributedWalker(g, mesh, 2, kind="uniform", num_walks=400,
                          exchange="a2a", slack=16)
    walks, ov = w.run(jax.random.PRNGKey(1))
    hub_rows = walks[walks[:, 0] == 0]
    freq = np.bincount(hub_rows[:, 1], minlength=k + 1)[1:]
    freq = freq / freq.sum()
    np.testing.assert_allclose(freq, 1 / k, atol=0.05)


def test_a2a_engine_zipf_hub_backpressure():
    """Hub graph with a TINY bucket cap: per-pair buckets overflow
    constantly, so completion proves backpressure retries instead of
    dropping. Receiver capacity (slack=8) stays sufficient → ov=0."""
    g = zipf_hub_graph()
    mesh = make_mesh((len(jax.devices()), 1))
    w = DistributedWalker(g, mesh, 10, kind="uniform", num_walks=30,
                          exchange="a2a", slack=8, bucket_cap=2)
    walks, ov = w.run(jax.random.PRNGKey(4))
    assert ov == 0
    assert walks.shape[0] == 30 * g.num_nodes
    # tiny buckets => many retry rounds, still terminates
    assert w.last_rounds > 9


def test_a2a_engine_hop_batching():
    g = ring_graph(64)
    mesh = make_mesh((len(jax.devices()), 1))
    w = DistributedWalker(g, mesh, 12, kind="uniform", num_walks=8,
                          exchange="a2a", hop_batch=4)
    walks, ov = w.run(jax.random.PRNGKey(5))
    assert ov == 0
    nbrs = {v: {(v + 1) % 64, (v - 1) % 64} for v in range(64)}
    for row in walks[:64]:
        for a, b in zip(row[:-1], row[1:]):
            if a >= 0 and b >= 0:
                assert b in nbrs[int(a)]


def test_ragged_all_to_all_backend_probe():
    """Re-verify (not assume) ragged_all_to_all's backend status: on
    XLA:CPU it is expected UNIMPLEMENTED — if this ever starts
    passing, the dense-bucketed exchange should grow a ragged path
    (parallel/walks.py docstring commitment)."""
    n = len(jax.devices())
    if n < 2:
        pytest.skip("needs >= 2 devices")
    mesh = make_mesh((n, 1))
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    def body(x):
        sizes = jnp.ones((n,), jnp.int32)
        offs = jnp.arange(n, dtype=jnp.int32)
        out = jnp.zeros((n, 1), x.dtype)
        return jax.lax.ragged_all_to_all(
            x, out, offs, sizes, offs, sizes, axis_name="data"
        )

    fn = jax.jit(shard_map(
        lambda x: body(x[0]),
        mesh=mesh, in_specs=(P("data"),), out_specs=P("data"),
        check_vma=False,
    ))
    x = jnp.arange(n * n, dtype=jnp.float32).reshape(n * n, 1)
    try:
        np.asarray(fn(x))
        supported = True
    except Exception:
        supported = False
    if jax.devices()[0].platform == "cpu":
        assert not supported, (
            "ragged_all_to_all now works on XLA:CPU — wire the ragged "
            "path in distributed_uniform_walks_a2a"
        )


def test_deepwalk_model_a2a_exchange():
    """Model-level reach: DeepWalk(G, mesh=..., walk_exchange='a2a')
    runs the exact-exchange engine end to end."""
    from graphembedding.data.datasets import synthetic_wiki
    from graphembedding.models import DeepWalk

    ds = synthetic_wiki(num_nodes=120, num_classes=4, avg_degree=6,
                        seed=2)
    mesh = make_mesh((len(jax.devices()), 1))
    m = DeepWalk(ds.graph, walk_length=6, num_walks=4, mesh=mesh,
                 walk_exchange="a2a")
    assert m.walk_overflow == 0
    assert m.walks.shape[1] == 6
    m.train(embed_size=8, window_size=2, iter=1)
    assert m.embedding_table.shape == (120, 8)


def test_a2a_weighted_distribution():
    """Weighted first-order hops through the exact exchange: empirical
    next-hop distribution matches the edge weights (star graph)."""
    k = 6
    src = np.zeros(k, dtype=int)
    dst = np.arange(1, k + 1)
    w = np.arange(1, k + 1, dtype=np.float64)  # weight ∝ leaf id
    g = Graph(src, dst, w, directed=False)
    mesh = make_mesh((len(jax.devices()), 1))
    wk = DistributedWalker(g, mesh, 2, kind="weighted", num_walks=600,
                           exchange="a2a", slack=16)
    walks, ov = wk.run(jax.random.PRNGKey(2))
    hub_rows = walks[walks[:, 0] == 0]
    freq = np.bincount(hub_rows[:, 1], minlength=k + 1)[1:]
    freq = freq / freq.sum()
    target = w / w.sum()
    np.testing.assert_allclose(freq, target, atol=0.04)


def test_a2a_multilayer_matches_replicated():
    """Multilayer walks through the exact exchange: visit distribution
    matches the replicated single-chip kernel; full accounting."""
    from graphembedding.models.struc2vec import (
        build_context_graph,
        build_layer_csr,
        multilayer_walks,
    )

    g = zipf_hub_graph(V=48, seed=1)
    layer_edges, K = build_context_graph(g)
    layers = build_layer_csr(layer_edges, g.num_nodes)
    mesh = make_mesh((len(jax.devices()), 1))
    w = DistributedWalker(
        None, mesh, 8, kind="multilayer", num_walks=40,
        num_nodes=g.num_nodes, layers=layers, exchange="a2a", slack=8,
    )
    walks, ov = w.run(jax.random.PRNGKey(0))
    assert ov == 0
    assert walks.shape == (40 * g.num_nodes, 8)
    assert (walks >= 0).all()  # forced steps: no dead walks
    counts = np.bincount(walks[:, 0], minlength=g.num_nodes)
    assert (counts == 40).all()
    # distribution vs the replicated kernel
    import jax.numpy as jnp

    starts = jnp.tile(
        jnp.arange(g.num_nodes, dtype=jnp.int32), 40
    )
    rw = multilayer_walks(
        jnp.asarray(layers["row_ptr"]), jnp.asarray(layers["col_idx"]),
        jnp.asarray(layers["accept"]), jnp.asarray(layers["alias"]),
        jnp.asarray(layers["gamma"]), starts,
        jax.random.PRNGKey(1), 0.3, length=8,
    )
    fa = np.bincount(walks.ravel(), minlength=g.num_nodes)
    fr = np.bincount(np.asarray(rw).ravel(), minlength=g.num_nodes)
    l1 = np.abs(fa / fa.sum() - fr / fr.sum()).sum()
    assert l1 < 0.1, l1


def test_a2a_engine_deterministic():
    """Same key -> identical corpus (golden-seed determinism,
    SURVEY.md §6 sanitizers row — the exchange engine included)."""
    g = zipf_hub_graph()
    mesh = make_mesh((len(jax.devices()), 1))
    w = DistributedWalker(g, mesh, 8, kind="uniform", num_walks=6,
                          exchange="a2a")
    a, _ = w.run(jax.random.PRNGKey(7))
    b, _ = w.run(jax.random.PRNGKey(7))
    np.testing.assert_array_equal(a, b)
    c, _ = w.run(jax.random.PRNGKey(8))
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("method", ["cumsum", "sort"])
def test_bucket_by_dest_fuzz_vs_numpy(seed, method):
    """Property check against an independent numpy reference: every
    crosser is either bucketed to its destination exactly once or
    held; buckets never mix destinations; capacities are respected;
    per-destination order of sent rows preserves index order."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(4, 200))
    vp = int(rng.integers(2, 9))
    n = int(rng.integers(2, 9))
    bcap = int(rng.integers(1, 6))
    send_cap = int(rng.integers(1, cap + 1))
    v = rng.integers(-1, vp * n, cap).astype(np.int32)
    w = rng.integers(-1, 1000, cap).astype(np.int32)
    t = rng.integers(0, 50, cap).astype(np.int32)
    sbuf, sent = bucket_by_dest(
        jnp.asarray(v), jnp.asarray(w), jnp.asarray(t), vp, n, bcap,
        send_cap=send_cap, method=method,
    )
    sbuf = np.asarray(sbuf).reshape(n, bcap, 3)
    sent = np.asarray(sent)

    # numpy reference: first-by-index under send_cap, then per-dest
    # first-by-index under bcap
    is_x = (w >= 0) & (v >= 0)
    exp_sent = np.zeros(cap, bool)
    exp_buckets = {d: [] for d in range(n)}
    n_cand = 0
    for i in range(cap):
        if not is_x[i] or n_cand >= send_cap:
            continue
        n_cand += 1
        d = v[i] // vp
        if len(exp_buckets[d]) < bcap:
            exp_buckets[d].append((v[i], w[i], t[i]))
            exp_sent[i] = True
    np.testing.assert_array_equal(sent, exp_sent)
    for d in range(n):
        rows = [tuple(r) for r in sbuf[d] if r[1] >= 0]
        assert rows == exp_buckets[d], (d, rows, exp_buckets[d])
        # padding rows are fully -1
        for r in sbuf[d][len(rows):]:
            assert tuple(r) == (-1, -1, -1)
