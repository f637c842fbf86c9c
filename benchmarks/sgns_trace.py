"""Device-time share of the SGNS block-gradient kernels in the wiki chunk.

Runs the walk-block trainer's compiled chunk (`sgns_block_chunk_cat`) on
the wiki graph at the DeepWalk main path's shapes (80 walks of length 10
per node, the trainer's block policy and cap mode), traces a few warm
chunks with `jax.profiler`, and reduces the trace:

- busy: the union of all kernel intervals on the device's streams over
  the traced window;
- block_grads: the kernels whose own HLO op is in the
  `sgns_block_grads` name scope, or whose fused body is mostly in it —
  the six einsums, sigmoids and loss of `sgns_block_grads_xla`;
- block_grads_fused_upper: the kernels that hold any operation of the
  scope, fused or not — an upper bound that also counts the gradient
  scatters into which XLA fuses the last gradient sums;
- the top kernels by device time, with their HLO op names.

    python -m benchmarks.sgns_trace [--out DIR] [--chunks 4]

Writes DIR/summary.json (and the raw trace under DIR) and prints the
summary as one JSON line. Needs a GPU.

XLA on the GPU replays a compiled step as one CUDA graph ("command
buffer"), which the trace shows as a single event. This script turns
command buffers off (`--xla_gpu_enable_command_buffer=` in XLA_FLAGS,
set before JAX starts) so each kernel appears on its own, and also times
the same number of chunks untraced, so the cost of the flag and of
tracing can be read against a run with command buffers on.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import time
from collections import defaultdict

SCOPE = "sgns_block_grads"


def classify_hlo_ops(hlo_text: str, scope: str = SCOPE):
    """HLO instructions attributed to `scope`, as two sets of names.

    `majority`: an instruction whose own op_name metadata is in the
    scope, or a fusion whose body's operations (those with op_name
    metadata) are mostly in the scope. `any`: also a fusion whose body
    holds even one such operation — an upper bound, since XLA fuses the
    last gradient sums into the scatters that consume them."""
    in_scope = re.compile(r'op_name="[^"]*' + re.escape(scope) + "/")
    has_meta = re.compile(r'op_name="')
    counts = defaultdict(lambda: [0, 0])  # computation -> [meta, scoped]
    calls, own = {}, set()
    current = None
    for line in hlo_text.splitlines():
        head = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{\s*$", line)
        if head and not line.startswith(" "):
            current = head.group(1)
            continue
        if line.startswith("}"):
            current = None
            continue
        ins = re.match(r"^\s+(?:ROOT )?%?([\w.\-]+) = ", line)
        if not ins:
            continue
        name = ins.group(1)
        scoped = in_scope.search(line) is not None
        if scoped:
            own.add(name)
        if current is not None and has_meta.search(line):
            counts[current][0] += 1
            counts[current][1] += scoped
        called = re.search(r"calls=%?([\w.\-]+)", line)
        if called:
            calls[name] = called.group(1)
    majority = own | {n for n, c in calls.items()
                      if 2 * counts[c][1] > counts[c][0]}
    anyone = own | {n for n, c in calls.items() if counts[c][1]}
    return majority, anyone


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path: str, majority: set, anyone: set,
                 scope: str = SCOPE) -> dict:
    """Busy time, block-gradient kernel time and top kernels from one
    `.xplane.pb`, over the kernel events of the GPU stream lines. A
    kernel counts toward block_grads when its HLO op is in `majority`
    or its own op name (the trace's `name` stat) is in the scope, and
    toward the upper bound when its op is in `anyone`."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    intervals, per_op = [], defaultdict(int)
    grads_ns, upper_ns, lines_seen = 0, 0, set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            lines_seen.add(f"{plane.name}|{line.name}")
            for ev in line.events:
                stats = {k: v for k, v in ev.stats}
                op = str(stats.get("hlo_op", ev.name))
                start = int(ev.start_ns)
                dur = int(ev.duration_ns)
                intervals.append((start, start + dur))
                per_op[op] += dur
                own = str(stats.get("name", ""))
                strict = (op in majority
                          or re.search(rf"/{scope}(/|$)", own) is not None)
                grads_ns += dur if strict else 0
                upper_ns += dur if (strict or op in anyone) else 0
    if not intervals:
        raise RuntimeError(f"no GPU stream events in {path}")
    busy = _union_ns(intervals)
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    kernel_ns = sum(per_op.values())
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:15]
    return {
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window,
        "kernel_ms": kernel_ns / 1e6,
        "block_grads_ms": grads_ns / 1e6,
        "block_grads_share_of_kernel_time": grads_ns / kernel_ns,
        "block_grads_share_of_busy": grads_ns / busy,
        "block_grads_fused_upper_ms": upper_ns / 1e6,
        "block_grads_fused_upper_share": upper_ns / kernel_ns,
        "top_kernels_ms": [[op, ns / 1e6, op in majority, op in anyone]
                           for op, ns in top],
        "stream_lines": sorted(lines_seen),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/sgns_trace")
    ap.add_argument("--chunks", type=int, default=4)
    args = ap.parse_args(argv)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_gpu_enable_command_buffer=").strip()

    import jax
    import jax.numpy as jnp
    import numpy as np

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {jax.devices()}")
    from graphembedding.data import load_dataset
    from graphembedding.ops.walk import simulate_walks
    from graphembedding.train.skipgram import (
        SkipGramConfig,
        SkipGramTrainer,
        corpus_counts,
        negative_table,
        plan_block_walks,
        sgns_block_chunk_cat,
    )

    g = load_dataset("wiki").graph
    V = g.num_nodes
    walks = simulate_walks(g, 80, 10, jax.random.PRNGKey(0))
    table = jnp.asarray(negative_table(corpus_counts(np.asarray(walks), V)))
    cfg = SkipGramConfig(epochs=3)
    NW, L = walks.shape
    kw = dict(
        chunk_steps=cfg.chunk_steps,
        block_walks=plan_block_walks(NW, L, V, cfg), window=cfg.window,
        negative=cfg.negative, k_shared=cfg.k_shared,
        neg_share_walks=cfg.neg_share_walks,
        neg_share_packs=cfg.neg_share_packs, update_cap=cfg.update_cap,
        sparse_cap=V >= (1 << 16),
    )
    w_cat = SkipGramTrainer(cfg)._init_cat(V, jax.random.PRNGKey(1))
    consts = (jax.random.PRNGKey(2), jnp.float32(cfg.alpha),
              jnp.float32(cfg.min_alpha))
    total = jnp.float32(1e5)

    def chunk(w_cat, t):
        return sgns_block_chunk_cat(w_cat, walks, table, *consts,
                                    jnp.int32(t), total, **kw)

    hlo = sgns_block_chunk_cat.lower(
        w_cat, walks, table, *consts, jnp.int32(0), total, **kw
    ).compile().as_text()
    majority, anyone = classify_hlo_ops(hlo)
    t = 0
    for _ in range(2):  # compile + warm
        w_cat, l, p = chunk(w_cat, t)
        t += cfg.chunk_steps
    jax.block_until_ready(w_cat)

    def window(w_cat, t):
        pairs = []
        t0 = time.perf_counter()
        for _ in range(args.chunks):
            w_cat, _, p = chunk(w_cat, t)
            pairs.append(p)
            t += cfg.chunk_steps
        jax.block_until_ready(w_cat)
        wall = time.perf_counter() - t0
        return w_cat, t, wall, float(jnp.sum(jnp.stack(
            [q.sum() for q in pairs])))

    w_cat, t, wall_plain, pairs_plain = window(w_cat, t)
    os.makedirs(args.out, exist_ok=True)
    jax.profiler.start_trace(args.out)
    w_cat, t, wall, n_pairs = window(w_cat, t)
    jax.profiler.stop_trace()

    path = sorted(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    with open(os.path.join(args.out, "chunk_hlo.txt"), "w") as f:
        f.write(hlo)
    summary = reduce_trace(path, majority, anyone)
    summary.update({
        "device": jax.devices()[0].device_kind,
        "nodes": V, "walks": NW, "block_walks": kw["block_walks"],
        "sparse_cap": kw["sparse_cap"], "chunks": args.chunks,
        "steps": args.chunks * cfg.chunk_steps,
        "traced_wall_s": wall, "pairs_per_s_traced": n_pairs / wall,
        "pairs_per_s_untraced": pairs_plain / wall_plain,
        "hlo_ops_in_scope": [len(majority), len(anyone)],
        "xla_flags": os.environ["XLA_FLAGS"],
    })
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
