"""Tracing / profiling helpers (SURVEY.md §6 aux subsystem).

Reference counterpart: none (`verbose` prints only). Provides:

- `trace(path)`: context manager around `jax.profiler.trace` — writes a
  TensorBoard/Perfetto trace of everything inside;
- `sgns_roofline(...)`: analytic ceiling for the walk-block SGNS step,
  used to sanity-check measured pairs/s against hardware limits
  (BASELINE: "kernels at speed-of-light per chip").

Roofline model
--------------
The step has four phases:

1. row GATHER   — token and negative rows read from the fused [V, 2D]
                  table, at a per-row cost.
2. compute      — the window/negative einsums at flops / peak FLOP/s.
3. elementwise  — the [G, PL, PL] mask/sigmoid traffic at bytes / peak
                  bandwidth.
4. row SCATTER  — token rows (width 2D+1 — the occupancy column) and
                  negative rows written back, at a per-row cost.

Three bounds:

- `pairs_per_s_serial_floor` = pairs / sum(all four phases): the
  fully serialized execution.
- `pairs_per_s_rowtraffic_ceiling` = pairs / (t_gather + t_scatter):
  the same-step row-traffic time.
- `pairs_per_s_pipelined_ceiling` = pairs / max(t_gather, t_scatter):
  the steady-state bound when neighbouring steps' gather and scatter
  streams overlap; a step's gathers depend on the prior table state, so
  that stream cannot itself be split.

`Roofline` takes the device's peaks and per-row costs explicitly: there
is no default device. A table of measured peaks keyed by
`device_kind` belongs beside the benchmark (ROADMAP S2); none is
measured on the H100 yet.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass


@contextmanager
def trace(path: str):
    import jax

    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class Roofline:
    flops: float
    pairs: float
    peak_flops: float          # device FLOP/s at the step's precision
    peak_bw: float             # device memory bytes/s
    gather_ns_per_row: float   # measured row-gather cost on the device
    scatter_ns_per_row: float  # measured row-scatter cost on the device
    gather_rows: float = 0.0   # table rows read per step
    scatter_rows: float = 0.0  # table rows written per step
    vpu_bytes: float = 0.0     # elementwise mask/sigmoid memory traffic

    def __post_init__(self):
        for name in ("peak_flops", "peak_bw", "gather_ns_per_row",
                     "scatter_ns_per_row"):
            v = getattr(self, name)
            if v is None or not v > 0:
                raise ValueError(
                    f"Roofline.{name} must be a measured positive "
                    f"value for the device, got {v!r}")

    @property
    def t_compute(self):
        return self.flops / self.peak_flops

    @property
    def t_vpu(self):
        return self.vpu_bytes / self.peak_bw

    @property
    def t_gather(self):
        return self.gather_rows * self.gather_ns_per_row * 1e-9

    @property
    def t_scatter(self):
        return self.scatter_rows * self.scatter_ns_per_row * 1e-9

    @property
    def t_serialized(self):
        return (self.t_gather + self.t_compute + self.t_vpu
                + self.t_scatter)

    @property
    def bound(self):
        t = {
            "gather": self.t_gather,
            "compute": self.t_compute,
            "vpu": self.t_vpu,
            "scatter": self.t_scatter,
        }
        return max(t, key=t.get)

    @property
    def pairs_per_s_serial_floor(self):
        """Fully-serialized execution — the worst case."""
        return self.pairs / self.t_serialized

    @property
    def pairs_per_s_rowtraffic_ceiling(self):
        """Same-step row-traffic bound: gather + scatter of one step
        back to back."""
        return self.pairs / max(self.t_gather + self.t_scatter, 1e-12)

    @property
    def pairs_per_s_pipelined_ceiling(self):
        """Steady-state pipelined ceiling: with neighbouring steps'
        gathers and scatters overlapped, the stage time is the slower
        of the two row streams."""
        return self.pairs / max(self.t_gather, self.t_scatter, 1e-12)


def sgns_roofline(*, peak_flops, peak_bw, gather_ns_per_row,
                  scatter_ns_per_row, block_walks=4032, walk_len=10,
                  window=5, k_shared=64, embed_dim=128, dtype_bytes=4,
                  neg_share_packs=4):
    """Per-step roofline of the packed walk-block SGNS step.

    Shapes mirror `train.skipgram.sgns_block_chunk`: P = 128//L walks
    per packed tile, G = Bw/P groups, PL = P*L positions per group, one
    shared negative set per `neg_share_packs` groups.
    """
    L, W, D, K = walk_len, window, embed_dim, k_shared
    P = max(128 // L, 1)
    G = block_walks // P
    PL = P * L
    G2 = max(G // max(neg_share_packs, 1), 1)
    tokens = G * PL
    # matmuls: logits [G,PL,PL,D], nlog [G2,nsp*PL,K,D], and the four
    # gradient einsums (d_yin pos+neg, d_yout, d_vn)
    flops = 2 * G * PL * D * (2 * PL + 2 * PL + K + K + K)
    # row traffic on the fused [V, 2D] table:
    #   gather: one row per token + one per shared negative
    #   scatter: one (2D+1)-wide row per token (occupancy column rides
    #   along) + one (D+1)-wide row per shared negative
    gather_rows = tokens + G2 * K
    scatter_rows = tokens + G2 * K
    # elementwise traffic: the [G, PL, PL] logits/mask/g_pos chain and
    # the [G2, nsp*PL, K] negative chain — ~6 full array passes each
    # (write+read of logits, mask, gradient scale), at f32
    vpu_bytes = 6 * (G * PL * PL + G2 * (PL * (G // G2)) * K) * dtype_bytes
    # expected trained pairs per step on the canonical config
    pairs_per_walk = 2 * sum(
        (W - d + 1) / W for d in range(1, W + 1)
    ) * (L - W / 2) / L * L  # ~56 for L=10, W=5
    pairs = block_walks * min(pairs_per_walk, 2 * W * L)
    return Roofline(flops=float(flops), pairs=float(pairs),
                    peak_flops=peak_flops, peak_bw=peak_bw,
                    gather_ns_per_row=gather_ns_per_row,
                    scatter_ns_per_row=scatter_ns_per_row,
                    gather_rows=float(gather_rows),
                    scatter_rows=float(scatter_rows),
                    vpu_bytes=float(vpu_bytes))
