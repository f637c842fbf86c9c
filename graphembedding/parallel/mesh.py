"""Device mesh construction + distributed init.

The reference has NO distributed story (SURVEY.md §3.3 — single host,
joblib pipes); this module is new surface area mandated by the BASELINE
north star. Axes:

- `data`  — walk-block data parallelism (each group trains different
            blocks; tables averaged — the cross-host analogue of gensim's
            hogwild, see parallel/sgns.py);
- `model` — embedding-dimension tensor parallelism (column-sharded
            tables; logits psum over this axis — exact).

Across processes call `init_distributed()` first (wraps
`jax.distributed.initialize`; on GPUs each process drives its own
card(s) and gets `coordinator_address`, `num_processes` and
`process_id`); in tests an 8-device CPU mesh comes from
`--xla_force_host_platform_device_count=8`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def init_distributed(**kwargs) -> None:
    """Multi-host SPMD init (no-op if already initialized).

    Honors a `JAX_PLATFORMS` env override BEFORE the backend comes up
    (a config set earlier in the process would otherwise win); and
    initialization failures are LOUD when the caller passed an
    explicit multi-process config (a swallowed failure silently
    degrades to independent single-process runs).
    """
    import os

    env = os.environ.get("JAX_PLATFORMS")
    if env:
        try:
            jax.config.update("jax_platforms", env)
        except Exception:
            pass  # backend already initialized
    if getattr(jax.distributed, "is_initialized", None) is not None:
        if jax.distributed.is_initialized():
            return  # duplicate call — nothing to do
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError) as e:
        msg = str(e).lower()
        # Fallback duplicate-call detection for jax versions without
        # is_initialized(); restricted to the no-kwargs path so a
        # genuine coordination failure with explicit kwargs is never
        # swallowed by a message that happens to contain "already".
        if not kwargs and (
            "already" in msg or "only be called once" in msg
        ):
            return
        if not kwargs:
            # best-effort cluster autodetect: stay single-process but say
            # so — a silent degrade trains unsynced per-host models
            import warnings

            warnings.warn(
                f"jax.distributed.initialize() failed ({e}); "
                "continuing single-process. Pass explicit coordinator "
                "kwargs to make this an error instead.",
                stacklevel=2,
            )
            return
        raise


def put_global(x, mesh: Mesh, spec) -> jax.Array:
    """Make a host value usable as an input of a `shard_map` over a
    possibly MULTI-PROCESS mesh.

    Single-process (the common case, incl. the virtual CPU mesh):
    plain device put — unchanged behavior. Multi-process: every
    process holds the full host value (our corpora/partitions are
    built identically on every host from the same seed), so the
    process-local slice for this process's addressable devices is cut
    here and assembled into one global array via
    `jax.make_array_from_process_local_data`. Callers pass the same
    `spec` they use in `in_specs`.
    """
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    if not isinstance(x, (jax.Array, np.ndarray)):
        x = np.asarray(x)  # lists etc.: device_put would pytree them
    if jax.process_count() == 1:
        # committed to the mesh sharding (NOT a bare default-device
        # put): checkpoint templates and donation derive shardings
        # from these arrays. Device inputs reshard device-to-device —
        # no host round trip (a np.asarray here would pull a 10 GB
        # table through PCIe at 10M nodes)
        return jax.device_put(x, sharding)
    x = np.asarray(x)
    # every process passes the FULL host value with an explicit
    # global_shape: jax slices out each process's shards (verified
    # against the 2-process gloo smoke, docs/MULTIHOST.md)
    return jax.make_array_from_process_local_data(
        sharding, x, global_shape=x.shape
    )


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axes: Sequence[str] = ("data", "model"),
    devices=None,
) -> Mesh:
    """Build a 2-D (data, model) mesh over the available devices.

    Default shape: all devices on the data axis, model=1 (shallow-model
    workloads shard best over data; pass an explicit shape for TP).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, tuple(axes))
