"""C++ native host-runtime helpers (ctypes bindings).

The device compute path is JAX/XLA/Pallas; this package accelerates the
host-side preprocessing the reference delegated to third-party native code
(SURVEY.md §3.2): CSR construction, alias-table building, and struc2vec
DTW. Built on demand by `build.py` (plain g++ -> shared object); every
caller has a pure-numpy fallback, so an unbuilt native library is never
fatal.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_LIB_PATH = os.path.join(os.path.dirname(__file__), "libgraphnative.so")


def _load():
    global _LIB
    if _LIB is None:
        # always run build(): it no-ops when the .so is newer than the
        # source, and REBUILDS a stale library (a pre-existing .so from
        # an older source would otherwise load fine and then fail on a
        # newly added symbol, silently disabling every native path)
        from graphembedding.native.build import build

        build()
        _LIB = ctypes.CDLL(_LIB_PATH)
        _LIB.build_row_alias.restype = None
        _LIB.build_row_alias.argtypes = [
            ctypes.POINTER(ctypes.c_int64),  # row_ptr
            ctypes.c_int64,  # n_rows
            ctypes.POINTER(ctypes.c_double),  # weights
            ctypes.POINTER(ctypes.c_float),  # accept out
            ctypes.POINTER(ctypes.c_int32),  # alias out
        ]
        _LIB.dtw_rle.restype = ctypes.c_double
        _LIB.dtw_rle.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int32,  # opt1 flag
        ]
        _LIB.struc2vec_distances.restype = None
        _LIB.struc2vec_distances.argtypes = [
            ctypes.POINTER(ctypes.c_int64),  # row_ptr
            ctypes.POINTER(ctypes.c_int64),  # col_idx
            ctypes.c_int64,  # num_nodes
            ctypes.POINTER(ctypes.c_int64),  # pair u
            ctypes.POINTER(ctypes.c_int64),  # pair v
            ctypes.c_int64,  # n_pairs
            ctypes.c_int64,  # max_layers
            ctypes.POINTER(ctypes.c_double),  # out_dist
            ctypes.POINTER(ctypes.c_int64),  # out_nlayers
            ctypes.c_int64,  # n_threads
            ctypes.c_int32,  # dtw_mode: 0 exact, 1 fastdtw r=1
            ctypes.c_double,  # early_stop cumulative-distance cutoff
        ]
        _LIB.fastdtw_rle.restype = ctypes.c_double
        _LIB.fastdtw_rle.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int64,  # radius
        ]
    return _LIB


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def native_build_row_alias(row_ptr, weights):
    """Per-row alias tables over CSR weights — C++ fast path."""
    lib = _load()
    rp = np.ascontiguousarray(row_ptr, dtype=np.int64)
    w = np.ascontiguousarray(weights, dtype=np.float64)
    accept = np.empty(w.shape[0], dtype=np.float32)
    alias = np.empty(w.shape[0], dtype=np.int32)
    lib.build_row_alias(
        rp.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(rp.shape[0] - 1),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        accept.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        alias.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return accept, alias


def native_struc2vec_distances(row_ptr, col_idx, pairs_u, pairs_v,
                               max_layers, workers=1,
                               dtw_mode="fastdtw", early_stop=35.0):
    """Cumulative struc2vec DTW distances for (u, v) pairs — C++ path.

    CSR must be the symmetrized adjacency. Returns
    (dist [n_pairs, max_layers] float64, -1 padded; n_layers [n_pairs]).
    `workers`: threads for the per-root BFS and per-pair DTW loops
    (the reference's `workers=N` joblib role); 0 -> all hardware
    threads. `dtw_mode`: 'fastdtw' (radius-1 approximation — what the
    reference actually computes, O(n) per pair) or 'exact' (O(nm)
    oracle). `early_stop`: stop a pair's cumulative layer loop once
    the distance passes this value — the context-edge weights exp(-f)
    are below f32 resolution well before the default 35, so dropped
    deep-layer edges carry numerically-zero weight; 0 disables.
    """
    if not workers:
        workers = os.cpu_count() or 1
    lib = _load()
    rp = np.ascontiguousarray(row_ptr, dtype=np.int64)
    ci = np.ascontiguousarray(col_idx, dtype=np.int64)
    pu = np.ascontiguousarray(pairs_u, dtype=np.int64)
    pv = np.ascontiguousarray(pairs_v, dtype=np.int64)
    n_pairs = pu.shape[0]
    dist = np.full((n_pairs, max_layers), -1.0, dtype=np.float64)
    nlay = np.zeros(n_pairs, dtype=np.int64)
    lib.struc2vec_distances(
        rp.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ci.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(rp.shape[0] - 1),
        pu.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        pv.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n_pairs),
        ctypes.c_int64(max_layers),
        dist.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        nlay.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(int(workers)),
        ctypes.c_int32(1 if dtw_mode == "fastdtw" else 0),
        ctypes.c_double(float(early_stop)),
    )
    return dist, nlay


def native_fastdtw(seq_a, seq_b, radius=1) -> float:
    """fastdtw (struc2vec RLE cost) — C++ path; oracle: native_dtw."""
    lib = _load()
    a = np.ascontiguousarray(seq_a, dtype=np.float64)
    b = np.ascontiguousarray(seq_b, dtype=np.float64)
    return float(
        lib.fastdtw_rle(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int64(a.shape[0]),
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int64(b.shape[0]),
            ctypes.c_int64(int(radius)),
        )
    )


def native_dtw(seq_a, seq_b, opt1=True) -> float:
    """Exact DTW with the struc2vec ground cost — C++ fast path."""
    lib = _load()
    a = np.ascontiguousarray(seq_a, dtype=np.float64)
    b = np.ascontiguousarray(seq_b, dtype=np.float64)
    na = a.shape[0]
    nb = b.shape[0]
    return float(
        lib.dtw_rle(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int64(na),
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int64(nb),
            ctypes.c_int32(1 if opt1 else 0),
        )
    )
