"""Smoke tests for the examples layer: every script must import, build
its parser, and print help without touching a device — catches broken
imports/flags in `examples/` that the model tests can't see."""

import os
import subprocess
import sys

import pytest

EXAMPLES = [
    "deepwalk_wiki.py",
    "node2vec_wiki.py",
    "line_wiki.py",
    "line_blogcatalog.py",
    "sdne_wiki.py",
    "struc2vec_flight.py",
]

EX_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                      "examples")


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_help_runs(script):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, os.path.join(EX_DIR, script), "--help"],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=EX_DIR,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--dataset" in out.stdout
    assert "--plot" in out.stdout


def test_plot_embeddings_writes_png(tmp_path):
    """The t-SNE plot helper (reference `plot_embeddings [U]` parity)."""
    import numpy as np

    sys.path.insert(0, EX_DIR)
    try:
        from common import plot_embeddings
    finally:
        sys.path.remove(EX_DIR)
    from graphembedding.data.datasets import synthetic_wiki

    ds = synthetic_wiki(num_nodes=40, num_classes=3, seed=1)
    rng = np.random.default_rng(0)
    emb = {x: rng.standard_normal(8).astype(np.float32) for x in ds.X}
    out = tmp_path / "plot.png"
    plot_embeddings(emb, ds, str(out))
    assert out.exists() and out.stat().st_size > 1000


def test_mesh_from_args_parses_shapes():
    import jax

    sys.path.insert(0, EX_DIR)
    try:
        from common import make_parser, mesh_from_args
    finally:
        sys.path.remove(EX_DIR)

    p = make_parser("x", "wiki")
    assert mesh_from_args(p.parse_args([])) is None
    n = len(jax.devices())
    m = mesh_from_args(p.parse_args(["--mesh", str(n)]))
    assert m.shape == {"data": n, "model": 1}
    if n % 2 == 0:
        m2 = mesh_from_args(p.parse_args(["--mesh", f"{n//2}x2"]))
        assert m2.shape == {"data": n // 2, "model": 2}
