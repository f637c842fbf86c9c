"""Round-start reference-mount readiness (parity_check.py) against a
mock mount layout — so the one-command re-baseline is known-working
before the session where /root/reference is actually populated."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import parity_check


def _mock_mount(root, num_nodes=40, seed=0):
    """A minimal populated reference checkout: ge/ sources, examples/,
    and real-format data files (weighted wiki edgelist + labels,
    unweighted flight edgelist + labels)."""
    rng = np.random.default_rng(seed)
    ge = root / "ge"
    (ge / "models").mkdir(parents=True)
    (root / "examples").mkdir()
    (ge / "__init__.py").write_text("from .models import *\n")
    (ge / "models" / "__init__.py").write_text(
        "from .deepwalk import DeepWalk\n"
    )
    for f in ("deepwalk", "node2vec", "line", "sdne", "struc2vec"):
        (ge / "models" / f"{f}.py").write_text(
            f"class {f.title()}:\n    pass\n"
        )
    for f in ("utils", "alias", "walker", "classify"):
        (ge / f"{f}.py").write_text(f"# mock {f}\n")
    (root / "examples" / "deepwalk_wiki.py").write_text("pass\n")

    wiki = root / "data" / "wiki"
    wiki.mkdir(parents=True)
    # two planted communities so quick DeepWalk separates them
    edges = []
    for u in range(num_nodes):
        for _ in range(4):
            half = num_nodes // 2
            if rng.random() < 0.9:
                v = int(rng.integers(0, half)) + (
                    half if u >= half else 0
                )
            else:
                v = int(rng.integers(0, num_nodes))
            if v != u:
                edges.append((u, v, int(rng.integers(1, 4))))
    wiki.joinpath("Wiki_edgelist.txt").write_text(
        "\n".join(f"{u} {v} {w}" for u, v, w in edges) + "\n"
    )
    wiki.joinpath("wiki_labels.txt").write_text(
        "\n".join(
            f"{i} {0 if i < num_nodes // 2 else 1}"
            for i in range(num_nodes)
        ) + "\n"
    )
    flight = root / "data" / "flight"
    flight.mkdir(parents=True)
    fedges = [(u, int(rng.integers(0, 30))) for u in range(30)
              for _ in range(3)]
    fedges = [(u, v) for u, v in fedges if u != v]
    flight.joinpath("brazil-airports.edgelist").write_text(
        "\n".join(f"{u} {v}" for u, v in fedges) + "\n"
    )
    deg = np.zeros(30, int)
    for u, v in fedges:
        deg[u] += 1
        deg[v] += 1
    quart = np.searchsorted(
        np.quantile(deg, [0.25, 0.5, 0.75]), deg, side="right"
    )
    flight.joinpath("labels-brazil-airports.txt").write_text(
        "node label\n"
        + "\n".join(f"{i} {quart[i]}" for i in range(30)) + "\n"
    )
    return root


def test_empty_mount_reports_and_exits_zero(tmp_path, capsys):
    empty = tmp_path / "ref"
    empty.mkdir()
    rc = parity_check.main(["--root", str(empty)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["mount"] == "empty"
    assert out["files"] == 0


def test_mock_mount_full_run(tmp_path, capsys, monkeypatch):
    root = _mock_mount(tmp_path / "ref")
    out = tmp_path / "PARITY_RUN"
    monkeypatch.chdir(tmp_path)
    # main() exports GE_REFERENCE_ROOT for load_dataset; setenv
    # first so monkeypatch restores the var after the test
    monkeypatch.setenv("GE_REFERENCE_ROOT", str(root))
    rc = parity_check.main(
        ["--root", str(root), "--out", str(out), "--quick"]
    )
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip())
    assert summary["mount"] == "populated"
    # all SURVEY-cited paths exist in the mock layout
    assert summary["citations_missing"] == 0
    report = json.load(open(str(out) + ".json"))
    base = report["baseline"]
    assert len(base) == len(parity_check.QUICK_CONFIGS)
    by_model = {r["model"]: r for r in base}
    # the mock mount's REAL files were used, not synthetics
    assert by_model["deepwalk"]["real_data"]
    assert by_model["deepwalk"]["dataset"] == "wiki"
    assert by_model["struc2vec"]["real_data"]
    # planted 2-community mock graph: even the quick run separates it
    assert by_model["deepwalk"]["micro_f1"] > 0.6
    md = open(str(out) + ".md").read()
    assert "BASELINE.md protocol" in md
    assert "| deepwalk | wiki | YES |" in md


def test_mock_mount_copycheck_flags_real_overlap(tmp_path):
    """A reference file cloned from one of ours must be flagged."""
    root = _mock_mount(tmp_path / "ref")
    repo = os.path.dirname(os.path.abspath(parity_check.__file__))
    ours = os.path.join(repo, "graphembedding", "ops", "alias.py")
    (tmp_path / "ref" / "ge" / "alias.py").write_text(
        open(ours).read()
    )
    copies = parity_check.copycheck(str(root), repo)
    top = copies[0]
    assert top["ours"].endswith("ops/alias.py")
    assert top["similarity"] > 0.9
    # and unrelated mock stubs do not trip the threshold
    assert all(
        c["similarity"] < 0.6 for c in copies
        if not c["ours"].endswith("alias.py")
    )


def test_make_parity_target_exists():
    mk = open(os.path.join(
        os.path.dirname(os.path.abspath(parity_check.__file__)),
        "Makefile",
    )).read()
    assert "parity:" in mk and "parity_check.py" in mk


@pytest.mark.skipif(
    os.environ.get("GE_RUN_SUBPROCESS_TESTS", "1") != "1",
    reason="subprocess test disabled",
)
def test_cli_empty_mount_subprocess(tmp_path):
    """The CLI entry works as `python parity_check.py` (what `make
    parity` runs) without importing the heavy model stack."""
    empty = tmp_path / "ref"
    empty.mkdir()
    repo = os.path.dirname(os.path.abspath(parity_check.__file__))
    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "parity_check.py"),
         "--root", str(empty)],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert proc.returncode == 0
    assert json.loads(proc.stdout)["mount"] == "empty"
