import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

from graphembedding.eval.classify import Classifier, read_node_label

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_topk_rule_and_split(tmp_path):
    # build a separable toy problem: 3 classes in embedding space
    rng = np.random.default_rng(0)
    n_per = 40
    emb = {}
    X, Y = [], []
    centers = np.eye(3) * 5
    for c in range(3):
        for i in range(n_per):
            name = f"n{c}_{i}"
            emb[name] = centers[c] + rng.standard_normal(3) * 0.3
            X.append(name)
            Y.append([str(c)])
    clf = Classifier(emb)
    res = clf.split_train_evaluate(X, Y, 0.8, seed=0)
    assert res["micro"] > 0.95
    assert set(res) == {"micro", "macro", "samples", "weighted", "acc"}


def test_split_is_seeded_and_restores_rng_state():
    rng_before = np.random.random()
    emb = {f"x{i}": np.array([float(i), 1.0]) for i in range(20)}
    X = [f"x{i}" for i in range(20)]
    Y = [[str(i % 2)] for i in range(20)]
    clf = Classifier(emb)
    r1 = clf.split_train_evaluate(X, Y, 0.5, seed=7)
    clf2 = Classifier(emb)
    r2 = clf2.split_train_evaluate(X, Y, 0.5, seed=7)
    assert r1 == r2


def test_multilabel_topk():
    # node with 2 true labels gets exactly its top-2 predicted
    rng = np.random.default_rng(1)
    emb, X, Y = {}, [], []
    for i in range(60):
        which = i % 3
        v = np.zeros(3)
        v[which] = 3
        v[(which + 1) % 3] = 2.5
        emb[f"m{i}"] = v + rng.standard_normal(3) * 0.1
        X.append(f"m{i}")
        Y.append([str(which), str((which + 1) % 3)])
    clf = Classifier(emb)
    res = clf.split_train_evaluate(X, Y, 0.7, seed=0)
    assert res["micro"] > 0.8


def test_read_node_label(tmp_path):
    p = tmp_path / "labels.txt"
    p.write_text("a 1 2\nb 0\n\nc 2\n")
    X, Y = read_node_label(str(p))
    assert X == ["a", "b", "c"]
    assert Y == [["1", "2"], ["0"], ["2"]]


def _multilabel_problem(seed=0, n=200, d=8, C=4):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d))
    Y = (X @ rng.standard_normal((d, C))
         + rng.standard_normal((n, C)) > 0.7).astype(int)
    Y[:, -1] = 0  # a label absent from training: constant predictor
    return X, Y


def test_probabilities_match_sklearn():
    sk_lm = pytest.importorskip("sklearn.linear_model")
    sk_mc = pytest.importorskip("sklearn.multiclass")
    from graphembedding.eval.classify import TopKRanker

    X, Y = _multilabel_problem()
    got = TopKRanker().fit(X, Y).predict_proba(X)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "label not 3 is present in all"
        want = sk_mc.OneVsRestClassifier(
            sk_lm.LogisticRegression()).fit(X, Y).predict_proba(X)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_micro_f1_matches_sklearn_pipeline():
    """Seeded split, one-vs-rest LR, top-k rule and F1 averages equal
    the reference's scikit-learn pipeline."""
    pytest.importorskip("sklearn")
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import f1_score
    from sklearn.multiclass import OneVsRestClassifier
    from sklearn.preprocessing import MultiLabelBinarizer

    rng = np.random.default_rng(3)
    n, d = 150, 6
    centers = rng.standard_normal((4, d)) * 2
    emb, X, Y = {}, [], []
    for i in range(n):
        labs = sorted({int(rng.integers(4)) for _ in range(1 + i % 2)})
        emb[f"v{i}"] = centers[labs].sum(0) + rng.standard_normal(d)
        X.append(f"v{i}")
        Y.append([str(c) for c in labs])
    got = Classifier(emb).split_train_evaluate(X, Y, 0.8, seed=0)

    np.random.seed(0)
    perm = np.random.permutation(np.arange(n))
    tr, te = perm[:int(0.8 * n)], perm[int(0.8 * n):]
    mlb = MultiLabelBinarizer().fit(Y)
    clf = OneVsRestClassifier(LogisticRegression()).fit(
        np.asarray([emb[X[i]] for i in tr]), mlb.transform([Y[i] for i in tr]))
    probs = clf.predict_proba(np.asarray([emb[X[i]] for i in te]))
    pred = np.zeros_like(probs)
    for r, i in enumerate(te):
        pred[r, probs[r].argsort()[-len(Y[i]):]] = 1
    truth = mlb.transform([Y[i] for i in te])
    for avg in ("micro", "macro", "samples", "weighted"):
        want = f1_score(truth, pred, average=avg, zero_division=0)
        assert got[avg] == pytest.approx(want, abs=1e-12), avg


def test_data_import_needs_no_sklearn(tmp_path):
    """The data loaders and the classifier import with scikit-learn
    unavailable (a None entry in sys.modules blocks the import)."""
    code = (
        "import sys\n"
        "sys.modules['sklearn'] = None\n"
        "import graphembedding\n"
        "from graphembedding.data import load_dataset\n"
        "from graphembedding.eval.classify import Classifier\n"
        "ds = load_dataset('wiki')\n"
        "assert ds.graph.num_nodes > 0\n"
        "print('OK')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, env=env, cwd=REPO,
    )
    assert out.stdout.strip().endswith("OK"), out.stderr[-2000:]
