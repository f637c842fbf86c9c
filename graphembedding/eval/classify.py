"""Downstream node-classification oracle (micro/macro-F1).

Reference counterpart: `ge/classify.py — TopKRanker / Classifier /
read_node_label [U]`. This is the framework's correctness metric
(BASELINE.json: "Wiki node-classification micro-F1 vs reference"), so the
semantics are reproduced exactly:

- one-vs-rest logistic regression over the embedding vectors, with
  scikit-learn's `LogisticRegression()` defaults: L2 penalty at C=1,
  an unpenalised intercept, L-BFGS for at most 100 iterations;
- **top-k prediction rule**: for each test node, take its k highest
  class probabilities as the predicted label set, where k = the node's
  true label count (the standard multi-label eval trick — getting this
  wrong moves micro-F1 by points);
- fixed-seed shuffle split (`numpy.random.seed(seed)` then a single
  permutation), train fraction 0.8 in the canonical configs.

Host-side numpy/scipy by design — evaluation is not a device workload,
and the framework needs no package beyond scipy to score itself.
"""

from __future__ import annotations

import copy

import numpy as np
from scipy import optimize
from scipy.special import expit


class LogisticRegression:
    """Binary L2 logistic regression, scikit-learn's default objective.

    Minimises mean(log(1 + exp(z)) - y z) + ||w||² / (2 C n) over
    z = X w + b (the intercept b is not penalised), with scipy's
    L-BFGS-B and the stopping rule scikit-learn passes it.
    """

    def __init__(self, C: float = 1.0, max_iter: int = 100,
                 tol: float = 1e-4):
        self.C = C
        self.max_iter = max_iter
        self.tol = tol

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        n, d = X.shape
        l2 = 1.0 / (self.C * n)

        def loss_grad(wb):
            w, b = wb[:d], wb[d]
            z = X @ w + b
            # log(1 + e^z) without overflow
            loss = np.mean(np.logaddexp(0.0, z) - y * z) + 0.5 * l2 * (w @ w)
            r = (expit(z) - y) / n
            return loss, np.concatenate([X.T @ r + l2 * w, [r.sum()]])

        res = optimize.minimize(
            loss_grad, np.zeros(d + 1), method="L-BFGS-B", jac=True,
            options={"maxiter": self.max_iter, "maxls": 50,
                     "gtol": self.tol, "ftol": 64 * np.finfo(float).eps},
        )
        self.coef_, self.intercept_ = res.x[:d], res.x[d]
        return self

    def predict_proba(self, X):
        """[n, 2] probabilities of class 0 and class 1."""
        p = expit(np.asarray(X, np.float64) @ self.coef_ + self.intercept_)
        return np.stack([1.0 - p, p], axis=1)


class TopKRanker:
    """One-vs-rest over a {0,1} label matrix; predicts each row's top-k
    classes, k given per row."""

    def __init__(self, estimator=None):
        self.estimator = estimator

    def fit(self, X, Y):
        """Y: [n, C] {0,1} indicator matrix, one binary problem per
        column. A column with one value throughout predicts that value,
        as scikit-learn's OneVsRestClassifier does."""
        Y = np.asarray(Y)
        self.classes_ = np.arange(Y.shape[1])
        self.estimators_ = []
        for c in self.classes_:
            col = Y[:, c]
            if col.min() == col.max():
                self.estimators_.append(float(col[0]))
            else:
                est = (LogisticRegression() if self.estimator is None
                       else copy.deepcopy(self.estimator))
                self.estimators_.append(est.fit(X, col))
        return self

    def predict_proba(self, X):
        n = len(X)
        return np.stack([
            np.full(n, e) if isinstance(e, float)
            else e.predict_proba(X)[:, 1]
            for e in self.estimators_
        ], axis=1)

    def predict(self, X, top_k_list):
        probs = self.predict_proba(X)
        out = np.zeros_like(probs)
        for i, k in enumerate(top_k_list):
            out[i, self.classes_[probs[i].argsort()[-k:]]] = 1
        return out


def _binarize(Y, classes):
    index = {c: j for j, c in enumerate(classes)}
    out = np.zeros((len(Y), len(classes)), np.int8)
    for i, labels in enumerate(Y):
        for lab in labels:
            out[i, index[lab]] = 1
    return out


def _div(num, den):
    """num / den elementwise, 0 where den == 0 (zero_division=0)."""
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den > 0)


def f1_scores(Y_true, Y_pred) -> dict:
    """Multi-label F1 (micro, macro, samples, weighted) and subset
    accuracy of two {0,1} [n, C] matrices, with scikit-learn's
    `f1_score(..., zero_division=0)` and `accuracy_score` semantics."""
    T = np.asarray(Y_true).astype(bool)
    P = np.asarray(Y_pred).astype(bool)
    tp = (T & P).sum(0)
    fp = (~T & P).sum(0)
    fn = (T & ~P).sum(0)
    per_label = _div(2 * tp, 2 * tp + fp + fn)
    support = T.sum(0)
    tp_s = (T & P).sum(1)
    return {
        "micro": float(_div(2 * tp.sum(), 2 * tp.sum() + fp.sum()
                            + fn.sum())),
        "macro": float(per_label.mean()),
        "samples": float(_div(2 * tp_s, T.sum(1) + P.sum(1)).mean()),
        "weighted": float(_div((per_label * support).sum(),
                               support.sum())),
        "acc": float((T == P).all(1).mean()),
    }


class Classifier:
    def __init__(self, embeddings, clf=None):
        """`clf`: binary estimator with fit(X, y) / predict_proba(X),
        fitted once per label; default `LogisticRegression()`."""
        self.embeddings = embeddings
        self.clf = TopKRanker(clf)

    def train(self, X, Y, Y_all):
        self.classes_ = sorted({lab for labels in Y_all for lab in labels})
        X_train = np.asarray([self.embeddings[x] for x in X])
        self.clf.fit(X_train, _binarize(Y, self.classes_))

    def evaluate(self, X, Y):
        top_k_list = [len(l) for l in Y]
        Y_pred = self.predict(X, top_k_list)
        return f1_scores(_binarize(Y, self.classes_), Y_pred)

    def predict(self, X, top_k_list):
        X_ = np.asarray([self.embeddings[x] for x in X])
        return self.clf.predict(X_, top_k_list)

    def split_train_evaluate(self, X, Y, train_precent, seed=0):
        """Reference-exact seeded shuffle split (incl. the arg typo)."""
        state = np.random.get_state()
        training_size = int(train_precent * len(X))
        np.random.seed(seed)
        shuffle_indices = np.random.permutation(np.arange(len(X)))
        X_train = [X[shuffle_indices[i]] for i in range(training_size)]
        Y_train = [Y[shuffle_indices[i]] for i in range(training_size)]
        X_test = [X[shuffle_indices[i]] for i in range(training_size, len(X))]
        Y_test = [Y[shuffle_indices[i]] for i in range(training_size, len(X))]
        self.train(X_train, Y_train, Y)
        np.random.set_state(state)
        return self.evaluate(X_test, Y_test)


def read_node_label(filename, skip_head=False):
    """Read `node label [label...]` lines -> (X nodes, Y label-lists)."""
    X, Y = [], []
    with open(filename) as fin:
        if skip_head:
            fin.readline()
        for line in fin:
            vec = line.strip().split()
            if not vec:
                continue
            X.append(vec[0])
            Y.append(vec[1:])
    return X, Y
