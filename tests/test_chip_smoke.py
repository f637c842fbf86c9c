"""chip_smoke.py on the CPU: it refuses to report success without a GPU,
and its phases run end to end at tiny sizes (the four-card checks on a
4-device virtual mesh)."""

import json
import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from graphembedding.data.datasets import (  # noqa: E402
    synthetic_flight,
    synthetic_wiki,
)


@pytest.fixture(scope="module")
def small_sbm():
    return synthetic_wiki(num_nodes=120, num_classes=3, avg_degree=8,
                          p_in=0.85, seed=3)


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_refuses_without_gpu(argv, capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(argv)
    assert e.value.code != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "GPU" in out.err


def test_phase_deepwalk_tiny(small_sbm):
    f1 = chip_smoke.phase_deepwalk(small_sbm, num_walks=20, gate=0.7,
                                   embed_size=32, block_walks=64,
                                   k_shared=16)
    assert f1 >= 0.7


def test_phase_sgns_tiny():
    chip_smoke.phase_sgns(G=8, P=4, L=6, D=16, K=8, nsp=2)


def test_phase_sgns_rejects_wrong_math(monkeypatch):
    from graphembedding.train import skipgram

    real = skipgram.sgns_block_grads_xla

    def off(*a, **k):
        d_yin, d_yout, d_vn, loss = real(*a, **k)
        return d_yin, d_yout * 1.01, d_vn, loss

    monkeypatch.setattr(skipgram, "sgns_block_grads_xla", off)
    with pytest.raises(AssertionError, match="d_yout"):
        chip_smoke.phase_sgns(G=8, P=4, L=6, D=16, K=8, nsp=2)


def test_phase_families_tiny(small_sbm, tmp_path):
    gates = {k: 0.0 for k in chip_smoke.GATES}
    chip_smoke.phase_families(
        small_sbm, synthetic_flight(num_nodes=40, seed=6), num_walks=4,
        iters=1, line_epochs=2, sdne_epochs=2, sdne_hidden=(16, 8),
        s2v_num_walks=2, temp_dir=str(tmp_path), gates=gates)


def test_phase_gate_fails_loudly(small_sbm):
    with pytest.raises(AssertionError, match="gate"):
        chip_smoke.phase_deepwalk(small_sbm, num_walks=2, iters=1,
                                  gate=1.01, embed_size=8,
                                  block_walks=32, k_shared=4)


def test_phase_million_tiny():
    chip_smoke.phase_million(V=4096, n_rep=1)


@pytest.fixture(scope="module")
def mesh4():
    return chip_smoke.four_mesh(jax.devices()[:4])


def test_four_mesh_distinct_devices(mesh4):
    assert mesh4.shape == {"data": 4, "model": 1}
    with pytest.raises(AssertionError, match="distinct"):
        chip_smoke.four_mesh([jax.devices()[0]] * 4)


def test_four_rowshard_exact(mesh4):
    chip_smoke.phase_rowshard(mesh4, rows_per_device=16, C=9, T=64)


def test_four_deepwalk_mesh_compare(mesh4, small_sbm):
    chip_smoke.phase_deepwalk_mesh(
        small_sbm, mesh4, tol=0.3, num_walks=20, gate=0.6,
        embed_size=32, block_walks=64, k_shared=16)


def test_four_deepwalk_mesh_compare_rejects_gap(mesh4, small_sbm):
    with pytest.raises(AssertionError, match="one card"):
        chip_smoke.phase_deepwalk_mesh(
            small_sbm, mesh4, single_f1=-1.0, num_walks=4, iters=1,
            gate=0.0, embed_size=8, block_walks=32, k_shared=4)


def test_four_sdne_mesh_matches_one_device(mesh4):
    ds = synthetic_wiki(num_nodes=100, num_classes=3, avg_degree=8,
                        seed=3)
    chip_smoke.phase_sdne_mesh(ds, mesh4, hidden=(32, 16), epochs=8)


@pytest.mark.gpu
def test_gpu_smoke_one_card(gpu_devices, capsys):
    """chip_smoke.py's one-card phases on the card, through main()."""
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": gpu_devices[0].device_kind,
        "count": len(gpu_devices)}}


@pytest.mark.gpu
def test_gpu_sgns_grads_real_shapes(gpu_devices):
    chip_smoke.phase_sgns()
