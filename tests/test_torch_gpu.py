"""The port's hand-written CUDA kernels on the card, held against their plain
PyTorch versions, and a small main path run on the card against the same
program on the CPU.

Every test is marked ``gpu`` and skips where torch finds no card: a CUDA
kernel has no CPU or interpret mode.  This file imports neither jax nor
pandas, so it runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: compaction and zone maps are exact; integer sums and counts
are exact; float64 sums agree to rtol 1e-9 (the kernel sums in another
order than ``index_add_``) and are bit-identical run to run.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu

CUDA = ops.KernelConfig(impl="cuda")


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU "
                    "or interpret mode")
    monkeypatch.setenv("REPRO_TORCH_DEVICE", "cuda")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 100_003])
def test_filter_compact_matches_plain(rng, card, n):
    vals = rng.normal(size=n)
    vals[::7] = np.nan
    cols = {"f": _t(vals, card), "g": _t(vals.astype(np.float32), card),
            "i": _t(rng.integers(-2**62, 2**62, n), card),
            "s": _t(rng.integers(-2**15, 2**15, n).astype(np.int16), card),
            "b": _t(rng.random(n) < 0.5, card)}
    mask = _t(rng.random(n) < 0.4, card)
    got = ops.filter_compact_table(cols, mask, CUDA)
    want = ref.filter_compact_table_ref(cols, mask)
    for k in cols:
        assert torch.equal(got[k].view(torch.uint8), want[k].view(torch.uint8)), k
    p, c = ops.filter_compact(cols["i"], mask, CUDA)
    rp, rc = ref.filter_compact_ref(cols["i"], mask)
    assert int(c) == int(rc) and torch.equal(p, rp)


@pytest.mark.parametrize("g", [1, 3, 50_000])
@pytest.mark.parametrize("dtype", [np.float64, np.int64])
def test_groupby_sum_matches_plain(rng, card, g, dtype):
    n = 200_003
    codes = _t(rng.integers(-1, g + 1, n), card)
    vals = _t((rng.normal(size=(n, 2)) * 100).astype(dtype), card)
    s, c = ops.groupby_sum_count(codes, vals, g, cfg=CUDA)
    rs, rc = ref.groupby_sum_count_ref(codes, vals, g)
    assert torch.equal(c, rc)
    if dtype == np.int64:
        assert torch.equal(s, rs)
    else:
        torch.testing.assert_close(s, rs, rtol=1e-9, atol=1e-9)
    s2, c2 = ops.groupby_sum_count(codes, vals, g, cfg=CUDA)
    assert torch.equal(s, s2) and torch.equal(c, c2)      # run to run


def test_groupby_count_exact_past_2_24(card):
    codes = torch.zeros((1 << 25) + 3, dtype=torch.int64, device=card)
    _, c = ops.groupby_sum_count(codes, None, 1, cfg=CUDA)
    assert int(c[0]) == (1 << 25) + 3


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int8, np.uint8,
                                   np.int16, np.int32, np.int64])
def test_zonemap_matches_plain(rng, card, dtype):
    vals = (rng.normal(size=100_003) * 100).astype(dtype)
    if vals.dtype.kind == "f":
        vals[5000] = np.nan
    x = _t(vals, card)
    mn, mx = ops.zonemap(x, 4096, CUDA)
    rmn, rmx = ref.zonemap_ref(x, 4096)
    assert torch.equal(mn.view(torch.uint8), rmn.view(torch.uint8))
    assert torch.equal(mx.view(torch.uint8), rmx.view(torch.uint8))


def test_main_path_on_card_matches_cpu(rng, card, monkeypatch):
    import repro_torch.pandas as pd
    from repro_torch.kernels import filter_compact, groupby_sum, zonemap

    n = 50_000
    arrays = {"fare": rng.uniform(-5, 100, n), "tip": rng.uniform(0, 20, n),
              "vendor": rng.integers(0, 3, n).astype(np.int32)}

    def run():
        with pd.session(engine="eager", name="gpu-test"):
            df = pd.from_arrays(arrays, 4096, dicts={"vendor": ["a", "b", "c"]})
            df = df[df["fare"] > 0]
            df["tip_rate"] = df["tip"] / df["fare"]
            res = df.groupby("vendor")["tip_rate"].mean().compute()
        return {k: v for k, v in res.columns.items()}

    mods = (filter_compact, groupby_sum, zonemap)
    before = [m.launches for m in mods]
    on_card = run()
    assert all(m.launches > b for m, b in zip(mods, before))
    assert all(v.is_cuda for v in on_card.values())
    monkeypatch.setenv("REPRO_TORCH_DEVICE", "cpu")
    on_cpu = run()
    assert torch.equal(on_card["vendor"].cpu(), on_cpu["vendor"])
    torch.testing.assert_close(on_card["tip_rate"].cpu(), on_cpu["tip_rate"],
                               rtol=1e-12, atol=0)
