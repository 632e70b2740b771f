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


def _same_zonemap(x, block):
    mn, mx = ops.zonemap(x, block, CUDA)
    rmn, rmx = ref.zonemap_ref(x, block)
    assert torch.equal(mn.view(torch.uint8), rmn.view(torch.uint8))
    assert torch.equal(mx.view(torch.uint8), rmx.view(torch.uint8))


def test_zonemap_one_block_over_12_7m_rows(rng, card):
    # one block covering a whole column: its pieces spread over every SM
    x = _t(rng.uniform(-5, 100, 12_700_000), card)
    _same_zonemap(x, x.shape[0])
    _same_zonemap(x, 1 << 16)


_ZM_DTYPES = [np.float32, np.float64, np.int8, np.uint8, np.int16, np.int32,
              np.int64]


@pytest.mark.parametrize("dtype", _ZM_DTYPES)
@pytest.mark.parametrize("edge", ["below", "equal", "ragged"])
def test_zonemap_block_rows_around_load_chunk(rng, card, dtype, edge):
    # the chunk is one thread block's round of 16-byte loads
    from repro_torch.kernels.zonemap import MIN_PIECE_BYTES
    es = np.dtype(dtype).itemsize
    chunk = MIN_PIECE_BYTES // es
    block = {"below": chunk - 1, "equal": chunk, "ragged": 3 * chunk + 5}[edge]
    x = _t((rng.normal(size=200_003) * 100).astype(dtype), card)
    _same_zonemap(x, block)


@pytest.mark.parametrize("dtype", _ZM_DTYPES)
@pytest.mark.parametrize("lead", [1, 3])
def test_zonemap_unaligned_views(rng, card, dtype, lead):
    x = _t((rng.normal(size=100_003) * 100).astype(dtype), card)[lead:]
    for block in (4096, 30_001, x.shape[0]):
        _same_zonemap(x, block)


def test_zonemap_nan_in_one_piece(rng, card):
    vals = rng.normal(size=1_000_000)
    vals[123_457] = np.nan                 # one piece of the first block
    x = _t(vals, card)
    _same_zonemap(x, 500_000)
    mn, mx = ops.zonemap(x, 500_000, CUDA)
    assert torch.isnan(mn[0]) and torch.isnan(mx[0])
    assert not torch.isnan(mn[1]) and not torch.isnan(mx[1])


def test_zonemap_int64_extremes(rng, card):
    vals = rng.integers(-2**40, 2**40, 300_000)
    vals[10], vals[150_001], vals[299_999] = 2**63 - 1, -(2**63 - 1), -2**63
    x = _t(vals, card)
    _same_zonemap(x, 150_000)
    mn, mx = ops.zonemap(x, 150_000, CUDA)
    assert mx.tolist() == [2**63 - 1, vals[150_000:].max()]
    assert mn.tolist() == [vals[:150_000].min(), -2**63]
    _same_zonemap(torch.full((70_000,), 2**63 - 1, device=card), 65_536)


def _fc_cols(rng, n, dev):
    vals = rng.normal(size=n)
    vals[::7] = np.nan
    return {"f": _t(vals, dev), "g": _t(vals.astype(np.float32), dev),
            "i": _t(rng.integers(-2**62, 2**62, n), dev),
            "w": _t(rng.integers(-2**31, 2**31, n).astype(np.int32), dev),
            "s": _t(rng.integers(-2**15, 2**15, n).astype(np.int16), dev),
            "b": _t(rng.random(n) < 0.5, dev)}


def _same_compaction(cols, mask):
    got = ops.filter_compact_table(cols, mask, CUDA)
    want = ref.filter_compact_table_ref(cols, mask)
    for k in cols:
        assert torch.equal(got[k].view(torch.uint8), want[k].view(torch.uint8)), k
    for k in ("f", "w", "s", "b"):
        p, c = ops.filter_compact(cols[k], mask, CUDA)
        rp, rc = ref.filter_compact_ref(cols[k], mask)
        assert int(c) == int(rc)
        assert torch.equal(p.view(torch.uint8), rp.view(torch.uint8)), k


_TILE = 4096          # fc_tile_rows(): 8 warps x 32 lanes x 16 mask bytes


@pytest.mark.parametrize("n", [15, 16, 17, 511, 512, 513, _TILE - 1, _TILE,
                               _TILE + 1, 2 * _TILE - 1, 2 * _TILE + 1])
@pytest.mark.parametrize("kind", ["random", "none", "all", "straddle"])
def test_filter_compact_around_tile_and_vector_widths(rng, card, n, kind):
    cols = _fc_cols(rng, n, card)
    r = np.arange(n) % _TILE
    mask = {"random": rng.random(n) < 0.4, "none": np.zeros(n, bool),
            "all": np.ones(n, bool),
            # survivors only on either side of each tile boundary
            "straddle": (r < 5) | (r >= _TILE - 5)}[kind]
    _same_compaction(cols, _t(mask, card))


@pytest.mark.parametrize("lead", [1, 3])
def test_filter_compact_unaligned_views(rng, card, lead):
    n = 100_003 + lead
    cols = {k: v[lead:] for k, v in _fc_cols(rng, n, card).items()}
    mask = _t(rng.random(n) < 0.6, card)[lead:]
    _same_compaction(cols, mask)


@pytest.mark.parametrize("chunk", [1 << 14, 1001])
def test_filter_compact_chunked_matches_plain(rng, card, chunk):
    # chunk 1001 starts every chunk's mask off a 16-byte boundary
    vals = _t(rng.normal(size=100_003), card)
    mask = _t(rng.random(100_003) < 0.3, card)
    p, c = ops.filter_compact_chunked(vals, mask, chunk=chunk, cfg=CUDA)
    rp, rc = ref.filter_compact_ref(vals, mask)
    assert int(c) == int(rc)
    assert torch.equal(p.view(torch.uint8), rp.view(torch.uint8))


def test_filter_compact_tile_size_matches_library(card):
    from repro_torch.kernels import _build
    assert _build.lib().fc_tile_rows() == _TILE


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
