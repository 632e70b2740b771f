"""The port's physical layer and expressions (``repro_torch.core``) against
the JAX package's on the same numpy inputs, on the CPU.

The JAX package's operators run on its host (numpy) path, which computes in
float64 like the port; its eager (jnp) path truncates to 32 bits without
x64, a property of the reference that these tests exclude by comparing
with the host path.  Where the port follows real pandas and the reference
does not (int64 group sums, float64 median), the test says so and checks
numpy/pandas semantics.  Floats agree to rtol 1e-12 unless a test states
otherwise; row orders, integers and dtypes exactly.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core.expr as JE  # noqa: E402
import repro.core.physical as JX  # noqa: E402
import repro_torch.core.expr as TE  # noqa: E402
import repro_torch.core.physical as TX  # noqa: E402
from repro_torch.core.physical import table as T  # noqa: E402


@pytest.fixture(autouse=True)
def torch_cpu(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_DEVICE", "cpu")


def _tt(table):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in table.items()}


def _table(rng, n=2000):
    return {
        "f": rng.normal(size=n) * 10,
        "g": rng.uniform(-5, 100, n).astype(np.float32),
        "i": rng.integers(-50, 50, n).astype(np.int64),
        "j": rng.integers(1, 7, n).astype(np.int32),
        "k": rng.integers(0, 4, n).astype(np.int32),
        "ts": rng.integers(-2_000_000_000, 2_000_000_000, n).astype(np.int64),
    }


def _exprs(mod):
    C, L, B = mod.Col, mod.Lit, mod.BinOp
    return {
        "int/int": B("truediv", C("i"), C("j")),
        "int*float": B("mul", C("i"), L(1.5)),
        "int+int": B("add", C("i"), L(3)),
        "f32*float": B("mul", C("g"), L(2.0)),
        "f32+int64": B("add", C("g"), C("i")),
        "int32-int64": B("sub", C("j"), C("i")),
        "floordiv neg": B("floordiv", C("i"), L(7)),
        "mod neg": B("mod", C("i"), L(7)),
        "float floordiv": B("floordiv", C("f"), L(3)),
        "cmp": B("and", B("gt", C("f"), L(0)), B("le", C("i"), L(10))),
        "or": B("or", B("lt", C("g"), L(10.0)), B("eq", C("k"), L(2))),
        "not": mod.Not(B("ne", C("k"), L(1))),
        "isin": mod.IsIn(C("k"), (0, 3)),
        "cast": mod.Cast(C("f"), "int32"),
        "clip": mod.Clip(C("f"), 0, 5),
        "round": mod.Round(C("f"), 2),
        "round0": mod.Round(C("g"), 0),
        **{f"dt.{fld}": mod.DtField(C("ts"), fld)
           for fld in ("dayofweek", "hour", "minute", "second", "day",
                       "month", "year", "quarter")},
    }


@pytest.mark.parametrize("name", sorted(_exprs(JE)))
def test_expr_matches_reference_dtype_and_values(rng, name):
    # numpy's result dtypes, not torch's (torch would make int/int and
    # int*float float32), and floor semantics on negative operands
    table = _table(rng)
    want = _exprs(JE)[name].evaluate(table)
    got = _exprs(TE)[name].evaluate(_tt(table))
    assert got.numpy().dtype == np.asarray(want).dtype, name
    np.testing.assert_array_equal(got.numpy(), want)


def test_udf_sees_numpy_and_returns_to_device(rng):
    seen = []

    def fn(a):
        seen.append(type(a))
        return np.sqrt(np.abs(a))

    table = _tt(_table(rng))
    out = TE.UDF(fn, (TE.Col("f"),)).evaluate(table)
    assert seen == [np.ndarray]
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), np.sqrt(np.abs(table["f"].numpy())))


# ---------------------------------------------------------------------------
# table protocol helpers


def test_lexsort_and_first_index_match_numpy(rng):
    a = rng.integers(0, 5, 500)
    b = rng.integers(0, 3, 500)
    np.testing.assert_array_equal(
        T.lexsort([torch.from_numpy(a), torch.from_numpy(b)]).numpy(),
        np.lexsort((a, b)))
    np.testing.assert_array_equal(
        T.unique_first_index(torch.from_numpy(a * 3 + b)).numpy(),
        np.unique(a * 3 + b, return_index=True)[1])


def test_dtype_helpers():
    for name in ("bool", "int8", "uint8", "int16", "int32", "int64",
                 "float32", "float64"):
        td = T.torch_dtype(name)
        assert T.numpy_dtype(td) == np.dtype(name)
        assert T.dtype_kind(torch.zeros(1, dtype=td)) == np.dtype(name).kind


def test_to_torch_roundtrip_keeps_dtypes(rng):
    table = _table(rng, 50)
    back = T.to_numpy(T.to_torch(table))
    for k in table:
        assert back[k].dtype == table[k].dtype
        np.testing.assert_array_equal(back[k], table[k])
    assert T.table_nbytes(T.to_torch(table)) == sum(v.nbytes for v in table.values())


def test_default_device_rule(monkeypatch):
    assert T.default_device() == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the cuda default works")
    monkeypatch.setenv("REPRO_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="REPRO_TORCH_DEVICE"):
        T.default_device()
    monkeypatch.delenv("REPRO_TORCH_DEVICE")
    with pytest.raises(RuntimeError, match="REPRO_TORCH_DEVICE"):
        T.to_torch({"a": np.zeros(3)})


# ---------------------------------------------------------------------------
# operators


def _same_table(got, want, rtol=1e-12):
    got = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
           for k, v in got.items()}
    assert list(got) == list(want)
    for k in want:
        w = np.asarray(want[k])
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[k], w, rtol=rtol, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("keys", [["k"], ["k", "j"]])
def test_groupby_agg_matches_reference_host_path(rng, keys):
    table = _table(rng)
    aggs = {"s": ("f", "sum"), "m": ("g", "mean"), "c": ("f", "count"),
            "lo": ("f", "min"), "hi": ("g", "max"), "u": ("j", "nunique"),
            "si": ("i", "sum")}
    got = TX.apply_groupby_agg(_tt(table), keys, aggs)
    want = JX.apply_groupby_agg(table, keys, aggs)
    # the reference's host path returns integer sums as float64; the port
    # keeps them int64 as pandas does, and its float32 mean stays float32
    assert got["si"].dtype == torch.int64 and got["c"].dtype == torch.int64
    assert got["m"].dtype == torch.float32
    want = dict(want, si=np.asarray(want["si"]).astype(np.int64))
    _same_table({k: got[k] for k in want}, want, rtol=1e-5)


def test_groupby_mean_and_count_match_pandas(rng):
    pd = pytest.importorskip("pandas")
    table = _table(rng)
    got = TX.apply_groupby_agg(_tt(table), ["k"], {"m": ("f", "mean"),
                                                   "c": ("f", "count")})
    want = pd.DataFrame(table).groupby("k")["f"].agg(["mean", "count"])
    np.testing.assert_allclose(got["m"].numpy(), want["mean"].to_numpy(), rtol=1e-12)
    np.testing.assert_array_equal(got["c"].numpy(), want["count"].to_numpy())


@pytest.mark.parametrize("fn", ["sum", "mean", "min", "max", "nunique",
                                "count", "median"])
@pytest.mark.parametrize("col", ["f", "g", "i"])
def test_reduce_matches_numpy(rng, fn, col):
    # mean and median in float64 as pandas does (the reference's jnp path
    # uses float32); median of an even count averages the middle pair
    table = _table(rng, 1000)
    got = TX.apply_reduce(_tt(table), col, fn)
    want = JX.apply_reduce(table, col, fn)
    got = got.item() if isinstance(got, torch.Tensor) else got
    if fn in ("mean", "median"):
        ref = np.median(table[col].astype(np.float64)) if fn == "median" \
            else table[col].astype(np.float64).mean()
        np.testing.assert_allclose(got, ref, rtol=1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-6 if col == "g" else 1e-12)


@pytest.mark.parametrize("by", [["k"], ["k", "f"], ["j", "i"]])
@pytest.mark.parametrize("ascending", [True, False])
def test_sort_matches_reference_row_order(rng, by, ascending):
    table = _table(rng, 500)
    _same_table(TX.apply_sort(_tt(table), by, ascending),
                JX.apply_sort(table, by, ascending))


@pytest.mark.parametrize("mode,ascending", [("select", False), ("select", True),
                                            ("sort", False), ("sort", True)])
def test_top_k_matches_reference(rng, mode, ascending):
    table = _table(rng, 500)
    table["f"][::9] = np.nan
    _same_table(TX.apply_top_k(_tt(table), ["f"], 17, ascending, mode),
                JX.apply_top_k(table, ["f"], 17, ascending, mode))


@pytest.mark.parametrize("subset", [None, ("k",), ("k", "j")])
def test_drop_duplicates_matches_reference(rng, subset):
    table = _table(rng, 300)
    table = {k: v for k, v in table.items() if k in ("k", "j", "i")}
    _same_table(TX.apply_drop_duplicates(_tt(table), subset),
                JX.apply_drop_duplicates(table, subset))


@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_matches_reference(rng, how):
    left = {"k": rng.integers(0, 6, 200).astype(np.int64),
            "x": rng.normal(size=200)}
    right = {"k": np.arange(4, dtype=np.int64), "y": rng.normal(size=4)}
    got = TX.apply_join(_tt(left), _tt(right), ["k"], how)
    assert all(isinstance(v, torch.Tensor) for v in got.values())
    _same_table(got, JX.apply_join(left, right, ["k"], how))


def test_filter_and_fused_chain_match_unfused(rng):
    from repro_torch.core import graph as G
    table = _tt(_table(rng))
    pred = TE.BinOp("gt", TE.Col("f"), TE.Lit(0.0))
    expr = TE.BinOp("truediv", TE.Col("i"), TE.Col("j"))
    src = G.Materialized({"a": np.zeros(1)}, ("m",))
    ops = (G.Filter(src, pred), G.Assign(src, "r", expr),
           G.FillNa(src, 0.0), G.Project(src, ["r", "k", "f"]))
    fused = TX.apply_fused_rowwise(table, ops)
    step = TX.apply_filter(table, pred)
    step = TX.apply_assign(step, "r", expr)
    step = TX.apply_fillna(step, 0.0)
    step = TX.apply_project(step, ["r", "k", "f"])
    assert list(fused) == list(step) == ["r", "k", "f"]
    for k in step:
        assert torch.equal(fused[k], step[k])


def test_source_zone_maps_match_reference(rng):
    from repro.core.source import InMemorySource as JaxSource
    from repro_torch.core.source import InMemorySource as TorchSource
    table = _table(rng, 5000)
    table["f"][1234] = np.nan
    j = JaxSource(table, 1024)
    t = TorchSource(table, 1024)
    for i in range(j.n_partitions):
        jm, tm = j.partition_meta(i), t.partition_meta(i)
        assert jm["rows"] == tm["rows"]
        assert set(jm["zonemap"]) == set(tm["zonemap"])
        for c, (lo, hi) in jm["zonemap"].items():
            np.testing.assert_array_equal([lo, hi], tm["zonemap"][c])
