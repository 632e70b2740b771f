"""The port's main path, end to end on the CPU: every
``benchmarks/api_corpus.py`` program through ``repro_torch.pandas`` on the
eager engine, held against real pandas and against the JAX package's eager
engine on the same inputs; fusion and plan-cache invariance; the port's
isolation from the JAX package; the device rule; and the data (in-memory
column dicts, NPZ directories with their stats sidecar) carried across.

Tolerances: against real pandas, floats agree to rtol 1e-12 (the port
computes in float64, as pandas does; only the summation order differs).
Against the JAX eager engine, rtol 1e-5: that engine computes in float32
(no x64).  The corpus inputs keep every integer inside int32 (pickup epoch
seconds stay below 2^31), so the JAX engine's 32-bit truncation of int64
columns does not change them.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("pandas")
pytest.importorskip("jax")

import repro.pandas as jpd  # noqa: E402
import repro_torch.pandas as tpd  # noqa: E402
from benchmarks.api_corpus import CORPUS  # noqa: E402
from test_conformance import (_REFS, _assert_bit_identical,  # noqa: E402
                              _canon_actual, _ground_truth,
                              assert_frame_matches)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def torch_session(monkeypatch):
    """A fresh ``repro_torch`` session on the CPU for every test."""
    monkeypatch.setenv("REPRO_TORCH_DEVICE", "cpu")
    from repro_torch.core.context import LaFPContext, pop_session, push_session
    from repro_torch.core.planner.plancache import default_plan_cache
    default_plan_cache().clear()
    ctx = push_session(LaFPContext(name="torch-test"))
    ctx.print_fn = lambda *a: None
    yield ctx
    pop_session()


def _canon(obj):
    """A port output in the canonical form of ``test_conformance``: frames
    become dicts of host arrays with vocab columns decoded to strings."""
    from repro_torch.core.lazyframe import Result
    if isinstance(obj, Result):
        out = {}
        for k, v in obj.columns.items():
            arr = v.cpu().numpy()
            out[k] = (np.asarray([obj.vocab[k][int(c)] for c in arr], dtype=object)
                      if k in obj.vocab else arr)
        return out
    if isinstance(obj, tuple):
        return tuple(_canon(x) for x in obj)
    if isinstance(obj, torch.Tensor):
        return obj.cpu().numpy()[()]
    return obj


def _run(pd, prog, **session):
    with pd.session(engine="eager", name="t", **session) as ctx:
        ctx.print_fn = lambda *a: None
        out = prog(pd, np.random.default_rng(0))
    return _canon(out) if pd is tpd else _canon_actual(out)


def _sorted(cols, by):
    if not by:
        return cols
    keys = [cols[b].astype(str) if cols[b].dtype == object else cols[b]
            for b in reversed(by)]
    idx = np.lexsort(keys)
    return {k: v[idx] for k, v in cols.items()}


def _assert_close(a, b, rtol, sort_by=None):
    """Canonical facade outputs agree: same columns and dtype kinds, floats
    to ``rtol``, everything else exactly."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_close(x, y, rtol, sort_by)
        return
    if not isinstance(a, dict):
        np.testing.assert_allclose(np.float64(a), np.float64(b), rtol=rtol)
        return
    assert set(a) == set(b)
    a, b = _sorted(a, sort_by), _sorted(b, sort_by)
    for k in a:
        kinds = {x.dtype.kind.replace("u", "i") for x in (a[k], b[k])}
        assert len(kinds) == 1, (k, a[k].dtype, b[k].dtype)
        if a[k].dtype.kind == "f":
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name,prog", CORPUS, ids=[n for n, _ in CORPUS])
def test_corpus_matches_pandas(name, prog):
    actual = _run(tpd, prog)
    _, opts = _REFS[name]
    assert_frame_matches(actual, _ground_truth(name), rtol=1e-12, atol=1e-12,
                         **opts)


@pytest.mark.parametrize("name,prog", CORPUS, ids=[n for n, _ in CORPUS])
def test_corpus_matches_jax_eager(name, prog):
    port, ref = _run(tpd, prog), _run(jpd, prog)
    _assert_close(port, ref, rtol=1e-5, sort_by=_REFS[name][1].get("sort_by"))


@pytest.mark.parametrize("name,prog", CORPUS, ids=[n for n, _ in CORPUS])
def test_corpus_fusion_bit_identical(name, prog):
    _assert_bit_identical(_run(tpd, prog, fusion=True),
                          _run(tpd, prog, fusion=False))


@pytest.mark.parametrize("name,prog", CORPUS, ids=[n for n, _ in CORPUS])
def test_corpus_plan_cache_bit_identical(name, prog):
    from repro_torch.core.planner.plancache import default_plan_cache
    default_plan_cache().clear()
    cold = _run(tpd, prog, plan_cache=False)
    with tpd.session(engine="eager", name="warm") as ctx:
        ctx.print_fn = lambda *a: None
        prog(tpd, np.random.default_rng(0))
        warm = _canon(prog(tpd, np.random.default_rng(0)))
        snap = ctx.metrics.snapshot()
        classified = (snap.get("plan_cache.hits", 0)
                      + snap.get("plan_cache.misses", 0)
                      + snap.get("plan_cache.uncacheable", 0))
        assert classified == ctx.exec_count
    _assert_bit_identical(warm, cold)


def test_filter_groupby_result_is_float64_tensors():
    prog = dict(CORPUS)["filter_groupby"]
    with tpd.session(engine="eager", name="f64"):
        res = prog(tpd, np.random.default_rng(0))
    assert all(isinstance(v, torch.Tensor) for v in res.columns.values())
    assert res["tip_rate"].dtype == torch.float64
    assert res["vendor"].dtype == torch.int32


def test_pushed_down_filter_runs_after_upload():
    # the eager engine evaluates a scan's pushed-down predicate on the
    # device table (one compaction), with the same io.* accounting
    prog = dict(CORPUS)["filter_groupby"]
    with tpd.session(engine="eager", name="pd") as ctx:
        prog(tpd, np.random.default_rng(0))
        snap = ctx.metrics.snapshot()
    fare = np.random.default_rng(0).uniform(-5, 100, 4000)
    assert snap["io.pushdown_rows_in"] == 4000
    assert snap["io.pushdown_rows_out"] == int((fare > 0).sum())


# ---------------------------------------------------------------------------
# isolation from the JAX package


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import repro_torch.pandas as pd\n"
        "from benchmarks.api_corpus import filter_groupby\n"
        "res = filter_groupby(pd, np.random.default_rng(0))\n"
        "assert res.rows() == 3\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, REPRO_TORCH_DEVICE="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)",
                        re.MULTILINE)


def test_no_jax_or_repro_imports_in_port_sources():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 40
    offenders = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
                 for p in files for m in _FORBIDDEN.finditer(p.read_text())]
    assert not offenders, offenders


# ---------------------------------------------------------------------------
# the device rule


def test_cuda_default_without_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    monkeypatch.delenv("REPRO_TORCH_DEVICE", raising=False)
    df = tpd.DataFrame({"a": np.arange(10.0), "b": np.arange(10) % 3})
    df = df[df["a"] > 2]
    with pytest.raises(RuntimeError, match="REPRO_TORCH_DEVICE"):
        df.groupby("b")["a"].mean().compute()


# ---------------------------------------------------------------------------
# the data carried across: the same numpy column dicts, and NPZ directories
# written by the JAX package (sidecar included), open unchanged in the port


def _taxi_arrays(rng, n=3000):
    return {
        "fare": rng.uniform(-5, 100, n),
        "tip": rng.uniform(0, 20, n),
        "vendor": rng.integers(0, 3, n).astype(np.int32),
        "pickup": (1_577_836_800 + rng.integers(0, 366 * 86400, n)).astype(np.int64),
        "passengers": rng.integers(1, 7, n).astype(np.int64),
    }


_DICTS = {"vendor": ["acme", "beta", "cabco"]}


def _pipeline(df):
    df = df[df["fare"] > 40.0]
    return _canon(df.groupby("vendor")
                  .agg({"m": ("tip", "mean"), "n": ("fare", "count"),
                        "p": ("passengers", "sum")})
                  .compute())


def test_in_memory_source_takes_the_same_state(rng):
    from repro.core.source import InMemorySource as JaxSource
    from repro_torch.core.source import InMemorySource as TorchSource
    arrays = _taxi_arrays(rng)
    j = JaxSource(arrays, 512, _DICTS, ("pickup",), "taxi")
    t = TorchSource(arrays, 512, _DICTS, ("pickup",), "taxi")
    assert t.n_partitions == j.n_partitions
    assert t.schema.names == j.schema.names
    assert [c.dtype for c in t.schema.columns] == [c.dtype for c in j.schema.columns]
    assert t.dicts == j.dicts
    for i in range(j.n_partitions):
        assert t.partition_meta(i) == j.partition_meta(i)
    assert t.cache_token() == j.cache_token()


def test_npz_directory_from_jax_package_opens_in_port(rng, tmp_path):
    from repro.core.source import write_npz_source
    arrays = _taxi_arrays(rng)
    jsrc = write_npz_source(str(tmp_path / "taxi"), arrays, 512, dicts=_DICTS,
                            datetimes=("pickup",))
    assert (tmp_path / "taxi" / "_stats.json").exists()
    disk = _pipeline(tpd.read_npz(str(tmp_path / "taxi")))
    mem = _pipeline(tpd.from_arrays(arrays, 512, dicts=_DICTS,
                                    datetimes=("pickup",)))
    _assert_bit_identical(disk, mem)
    from repro_torch.core.source import NpzDirectorySource
    tsrc = NpzDirectorySource(str(tmp_path / "taxi"))
    assert tsrc.dicts == jsrc.dicts
    for i in range(jsrc.n_partitions):
        assert tsrc.partition_meta(i) == jsrc.partition_meta(i)


def test_npz_sidecar_restores_stats_in_port(rng, tmp_path):
    # a _meta.json stripped of stats: the port restores rows and zone maps
    # from the JAX package's _stats.json sidecar without rescanning data
    import json
    from repro.core.source import write_npz_source
    from repro_torch.core.source import NpzDirectorySource
    path = tmp_path / "taxi"
    jsrc = write_npz_source(str(path), _taxi_arrays(rng), 512, dicts=_DICTS)
    meta = json.loads((path / "_meta.json").read_text())
    for p in meta["partitions"]:
        del p["zonemap"]
    (path / "_meta.json").write_text(json.dumps(meta))
    tsrc = NpzDirectorySource(str(path))
    for i in range(jsrc.n_partitions):
        assert tsrc.partition_meta(i) == jsrc.partition_meta(i)


@pytest.mark.parametrize("rewrites", (True, False), ids=("rewrites", "no-rewrites"))
def test_zone_map_prune_spares_a_shared_scan(rewrites):
    # concat([df, df.head(20)]) filtered: the rewrite pushes the filter into
    # both branches, which share one scan.  Pruning that scan's partitions
    # for the bare branch must not change the rows head(20) sees (the JAX
    # package prunes it and returns the row at index 40 twice).
    pd_real = pytest.importorskip("pandas")
    b = np.zeros(64)
    b[40] = 3.0
    data = {"a": np.arange(64), "b": b}
    with tpd.session(engine="eager", rewrites=rewrites, name="shared"):
        df = tpd.from_arrays(data, partition_rows=32)
        cat = tpd.concat([df, df.head(20)])
        got = _canon(cat[cat["b"] > 2].compute())
    ref = pd_real.DataFrame(data)
    ref = pd_real.concat([ref, ref.head(20)])
    want = ref[ref["b"] > 2]
    np.testing.assert_array_equal(got["a"], want["a"].to_numpy())
    np.testing.assert_array_equal(got["b"], want["b"].to_numpy())
