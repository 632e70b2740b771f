"""The port's kernel layer (``repro_torch.kernels``) against the JAX
package's kernels on the same inputs.

On the CPU the port's dispatcher takes each kernel's plain PyTorch version
(the tensors lie on the CPU); the JAX side runs the Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` does.  Inputs are made with
numpy from a seed and handed to both packages.

Tolerances: ``filter_compact`` and ``zonemap`` on float32 inputs are exact
(values are moved or compared, never rounded); ``groupby_sum`` on float32
inputs is held at rtol 3e-4, atol 1e-3, because the Pallas kernel sums in
another block order.  Integer sums are exact.

The hand-written CUDA kernels themselves are held against the plain
versions on the card in ``test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")


from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.filter_compact import filter_compact as jax_filter_compact  # noqa: E402
from repro.kernels.groupby_sum import groupby_sum as jax_groupby_sum  # noqa: E402
from repro.kernels.zonemap import zonemap as jax_zonemap  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

CPU = ops.KernelConfig(impl="auto")


@pytest.fixture(autouse=True)
def torch_cpu(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_DEVICE", "cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# filter_compact


@pytest.mark.parametrize("n", [0, 1, 63, 512, 1537, 8192])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_filter_compact_matches_pallas(rng, n, p):
    vals = rng.normal(size=n).astype(np.float32)
    vals[::5] = np.nan
    mask = rng.random(n) < p
    got, cnt = ops.filter_compact(_t(vals), _t(mask), CPU)
    if n:
        want, wcnt = jax_filter_compact(jnp.asarray(vals), jnp.asarray(mask),
                                        block_rows=128, interpret=True)
    else:
        want, wcnt = jref.filter_compact_ref(jnp.asarray(vals), jnp.asarray(mask))
    assert int(cnt) == int(wcnt) == int(mask.sum())
    # exact, NaN placement included; slots past the count are zero
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.bool_, np.int8, np.int32, np.int64,
                                   np.float64])
def test_filter_compact_keeps_dtype_bytes(rng, dtype):
    # the port copies values in their own dtype: int64 beyond 2^24 and
    # float64 survive bit for bit (the Pallas kernel casts to f32)
    n = 1000
    vals = (rng.integers(-2**62, 2**62, n) if dtype == np.int64
            else rng.normal(size=n) * 1e6).astype(dtype)
    mask = rng.random(n) < 0.5
    got, cnt = ops.filter_compact(_t(vals), _t(mask), CPU)
    k = int(cnt)
    assert got.dtype == _t(vals).dtype
    np.testing.assert_array_equal(got.numpy()[:k], vals[mask])
    assert not got.numpy()[k:].any()


def test_filter_compact_table_one_mask(rng):
    n = 777
    cols = {"a": _t(rng.normal(size=n)), "b": _t(rng.integers(0, 9, n)),
            "c": _t(rng.random(n) < 0.5)}
    mask = _t(rng.random(n) < 0.3)
    out = ops.filter_compact_table(cols, mask, CPU)
    for k, v in cols.items():
        packed, cnt = ops.filter_compact(v, mask, CPU)
        assert torch.equal(out[k], packed[: int(cnt)])


def test_filter_compact_chunked_matches_whole(rng):
    vals = rng.normal(size=100_000).astype(np.float32)
    mask = rng.random(100_000) < 0.2
    got, cnt = ops.filter_compact_chunked(_t(vals), _t(mask), chunk=1 << 14,
                                          cfg=CPU)
    assert int(cnt) == int(mask.sum())
    np.testing.assert_array_equal(got.numpy()[: int(cnt)], vals[mask])


# ---------------------------------------------------------------------------
# groupby_sum


@pytest.mark.parametrize("n", [0, 17, 256, 1000, 4096])
@pytest.mark.parametrize("g", [1, 7, 100])
@pytest.mark.parametrize("vdim", [0, 5])
def test_groupby_sum_matches_pallas(rng, n, g, vdim):
    codes = rng.integers(-2, g + 2, n)            # out-of-range and negative
    shape = (n,) if vdim == 0 else (n, vdim)
    vals = rng.normal(size=shape).astype(np.float32)
    got = ops.groupby_sum(_t(codes), _t(vals), g, CPU)
    if n:
        want = jax_groupby_sum(jnp.asarray(codes.astype(np.int32)),
                               jnp.asarray(vals), g, block_rows=256,
                               interpret=True)
    else:
        want = jref.groupby_sum_ref(jnp.asarray(codes.astype(np.int32)),
                                    jnp.asarray(vals), g)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=1e-3)


def test_groupby_sum_out_of_range_codes():
    codes = _t(np.array([0, 5, 99, 2, -1, 5], np.int64))
    got = ops.groupby_sum(codes, torch.ones(6, dtype=torch.float32), 6, CPU)
    want = np.asarray(jax_groupby_sum(
        jnp.asarray(np.array([0, 5, 99, 2, -1, 5], np.int32)),
        jnp.ones(6, jnp.float32), 6, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got.sum()) == 4.0 and float(got[5]) == 2.0


def test_groupby_sum_int64_exact_and_count(rng):
    # int64 sums are exact and counts come out of the same pass as int64
    codes = _t(rng.integers(0, 9, 5000))
    vals = _t(rng.integers(2**40, 2**41, 5000))
    s, c = ops.groupby_sum_count(codes, vals, 9, cfg=CPU)
    cn, vn = codes.numpy(), vals.numpy()
    assert s.dtype == torch.int64 and c.dtype == torch.int64
    np.testing.assert_array_equal(
        s.numpy(), [vn[cn == g].sum() for g in range(9)])
    np.testing.assert_array_equal(c.numpy(), np.bincount(cn, minlength=9))
    s2, c2 = ops.groupby_sum_count(codes, None, 9, cfg=CPU)
    assert s2 is None and torch.equal(c2, c)


# ---------------------------------------------------------------------------
# zonemap


@pytest.mark.parametrize("n,block", [(1, 64), (63, 64), (100, 64),
                                     (4096, 512), (4097, 64), (10000, 1024)])
def test_zonemap_matches_pallas(rng, n, block):
    vals = rng.normal(size=n).astype(np.float32)
    mn, mx = ops.zonemap(_t(vals), block, CPU)
    jmn, jmx = jax_zonemap(jnp.asarray(vals), block_rows=block, interpret=True)
    np.testing.assert_array_equal(mn.numpy(), np.asarray(jmn))
    np.testing.assert_array_equal(mx.numpy(), np.asarray(jmx))


def test_zonemap_empty_contract():
    mn, mx = ops.zonemap(torch.zeros(0, dtype=torch.float32), 64, CPU)
    assert mn.shape == mx.shape == (0,)


def test_zonemap_own_dtype_and_nan(rng):
    # integer bounds beyond 2^24 stay exact in the port (the Pallas kernel's
    # f32 cast rounds them); a block holding a NaN reports NaN, like numpy
    ints = rng.integers(2**40, 2**41, 300)
    mn, mx = ops.zonemap(_t(ints), 128, CPU)
    assert mn.dtype == torch.int64
    np.testing.assert_array_equal(
        mn.numpy(), [ints[i:i + 128].min() for i in range(0, 300, 128)])
    np.testing.assert_array_equal(
        mx.numpy(), [ints[i:i + 128].max() for i in range(0, 300, 128)])
    f = rng.normal(size=300)
    f[200] = np.nan
    mn, mx = ops.zonemap(_t(f), 128, CPU)
    assert np.isnan(mn.numpy()[1]) and np.isnan(mx.numpy()[1])
    assert mn.numpy()[0] == f[:128].min()


# ---------------------------------------------------------------------------
# dispatch by tensor device


def test_kernel_config_dispatch_by_device():
    x = torch.ones(3)
    assert ops.KernelConfig("auto").use_kernel(x) is False
    assert ops.KernelConfig("torch").use_kernel(x) is False
    with pytest.raises(ValueError, match="cuda"):
        ops.KernelConfig("cuda").use_kernel(x)
    with pytest.raises(ValueError):
        ops.KernelConfig("pallas")


def test_cuda_impl_raises_for_cpu_tensors():
    cfg = ops.KernelConfig(impl="cuda")
    with pytest.raises(ValueError):
        ops.filter_compact(torch.ones(4), torch.ones(4, dtype=torch.bool), cfg)
    with pytest.raises(ValueError):
        ops.groupby_sum(torch.zeros(4, dtype=torch.int64), torch.ones(4), 1, cfg)
    with pytest.raises(ValueError):
        ops.zonemap(torch.ones(4), 2, cfg)


def test_wrappers_refuse_cpu_tensors():
    # the CUDA wrappers never take the plain path: a CPU tensor raises
    from repro_torch.kernels import filter_compact, groupby_sum, zonemap
    with pytest.raises(ValueError):
        filter_compact.filter_compact(torch.ones(4),
                                      torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        groupby_sum.groupby_sum_count(torch.zeros(4, dtype=torch.int64),
                                      torch.ones(4), 1)
    with pytest.raises(ValueError):
        zonemap.zonemap(torch.ones(4), 2)
