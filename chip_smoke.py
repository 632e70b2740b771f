#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Phases, each fatal on failure:

1. the card: name and power limit (``nvidia-smi``), torch's device name
   and the device count;
2. the build of the hand-written kernels (``src/repro_torch/kernels/csrc``);
3. each kernel held against its plain PyTorch version on the card, at the
   main path's shapes and on edge cases, with its own device time (the
   durations of its CUDA kernels, torch.profiler), what a call of its
   wrapper costs (CUDA events), its bound at 3.35 TB/s, the plain version's
   time and a library call's time (events and device), each the median of
   five windows with their spread;
4. the main path through ``repro_torch.pandas`` on the eager engine at
   NYC-taxi-month scale (12.7 M rows, about January 2015 of yellow-taxi
   trips): ``filter_groupby`` and a sum/count feature-engineering program,
   cold then warm, each result checked against numpy on the host, and every
   kernel's launch counter shown to move;
5. where the time goes: host seconds of the cold run's pieces and the
   card's busy share of a warm run (torch.profiler);
6. one JSON line with the kernels' numbers, then the JSON status line.

Exits non-zero, printing no result, when no CUDA device is present or when
run outside the repository.

    python3 chip_smoke.py [--seed 0] [--rows 12700000] [--parent-csrc DIR]

``--parent-csrc DIR`` (a directory holding an earlier commit's
``src/repro_torch/kernels/csrc/*.cu``, e.g. from ``git show``) adds a
phase that times that commit's zonemap and filter_compact against this
tree's in turns on the same card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM data sheet, float32 outside the tensor cores
PARTITION_ROWS = 1 << 16
REPEATS = 5                    # timing windows per figure (median, spread)
VENDORS = ["acme", "beta", "cabco"]
JAN_2015 = 1_420_070_400       # 2015-01-01T00:00:00Z


# ---------------------------------------------------------------------------
# helpers


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the card over ``iters`` runs: what a
    caller pays, host work and host syncs inside ``fn`` included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def median_spread(samples: list[float]) -> tuple[float, list[float]]:
    s = sorted(samples)
    mid = len(s) // 2
    med = s[mid] if len(s) % 2 else (s[mid - 1] + s[mid]) / 2
    return med, [s[0], s[-1]]


def call_ms(fn, iters: int = 20, repeats: int = REPEATS) -> tuple[float, list[float]]:
    """``cuda_ms`` repeated ``repeats`` times: (median, [min, max])."""
    return median_spread([cuda_ms(fn, iters, warmup=3 if r == 0 else 1)
                          for r in range(repeats)])


def device_us_by_name(prof) -> dict[str, float]:
    """Device microseconds by activity name in a torch.profiler run."""
    out: dict[str, float] = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            out[ev.key] = out.get(ev.key, 0.0) + us
    return out


def own_activity(name: str, prefixes: tuple[str, ...] | None) -> bool:
    """Whether a device activity counts: a kernel whose name (template
    kernels carry a leading ``void``) starts with one of ``prefixes``, or,
    with ``prefixes`` None, every kernel and memset (copies between host
    and card are not the function's work)."""
    if prefixes is None:
        return not name.startswith("Memcpy")
    return name.removeprefix("void ").startswith(prefixes)


def device_ms(fn, prefixes: tuple[str, ...] | None, calls: int = 20,
              repeats: int = REPEATS) -> tuple[float, list[float]]:
    """Device milliseconds per call of ``fn``: the durations of the device
    activities it launches (``own_activity``), summed with torch.profiler
    over a steady window of ``calls`` calls, divided by ``calls``; the
    window is taken ``repeats`` times, giving (median, [min, max]).  Host
    work and host syncs between launches are not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(v for k, v in device_us_by_name(prof).items()
                 if own_activity(k, prefixes))
        check(us > 0, f"torch.profiler saw no device time of {prefixes}")
        samples.append(us / 1e3 / calls)
    return median_spread(samples)


def timings(kernel, plain, library, prefixes: tuple[str, ...]) -> dict:
    """The timing keys of one kernel row: the kernel's own device time,
    what a caller pays for the wrapper, the plain version's and the library
    call's event times, and the library call's device time."""
    d, d_sp = device_ms(kernel, prefixes)
    c, c_sp = call_ms(kernel)
    p, _ = call_ms(plain, repeats=3)
    lib_c, _ = call_ms(library)
    lib_d, lib_d_sp = device_ms(library, None)
    return {"ms": d, "device_ms": d, "device_ms_spread": d_sp,
            "call_ms": c, "call_ms_spread": c_sp, "plain_ms": p,
            "library_ms": lib_c, "library_device_ms": lib_d,
            "library_device_ms_spread": lib_d_sp}


def bound(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_bits(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def max_abs_err(a, b) -> float:
    import torch
    if a.numel() == 0:
        return 0.0
    a64, b64 = a.double(), b.double()
    both_nan = torch.isnan(a64) & torch.isnan(b64)
    d = (a64 - b64).abs().masked_fill(both_nan, 0.0)
    return float(d.max())


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def make_taxi(rows: int, seed: int) -> dict:
    """One month of taxi-like trips, made from ``seed``."""
    rng = np.random.default_rng(seed)
    return {
        "fare": rng.uniform(-5, 100, rows),
        "tip": rng.uniform(0, 20, rows),
        "passengers": rng.integers(1, 7, rows).astype(np.int64),
        "vendor": rng.integers(0, 3, rows).astype(np.int32),
        "pickup": JAN_2015 + rng.integers(0, 31 * 86400, rows).astype(np.int64),
        "trip_miles": rng.uniform(0, 30, rows),
    }


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions


def fc_edge_case(FC, ref, g, dev, n, m, kind, lead) -> None:
    """filter_compact of every dtype under mask ``m`` (n rows), table form
    and one-column form, against the plain version; with ``lead`` > 0 the
    mask and columns are views ``x[lead:]`` of longer tensors."""
    import torch
    N = n + lead
    f = torch.randn(N, generator=g, device=dev, dtype=torch.float64)
    f[::7] = float("nan")
    cols = {"f64": f, "f32": f.float(),
            "i64": torch.randint(-2**62, 2**62, (N,), generator=g, device=dev),
            "i32": torch.randint(-2**31, 2**31 - 1, (N,), generator=g, device=dev,
                                 dtype=torch.int32),
            "i16": torch.randint(-2**15, 2**15 - 1, (N,), generator=g, device=dev,
                                 dtype=torch.int16),
            "b": torch.rand(N, generator=g, device=dev) < 0.5}
    for extra in range(14):
        cols[f"x{extra}"] = cols["i32"] + extra
    if lead:
        m = torch.cat([torch.ones(lead, dtype=torch.bool, device=dev), m])[lead:]
        cols = {c: v[lead:] for c, v in cols.items()}
    what = f"n={n} {kind} view x[{lead}:]"
    got_t = FC.filter_compact_table(cols, m)
    want_t = ref.filter_compact_table_ref(cols, m)
    for c in cols:
        check(same_bits(got_t[c], want_t[c]), f"filter_compact {what} {c}")
    for c in ("f64", "i64", "i32", "i16", "b"):
        p, k = FC.filter_compact(cols[c], m)
        rp, rk = ref.filter_compact_ref(cols[c], m)
        check(same_bits(p, rp) and int(k) == int(rk),
              f"filter_compact one-column {what} {c}")


def kernel_filter_compact(arrays, dev) -> dict:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import filter_compact as FC
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref

    # main path: the scan's output columns compacted under fare > 0
    table = {c: torch.from_numpy(arrays[c]).to(dev) for c in ("fare", "tip", "vendor")}
    mask = table["fare"] > 0
    got = FC.filter_compact_table(table, mask)
    want = ref.filter_compact_table_ref(table, mask)
    for c in table:
        check(same_bits(got[c], want[c]), f"filter_compact main path column {c}")
    err = max(max_abs_err(got[c], want[c]) for c in table)

    # edge cases: sizes one either side of a lane's 16 mask bytes, a warp's
    # 512 rows and the 4096-row tile; empty, all-false, all-true, survivors
    # only around tile boundaries; NaN; 1/2/4/8-byte dtypes; more columns
    # than one launch takes; views starting 1 and 3 rows in (unaligned)
    g = torch.Generator(device=dev).manual_seed(0)
    tile = _build.lib().fc_tile_rows()
    sizes = (0, 1, 15, 16, 17, 511, 512, 513, 2047, 2048, 2049, tile - 1, tile,
             tile + 1, 2 * tile - 1, 2 * tile + 1, 100_003)
    for n in sizes:
        for kind in ("random", "none", "all", "straddle"):
            if kind == "random":
                m = torch.rand(n, generator=g, device=dev) < 0.4
            elif kind == "straddle":
                r = torch.arange(n, device=dev) % tile
                m = (r < 5) | (r >= tile - 5)
            else:
                m = torch.full((n,), kind == "all", dtype=torch.bool, device=dev)
            for lead in ((0, 1, 3) if n in (tile + 1, 100_003) else (0,)):
                fc_edge_case(FC, ref, g, dev, n, m, kind, lead)
    # the two-level chunked form; chunks of 1001 rows start off 16 bytes
    v = torch.randn(100_003, generator=g, device=dev, dtype=torch.float64)
    m = torch.rand(100_003, generator=g, device=dev) < 0.3
    for chunk in (1 << 14, 1001):
        p, k = K.filter_compact_chunked(v, m, chunk=chunk)
        rp, rk = ref.filter_compact_ref(v, m)
        check(same_bits(p, rp) and int(k) == int(rk),
              f"filter_compact_chunked chunk={chunk}")

    n = mask.shape[0]
    k = int(mask.sum())
    es = sum(v.element_size() for v in table.values())
    t = timings(lambda: FC.filter_compact_table(table, mask),
                lambda: ref.filter_compact_table_ref(table, mask),
                lambda: [v[mask] for v in table.values()], ("fc_",))
    b_ms, b_by = bound(n + n * es + k * es)
    return {"name": "filter_compact", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/filter_compact.cu",
            "replaces": "src/repro/kernels/filter_compact.py:66",
            "max_abs_err": err, **t, "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"{n} rows x 3 cols (f64, f64, i32), {k} survivors"}


def kernel_groupby_sum(arrays, dev) -> dict:
    import torch
    from repro_torch.kernels import groupby_sum as GB
    from repro_torch.kernels import ref

    # main path: mean of tip_rate by vendor over the fare > 0 survivors
    fare = torch.from_numpy(arrays["fare"]).to(dev)
    keep = fare > 0
    codes = torch.from_numpy(arrays["vendor"]).to(dev)[keep].to(torch.int64)
    vals = (torch.from_numpy(arrays["tip"]).to(dev)[keep] / fare[keep]).contiguous()
    G = 3
    s, c = GB.groupby_sum_count(codes, vals, G)
    rs, rc = ref.groupby_sum_count_ref(codes, vals, G)
    check(torch.equal(c, rc), "groupby_sum main path counts")
    check(torch.allclose(s, rs, rtol=1e-9, atol=0), "groupby_sum main path sums (rtol 1e-9)")
    s2, c2 = GB.groupby_sum_count(codes, vals, G)
    check(same_bits(s, s2) and same_bits(c, c2), "groupby_sum run-to-run bits")
    err = max_abs_err(s, rs)

    g = torch.Generator(device=dev).manual_seed(1)
    # empty input, out-of-range and negative codes, (N, V) values in
    # float32 / float64 / int64, the sorted path for large G
    for en, eg in ((0, 3), (1, 1), (4097, 7), (100_003, 5), (100_003, 50_000)):
        cd = torch.randint(-2, eg + 2, (en,), generator=g, device=dev)
        for dt in (torch.float32, torch.float64, torch.int64):
            for V in (None, 4):
                shape = (en,) if V is None else (en, V)
                v = (torch.randint(-1000, 1000, shape, generator=g, device=dev).to(dt)
                     if dt == torch.int64
                     else torch.randn(shape, generator=g, device=dev, dtype=dt))
                ks, kc = GB.groupby_sum_count(cd, v, eg)
                rs_, rc_ = ref.groupby_sum_count_ref(cd, v, eg)
                check(torch.equal(kc, rc_), f"groupby_sum counts n={en} G={eg}")
                if dt == torch.int64:
                    ok = torch.equal(ks, rs_)
                elif dt == torch.float32:
                    ok = torch.allclose(ks, rs_, rtol=3e-4, atol=1e-3)
                else:
                    ok = torch.allclose(ks, rs_, rtol=1e-9, atol=1e-9)
                check(ok, f"groupby_sum sums n={en} G={eg} {dt} V={V}")
        ks, kc = GB.groupby_sum_count(cd, None, eg)
        check(ks is None and torch.equal(kc, ref.groupby_sum_count_ref(cd, None, eg)[1]),
              f"groupby_sum count-only n={en} G={eg}")
    # a count past 2^24 rows in one group stays exact (f32 ones would not)
    big = torch.zeros((1 << 25,), dtype=torch.int64, device=dev)
    _, kc = GB.groupby_sum_count(big, None, 1)
    check(int(kc[0]) == 1 << 25, f"groupby_sum count 2^25 rows: {int(kc[0])}")
    del big

    # the sorted path (G*V past the shared-memory slots) at the main
    # path's row count: groups of even size, and the three main-path
    # groups run through it (all rows in 3 of 50,000 groups: skew)
    sorted_ms = {}
    for label, cd, gg in (("uniform_G50000", torch.randint(0, 50_000, codes.shape,
                                                            generator=g, device=dev), 50_000),
                          ("skewed_G50000", codes, 50_000)):
        sorted_ms[label] = cuda_ms(lambda: GB.groupby_sum_count(cd, vals, gg), iters=5)
    print("groupby_sum_sorted_path " + json.dumps(
        {"rows": int(codes.shape[0]), "ms": sorted_ms}), flush=True)

    n = codes.shape[0]
    both = torch.stack([vals, torch.ones_like(vals)], dim=1)
    zeros = torch.zeros((G, 2), dtype=vals.dtype, device=dev)
    t = timings(lambda: GB.groupby_sum_count(codes, vals, G),
                lambda: ref.groupby_sum_count_ref(codes, vals, G),
                lambda: zeros.clone().index_add_(0, codes, both), ("gb_",))
    b_ms, b_by = bound(n * 8 + n * 8 + G * 8 + G * 8, ops=2 * n)
    return {"name": "groupby_sum", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/groupby_sum.cu",
            "replaces": "src/repro/kernels/groupby_sum.py:56",
            "max_abs_err": err, **t, "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"{n} rows, int64 codes, f64 values, G=3, sum+count"}


def zonemap_edge_cases(ZM, ref, g, dev, column) -> None:
    """zonemap against the plain version where its pieces and vectors have
    edges: one block over a whole main-path column; blocks smaller than,
    equal to and not a multiple of a thread block's 16-byte load chunk;
    a NaN in one piece only; int64 at +-(2**63-1); views x[1:], x[3:]."""
    import torch
    from repro_torch.kernels import _build

    lib = _build.lib()
    check(ZM.CTAS_PER_SM <= lib.zm_min_blocks()
          and lib.zm_threads() * 4 * 16 == ZM.MIN_PIECE_BYTES,
          "zonemap: plan_split's constants differ from csrc/zonemap.cu")

    def same(x, block, what):
        mn, mx = ZM.zonemap(x, block)
        rmn, rmx = ref.zonemap_ref(x, block)
        check(same_bits(mn, rmn) and same_bits(mx, rmx),
              f"zonemap {what} block_rows={block} n={x.shape[0]} {x.dtype}")

    same(column, column.shape[0], "one block over the column")
    same(column, 1_000_003, "13 blocks")
    n = 100_003
    cols = [torch.randn(n, generator=g, device=dev, dtype=torch.float64),
            torch.randn(n, generator=g, device=dev, dtype=torch.float32),
            torch.randint(-2**62, 2**62, (n,), generator=g, device=dev),
            torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=dev,
                          dtype=torch.int32),
            torch.randint(-2**15, 2**15 - 1, (n,), generator=g, device=dev,
                          dtype=torch.int16),
            torch.randint(-128, 127, (n,), generator=g, device=dev, dtype=torch.int8),
            torch.randint(0, 255, (n,), generator=g, device=dev, dtype=torch.uint8)]
    for x in cols:
        chunk = ZM.MIN_PIECE_BYTES // x.element_size()
        for block in (chunk - 1, chunk, 3 * chunk + 5, n):
            same(x, block, "chunk edges")
            for lead in (1, 3):
                same(x[lead:], block, f"view x[{lead}:]")
    f = torch.randn(1_000_000, generator=g, device=dev, dtype=torch.float64)
    f[123_457] = float("nan")                       # one piece of block 0
    same(f, 500_000, "NaN in one piece")
    mn, _ = ZM.zonemap(f, 500_000)
    check(bool(torch.isnan(mn[0])) and not bool(torch.isnan(mn[1])),
          "zonemap NaN in one piece: only its block is NaN")
    i = torch.randint(-2**40, 2**40, (300_000,), generator=g, device=dev)
    i[10], i[150_001], i[299_999] = 2**63 - 1, -(2**63 - 1), -2**63
    same(i, 150_000, "int64 extremes")
    same(torch.full((70_000,), 2**63 - 1, device=dev), 65_536, "int64 all max")


def kernel_zonemap(arrays, dev) -> tuple[dict, dict]:
    import torch
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref
    from repro_torch.kernels import zonemap as ZM

    # main path: every numeric column, one block per 65536-row partition
    err = 0.0
    for name, arr in arrays.items():
        x = torch.from_numpy(arr).to(dev)
        mn, mx = ZM.zonemap(x, PARTITION_ROWS)
        rmn, rmx = ref.zonemap_ref(x, PARTITION_ROWS)
        check(same_bits(mn, rmn) and same_bits(mx, rmx), f"zonemap main path {name}")
        err = max(err, max_abs_err(mn, rmn), max_abs_err(mx, rmx))

    g = torch.Generator(device=dev).manual_seed(2)
    for n in (1, 4095, 4096, 4097, 100_003):
        f = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
        if n > 4097:
            f[5000] = float("nan")              # one NaN block
        cols = [f, f.float(),
                torch.randint(2**62, 2**62 + 1000, (n,), generator=g, device=dev),
                torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=dev,
                              dtype=torch.int32),
                torch.randint(-2**15, 2**15 - 1, (n,), generator=g, device=dev,
                              dtype=torch.int16),
                torch.randint(-128, 127, (n,), generator=g, device=dev, dtype=torch.int8),
                torch.randint(0, 255, (n,), generator=g, device=dev, dtype=torch.uint8)]
        for x in cols:
            mn, mx = ZM.zonemap(x, 4096)
            rmn, rmx = ref.zonemap_ref(x, 4096)
            check(same_bits(mn, rmn) and same_bits(mx, rmx), f"zonemap n={n} {x.dtype}")
    e_mn, e_mx = K.zonemap(torch.empty((0,), device=dev))
    check(e_mn.shape == (0,) and e_mx.shape == (0,), "zonemap empty contract")
    zonemap_edge_cases(ZM, ref, g, dev, torch.from_numpy(arrays["fare"]).to(dev))

    arr = arrays["fare"]
    x = torch.from_numpy(arr).to(dev)
    n = x.shape[0]
    nb = -(-n // PARTITION_ROWS)
    padded = torch.cat([x, x[-1:].expand(nb * PARTITION_ROWS - n)]).view(nb, -1)
    t = timings(lambda: ZM.zonemap(x, PARTITION_ROWS),
                lambda: ref.zonemap_ref(x, PARTITION_ROWS),
                lambda: torch.aminmax(padded, dim=1), ("zm_",))
    b_ms, b_by = bound(n * 8 + 2 * nb * 8, ops=2 * n)
    host = torch.from_numpy(arr)
    upload_ms = cuda_ms(lambda: host.to(dev), iters=5, warmup=1)
    upload = {"zonemap_upload": {"column": "fare", "bytes": int(arr.nbytes),
                                 "ms": upload_ms,
                                 "kernel_device_ms": t["device_ms"]}}
    return ({"name": "zonemap", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/zonemap.cu",
             "replaces": "src/repro/kernels/zonemap.py:33",
             "max_abs_err": err, **t, "bound_ms": b_ms, "bound_by": b_by,
             "shape": f"{n} rows f64, blocks of {PARTITION_ROWS} ({nb} blocks)"},
            upload)


def compare_parent(parent_csrc: str, arrays, dev) -> None:
    """An earlier commit's zonemap and filter_compact (its ``.cu`` files in
    ``parent_csrc``, built into a scratch library) against this tree's,
    each held against the plain version and timed by device time in turns
    (old, new, new, old) at the main path's shapes; then this tree's
    zonemap at other depths of ``plan_split``.  The earlier sources must
    have the C interface of commit 8b0a8bf (a ``zm_minmax`` that takes no
    pieces)."""
    import ctypes
    from pathlib import Path

    import torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import filter_compact as FC
    from repro_torch.kernels import zonemap as ZM

    old = ctypes.CDLL(str(_build.build(Path(parent_csrc),
                                       _build.BUILD_DIR.parent / "parent_lib")))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, argtypes in (("zm_minmax", [I, P, L, L, P, P, P]),
                           ("fc_count", [P, L, P, P, P]),
                           ("fc_scatter_cols", [P, L, P, P, P, P, I, I, P]),
                           ("fc_tile_rows", []), ("fc_max_cols", [])):
        getattr(old, name).argtypes = argtypes
        getattr(old, name).restype = I

    def old_zonemap(x, block):
        nb = -(-x.shape[0] // block)
        out = torch.empty((2, nb), dtype=x.dtype, device=dev)
        _build.check(old.zm_minmax(ZM._DTYPE_CODE[x.dtype], x.data_ptr(), x.shape[0],
                                   block, out[0].data_ptr(), out[1].data_ptr(),
                                   _build.stream_of(x)), "parent zm_minmax")
        return out[0], out[1]

    def table_with(lib):
        def run(cols, mask):
            stream = _build.stream_of(mask)
            offsets, tiles = FC._offsets(lib, mask, stream)
            count = int(offsets[tiles].item())
            out = {k: torch.empty((count,), dtype=v.dtype, device=dev)
                   for k, v in cols.items()}
            FC._scatter(lib, mask, offsets, [(v, out[k]) for k, v in cols.items()],
                        0, stream)
            return out
        return run

    x = torch.from_numpy(arrays["fare"]).to(dev)
    table = {c: torch.from_numpy(arrays[c]).to(dev) for c in ("fare", "tip", "vendor")}
    mask = table["fare"] > 0
    cases = {
        "zonemap_194_blocks": (lambda: old_zonemap(x, PARTITION_ROWS),
                               lambda: ZM.zonemap(x, PARTITION_ROWS),
                               lambda: ref.zonemap_ref(x, PARTITION_ROWS), ("zm_",)),
        "zonemap_one_block": (lambda: old_zonemap(x, x.shape[0]),
                              lambda: ZM.zonemap(x, x.shape[0]),
                              lambda: ref.zonemap_ref(x, x.shape[0]), ("zm_",)),
        "filter_compact_table": (lambda: table_with(old)(table, mask),
                                 lambda: table_with(_build.lib())(table, mask),
                                 lambda: ref.filter_compact_table_ref(table, mask),
                                 ("fc_",)),
    }
    out = {}
    for name, (f_old, f_new, f_ref, prefixes) in cases.items():
        want = f_ref()
        for label, fn in (("old", f_old), ("new", f_new)):
            got = fn()
            pairs = (zip(got.values(), want.values()) if isinstance(got, dict)
                     else zip(got, want))
            check(all(same_bits(a, b) for a, b in pairs), f"compare_parent {name} {label}")
        turns = {"old": [], "new": []}
        for label in ("old", "new", "new", "old"):
            turns[label].append(device_ms(f_old if label == "old" else f_new, prefixes)[0])
        out[name] = {k: sum(v) / len(v) for k, v in turns.items()}
        out[name]["turns"] = turns
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            cases["filter_compact_table"][1]()
        torch.cuda.synchronize()
    out["filter_compact_new_by_kernel_ms"] = {
        k.removeprefix("void ").split("(")[0]: v / 1e3 / 20
        for k, v in device_us_by_name(prof).items() if own_activity(k, ("fc_",))}
    depth = {}
    keep = ZM.CTAS_PER_SM
    try:
        for d in (1, 2, 4, 8):
            ZM.CTAS_PER_SM = d
            depth[d] = {"194_blocks": device_ms(lambda: ZM.zonemap(x, PARTITION_ROWS), ("zm_",))[0],
                        "one_block": device_ms(lambda: ZM.zonemap(x, x.shape[0]), ("zm_",))[0]}
    finally:
        ZM.CTAS_PER_SM = keep
    out["zonemap_depth"] = depth
    print("compare_parent " + json.dumps(out), flush=True)


# ---------------------------------------------------------------------------
# 4. the main path


def prog_filter_groupby(base):
    df = base.copy()
    df = df[df["fare"] > 0]
    df["tip_rate"] = df["tip"] / df["fare"]
    return df.groupby("vendor")["tip_rate"].mean().compute()


def prog_feature_engineering(base):
    df = base.copy()
    df["day"] = df["pickup"].dt.dayofweek
    df["fare_clipped"] = df["fare"].clip(0, 50)
    return df.groupby("day").agg({"fare_clipped": ("fare_clipped", "sum"),
                                  "rides": ("fare", "count")}).compute()


def ref_filter_groupby(a):
    keep = a["fare"] > 0
    rate = a["tip"][keep] / a["fare"][keep]
    v = a["vendor"][keep]
    s = np.bincount(v, weights=rate, minlength=3)
    c = np.bincount(v, minlength=3)
    return {"vendor": np.arange(3), "tip_rate": s / c}


def ref_feature_engineering(a):
    day = ((a["pickup"] // 86400) + 3) % 7
    clipped = np.clip(a["fare"], 0, 50)
    return {"day": np.arange(7),
            "fare_clipped": np.bincount(day, weights=clipped, minlength=7),
            "rides": np.bincount(day, minlength=7).astype(np.int64)}


def compare(res, want: dict, what: str) -> None:
    got = {k: v.cpu().numpy() for k, v in res.columns.items()}
    check(set(got) == set(want), f"{what}: columns {sorted(got)}")
    for k, w in want.items():
        g = got[k]
        check(g.shape == w.shape, f"{what}: {k} shape {g.shape} vs {w.shape}")
        check(np.all(np.isfinite(g.astype(np.float64))), f"{what}: {k} not finite")
        if g.dtype.kind == "f":
            check(np.allclose(g, w, rtol=1e-9, atol=0), f"{what}: {k} (rtol 1e-9)")
        else:
            check(np.array_equal(g.astype(np.int64), w.astype(np.int64)), f"{what}: {k}")


def main_path(arrays, dev) -> dict:
    import torch
    import repro_torch.pandas as pd
    from repro_torch.kernels import filter_compact, groupby_sum, zonemap

    counters = {"filter_compact": filter_compact, "groupby_sum": groupby_sum,
                "zonemap": zonemap}
    refs = {"filter_groupby": ref_filter_groupby(arrays),
            "feature_engineering": ref_feature_engineering(arrays)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in counters.values():
        m.launches = 0
    walls, by_run = {}, {}
    with pd.session(engine="eager", name="chip_smoke"):
        base = pd.from_arrays(arrays, partition_rows=PARTITION_ROWS,
                              dicts={"vendor": VENDORS}, datetimes=("pickup",))
        for name, prog in (("filter_groupby", prog_filter_groupby),
                           ("feature_engineering", prog_feature_engineering)):
            for run in ("cold", "warm"):
                before = {k: m.launches for k, m in counters.items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = prog(base)
                torch.cuda.synchronize()
                walls[f"{name}.{run}"] = time.perf_counter() - t0
                by_run[f"{name}.{run}"] = {k: m.launches - before[k]
                                           for k, m in counters.items()}
                check(all(v.is_cuda for v in res.columns.values()),
                      f"{name}: result left the card")
                compare(res, refs[name], f"{name}.{run}")
    launches = {k: m.launches for k, m in counters.items()}
    for k, v in launches.items():
        check(v > 0, f"main path never launched kernel {k}")
    info = {"rows": len(arrays["fare"]), "wall_s": walls, "launches": launches,
            "launches_by_run": by_run,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    print("main_path " + json.dumps(info), flush=True)
    return launches


def breakdown(arrays) -> None:
    """Where a run's time goes: host seconds of the cold run's setup pieces
    (content hash of the source, every partition's zone map), host span
    totals of a cold ``filter_groupby``, and the card's busy time against
    the wall of a warm one (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import repro_torch.pandas as pd
    from repro_torch.core.source import InMemorySource

    out = {}
    src = InMemorySource(arrays, PARTITION_ROWS, {"vendor": VENDORS}, ("pickup",))
    t0 = time.perf_counter()
    src.cache_token()
    out["source_hash_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    src.partition_meta(0)
    torch.cuda.synchronize()
    out["zone_maps_s"] = time.perf_counter() - t0
    with pd.session(engine="eager", name="breakdown"):
        from repro_torch.core.planner.plancache import default_plan_cache
        default_plan_cache().clear()
        base = pd.from_arrays(arrays, partition_rows=PARTITION_ROWS,
                              dicts={"vendor": VENDORS}, datetimes=("pickup",))
        with pd.profile() as prof:
            t0 = time.perf_counter()
            prog_filter_groupby(base)
            torch.cuda.synchronize()
            out["cold_wall_s"] = time.perf_counter() - t0
        spans: dict[str, float] = {}
        for sp in prof.spans:
            spans[sp.name] = spans.get(sp.name, 0.0) + sp.duration
        out["cold_host_span_s"] = dict(sorted(spans.items(), key=lambda kv: -kv[1]))
        prog_filter_groupby(base)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
            t0 = time.perf_counter()
            prog_filter_groupby(base)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kernels: dict[str, float] = {}
    for key, us in device_us_by_name(tp).items():
        kernels[key[:60]] = kernels.get(key[:60], 0.0) + us / 1e6
    busy = sum(kernels.values())
    out["warm_wall_s"] = wall
    out["warm_device_busy_s"] = busy
    out["warm_device_idle_share"] = 1.0 - busy / wall if wall > 0 else None
    out["warm_device_s_by_kernel"] = dict(sorted(kernels.items(),
                                                 key=lambda kv: -kv[1])[:12])
    print("breakdown " + json.dumps(out), flush=True)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=12_700_000)
    ap.add_argument("--parent-csrc", default=None,
                    help="a directory holding an earlier commit's csrc/*.cu: "
                         "time its zonemap and filter_compact against this tree's")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's check needs one card",
              file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "src", "repro_torch", "kernels", "csrc")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(repo, "src"))
    os.environ["REPRO_TORCH_DEVICE"] = "cuda:0"
    dev = torch.device("cuda:0")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.lib()
    print(f"build {time.perf_counter() - t0:.3f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})",
          flush=True)

    arrays = make_taxi(args.rows, args.seed)
    kernels = [kernel_filter_compact(arrays, dev), kernel_groupby_sum(arrays, dev)]
    zm, upload = kernel_zonemap(arrays, dev)
    kernels.append(zm)
    for k in kernels:
        k["bound_share"] = k["bound_ms"] / k["device_ms"]
        print(f"kernel {k['name']}: ok max_abs_err={k['max_abs_err']} "
              f"device_ms={k['device_ms']:.4f} {k['device_ms_spread']} "
              f"call_ms={k['call_ms']:.4f} {k['call_ms_spread']} "
              f"plain_ms={k['plain_ms']:.4f} library_ms={k['library_ms']:.4f} "
              f"library_device_ms={k['library_device_ms']:.4f} "
              f"bound_ms={k['bound_ms']:.4f} share={k['bound_share']:.3f} "
              f"({k['shape']})", flush=True)
    print(json.dumps(upload), flush=True)
    if args.parent_csrc:
        compare_parent(args.parent_csrc, arrays, dev)

    launches = main_path(arrays, dev)
    breakdown(arrays)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        del k["shape"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
