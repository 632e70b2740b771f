"""Dispatch between the hand-written CUDA kernels and their plain versions.

``KernelConfig.impl`` selects:

* ``"auto"``  — by the input tensor's device: a CUDA tensor launches the
                kernel, a CPU tensor takes the plain PyTorch version;
* ``"cuda"``  — the kernel; a CPU tensor raises;
* ``"torch"`` — the plain PyTorch version on any device.

No path falls back from a kernel to the plain version: a kernel that fails
to build or launch raises.
"""
from __future__ import annotations

import dataclasses

import torch

from . import ref

IMPLS = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    impl: str = "auto"          # auto | cuda | torch

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"kernel impl {self.impl!r} not in {IMPLS}")

    def use_kernel(self, t: torch.Tensor) -> bool:
        """True when ``t`` goes to the hand-written kernel."""
        if self.impl == "torch":
            return False
        if self.impl == "cuda" and not t.is_cuda:
            raise ValueError(f"kernel impl 'cuda' given a tensor on {t.device}")
        return t.is_cuda


_CONFIG = KernelConfig()


def set_kernel_config(cfg: KernelConfig):
    global _CONFIG
    _CONFIG = cfg


def get_kernel_config() -> KernelConfig:
    return _CONFIG


def groupby_sum_count(codes, values, num_groups: int, with_count: bool = True,
                      cfg: KernelConfig | None = None):
    """``(sums | None, counts | None)`` by group code in one pass."""
    cfg = cfg or _CONFIG
    if cfg.use_kernel(codes):
        from .groupby_sum import groupby_sum_count as kernel
        return kernel(codes, values, num_groups, with_count)
    return ref.groupby_sum_count_ref(codes, values, num_groups, with_count)


def groupby_sum(codes, values, num_groups: int, cfg: KernelConfig | None = None):
    return groupby_sum_count(codes, values, num_groups, False, cfg)[0]


def filter_compact(values, mask, cfg: KernelConfig | None = None):
    cfg = cfg or _CONFIG
    if cfg.use_kernel(mask):
        from .filter_compact import filter_compact as kernel
        return kernel(values, mask)
    return ref.filter_compact_ref(values, mask)


def filter_compact_table(cols: dict, mask, cfg: KernelConfig | None = None):
    """Every column of a table compacted under one mask."""
    cfg = cfg or _CONFIG
    if cfg.use_kernel(mask):
        from .filter_compact import filter_compact_table as kernel
        return kernel(cols, mask)
    return ref.filter_compact_table_ref(cols, mask)


def filter_compact_chunked(values, mask, chunk: int = 1 << 20,
                           cfg: KernelConfig | None = None):
    """Two-level compaction: compact each chunk, then compact the
    concatenated chunks under their valid-prefix mask.  Same result as
    ``filter_compact``."""
    n = values.shape[0]
    if n <= chunk:
        return filter_compact(values, mask, cfg)
    packed_parts, counts = [], []
    for lo in range(0, n, chunk):
        p, c = filter_compact(values[lo:lo + chunk], mask[lo:lo + chunk], cfg)
        packed_parts.append(p)
        counts.append(c)
    packed = torch.cat(packed_parts)
    counts = torch.stack(counts)
    sizes = torch.tensor([p.shape[0] for p in packed_parts],
                         device=packed.device)
    offs = torch.cumsum(sizes, 0) - sizes
    idx = torch.arange(packed.shape[0], device=packed.device)
    chunk_id = torch.searchsorted(offs, idx, right=True) - 1
    valid = (idx - offs[chunk_id]) < counts[chunk_id]
    return filter_compact(packed, valid, cfg)


def zonemap(values, block_rows: int = 4096, cfg: KernelConfig | None = None):
    cfg = cfg or _CONFIG
    if values.shape[0] == 0:
        # no rows → no blocks
        return (values.new_zeros((0,)), values.new_zeros((0,)))
    if cfg.use_kernel(values):
        from .zonemap import zonemap as kernel
        return kernel(values, block_rows)
    return ref.zonemap_ref(values, block_rows)
