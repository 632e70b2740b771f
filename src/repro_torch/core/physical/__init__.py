"""Unified physical-operator layer.

Explicit operators (the row-preserving pipeline, group-by, join, sort,
distinct, reductions, segment handoff) over a common *table protocol*:

* eager     — whole-table ``dict[str, torch.Tensor]`` on the default device
* host      — ``dict[str, np.ndarray]`` (sources, fallback results)

Module map
----------
``table``    table protocol helpers, device choice, handoff normalization
``rowwise``  row-preserving pipeline ops (filter/project/assign/…)
``groupby``  factorization + dense segment aggregation
``join``     host hash/sort join and aligned key factorization
``sort``     sort + distinct
``reduce``   whole-column reductions

``repro_torch.core.exec_common`` re-exports everything here.
"""
from __future__ import annotations

from .table import (Table, apply_concat, default_device, dtype_kind,
                    handoff_value, is_torch, table_nbytes, table_rows,
                    to_host_value, to_numpy, to_torch, xp_of)
from .rowwise import (apply_assign, apply_astype, apply_fillna, apply_filter,
                      apply_fused_rowwise, apply_head, apply_map_rows,
                      apply_project, apply_rename)
from .groupby import _factorize, _factorize_multi, apply_groupby_agg
from .join import _factorize_multi_np_pair, apply_join
from .sort import apply_drop_duplicates, apply_sort, apply_top_k
from .reduce import apply_reduce

__all__ = [
    "Table", "is_torch", "xp_of", "dtype_kind", "default_device",
    "table_rows", "table_nbytes", "to_numpy", "to_torch", "to_host_value",
    "handoff_value", "apply_concat",
    "apply_filter", "apply_project", "apply_assign", "apply_rename",
    "apply_astype", "apply_fillna", "apply_fused_rowwise", "apply_head",
    "apply_map_rows",
    "_factorize", "_factorize_multi", "apply_groupby_agg", "apply_join",
    "_factorize_multi_np_pair", "apply_sort", "apply_top_k",
    "apply_drop_duplicates", "apply_reduce",
]
