"""Rule-based plan-rewrite engine (see engine.py for the driver)."""
from .engine import (RewriteEvent, RewriteRule, apply_rewrites,
                     consumed_ok, default_rules)
from .rules import (DEFAULT_RULES, DedupBeforeSort, FilterThroughConcat,
                    MapRowsVectorize, SortHeadToTopK)

__all__ = [
    "RewriteEvent", "RewriteRule", "apply_rewrites", "consumed_ok",
    "default_rules", "DEFAULT_RULES", "DedupBeforeSort",
    "FilterThroughConcat", "MapRowsVectorize", "SortHeadToTopK",
]
