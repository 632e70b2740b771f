"""Back-compat shim — the physical operators moved to
``repro_torch.core.physical`` (the unified physical-operator layer shared by all
backends).  Import from there in new code; this module re-exports the full
surface so existing ``from .. import exec_common as X`` call sites keep
working unchanged.
"""
from __future__ import annotations

from .physical import *  # noqa: F401,F403
from .physical import __all__  # noqa: F401
