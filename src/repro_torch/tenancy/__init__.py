"""Multi-tenant preference layer of the port: one Full Index, many hot
indexes.

Every preference-shaped thing — the per-tenant query counter, hot index,
Alg-2 rebuild clock and hot device tables — lives per tenant, while the
Full Index (rows, graph, quantizer) stays shared.  Port of
``repro.tenancy``.
"""

from .tenant import DEFAULT_TENANT, TenantState  # noqa: F401
from .registry import StackedHotTables, TenantRegistry  # noqa: F401

__all__ = ["DEFAULT_TENANT", "TenantState", "TenantRegistry",
           "StackedHotTables"]
