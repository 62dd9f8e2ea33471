"""The paper's contribution, ported: the unified data layer.

  store.py        columnar device-resident document store (one source of truth)
  transactions.py atomic commits + snapshot isolation (0 ms inconsistency window)
  query.py        the unified query (similarity + freshness + category + RLS in
                  one pass); plain engine here, CUDA kernel in repro_torch.kernels
  tenancy.py      principals, tenant registry, server-side predicate builder
"""
from repro_torch.core.query import (Predicate, unified_query,  # noqa: F401
                                    unified_query_grouped, unified_query_ref)
from repro_torch.core.store import (DocBatch, Store, StoreConfig,  # noqa: F401
                                    empty)
from repro_torch.core.tenancy import (Principal, TenantRegistry,  # noqa: F401
                                      build_predicate)
from repro_torch.core.transactions import TransactionLog  # noqa: F401
