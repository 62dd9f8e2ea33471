"""The paper's contribution, ported: the unified data layer.

  store.py        columnar device-resident document store (one source of truth)
  transactions.py atomic commits + snapshot isolation (0 ms inconsistency window)
  ivf.py          IVF cluster index (the pruned route: probe nprobe clusters)
  query.py        the unified query (similarity + freshness + category + RLS in
                  one pass); plain engine here, CUDA kernel in repro_torch.kernels
  tenancy.py      principals, tenant registry, server-side predicate builder
  splitstack.py   Stack A -- the conventional 3-tool baseline (vector DB +
                  metadata store + cache + app-layer glue), bug-injectable;
                  queried with pushdown, the warm tier
  router.py       3-tier hot/warm/cold deployment router (paper §7.3)
"""
from repro_torch.core.ivf import (IVFConfig, IVFIndex, build_ivf,  # noqa: F401
                                  ivf_query)
from repro_torch.core.query import (Predicate, unified_query,  # noqa: F401
                                    unified_query_grouped, unified_query_ref)
from repro_torch.core.store import (DocBatch, Store, StoreConfig,  # noqa: F401
                                    empty)
from repro_torch.core.tenancy import (Principal, TenantRegistry,  # noqa: F401
                                      build_predicate)
from repro_torch.core.transactions import TransactionLog  # noqa: F401
from repro_torch.core.splitstack import SplitStackClient  # noqa: F401
from repro_torch.core.router import (RouteStats, TieredResult,  # noqa: F401
                                     TieredRouter)
