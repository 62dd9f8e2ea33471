"""The front-door API of the port: one session-scoped entrance to the
unified data layer.

  ragdb.py     RagDB (storage + tenants + plan execution), Session (principal
               -scoped; the only way to query), QueryBuilder (composable chain)
  plan.py      LogicalPlan (what was asked) / PhysicalPlan (how it runs) with
               SQL-style explain()
  planner.py   deterministic compilation: engine selection + tier routing
  executor.py  predicate-group batched execution; the single dispatch point
               for retrieval device calls
"""
from repro_torch.api.executor import CompiledShapes, ExecStats  # noqa: F401
from repro_torch.api.plan import (LogicalPlan, PhysicalPlan,  # noqa: F401
                                  bucket_rows)
from repro_torch.api.planner import (CostModel, FusedGroup,  # noqa: F401
                                     PlannerConfig, compile_plan, fuse_batch)
from repro_torch.api.ragdb import (QueryBuilder, QueryResult,  # noqa: F401
                                   RagDB, ResultCache, Session)
