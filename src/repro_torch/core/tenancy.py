"""Tenancy + access control: predicate construction is server-side.

The unified engine's isolation guarantee has two halves:
  1. the predicate is evaluated inside the retrieval kernel (query.py /
     kernels/filtered_topk) — no app code can skip it;
  2. the predicate itself is built HERE from the authenticated principal, not
     from request parameters — a client cannot ask for another tenant.

That pairing is the row-level-security analogue. `build_predicate` is the only
public way to obtain a Predicate carrying a tenant clause.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.query import Predicate


@dataclasses.dataclass(frozen=True)
class Principal:
    """An authenticated caller: tenant + ACL group memberships."""
    tenant_id: int
    group_bits: int          # uint32 bitmask of ACL groups the caller is in


@dataclasses.dataclass
class TenantRegistry:
    """Tenant id allotment + per-tenant quota accounting."""
    n_tenants: int = 0
    doc_quota: dict = dataclasses.field(default_factory=dict)
    doc_count: dict = dataclasses.field(default_factory=dict)

    def create_tenant(self, quota: int = 1 << 30) -> int:
        tid = self.n_tenants
        self.n_tenants += 1
        self.doc_quota[tid] = quota
        self.doc_count[tid] = 0
        return tid

    def precheck(self, tid: int, n_docs: int) -> None:
        """The quota rule, checkable without committing (batch validation)."""
        if self.doc_count[tid] + n_docs > self.doc_quota[tid]:
            raise PermissionError(f"tenant {tid} over document quota")

    def charge(self, tid: int, n_docs: int) -> None:
        self.precheck(tid, n_docs)
        self.doc_count[tid] += n_docs


def category_mask(categories) -> int:
    """Lower a category id list to the engine's uint32 bitmask — the ONE
    place the [0, 32) bound is enforced (shared by build_predicate and the
    front-door LogicalPlan lowering)."""
    mask = 0
    for c in categories:
        c = int(c)
        if not 0 <= c < 32:
            raise ValueError("category ids must be in [0, 32)")
        mask |= 1 << c
    return mask


def build_predicate(principal: Principal, *, min_ts: int = 0,
                    categories: list[int] | None = None) -> Predicate:
    """With the front-door Session lowering, one of the only two predicate
    constructors that set the tenant/ACL clauses — both take them from the
    authenticated principal, never from request parameters. Categories and
    recency are caller-chosen filters.
    """
    cat_mask = 0xFFFFFFFF if categories is None else category_mask(categories)
    return Predicate(tenant=principal.tenant_id, min_ts=min_ts,
                     cat_mask=cat_mask, acl_bits=principal.group_bits & 0xFFFFFFFF)
