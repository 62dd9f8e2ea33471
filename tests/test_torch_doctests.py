"""Doctest smoke for the port's front door, IVF index, warm tier, router,
lexical arena, split-stack two-scan baseline, arena-scan tile policy,
hybrid reference, observability, serving (scheduler, load harness,
metrics, faults) and corpus docstrings (the twin of
tests/test_doctests.py): every ``>>>`` example runs here on the CPU, so
the runnable examples cannot rot."""
import doctest

import pytest
import torch

import repro_torch.api.executor
import repro_torch.api.plan
import repro_torch.api.planner
import repro_torch.api.ragdb
import repro_torch.core.ivf
import repro_torch.core.query
import repro_torch.core.router
import repro_torch.core.splitstack
import repro_torch.data.corpus
import repro_torch.index.lexical.arena
import repro_torch.index.lexical.twoscan
import repro_torch.kernels.arena_scan.ops
import repro_torch.kernels.arena_scan.stages
import repro_torch.kernels.hybrid_score.ref
import repro_torch.obs.calibration
import repro_torch.obs.recorder
import repro_torch.obs.tracer
import repro_torch.serving.faults
import repro_torch.serving.load
import repro_torch.serving.metrics
import repro_torch.serving.scheduler

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

MODULES = [
    repro_torch.api.plan,
    repro_torch.api.planner,
    repro_torch.api.executor,
    repro_torch.api.ragdb,
    repro_torch.core.ivf,
    repro_torch.core.query,
    repro_torch.core.router,
    repro_torch.core.splitstack,
    repro_torch.data.corpus,
    repro_torch.index.lexical.arena,
    repro_torch.index.lexical.twoscan,
    repro_torch.kernels.arena_scan.ops,
    repro_torch.kernels.arena_scan.stages,
    repro_torch.kernels.hybrid_score.ref,
    repro_torch.obs.tracer,
    repro_torch.obs.recorder,
    repro_torch.obs.calibration,
    repro_torch.serving.faults,
    repro_torch.serving.load,
    repro_torch.serving.metrics,
    repro_torch.serving.scheduler,
]


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m.__name__)
def test_module_doctests(mod):
    result = doctest.testmod(mod, verbose=False)
    assert result.attempted > 0, f"{mod.__name__} lost its doctest examples"
    assert result.failed == 0, f"{result.failed} doctest failure(s) in {mod.__name__}"
