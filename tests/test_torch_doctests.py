"""Doctest smoke for the port's front door, observability and corpus
docstrings (the twin of tests/test_doctests.py): every ``>>>`` example runs
here on the CPU, so the runnable examples cannot rot."""
import doctest

import pytest
import torch

import repro_torch.api.executor
import repro_torch.api.plan
import repro_torch.api.planner
import repro_torch.api.ragdb
import repro_torch.core.query
import repro_torch.data.corpus
import repro_torch.obs.calibration
import repro_torch.obs.recorder
import repro_torch.obs.tracer
import repro_torch.serving.faults

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

MODULES = [
    repro_torch.api.plan,
    repro_torch.api.planner,
    repro_torch.api.executor,
    repro_torch.api.ragdb,
    repro_torch.core.query,
    repro_torch.data.corpus,
    repro_torch.obs.tracer,
    repro_torch.obs.recorder,
    repro_torch.obs.calibration,
    repro_torch.serving.faults,
]


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m.__name__)
def test_module_doctests(mod):
    result = doctest.testmod(mod, verbose=False)
    assert result.attempted > 0, f"{mod.__name__} lost its doctest examples"
    assert result.failed == 0, f"{result.failed} doctest failure(s) in {mod.__name__}"
