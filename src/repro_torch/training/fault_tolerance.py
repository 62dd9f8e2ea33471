"""Fault tolerance (port of ``repro/training/fault_tolerance.py``).

Three mechanisms:
  1. Checkpoint/restart -- `resume_or_init` restarts a crashed job from the
     newest complete checkpoint (atomic-rename saves guarantee completeness).
  2. Straggler detection -- per-step wall-time EMA + robust z-score; slow
     steps flag the host so the scheduler can drain/replace it.
  3. Elastic re-mesh -- when the healthy device set shrinks/grows, pick the
     largest (data, model)-factorable mesh that fits the cards present
     (`make_elastic_mesh`), and restore the newest checkpoint onto its
     shardings (`reshard_state`): over several cards every leaf lands in
     its pieces on their cards (`checkpoint.restore`).

`StragglerDetector` and `plan_mesh_shape` are plain Python, copied from the
reference.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.training import checkpoint as ckpt


# ---------------------------------------------------------------------------
# 1. checkpoint / restart
# ---------------------------------------------------------------------------

def resume_or_init(root: str | None, init_fn, like=None, *, device=None,
                   shardings=None):
    """Returns (state, start_step). `init_fn()` builds a fresh state; `like`
    defaults to that fresh state as the structure donor for restore;
    ``shardings`` restores onto a mesh (`checkpoint.restore`)."""
    if root:
        step = ckpt.latest_step(root)
        if step is not None:
            donor = like if like is not None else init_fn()
            state = ckpt.restore(root, step, donor, device=device,
                                 shardings=shardings)
            return state, step
    return init_fn(), 0


# ---------------------------------------------------------------------------
# 2. straggler detection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerDetector:
    """EMA + MAD z-score over step times. `record` returns True when the
    step is flagged; flagged steps accumulate in `events`."""
    alpha: float = 0.05
    z_threshold: float = 4.0
    warmup_steps: int = 10
    _ema: float = 0.0
    _var: float = 0.0
    _n: int = 0

    def __post_init__(self):
        self.events: list[tuple[int, float, float]] = []

    def record(self, step: int, dt_s: float) -> bool:
        self._n += 1
        if self._n == 1:
            self._ema = dt_s
            self._var = 0.0
            return False
        delta = dt_s - self._ema
        self._ema += self.alpha * delta
        self._var = (1 - self.alpha) * (self._var + self.alpha * delta * delta)
        if self._n <= self.warmup_steps:
            return False
        sigma = math.sqrt(self._var) + 1e-9
        z = (dt_s - self._ema) / sigma
        if z > self.z_threshold:
            self.events.append((step, dt_s, z))
            return True
        return False

    @property
    def mean_step_s(self) -> float:
        return self._ema


# ---------------------------------------------------------------------------
# 3. elastic re-mesh
# ---------------------------------------------------------------------------

def plan_mesh_shape(n_devices: int, *, model_parallel: int,
                    prefer_pow2: bool = True) -> tuple[int, int]:
    """Largest (data, model) grid with the requested model-parallel degree
    that fits n_devices. Shrinks model_parallel if needed (a model that fit
    M-way sharded still fits at larger M only if divisible — we only shrink
    to divisors so params keep fitting)."""
    mp = model_parallel
    while mp > 1 and n_devices % mp != 0:
        mp //= 2
    dp = n_devices // mp
    if prefer_pow2:
        dp = 1 << (dp.bit_length() - 1)
    return dp, mp


def make_elastic_mesh(n_devices: int, *, model_parallel: int,
                      devices=None) -> Mesh:
    """The planned (data, model) mesh over the first dp * mp of ``devices``
    (default: the CUDA devices present)."""
    dp, mp = plan_mesh_shape(n_devices, model_parallel=model_parallel)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(have)]
    return make_mesh((dp, mp), ("data", "model"), devices=list(devices)[: dp * mp])


def reshard_state(root: str, step: int, like, new_shardings):
    """Restore checkpoint `step` resharded onto a new mesh's shardings (a
    tree of `distributed.sharding.NamedSharding`) -- the recovery path
    after losing a pod/host. The mesh's devices must be of one type and
    every spec must fit its leaf, else ValueError (`checkpoint.restore`);
    over several devices every leaf lands in its pieces on them."""
    return ckpt.restore(root, step, like, shardings=new_shardings)
