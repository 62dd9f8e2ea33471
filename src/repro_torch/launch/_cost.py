"""The work of one call, counted op by op: the port's stand-in for XLA's
``cost_analysis`` and ``memory_analysis`` (the launch tools' counter).

``count(fn, *args)`` runs ``fn(*args)`` under a `CostCounter`, a
``TorchDispatchMode`` that sees every aten op the call dispatches, and
returns the `Cost`. It works alike on the ``meta`` device (shapes only,
nothing computed: the dry run) and on ``cuda`` (the call runs).

Conventions:

* ``flops``: the matmul family (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  convolutions, SDPA ...) by ``torch.utils.flop_counter``'s registry
  (2 per multiply-add), plus what each hand-written kernel reports
  (`report`: the formulas of its bound). Elementwise ops count none, as
  in the registry.
* ``bytes``: every dispatched op's tensor inputs and outputs, each
  tensor's elements once (a slice counts its own elements, not its
  storage's). That is what the eager port moves: nothing is fused. View
  ops (``func.is_view`` and ``_unsafe_view``, ``detach``, ``alias``) and
  allocations (``empty*``) count nothing; a gather (`GATHER`: ``index``,
  ``index_select``, ``gather``, ``embedding``, ``take``) reads the
  elements it gathers, not its whole source, so it counts its indices and
  twice its output; an in-place op counts its target as an input and as
  its output (read and written); a kernel adds the bytes it reports (each
  input read once, each output written once).
* ``transcendentals``: the elements of every op in `TRANSCENDENTAL` (the
  largest tensor among its inputs and outputs): exp / log / tanh /
  sigmoid / rsqrt / erf / sin / cos and the ops built on them (silu,
  gelu, softmax, logsumexp and their backward passes that evaluate them).
* ``peak_bytes``: the peak of live storage beyond the arguments: a
  storage counts from the op that allocates it until it is freed (a weak
  reference to the storage sees it die), whoever holds it meanwhile
  (autograd's saved tensors included). Storages that existed before the
  call (the arguments, module caches) never count.
* ``launches``: each kernel's reports, by name.
* ``by_op``: (flops, bytes) by op name, to tell two counts apart.

A ``.item()`` or any other read of a value raises on ``meta`` (aten's
``_local_scalar_dense`` has no meta kernel): a cell whose path reads
device values cannot be reckoned this way, and the caller must say how it
reckons it instead.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

#: op packets whose elements are transcendental evaluations
TRANSCENDENTAL = frozenset(
    getattr(aten, name) for name in (
        "exp", "exp_", "exp2", "expm1", "log", "log_", "log1p", "log2",
        "tanh", "tanh_", "sigmoid", "sigmoid_", "rsqrt", "rsqrt_", "erf",
        "erfinv", "sin", "cos", "silu", "silu_", "silu_backward", "gelu",
        "gelu_backward", "_softmax", "_log_softmax", "logsumexp",
        "softplus", "tanh_backward", "sigmoid_backward")
    if hasattr(aten, name))
#: ops that alias their input or only allocate: no bytes
_NO_BYTES = frozenset(
    getattr(aten, name) for name in (
        "_unsafe_view", "detach", "alias", "lift_fresh", "empty",
        "empty_like", "empty_strided", "new_empty", "new_empty_strided",
        "_local_scalar_dense", "set_", "resize_")
    if hasattr(aten, name))

#: ops whose first argument is a source they read only where indexed
GATHER = frozenset(
    getattr(aten, name) for name in (
        "index", "index_select", "gather", "embedding", "take")
    if hasattr(aten, name))

_ACTIVE: list["CostCounter"] = []


@dataclasses.dataclass
class Cost:
    flops: int = 0
    bytes: int = 0
    transcendentals: int = 0
    peak_bytes: int = 0
    launches: dict = dataclasses.field(default_factory=dict)
    by_op: dict = dataclasses.field(default_factory=dict)


def counting() -> bool:
    """Whether a counter is active (a wrapper reckons its work only
    then: the serving path pays nothing for it)."""
    return bool(_ACTIVE)


def report(name: str, *, flops: int, nbytes: int,
           transcendentals: int = 0) -> None:
    """A hand-written kernel's wrapper declares one launch's work (its
    bound's operations and bytes) to the active counter, if any. Called on
    ``meta`` (no launch) and on ``cuda`` (the launch) alike."""
    if _ACTIVE:
        c = _ACTIVE[-1].cost
        c.flops += int(flops)
        c.bytes += int(nbytes)
        c.transcendentals += int(transcendentals)
        c.launches[name] = c.launches.get(name, 0) + 1
        f, b = c.by_op.get(name, (0, 0))
        c.by_op[name] = (f + int(flops), b + int(nbytes))


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):   # a tensor with no storage
        return None


class CostCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is active (see the module's
    conventions); `Cost` is in ``.cost``. ``known`` holds tensors whose
    storages existed before the call (the arguments)."""

    def __init__(self, known=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.cost = Cost()
        self._live = 0
        # storage address -> (nbytes, counted, finalizer)
        self._storages: dict[int, tuple] = {}
        for t in known:
            self._note(_storage(t), counted=False)

    def _note(self, st, *, counted: bool) -> None:
        if st is None:
            return
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes() if counted else 0
        fin = weakref.finalize(st, self._freed, key)
        fin.atexit = False
        self._storages[key] = (n, counted, fin)
        if counted:
            self._live += n
            self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)

    def _freed(self, key: int) -> None:
        n, counted, _ = self._storages.pop(key)
        if counted:
            self._live -= n

    def close(self) -> None:
        """Stop watching storages (the count is final)."""
        for _, _, fin in list(self._storages.values()):
            fin.detach()
        self._storages.clear()

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        for t in ins:                       # pre-existing storages
            self._note(_storage(t), counted=False)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:                      # new storages count from here
            self._note(_storage(t), counted=True)
        packet = func._overloadpacket
        c = self.cost
        flops = 0
        if packet in self._flop_registry:
            flops = int(self._flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
            c.flops += flops
        nbytes = 0
        if packet in GATHER:
            src = args[0]
            nbytes = sum(_nbytes(t) for t in ins if t is not src) \
                + 2 * sum(map(_nbytes, outs))
            c.bytes += nbytes
        elif not (func.is_view or packet in _NO_BYTES):
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            c.bytes += nbytes
        if packet in TRANSCENDENTAL:
            c.transcendentals += max((t.numel() for t in ins + outs),
                                     default=0)
        if flops or nbytes:
            name = packet.__name__
            f, b = c.by_op.get(name, (0, 0))
            c.by_op[name] = (f + flops, b + nbytes)
        return out


def arg_tensors(tree) -> list[torch.Tensor]:
    """Every tensor of a cell's arguments: tensors, modules (parameters
    and buffers), dicts, lists and tuples."""
    out = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif isinstance(node, torch.nn.Module):
            out.extend(node.parameters())
            out.extend(node.buffers())
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
    walk(tree)
    return out


def count(fn, *args) -> tuple[Cost, object]:
    """(the `Cost` of ``fn(*args)``, its result)."""
    counter = CostCounter(known=arg_tensors(args))
    try:
        with counter:
            out = fn(*args)
        return counter.cost, out
    finally:
        counter.close()
