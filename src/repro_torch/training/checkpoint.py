"""Checkpointing: atomic, async, keep-k (port of
``repro/training/checkpoint.py``), in the reference's on-disk format.

Layout (one checkpoint = one directory):
  <root>/step_000000001230/
    manifest.json        {step, n_leaves, paths, shapes, dtypes, time}
    arrays.npz           leaf arrays keyed by flattened path

Paths are the reference's: the leaves of the tree's reference view
(`training.tree.ref_items`: dict keys sorted, a model's layers stacked on
a leading n_layers axis) joined by ``$``, so a checkpoint written by either
package restores in the other. A bf16 leaf is written as the reference
writes one: its 2-byte patterns as an ``np.savez`` void array ('|V2') with
``bfloat16`` in the manifest's ``dtypes``; reading goes by the manifest,
so neither side needs ``ml_dtypes``. A Python int leaf (the step) is saved
as int32, the reference's step dtype.

Atomicity: write into ``<root>/.tmp_<step>`` then ``os.rename`` -- a crash
mid-write can never produce a directory that `latest_step` would pick up.
Async: one background writer thread; the device -> host copy happens on the
caller thread, serialisation off the critical path; keep-k pruning on
every save. A state laid on a mesh of several devices
(`distributed.sharding.Placed` leaves) is saved as the global arrays its
pieces make up, in the same layout. On restore, tensor leaves go to
``device`` (default: where the structure donor's leaf lives), or onto the
mesh of ``shardings`` (the elastic re-mesh path of fault_tolerance.py):
over a mesh of one device the leaves go to that device and are checked
against their specs (`distributed.sharding.place`); over a mesh of
several devices each leaf is read from the file and laid straight into
its pieces on their devices, one leaf at a time.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import normalize_device, tensor_device
from repro_torch.training import tree as T

SEP = "$"


def _flatten(tree) -> tuple[list[str], list]:
    items = T.ref_items(tree)
    return ([SEP.join(str(key) for key in path) for path, _ in items],
            [leaf for _, leaf in items])


def _host_leaf(leaf):
    """A leaf copied to the host: a CPU tensor (a layer group stacked), a
    numpy array, or an int32 / float32 / bool numpy scalar array."""
    if isinstance(leaf, T.Group):
        return torch.stack([t.detach().cpu() for t in leaf])
    if isinstance(leaf, shd.Placed):
        return leaf.assemble("cpu")
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    if isinstance(leaf, (bool, np.bool_)):
        return np.asarray(leaf, np.bool_)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float32)
    return np.asarray(leaf)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array as np.savez writes it, the manifest's dtype name)."""
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            bits = leaf.contiguous().view(torch.int16).numpy()
            return bits.view(np.dtype("V2")), "bfloat16"
        leaf = leaf.numpy()
    return leaf, str(leaf.dtype)


def save(root: str, step: int, tree, *, keep: int = 3) -> str:
    """Synchronous atomic save. Returns the final checkpoint path."""
    keys, vals = _flatten(tree)
    host = [_to_numpy(_host_leaf(v)) for v in vals]
    tmp = os.path.join(root, f".tmp_{step}")
    final = os.path.join(root, f"step_{step:012d}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: a for k, (a, _) in zip(keys, host)})
    manifest = {
        "step": step,
        "n_leaves": len(keys),
        "paths": keys,
        "shapes": [list(a.shape) for a, _ in host],
        "dtypes": [name for _, name in host],
        "time": time.time(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(root, keep)
    return final


def _prune(root: str, keep: int) -> None:
    steps = sorted(all_steps(root))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(root, f"step_{s:012d}"), ignore_errors=True)


def all_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_") and os.path.exists(os.path.join(root, name, "manifest.json")):
            out.append(int(name[5:]))
    return sorted(out)


def latest_step(root: str) -> int | None:
    steps = all_steps(root)
    return steps[-1] if steps else None


def _tensor_of(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """An array read from the npz as a tensor; ``bfloat16`` in the manifest
    reinterprets its 2-byte patterns."""
    if dtype_name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def restore(root: str, step: int, like, *, device=None, shardings=None):
    """Rebuild the tree of ``like`` (the structure donor) from checkpoint
    ``step``. Tensor leaves become tensors on ``device`` (default: the
    donor leaf's device), keeping the donor's ``requires_grad``; int and
    float leaves come back as Python numbers, numpy leaves as arrays. A
    module in ``like`` (the port's `Transformer`) comes back as a new
    module of the same config, its parameters filled from the checkpoint
    (shapes must match).

    ``shardings`` (a tree of `NamedSharding` matching the state, e.g.
    `distributed.sharding.state_shardings`) restores onto that mesh, whose
    devices must be of one type, and every spec must fit its leaf; else
    ValueError. Over a mesh of one device the leaves go to that device
    (`sharding.place`, the donor's structure kept); over several devices
    the result is the reference's tree of the state, every tensor leaf a
    `sharding.Placed` whose pieces are read from the file straight onto
    their devices. It and ``device`` exclude each other."""
    if shardings is not None:
        if device is not None:
            raise ValueError("pass device= or shardings=, not both")
        mesh = next(sh.mesh for _, sh in _shardings(shardings))
        shd.check_mesh(mesh)
        if shd.one_device(mesh):
            return shd.place(restore(root, step, like, device=tensor_device(
                normalize_device(mesh.devices[0]))), shardings)
    path = os.path.join(root, f"step_{step:012d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    items = T.ref_items(like)
    keys = [SEP.join(str(key) for key in p) for p, _ in items]
    if set(keys) != set(manifest["paths"]):
        missing = set(manifest["paths"]) ^ set(keys)
        raise ValueError(f"checkpoint/model structure mismatch: {sorted(missing)[:5]} ...")
    dtype_of = dict(zip(manifest["paths"], manifest["dtypes"]))
    values = {}
    for (p, donor), key in zip(items, keys):
        arr = data[key]
        if shardings is not None and (isinstance(donor, shd.Placed) or
                                      torch.is_tensor(T.first(donor))):
            values[p] = shd.place_leaf(_tensor_of(arr, dtype_of[key]),
                                       T.at(shardings, p))
        elif isinstance(donor, T.Group) or torch.is_tensor(donor):
            first = donor[0] if isinstance(donor, T.Group) else donor
            t = _tensor_of(arr, dtype_of[key]).to(
                device if device is not None else first.device)
            grad = first.requires_grad and t.is_floating_point()
            values[p] = ([t[i].clone().requires_grad_(grad)
                          for i in range(t.shape[0])]
                         if isinstance(donor, T.Group)
                         else t.requires_grad_(grad))
        elif isinstance(donor, (bool, np.bool_)):
            values[p] = bool(arr)
        elif isinstance(donor, int):
            values[p] = int(arr)
        elif isinstance(donor, float):
            values[p] = float(arr)
        else:
            values[p] = arr

    if shardings is not None:
        for p, donor in items:
            if not (isinstance(donor, shd.Placed)
                    or torch.is_tensor(T.first(donor))) and tuple(
                        T.at(shardings, p).spec):
                raise ValueError(f"{SEP.join(map(str, p))}: a non-tensor "
                                 "leaf takes P()")
        return T.unflatten([p for p, _ in items],
                           [values[p] for p, _ in items])

    def remake(module, tree):
        dev = device if device is not None else module.device
        new = type(module)(module.cfg, device=dev)
        with torch.no_grad():
            for dst, src in zip(T.leaves(new), T.leaves(tree)):
                if tuple(dst.shape) != tuple(src.shape):
                    raise ValueError(f"checkpoint shape {tuple(src.shape)} "
                                     f"for a parameter of shape "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
        new.requires_grad_(any(p.requires_grad for p in module.parameters()))
        return new

    return T.rebuild(like, values, on_module=remake)


def _shardings(tree):
    """(path, NamedSharding) over a tree of them."""
    if isinstance(tree, shd.NamedSharding):
        return [((), tree)]
    return [((k,) + p, sh) for k, v in tree.items()
            for p, sh in _shardings(v)]


class AsyncCheckpointer:
    """Background writer: `save()` snapshots to host synchronously,
    serialisation happens on the writer thread. `wait()` drains. At most
    one snapshot waits while another is written (a second `save` blocks):
    a full train state of a 1B-parameter model is 13.4 GB on the host."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: list[BaseException] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, tree_host = item
            try:
                save(self.root, step, tree_host, keep=self.keep)
            except BaseException as e:  # surfaced on wait()
                self._err.append(e)
            finally:
                self._q.task_done()

    def save(self, step: int, tree) -> None:
        items = T.ref_items(tree)
        host = T.unflatten([p for p, _ in items],
                           [_host_leaf(leaf) for _, leaf in items])
        self._q.put((step, host))

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err[0]

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join()
