"""Multi-pod dry run: reckon EVERY (arch x shape) cell on the production
meshes, on the ``meta`` device (port of ``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k

The reference lowers and compiles each cell for 256 or 512 fake devices
and reads XLA's analyses. The port has no compiler between it and the
card: it runs the cell's step once on ``meta`` tensors under
`launch._cost` (shapes only, nothing computed) and reckons the rest from
the cell's shardings. Results cache to ``results/torch_dryrun.json``
incrementally (one entry per arch/shape/mesh, the reference's keys);
finished cells are skipped unless --force. ``launch/roofline.py`` reads the
same entries.

What each key means in the port:

* ``hlo_flops``, ``hlo_bytes``, ``transcendentals``: the counted global
  work of one step (`launch._cost`'s conventions) over the mesh's device
  count: per device, as XLA reports them for an SPMD program, on the
  assumption that the work splits evenly;
* ``mem_temp_bytes``: the count's peak of live storage beyond the
  arguments (outputs included) over the device count, the same way;
* ``mem_args_bytes`` / ``mem_out_bytes``: exact per device, from each
  leaf's shard shape under its sharding (ceil division: the largest
  device's piece); a Python int argument or result (a train state's step,
  the decode index) is an int32 scalar; an output without a sharding is
  reckoned replicated;
* ``mem_alias_bytes``: the per-device bytes of outputs that are arguments
  updated in place (a train state's parameters, the decode cache);
* ``mem_code_bytes`` 0 and ``compile_s`` 0.0: nothing compiles per cell;
  ``lower_s`` is the seconds of the counted trace;
* ``collective_bytes``: the reference's five kinds, per device, reckoned
  by `collectives_of` (below), each collective counted by its result
  shape as ``collective_bytes_of_hlo`` counts it.

A cell's trace is reused across meshes when its arguments' shapes are the
same on both and its op stream cannot depend on the mesh: never for an
MoE LM whose dispatch runs shard by shard on the MoE mesh (``moe_impl``
"scatter_shmap"; the FULL configs' "einsum" never reads the mesh) or
under a ``REPRO_*`` toggle.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, assigned_cells, get
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.launch import _cost
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.training import tree as T

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results")
DEFAULT_OUT = "torch_dryrun.json"
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
MESH_NAMES = {False: "pod256_16x16", True: "pod512_2x16x16"}
TOGGLES = ("REPRO_LM_VP_LOSS", "REPRO_RAG_SHARDED")


def production_mesh(multi_pod: bool = False):
    """The reference's production mesh over ``meta`` devices: (data=16,
    model=16), or (pod=2, data=16, model=16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=["meta"] * math.prod(shape))


def cell_key(arch_id: str, shape: str, mesh_name: str) -> str:
    return f"{arch_id}|{shape}|{mesh_name}"


# ---------------------------------------------------------------------------
# per-device bytes of a tree under its shardings
# ---------------------------------------------------------------------------

def _leaf_bytes(leaf, sh) -> int:
    """Bytes of the largest device's piece of one reference leaf (a
    tensor, a `Group` read as its stack, or a Python int: an int32
    scalar)."""
    if isinstance(leaf, (int, float)) and not isinstance(leaf, bool):
        return 4
    first = T.first(leaf)
    shape = T.shape(leaf)
    if sh is not None:
        spec = list(sh.spec) + [None] * (len(shape) - len(sh.spec))
        shape = tuple(-(-d // _group_size(sh.mesh, ax))
                      for d, ax in zip(shape, spec))
    return math.prod(shape) * first.element_size()


def _group_size(mesh, ax) -> int:
    if ax is None:
        return 1
    return math.prod(mesh.shape[a] for a in ((ax,) if isinstance(ax, str)
                                             else ax))


def _sharding_at(sh, path):
    for key in path:
        if sh is None or isinstance(sh, NamedSharding):
            break
        sh = sh[key]
    return sh if isinstance(sh, NamedSharding) else None


def tree_bytes(tree, shardings) -> int:
    """Per-device bytes of ``tree`` (args or outputs, a tuple) under the
    matching tree of `NamedSharding` (None: replicated)."""
    total = 0
    for i, node in enumerate(tree):
        sh = None if shardings is None else shardings[i]
        for path, leaf in T.ref_items(node):
            if leaf is None:
                continue
            total += _leaf_bytes(leaf, _sharding_at(sh, path))
    return total


def _alias_bytes(args, out, out_shardings) -> int:
    """Per-device bytes of the outputs whose storage is an argument's."""
    arg_keys = {t.untyped_storage()._cdata for t in _cost.arg_tensors(args)}
    total = 0
    for i, node in enumerate(out):
        sh = None if out_shardings is None else out_shardings[i]
        for path, leaf in T.ref_items(node):
            first = T.first(leaf)
            if torch.is_tensor(first) and \
                    first.untyped_storage()._cdata in arg_keys:
                total += _leaf_bytes(leaf, _sharding_at(sh, path))
    return total


# ---------------------------------------------------------------------------
# collectives by rule
# ---------------------------------------------------------------------------

def _param_items(cell):
    """(path, leaf, sharding) of the cell's parameters: a train cell's
    state["params"], else its first argument (a model)."""
    arg0, sh0 = cell.args[0], cell.in_shardings[0]
    train = isinstance(arg0, dict) and "params" in arg0
    params, psh = (arg0["params"], sh0["params"]) if train else (arg0, sh0)
    if not isinstance(params, torch.nn.Module):
        return train, []          # the RAG store: no parameters
    return train, [(path, leaf, _sharding_at(psh, path))
                   for path, leaf in T.ref_items(params)]


def _is_sharded(sh, axes=None) -> bool:
    """Whether ``sh`` splits its leaf over an axis (of ``axes``) of more
    than one device."""
    for entry in sh.spec:
        for a in (() if entry is None else (entry,) if isinstance(entry, str)
                  else entry):
            if (axes is None or a in axes) and sh.mesh.shape[a] > 1:
                return True
    return False


def collectives_of(cell, mesh) -> dict[str, int]:
    """The collectives one step of ``cell`` needs on ``mesh``, per device,
    each counted by its result shape, by this rule:

    * parameters (FSDP): a parameter sharded over any axis other than
      "model" is all-gathered over those axes for each read -- once in a
      forward-only cell, twice in a train step with ``remat`` (forward,
      then the recomputed forward; the backward reuses the latter), once
      without; the result is the parameter with only its "model" split;
    * gradients (train): each parameter sharded over any axis is
      reduce-scattered to its shard (the parameter's dtype); a replicated
      parameter's gradient is all-reduced whole over the data-parallel
      shards;
    * tensor parallelism (LM, "model" > 1): each layer's row-parallel
      products (``wo``, ``w_down``) all-reduce their (B / dp, S, d_model)
      output in the compute dtype, S = 1 in decode; a train step does it
      three times (forward, recomputed forward, backward of the
      column-parallel inputs);
    * the train step's scalar all-reduces: the loss and the global
      gradient norm, f32;
    * the port's explicit shard-wise collectives: the vocab-parallel loss
      (``REPRO_LM_VP_LOSS``) all-reduces (B / dp, S) f32 three times over
      "model" in the forward (max, sum of exp, gold) and twice in the
      backward; the sharded RAG query (``REPRO_RAG_SHARDED``) all-gathers
      its shards' lists (`sharded_collective_bytes`, the reference's HLO
      count).
    """
    out = {k: 0 for k in KINDS}
    arch = get(cell.arch_id)
    n_dev = math.prod(mesh.shape.values())
    if n_dev == 1:
        return out
    dp_axes = tuple(a for a in mesh.axis_names if a != "model")
    n_model = mesh.shape.get("model", 1)
    shape = arch.shapes[cell.shape_name]
    train, items = _param_items(cell)
    remat = bool(getattr(arch.full, "remat", False))
    reads = 2 if train and remat else 1
    for path, leaf, sh in items:
        esz = T.first(leaf).element_size()
        dims = T.shape(leaf)
        if sh is None:
            continue
        if _is_sharded(sh, dp_axes):
            spec = list(sh.spec) + [None] * (len(dims) - len(sh.spec))
            gathered = math.prod(
                d // (n_model if ax is not None and "model" in
                      ((ax,) if isinstance(ax, str) else ax) else 1)
                for d, ax in zip(dims, spec))
            out["all-gather"] += reads * gathered * esz
        if train:
            if _is_sharded(sh):
                out["reduce-scatter"] += _leaf_bytes(leaf, sh)
            elif n_dev > 1:
                out["all-reduce"] += math.prod(dims) * esz
    if train:
        out["all-reduce"] += 2 * 4
    if arch.family == "lm" and n_model > 1:
        cfg = arch.full
        n_dp = math.prod(mesh.shape[a] for a in dp_axes)
        b = max(1, shape["batch"] // n_dp)
        s = 1 if shape["kind"] == "decode" else shape["seq"]
        esz = torch.empty((), dtype=_dtype(cfg.dtype)).element_size()
        passes = 3 if train else 1
        out["all-reduce"] += passes * 2 * cfg.n_layers * b * s \
            * cfg.d_model * esz
        if train and os.environ.get("REPRO_LM_VP_LOSS", "0") == "1":
            out["all-reduce"] += 5 * b * s * 4
    shape = arch.shapes[cell.shape_name]
    if shape["kind"] == "rag_query" and \
            os.environ.get("REPRO_RAG_SHARDED", "0") == "1":
        from repro_torch.kernels.arena_scan.sharded import \
            sharded_collective_bytes
        out["all-gather"] += sharded_collective_bytes(
            n_dev, shape["batch"], shape["k"], arch.full.capacity // n_dev)
    return out


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def _signature(cell) -> tuple:
    return tuple((tuple(T.shape(leaf)),
                  str(getattr(T.first(leaf), "dtype", type(leaf))))
                 for path, leaf in T.ref_items(list(cell.args)))


def _reusable(cell) -> bool:
    arch = get(cell.arch_id)
    shmap = arch.family == "lm" and arch.full.is_moe \
        and arch.full.moe_impl == "scatter_shmap"
    return not shmap and not any(os.environ.get(t, "0") == "1"
                                 for t in TOGGLES)


def measure(cell, mesh, trace_cache: dict | None = None) -> dict:
    """The cell's counted work (global `Cost`), per-device memory and
    collectives on ``mesh``; a trace is reused from ``trace_cache`` where
    the cell allows it (see the module)."""
    n_dev = math.prod(mesh.shape.values())
    key = (cell.arch_id, cell.shape_name, _signature(cell))
    t0 = time.perf_counter()
    hit = trace_cache.get(key) if trace_cache is not None else None
    if hit is None:
        cost, out = _cost.count(cell.fn, *cell.args)
        out = out if isinstance(out, tuple) else (out,)
        out_sh = cell.out_shardings
        if out_sh is not None and not isinstance(out_sh, tuple):
            out_sh = (out_sh,)
        hit = (cost, tree_bytes(out, out_sh),
               _alias_bytes(cell.args, out, out_sh))
        del out
        if trace_cache is not None and _reusable(cell):
            trace_cache[key] = hit
    cost, out_bytes, alias_bytes = hit
    return {"cost": cost, "n_dev": n_dev,
            "args_bytes": tree_bytes(cell.args, cell.in_shardings),
            "out_bytes": out_bytes, "alias_bytes": alias_bytes,
            "coll": collectives_of(cell, mesh),
            "trace_s": time.perf_counter() - t0}


def run_cell(arch_id: str, shape_name: str, mesh_name: str, mesh,
             trace_cache: dict | None = None) -> dict:
    cell = build_cell(arch_id, shape_name, mesh)
    m = measure(cell, mesh, trace_cache)
    cost, n = m["cost"], m["n_dev"]
    return {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": mesh_name,
        "note": cell.note,
        "model_flops": cell.model_flops,
        "model_bytes": cell.model_bytes,
        "hlo_flops": cost.flops / n,
        "hlo_bytes": cost.bytes / n,
        "transcendentals": cost.transcendentals / n,
        "mem_args_bytes": m["args_bytes"],
        "mem_out_bytes": m["out_bytes"],
        "mem_temp_bytes": -(-cost.peak_bytes // n),
        "mem_code_bytes": 0,
        "mem_alias_bytes": m["alias_bytes"],
        "collective_bytes": m["coll"],
        "lower_s": m["trace_s"],
        "compile_s": 0.0,
        "ok": True,
    }


def all_cells(include_rag: bool = True) -> list[tuple[str, str]]:
    cells = assigned_cells()
    if include_rag:
        cells += [("rag-unified", s) for s in ARCHS["rag-unified"].shapes]
    return cells


def run_all(cells, meshes, results: dict, *, force: bool = False,
            out_path: str | None = None, log=print) -> int:
    """Reckon ``cells`` on each (name, mesh) of ``meshes`` into
    ``results`` (skipping finished entries unless ``force``); returns the
    number of new failures. The MoE mesh is saved and restored around the
    run (``build_cell`` sets it)."""
    from repro_torch.models import moe
    saved = dict(moe._MOE_MESH)
    trace_cache: dict = {}
    n_fail = 0
    try:
        for mesh_name, mesh in meshes:
            for arch_id, shape_name in cells:
                key = cell_key(arch_id, shape_name, mesh_name)
                if not force and results.get(key, {}).get("ok"):
                    continue
                log(f"=== {key}")
                try:
                    res = run_cell(arch_id, shape_name, mesh_name, mesh,
                                   trace_cache)
                    tot = sum(res["collective_bytes"].values())
                    log(f"    flops={res['hlo_flops']:.3e} "
                        f"bytes={res['hlo_bytes']:.3e} coll={tot:.3e} "
                        f"temp={res['mem_temp_bytes'] / 2**30:.2f}GiB "
                        f"args={res['mem_args_bytes'] / 2**30:.2f}GiB "
                        f"(trace {res['lower_s']:.1f}s)")
                except Exception as e:
                    n_fail += 1
                    res = {"arch": arch_id, "shape": shape_name,
                           "mesh": mesh_name, "ok": False,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    log(f"    FAIL {type(e).__name__}: {str(e)[:300]}")
                results[key] = res
                if out_path:
                    with open(out_path, "w") as f:
                        json.dump(results, f, indent=1)
    finally:
        moe._MOE_MESH.clear()
        moe._MOE_MESH.update(saved)
    return n_fail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch id (default: all)")
    ap.add_argument("--shape", default=None, help="single shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--include-rag", action="store_true", default=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    out_path = args.out or os.path.join(os.path.abspath(RESULTS), DEFAULT_OUT)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    results: dict[str, dict] = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)

    cells = all_cells(args.include_rag)
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append((MESH_NAMES[False], production_mesh(False)))
    if args.mesh in ("multi", "both"):
        meshes.append((MESH_NAMES[True], production_mesh(True)))

    n_fail = run_all(cells, meshes, results, force=args.force,
                     out_path=out_path, log=lambda s: print(s, flush=True))
    ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"\n{ok}/{len(results)} cells ok, {n_fail} new failures -> {out_path}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
