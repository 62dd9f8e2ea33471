"""Parity of the port's launch tools (``repro_torch.launch.{steps, dryrun,
roofline, hillclimb, _cost}``, ``distributed.collectives``' ``constrain``
and ``collective_bytes_of_hlo``, the kernels' meta branches) with the
reference's on the CPU.

* every one of the 42 cells on both production meshes: ``model_flops``,
  ``model_bytes``, ``note``, every argument leaf's shape and dtype and
  every in / out spec, leaf for leaf, against the reference's
  ``build_cell`` (one subprocess with 512 fake XLA devices, which also
  compiles the reference's mini dry run and runs its ``analyze``);
* the mini dry run's four cells (``tests/test_distributed.py``) on a
  (2, 2) mesh: the port's ``mem_args_bytes`` equals the compiled
  ``argument_size_in_bytes``, and the port's ``collective_bytes_of_hlo``
  the reference's on the compiled HLO texts (with ``-s`` the test prints
  the port's reckoned collective bytes beside the HLO's: a comparison,
  not a gate);
* ``analyze`` equal to the reference's with its constants replaced by
  the port's (the advice strings are the card's);
* the loop correction's identity holds exactly for the port's count;
* the kernels' meta branches: shapes, dtypes, the work they report, no
  launch; a ``decode_step`` and a chunked ``prefill`` trace on meta;
* the three mains on ``--arch fm``; ``constrain``; the MoE mesh restored.

Differences by design, mapped before comparing: a Python int argument (a
train state's step, the decode index) is an int32 scalar; the store's and
the ingest's ``acl`` are int32 (the uint32 bit pattern).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.distributed import collectives as tcoll
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.kernels.arena_scan import kernel as scan_mod
from repro_torch.kernels.decode_attention import decode_attention as dec_mod
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import _cost, dryrun, hillclimb, roofline, steps
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.training import tree as T

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MINI = [("qwen1.5-0.5b", "decode_32k"), ("fm", "serve_p99"),
        ("gcn-cora", "molecule"), ("rag-unified", "ingest")]
PORT_CONSTS = dict(PEAK_FLOPS=989e12, HBM_BW=3.35e12, LINK_BW=450e9,
                   HBM_PER_CHIP=80e9)
ENTRIES = [  # synthetic dry-run entries for analyze
    {"flops": 3.2e15, "bytes": 9.1e11, "coll": 3.9e11, "model_flops": 5.3e17,
     "model_bytes": 2.2e12, "temp_bytes": 14e9, "args_bytes": 2.3e9},
    {"flops": 2.0e8, "bytes": 2.1e8, "coll": 5.8e7, "model_flops": 5.2e10,
     "model_bytes": 5.2e10, "temp_bytes": 0, "args_bytes": 2e8},
    {"flops": 0.0, "bytes": 1.6e9, "coll": 0.0, "model_flops": 6.3e6,
     "model_bytes": 2.6e7, "temp_bytes": 81e9, "args_bytes": 8e8},
    {"flops": 1e12, "bytes": 1e9, "coll": 1e13, "model_flops": 0.0,
     "temp_bytes": 1, "args_bytes": 1},
]

REF_CODE = """
import json, sys
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs import ARCHS, assigned_cells
from repro.distributed.collectives import collective_bytes_of_hlo
from repro.launch.mesh import make_mesh, make_production_mesh
from repro.launch.steps import build_cell

out_dir = sys.argv[1]

def key(k):
    for a in ("key", "idx", "name"):
        if hasattr(k, a):
            return str(getattr(k, a))
    return str(k)

def entry(e):
    if e is None or isinstance(e, str):
        return e
    e = tuple(e)
    return e[0] if len(e) == 1 else list(e)

def leaves(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return flat

def specs(tree):
    if tree is None:
        return None
    return {"/".join(key(k) for k in p): [entry(e) for e in s.spec]
            for p, s in leaves(tree, lambda x: isinstance(x, NamedSharding))}

cells = assigned_cells() + [("rag-unified", s) for s in ARCHS["rag-unified"].shapes]
meta = {}
for mesh_name, multi in (("pod256_16x16", False), ("pod512_2x16x16", True)):
    mesh = make_production_mesh(multi_pod=multi)
    for a, s in cells:
        c = build_cell(a, s, mesh)
        meta[f"{a}|{s}|{mesh_name}"] = {
            "model_flops": c.model_flops, "model_bytes": c.model_bytes,
            "note": c.note,
            "args": {"/".join(key(k) for k in p): [list(x.shape), str(x.dtype)]
                     for p, x in leaves(c.args)},
            "in": specs(c.in_shardings), "out": specs(c.out_shardings)}

mini = {}
mesh = make_mesh((2, 2), ("data", "model"))
for a, s in %r:
    c = build_cell(a, s, mesh)
    comp = jax.jit(c.fn, in_shardings=c.in_shardings,
                   out_shardings=c.out_shardings).lower(*c.args).compile()
    text = comp.as_text()
    path = f"{out_dir}/{a}_{s}.hlo"
    with open(path, "w") as f:
        f.write(text)
    mini[f"{a}|{s}"] = {"args_bytes": int(comp.memory_analysis().argument_size_in_bytes),
                        "coll": collective_bytes_of_hlo(text), "hlo": path}

import repro.launch.roofline as R
for name, v in %r.items():
    setattr(R, name, v)
analyze = [R.analyze(e, n) for e in %r for n in (1, 256, 512)]
with open(f"{out_dir}/ref.json", "w") as f:
    json.dump({"meta": meta, "mini": mini, "analyze": analyze}, f)
print("REF_OK")
""" % (MINI, PORT_CONSTS, ENTRIES)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's cells, mini dry run and analyze, from one
    subprocess with 512 fake XLA devices."""
    out_dir = tmp_path_factory.mktemp("ref_launch")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_CODE),
                          str(out_dir)], capture_output=True, text=True,
                         env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "REF_OK" in run.stdout
    with open(out_dir / "ref.json") as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def moe_mesh_restored():
    """build_cell sets the process-global MoE mesh: every test leaves it as
    it found it."""
    saved = dict(tmoe._MOE_MESH)
    yield
    tmoe._MOE_MESH.clear()
    tmoe._MOE_MESH.update(saved)


# ---------------------------------------------------------------------------
# the port's cells as the reference's metadata
# ---------------------------------------------------------------------------

def _dtype_name(leaf) -> str:
    if isinstance(leaf, int):
        return "int32"                 # a Python int: an int32 scalar
    return str(T.first(leaf).dtype).replace("torch.", "")


def _port_args(cell) -> dict:
    out = {}
    for i, arg in enumerate(cell.args):
        for path, leaf in T.ref_items(arg):
            out["/".join(map(str, (i,) + path))] = [list(T.shape(leaf)),
                                                    _dtype_name(leaf)]
    return out


def _entry(e):
    if e is None or isinstance(e, str):
        return e
    return e[0] if len(e) == 1 else list(e)


def _port_specs(tree) -> dict | None:
    if tree is None:
        return None
    out = {}

    def walk(node, path):
        if isinstance(node, NamedSharding):
            out["/".join(map(str, path))] = [_entry(e) for e in node.spec]
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            for i, v in enumerate(node):
                walk(v, path + (i,))
    walk(tree, ())
    return out


def _ref_args(args: dict) -> dict:
    """The reference's leaves with the port's differences by design: the
    uint32 acl columns are int32."""
    return {p: [shape, "int32" if dt == "uint32" else dt]
            for p, (shape, dt) in args.items()}


@pytest.mark.parametrize("multi", [False, True], ids=["pod256", "pod512"])
def test_cells_match_reference(ref, multi):
    mesh_name = dryrun.MESH_NAMES[multi]
    mesh = dryrun.production_mesh(multi)
    bad = []
    for arch_id, shape in dryrun.all_cells():
        want = ref["meta"][f"{arch_id}|{shape}|{mesh_name}"]
        cell = steps.build_cell(arch_id, shape, mesh)
        got = {"model_flops": cell.model_flops,
               "model_bytes": cell.model_bytes, "note": cell.note,
               "args": _port_args(cell),
               "in": _port_specs(cell.in_shardings),
               "out": _port_specs(cell.out_shardings)}
        want = dict(want, args=_ref_args(want["args"]))
        for k in got:
            if got[k] != want[k]:
                bad.append((arch_id, shape, k))
    assert not bad, bad


# ---------------------------------------------------------------------------
# the mini dry run against XLA's compiled programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id,shape", MINI)
def test_mini_dryrun_args_and_hlo_parser(ref, arch_id, shape):
    mesh = make_mesh((2, 2), ("data", "model"), devices=["meta"] * 4)
    res = dryrun.run_cell(arch_id, shape, "mini_2x2", mesh)
    want = ref["mini"][f"{arch_id}|{shape}"]
    # XLA pads nothing in these programs. The gap is exactly the arguments
    # the step never reads, which jax.jit prunes (keep_unused=False): FM
    # serve's labels, (512,) int32 split over the 2 data shards
    unused = {"fm|serve_p99": 512 // 2 * 4}
    assert res["mem_args_bytes"] - unused.get(f"{arch_id}|{shape}", 0) \
        == want["args_bytes"]
    with open(want["hlo"]) as f:
        text = f.read()
    assert tcoll.collective_bytes_of_hlo(text) == want["coll"]
    print(f"\n{arch_id}|{shape} (2x2) collective bytes, port reckoned "
          f"{res['collective_bytes']} / reference HLO {want['coll']}")


def test_hlo_parser_kinds():
    text = textwrap.dedent("""
        %a = f32[128,256]{1,0} all-gather(%y), dims={0}
        %s = (f32[4]{0}, bf16[2,3]{1,0}) all-reduce-start(%p, %q)
        %d = (f32[4]{0}, bf16[2,3]{1,0}) all-reduce-done(%s)
        %r = s32[8]{0} reduce-scatter(%z)
        %t = u8[3]{0} collective-permute(%w)
        %x = f32[9]{0} add(%u, %v)
    """)
    assert tcoll.collective_bytes_of_hlo(text) == {
        "all-gather": 131072, "all-reduce": 28, "reduce-scatter": 32,
        "all-to-all": 0, "collective-permute": 3}


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

def test_constants_are_the_h100s():
    for name, v in PORT_CONSTS.items():
        assert getattr(roofline, name) == v


def test_analyze_matches_reference(ref):
    got = [roofline.analyze(e, n) for e in ENTRIES for n in (1, 256, 512)]
    for g, w in zip(got, ref["analyze"], strict=True):
        g, w = dict(g), dict(w)
        assert g.pop("advice") and w.pop("advice")
        assert g == w


@pytest.mark.parametrize("arch_id,shapes", [
    ("qwen3-4b", ("train_4k", "prefill_32k", "decode_32k")),
    ("granite-moe-1b-a400m", ("train_4k", "decode_32k"))])
def test_loop_correction_identity(arch_id, shapes):
    """c(L) = c(1) + (L - 1) (c(2) - c(1)) for the port's count: the eager
    loop counts every layer (a REDUCED config, 4 layers, the cells'
    shapes cut to a small batch)."""
    arch = tconfigs.get(arch_id)
    mesh = make_mesh((2, 2), ("data", "model"), devices=["meta"] * 4)
    for shape in shapes:
        small = dict(arch.shapes[shape], batch=2,
                     seq=min(arch.shapes[shape]["seq"], 128))
        counts = {}
        for n_layers in (1, 2, 4):
            cfg = dataclasses.replace(arch.reduced, n_layers=n_layers,
                                      dtype="bfloat16")
            a = dataclasses.replace(arch, full=cfg,
                                    shapes={shape: small})
            fam = {"train": steps._lm_train_cell,
                   "prefill": steps._lm_prefill_cell,
                   "decode": steps._lm_decode_cell}[small["kind"]]
            cell = fam(a, small, mesh, steps.Draw())
            counts[n_layers] = _cost.count(cell.fn, *cell.args)[0].flops
        assert counts[4] == counts[1] + 3 * (counts[2] - counts[1]), counts
        assert counts[2] > counts[1]


def test_corrected_cell_marks_lm_entries():
    mesh = make_host_mesh(1, 1, device="meta")
    e = roofline.corrected_cell("qwen1.5-0.5b", "long_500k", "one", mesh, {})
    assert e["corrected"] and e["raw_flops"] == e["flops"] > 0
    f = roofline.corrected_cell("fm", "serve_p99", "one", mesh, {})
    assert not f["corrected"] and "raw_flops" not in f


# ---------------------------------------------------------------------------
# the counter and the kernels' meta branches
# ---------------------------------------------------------------------------

def test_counter_conventions():
    a = torch.empty(64, 32, device="meta")
    w = torch.empty(32, 16, device="meta")

    def fn(a, w):
        v = a.view(32, 64).T          # views: no bytes
        y = torch.exp(a @ w)          # 2*64*32*16 flops; 64*16 exps
        del v
        z = torch.empty(1 << 20, device="meta")   # 4 MiB, allocated only
        del z
        return y.sum()

    cost, _ = _cost.count(fn, a, w)
    assert cost.flops == 2 * 64 * 32 * 16
    assert cost.transcendentals == 64 * 16
    # mm reads a, w and writes y; exp reads and writes y; sum reads y
    assert cost.bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16) \
        + 4 * 2 * 64 * 16 + 4 * (64 * 16 + 1)
    assert cost.peak_bytes >= 4 << 20
    assert cost.by_op["mm"][0] == cost.flops


def test_counter_gather_reads_what_it_gathers():
    table = torch.empty(1_000_000, 64, device="meta")
    ids = torch.empty(512, dtype=torch.int64, device="meta")
    cost, out = _cost.count(lambda t, i: t[i], table, ids)
    assert out.shape == (512, 64)
    assert cost.bytes == 512 * 8 + 2 * 512 * 64 * 4
    cost, _ = _cost.count(lambda t, i: torch.nn.functional.embedding(i, t),
                          table, ids)
    assert cost.bytes == 512 * 8 + 2 * 512 * 64 * 4


def test_flash_meta_branch_reports_work():
    B, S, KV, G, hd = 8, 2048, 8, 4, 128
    q = torch.empty(B, S, KV * G, hd, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, S, KV, hd, dtype=torch.bfloat16, device="meta")
    before = fa_mod.LAUNCHES
    cost, out = _cost.count(lambda q, k: fa_ops.flash_attention(q, k, k, KV),
                            q, k)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.device.type == "meta" and fa_mod.LAUNCHES == before
    assert cost.launches == {"flash_attention": 1}
    # PERF.md's kernel table: 275.0 GFLOP at this shape
    assert cost.by_op["flash_attention"][0] == 4 * hd * (S * (S + 1) // 2) \
        * B * KV * G
    assert round(cost.by_op["flash_attention"][0] / 1e9, 1) == 275.0
    assert cost.by_op["flash_attention"][1] == 2 * (2 * q.numel()
                                                    + 2 * k.numel())


def test_decode_meta_branch_reports_work():
    B, S, KV, G, hd, live = 8, 2064, 8, 4, 128, 2049
    q = torch.empty(B, KV * G, hd, dtype=torch.bfloat16, device="meta")
    kc = torch.empty(B, S, KV, hd, dtype=torch.bfloat16, device="meta")
    lengths = torch.empty(B, dtype=torch.int32, device="meta")
    before = dec_mod.LAUNCHES
    cost, out = _cost.count(lambda q, kc, ln: dec_ops.decode_attention(
        q, kc, kc, ln, KV, live=live), q, kc, lengths)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert dec_mod.LAUNCHES == before
    flops, nbytes = cost.by_op["decode_attention"]
    assert flops == 4 * hd * KV * G * B * live
    # PERF.md's kernel table: 67.3 MB at this shape
    assert nbytes == 2 * B * live * KV * hd * 2 + q.numel() * 2 \
        + B * KV * G * (hd + 2) * 4
    assert round(nbytes / 1e6, 1) == 67.3
    acc, m, l = dec_mod.decode_attention_meta(q.reshape(B, KV, G, hd))
    assert (acc.shape, m.shape, l.shape) == ((B, KV, G, hd), (B, KV, G, 1),
                                             (B, KV, G, 1))
    assert acc.dtype == m.dtype == torch.float32


def test_arena_scan_meta_branch_reports_work():
    B, N, D, k = 8, 4096, 64, 10
    q = torch.empty(B, D, device="meta")
    emb = torch.empty(N, D, device="meta")
    meta = torch.empty(N, 4, dtype=torch.int32, device="meta")
    gids = torch.empty(B, dtype=torch.int32, device="meta")
    preds = torch.empty(1, 4, dtype=torch.int32, device="meta")
    before = scan_mod.LAUNCHES
    cost, (s, i) = _cost.count(lambda *a: scan_mod.arena_scan(*a, k), q, emb,
                               meta, gids, preds)
    assert (s.shape, s.dtype, i.dtype) == ((B, k), torch.float32, torch.int32)
    assert scan_mod.LAUNCHES == before
    assert cost.by_op["arena_scan"] == (
        2 * B * N * D, N * (4 * D + 16) + B * D * 4 + B * 4 + 16 + B * k * 8)


@pytest.mark.parametrize("arch_id", ["qwen3-4b", "granite-moe-1b-a400m"])
def test_decode_and_chunked_prefill_trace_on_meta(arch_id):
    cfg = dataclasses.replace(tconfigs.get(arch_id).reduced,
                              attn_impl="chunked", dtype="bfloat16")
    model = tt.Transformer(cfg, device="meta")
    tokens = torch.empty(2, 64, dtype=torch.int32, device="meta")
    cost, (logits, cache) = _cost.count(
        lambda m, t: tt.prefill(m, cfg, t, cache_len=80), model, tokens)
    assert logits.shape == (2, cfg.vocab_size)
    assert cost.launches == {"flash_attention": cfg.n_layers}
    tok = torch.empty(2, dtype=torch.int32, device="meta")
    cost, (logits, cache2) = _cost.count(
        lambda m, c, t: tt.decode_step(m, cfg, t, c, 64), model, cache, tok)
    assert cache2 is cache and logits.shape == (2, cfg.vocab_size)
    assert cost.launches == {"decode_attention": cfg.n_layers}
    # every other device still raises: no engine for it
    assert cost.flops > 0


# ---------------------------------------------------------------------------
# the mains, constrain, isolation
# ---------------------------------------------------------------------------

def test_mains_on_fm(tmp_path, capsys):
    dr = tmp_path / "dryrun.json"
    assert dryrun.main(["--arch", "fm", "--out", str(dr)]) == 0
    res = json.loads(dr.read_text())
    assert len(res) == 8 and all(r["ok"] for r in res.values())
    one = res["fm|serve_p99|pod256_16x16"]
    assert {"hlo_flops", "hlo_bytes", "transcendentals", "mem_args_bytes",
            "mem_out_bytes", "mem_temp_bytes", "mem_code_bytes",
            "mem_alias_bytes", "collective_bytes", "lower_s", "compile_s",
            "model_flops", "note"} <= set(one)
    assert set(one["collective_bytes"]) == set(dryrun.KINDS)
    rf = tmp_path / "roofline.json"
    roofline.main(["--arch", "fm", "--out", str(rf), "--markdown"])
    text = capsys.readouterr().out
    assert text.count("fm|") >= 16 and "| fits HBM |" in text
    rows = json.loads(rf.read_text())
    assert all("analysis" in e for e in rows.values())
    hc = tmp_path / "hc.json"
    entry = hillclimb.main(["--cell", "fm|serve_p99", "--tag", "t0",
                            "--out", str(hc)])
    log = json.loads(hc.read_text())
    assert len(log) == 1 and log[0]["tag"] == "t0"
    assert {"analysis", "env", "cell", "mesh", "coll_by_kind"} <= set(log[0])
    assert entry["cell"] == "fm|serve_p99"


def test_constrain():
    mesh = make_host_mesh(2, 2)
    x = torch.ones(4, 4)
    assert tcoll.constrain(x, mesh, P("data", "model")) is x
    assert tcoll.constrain(x, mesh, P(("data", "model"), None)) is x
    with pytest.raises(ValueError, match="names axis"):
        tcoll.constrain(x, mesh, P("pod", None))
    cards = make_mesh((2, 2), ("data", "model"),
                      devices=[torch.device("cpu", i) for i in range(4)])
    assert tcoll.constrain(x, cards, P("data", "model")) is x
    with pytest.raises(ValueError, match="more than one type"):
        tcoll.constrain(x, make_mesh((2,), ("data",),
                                     devices=["cpu", "meta"]),
                        P("data", None))


def test_moe_mesh_restored_by_run_all():
    saved = dict(tmoe._MOE_MESH)
    mesh = make_mesh((2, 2), ("data", "model"), devices=["meta"] * 4)
    results = {}
    n_fail = dryrun.run_all([("granite-moe-1b-a400m", "long_500k")],
                            [("m", mesh)], results, log=lambda s: None)
    assert n_fail == 0 and results["granite-moe-1b-a400m|long_500k|m"]["ok"]
    assert tmoe._MOE_MESH == saved
    steps.build_cell("granite-moe-1b-a400m", "long_500k", mesh)
    assert tmoe._MOE_MESH["mesh"] is mesh      # restored by the fixture


def test_cell_on_cpu_runs_with_drawn_args():
    """A cell off the meta device draws its arguments from a generator and
    runs: the same argument shapes and dtypes as on meta, finite logits (a
    REDUCED LM decode; on the CPU the decode dispatch takes the plain
    version, which reports no kernel work)."""
    arch = tconfigs.get("qwen1.5-0.5b")
    cfg = dataclasses.replace(arch.reduced, dtype="float32")
    shape = dict(arch.shapes["long_500k"], seq=96)
    a = dataclasses.replace(arch, full=cfg, shapes={"long_500k": shape})
    mesh_meta = make_host_mesh(1, 1, device="meta")
    meta_cell = steps._lm_decode_cell(a, shape, mesh_meta, steps.Draw())
    gen = torch.Generator().manual_seed(0)
    cpu_cell = steps._lm_decode_cell(a, shape, make_host_mesh(1, 1),
                                     steps.Draw("cpu", gen))
    assert _port_args(meta_cell) == _port_args(cpu_cell)
    c_cpu, (logits, _) = _cost.count(cpu_cell.fn, *cpu_cell.args)
    assert c_cpu.flops > 0 and not c_cpu.launches
    assert np.isfinite(logits.numpy()).all()
    with pytest.raises(ValueError, match="generator"):
        steps.Draw("cpu")
