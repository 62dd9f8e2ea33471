"""The port's launchers on the CPU (``repro_torch.launch.train`` /
``serve``): a REDUCED MoE run of 4 steps with a checkpoint directory,
run twice -- the second resumes at step 4, trains no step and ends with the
first run's parameters --, a serving run of 4 requests, and the mesh
flags: ``--mesh 1x2 --vp-loss`` trains on a logical mesh with the
vocab-parallel loss and logs the plain run's losses, ``--vp-loss`` alone
is the plain loss, and a mesh over other devices than the state's
raises."""
import pytest
import torch

from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import tree as T

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

TRAIN = ["--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu",
         "--steps", "4", "--batch", "2", "--seq", "32"]


def test_train_launcher_resumes(tmp_path, capsys):
    args = TRAIN + ["--ckpt", str(tmp_path)]
    first = train_mod.main(args)
    assert first["step"] == 4
    assert ckpt.all_steps(str(tmp_path)) == [2, 3, 4]      # every step, keep 3
    log = capsys.readouterr().out
    assert "step      0" in log and "step      3" in log
    second = train_mod.main(args)
    assert second["step"] == 4
    assert "step " not in capsys.readouterr().out            # no step ran
    for a, b in zip(T.leaves(first["params"]), T.leaves(second["params"])):
        assert torch.equal(a, b)
    assert first["params"].cfg.name == "granite-moe-reduced"


def test_serve_launcher_runs(capsys):
    served = serve_mod.main(["--arch", "granite-moe-1b-a400m", "--device",
                             "cpu", "--requests", "4", "--docs", "2000",
                             "--tokens", "3"])
    assert served == 4
    assert "served 4 requests" in capsys.readouterr().out


class _Picked(Exception):
    pass


def test_serve_reduced_flag_switches_off(monkeypatch):
    """--reduced is on by default (the reference's); --no-reduced serves
    the FULL config (stopped here where the weights would be drawn)."""
    from repro_torch.models import transformer as tt

    def pick(cfg, **kw):
        raise _Picked(cfg.name)

    monkeypatch.setattr(tt, "init", pick)
    for argv, want in (([], "granite-moe-reduced"),
                       (["--reduced"], "granite-moe-reduced"),
                       (["--no-reduced"], "granite-moe-1b-a400m")):
        with pytest.raises(_Picked, match=want):
            serve_mod.main(["--arch", "granite-moe-1b-a400m", "--device",
                            "cpu", "--docs", "100", *argv])


def _losses(argv, capsys):
    state = train_mod.main(TRAIN + argv)
    out = capsys.readouterr().out
    return state, [float(line.split("loss")[1].split()[0])
                   for line in out.splitlines() if line.startswith("step ")]


@pytest.mark.parametrize("flag", [["--mesh", "1x2", "--vp-loss"],
                                  ["--vp-loss"]])
def test_mesh_flags_train_as_the_plain_run(flag, capsys):
    _, plain = _losses([], capsys)
    state, got = _losses(flag, capsys)
    assert state["step"] == 4 and len(got) == len(plain) == 2
    if flag == ["--vp-loss"]:                 # no mesh: the plain loss
        assert got == plain
    else:
        assert got == pytest.approx(plain, rel=1e-5)


def test_mesh_of_other_devices_raises(monkeypatch):
    from repro_torch.launch import mesh as mesh_mod
    make = mesh_mod.make_mesh
    monkeypatch.setattr(mesh_mod, "make_mesh", lambda shape, axes, devices:
                        make(shape, axes, devices=["meta"] * len(devices)))
    with pytest.raises(ValueError, match="more than one type"):
        train_mod.main(TRAIN + ["--mesh", "2x2"])


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                        "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.main(["--requests", "1"])
