"""The port's launchers on the CPU (``repro_torch.launch.train`` /
``serve``): a REDUCED MoE run of 4 steps with a checkpoint directory,
run twice -- the second resumes at step 4, trains no step and ends with the
first run's parameters --, a serving run of 4 requests, and the flags that
wait for ROADMAP queue 1's training scale-out."""
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


@pytest.mark.parametrize("flag", [["--mesh", "2x2"], ["--vp-loss"]])
def test_scale_out_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="training scale-out"):
        train_mod.main(TRAIN + flag)


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                        "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.main(["--requests", "1"])
