"""The trainer's MFU: nerf_tpu_torch.utils.flops against nerf_tpu.utils.flops
on the same weights, and the MFU of the CPU trainer's epoch lines and
metrics log against the formula.

The FLOP count is an integer sum of 2 x in x out products, so the two
packages must agree exactly; the logged MFU must equal
steps / Time/epoch x FLOPs / peak to float rounding, and the printed one
that value to its one decimal.
"""

import os
import re

import numpy as np
import pytest

from torch_port_common import configs, jax_variables, port_models
from nerf_tpu.utils import flops as jflops
import nerf_tpu_torch.cli.trainer as trainer_mod
from nerf_tpu_torch.cli.flags import get_parser
from nerf_tpu_torch.cli.trainer import train
from nerf_tpu_torch.utils import flops
from nerf_tpu_torch.utils.metrics import read_scalars

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
MODELS = {"vanilla": {}, "ref": dict(model="ref"), "mip": dict(model="mip"),
          "ipe": dict(use_ipe=True)}
WIDTHS = {"narrow": dict(nerf_width=32, prop_width=32),
          "default": dict(nerf_width=256, prop_width=256)}
SAMPLES = [dict(n_coarse=8, n_fine=16, ray_batch=32),
           dict(n_coarse=64, n_fine=128, ray_batch=1024),
           dict(n_coarse=48, n_fine=96, ray_batch=4096)]
_VARIABLES = {}


def _variables(model: str, width: str):
    if (model, width) not in _VARIABLES:
        jcfg, _ = configs(**MODELS[model], **WIDTHS[width])
        _VARIABLES[model, width] = jax_variables(jcfg, seed=3)
    return _VARIABLES[model, width]


@pytest.mark.parametrize("samples", SAMPLES, ids=lambda s: str(s["n_fine"]))
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("model", MODELS)
def test_train_step_flops_equals_jax(model, width, samples):
    """The same count as nerf_tpu's on the weights carried across by the
    bridge, and the MFU formula on top of it."""
    variables = _variables(model, width)
    jcfg, cfg = configs(**MODELS[model], **WIDTHS[width], **samples)
    models = port_models(cfg, variables)
    want = jflops.train_step_flops(jcfg, variables)
    assert flops.train_step_flops(cfg, models) == want
    assert (models[1] is None) == (model == "mip")
    rays_s = 123_456.0
    assert flops.mfu(cfg, models, rays_s) == pytest.approx(
        rays_s / cfg.ray_batch * want / 989e12, rel=1e-15)
    assert jflops.mfu(jcfg, variables, rays_s, peak_flops=989e12) == \
        pytest.approx(flops.mfu(cfg, models, rays_s), rel=1e-15)


def test_default_vanilla_step_flops():
    """The default step (1024 rays, 64 + 128 samples, 256 wide): the fine
    net's and the proposal net's multiply-adds per point, three passes."""
    _, cfg = configs(nerf_width=256, prop_width=256, n_coarse=64, n_fine=128)
    models = port_models(cfg, _variables("vanilla", "default"))
    macs = [sum(p.numel() for p in m.parameters() if p.dim() == 2)
            for m in models]
    assert macs == [flops._mac_per_point(m) for m in models]
    assert flops.train_step_flops(cfg, models) == \
        2 * 1024 * 3 * (128 * macs[0] + 64 * macs[1])


def _argv(tmp_path, *extra):
    return ["--dataset_root", FIXTURES, "--dataset_name", "lego_mini",
            "--img_scale", "1.0", "-w", "--sample_ray_num", "32",
            "--nerf_net_width", "32", "--prop_net_width", "32",
            "--coarse_sample_pnum", "8", "--fine_sample_pnum", "16",
            "--eval_chunk", "64", "--epochs", "3", "--output_time", "100",
            "--output_dir", str(tmp_path / "out"),
            "--log_dir", str(tmp_path / "logs"), "--no_tensorboard", *extra]


@pytest.mark.parametrize("flag", [[], ["-t"], ["-m"]])
def test_trainer_prints_and_logs_mfu(tmp_path, monkeypatch, capsys, flag):
    """Every epoch line carries ``MFU: x.x%`` after the rays/s and the
    metrics log an ``MFU`` scalar per epoch, equal to the formula on the
    epoch's own time."""
    monkeypatch.chdir(tmp_path)
    trainer = train(get_parser().parse_args(_argv(tmp_path, *flag)),
                    device="cpu")
    out = capsys.readouterr().out
    lines = re.findall(r"Epoch +(\d+) / +3\t.*\t([\d,]+) rays/s\t"
                       r"MFU: ([\d.]+)%\tETA", out)
    assert [int(ep) for ep, _, _ in lines] == [0, 1, 2]
    (log,) = (tmp_path / "logs").glob("*/*/metrics.jsonl")
    mfus = read_scalars(str(log), "MFU")
    times = read_scalars(str(log), "Time/epoch")
    assert [s for s, _ in mfus] == [0, 1, 2] == [s for s, _ in times]
    step_flops = flops.train_step_flops(trainer.cfg, trainer.models)
    assert step_flops > 0
    steps = len(trainer.train_set)
    for (_, rays, printed), (_, mfu), (_, dt) in zip(lines, mfus, times):
        want = steps / dt * step_flops / flops.H100_BF16_PEAK
        assert mfu == pytest.approx(want, rel=1e-9)
        assert printed == f"{mfu * 100:.1f}"
        assert int(rays.replace(",", "")) == round(
            steps * trainer.cfg.ray_batch / dt)


def test_trainer_says_once_when_the_count_fails(tmp_path, monkeypatch,
                                                capsys):
    """A model the count does not know prints one warning and MFU 0.0%."""
    monkeypatch.chdir(tmp_path)

    def broken(cfg, models):
        raise AttributeError("no spa_block1")

    monkeypatch.setattr(trainer_mod, "train_step_flops", broken)
    train(get_parser().parse_args(_argv(tmp_path)), device="cpu")
    out = capsys.readouterr().out
    assert out.count("warning: FLOPs model failed (AttributeError: no "
                     "spa_block1); MFU will report 0.0%") == 1
    assert out.count("MFU: 0.0%") == 3
    (log,) = (tmp_path / "logs").glob("*/*/metrics.jsonl")
    assert [v for _, v in read_scalars(str(log), "MFU")] == [0.0] * 3
    assert np.isfinite([v for _, v in read_scalars(str(log),
                                                   "Train Loss")]).all()
