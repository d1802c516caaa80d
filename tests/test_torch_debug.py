"""-b in nerf_tpu_torch against nerf_tpu: the NaN hooks name the module
that made a NaN, the module nerf_tpu's attribution names on the same
weights (through bridge.py's layer names); a clean model runs unchanged
under them; the trainer's -b launches no kernel."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _train_argv
from torch_port_common import (
    configs, jax_variables, port_models, two_camera_batch,
)
from nerf_tpu.train.pipeline import make_models as jax_make_models
from nerf_tpu.utils.debug import nan_attribution as jax_nan_attribution
from nerf_tpu_torch import bridge, ops
from nerf_tpu_torch.cli.flags import get_parser
from nerf_tpu_torch.cli.trainer import Trainer
from nerf_tpu_torch.train.step import compute_loss
from nerf_tpu_torch.utils.debug import check_finite, nan_attribution

# (model, net, the port's layer, its bridge name)
PLANTED = [("vanilla", "nerf", "lin_block2.2", "nerf"),
           ("vanilla", "prop", "layers.2", "prop"),
           ("ref", "nerf", "dir_block1.2", "ref")]


def _nerf_tpu_label(port_label: str, bridge_net: str) -> str:
    """nerf_tpu's module path of a port layer, through bridge.py."""
    layers = dict(bridge._layers(bridge_net))
    return "/".join(layers[port_label])


@pytest.mark.parametrize("model,net,layer,bridge_net", PLANTED)
def test_nan_names_the_module_nerf_tpu_names(model, net, layer, bridge_net):
    """A NaN planted in one weight of one layer: the port raises
    FloatingPointError naming ``<net>.<layer>``, and nerf_tpu's
    attribution on the same flax params names the layer that bridge.py
    maps it to."""
    jcfg, cfg = configs(model=model, white_bkg=False, bottleneck_noise=0.0,
                        use_pallas=False)
    variables = jax_variables(jcfg, seed=0, gain=1.0, bias_std=0.1)
    label = _nerf_tpu_label(layer, bridge_net)
    node = variables[net]
    for k in label.split("/"):
        node = node[k]
    node["kernel"][0, 0] = np.nan
    models = port_models(cfg, variables)
    rays, gt, jit, u = two_camera_batch(0, 8, cfg.n_coarse, cfg.n_fine)
    t = torch.from_numpy
    with nan_attribution(models):
        with pytest.raises(FloatingPointError) as e:
            compute_loss(models, t(rays), t(gt), cfg, noise=(t(jit), t(u)),
                         device="cpu")
    assert f"of {net}.{layer} (Dense)" in str(e.value)
    assert "first at indices [[" in str(e.value)
    assert not torch.is_anomaly_enabled()

    jmodel = jax_make_models(jcfg)[0 if net == "nerf" else 1]
    pos = jnp.full((4, 3), 0.1)
    dirs = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (4, 1))
    params = {"params": flax.core.unfreeze(jax.tree.map(jnp.asarray,
                                                        variables[net]))}
    with jax_nan_attribution(mode="callback"):
        f = jax.jit(lambda p: jmodel.apply(p, pos, dirs) if net == "nerf"
                    else jmodel.apply(p, pos))
        with pytest.raises(Exception, match=label):
            jax.block_until_ready(f(params))


@pytest.mark.parametrize("model", ["vanilla", "ref", "mip"])
def test_hooks_leave_a_clean_model_unchanged(model):
    """The loss, its terms and the grads are equal with and without the
    hooks, and the hooks are gone afterwards."""
    kw = dict(ipe_radius=0.02) if model == "mip" else {}
    jcfg, cfg = configs(model=model, white_bkg=False, bottleneck_noise=0.0,
                        use_pallas=False, **kw)
    models = port_models(cfg, jax_variables(jcfg, seed=1, gain=1.0,
                                            bias_std=0.1))
    rays, gt, jit, u = two_camera_batch(
        2, 8, cfg.n_coarse + (model == "mip"), cfg.n_fine)
    t = torch.from_numpy
    out = []
    for hooked in (False, True):
        for m in models:
            if m is not None:
                m.zero_grad(set_to_none=True)
        with nan_attribution(models, enable=hooked):
            loss, metrics = compute_loss(models, t(rays), t(gt), cfg,
                                         noise=(t(jit), t(u)), device="cpu")
            loss.backward()
        out.append(({k: v.detach() for k, v in metrics.items()},
                    [p.grad.clone() for m in models if m is not None
                     for p in m.parameters()]))
    assert out[0][0].keys() == out[1][0].keys()
    for k in out[0][0]:
        assert torch.equal(out[0][0][k], out[1][0][k]), k
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    assert all(not m._forward_hooks for net in models if net is not None
               for m in net.modules())


def test_check_finite_names_the_entry():
    check_finite({"loss": np.ones(3)}, "metrics")
    with pytest.raises(FloatingPointError, match=r"metrics\['psnr'\]"):
        check_finite({"loss": np.ones(3),
                      "psnr": np.array([1.0, np.inf])}, "metrics")
    with pytest.raises(FloatingPointError, match=r"grads\[1\]"):
        check_finite([torch.ones(2), torch.tensor([np.nan])], "grads")


def test_trainer_debug_launches_no_kernel_and_names_a_planted_nan(
        tmp_path, monkeypatch):
    """-b trains and evaluates through the nn.Module route in f32: no
    kernel launches; a NaN planted in the trainer's fine net raises
    FloatingPointError naming its module, and the hooks are removed."""
    monkeypatch.chdir(tmp_path)
    args = get_parser().parse_args(_train_argv(
        tmp_path, "-b", "-s", "--epochs", "2", "--output_time", "1"))
    ops.reset_launches()
    t = Trainer(args, "cpu").train()
    assert not any(ops.LAUNCHES.values())
    assert t.cfg.use_pallas is False and t.cfg.eval_use_pallas is False
    assert not t.cfg.use_bf16 and np.isfinite(t.losses).all()
    t = Trainer(get_parser().parse_args(_train_argv(
        tmp_path, "-b", "--epochs", "1", "--name", "nan")), "cpu")
    with torch.no_grad():
        t.models[0].lin_block1[4].weight[3, 1] = float("nan")
    with pytest.raises(FloatingPointError, match=r"nerf\.lin_block1\.4"):
        t.train()
    assert not any(m._forward_hooks for m in t.models[0].modules())
    assert not torch.is_anomaly_enabled()
