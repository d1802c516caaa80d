"""Weights across the two packages: flax parameter trees <-> the port's
``state_dict``s.

A flax tree here is a nested dict of numpy arrays (``np.asarray`` of each
leaf of ``nerf_tpu``'s params).  A flax ``Dense`` kernel is (in, out) and a
torch ``Linear`` weight is (out, in).  The state-dict keys are the reference
torch layout, the same as ``tools/export_torch_checkpoint.py`` writes, so the
port's own copy of that mapping lives here.  Both directions are exact
(transposes and f32 copies only).
"""

from __future__ import annotations

import numpy as np
import torch

_D4 = tuple(f"Dense_{i}" for i in range(4))

# torch prefix <- flax path, per net
VANILLA_LAYERS = (
    *((f"lin_block1.{t}", ("block1", f)) for t, f in zip((0, 2, 4, 6), _D4)),
    *((f"lin_block2.{t}", ("block2", f)) for t, f in zip((0, 2, 4), _D4)),
    ("opacity_head.0", ("opacity_head",)),
    ("bottle_neck.0", ("bottle_neck",)),
    ("rgb_layer.0", ("rgb_layer", "Dense_0")),
    ("rgb_layer.2", ("rgb_layer", "Dense_1")),
)


def _block4(name: str):
    """A 4-layer flax MLP ``name`` -> the torch Sequential ``name``."""
    return tuple((f"{name}.{t}", (name, f)) for t, f in zip((0, 2, 4, 6), _D4))


REF_LAYERS = (
    *_block4("spa_block1"), *_block4("spa_block2"),
    ("rho_tau_head", ("rho_tau_head",)),
    ("norm_col_tint_head", ("norm_col_tint_head",)),
    ("bottle_neck", ("bottle_neck",)),
    *_block4("dir_block1"), *_block4("dir_block2"),
    ("spec_rgb_head.0", ("spec_rgb_head", "Dense_0")),
)
PROP_LAYERS = (
    *((f"layers.{t}", ("MLP_0", f)) for t, f in zip((0, 2, 4, 6), _D4)),
    ("layers.8", ("MLP_1", "Dense_0")),
)


def _layers(net: str):
    if net == "nerf":
        return VANILLA_LAYERS
    if net == "ref":
        return REF_LAYERS
    if net == "prop":
        return PROP_LAYERS
    raise ValueError(f"unknown net {net!r}; expected 'nerf', 'ref' or 'prop'")


def flax_to_state_dict(params: dict, net: str) -> dict:
    """flax params of ``net`` ("nerf" = VanillaNeRF, "ref" = RefNeRF,
    "prop") -> state_dict."""
    sd = {}
    for prefix, path in _layers(net):
        layer = params
        for k in path:
            layer = layer[k]
        sd[f"{prefix}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(layer["kernel"], np.float32).T))
        sd[f"{prefix}.bias"] = torch.from_numpy(
            np.array(layer["bias"], np.float32).reshape(-1))
    return sd


def state_dict_to_flax(sd: dict, net: str) -> dict:
    """state_dict of ``net`` -> flax params (nested dicts of numpy arrays)."""
    params: dict = {}
    for prefix, path in _layers(net):
        node = params
        for k in path:
            node = node.setdefault(k, {})
        w = sd[f"{prefix}.weight"].detach().cpu().to(torch.float32).numpy()
        node["kernel"] = np.ascontiguousarray(w.T)
        node["bias"] = sd[f"{prefix}.bias"].detach().cpu().to(
            torch.float32).numpy().copy()
    return params


def load_flax_variables(models, variables: dict) -> None:
    """Copy {"nerf": params, "prop": params} into (nerf, prop) modules; the
    fine net's params are a VanillaNeRF's or a RefNeRF's.  Mip-NeRF's
    {"nerf": params} goes into (nerf, None)."""
    nerf, prop = models
    net = "ref" if "spa_block1" in variables["nerf"] else "nerf"
    nerf.load_state_dict(flax_to_state_dict(variables["nerf"], net))
    if (prop is None) != ("prop" not in variables):
        raise ValueError("the variables and the models disagree on the "
                         "proposal net: one has it, the other not")
    if prop is not None:
        prop.load_state_dict(flax_to_state_dict(variables["prop"], "prop"))
