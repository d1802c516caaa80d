"""Weights across the two packages: flax parameter trees <-> the port's
``state_dict``s, and ``nerf_tpu``'s optax Adam state -> torch's Adam.

A flax tree here is a nested dict of numpy arrays (``np.asarray`` of each
leaf of ``nerf_tpu``'s params, or a tree read from its checkpoint by
``utils/checkpoint.load_nerf_tpu_checkpoint``).  A flax ``Dense`` kernel is
(in, out) and a torch ``Linear`` weight is (out, in).  The state-dict keys
are the reference torch layout, the same as
``tools/export_torch_checkpoint.py`` writes, so the port's own copy of that
mapping lives here.  Both directions are exact (transposes and f32 copies
only).  A leading replica axis, which ``nerf_tpu``'s ddp and ma modes leave
on every leaf, is dropped: one replica's row is read (by default the first,
as nerf_tpu/cli/render.py:54-65 does; each rank of the port's ``ma`` mode
reads its own).
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


def _replica_row(a, ndim: int, replica: int = 0) -> np.ndarray:
    """``a`` as f32, row ``replica`` of its leading replica axis where it has
    one more dimension than ``ndim``."""
    a = np.asarray(a, np.float32)
    if a.ndim != ndim + 1:
        return a
    if not 0 <= replica < a.shape[0]:
        raise ValueError(f"replica {replica} of a checkpoint with "
                         f"{a.shape[0]} replicas")
    return a[replica]


def flax_to_state_dict(params: dict, net: str, replica: int = 0) -> dict:
    """flax params of ``net`` ("nerf" = VanillaNeRF, "ref" = RefNeRF,
    "prop") -> state_dict, row ``replica`` of a stacked tree.  Also maps a
    tree of the same layout (Adam's moments)."""
    sd = {}
    for prefix, path in _layers(net):
        layer = params
        for k in path:
            layer = layer[k]
        # np.array copies: a leaf read from a checkpoint is a read-only
        # view of the file's bytes, and the optimizer updates its moments
        # in place
        sd[f"{prefix}.weight"] = torch.from_numpy(
            np.array(_replica_row(layer["kernel"], 2, replica).T, order="C"))
        sd[f"{prefix}.bias"] = torch.from_numpy(
            np.array(_replica_row(layer["bias"], 1, replica)).reshape(-1))
    return sd


def state_dict_to_flax(sd: dict, net: str) -> dict:
    """state_dict of ``net`` -> flax params (nested dicts of numpy arrays)."""
    params: dict = {}
    for prefix, path in _layers(net):
        node = params
        for k in path:
            node = node.setdefault(k, {})
        w = sd[f"{prefix}.weight"].detach().cpu().to(torch.float32).numpy()
        node["kernel"] = np.array(w.T, order="C")    # a copy, not a view
        node["bias"] = sd[f"{prefix}.bias"].detach().cpu().to(
            torch.float32).numpy().copy()
    return params


def load_flax_variables(models, variables: dict, replica: int = 0) -> None:
    """Copy {"nerf": params, "prop": params} (row ``replica`` of a stacked
    tree) into (nerf, prop) modules; the fine net's params are a
    VanillaNeRF's or a RefNeRF's.  Mip-NeRF's {"nerf": params} goes into
    (nerf, None)."""
    for module, key, net in _nets(models, variables):
        module.load_state_dict(flax_to_state_dict(variables[key], net,
                                                  replica))


def _nets(models, variables: dict):
    """(module, key of ``variables``, bridge net name) for each module of
    (nerf, prop)."""
    nerf, prop = models
    if (prop is None) != ("prop" not in variables):
        raise ValueError("the variables and the models disagree on the "
                         "proposal net: one has it, the other not")
    out = [(nerf, "nerf",
            "ref" if "spa_block1" in variables["nerf"] else "nerf")]
    if prop is not None:
        out.append((prop, "prop", "prop"))
    return out


def adam_state(opt_state: dict) -> dict:
    """optax's ``ScaleByAdamState`` ({"count", "mu", "nu"}) in
    ``nerf_tpu``'s optimizer state: at ``["0"]["0"]``, or at ``["1"]["0"]``
    when ``--grad_clip`` put ``clip_by_global_norm`` (an empty state)
    first (nerf_tpu/train/step.py:241-247)."""
    for key in ("0", "1"):
        adam = opt_state.get(key, {}).get("0", {})
        if {"count", "mu", "nu"} <= set(adam):
            return adam
    raise ValueError("no Adam state (count, mu, nu) at opt_state['0']['0'] "
                     "or opt_state['1']['0']")


def load_flax_train_state(models, optimizer: torch.optim.Optimizer,
                          state: dict, replica: int = 0) -> None:
    """Load ``nerf_tpu``'s train state (a ``TrainState`` as a tree: params,
    opt_state, step; row ``replica`` of a stacked one, as the ddp and ma
    modes write it) into (nerf, prop) and torch's Adam over them: optax's
    ``mu``/``nu``/``count`` become each parameter's ``exp_avg``/
    ``exp_avg_sq``/``step``, with the kernels' transposes.  Both Adams
    take the rate at the update's own count and correct the moments' bias
    by ``count + 1``, so the next update is the same."""
    params = state["params"]
    load_flax_variables(models, params, replica)
    adam = adam_state(state["opt_state"])
    count = float(_replica_row(adam["count"], 0, replica))
    slot = {id(p): i for i, p in enumerate(
        p for g in optimizer.param_groups for p in g["params"])}
    moments = {}
    for module, key, net in _nets(models, params):
        mu = flax_to_state_dict(adam["mu"][key], net, replica)
        nu = flax_to_state_dict(adam["nu"][key], net, replica)
        for name, p in module.named_parameters():
            moments[slot[id(p)]] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": mu[name], "exp_avg_sq": nu[name]}
    if len(moments) != len(slot):
        raise ValueError(f"the Adam state covers {len(moments)} of the "
                         f"optimizer's {len(slot)} parameters")
    sd = optimizer.state_dict()
    sd["state"] = moments
    optimizer.load_state_dict(sd)
