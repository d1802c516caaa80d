"""Checkpoints in the reference saveModel layout.

``model/<name>_mip.pt`` holds the fine net and ``model/<name>_prop.pt`` the
proposal net, each ``{"model": state_dict, "train_cnt": int, "epoch": int}``;
a Mip-NeRF (``-m``), which has no proposal net, is ``<name>_mip.pt`` alone.
These are the files ``tools/export_torch_checkpoint.py`` writes from a
``nerf_tpu`` checkpoint, so a model trained by the JAX package renders here
without another converter.
"""

from __future__ import annotations

import os

import torch

from nerf_tpu_torch.train.config import PipelineConfig
from nerf_tpu_torch.train.pipeline import make_models


def checkpoint_paths(model_dir: str, name: str):
    return (os.path.join(model_dir, f"{name}_mip.pt"),
            os.path.join(model_dir, f"{name}_prop.pt"))


def model_files(model_dir: str, name: str, models) -> list:
    """(module, path) for each module that ``models`` (nerf, prop) holds: a
    Mip-NeRF's (nerf, None) has ``<name>_mip.pt`` alone."""
    return [(module, path) for module, path
            in zip(models, checkpoint_paths(model_dir, name))
            if module is not None]


def load_models(model_dir: str, name: str, cfg: PipelineConfig, device=None):
    """(nerf, prop) modules built for ``cfg`` with the weights of their
    ``model_files`` in ``model_dir``; returns (models, train_cnt, epoch)."""
    models = make_models(cfg, device)
    meta = (0, 0)
    for module, path in model_files(model_dir, name, models):
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no trained model at {path}; export one from a nerf_tpu "
                f"checkpoint with tools/export_torch_checkpoint.py")
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        module.load_state_dict(ckpt["model"])
        meta = (int(ckpt.get("train_cnt", 0)), int(ckpt.get("epoch", 0)))
    return models, meta[0], meta[1]


def save_models(model_dir: str, name: str, models, train_cnt: int = 0,
                epoch: int = 0) -> list:
    """Write each module of (nerf, prop) to its ``model_files`` path;
    returns the paths written."""
    os.makedirs(model_dir, exist_ok=True)
    files = model_files(model_dir, name, models)
    for module, path in files:
        sd = {k: v.detach().cpu() for k, v in module.state_dict().items()}
        torch.save({"model": sd, "train_cnt": train_cnt, "epoch": epoch},
                   path)
    return [path for _, path in files]
