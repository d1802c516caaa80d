"""Checkpoints: the reference saveModel layout, the whole train state, the
rotating window, and ``nerf_tpu``'s msgpack checkpoints.

``model/<name>_mip.pt`` holds the fine net and ``model/<name>_prop.pt`` the
proposal net, each ``{"model": state_dict, "train_cnt": int, "epoch": int}``;
a Mip-NeRF (``-m``), which has no proposal net, is ``<name>_mip.pt`` alone.
These are the files ``tools/export_torch_checkpoint.py`` writes from a
``nerf_tpu`` checkpoint, so a model trained by the JAX package renders here
without another converter.

``save_checkpoint`` writes the port's whole train state to one
``torch.save`` file: the nets, Adam's ``state_dict``, the state of the
trainer's ``torch.Generator`` (the port draws its pixels and noise from it,
where ``nerf_tpu`` keys them on the step, so a resume that did not restore it
would train on other rays), ``step`` and ``epoch``.  The write is atomic:
a temporary file, then ``os.replace`` (nerf_tpu/utils/checkpoint.py:36-47).

A slot of the distributed modes also holds every rank's generator state
(``generators``, in rank order) and the run's ``layout`` (mode, n_replica,
n_data).  A ``ddp`` slot holds rank 0's nets and Adam (under
``--no_sync_prop`` the proposal nets differ per rank and rank 0's are
kept, as ``nerf_tpu`` keeps device 0's); an ``ma`` slot holds every
replica's, stacked on a leading axis as ``nerf_tpu``'s stacked
``TrainState`` (nerf_tpu/parallel/dp.py:30-61).  ``load_checkpoint`` reads
one replica's row and one rank's generator.

``CheckpointManager`` keeps ``nerf_tpu``'s rotating window
(nerf_tpu/utils/checkpoint.py:64-119): slot ``(count % max_save) + 1``,
named ``<prefix>_<slot>``, and an index ``<prefix>_index.json`` with
``count``, ``latest_slot``, ``step`` and ``epoch``, written after the slot.
The port's slots are ``.pt`` files and its index also names the newest one
(``file``); an index without it was written by ``nerf_tpu`` and points at
its ``<prefix>_<slot>.ckpt``, which ``load_nerf_tpu_checkpoint`` reads
through the port's own msgpack reader (``utils/msgpack.py``).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from nerf_tpu_torch.train.config import PipelineConfig
from nerf_tpu_torch.train.pipeline import make_models
from nerf_tpu_torch.utils import msgpack

NETS = ("nerf", "prop")
NERF_TPU_SUFFIX = ".ckpt"


def checkpoint_paths(model_dir: str, name: str):
    return (os.path.join(model_dir, f"{name}_mip.pt"),
            os.path.join(model_dir, f"{name}_prop.pt"))


def model_files(model_dir: str, name: str, models) -> list:
    """(module, path) for each module that ``models`` (nerf, prop) holds: a
    Mip-NeRF's (nerf, None) has ``<name>_mip.pt`` alone."""
    return [(module, path) for module, path
            in zip(models, checkpoint_paths(model_dir, name))
            if module is not None]


def load_model_files(files) -> tuple:
    """Load each (module, path) of ``model_files``; returns (train_cnt,
    epoch) of the last file."""
    meta = (0, 0)
    for module, path in files:
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no trained model at {path}; export one from a nerf_tpu "
                f"checkpoint with tools/export_torch_checkpoint.py")
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        module.load_state_dict(ckpt["model"])
        meta = (int(ckpt.get("train_cnt", 0)), int(ckpt.get("epoch", 0)))
    return meta


def load_models(model_dir: str, name: str, cfg: PipelineConfig, device=None):
    """(nerf, prop) modules built for ``cfg`` with the weights of their
    ``model_files`` in ``model_dir``; returns (models, train_cnt, epoch)."""
    models = make_models(cfg, device)
    step, epoch = load_model_files(model_files(model_dir, name, models))
    return models, step, epoch


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


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def train_state(models, optimizer: torch.optim.Optimizer) -> dict:
    """The nets' and Adam's state dicts, on the CPU."""
    return {"models": {net: _to_cpu(m.state_dict())
                       for net, m in zip(NETS, models) if m is not None},
            "optimizer": _to_cpu(optimizer.state_dict())}


def stack_states(states: list) -> dict:
    """``train_state``s of the replicas, each tensor stacked on a leading
    replica axis (the rest taken from the first)."""
    def stack(first, *rest):
        if isinstance(first, torch.Tensor):
            return torch.stack([first, *rest])
        if isinstance(first, dict):
            return {k: stack(first[k], *(r[k] for r in rest)) for k in first}
        return first
    return stack(*states)


def state_row(state, row: int):
    """Replica ``row`` of a ``stack_states`` tree."""
    if isinstance(state, torch.Tensor):
        return state[row]
    if isinstance(state, dict):
        return {k: state_row(v, row) for k, v in state.items()}
    return state


def checkpoint_payload(models, optimizer: torch.optim.Optimizer,
                       generator: torch.Generator, step: int = 0,
                       epoch: int = 0) -> dict:
    return {**train_state(models, optimizer),
            "generator": generator.get_state(),
            "generator_device": generator.device.type,
            "step": int(step), "epoch": int(epoch)}


def write_checkpoint(path: str, payload: dict) -> str:
    """Write a slot's ``payload`` to ``path`` atomically; returns the
    path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(path: str, models, optimizer: torch.optim.Optimizer,
                    generator: torch.Generator, step: int = 0,
                    epoch: int = 0) -> str:
    """Write the train state to ``path`` atomically; returns the path."""
    return write_checkpoint(path, checkpoint_payload(
        models, optimizer, generator, step, epoch))


def layout_of(ckpt: dict) -> tuple:
    """(n_replica, n_data) of the run that wrote a slot: (1, 1) for the
    single-device trainer."""
    layout = ckpt.get("layout") or {"n_replica": 1, "n_data": 1}
    return int(layout["n_replica"]), int(layout["n_data"])


def load_checkpoint(path: str, models,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    generator: Optional[torch.Generator] = None,
                    replica: int = 0, rank: int = 0,
                    layout: Optional[tuple] = None):
    """Load a ``save_checkpoint`` file into ``models`` (and the optimizer
    and generator, when given); returns (step, epoch).  A distributed slot
    gives replica ``replica``'s nets and Adam and rank ``rank``'s generator.
    Raises when the file's nets are not the models', when ``layout``
    ((n_replica, n_data) of the loading run) is not the writer's, or when
    its generator state was taken on another device type (a CUDA
    generator's state is a Philox seed and offset, a CPU one's a Mersenne
    Twister)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if layout is not None and layout_of(ckpt) != tuple(layout):
        raise ValueError(
            f"{path} was written by a {layout_of(ckpt)} (replica x data) "
            f"run; this run is {tuple(layout)}: resume at the same layout")
    if (ckpt.get("layout") or {}).get("mode") == "ma":
        ckpt.update(state_row({k: ckpt[k] for k in ("models", "optimizer")},
                              replica))
    if "generators" in ckpt:
        ckpt["generator"] = ckpt["generators"][rank]
    nets = {net: m for net, m in zip(NETS, models) if m is not None}
    if set(ckpt["models"]) != set(nets):
        raise ValueError(f"{path} holds the nets {sorted(ckpt['models'])}, "
                         f"the models are {sorted(nets)}")
    for net, m in nets.items():
        m.load_state_dict(ckpt["models"][net])
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
    if generator is not None:
        if ckpt["generator_device"] != generator.device.type:
            raise ValueError(
                f"{path} holds a {ckpt['generator_device']} generator's "
                f"state; the run's generator is on {generator.device.type}")
        generator.set_state(ckpt["generator"])
    return int(ckpt["step"]), int(ckpt["epoch"])


def load_nerf_tpu_checkpoint(path: str) -> dict:
    """A ``nerf_tpu`` checkpoint (``model/<name>.ckpt`` or a rotating slot):
    ``{"state": tree, "step": int, "epoch": int}``, the state as nested
    dicts of numpy arrays (a ``TrainState``'s ``params``, ``opt_state`` and
    ``step``)."""
    with open(path, "rb") as f:
        payload = msgpack.restore(f.read())
    return {"state": payload["state"], "step": int(payload["step"]),
            "epoch": int(payload["epoch"])}


def is_nerf_tpu_checkpoint(path: str) -> bool:
    return path.endswith(NERF_TPU_SUFFIX)


class CheckpointManager:
    """The rotating window of ``max_save`` slots and its index."""

    def __init__(self, directory: str, max_save: int = 3,
                 prefix: str = "chkpt"):
        self.directory = directory
        self.max_save = max(1, int(max_save))
        self.prefix = prefix
        self._count = 0
        os.makedirs(directory, exist_ok=True)
        idx = self._read_index()
        if idx is not None:
            self._count = int(idx.get("count", 0))

    def _index_path(self) -> str:
        return os.path.join(self.directory, f"{self.prefix}_index.json")

    def _read_index(self):
        try:
            with open(self._index_path()) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def slot_path(self, slot: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{slot}.pt")

    def save(self, models, optimizer, generator, step: int = 0,
             epoch: int = 0) -> str:
        return self.write(checkpoint_payload(models, optimizer, generator,
                                             step, epoch), step, epoch)

    def write(self, payload: dict, step: int = 0, epoch: int = 0) -> str:
        """Write ``payload`` to the next slot, then the index."""
        slot = (self._count % self.max_save) + 1
        path = write_checkpoint(self.slot_path(slot), payload)
        self._count += 1
        tmp = self._index_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"count": self._count, "latest_slot": slot,
                       "step": int(step), "epoch": int(epoch),
                       "file": os.path.basename(path)}, f)
        os.replace(tmp, self._index_path())
        return path

    def latest_path(self) -> Optional[str]:
        """The newest slot, the port's or ``nerf_tpu``'s; None if there is
        none."""
        idx = self._read_index()
        if idx is None:
            return None
        name = idx.get("file", f"{self.prefix}_{int(idx['latest_slot'])}"
                               f"{NERF_TPU_SUFFIX}")
        path = os.path.join(self.directory, name)
        return path if os.path.exists(path) else None
