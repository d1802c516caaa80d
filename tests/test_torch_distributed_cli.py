"""The distributed modes through their entries, ``ddp_main`` and ``ma_main``,
on the CPU: gloo ranks in ``-c`` subprocesses that meet through a FileStore
(``--coordinator file://...``), each with a join timeout; world size 1 in
this process.

- world size 1: ``ddp`` and ``ma`` (each averaging method) equal the
  single-device trainer bit for bit;
- 2 ranks of ``ddp`` and 3 of ``ma`` (2 replicas on a ``-div`` split, one
  idle rank) run to the end: rank 0 alone prints and writes, the synced
  nets are equal on every rank, each replica trains its own division;
- a SIGTERM to rank 1 alone stops both ranks after the same epoch, exit
  128 + 15, with one slot written by rank 0, which ``-l`` resumes;
- ``ma`` resumed with ``-l`` from the slot after 3 epochs and run 3 more
  equals 6 straight epochs bit for bit on every rank.
"""

import json
import os
import signal

import pytest
import torch

from torch_port_common import run_ranks
from nerf_tpu_torch.cli.entry import ddp_main, ma_main, main
from nerf_tpu_torch.data.synthetic import (
    make_synthetic_scene, write_blender_dataset,
)

ARGS = ["--dataset_root", "data", "--dataset_name", "lego",
        "--sample_ray_num", "16", "--coarse_sample_pnum", "8",
        "--fine_sample_pnum", "8", "--nerf_net_width", "16",
        "--prop_net_width", "16", "--img_scale", "1.0", "--no_tensorboard",
        "--output_time", "100000", "--eval_chunk", "64"]
DIVISION = [0, 1, 0, 1]
DIV_WEIGHTS = [0.25, 0.75]

# a rank of the entry: TEST_HOOK (JSON) may signal this rank after an epoch
# or start a resumed run one epoch after the saved one; after train() each
# active rank saves its nets and image orders to nets_<rank>.pt
CLI_RANK = """
import json, signal
from nerf_tpu_torch.cli import trainer
from nerf_tpu_torch.cli.entry import ddp_main, ma_main
hook = json.loads(os.environ.get("TEST_HOOK", "{}"))
train, run_epoch = trainer.Trainer.train, trainer.Trainer.run_epoch
def dumped(self):
    if hook.get("after_saved_epoch") and self.epoch_start:
        self.epoch_start += 1
    try:
        return train(self)
    finally:
        torch.save({"nets": [m.state_dict() for m in self.models
                             if m is not None],
                    "orders": [self.epoch_order(ep).tolist()
                               for ep in range(self.args.epochs)]
                    if self.active else [],
                    "step": self.step}, f"nets_{RANK}.pt")
def signalled(self, ep):
    out = run_epoch(self, ep)
    if RANK == hook.get("sigterm_rank") and ep == hook.get("sigterm_after"):
        os.kill(os.getpid(), signal.SIGTERM)
    return out
trainer.Trainer.train, trainer.Trainer.run_epoch = dumped, signalled
entry = ddp_main if sys.argv[1] == "ddp" else ma_main
sys.exit(entry(sys.argv[2:] + [
    "--coordinator", "file://" + STORE, "--num_processes", str(WORLD),
    "--process_id", str(RANK)], device="cpu", backend="gloo"))
"""


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 4-view 16x16 scene in the Blender layout, with a two-way
    transforms_train_div.json."""
    root = tmp_path_factory.mktemp("dist")
    lego = root / "data" / "lego"
    train, test, (tr_p, te_p) = make_synthetic_scene(
        n_train=4, n_test=1, hw=(16, 16), seed=0, n_samples=16,
        device="cpu")
    write_blender_dataset(str(lego), train, tr_p, "train")
    write_blender_dataset(str(lego), test, te_p, "test")
    meta = json.loads((lego / "transforms_train.json").read_text())
    meta.update(division=DIVISION, weights=DIV_WEIGHTS)
    (lego / "transforms_train_div.json").write_text(json.dumps(meta))
    return root


@pytest.fixture
def workdir(scene, tmp_path, monkeypatch):
    os.symlink(scene / "data", tmp_path / "data")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _ranks(workdir, mode, argv, world=2, hook=None, run="run"):
    res = run_ranks(CLI_RANK, world, workdir, [mode, *ARGS, *argv],
                    store=workdir / f"store_{run}",
                    env={"TEST_HOOK": json.dumps(hook or {})})
    nets = [torch.load(workdir / f"nets_{r}.pt", weights_only=True)
            if os.path.exists(workdir / f"nets_{r}.pt") else None
            for r in range(world)]
    for r in range(world):
        if os.path.exists(workdir / f"nets_{r}.pt"):
            os.remove(workdir / f"nets_{r}.pt")
    return res, nets


def _equal(a, b) -> bool:
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def _final(name):
    return [torch.load(os.path.join("model", f"{name}_{net}.pt"),
                       weights_only=True)["model"] for net in ("mip", "prop")]


def test_world_one_equals_the_single_device_run(workdir):
    """ddp and ma (each averaging method, every second epoch) at world size
    1, in this process: the final nets equal the single-device trainer's
    bit for bit."""
    argv = ARGS + ["--epochs", "3"]
    main(argv + ["--name", "single"], device="cpu")
    want = _final("single")
    ddp_main(argv + ["--name", "ddp"], device="cpu")
    assert _equal(_final("ddp"), want)
    for method in ("all_reduce", "broadcast", "p2p"):
        ma_main(argv + ["--name", f"ma_{method}", "--ma_epoch", "2",
                        "--ma_method", method], device="cpu")
        assert _equal(_final(f"ma_{method}"), want), method
    assert not torch.distributed.is_initialized()


def test_ddp_two_ranks_through_the_entry(workdir):
    """Two ranks, two steps an epoch: both exit 0, only rank 0 prints and
    writes, every rank ends on the same nets, each epoch splits a
    permutation of the images between the ranks."""
    res, nets = _ranks(workdir, "ddp", ["--epochs", "3", "--output_time",
                                        "2", "--name", "ddp2"])
    assert [rc for rc, _, _ in res] == [0, 0], [e[-3000:] for *_, e in res]
    out0, out1 = res[0][1], res[1][1]
    assert "mode=ddp ranks=2 backend=gloo grid=(1x2)" in out0 and out1 == ""
    assert "Epoch    2 /    3" in out0 and "Evaluation in epoch:    2" in out0
    assert _equal(nets[0]["nets"], nets[1]["nets"])
    assert _equal(_final("ddp2"), nets[0]["nets"])
    for a, b in zip(nets[0]["orders"], nets[1]["orders"]):
        assert sorted(a + b) == [0, 1, 2, 3]
    assert nets[0]["step"] == nets[1]["step"] == 6
    slots = os.listdir(os.path.join("check_points", "lego"))
    assert "ddp2_chkpt_index.json" in slots


def test_ma_div_three_ranks_one_idle(workdir):
    """ma on -div's two divisions over three ranks: a 2x1 grid and an idle
    rank 2, which exits 0 at once; each replica trains only its division;
    after the averaging epoch both replicas hold the same nets."""
    res, nets = _ranks(workdir, "ma", [
        "--epochs", "2", "--ma_epoch", "2", "-div", "--num_replicas", "2",
        "--name", "ma3"], world=3)
    assert [rc for rc, _, _ in res] == [0, 0, 0], \
        [e[-3000:] for *_, e in res]
    assert "3 ranks, using 2x1 grid (1 idle)" in res[0][1]
    assert res[1][1] == res[2][1] == ""
    assert nets[2]["step"] == 0
    for r in range(2):
        assert {i for o in nets[r]["orders"] for i in o} == {
            i for i, d in enumerate(DIVISION) if d == r}
    assert _equal(nets[0]["nets"], nets[1]["nets"])


def test_sigterm_to_one_rank_stops_both(workdir):
    """SIGTERM to rank 1 alone after epoch 1: both ranks stop after that
    epoch with exit 128 + 15; rank 0 writes one slot (step 4, epoch 1, both
    ranks' generators); -l resumes both ranks from it to the end."""
    res, _ = _ranks(workdir, "ddp", ["--epochs", "6", "--name", "term"],
                    hook={"sigterm_rank": 1, "sigterm_after": 1})
    assert [rc for rc, _, _ in res] == [128 + signal.SIGTERM] * 2, \
        [e[-3000:] for *_, e in res]
    assert "signal 15: checkpointed step 4, epoch 1" in res[0][1]
    assert "Epoch    2" not in res[0][1]
    ckdir = os.path.join("check_points", "lego")
    idx = json.load(open(os.path.join(ckdir, "term_chkpt_index.json")))
    assert (idx["step"], idx["epoch"], idx["count"]) == (4, 1, 1)
    slot = torch.load(os.path.join(ckdir, idx["file"]), weights_only=True)
    assert slot["layout"] == {"mode": "ddp", "n_replica": 1, "n_data": 2}
    assert len(slot["generators"]) == 2
    assert not os.path.exists("model")
    res, nets = _ranks(workdir, "ddp", ["--epochs", "3", "--name", "term",
                                        "-l"], run="resume")
    assert [rc for rc, _, _ in res] == [0, 0], [e[-3000:] for *_, e in res]
    assert "step 4, epoch 1." in res[0][1]
    assert nets[0]["step"] == nets[1]["step"] == 8    # epoch 1 runs again


def test_ma_resume_three_plus_three_equals_six(workdir):
    """ma, 2 replicas, averaging every 3 epochs: 3 epochs (their last writes
    a slot of both replicas' nets and Adam and both ranks' generators), then
    -l for epochs 3-5 (the resumed run starts one epoch after the saved one,
    which -l itself runs again), against 6 straight: every rank's nets bit
    for bit."""
    common = ["--ma_epoch", "3", "--ma_method", "broadcast"]
    _, straight = _ranks(workdir, "ma", common + ["--epochs", "6", "--name",
                                                  "straight"])
    res, _ = _ranks(workdir, "ma", common + ["--epochs", "3", "--name",
                                             "split"], run="first")
    assert [rc for rc, _, _ in res] == [0, 0], [e[-3000:] for *_, e in res]
    res, resumed = _ranks(workdir, "ma", common + [
        "--epochs", "6", "--name", "split", "-l"],
        hook={"after_saved_epoch": True}, run="second")
    assert [rc for rc, _, _ in res] == [0, 0], [e[-3000:] for *_, e in res]
    assert "step 6, epoch 2." in res[0][1]
    for r in range(2):
        assert resumed[r]["step"] == straight[r]["step"] == 12
        assert _equal(resumed[r]["nets"], straight[r]["nets"]), r
    assert _equal(straight[0]["nets"], straight[1]["nets"])   # averaged
