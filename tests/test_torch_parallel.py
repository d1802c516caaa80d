"""The distributed modes' pieces (nerf_tpu_torch/parallel, the division
sampler, ``-div``, the sharded render, the stacked slots) against
nerf_tpu, on gloo CPU ranks that meet through a FileStore.

Tolerances:
- averaging: within 1e-6 of ``make_average_fn`` on a 3-replica virtual CPU
  mesh, per replica (the same f32 products and sums; bit for bit expected);
- a 2-rank ``ddp`` step against the JAX composition that
  nerf_tpu/parallel/dp.py:119-139 runs (``compute_loss`` per device, the mean
  of the grads, optax's clip and Adam): the step tolerances of
  tests/test_torch_train.py (grads 2e-3 relative per weight tuple, params
  within 2 lr and at most 0.1% of them beyond 0.1 lr); against the port's
  one-process oracle (both ranks' backwards, (a + b) / 2, clip, Adam) bit
  for bit;
- the sharded render: bit for bit against the port's single-process
  render, and within RGB_TOL of nerf_tpu's ``render_image(mesh=...)`` on
  the same noise (8x8 frames, as tests/test_torch_checkpoint.py's);
- the epoch layouts and ``-div`` exactly.
"""

import dataclasses
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_port_common import (
    INIT_GLOO, configs, jax_variables, port_models, rays_for, run_ranks,
    two_camera_batch,
)
from nerf_tpu.cli.trainer import Trainer as JaxTrainer
from nerf_tpu.data import sampler as jsampler
from nerf_tpu.data.blender import BlenderDataset as JaxBlenderDataset
from nerf_tpu.ops import prop_weights_from_params, vanilla_weights_from_params
from nerf_tpu.parallel import make_average_fn, make_mesh
from nerf_tpu.train import schedule as jschedule
from nerf_tpu.train.pipeline import make_models as jax_make_models
from nerf_tpu.train.renderer import render_image as jax_render_image
from nerf_tpu.train.step import compute_loss as jax_compute_loss
from nerf_tpu.train.step import make_optimizer as jax_make_optimizer
from nerf_tpu_torch import bridge, parallel
from nerf_tpu_torch.cli.trainer import epoch_indices, grid_layout
from nerf_tpu_torch.data.blender import BlenderDataset
from nerf_tpu_torch.data.sampler import LocalShuffleSampler
from nerf_tpu_torch.data.synthetic import (
    make_synthetic_scene, write_blender_dataset,
)
from nerf_tpu_torch.train import schedule
from nerf_tpu_torch.train.renderer import render_image
from nerf_tpu_torch.train.step import (
    clip_by_global_norm_, compute_loss, make_optimizer,
)
from nerf_tpu_torch.utils.checkpoint import (
    load_checkpoint, save_checkpoint, stack_states, state_row, train_state,
    write_checkpoint,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from pose_division import divide_transforms  # noqa: E402

STRATEGIES = ("all_reduce", "broadcast", "p2p")
RGB_TOL = dict(rtol=1e-4, atol=2e-4)
GRAD_REL = 2e-3
N_RAYS = 16
WEIGHTS = dict(seed=7, gain=1.0, bias_std=0.1)

# ---------------------------------------------------------------------------
# the weighted average at R = 3
# ---------------------------------------------------------------------------

AVERAGE_RANK = INIT_GLOO + """
from nerf_tpu_torch.parallel import average_flat, make_grid
data = np.load(sys.argv[1])
grid = make_grid(WORLD, 1, torch.device("cpu"))
x = torch.from_numpy(data["x"][RANK])
np.savez(sys.argv[2] + f"_{RANK}.npz", **{
    s: average_flat(x, data["w"], grid.replica, grid.replica_group, s).numpy()
    for s in ("all_reduce", "broadcast", "p2p")})
"""


@pytest.fixture(scope="module")
def averaged(tmp_path_factory):
    """Three gloo ranks average seeded vectors with Dirichlet weights under
    each schedule: (inputs, weights, {strategy: per-rank results})."""
    tmp = tmp_path_factory.mktemp("average")
    rng = np.random.default_rng(11)
    x = rng.normal(size=(3, 1000)).astype(np.float32)
    w = parallel.normalized_weights(rng.dirichlet(np.ones(3)), 3)
    np.savez(tmp / "in.npz", x=x, w=w)
    res = run_ranks(AVERAGE_RANK, 3, tmp, [tmp / "in.npz", tmp / "out"])
    assert all(rc == 0 for rc, _, _ in res), [e[-2000:] for _, _, e in res]
    outs = [np.load(tmp / f"out_{r}.npz") for r in range(3)]
    return x, w, {s: [o[s] for o in outs] for s in STRATEGIES}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_average_matches_make_average_fn(averaged, strategy):
    x, w, got = averaged
    mesh = make_mesh(n_replica=3, devices=jax.devices()[:3])
    want = make_average_fn(mesh, strategy)(
        {"x": jnp.asarray(x)}, jnp.asarray(w))["x"]
    for r in range(3):
        np.testing.assert_allclose(got[strategy][r], np.asarray(want[r]),
                                   rtol=0, atol=1e-6)
    # all_reduce and broadcast give every replica the same bits; the ring
    # sums in each replica's own order, as nerf_tpu's does
    if strategy != "p2p":
        np.testing.assert_array_equal(got[strategy][0], got[strategy][2])


def test_normalized_weights_match_nerf_tpu():
    w = [0.25, 0.5, 0.125, 0.5]
    jw = np.asarray(w, np.float32)
    np.testing.assert_array_equal(parallel.normalized_weights(w, 4),
                                  jw / jw.sum())
    np.testing.assert_array_equal(parallel.normalized_weights(None, 4),
                                  np.full(4, 0.25, np.float32))
    with pytest.raises(ValueError, match="3 division weights for 4"):
        parallel.normalized_weights(w[:3], 4)


def test_average_rejects_delicate():
    with pytest.raises(ValueError, match="delicate"):
        parallel.check_strategy("delicate")
    with pytest.raises(ValueError, match="unknown averaging strategy"):
        parallel.average_flat(torch.ones(3), np.ones(1, np.float32), 0, None,
                              "gossip")
    from nerf_tpu_torch.cli.entry import ma_main

    with pytest.raises(SystemExit):
        ma_main(["--ma_epoch", "1", "--ma_method", "delicate"],
                device="cpu")


# ---------------------------------------------------------------------------
# a 2-rank ddp step
# ---------------------------------------------------------------------------

STEP_RANK = INIT_GLOO + """
from nerf_tpu_torch.parallel import GradSync, make_grid
from nerf_tpu_torch.train.config import PipelineConfig
from nerf_tpu_torch.train.pipeline import make_models
from nerf_tpu_torch.train.step import make_optimizer, train_step
job = torch.load(sys.argv[1], weights_only=True)
cfg = PipelineConfig(**job["cfg"])
models = make_models(cfg, "cpu")
for m, sd in zip(models, job["weights"]):
    m.load_state_dict(sd)
grid = make_grid(1, WORLD, torch.device("cpu"))
sync = GradSync(models, grid.data_group, grid.n_data,
                sync_prop=job["sync_prop"])
rays, gt, jit, u = job["batches"][RANK]
train_step(models, make_optimizer(models), rays, gt, cfg, job["lr"],
           grad_clip=job["grad_clip"], noise=(jit, u), device="cpu",
           grad_sync=sync)
torch.save([{k: (p.detach().clone(), p.grad.clone())
             for k, p in m.named_parameters()} for m in models],
           sys.argv[2] + f"_{RANK}.pt")
"""

STEP_CASES = [(True, -1.0), (True, 0.05), (False, -1.0)]


def _step_setup():
    jcfg, cfg = configs(use_pallas=True, white_bkg=False)
    variables = jax_variables(jcfg, **WEIGHTS)
    batches = [two_camera_batch(1 + r, N_RAYS, cfg.n_coarse, cfg.n_fine)
               for r in range(2)]
    lr = float(schedule.decay_schedule(5e-3, warmup_step=3)(0))
    return jcfg, cfg, variables, batches, lr


_STEPS = {}


@pytest.fixture
def rank_step(tmp_path):
    """Each rank's (params, synced grads) after one 2-rank step of a case
    (sync_prop, grad_clip), run once per case."""
    def run(sync_prop, grad_clip):
        key = (sync_prop, grad_clip)
        if key not in _STEPS:
            jcfg, cfg, variables, batches, lr = _step_setup()
            t = torch.from_numpy
            torch.save({"cfg": dataclasses.asdict(cfg),
                "weights": [m.state_dict()
                            for m in port_models(cfg, variables)],
                "batches": [tuple(map(t, b)) for b in batches],
                "sync_prop": sync_prop, "grad_clip": grad_clip, "lr": lr},
                tmp_path / "job.pt")
            res = run_ranks(STEP_RANK, 2, tmp_path,
                            [tmp_path / "job.pt", tmp_path / "out"])
            assert all(rc == 0 for rc, _, _ in res), \
                [e[-2000:] for _, _, e in res]
            _STEPS[key] = [torch.load(tmp_path / f"out_{r}.pt",
                                      weights_only=True) for r in range(2)]
        return _STEPS[key]
    return run


def _tree(named, which, net):
    return bridge.state_dict_to_flax({k: v[which] for k, v in named.items()},
                                     net)


def _tuples(tree):
    return [np.asarray(a) for a in (
        list(vanilla_weights_from_params(tree["nerf"]))
        + list(prop_weights_from_params(tree["prop"])))]


_JAX_GRADS = []


def _jax_device_grads():
    """nerf_tpu's compute_loss grads of each device's batch (Pallas in
    interpret mode), computed once."""
    if not _JAX_GRADS:
        jcfg, _, variables, batches, _ = _step_setup()
        models_j = jax_make_models(jcfg)
        grad = jax.jit(jax.grad(lambda p, rays, gt, jit, u: jax_compute_loss(
            models_j, p, rays, gt, None, jcfg, noise=(jit, u))[0]))
        params = jax.tree.map(jnp.asarray, variables)
        _JAX_GRADS.extend(grad(params, *map(jnp.asarray, b))
                          for b in batches)
    return _JAX_GRADS


@pytest.mark.parametrize("sync_prop,grad_clip", STEP_CASES)
def test_two_rank_step_matches_the_jax_composition(rank_step, sync_prop,
                                                   grad_clip):
    """nerf_tpu/parallel/dp.py:119-139 composed on one process: each
    device's compute_loss grads, their mean (the proposal net's only under
    sync_prop), optax's clip and Adam; every rank's grads and params."""
    got = rank_step(sync_prop, grad_clip)
    jcfg, cfg, variables, batches, lr = _step_setup()
    params = jax.tree.map(jnp.asarray, variables)
    grads = _jax_device_grads()
    mean = jax.tree.map(lambda a, b: (a + b) / 2, *grads)
    tx = jax_make_optimizer(jcfg, jschedule.decay_schedule(5e-3,
                                                           warmup_step=3),
                            grad_clip=grad_clip)
    for r in range(2):
        g = mean if sync_prop else {"nerf": mean["nerf"],
                                    "prop": grads[r]["prop"]}
        if grad_clip > 0:
            g, _ = optax.clip_by_global_norm(grad_clip).update(g, None)
        updates, _ = tx.update(g, tx.init(params), params)
        new = optax.apply_updates(params, updates)
        port = {net: _tree(named, 1, net) for net, named
                in zip(("nerf", "prop"), got[r])}
        for i, (a, b) in enumerate(zip(_tuples(port), _tuples(g))):
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert rel < GRAD_REL, (r, i, rel)
        port = {net: _tree(named, 0, net) for net, named
                in zip(("nerf", "prop"), got[r])}
        diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(
            _tuples(port), _tuples(new))])
        assert diff.max() < 2 * lr and (diff > 0.1 * lr).mean() < 1e-3, r


@pytest.mark.parametrize("sync_prop,grad_clip", STEP_CASES)
def test_two_rank_step_equals_the_one_process_oracle(rank_step, sync_prop,
                                                     grad_clip):
    """Both ranks' backwards in this process, (a + b) / 2 of the synced
    nets' grads, the clip and Adam: every rank's params and grads bit for
    bit; the nets that sync are equal across the ranks, the proposal net
    under --no_sync_prop is not."""
    got = rank_step(sync_prop, grad_clip)
    _, cfg, variables, batches, lr = _step_setup()
    t = torch.from_numpy
    models = port_models(cfg, variables)
    own = []
    for rays, gt, jit, u in batches:
        for p in (p for m in models for p in m.parameters()):
            p.grad = None
        compute_loss(models, t(rays), t(gt), cfg, noise=(t(jit), t(u)),
                     device="cpu")[0].backward()
        own.append([[p.grad.clone() for p in m.parameters()]
                    for m in models])
    for r in range(2):
        models = port_models(cfg, variables)
        opt = make_optimizer(models)
        for n, m in enumerate(models):
            synced = n == 0 or sync_prop
            for i, p in enumerate(m.parameters()):
                p.grad = ((own[0][n][i] + own[1][n][i]) / 2 if synced
                          else own[r][n][i])
        if grad_clip > 0:
            clip_by_global_norm_([p.grad for m in models
                                  for p in m.parameters()], grad_clip)
        for g in opt.param_groups:
            g["lr"] = lr
        opt.step()
        for m, named in zip(models, got[r]):
            for k, p in m.named_parameters():
                assert torch.equal(p.detach(), named[k][0]), (r, k)
                assert torch.equal(p.grad, named[k][1]), (r, k)
    for n, net in enumerate(("nerf", "prop")):
        same = all(torch.equal(got[0][n][k][0], got[1][n][k][0])
                   for k in got[0][n])
        assert same == (net == "nerf" or sync_prop), net


# ---------------------------------------------------------------------------
# the sharded render
# ---------------------------------------------------------------------------

RENDER_RANK = INIT_GLOO + """
from nerf_tpu_torch.parallel import make_grid
from nerf_tpu_torch.train.config import PipelineConfig
from nerf_tpu_torch.train.pipeline import make_models
from nerf_tpu_torch.train.renderer import render_image
job = torch.load(sys.argv[1], weights_only=True)
cfg = PipelineConfig(**job["cfg"])
models = make_models(cfg, "cpu")
for m, sd in zip(models, job["weights"]):
    m.load_state_dict(sd)
grid = make_grid(1, WORLD, torch.device("cpu"))
out = render_image(models, job["pose"].numpy(), (8, 8), job["focal"], cfg,
                   render_depth=True, noise=job["noise"], chunk=16,
                   device="cpu", group=grid.grid_group)
np.savez(sys.argv[2] + f"_{RANK}.npz", **out)
"""


def test_sharded_render_equals_the_single_frame(tmp_path):
    """Two gloo ranks render an 8x8 frame in chunks of 16 (padded to a grid
    of 32): bit for bit the port's single-process frame (rgb and depth) on
    both ranks, and within RGB_TOL of nerf_tpu's render_image(mesh=...)
    over two virtual devices with the same key, whose noise the port
    gets."""
    from nerf_tpu.core import rays as jrays
    from nerf_tpu.core.fastmath import sorted_uniforms

    jcfg, cfg = configs()
    variables = jax_variables(jcfg, seed=0)
    pose = np.asarray(jrays.pose_spherical(30.0, -30.0, 4.0), np.float32)
    focal = jrays.fov_to_focal(0.6911112070083618, (8, 8))
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    noise = (np.array(jax.random.uniform(k1, (64, cfg.n_coarse))),
             np.array(sorted_uniforms(k2, (64, cfg.n_fine + 1))))
    t = torch.from_numpy
    torch.save({"cfg": dataclasses.asdict(cfg),
                "weights": [m.state_dict()
                            for m in port_models(cfg, variables)],
                "pose": t(pose), "focal": [float(f) for f in focal],
                "noise": tuple(map(t, noise))}, tmp_path / "job.pt")
    res = run_ranks(RENDER_RANK, 2, tmp_path,
                    [tmp_path / "job.pt", tmp_path / "out"])
    assert all(rc == 0 for rc, _, _ in res), [e[-2000:] for _, _, e in res]
    single = render_image(port_models(cfg, variables), pose, (8, 8), focal,
                          cfg, render_depth=True,
                          noise=tuple(map(t, noise)), chunk=16, device="cpu")
    for r in range(2):
        got = np.load(tmp_path / f"out_{r}.npz")
        for k in ("rgb", "depth"):
            np.testing.assert_array_equal(got[k], single[k], err_msg=k)
    want = jax_render_image(
        jax.tree.map(jnp.asarray, variables), pose, (8, 8), focal, jcfg,
        render_depth=True, key=key, chunk=16,
        mesh=make_mesh(n_replica=1, devices=jax.devices()[:2]))
    np.testing.assert_allclose(single["rgb"], want["rgb"], **RGB_TOL)


# ---------------------------------------------------------------------------
# the division sampler, the grid layouts and the epoch layouts
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(n=st.integers(2, 40), seed=st.integers(0, 5), epoch=st.integers(0, 3),
       data=st.data())
def test_local_shuffle_sampler_matches_nerf_tpu(n, seed, epoch, data):
    """Equal splits and explicit divisions, truncated or imbalanced: every
    replica's epoch order and length, and the stacked rows."""
    n_rep = data.draw(st.integers(1, min(n, 5)))
    if data.draw(st.booleans()):
        division = n_rep
    else:
        division = data.draw(st.lists(st.integers(0, n_rep - 1), min_size=n,
                                      max_size=n))
        division[:n_rep] = range(n_rep)      # every division is used
    imbalance = data.draw(st.booleans())
    mine = [LocalShuffleSampler(n, division, r, seed=seed,
                                allow_imbalance=imbalance)
            for r in range(n_rep)]
    theirs = [jsampler.LocalShuffleSampler(n, division, r, seed=seed,
                                           allow_imbalance=imbalance)
              for r in range(n_rep)]
    for a, b in zip(mine, theirs):
        assert len(a) == len(b)
        np.testing.assert_array_equal(a.epoch_indices(epoch),
                                      b.epoch_indices(epoch))
    np.testing.assert_array_equal(
        LocalShuffleSampler.stacked_epoch_indices(mine, epoch),
        jsampler.LocalShuffleSampler.stacked_epoch_indices(theirs, epoch))


def test_local_shuffle_sampler_rejects_a_bad_rank():
    with pytest.raises(ValueError, match="invalid rank 2 for 2 replicas"):
        LocalShuffleSampler(8, 2, 2)


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 40), world=st.integers(1, 8), seed=st.integers(0, 3),
       epoch=st.integers(0, 3), data=st.data())
def test_epoch_layouts_match_nerf_tpu(n, world, seed, epoch, data):
    """``epoch_indices`` of ddp, ma and the hybrid ma layout against
    nerf_tpu's Trainer._epoch_indices on the same samplers, raising where
    it raises."""
    mode = data.draw(st.sampled_from(["single", "ddp", "ma"]))
    n_rep = data.draw(st.integers(1, min(n, world))) if mode == "ma" else 1
    n_data = data.draw(st.integers(1, world)) if mode != "single" else 1
    samplers = [jsampler.LocalShuffleSampler(n, n_rep, r, seed=seed)
                for r in range(n_rep)]
    fake = types.SimpleNamespace(
        mode=mode, train_set=[None] * n, args=types.SimpleNamespace(
            seed=seed), n_data=n_data, n_replica=n_rep, samplers=samplers)
    try:
        want = JaxTrainer._epoch_indices(fake, epoch)
    except ValueError:
        with pytest.raises(ValueError):
            epoch_indices(mode, n, epoch, seed, n_data, [
                LocalShuffleSampler(n, n_rep, r, seed=seed)
                for r in range(n_rep)])
        return
    got = epoch_indices(mode, n, epoch, seed, n_data, [
        LocalShuffleSampler(n, n_rep, r, seed=seed) for r in range(n_rep)])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def jax_trainer_args(argv):
    """nerf_tpu's trainer flags with the ddp/ma entries' extra ones."""
    from nerf_tpu.cli import get_parser as jax_get_parser

    parser = jax_get_parser()
    for flag, kw in (("--ma_epoch", dict(type=int, default=100)),
                     ("--ma_method", dict(default="all_reduce")),
                     ("--num_replicas", dict(type=int, default=None))):
        parser.add_argument(flag, **kw)
    parser.add_argument("--div", default=False, action="store_true")
    parser.add_argument("--allow_imbalanced", default=False,
                        action="store_true")
    return parser.parse_args(argv)


class _Split:
    """What nerf_tpu's Trainer reads of a split before it trains."""

    image_hw = (8, 8)

    def __init__(self, n, division=None, weights=None):
        self.n, self.division, self.weights = n, division, weights

    def __len__(self):
        return self.n

    def focal(self, legacy_square=False):
        return (8.0, 8.0)


def nerf_tpu_layout(tmp, mode, world, n, division=None, num_replicas=None,
                    weights=None):
    """(n_replica, n_data) of the mesh that nerf_tpu's Trainer(mode) builds
    on the first ``world`` devices of the virtual mesh, or "raises" when
    its constructor raises ValueError.  Its train state is not made
    (init_variables and stack_state stubbed): the layout does not read
    it."""
    import nerf_tpu.cli.trainer as jtrainer
    import nerf_tpu.parallel as jparallel

    args = jax_trainer_args([
        "--ckpt_dir", str(tmp / "ckpt"), "--log_dir", str(tmp / "logs"),
        "--no_tensorboard", "--no_pallas"]
        + (["--num_replicas", str(num_replicas)] if num_replicas else []))
    devices, meshes = jax.devices()[:world], []
    make = jparallel.make_mesh

    def recorded(n_data=None, n_replica=1):
        meshes.append((n_replica, n_data))
        return make(n_data=n_data, n_replica=n_replica)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda backend=None: devices)
        mp.setattr(jtrainer, "init_variables", lambda cfg, key: None)
        mp.setattr(jparallel, "stack_state", lambda *a, **kw: None)
        mp.setattr(jparallel, "make_mesh", recorded)
        try:
            JaxTrainer(args, mode=mode, train_set=_Split(n, division, weights),
                       test_set=_Split(1))
        except ValueError:
            return "raises"
    (layout,) = meshes
    return layout


def port_layout(mode, world, n, division=None, num_replicas=None,
                weights=None):
    """The port's (n_replica, n_data), with the averaging weights' check
    of ``ma``, or "raises"."""
    try:
        layout = grid_layout(mode, world, n, division, num_replicas)
        if mode == "ma":
            parallel.normalized_weights(weights, layout[0])
    except ValueError:
        return "raises"
    return layout


@pytest.mark.parametrize("mode,world,n,division,num_replicas", [
    ("ddp", 8, 8, None, None),
    ("ma", 8, 8, None, None),
    ("ma", 8, 16, None, 4),                  # the hybrid layout
    ("ma", 8, 6, None, 2),                   # 3 images a replica
    ("ma", 7, 16, None, 2),                  # one idle rank
    ("ma", 4, 9, [0, 0, 0, 0, 1, 1, 1, 1, 1], 2),
    ("ma", 8, 9, [0, 1, 1, 1, 1, 1, 1, 1, 1], 2),  # smallest: 1
    ("ma", 1, 20, None, None),
])
def test_grid_layout_follows_nerf_tpu_rules(tmp_path, mode, world, n,
                                            division, num_replicas):
    """nerf_tpu/cli/trainer.py:117-150, with its ranks as the devices (the
    cases of tests/test_cli.py's hybrid mesh among them): the mesh that
    nerf_tpu's Trainer builds on ``world`` virtual devices."""
    want = nerf_tpu_layout(tmp_path, mode, world, n, division, num_replicas)
    assert want != "raises"
    assert grid_layout(mode, world, n, division, num_replicas) == want


@settings(max_examples=100, deadline=None)
@given(mode=st.sampled_from(["ddp", "ma"]), world=st.integers(1, 8),
       n=st.integers(1, 24), data=st.data())
def test_grid_layout_matches_nerf_tpu_on_hypothesis_cases(
        tmp_path_factory, mode, world, n, data):
    """The port's layout (and the weights' check) against the mesh of
    nerf_tpu's Trainer, raising where it raises: replicas by default and by
    --num_replicas (more than the ranks too), divisions of any group count
    and size, weights of any length."""
    k = data.draw(st.integers(1, min(n, world + 1)))
    num_replicas = data.draw(st.sampled_from([None, k, world + 1]))
    division = data.draw(st.one_of(st.none(), st.lists(
        st.integers(0, k - 1), min_size=n, max_size=n)))
    weights = data.draw(st.one_of(st.none(), st.lists(
        st.floats(0.1, 1.0), min_size=1, max_size=4)))
    want = nerf_tpu_layout(tmp_path_factory.getbasetemp(), mode, world, n,
                           division, num_replicas, weights)
    assert port_layout(mode, world, n, division, num_replicas,
                       weights) == want


def test_grid_layout_rejects_too_many_replicas(tmp_path):
    assert nerf_tpu_layout(tmp_path, "ma", 2, 8, None, 3) == "raises"
    with pytest.raises(ValueError, match="--num_replicas 3 > 2 ranks"):
        grid_layout("ma", 2, 8, None, 3)


def test_rank_seed_keeps_the_seed_at_position_zero():
    assert parallel.rank_seed(7, 0) == 7
    seeds = {parallel.rank_seed(7, i) for i in range(1, 9)}
    assert len(seeds) == 8 and 7 not in seeds


# ---------------------------------------------------------------------------
# -div: transforms_train_div.json
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def div_scene(tmp_path_factory):
    """A 9-view scene with the _div.json of tools/pose_division.py."""
    root = tmp_path_factory.mktemp("div") / "lego"
    train, test, (tr_p, te_p) = make_synthetic_scene(
        n_train=9, n_test=1, hw=(8, 8), seed=3, n_samples=16, device="cpu")
    write_blender_dataset(str(root), train, tr_p, "train")
    with open(root / "transforms_train.json") as f:
        meta = json.load(f)
    with open(root / "transforms_train_div.json", "w") as f:
        json.dump(divide_transforms(meta, mix_num=1), f)
    return root


def test_div_loads_like_nerf_tpu(div_scene):
    mine = BlenderDataset.load(str(div_scene), "train", use_div=True)
    theirs = JaxBlenderDataset.load(str(div_scene), "train", use_div=True,
                                    use_native=False)
    assert mine.division == theirs.division and len(mine.division) == 9
    assert mine.weights == theirs.weights
    np.testing.assert_array_equal(mine.images, theirs.images)
    np.testing.assert_array_equal(mine.poses, theirs.poses)
    plain = BlenderDataset.load(str(div_scene), "train")
    assert plain.division is None and plain.weights is None


def test_div_errors_like_nerf_tpu(div_scene, tmp_path):
    """A division whose length is not the images' raises in both packages;
    so does a missing _div.json, with the tool's name."""
    import shutil

    root = tmp_path / "lego"
    shutil.copytree(div_scene, root)
    path = root / "transforms_train_div.json"
    meta = json.loads(path.read_text())
    meta["division"] = meta["division"][:-1]
    path.write_text(json.dumps(meta))
    for load in (lambda: BlenderDataset.load(str(root), "train",
                                             use_div=True),
                 lambda: JaxBlenderDataset.load(str(root), "train",
                                                use_div=True,
                                                use_native=False)):
        with pytest.raises(ValueError, match="8 division entries but the "
                                             "dataset resolves to 9"):
            load()
    path.unlink()
    for load in (lambda: BlenderDataset.load(str(root), "train",
                                             use_div=True),
                 lambda: JaxBlenderDataset.load(str(root), "train",
                                                use_div=True,
                                                use_native=False)):
        with pytest.raises(FileNotFoundError, match="pose_division.py"):
            load()


# ---------------------------------------------------------------------------
# stacked slots, and nerf_tpu's ma checkpoint row by row
# ---------------------------------------------------------------------------

def test_ma_slot_rows_and_rank_generators(tmp_path):
    """A slot of two replicas' nets and Adam stacked and three ranks'
    generators: each replica's row and each rank's generator come back,
    a slot of another layout is refused."""
    _, cfg = configs()
    states, gens = [], []
    for r in range(2):
        models = port_models(cfg, jax_variables(configs()[0], seed=r))
        opt = make_optimizer(models)
        for p in opt.param_groups[0]["params"]:
            p.grad = torch.full_like(p, 0.1 * (r + 1))
        opt.step()
        states.append((train_state(models, opt), models))
    for i in range(3):
        gens.append(torch.Generator().manual_seed(i).get_state())
    stacked = stack_states([s for s, _ in states])
    path = write_checkpoint(str(tmp_path / "slot.pt"), dict(
        stacked, generator=gens[0], generator_device="cpu", generators=gens,
        layout={"mode": "ma", "n_replica": 2, "n_data": 1}, step=4,
        epoch=1))
    for r in range(2):
        for k, v in state_row(stacked, r)["models"]["nerf"].items():
            assert torch.equal(v, states[r][0]["models"]["nerf"][k]), k
        models = port_models(cfg, jax_variables(configs()[0], seed=5))
        opt, gen = make_optimizer(models), torch.Generator()
        assert load_checkpoint(path, models, opt, gen, replica=r, rank=2,
                               layout=(2, 1)) == (4, 1)
        for a, b in zip(models, states[r][1]):
            for (k, p), q in zip(a.named_parameters(), b.parameters()):
                assert torch.equal(p, q), k
        p0 = opt.param_groups[0]["params"][0]
        assert torch.equal(opt.state[p0]["exp_avg"],
                           states[r][0]["optimizer"]["state"][0]["exp_avg"])
        assert torch.equal(gen.get_state(), gens[2])
    with pytest.raises(ValueError, match="resume at the same layout"):
        load_checkpoint(path, models, layout=(1, 2))
    single = save_checkpoint(str(tmp_path / "single.pt"), models, opt, gen)
    load_checkpoint(single, models, layout=(1, 1))


def test_nerf_tpu_ma_checkpoint_loads_row_by_row(tmp_path, monkeypatch):
    """A nerf_tpu Trainer(mode="ma") on the 8-device virtual mesh trains two
    epochs without averaging and writes its final .ckpt, each leaf with a
    replica axis of 8: every row goes into the port's nets and Adam through
    load_flax_train_state, equal to that replica's params and moments."""
    from nerf_tpu.data.synthetic import (
        make_synthetic_scene as jax_scene,
        write_blender_dataset as jax_write,
    )
    from nerf_tpu_torch.train.pipeline import make_models
    from nerf_tpu_torch.utils.checkpoint import load_nerf_tpu_checkpoint

    monkeypatch.chdir(tmp_path)
    train, test, (tr_p, te_p) = jax_scene(n_train=8, n_test=1, hw=(8, 8),
                                          seed=0, n_samples=16)
    jax_write("data/lego", train, tr_p, "train")
    jax_write("data/lego", test, te_p, "test")
    argv = ["--dataset_root", "data", "--dataset_name", "lego", "--epochs",
            "2", "--sample_ray_num", "8", "--coarse_sample_pnum", "8",
            "--fine_sample_pnum", "8", "--nerf_net_width", "16",
            "--prop_net_width", "16", "--img_scale", "1.0",
            "--output_time", "100", "--no_tensorboard", "--eval_chunk", "64",
            "--no_pallas"]
    JaxTrainer(jax_trainer_args(argv), mode="ma").train()
    ckpt = load_nerf_tpu_checkpoint(os.path.join("model", "model_1.ckpt"))
    state = ckpt["state"]
    kernel = state["params"]["nerf"]["opacity_head"]["kernel"]
    assert kernel.shape[0] == 8 and not np.array_equal(kernel[0], kernel[1])
    from nerf_tpu_torch.cli.flags import config_from_args, get_parser

    cfg = config_from_args(get_parser().parse_args(argv))
    adam = bridge.adam_state(state["opt_state"])
    for r in range(8):
        models = make_models(cfg, "cpu")
        opt = make_optimizer(models)
        bridge.load_flax_train_state(models, opt, state, replica=r)
        want = bridge.flax_to_state_dict(
            jax.tree.map(lambda a: a[r], state["params"]["nerf"]), "nerf")
        for k, v in models[0].state_dict().items():
            assert torch.equal(v, want[k]), (r, k)
        mu = bridge.flax_to_state_dict(
            jax.tree.map(lambda a: a[r], adam["mu"]["prop"]), "prop")
        w = models[1].layers[0].weight
        assert torch.equal(opt.state[w]["exp_avg"], mu["layers.0.weight"])
        assert float(opt.state[w]["step"]) == float(adam["count"][r]) == 2
    with pytest.raises(ValueError, match="replica 8 of a checkpoint with 8"):
        bridge.load_flax_train_state(models, opt, state, replica=8)
