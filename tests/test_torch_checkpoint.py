"""The trainer's operations shell in nerf_tpu_torch against nerf_tpu: the
msgpack reader against flax, the rotating checkpoint window, resume bit for
bit in the port and from nerf_tpu's train state, the SIGTERM drill through
the entry, and render-only's fallback chain.

Tolerances:
- the msgpack reader: equal to ``flax.serialization.msgpack_restore`` bit
  for bit (the same tree, types, dtypes, shapes and bytes);
- resume in the port: the params after 3 + 3 steps equal those after 6
  straight steps bit for bit (f32, CPU);
- resume from nerf_tpu's state: the port's steps after the loaded state
  are held to nerf_tpu's uninterrupted trajectory with
  test_five_step_trajectory_matches_jax's tolerances (losses rtol
  2 * LOSS_RTOL; each weight-tuple tensor within 3% of how far the JAX
  params moved, every element within half the summed learning rates);
- render-only: each frame within the port's eval tolerance RGB_TOL
  (rtol 1e-4, atol 2e-4; tests/test_torch_pipeline.py) of nerf_tpu's
  ``render_only`` on the same params and noise.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap

import flax.serialization as fser
import jax
import jax.numpy as jnp
import msgpack as pymsgpack
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_train import (
    LOSS_RTOL, N_RAYS, WEIGHTS, _draws, _jax_batch, _jax_step_fn,
    _kernel_tuples, _port_batch, _port_tree, _t, scene,  # noqa: F401
)
from torch_port_common import (
    configs, eval_noise, jax_variables, port_models, rays_for,
)
import nerf_tpu.cli.render as jax_render_cli
from nerf_tpu.cli.flags import get_parser as jax_get_parser
from nerf_tpu.train import schedule as jschedule
from nerf_tpu.train.pipeline import make_models as jax_make_models
from nerf_tpu.train.pipeline import render_rays_eval as jax_render_rays_eval
from nerf_tpu.train.step import TrainState
from nerf_tpu.train.step import make_optimizer as jax_make_optimizer
from nerf_tpu.utils import CheckpointManager as JaxCheckpointManager
from nerf_tpu.utils import save_checkpoint as jax_save_checkpoint
import nerf_tpu_torch.cli.render as render_cli
from nerf_tpu_torch import bridge
from nerf_tpu_torch.cli.flags import get_parser
from nerf_tpu_torch.cli.trainer import Trainer
from nerf_tpu_torch.data.synthetic import (
    make_synthetic_scene, write_blender_dataset,
)
from nerf_tpu_torch.train import schedule
from nerf_tpu_torch.train.step import (
    make_optimizer, sample_train_rays, train_step,
)
from nerf_tpu_torch.utils import msgpack
from nerf_tpu_torch.utils.checkpoint import (
    CheckpointManager, load_checkpoint, load_nerf_tpu_checkpoint,
    save_models,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
RGB_TOL = dict(rtol=1e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the msgpack reader against flax
# ---------------------------------------------------------------------------

def assert_same_tree(got, want, path="state"):
    """Equal trees: the same container and scalar types, dict keys in the
    same order, arrays of one dtype, shape, flags and bytes."""
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert (got.dtype, got.shape, got.flags.writeable) == \
            (want.dtype, want.shape, want.flags.writeable), path
        assert got.tobytes() == want.tobytes(), path
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got), path
    else:
        assert got == want, path
        if isinstance(want, np.generic):
            assert got.dtype == want.dtype, path


def jax_train_state(model: str, grad_clip: float, seed: int = 0):
    """A nerf_tpu TrainState after one Adam update with random grads, so
    that every moment and count is live."""
    kw = {"ipe_radius": 0.02} if model == "mip" else {}
    jcfg, _ = configs(model=model, **kw)
    params = jax_variables(jcfg, **{**WEIGHTS, "seed": seed})
    tx = jax_make_optimizer(jcfg, jschedule.decay_schedule(1e-3),
                            grad_clip=grad_clip)
    opt_state = tx.init(params)
    rng = np.random.default_rng(seed + 1)
    grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), params)
    updates, opt_state = tx.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    return TrainState(params, opt_state, jnp.int32(1))


@pytest.mark.parametrize("grad_clip", [-1.0, 0.05])
@pytest.mark.parametrize("model", ["vanilla", "ref", "mip"])
def test_msgpack_reader_equals_flax_on_train_states(tmp_path, model,
                                                    grad_clip):
    """nerf_tpu's save_checkpoint of a TrainState, read by the port's
    reader and by flax: equal trees (the optax tuple as {"0", "1"} maps,
    clip_by_global_norm's empty map, int32 counts as zero-dim ext-1
    arrays, the epoch and step as msgpack ints)."""
    path = jax_save_checkpoint(str(tmp_path / "c.ckpt"),
                               jax_train_state(model, grad_clip), 7, 2)
    data = open(path, "rb").read()
    got, want = msgpack.restore(data), fser.msgpack_restore(data)
    assert_same_tree(got, want)
    assert got["state"]["step"].shape == () and got["step"] == 7
    opt = got["state"]["opt_state"]
    assert (opt["0"] == {}) == (grad_clip > 0)
    ckpt = load_nerf_tpu_checkpoint(path)
    assert (ckpt["step"], ckpt["epoch"]) == (7, 2)
    assert bridge.adam_state(opt)["count"] == 1


LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


@pytest.mark.parametrize("n", LENGTHS)
def test_msgpack_reader_length_forms(n):
    """str, bin, array and map of each length form (fix, 8, 16 and 32 bit
    lengths), and arrays of n elements as flax writes them."""
    doc = {"s": "x" * n, "b": b"\x01" * n, "a": list(range(n)),
           "m": {f"k{i}": i for i in range(n)},
           "arr": np.arange(n, dtype=np.float32)}
    for data in (pymsgpack.packb({k: v for k, v in doc.items()
                                  if k != "arr"}, use_bin_type=True),
                 fser.msgpack_serialize(doc)):
        assert_same_tree(msgpack.restore(data), fser.msgpack_restore(data))


@settings(max_examples=150, deadline=None)
@given(st.recursive(
    st.none() | st.booleans()
    | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
    | st.floats(allow_nan=True) | st.text(max_size=40)
    | st.binary(max_size=40),
    lambda inner: st.lists(inner, max_size=5)
    | st.dictionaries(st.text(max_size=8), inner, max_size=5),
    max_leaves=20), st.booleans())
def test_msgpack_reader_scalar_forms(doc, single_float):
    """nil, bools, ints of every width and sign, f32 and f64 floats, str,
    bin, arrays and maps, nested."""
    data = pymsgpack.packb(doc, use_bin_type=True,
                           use_single_float=single_float)
    assert_same_tree(msgpack.restore(data), fser.msgpack_restore(data))


@pytest.mark.parametrize("arr", [
    np.float32(2.5), np.int32(-3), np.zeros((), np.float32),
    np.array(7, np.int32), np.zeros((0,), np.float32),
    np.zeros((3, 0, 2), np.int64), np.arange(12, dtype=np.uint8).reshape(
        3, 4), np.array([True, False]), np.full((2, 2), np.nan, np.float64)],
    ids=lambda a: f"{type(a).__name__}-{a.dtype}-{a.shape}")
def test_msgpack_reader_arrays_and_numpy_scalars(arr):
    """ext type 1 (ndarray, zero-dim and empty ones too) and ext type 3
    (numpy scalar)."""
    data = fser.msgpack_serialize({"x": arr, "y": [arr, {"z": arr}]})
    assert_same_tree(msgpack.restore(data), fser.msgpack_restore(data))


def test_msgpack_reader_refuses_what_no_checkpoint_holds(monkeypatch):
    """ext type 2 (complex), flax's chunked large-array form, an unknown
    ext type, a truncated document and trailing bytes."""
    data = fser.msgpack_serialize({"c": 1.0 + 2.0j})
    assert isinstance(fser.msgpack_restore(data)["c"], complex)
    with pytest.raises(msgpack.MsgpackError, match="ext type 2"):
        msgpack.restore(data)
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    data = fser.msgpack_serialize({"w": np.arange(100, dtype=np.float32)})
    assert fser.msgpack_restore(data)["w"].shape == (100,)
    with pytest.raises(msgpack.MsgpackError,
                       match="__msgpack_chunked_array__"):
        msgpack.restore(data)
    with pytest.raises(msgpack.MsgpackError, match="ext type 9"):
        msgpack.restore(pymsgpack.packb(pymsgpack.ExtType(9, b"ab")))
    good = fser.msgpack_serialize({"x": np.ones(4, np.float32)})
    with pytest.raises(msgpack.MsgpackError, match="truncated"):
        msgpack.restore(good[:-3])
    with pytest.raises(msgpack.MsgpackError, match="after the document"):
        msgpack.restore(good + b"\xc0")


# ---------------------------------------------------------------------------
# the rotating window
# ---------------------------------------------------------------------------

def _small_state(model="vanilla", seed=0):
    kw = {"ipe_radius": 0.02} if model == "mip" else {}
    jcfg, cfg = configs(model=model, **kw)
    models = port_models(cfg, jax_variables(jcfg, seed=seed))
    return cfg, models, make_optimizer(models), \
        torch.Generator().manual_seed(seed)


def test_rotation_window_and_index_match_nerf_tpu(tmp_path):
    """Seven saves over --max_save 2: two slots and the newest index, the
    same slot sequence and index counters as nerf_tpu's manager; a second
    manager instance continues the count and restores the newest."""
    _, models, opt, gen = _small_state()
    tree = {"w": np.ones(3, np.float32)}
    mgr = CheckpointManager(str(tmp_path / "port"), max_save=2,
                            prefix="model_1_chkpt")
    jmgr = JaxCheckpointManager(str(tmp_path / "jax"), max_save=2,
                                prefix="model_1_chkpt")
    for i in range(7):
        path = mgr.save(models, opt, gen, step=10 * i, epoch=i)
        jpath = jmgr.save(tree, step=10 * i, epoch=i)
        assert os.path.splitext(os.path.basename(path))[0] == \
            os.path.splitext(os.path.basename(jpath))[0]
    assert sorted(os.listdir(tmp_path / "port")) == [
        "model_1_chkpt_1.pt", "model_1_chkpt_2.pt",
        "model_1_chkpt_index.json"]
    idx = json.load(open(tmp_path / "port" / "model_1_chkpt_index.json"))
    jidx = json.load(open(tmp_path / "jax" / "model_1_chkpt_index.json"))
    assert {k: idx[k] for k in jidx} == jidx == {
        "count": 7, "latest_slot": 1, "step": 60, "epoch": 6}
    mgr2 = CheckpointManager(str(tmp_path / "port"), max_save=2,
                             prefix="model_1_chkpt")
    assert mgr2.latest_path() == mgr.slot_path(1)
    assert mgr2.save(models, opt, gen, step=70, epoch=7) == mgr.slot_path(2)
    _, fresh, fopt, fgen = _small_state(seed=5)
    assert load_checkpoint(mgr2.latest_path(), fresh, fopt, fgen) == (70, 7)
    assert CheckpointManager(str(tmp_path / "empty")).latest_path() is None


def test_checkpoint_refuses_a_mismatch(tmp_path):
    """A slot of another model, or a generator state of another device
    type, raises instead of starting quietly."""
    _, models, opt, gen = _small_state("mip")
    mgr = CheckpointManager(str(tmp_path), prefix="m")
    path = mgr.save(models, opt, gen, step=3, epoch=1)
    _, vanilla, vopt, vgen = _small_state()
    with pytest.raises(ValueError, match="holds the nets"):
        load_checkpoint(path, vanilla, vopt, vgen)
    payload = torch.load(path, weights_only=True)
    payload["generator_device"] = "cuda"
    torch.save(payload, path)
    _, fresh, fopt, fgen = _small_state("mip")
    with pytest.raises(ValueError, match="cuda generator"):
        load_checkpoint(path, fresh, fopt, fgen)


# ---------------------------------------------------------------------------
# resume bit for bit in the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["vanilla", "ref", "mip"])
def test_resume_is_bit_exact_in_the_port(scene, tmp_path, model):
    """The counterpart of tests/test_resume_determinism.py:26-54: 6 steps
    straight, against 3 steps, a save through CheckpointManager, a load
    into fresh modules, optimizer and generator, and 3 more.  Picks and
    noise come from the generator, as in the trainer."""
    pool, poses, focal = scene
    sched = schedule.decay_schedule(1e-3, warmup_step=0)

    def steps(state, i0, i1):
        cfg, models, opt, gen = state
        for i in range(i0, i1):
            rays, gt = sample_train_rays(_t(pool), _t(poses), i % 3,
                                         (20, 20), focal, N_RAYS,
                                         generator=gen)
            train_step(models, opt, rays, gt, cfg, sched(i), generator=gen,
                       device="cpu")

    straight = _small_state(model)
    steps(straight, 0, 6)
    first = _small_state(model)
    steps(first, 0, 3)
    mgr = CheckpointManager(str(tmp_path), prefix="model_1_chkpt")
    mgr.save(*first[1:], step=3, epoch=0)
    resumed = _small_state(model, seed=9)     # other weights and draws
    assert load_checkpoint(mgr.latest_path(), *resumed[1:]) == (3, 0)
    steps(resumed, 3, 6)
    for a, b in zip(straight[1], resumed[1]):
        if a is None:
            continue
        for (name, p), q in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(p, q), name


# ---------------------------------------------------------------------------
# resume from nerf_tpu's train state
# ---------------------------------------------------------------------------

K_SAVED = 2


def _trajectory_faults(grad_clip, plant, tmp_path, scene):
    """nerf_tpu trains 5 steps with injected picks and noise and saves its
    TrainState after K_SAVED; the port loads that .ckpt (params and Adam)
    and runs the remaining steps on the same picks and noise.  Returns the
    checks of test_five_step_trajectory_matches_jax that the port's
    trajectory fails.  ``plant`` transposes both Adam moments of one
    square layer after the load."""
    jcfg, cfg = configs(white_bkg=False, use_pallas=True)
    variables = jax_variables(jcfg, **WEIGHTS)
    sched = schedule.decay_schedule(5e-3, warmup_step=3)
    step, tx = _jax_step_fn(jcfg, jschedule.decay_schedule(
        5e-3, warmup_step=3), grad_clip)
    params = jax.tree.map(jnp.asarray, variables)
    opt_state = tx.init(params)
    rng = np.random.default_rng(6)
    draws = [_draws(rng, cfg) for _ in range(5)]
    jl = []
    for i, (img, row, col, jit, u) in enumerate(draws):
        if i == K_SAVED:
            path = jax_save_checkpoint(
                str(tmp_path / "model_1.ckpt"),
                TrainState(params, opt_state, jnp.int32(i)), i, 0)
        jr, jgt = _jax_batch(scene, img, row, col)
        params, opt_state, jm, _ = step(params, opt_state, jr, jgt,
                                        jnp.asarray(jit), jnp.asarray(u))
        jl.append(float(jm["loss"]))
    models = port_models(cfg, jax_variables(jcfg, seed=3))
    opt = make_optimizer(models)
    ckpt = load_nerf_tpu_checkpoint(path)
    bridge.load_flax_train_state(models, opt, ckpt["state"])
    saved = _kernel_tuples(_port_tree(models))
    if plant:
        w = models[0].lin_block1[2].weight
        assert w.shape[0] == w.shape[1]
        for key in ("exp_avg", "exp_avg_sq"):
            m = opt.state[w][key]
            m.copy_(m.T.clone())
    tl = []
    for i in range(K_SAVED, 5):
        img, row, col, jit, u = draws[i]
        r, gt = _port_batch(scene, img, row, col)
        m = train_step(models, opt, r, gt, cfg, sched(i),
                       grad_clip=grad_clip, noise=(_t(jit), _t(u)),
                       device="cpu")
        tl.append(float(m["loss"]))
    faults = []
    if not np.allclose(tl, jl[K_SAVED:], rtol=2 * LOSS_RTOL, atol=0.0):
        faults.append(("losses", tl, jl[K_SAVED:]))
    lr_sum = sum(sched(i) for i in range(K_SAVED, 5))
    for i, (p, w, w0) in enumerate(zip(_kernel_tuples(_port_tree(models)),
                                       _kernel_tuples(params), saved)):
        if np.linalg.norm(p - w) > 0.03 * np.linalg.norm(w - w0):
            faults.append(("distance", i))
        if np.abs(p - w).max() >= 0.5 * lr_sum:
            faults.append(("element", i))
    return faults


@pytest.mark.parametrize("grad_clip", [-1.0, 0.05])
def test_resume_from_nerf_tpu_state_continues_its_trajectory(
        scene, tmp_path, grad_clip):
    """Adam's mu/nu/count, at opt_state["0"]["0"] (or ["1"]["0"] under
    --grad_clip), transposed into torch's exp_avg/exp_avg_sq/step: the port
    continues nerf_tpu's trajectory within the five-step test's
    tolerances.  A clip at 0.05 binds on every step."""
    assert _trajectory_faults(grad_clip, False, tmp_path, scene) == []


def test_a_mistransposed_moment_fails_the_trajectory(scene, tmp_path):
    """The planted fault: a square layer's moments loaded transposed (no
    shape error) part from nerf_tpu's trajectory beyond the tolerances."""
    faults = _trajectory_faults(-1.0, True, tmp_path, scene)
    assert any(f[0] in ("distance", "element") for f in faults), faults


# ---------------------------------------------------------------------------
# the CLI drill
# ---------------------------------------------------------------------------

DRILL_ARGS = ["--dataset_root", "data", "--dataset_name", "lego",
              "--sample_ray_num", "16", "--coarse_sample_pnum", "8",
              "--fine_sample_pnum", "8", "--nerf_net_width", "16",
              "--prop_net_width", "16", "--img_scale", "1.0",
              "--no_tensorboard", "--output_time", "100000",
              "--eval_chunk", "64"]


@pytest.fixture(scope="module")
def drill_dir(tmp_path_factory):
    """A 4-view 16x16 scene in the Blender layout."""
    root = tmp_path_factory.mktemp("drill")
    train, test, (tr_p, te_p) = make_synthetic_scene(
        n_train=4, n_test=1, hw=(16, 16), seed=0, n_samples=16,
        device="cpu")
    write_blender_dataset(str(root / "data" / "lego"), train, tr_p, "train")
    write_blender_dataset(str(root / "data" / "lego"), test, te_p, "test")
    return root


def test_sigterm_checkpoints_and_resumes(drill_dir, monkeypatch, capsys):
    """The counterpart of tests/test_resume_determinism.py:57-115: the
    port's entry in a CPU subprocess, SIGTERM after epoch 3 of 4 images:
    exit 128 + 15 and a slot with step 16 and epoch 3; -l resumes at
    epoch 3, step 16, and runs to the end."""
    script = textwrap.dedent("""
        import os, signal, sys
        from nerf_tpu_torch.cli import trainer
        from nerf_tpu_torch.cli.entry import main
        run_epoch = trainer.Trainer.run_epoch
        def hooked(self, ep):
            out = run_epoch(self, ep)
            if ep == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        trainer.Trainer.run_epoch = hooked
        sys.exit(main(sys.argv[1:], device="cpu"))
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", script, *DRILL_ARGS,
                        "--epochs", "20"], cwd=drill_dir,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 128 + signal.SIGTERM, r.stderr[-2000:]
    assert "signal 15: checkpointed step 16, epoch 3" in r.stdout
    assert "Epoch    3 /   20" in r.stdout
    assert not os.path.exists(drill_dir / "model")     # no final save
    ckdir = drill_dir / "check_points" / "lego"
    idx = json.load(open(ckdir / "model_1_chkpt_index.json"))
    assert (idx["step"], idx["epoch"], idx["count"]) == (16, 3, 1)
    monkeypatch.chdir(drill_dir)
    args = get_parser().parse_args(DRILL_ARGS + ["-l", "--epochs", "5"])
    t = Trainer(args, "cpu")
    assert (t.epoch_start, t.step) == (3, 16)
    t.train()
    assert t.step == 24 and len(t.losses) == 8
    out = capsys.readouterr().out
    assert "Epoch    3 /    5" in out and "Epoch    4 /    5" in out
    assert torch.load(drill_dir / "model" / "model_1_mip.pt",
                      weights_only=True)["train_cnt"] == 24


def test_load_without_a_checkpoint_starts_fresh(drill_dir, tmp_path,
                                                monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    args = get_parser().parse_args(
        DRILL_ARGS + ["--dataset_root", str(drill_dir / "data"), "-l",
                      "--epochs", "1"])
    t = Trainer(args, "cpu")
    assert "Not loading: no checkpoint under" in capsys.readouterr().out
    assert (t.epoch_start, t.step) == (0, 0)


def test_load_resumes_from_nerf_tpu_slots(drill_dir, tmp_path, monkeypatch):
    """-l on a --ckpt_dir that nerf_tpu wrote: its newest .ckpt slot (read
    through the port's msgpack reader) gives the nets, Adam's moments and
    step, the step counter and the epoch; the generator is seeded from
    --seed and the step."""
    monkeypatch.chdir(tmp_path)
    argv = DRILL_ARGS + ["--dataset_root", str(drill_dir / "data"), "-l",
                         "--epochs", "4", "--grad_clip", "0.1"]
    jargs = jax_get_parser().parse_args(argv)
    from nerf_tpu.cli.flags import config_from_args as jax_config

    jcfg = jax_config(jargs)
    params = jax_variables(jcfg, seed=4)
    tx = jax_make_optimizer(jcfg, jschedule.decay_schedule(1e-3),
                            grad_clip=0.1)
    opt_state = tx.init(params)
    grads = jax.tree.map(lambda a: np.full(a.shape, 0.5, np.float32), params)
    for _ in range(2):
        updates, opt_state = tx.update(grads, opt_state, params)
    jmgr = JaxCheckpointManager(os.path.join("check_points", "lego"),
                                max_save=3, prefix="model_1_chkpt")
    jmgr.save(TrainState(params, opt_state, jnp.int32(2)), step=9, epoch=2)
    t = Trainer(get_parser().parse_args(argv), "cpu")
    assert (t.epoch_start, t.step) == (2, 9)
    want = bridge.flax_to_state_dict(params["nerf"], "nerf")
    for k, v in t.models[0].state_dict().items():
        assert torch.equal(v, want[k]), k
    adam = bridge.adam_state(jax.tree.map(np.asarray,
                                          fser.to_state_dict(opt_state)))
    mu = bridge.flax_to_state_dict(adam["mu"]["prop"], "prop")
    w = t.models[1].layers[0].weight
    assert torch.equal(t.optimizer.state[w]["exp_avg"],
                       mu["layers.0.weight"])
    assert float(t.optimizer.state[w]["step"]) == 2.0
    from nerf_tpu_torch.cli.trainer import resume_seed

    assert t.generator.initial_seed() == resume_seed(0, 9)


# ---------------------------------------------------------------------------
# render-only's fallback chain
# ---------------------------------------------------------------------------

SOURCES = ["port_pt", "nerf_tpu_final", "port_slot", "nerf_tpu_slot"]


def _frame_noise(i, cfg, n_pix):
    return eval_noise(np.random.default_rng(100 + i), n_pix, cfg.n_coarse,
                      cfg.n_fine)


def _render_args(extra=()):
    """-r -e on the fixture's two test views at 8x8, the frame size of
    test_render_rays_eval_matches_jax.  At their full 16x16 the packages'
    inverse-CDF depths part by up to 7e-6 (15 ulps; the blurred proposal
    weights by 8e-7 relative, the order of their sums), which moves one of
    768 values by 5.5e-4 at a density edge: the port's two eval routes
    agree within 5e-7 there, and so do nerf_tpu's within 7e-5."""
    _, cfg = configs()
    return ["-r", "-e", "-w", "--dataset_root", FIXTURES, "--dataset_name",
            "lego_mini", "--img_scale", "0.5", "--nerf_net_width",
            str(cfg.nerf_width), "--prop_net_width", str(cfg.prop_width),
            "--coarse_sample_pnum", str(cfg.n_coarse),
            "--fine_sample_pnum", str(cfg.n_fine), "--eval_chunk", "64",
            "--output_dir", "out", *extra]


@pytest.fixture(scope="module")
def render_variables():
    """The eval tests' weights (tests/test_torch_pipeline.py)."""
    return jax_variables(configs()[0], seed=0)


def _jax_frames(monkeypatch, variables):
    """nerf_tpu's render_only on its final .ckpt of ``variables``, with
    each frame rendered on the injected noise of ``_frame_noise``."""
    frames = []

    def frame(params, c2w, hw, focal, cfg, sample_num=None, **kw):
        h, w = hw
        jit, u = _frame_noise(len(frames), cfg, h * w)
        rgb, _ = jax_render_rays_eval(
            jax_make_models(cfg), params,
            jnp.asarray(rays_for(h, w, c2w, focal)), None, cfg,
            sample_num=sample_num, noise=(jnp.asarray(jit), jnp.asarray(u)))
        frames.append(np.asarray(rgb).reshape(h, w, 3))
        return {"rgb": frames[-1]}

    monkeypatch.setattr(jax_render_cli, "render_image", frame)
    jax_save_checkpoint(os.path.join("model", "model_1.ckpt"),
                        {"params": variables}, 5, 1)
    jax_render_cli.render_only(jax_get_parser().parse_args(_render_args()))
    os.remove(os.path.join("model", "model_1.ckpt"))
    return frames


def _write_source(source, variables):
    _, cfg = configs()
    models = port_models(cfg, variables)
    ckdir = os.path.join("check_points", "lego_mini")
    if source == "port_pt":
        save_models("model", "model_1", models, train_cnt=5, epoch=1)
    elif source == "nerf_tpu_final":
        jax_save_checkpoint(os.path.join("model", "model_1.ckpt"),
                            {"params": variables}, 5, 1)
    elif source == "port_slot":
        CheckpointManager(ckdir, prefix="model_1_chkpt").save(
            models, make_optimizer(models), torch.Generator(), 5, 1)
    else:    # nerf_tpu's ddp/ma slot: a leading replica axis of 2
        other = jax_variables(configs()[0], seed=1)
        stacked = jax.tree.map(lambda a, b: np.stack([a, b]), variables,
                               other)
        JaxCheckpointManager(ckdir, prefix="model_1_chkpt").save(
            {"params": stacked}, step=5, epoch=1)


@pytest.mark.parametrize("source", SOURCES)
def test_render_only_falls_back_like_nerf_tpu(source, render_variables,
                                              tmp_path, monkeypatch, capsys):
    """-r -e from each source alone renders nerf_tpu's frames (its
    render_only on the same params and noise) within RGB_TOL, and the
    frames of the port's modules holding those params bit for bit; the
    console names the file with its step and epoch."""
    monkeypatch.chdir(tmp_path)
    want = _jax_frames(monkeypatch, render_variables)
    _write_source(source, render_variables)
    calls = []
    render = render_cli.render_image

    def frame(models, c2w, hw, focal, cfg, **kw):
        kw["noise"] = tuple(map(torch.from_numpy, _frame_noise(
            len(calls), cfg, hw[0] * hw[1])))
        calls.append(((c2w, hw, focal, cfg), kw,
                      render(models, c2w, hw, focal, cfg, **kw)["rgb"]))
        return {"rgb": calls[-1][2]}

    monkeypatch.setattr(render_cli, "render_image", frame)
    capsys.readouterr()
    render_cli.render_only(get_parser().parse_args(_render_args()),
                           device="cpu")
    out = capsys.readouterr().out
    assert "(step 5, epoch 1)" in out
    assert ("chkpt" in out) == source.endswith("slot")
    assert len(calls) == len(want) == 2 and want[0].shape == (8, 8, 3)
    for (args, kw, got), ref in zip(calls, want):
        np.testing.assert_allclose(got, ref, **RGB_TOL)
        direct = render(port_models(args[3], render_variables), *args, **kw)
        np.testing.assert_array_equal(got, direct["rgb"])


def test_render_only_without_a_model_names_all_three(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError) as e:
        render_cli.render_only(get_parser().parse_args(_render_args()),
                               device="cpu")
    for name in ("model_1_mip.pt", "model_1_prop.pt", "model_1.ckpt",
                 os.path.join("check_points", "lego_mini")):
        assert name in str(e.value)
