"""The recompute-form training step of nerf_tpu_torch (``store_residuals=
False``, both models) and the ``ref_kernels="hybrid"`` route against
nerf_tpu: the plain versions of the four recompute kernels (through the
autograd Functions) against their Pallas forms in interpret mode, the
training loss and grads of both models in the recompute form and of the
hybrid route, a 3-step hybrid trajectory, and ``-t --ref_kernels hybrid``
training and rendering through the entry on the CPU.

Small size: the kernels at H = 48, O = 80 (vanilla: bottleneck 40, rgb
layer 24), N = 150 points in 64-row tiles (a ragged last tile); the steps
at hidden 32 with 8 coarse + 16 fine samples (23 merged).  Tolerances:
- the plain kernels against Pallas (forward outputs, d(heads) and every
  grad): f32 rtol 2e-4 / atol 1e-5 (tests/test_ops.py:79), bf16 rtol
  0.05 / atol 0.02 (:117).  In bf16 the spatial backward's plain version
  equals eager ``jax.vjp`` through ``_cd_matmul_rules`` bit for bit; the
  Pallas kernel in interpret mode runs under ``jit``, where XLA keeps the
  bf16 sum of the heads' three pullbacks in f32, which moves the bias grad
  of the last trunk layer by 1.4e-3 of itself (the pinning test below).
  The normal target is compared where |g| > 1e-2, as in
  tests/test_torch_ref_train.py.
- ``compute_loss``: loss terms rtol 1e-4; grads as the existing step tests
  state them (vanilla: relative Frobenius error 2e-3 per weight-tuple
  tensor, tests/test_torch_train.py; Ref-NeRF: rtol 5e-3 / atol 3e-4 on
  the flat vector, tests/test_torch_ref_train.py).
- 3 hybrid steps: losses rtol 2e-4, params as tests/test_torch_ref_train.py.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_common import (
    configs, jax_variables, port_models, two_camera_batch,
)
from nerf_tpu.ops import fused_mlp as jfused
from nerf_tpu.ops import ref_fused as jref
from nerf_tpu.train import schedule as jschedule
from nerf_tpu.train.pipeline import make_models as jax_make_models
from nerf_tpu.train.step import compute_loss as jax_compute_loss
from nerf_tpu.train.step import make_optimizer as jax_make_optimizer
from nerf_tpu_torch import bridge, ops
from nerf_tpu_torch.cli.entry import main
from nerf_tpu_torch.core.encoding import cat_pos_pe
from nerf_tpu_torch.ops.launch import prep_weights
from nerf_tpu_torch.train import schedule
from nerf_tpu_torch.train.pipeline import render_rays_train
from nerf_tpu_torch.train.step import compute_loss, make_optimizer, train_step
from nerf_tpu_torch.utils.metrics import read_scalars
from nerf_tpu_torch.utils.png import read_png

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
TILE = 64
N = 150
H, O = 48, 80
KERNEL_TOLS = {torch.float32: dict(rtol=2e-4, atol=1e-5),
               torch.bfloat16: dict(rtol=0.05, atol=0.02)}
DGRAD_MIN_NORM = 1e-2
LOSS_RTOL = 1e-4
VANILLA_GRAD_REL = 2e-3
REF_GRAD_TOL = dict(rtol=5e-3, atol=3e-4)
N_RAYS = 8
# weights N(0, 1/fan_in), biases N(0, 0.1^2), as the Ref-NeRF step tests
WEIGHTS = dict(gain=1.0, bias_std=0.1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _assert_close(got, want, dtype, name):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, **KERNEL_TOLS[dtype], err_msg=name)


def _weights(rng, mats):
    """f32 numpy weights for matrices ``mats`` (None: the bias of the
    matrix before it): N(0, 1/fan_in) and N(0, 0.1^2)."""
    out = []
    for i, m in enumerate(mats):
        if m is None:
            prev = next(x for x in reversed(mats[:i]) if x is not None)
            out.append(rng.normal(0, 0.1, (1, prev[1])))
        else:
            out.append(rng.normal(0, 1 / np.sqrt(m[0]), m))
    return [w.astype(np.float32) for w in out]


def _spa_mats(dx=63, nb=128):
    h, o = H, O
    return [(dx, h), None, (h, h), None, (h, h), None, (h, h), None,
            (dx, h), (h, h), None, (h, h), None, (h, h), None, (h, o), None,
            (o, 2), None, (o, 9), None, (o, nb), None]


def _dir_mats(n_ch, nb=128):
    h, o, dd = H, O, nb + 2 * n_ch + 1
    return [(dd, h), None, (h, h), None, (h, h), None, (h, h), None,
            (dd, h), (h, h), None, (h, h), None, (h, o), None, (o, o), None,
            (o, 3), None]


def _points(rng, per_ray=15):
    pos = rng.uniform(-1.2, 1.2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N // per_ray, 3))
    scale = rng.uniform(1.0, 1.12, (N // per_ray, 1))
    dirs = d / np.linalg.norm(d, axis=-1, keepdims=True) * scale
    return pos, dirs.astype(np.float32), per_ray


# ---------------------------------------------------------------------------
# the four recompute kernels' plain versions against Pallas (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vanilla_recompute_matches_pallas(dtype):
    """VanillaMLPRecompute (vanilla_mlp_plain, then
    vanilla_mlp_bwd_recompute_plain) against make_vanilla_fused with
    store_residuals=False: rgb3, sigma and the 24 grads for seeded
    cotangents of both outputs."""
    rng = np.random.default_rng(0)
    h, bn, r = H, 40, 24
    ws = _weights(rng, [(63, h), None, (h, h), None, (h, h), None, (h, h),
                        None, (63, h), (h, h), None, (h, h), None, (h, bn),
                        None, (bn, 1), None, (bn, bn), None, (bn, r),
                        (27, r), None, (r, 3), None])
    x = _t(rng.uniform(-1, 1, (N, 63)).astype(np.float32)).to(dtype)
    d = _t(rng.uniform(-1, 1, (N, 27)).astype(np.float32)).to(dtype)
    g_rgb = rng.normal(size=(3, N)).astype(np.float32)
    g_sig = rng.normal(size=N).astype(np.float32)
    cd = _jdt(dtype)
    fused = jfused.make_vanilla_fused(cd, TILE, True, store_residuals=False)
    jx, jd = (jnp.asarray(a.float().numpy(), cd) for a in (x, d))
    (jrgb3, jsig), vjp = jax.vjp(lambda w: fused(w, jx, jd),
                                 tuple(map(jnp.asarray, ws)))
    (jgrads,) = vjp((jnp.asarray(g_rgb), jnp.asarray(g_sig)))

    params = [_t(w).requires_grad_() for w in ws]
    ops.reset_launches()
    rgb3, sig = ops.VanillaMLPRecompute.apply("cpu", x, d, *params)
    grads = torch.autograd.grad((rgb3, sig), params, (_t(g_rgb), _t(g_sig)))
    assert not any(ops.LAUNCHES.values())
    assert float(np.asarray(jrgb3).std()) > 0.01
    _assert_close(rgb3, jrgb3, dtype, "rgb3")
    _assert_close(sig, jsig, dtype, "sigma")
    assert len(grads) == 24
    for i, (a, b) in enumerate(zip(grads, jgrads)):
        _assert_close(a, b, dtype, f"grad {i}")


def _spa_case(dtype, seed=1):
    rng = np.random.default_rng(seed)
    ws = _weights(rng, _spa_mats())
    pos, _, _ = _points(rng)
    enc = cat_pos_pe(_t(pos), 10, dtype)
    g_heads = rng.normal(size=(N, jref.SPA_HEAD_DIM)).astype(np.float32)
    return ws, pos, enc, g_heads


def _pallas_spa(ws, enc, pos, g_heads, dtype):
    """_make_spa_fused(store_residuals=False) in interpret mode: heads,
    the normal target (N, 3) and the 23 grads."""
    cd = _jdt(dtype)
    spa = jref._make_spa_fused(cd, TILE, True, True, store_residuals=False)
    jenc = jnp.asarray(enc.float().numpy(), cd)
    (heads, dgrad3), vjp = jax.vjp(lambda w: spa(w, jenc, jnp.asarray(pos)),
                                   tuple(map(jnp.asarray, ws)))
    (grads,) = vjp((jnp.asarray(g_heads), jnp.zeros((3, N), jnp.float32)))
    return heads, np.asarray(dgrad3).T, grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spatial_recompute_matches_pallas(dtype):
    """RefSpatialMLPRecompute (ref_spa_fwd_grad_plain,
    ref_spa_bwd_recompute_plain) against the store_residuals=False spatial
    pair of make_ref_fused: heads, the normal target and the 23 grads."""
    ws, pos, enc, g_heads = _spa_case(dtype)
    jheads, jdgrad, jgrads = _pallas_spa(ws, enc, pos, g_heads, dtype)
    params = [_t(w).requires_grad_() for w in ws]
    heads, dgrad = ops.RefSpatialMLPRecompute.apply("cpu", TILE, enc,
                                                    _t(pos), *params)
    assert not dgrad.requires_grad
    grads = torch.autograd.grad(heads, params, _t(g_heads))
    _assert_close(heads, jheads, dtype, "heads")
    wsc = prep_weights([w.detach() for w in params],
                       ops.ref_fused.REF_SPA_BIASES, dtype)
    _, _, acts = ops.ref_spa_fwd_res_plain(wsc, enc, _t(pos))
    g = ops.ref_fused.density_grad_plain(wsc, enc, _t(pos), acts)
    live = torch.linalg.vector_norm(g, dim=-1) > DGRAD_MIN_NORM
    assert int(live.sum()) >= N - 4, int(live.sum())
    _assert_close(dgrad[live], jdgrad[live.numpy()], dtype, "normal target")
    assert len(grads) == 23
    for i, (a, b) in enumerate(zip(grads, jgrads)):
        _assert_close(a, b, dtype, f"grad {i}")


def test_spatial_recompute_sums_as_jax_vjp():
    """The recompute backward's own rules, in bf16: d(inter) sums the heads'
    pullbacks as (bn + nct) + rt, rounding after each add (eager jax.vjp's
    order), and the heads' bias grads sum the f32 cotangent.  The plain
    version meets eager jax.vjp through _cd_matmul_rules on every grad to
    f32 summation order (relative error 1e-6; the weight grads, rounded to
    bf16, are equal); the residual form's hand rules read 1e-3 or more away
    on the 11 bias grads that the two rules move (the Pallas kernel under
    jit sits 1.4e-3 away on db7 only, see the module docstring)."""
    dtype, cd = torch.bfloat16, jnp.bfloat16
    ws, pos, enc, g_heads = _spa_case(dtype)
    wsc = prep_weights([_t(w) for w in ws], ops.ref_fused.REF_SPA_BIASES,
                       dtype)
    jws = tuple(jnp.asarray(w.float().numpy(),
                            jnp.float32 if w.shape[0] == 1 else cd)
                for w in wsc)
    jenc = jnp.asarray(enc.float().numpy(), jnp.float32)

    def full(w):
        return jnp.concatenate(jref._spa_pure(w, jenc, cd, bwd_cd=True), 1)

    # one tile: the weight grads are rounded to bf16 once, as the plain
    # version rounds each tile's
    _, vjp = jax.vjp(full, jws)
    (want,) = vjp(jnp.asarray(g_heads))
    got = ops.ref_spa_bwd_recompute_plain(wsc, enc, _t(g_heads), tile=N)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _rel(a.numpy(), b) < 1e-6, (i, _rel(a.numpy(), b))
    acts, _ = ops.ref_fused._spa_forward(wsc, enc)
    res = ops.ref_spa_bwd_plain(wsc, enc, _t(g_heads), acts, tile=N)
    moved = [_rel(res[i].numpy(), want[i])
             for i in (1, 3, 5, 7, 10, 12, 14, 16, 18, 20, 22)]
    assert min(moved) > 1e-3, moved


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ide_level, use_srgb", [(4, False), (4, True),
                                                 (2, False)])
def test_directional_recompute_matches_pallas(dtype, ide_level, use_srgb):
    """RefDirectionalMLPRecompute (ref_dir_plain, then
    ref_dir_bwd_recompute_plain) against the store_residuals=False
    directional pair of make_ref_fused, with a seeded bottleneck noise:
    rgb, normal, density, d(heads) and the 19 grads for seeded cotangents
    of all three outputs."""
    from nerf_tpu.core.encoding import ide_tables

    rng = np.random.default_rng(2)
    ws = _weights(rng, _dir_mats(ide_tables(ide_level)["n_ch"]))
    _, dirs, per_ray = _points(rng)
    heads = _t(rng.normal(size=(N, jref.SPA_HEAD_DIM)).astype(np.float32))
    noise = _t(rng.normal(0, 0.02, (N, 128)).astype(np.float32)).to(dtype)
    g_rgb, g_nrm = rng.normal(size=(2, N, 3)).astype(np.float32)
    g_den = rng.normal(size=N).astype(np.float32)
    cd = _jdt(dtype)
    dr = jref._make_dir_fused(cd, TILE, True, ide_level, use_srgb,
                              store_residuals=False)
    jnoise = jnp.asarray(noise.float().numpy(), cd)
    dirs3 = jnp.asarray(np.repeat(dirs, per_ray, 0).T.copy())
    (jrgb3, jnrm3, jden), vjp = jax.vjp(
        lambda w, hh: dr(w, hh, jnoise, dirs3), tuple(map(jnp.asarray, ws)),
        jnp.asarray(heads.numpy()))
    jgrads, jdheads = vjp((jnp.asarray(g_rgb.T), jnp.asarray(g_nrm.T),
                           jnp.asarray(g_den)))

    params = [_t(w).requires_grad_() for w in ws]
    hv = heads.clone().requires_grad_()
    rgb, normal, density = ops.RefDirectionalMLPRecompute.apply(
        "cpu", TILE, hv, _t(dirs), noise, per_ray, ide_level, use_srgb, dtype,
        *params)
    assert float(np.asarray(jrgb3).std()) > 0.01   # not saturated
    for name, a, b in (("rgb", rgb, np.asarray(jrgb3).T),
                       ("normal", normal, np.asarray(jnrm3).T),
                       ("density", density, jden)):
        _assert_close(a, b, dtype, name)
    got = torch.autograd.grad((rgb, normal, density), (hv, *params),
                              (_t(g_rgb), _t(g_nrm), _t(g_den)))
    _assert_close(got[0], jdheads, dtype, "dheads")
    assert len(got) == 20
    for i, (a, b) in enumerate(zip(got[1:], jgrads)):
        _assert_close(a, b, dtype, f"grad {i}")


def test_recompute_wrappers_check_operands():
    """The recompute wrappers check what their kernels take, on the CPU as
    on the card; without a card they refuse to run quietly."""
    rng = np.random.default_rng(3)
    spa = prep_weights([_t(w) for w in _weights(rng, _spa_mats())],
                       ops.ref_fused.REF_SPA_BIASES, torch.float32)
    enc, pos = torch.zeros((14, 63)), torch.zeros((14, 3))
    heads, dgrad = ops.ref_spa_fwd_grad(spa, enc, pos, device="cpu")
    assert heads.shape == (14, 139) and dgrad.shape == (14, 3)
    with pytest.raises(ValueError, match="pos must be"):
        ops.ref_spa_fwd_grad(spa, enc, pos[:7], device="cpu")
    with pytest.raises(ValueError, match="g_heads must be"):
        ops.ref_spa_bwd_recompute(spa, enc, heads[:, :100].contiguous(),
                                  device="cpu")
    with pytest.raises(ValueError, match="tile must be positive"):
        ops.ref_spa_bwd_recompute(spa, enc, heads, tile=0, device="cpu")
    from nerf_tpu.core.encoding import ide_tables
    dr = prep_weights([_t(w) for w in _weights(
        rng, _dir_mats(ide_tables(4)["n_ch"]))],
        ops.ref_fused.REF_DIR_BIASES, torch.float32)
    g = torch.zeros((14, 3))
    with pytest.raises(ValueError, match="g_density must be"):
        ops.ref_dir_bwd_recompute(dr, heads, torch.ones((2, 3)), 7, None, g,
                                  g, g, device="cpu")
    with pytest.raises(ValueError, match="g_sigma must be"):
        ops.vanilla_mlp_bwd_recompute(
            ops.fused_mlp.prep_weights(
                [_t(w) for w in _weights(rng, [
                    (63, 8), None, (8, 8), None, (8, 8), None, (8, 8), None,
                    (63, 8), (8, 8), None, (8, 8), None, (8, 8), None,
                    (8, 1), None, (8, 8), None, (8, 4), (27, 4), None,
                    (4, 3), None])], torch.float32),
            enc, torch.zeros((14, 27)), torch.zeros((3, 14)),
            torch.zeros(13), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ops.ref_spa_bwd_recompute(spa, enc, heads)


# ---------------------------------------------------------------------------
# the training step: recompute form and hybrid route against nerf_tpu
# ---------------------------------------------------------------------------

def _cfgs(model, **kw):
    base = dict(model=model, pallas_tile=TILE, white_bkg=False,
                use_pallas=True)
    if model == "ref":
        base["bottleneck_noise"] = 0.0
    return configs(**{**base, **kw})


@functools.lru_cache(maxsize=None)
def _variables(model):
    return jax_variables(_cfgs(model)[0], seed=0, **WEIGHTS)


def _batch(seed: int):
    _, cfg = _cfgs("ref")
    return two_camera_batch(seed, N_RAYS, cfg.n_coarse, cfg.n_fine)


def _loss_and_grads(model, **kw):
    jcfg, cfg = _cfgs(model, **kw)
    v = _variables(model)
    rays, gt, jit, u = _batch(1)
    (jloss, jm), jg = jax.value_and_grad(
        lambda prm: jax_compute_loss(jax_make_models(jcfg), prm,
                                     jnp.asarray(rays), jnp.asarray(gt),
                                     None, jcfg, noise=(jnp.asarray(jit),
                                                        jnp.asarray(u))),
        has_aux=True)(jax.tree.map(jnp.asarray, v))
    models = port_models(cfg, v)
    ops.reset_launches()
    loss, m = compute_loss(models, _t(rays), _t(gt), cfg,
                           noise=(_t(jit), _t(u)), device="cpu")
    loss.backward()
    assert not any(ops.LAUNCHES.values())
    keys = ("loss", "img_loss", "prop_loss") + (
        ("normal_loss", "bf_loss") if model == "ref" else ())
    for k in keys:
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
        assert float(m[k].detach()) > 0.0, k
    nerf, prop = models
    got = {"nerf": bridge.state_dict_to_flax(
               {k: p.grad for k, p in nerf.named_parameters()},
               "ref" if model == "ref" else "nerf"),
           "prop": bridge.state_dict_to_flax(
               {k: p.grad for k, p in prop.named_parameters()}, "prop")}
    return got, jax.tree.map(np.asarray, jg)


@pytest.mark.parametrize("model, kw", [
    ("vanilla", dict(store_residuals=False, prop_store_residuals=None)),
    ("ref", dict(store_residuals=False))])
def test_compute_loss_recompute_matches_jax(model, kw):
    """Loss, metrics and every parameter grad of the step with
    store_residuals=False: nerf_tpu's Pallas recompute kernels (interpret
    mode) against the port's recompute Functions (plain versions).  With
    prop_store_residuals=None the proposal net follows store_residuals into
    its (ported) recompute pair."""
    got, want = _loss_and_grads(model, **kw)
    if model == "vanilla":
        from nerf_tpu.ops import (
            prop_weights_from_params, vanilla_weights_from_params,
        )

        for net, fn in (("nerf", vanilla_weights_from_params),
                        ("prop", prop_weights_from_params)):
            for i, (a, b) in enumerate(zip(fn(got[net]), fn(want[net]))):
                a, b = np.asarray(a), np.asarray(b)
                assert a.shape == b.shape and _rel(a, b) < VANILLA_GRAD_REL, \
                    (net, i, _rel(a, b))
        return
    flat_got, _ = jax.flatten_util.ravel_pytree(got)
    flat_want, _ = jax.flatten_util.ravel_pytree(want)
    np.testing.assert_allclose(np.asarray(flat_got), np.asarray(flat_want),
                               **REF_GRAD_TOL)


@pytest.mark.parametrize("prop_normal", [False, True])
def test_compute_loss_hybrid_matches_jax(prop_normal):
    """The same for ref_kernels="hybrid": nerf_tpu's Pallas spatial kernel
    and flax directional branch against the port's RefSpatialMLPRecompute
    and RefNeRF.directional; with --prop_normal also the proposal net's
    coarse normals."""
    got, want = _loss_and_grads("ref", ref_kernels="hybrid",
                                prop_normal=prop_normal)
    flat_got, _ = jax.flatten_util.ravel_pytree(got)
    flat_want, _ = jax.flatten_util.ravel_pytree(want)
    np.testing.assert_allclose(np.asarray(flat_got), np.asarray(flat_want),
                               **REF_GRAD_TOL)


def test_hybrid_three_step_trajectory_matches_jax():
    """Three Adam steps of the hybrid route, fresh rays and noise per step:
    the per-step losses and the final parameters."""
    jcfg, cfg = _cfgs("ref", ref_kernels="hybrid")
    v = _variables("ref")
    jsched = jschedule.decay_schedule(5e-3, warmup_step=2)
    sched = schedule.decay_schedule(5e-3, warmup_step=2)
    models_j = jax_make_models(jcfg)
    tx = jax_make_optimizer(jcfg, jsched)

    @jax.jit
    def jstep(params, opt_state, rays, gt, jit, u):
        (loss, _), grads = jax.value_and_grad(
            lambda p: jax_compute_loss(models_j, p, rays, gt, None, jcfg,
                                       noise=(jit, u)), has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    params = jax.tree.map(jnp.asarray, v)
    opt_state = tx.init(params)
    models = port_models(cfg, v)
    opt = make_optimizer(models)
    jl, tl = [], []
    for i in range(3):
        rays, gt, jit, u = _batch(10 + i)
        params, opt_state, jloss = jstep(params, opt_state, rays, gt, jit, u)
        jl.append(float(jloss))
        m = train_step(models, opt, _t(rays), _t(gt), cfg, sched(i),
                       noise=(_t(jit), _t(u)), device="cpu")
        tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=2 * LOSS_RTOL)
    lr_sum = sum(sched(i) for i in range(3))
    nerf, prop = models
    got = {"nerf": bridge.state_dict_to_flax(nerf.state_dict(), "ref"),
           "prop": bridge.state_dict_to_flax(prop.state_dict(), "prop")}
    for p, w, w0 in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(params),
                        jax.tree_util.tree_leaves(v)):
        p, w, w0 = (np.asarray(a) for a in (p, w, w0))
        assert np.linalg.norm(p - w) <= 0.03 * np.linalg.norm(w - w0)
        assert np.abs(p - w).max() < 0.5 * lr_sum


def test_recompute_and_hybrid_routes_run_without_raising():
    """Both models run with store_residuals=False, and the hybrid route
    with either form; the proposal net's residual pair raises, naming its
    item, and an unknown ref_kernels is refused."""
    rays, _, jit, u = _batch(3)
    for model, kw in (("vanilla", dict(store_residuals=False)),
                      ("ref", dict(store_residuals=False)),
                      ("ref", dict(ref_kernels="hybrid")),
                      ("ref", dict(ref_kernels="hybrid",
                                   store_residuals=False))):
        _, cfg = _cfgs(model, **kw)
        out = render_rays_train(port_models(cfg, _variables(model)),
                                _t(rays), cfg, noise=(_t(jit), _t(u)),
                                device="cpu")
        assert torch.isfinite(out["fine_rgb"]).all(), (model, kw)
    _, cfg = _cfgs("ref", ref_kernels="hybrid", prop_store_residuals=True)
    with pytest.raises(NotImplementedError, match="B1"):
        render_rays_train(port_models(cfg, _variables("ref")), _t(rays), cfg,
                          device="cpu")
    cfg = cfg.replace(ref_kernels="xla", prop_store_residuals=False)
    with pytest.raises(ValueError, match="unknown ref_kernels"):
        render_rays_train(port_models(cfg, _variables("ref")), _t(rays), cfg,
                          device="cpu")


# ---------------------------------------------------------------------------
# the entry
# ---------------------------------------------------------------------------

def test_hybrid_training_end_to_end_on_cpu(tmp_path, monkeypatch, capsys):
    """``-t --ref_kernels hybrid --epochs 2`` through the entry on the
    7-view fixture (14 steps, the normal and back-face losses logged, a
    RefNeRF checkpoint); then ``-t -r -e --ref_kernels hybrid
    --render_normal`` renders it."""
    _, cfg = _cfgs("ref")
    monkeypatch.chdir(tmp_path)
    common = ["-t", "--ref_kernels", "hybrid", "--dataset_root", FIXTURES,
              "--dataset_name", "lego_mini", "--img_scale", "0.5", "-w",
              "--nerf_net_width", str(cfg.nerf_width), "--prop_net_width",
              str(cfg.prop_width), "--coarse_sample_pnum", str(cfg.n_coarse),
              "--fine_sample_pnum", str(cfg.n_fine), "--eval_chunk", "64",
              "--output_dir", str(tmp_path / "out"), "--render_normal"]
    assert main(common + ["--epochs", "2", "--sample_ray_num", "32",
                          "--output_time", "1", "--eval_time", "1",
                          "--log_dir", str(tmp_path / "logs"),
                          "--no_tensorboard"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "model=ref" in out and out.count("rays/s") == 2
    (log,) = list((tmp_path / "logs").glob("*/*/metrics.jsonl"))
    for tag in ("Train Loss", "Normal Loss", "Backface Loss"):
        vals = [x for _, x in read_scalars(str(log), tag)]
        assert len(vals) == 14 and np.isfinite(vals).all(), tag
    sd = torch.load(tmp_path / "model" / "model_1_mip.pt",
                    weights_only=True)
    assert (sd["train_cnt"], sd["epoch"]) == (14, 2)
    assert main(common + ["-r", "-e"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "(step 14, epoch 2)" in out and "Mean PSNR" in out
    grid = read_png(str(tmp_path / "out" / "given" / "result_000.png"))
    assert grid.shape[:2] == (8, 3 * 10 - 2)   # rgb, normal, ground truth
    assert grid[:, 10:18].std() > 0.0
