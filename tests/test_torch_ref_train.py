"""The Ref-NeRF training slice of nerf_tpu_torch against nerf_tpu: the merge's
index bookkeeping, the normal and back-face losses, the plain versions of the
four training kernels (through the two autograd Functions) against the Pallas
kernels in interpret mode, the training loss and grads on both MLP routes, a
3-step trajectory, and ``-t`` training and rendering through the entry on
the CPU.

Small size: hidden 32, output_dim 256, bottleneck 128, 8 rays of 8 coarse +
16 fine samples (23 merged), Pallas tile 64.  Tolerances:
- ``count_lt``, ``count_le``, the training merge (``coarse_pos``,
  ``idx_full``) and ``legacy_coarse_positions``: exact, ties included.
- the normal and back-face losses: f32 rtol 1e-6.
- the PE tables: exact.
- the plain kernels against Pallas (heads, activations, rgb/normal/density,
  d(heads) and the 42 grads): f32 rtol 2e-4 / atol 1e-5
  (tests/test_ref_fused.py:185), bf16 rtol 0.05 / atol 0.02.  Both round at
  the same places and part by f32 summation order, in bf16 now and then by
  one bf16 ulp that later layers carry.  The normal target -g / max(1e-5,
  |g|) is compared where |g| > 1e-2, a thousand times the clamp: near the
  clamp a unit vector's direction is set by rounding noise (at most a few
  of the 184 points, counted).
- ``compute_loss`` against JAX's (f32, bottleneck noise off, the same
  jitter and uniforms): loss rtol 1e-4, grads rtol 5e-3 / atol 3e-4
  (tests/test_ref_fused.py:215-219), on the kernel route (Pallas in
  interpret mode / plain versions) and the module route (flax /
  ``RefNeRF``).
- 3 steps: losses rtol 2e-4, params as tests/test_torch_train.py states.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

from torch_port_common import configs, jax_variables, port_models
from nerf_tpu import ops as jops
from nerf_tpu.core import rays as jrays
from nerf_tpu.core import sampling as jsampling
from nerf_tpu.core.fastmath import _pe_tables
from nerf_tpu.ops import fused_mlp as jfused
from nerf_tpu.ops import ref_fused as jref
from nerf_tpu.train import losses as jlosses
from nerf_tpu.train import schedule as jschedule
from nerf_tpu.train.pipeline import make_models as jax_make_models
from nerf_tpu.train.step import compute_loss as jax_compute_loss
from nerf_tpu.train.step import legacy_coarse_positions as jlegacy
from nerf_tpu.train.step import make_optimizer as jax_make_optimizer
from nerf_tpu_torch import bridge, ops
from nerf_tpu_torch.cli.entry import main
from nerf_tpu_torch.core import sampling
from nerf_tpu_torch.core.encoding import cat_pos_pe
from nerf_tpu_torch.train import losses, schedule
from nerf_tpu_torch.train.step import (
    compute_loss, legacy_coarse_positions, make_optimizer, train_parameters,
    train_step,
)
from nerf_tpu_torch.utils.metrics import read_scalars
from nerf_tpu_torch.utils.png import read_png

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
FOV = 0.6911112070083618          # lego's camera_angle_x
TILE = 64
N_RAYS = 8
KERNEL_TOLS = {torch.float32: dict(rtol=2e-4, atol=1e-5),
               torch.bfloat16: dict(rtol=0.05, atol=0.02)}
LOSS_RTOL = 1e-4
STEP_GRAD_TOL = dict(rtol=5e-3, atol=3e-4)
DGRAD_MIN_NORM = 1e-2
# weights N(0, 1/fan_in), biases N(0, 0.1^2): densities of a few units, rays
# partly transparent, every loss term and grad live
WEIGHTS = dict(gain=1.0, bias_std=0.1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _cfgs(**kw):
    return configs(**{"model": "ref", "pallas_tile": TILE,
                      "bottleneck_noise": 0.0, "white_bkg": False, **kw})


@functools.lru_cache(maxsize=None)
def _variables(ide_level=4, seed=0):
    return jax_variables(_cfgs(ide_level=ide_level)[0], seed=seed, **WEIGHTS)


# ---------------------------------------------------------------------------
# merge, losses, tables
# ---------------------------------------------------------------------------

def _depths(ties: bool):
    rng = np.random.default_rng(7)
    c_z = np.sort(rng.uniform(2.0, 6.0, (9, 8)), -1).astype(np.float32)
    f_z = np.sort(rng.uniform(2.0, 6.0, (9, 17)), -1).astype(np.float32)
    f_idx = np.sort(rng.integers(0, 7, (9, 17)), -1).astype(np.int32)
    if ties:
        f_z[:, ::3] = c_z[:, :6]
        f_z = np.sort(f_z, -1)
        f_z[0] = c_z[0, 0]           # one ray whose samples are all equal
        c_z[0] = c_z[0, 0]
    return c_z, f_z, f_idx


@pytest.mark.parametrize("ties", [False, True])
def test_counts_and_training_merge_match_exactly(ties):
    c_z, f_z, f_idx = _depths(ties)
    for ours, theirs in ((sampling.count_lt, jsampling.count_lt),
                         (sampling.count_le, jsampling.count_le)):
        for a, b in ((c_z, f_z), (f_z, c_z)):
            np.testing.assert_array_equal(
                ours(_t(a), _t(b)).numpy(),
                np.asarray(theirs(jnp.asarray(a), jnp.asarray(b))))
    z, cpos, idx = sampling.merge_coarse_fine(_t(c_z), _t(f_z), _t(f_idx))
    jz, _, jcpos, jidx = jsampling.merge_coarse_fine(
        jnp.asarray(c_z), jnp.asarray(f_z), jnp.asarray(f_idx))
    _, _, sidx = jsampling.merge_coarse_fine_via_sort(
        jnp.asarray(c_z), jnp.asarray(f_z), jnp.asarray(f_idx))
    assert idx.shape == (9, 25) and cpos.shape == (9, 8)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(cpos.numpy(), np.asarray(jcpos))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(sidx))
    np.testing.assert_array_equal(
        sampling.merge_coarse_fine(_t(c_z), _t(f_z)).numpy(), np.asarray(jz))


def test_legacy_coarse_positions_match_exactly():
    c_z, f_z, _ = _depths(True)
    cpos = jsampling.merge_coarse_fine(jnp.asarray(c_z), jnp.asarray(f_z))[2]
    for last in (np.full(9, 16), np.arange(9) * 3, np.array([0, 24] * 4 + [5])):
        want = jlegacy(cpos, jnp.asarray(last, jnp.int32))
        got = legacy_coarse_positions(_t(np.asarray(cpos)), _t(last))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_normal_losses_match_jax():
    rng = np.random.default_rng(2)
    w = rng.uniform(0, 1, (10, 16)).astype(np.float32)
    dn, pn = rng.normal(size=(2, 10, 16, 3)).astype(np.float32)
    d = rng.normal(size=(10, 3)).astype(np.float32)
    want = jlosses.weighted_normal_loss_rl(
        jnp.asarray(w), jnp.moveaxis(dn, -1, 0), jnp.moveaxis(pn, -1, 0))
    np.testing.assert_allclose(
        float(losses.weighted_normal_loss(_t(w), _t(dn), _t(pn))),
        float(want), rtol=1e-6)
    want = jlosses.backface_loss_rl(jnp.asarray(w), jnp.moveaxis(pn, -1, 0),
                                    jnp.asarray(d))
    got = losses.backface_loss(_t(w), _t(pn), _t(d))
    assert float(got) > 0.0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_pe_tables_match_the_original():
    for levels in (4, 10):
        for got, want in zip(ops.ref_fused.pe_tables(levels, 3),
                             _pe_tables(levels, 3)):
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the four training kernels' plain versions against Pallas (interpret mode)
# ---------------------------------------------------------------------------

def _points(rng, r=N_RAYS, p=23):
    pos = rng.uniform(-1.2, 1.2, (r * p, 3)).astype(np.float32)
    scale = rng.uniform(1.0, 1.12, (r, 1))
    d = rng.normal(size=(r, 3))
    dirs = (d / np.linalg.norm(d, axis=-1, keepdims=True) * scale)
    return pos, dirs.astype(np.float32), p


def _pallas_spa_res(ws, enc, pos, cd):
    """``_make_spa_fwd_kernel(need_grad=True, store_acts=True)`` in
    interpret mode as ``_fwd_impl`` calls it: heads, the normal target
    (N, 3) and the 8 activations, unpadded."""
    ws = tuple(w.astype(jnp.float32) if w.shape[0] == 1 else w.astype(cd)
               for w in ws)
    n = enc.shape[0]
    x = jfused._pad_rows(enc.astype(cd), TILE)
    pe_w, pe_b = _pe_tables((enc.shape[1] - 3) // 6, 3)
    extra = (jfused._pad_rows(pos, TILE), jnp.asarray(pe_w),
             jnp.asarray(pe_b).reshape(1, -1))
    np_ = x.shape[0]
    h, o = ws[2].shape[0], ws[15].shape[1]
    widths = (h,) * 7 + (o,)
    outs = pl.pallas_call(
        jref._make_spa_fwd_kernel(cd, True, store_acts=True),
        grid=(np_ // TILE,),
        in_specs=[jfused._row_spec(TILE, x.shape[1]),
                  jfused._row_spec(TILE, 3), jfused._full_spec(pe_w.shape),
                  jfused._full_spec((1, pe_b.shape[0]))]
        + [jfused._full_spec(w.shape) for w in ws],
        out_specs=tuple([jfused._row_spec(TILE, jref.SPA_HEAD_DIM),
                         jfused._col_spec(3, TILE)]
                        + [jfused._row_spec(TILE, w) for w in widths]),
        out_shape=tuple(
            [jax.ShapeDtypeStruct((np_, jref.SPA_HEAD_DIM), jnp.float32),
             jax.ShapeDtypeStruct((3, np_), jnp.float32)]
            + [jax.ShapeDtypeStruct((np_, w), cd) for w in widths]),
        interpret=True)(x, *extra, *ws)
    return outs[0][:n], outs[1][:, :n].T, [a[:n] for a in outs[2:]]


def _pallas_dir_res(ws, heads, noise, dirs3, cd, ide_level, use_srgb):
    """``_make_dir_fwd_kernel(store_acts=True)`` in interpret mode: the 8
    activations, unpadded."""
    from nerf_tpu.core.encoding import ide_tables

    ws = tuple(w.astype(jnp.float32) if w.shape[0] == 1 else w.astype(cd)
               for w in ws)
    tables = ide_tables(ide_level)
    mat = np.asarray(tables["mat"], np.float32)
    sigma = np.asarray(tables["sigma"], np.float32).reshape(1, -1)
    n = heads.shape[0]
    h = jfused._pad_rows(heads, TILE)
    nz = jfused._pad_rows(noise, TILE)
    d = jfused._pad_cols(dirs3, TILE)
    np_ = h.shape[0]
    widths = (ws[2].shape[1],) * 6 + (ws[13].shape[1], ws[15].shape[1])
    outs = pl.pallas_call(
        jref._make_dir_fwd_kernel(cd, ide_level, use_srgb, True,
                                  store_acts=True),
        grid=(np_ // TILE,),
        in_specs=[jfused._row_spec(TILE, h.shape[1]),
                  jfused._row_spec(TILE, nz.shape[1]),
                  jfused._col_spec(3, TILE), jfused._full_spec(mat.shape),
                  jfused._full_spec(sigma.shape)]
        + [jfused._full_spec(w.shape) for w in ws],
        out_specs=tuple([jfused._col_spec(3, TILE), jfused._col_spec(3, TILE),
                         jfused._col_spec(1, TILE)]
                        + [jfused._row_spec(TILE, w) for w in widths]),
        out_shape=tuple(
            [jax.ShapeDtypeStruct((3, np_), jnp.float32)] * 2
            + [jax.ShapeDtypeStruct((1, np_), jnp.float32)]
            + [jax.ShapeDtypeStruct((np_, w), cd) for w in widths]),
        interpret=True)(h, nz, d, mat, sigma, *ws)
    return [a[:n] for a in outs[3:]]


def _assert_close(got, want, dtype, name):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, **KERNEL_TOLS[dtype], err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spatial_function_matches_pallas(dtype):
    """RefSpatialMLP (ref_spa_fwd_res_plain, ref_spa_bwd_plain) against the
    store_residuals spatial pair of make_ref_fused: heads, normal target,
    the 8 activations and the 23 grads for a seeded heads cotangent."""
    cd = _jdt(dtype)
    v = _variables()
    nerf, _ = port_models(_cfgs(use_bf16=dtype == torch.bfloat16)[1], v)
    pos, _, _ = _points(np.random.default_rng(3))
    n = pos.shape[0]
    enc = cat_pos_pe(_t(pos), 10, dtype)
    jenc = jnp.asarray(enc.float().numpy(), cd)
    jws = jops.ref_spatial_weights_from_params(v["nerf"])
    jheads, jdgrad, jacts = _pallas_spa_res(jws, jenc, jnp.asarray(pos), cd)
    g_heads = np.random.default_rng(4).normal(
        size=(n, jref.SPA_HEAD_DIM)).astype(np.float32)
    spa = jref._make_spa_fused(cd, TILE, True, True, store_residuals=True)
    _, vjp = jax.vjp(lambda w: spa(w, jenc, jnp.asarray(pos)), jws)
    (jgrads,) = vjp((jnp.asarray(g_heads), jnp.zeros((3, n), jnp.float32)))

    params = nerf.kernel_params()[0]
    heads, dgrad = ops.RefSpatialMLP.apply("cpu", TILE, enc, _t(pos),
                                           *params)
    assert not dgrad.requires_grad
    grads = torch.autograd.grad(heads, params, _t(g_heads))
    _assert_close(heads, jheads, dtype, "heads")
    g = ops.ref_fused.density_grad_plain(
        nerf.kernel_weights()[0], enc, _t(pos),
        ops.ref_spa_fwd_res_plain(nerf.kernel_weights()[0], enc,
                                  _t(pos))[2])
    live = torch.linalg.vector_norm(g, dim=-1) > DGRAD_MIN_NORM
    assert int(live.sum()) >= n - 4, int(live.sum())
    _assert_close(dgrad[live], np.asarray(jdgrad)[live.numpy()], dtype,
                  "normal target")
    _, _, acts = ops.ref_spa_fwd_res(nerf.kernel_weights()[0], enc, _t(pos),
                                     device="cpu")
    for i, (a, ja) in enumerate(zip(acts, jacts)):
        assert a.dtype == dtype
        _assert_close(a, ja, dtype, f"activation {i}")
    assert len(grads) == 23
    for i, (a, b) in enumerate(zip(grads, jgrads)):
        _assert_close(a, b, dtype, f"grad {i}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ide_level, use_srgb", [(4, False), (4, True),
                                                 (2, False)])
def test_directional_function_matches_pallas(dtype, ide_level, use_srgb):
    """RefDirectionalMLP (ref_dir_fwd_res_plain, ref_dir_bwd_plain) against
    the store_residuals directional pair of make_ref_fused, with a seeded
    bottleneck noise: rgb, normal, density, the 8 activations, d(heads) and
    the 19 grads, for seeded cotangents of all three outputs."""
    cd = _jdt(dtype)
    v = _variables(ide_level)
    nerf, _ = port_models(_cfgs(ide_level=ide_level, use_srgb=use_srgb,
                                use_bf16=dtype == torch.bfloat16)[1], v)
    rng = np.random.default_rng(5)
    pos, dirs, p = _points(rng)
    n = pos.shape[0]
    enc = cat_pos_pe(_t(pos), 10, dtype)
    heads = ops.ref_spa_plain(nerf.kernel_weights()[0], enc)
    noise = torch.from_numpy(rng.normal(0, 0.02, (n, 128)).astype(
        np.float32)).to(dtype)
    g_rgb, g_nrm = rng.normal(size=(2, n, 3)).astype(np.float32)
    g_den = rng.normal(size=n).astype(np.float32)
    dr = jref._make_dir_fused(cd, TILE, True, ide_level, use_srgb,
                              store_residuals=True)
    jws = jops.ref_directional_weights_from_params(v["nerf"])
    jheads = jnp.asarray(heads.numpy())
    jnoise = jnp.asarray(noise.float().numpy(), cd)
    dirs3 = jnp.asarray(np.repeat(dirs, p, 0).T.copy())
    (jrgb3, jnrm3, jden), vjp = jax.vjp(
        lambda w, h: dr(w, h, jnoise, dirs3), jws, jheads)
    jgrads, jdheads = vjp((jnp.asarray(g_rgb.T), jnp.asarray(g_nrm.T),
                           jnp.asarray(g_den)))
    jacts = _pallas_dir_res(jws, jheads, jnoise, dirs3, cd, ide_level,
                            use_srgb)

    params = nerf.kernel_params()[1]
    hv = heads.clone().requires_grad_()
    rgb, normal, density = ops.RefDirectionalMLP.apply(
        "cpu", TILE, hv, _t(dirs), noise, p, ide_level, use_srgb, dtype,
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
    _, _, _, acts = ops.ref_dir_fwd_res(
        nerf.kernel_weights()[1], heads, _t(dirs), p, noise, ide_level,
        use_srgb, device="cpu")
    for i, (a, ja) in enumerate(zip(acts, jacts)):
        _assert_close(a, ja, dtype, f"activation {i}")


def test_training_wrappers_reject_bad_operands():
    nerf, _ = port_models(_cfgs()[1], _variables())
    spa_ws, dir_ws = nerf.kernel_weights()
    enc, pos = torch.zeros((14, 63)), torch.zeros((14, 3))
    heads, _, acts = ops.ref_spa_fwd_res(spa_ws, enc, pos, device="cpu")
    with pytest.raises(ValueError, match="pos must be"):
        ops.ref_spa_fwd_res(spa_ws, enc, pos[:7], device="cpu")
    with pytest.raises(ValueError, match="activation 7 must be"):
        ops.ref_spa_bwd(spa_ws, enc, heads, acts[:7] + (acts[6],),
                        device="cpu")
    with pytest.raises(ValueError, match="tile must be positive"):
        ops.ref_spa_bwd(spa_ws, enc, heads, acts, tile=0, device="cpu")
    dirs = torch.ones((2, 3))
    out = ops.ref_dir_fwd_res(dir_ws, heads, dirs, 7, device="cpu")
    g = torch.zeros((14, 3))
    with pytest.raises(ValueError, match="noise must be"):
        ops.ref_dir_bwd(dir_ws, heads, dirs, 7,
                        torch.zeros((14, 128), dtype=torch.bfloat16), g, g,
                        g[:, 0].contiguous(), out[3], device="cpu")
    with pytest.raises(ValueError, match="g_density must be"):
        ops.ref_dir_bwd(dir_ws, heads, dirs, 7, None, g, g, g, out[3],
                        device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ops.ref_spa_bwd(spa_ws, enc, heads, acts)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def _batch(seed: int):
    """Rays from two cameras at radius 4 on opposite sides of the origin,
    ground truth and the step's noise, from one numpy seed."""
    rng = np.random.default_rng(seed)
    focal = jrays.fov_to_focal(FOV, (20, 20))
    rays = []
    for az in rng.uniform(0, 360) + np.array([0.0, 180.0]):
        pose = jrays.pose_spherical(float(az), -30.0, 4.0)
        row, col = rng.integers(0, 20, (2, N_RAYS // 2))
        coords = jnp.stack((jnp.asarray(col - 10), jnp.asarray(10 - row)),
                           -1)
        rays.append(np.asarray(jrays.rays_from_coords(
            coords, jnp.asarray(pose[:3]), focal)))
    rays = np.concatenate(rays)
    gt = rng.uniform(size=(N_RAYS, 3)).astype(np.float32)
    _, cfg = _cfgs()
    jit = rng.uniform(size=(N_RAYS, cfg.n_coarse)).astype(np.float32)
    u = np.sort(rng.uniform(size=(N_RAYS, cfg.n_fine + 1)), -1)
    return rays, gt, jit, u.astype(np.float32)


def _port_grads(models):
    nerf, prop = models
    return {"nerf": bridge.state_dict_to_flax(
                {k: p.grad for k, p in nerf.named_parameters()}, "ref"),
            "prop": bridge.state_dict_to_flax(
                {k: p.grad for k, p in prop.named_parameters()}, "prop")}


@pytest.mark.parametrize("use_pallas, prop_normal, legacy", [
    (True, False, False), (False, False, False), (True, True, False),
    (False, True, True), (True, True, True)])
def test_compute_loss_matches_jax(use_pallas, prop_normal, legacy):
    """Loss, metrics and every parameter grad of the Ref-NeRF loss: the
    Pallas route (interpret mode) against the port's kernel route (plain
    versions), and flax against the nn.Modules; with --prop_normal the
    proposal net's coarse normals, by the merge ranks or the legacy
    off-by-one positions."""
    jcfg, cfg = _cfgs(use_pallas=use_pallas, prop_normal=prop_normal,
                      legacy_coarse_select=legacy)
    v = _variables()
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
    for k in ("loss", "img_loss", "prop_loss", "normal_loss", "bf_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    assert float(m["normal_loss"]) > 0.0 and float(m["bf_loss"]) > 0.0
    got = _port_grads(models)
    flat_got, _ = jax.flatten_util.ravel_pytree(got)
    flat_want, _ = jax.flatten_util.ravel_pytree(
        jax.tree.map(np.asarray, jg))
    assert flat_got.shape == flat_want.shape
    np.testing.assert_allclose(np.asarray(flat_got), np.asarray(flat_want),
                               **STEP_GRAD_TOL)


def test_three_step_trajectory_matches_jax():
    """Three Adam steps on the kernel routes, fresh rays and noise per step:
    the per-step losses and the final parameters."""
    jcfg, cfg = _cfgs(use_pallas=True)
    v = _variables()
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


def test_bottleneck_noise_is_drawn_per_step():
    """With bottleneck noise on, both routes draw it from the step's
    generator: the same seed gives the same loss, another seed another."""
    _, cfg = _cfgs(bottleneck_noise=0.5)
    rays, gt, jit, u = _batch(2)
    for use_pallas in (True, False):
        c = cfg.replace(use_pallas=use_pallas)
        models = port_models(c, _variables())
        assert models[0].perturb_bottleneck == 0.5
        losses_ = [float(compute_loss(
            models, _t(rays), _t(gt), c, noise=(_t(jit), _t(u)),
            generator=torch.Generator().manual_seed(s), device="cpu")[0])
            for s in (0, 0, 1)]
        assert losses_[0] == losses_[1] != losses_[2], losses_


# ---------------------------------------------------------------------------
# the entry
# ---------------------------------------------------------------------------

def test_ref_training_end_to_end_on_cpu(tmp_path, monkeypatch, capsys):
    """``-t --epochs 2`` through the entry on the 7-view fixture (14 steps,
    the eval grid with the normal panel, model/<name>_{mip,prop}.pt and the
    normal and back-face losses in the metrics log); then ``-t -r -e
    --render_normal`` renders the checkpoint it wrote."""
    _, cfg = _cfgs()
    monkeypatch.chdir(tmp_path)
    common = ["-t", "--dataset_root", FIXTURES, "--dataset_name", "lego_mini",
              "--img_scale", "0.5", "-w", "--nerf_net_width",
              str(cfg.nerf_width), "--prop_net_width", str(cfg.prop_width),
              "--coarse_sample_pnum", str(cfg.n_coarse),
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
    grid = read_png(str(tmp_path / "out" / "result_ep0001.png"))
    assert grid.shape[1] == 2 * 10 - 2        # rgb and normal per row
    for net in ("mip", "prop"):
        ckpt = torch.load(tmp_path / "model" / f"model_1_{net}.pt",
                          weights_only=True)
        assert (ckpt["train_cnt"], ckpt["epoch"]) == (14, 2)
    assert main(common + ["-r", "-e"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "(step 14, epoch 2)" in out and "Mean PSNR" in out
    grid = read_png(str(tmp_path / "out" / "given" / "result_000.png"))
    assert grid.shape[:2] == (8, 3 * 10 - 2)   # rgb, normal, ground truth
    assert read_png(str(tmp_path / "out" / "given" / "result_000.png")
                    )[:, 10:18].std() > 0.0


def test_train_parameters_cover_the_ref_model():
    _, cfg = _cfgs()
    models = port_models(cfg, _variables())
    spa, dr = models[0].kernel_params()
    assert len(spa) == 23 and len(dr) == 19
    n_params = sum(p.numel() for p in train_parameters(models))
    assert n_params == sum(w.numel() for w in spa + dr) + sum(
        p.numel() for p in models[1].parameters())
