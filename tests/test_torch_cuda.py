"""The CUDA kernels of nerf_tpu_torch against their plain versions, and the
eval path and the training step through them against the nn.Module path,
on the card.

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Every test skips without a CUDA device.  This file imports no JAX, so with
``--noconftest`` (tests/conftest.py sets JAX up) it runs on a machine that
has PyTorch and a card only.
"""

import numpy as np
import pytest
import torch

from nerf_tpu_torch import ops
from nerf_tpu_torch.core import sampling
from nerf_tpu_torch.core.encoding import cat_pos_pe
from nerf_tpu_torch.models import ProposalNetwork, RefNeRF, VanillaNeRF
from nerf_tpu_torch.train.config import PipelineConfig
from nerf_tpu_torch.train.pipeline import make_models, render_rays_eval
from nerf_tpu_torch.train.step import compute_loss, train_parameters

pytestmark = pytest.mark.cuda

# bf16: both sides round every layer to bf16 but sum in another order, so a
# value at a rounding boundary may differ by one bf16 ulp and carry on;
# f32: summation order alone.
TOLS = {torch.float32: dict(rtol=1e-4, atol=1e-5),
        torch.bfloat16: dict(rtol=2e-2, atol=1e-2)}
# backward grads, as the relative Frobenius error of each grad tensor.  The
# kernel and the plain version round the same deltas per layer and part only
# where an f32 sum taken in another order lands on the other side of a
# rounding edge: at most 9.3e-7 over these cases on an H100 80GB HBM3, both
# dtypes.  A bf16 backward with its per-layer casts left out reads 3.6e-3 or
# more there (the control in test_training_kernels_match_plain).
GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-4}
# one f32 step, kernels vs the nn.Module path with the kernel route's fine
# sample depths handed to the module path
SHARED_DEPTH_REL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randomize(module, seed, gain=2.0 ** 0.5):
    """N(0, gain^2/fan_in) weights and N(0, 0.25) biases, so that the
    activations are far from zero."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            std = 0.5 if name.endswith("bias") else gain / p.shape[1] ** 0.5
            p.copy_(torch.randn(p.shape, generator=gen) * std)
    return module


@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("n", [1, 70, 4099])
@pytest.mark.parametrize("width", [48, 256])
def test_kernels_match_plain(cuda, dtype, n, width):
    v = _randomize(VanillaNeRF(hidden=width, bottleneck=width - 8,
                               dtype=dtype), 0).to(cuda)
    p = _randomize(ProposalNetwork(hidden=width, dtype=dtype), 1).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = (torch.rand((n, v.d_x), generator=gen, device=cuda) * 2 - 1).to(dtype)
    d = (torch.rand((n, v.d_d), generator=gen, device=cuda) * 2 - 1).to(dtype)
    before = dict(ops.LAUNCHES)
    dens = ops.prop_mlp_fwd(p.kernel_weights(), x)
    rgb3, sig = ops.vanilla_mlp_fwd(v.kernel_weights(), x, d)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["prop_mlp_fwd"] == before["prop_mlp_fwd"] + 1
    assert ops.LAUNCHES["vanilla_mlp_fwd"] == before["vanilla_mlp_fwd"] + 1
    torch.testing.assert_close(dens, ops.prop_mlp_plain(p.kernel_weights(), x),
                               **TOLS[dtype])
    prgb3, psig = ops.vanilla_mlp_plain(v.kernel_weights(), x, d)
    torch.testing.assert_close(rgb3, prgb3, **TOLS[dtype])
    torch.testing.assert_close(sig, psig, **TOLS[dtype])


def test_eval_kernels_match_module_path(cuda):
    """f32 render of a ray batch through the kernels and through the
    nn.Module path, same weights and noise.  N(0, 1/fan_in) weights and
    N(0, 0.25) biases give a field with structure that is still smooth;
    with rougher weights (N(0, 2/fan_in)) a fine depth that moves by an f32
    ulp changed the density it met by more (6e-4 on one of 900 values)."""
    cfg = PipelineConfig(n_coarse=16, n_fine=32, nerf_width=64, prop_width=64,
                         white_bkg=True)
    models = make_models(cfg, cuda)
    for i, m in enumerate(models):
        _randomize(m, 10 + i, gain=1.0)
    rng = np.random.default_rng(0)
    rays = np.concatenate([rng.normal(0, 0.2, (300, 3)) + [0, 0, 4.0],
                           rng.normal(0, 0.3, (300, 3)) + [0, 0, -1.0]], -1)
    rays = torch.tensor(rays, dtype=torch.float32, device=cuda)
    jit = torch.tensor(rng.uniform(size=(300, 16)), dtype=torch.float32,
                       device=cuda)
    u = torch.tensor(np.sort(rng.uniform(size=(300, 33)), -1),
                     dtype=torch.float32, device=cuda)
    outs = [render_rays_eval(models, rays, cfg.replace(eval_use_pallas=k),
                             render_depth=True, noise=(jit, u))
            for k in (True, False)]
    assert float(outs[1][1]["depth"].std()) > 0.1   # not a blank batch
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-4, atol=2e-4)
    torch.testing.assert_close(outs[0][1]["depth"], outs[1][1]["depth"],
                               rtol=1e-4, atol=2e-4)


def _rel_err(got, want):
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-30))


@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("n", [1, 70, 4099])
@pytest.mark.parametrize("width", [48, 256])
def test_training_kernels_match_plain(cuda, dtype, n, width):
    """vanilla_mlp_fwd_res, vanilla_mlp_bwd and prop_mlp_bwd against their
    plain versions on the same operands; each launches once.  In bf16 a
    control, the plain backwards with no per-layer cast (run on operands
    upcast to f32), must read beyond GRAD_REL."""
    v = _randomize(VanillaNeRF(hidden=width, bottleneck=width - 8,
                               dtype=dtype), 2).to(cuda)
    p = _randomize(ProposalNetwork(hidden=width, dtype=dtype), 3).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(n + 7)
    x = (torch.rand((n, v.d_x), generator=gen, device=cuda) * 2 - 1).to(dtype)
    d = (torch.rand((n, v.d_d), generator=gen, device=cuda) * 2 - 1).to(dtype)
    g_rgb = torch.randn((3, n), generator=gen, device=cuda)
    g_sig = torch.randn((n,), generator=gen, device=cuda)
    vw, pw = v.kernel_weights(), p.kernel_weights()
    ops.reset_launches()
    rgb3, sig, acts = ops.vanilla_mlp_fwd_res(vw, x, d)
    grads = ops.vanilla_mlp_bwd(vw, x, d, g_rgb, g_sig, rgb3, acts)
    pgrads = ops.prop_mlp_bwd(pw, x, g_sig)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == dict(dict.fromkeys(ops.LAUNCHES, 0),
                                vanilla_mlp_fwd_res=1, vanilla_mlp_bwd=1,
                                prop_mlp_bwd=1)
    prgb3, psig, pacts = ops.vanilla_mlp_fwd_res_plain(vw, x, d)
    torch.testing.assert_close(rgb3, prgb3, **TOLS[dtype])
    torch.testing.assert_close(sig, psig, **TOLS[dtype])
    for a, pa in zip(acts, pacts):
        torch.testing.assert_close(a.float(), pa.float(), **TOLS[dtype])
    # the same stored activations for both backwards: the masks agree
    want = ops.vanilla_mlp_bwd_plain(vw, x, d, g_rgb, g_sig, rgb3, acts)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel_err(g, w) < GRAD_REL[dtype], (i, _rel_err(g, w))
    pwant = ops.prop_mlp_bwd_plain(pw, x, g_sig)
    for i, (g, w) in enumerate(zip(pgrads, pwant)):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel_err(g, w) < GRAD_REL[dtype], (i, _rel_err(g, w))
    if dtype == torch.bfloat16:
        def up(ts):
            return [t.float() for t in ts]
        uncast = ops.vanilla_mlp_bwd_plain(up(vw), x.float(), d.float(),
                                           g_rgb, g_sig, rgb3, up(acts))
        assert max(map(_rel_err, uncast, want)) > GRAD_REL[dtype]
        uncast = ops.prop_mlp_bwd_plain(up(pw), x.float(), g_sig)
        assert max(map(_rel_err, uncast, pwant)) > GRAD_REL[dtype]


def _held_against_plain(monkeypatch, record):
    """Make every call of a training kernel's wrapper from the autograd
    Functions also run its plain version on the call's own operands: the
    forwards must match within TOLS, and ``record`` gets each backward's
    worst relative grad error."""
    fm = ops.fused_mlp
    f32 = TOLS[torch.float32]

    def wrap(name, plain, compare):
        orig = getattr(fm, name)

        def call(*args, device=None):
            out = orig(*args, device=device)
            compare(name, out, plain(*args))
            return out
        monkeypatch.setattr(fm, name, call)

    def grads(name, got, want):
        record[name] = max(record.get(name, 0.0),
                           max(map(_rel_err, got, want)))

    def outputs(name, got, want):
        for a, b in zip(got[:2], want[:2]):
            torch.testing.assert_close(a, b, **f32)

    wrap("prop_mlp_fwd", fm.prop_mlp_plain,
         lambda name, got, want: outputs(name, (got,), (want,)))
    wrap("vanilla_mlp_fwd_res", fm.vanilla_mlp_fwd_res_plain, outputs)
    wrap("vanilla_mlp_bwd", fm.vanilla_mlp_bwd_plain, grads)
    wrap("prop_mlp_bwd", fm.prop_mlp_bwd_plain, grads)


def test_train_step_kernels_match_module_path(cuda, monkeypatch):
    """One f32 step's loss and 32 parameter grads through the kernels'
    autograd and through the nn.Module path, same weights, rays and noise.

    Each kernel call of the step meets its plain version on the call's own
    operands (backwards within GRAD_REL), so the kernels' backward is not
    what parts the routes.  The fine sample depths are: they come from the
    proposal's density through the inverse CDF, so they differ between the
    routes by f32 ulps, and the positional encoding's top frequency (2^9)
    amplifies that in the inputs of the fine net's first layers.  The worst
    grad, the fine net's first matrix, parts by 3.5e-3 on an H100 80GB HBM3
    (the proposal net's grads by 1e-6); the bound is 1e-2.  Given the kernel
    route's depths, the module route's grads agree within SHARED_DEPTH_REL.
    """
    cfg = PipelineConfig(n_coarse=16, n_fine=32, nerf_width=64, prop_width=64,
                         ray_batch=300)
    models = make_models(cfg, cuda)
    for i, m in enumerate(models):
        _randomize(m, 20 + i, gain=1.0)
    rng = np.random.default_rng(1)
    rays = np.concatenate([rng.normal(0, 0.2, (300, 3)) + [0, 0, 4.0],
                           rng.normal(0, 0.3, (300, 3)) + [0, 0, -1.0]], -1)
    rays = torch.tensor(rays, dtype=torch.float32, device=cuda)
    gt = torch.tensor(rng.uniform(size=(300, 3)), dtype=torch.float32,
                      device=cuda)
    jit = torch.tensor(rng.uniform(size=(300, 16)), dtype=torch.float32,
                       device=cuda)
    u = torch.tensor(np.sort(rng.uniform(size=(300, 33)), -1),
                     dtype=torch.float32, device=cuda)
    params = train_parameters(models)
    per_call, depths = {}, []
    _held_against_plain(monkeypatch, per_call)
    inverse_sample = sampling.inverse_sample

    def recorded(*args, **kw):
        depths.append(inverse_sample(*args, **kw))
        return depths[-1]

    out = []
    for use_kernels, sample in ((True, recorded), (False, inverse_sample),
                                (False, lambda *a, **kw: depths[0])):
        monkeypatch.setattr(sampling, "inverse_sample", sample)
        ops.reset_launches()
        loss, _ = compute_loss(models, rays, gt,
                               cfg.replace(use_pallas=use_kernels),
                               noise=(jit, u))
        grads = torch.autograd.grad(loss, params)
        out.append((loss, grads, dict(ops.LAUNCHES)))
    assert out[0][2]["vanilla_mlp_bwd"] == out[0][2]["prop_mlp_bwd"] == 1
    assert not any(out[1][2].values())
    assert per_call["vanilla_mlp_bwd"] < GRAD_REL[torch.float32], per_call
    assert per_call["prop_mlp_bwd"] < GRAD_REL[torch.float32], per_call
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-4, atol=1e-6)
    rels = [_rel_err(g, w) for g, w in zip(out[0][1], out[1][1])]
    assert max(rels) < 1e-2, rels
    shared = [_rel_err(g, w) for g, w in zip(out[0][1], out[2][1])]
    assert max(shared) < SHARED_DEPTH_REL, (shared, rels)


def test_oversized_widths_raise_and_leave_no_error(cuda):
    """A width whose tile does not fit a block's shared memory raises the
    CUDA error from the launch, and the next launch runs clean."""
    p = ProposalNetwork(hidden=1024).to(cuda)
    x = torch.zeros((70, 63), device=cuda)
    with pytest.raises(RuntimeError, match="prop_mlp_fwd launch failed"):
        ops.prop_mlp_fwd(p.kernel_weights(), x)
    small = _randomize(ProposalNetwork(hidden=48), 0).to(cuda)
    torch.testing.assert_close(
        ops.prop_mlp_fwd(small.kernel_weights(), x),
        ops.prop_mlp_plain(small.kernel_weights(), x), **TOLS[torch.float32])
    torch.cuda.synchronize()


def _ref_operands(cuda, dtype, n, per_ray, seed, **model):
    """A randomized RefNeRF's kernel weights, the encodings of n points
    N(0, 1) and the raw directions of n / per_ray rays as a camera casts
    them (|d| from 1 to 1.12: at larger |d| the IDE's z^l_max terms grow as
    |d|^l_max)."""
    m = _randomize(RefNeRF(dtype=dtype, **model), seed, gain=1.0).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    pos = torch.randn((n, 3), generator=gen, device=cuda)
    dirs = torch.randn((n // per_ray, 3), generator=gen, device=cuda)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) * (
        1.0 + 0.12 * torch.rand((n // per_ray, 1), generator=gen,
                                device=cuda))
    return m, cat_pos_pe(pos, m.pos_levels, dtype), dirs


def _assert_ref_match(cuda, dtype, n, per_ray, **model):
    ide_level, use_srgb = model.get("ide_level", 4), model.get("use_srgb",
                                                               False)
    m, enc, dirs = _ref_operands(cuda, dtype, n, per_ray, n, **model)
    spa_ws, dir_ws = m.kernel_weights()
    ops.reset_launches()
    heads = ops.ref_spa_fwd(spa_ws, enc)
    out = ops.ref_dir_fwd(dir_ws, heads, dirs, per_ray,
                          ide_level=ide_level, use_srgb=use_srgb)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ref_spa_fwd"] == ops.LAUNCHES["ref_dir_fwd"] == 1
    torch.testing.assert_close(heads, ops.ref_spa_plain(spa_ws, enc),
                               **TOLS[dtype])
    # the directional kernel on the kernel's own heads
    want = ops.ref_dir_plain(dir_ws, heads, dirs, per_ray,
                             ide_level=ide_level, use_srgb=use_srgb)
    for name, a, b in zip(("rgb", "normal", "density"), out, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        torch.testing.assert_close(a, b, **TOLS[dtype], msg=name)
    if n > 1:
        assert float(out[0].std()) > 0.0


@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("n, per_ray", [(1, 1), (70, 7), (4097, 17)])
@pytest.mark.parametrize("hidden, output_dim", [(256, 256), (48, 80)])
def test_ref_kernels_match_plain(cuda, dtype, n, per_ray, hidden,
                                 output_dim):
    """ref_spa_fwd and ref_dir_fwd against their plain versions: a single
    point, ragged last tiles, and a trunk whose width H differs from the
    output_dim O (the skip and O-wide layers are not square)."""
    _assert_ref_match(cuda, dtype, n, per_ray, hidden=hidden,
                      output_dim=output_dim)


@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("ide_level, use_srgb, bottleneck_dim",
                         [(1, False, 128), (2, True, 128), (5, False, 64)])
def test_ref_dir_kernel_levels_and_srgb(cuda, dtype, ide_level, use_srgb,
                                        bottleneck_dim):
    """The directional kernel at other IDE levels (l_max 1, 2 and 16), with
    the sRGB curve and a narrower bottleneck."""
    _assert_ref_match(cuda, dtype, 4097, 17, hidden=64, output_dim=64,
                      ide_level=ide_level, use_srgb=use_srgb,
                      bottleneck_dim=bottleneck_dim)


def test_ref_kernels_raise_on_misplaced_operands(cuda):
    """A CUDA call with one operand on the CPU raises instead of running the
    plain version, and launches nothing."""
    m, enc, dirs = _ref_operands(cuda, torch.float32, 70, 7, 0, hidden=32)
    spa_ws, dir_ws = m.kernel_weights()
    heads = ops.ref_spa_plain(spa_ws, enc)
    ops.reset_launches()
    with pytest.raises(ValueError, match="weight 3 is on cpu"):
        ops.ref_spa_fwd(spa_ws[:3] + (spa_ws[3].cpu(),) + spa_ws[4:], enc)
    with pytest.raises(ValueError, match="dirs is on cpu"):
        ops.ref_dir_fwd(dir_ws, heads, dirs.cpu(), 7)
    with pytest.raises(ValueError, match="weight 0 is on cpu"):
        ops.ref_dir_fwd((dir_ws[0].cpu(),) + dir_ws[1:], heads, dirs, 7)
    assert not any(ops.LAUNCHES.values())


def test_ref_eval_kernels_match_module_path(cuda):
    """f32 Ref-NeRF render of a ray batch through the kernels and through
    the RefNeRF module, same weights and noise: rgb, depth and normal map."""
    cfg = PipelineConfig(model="ref", n_coarse=16, n_fine=32, nerf_width=64,
                         prop_width=64, white_bkg=True)
    models = make_models(cfg, cuda)
    for i, m in enumerate(models):
        _randomize(m, 30 + i, gain=1.0)
    rng = np.random.default_rng(2)
    rays = np.concatenate([rng.normal(0, 0.2, (300, 3)) + [0, 0, 4.0],
                           rng.normal(0, 0.3, (300, 3)) + [0, 0, -1.0]], -1)
    rays = torch.tensor(rays, dtype=torch.float32, device=cuda)
    jit = torch.tensor(rng.uniform(size=(300, 16)), dtype=torch.float32,
                       device=cuda)
    u = torch.tensor(np.sort(rng.uniform(size=(300, 33)), -1),
                     dtype=torch.float32, device=cuda)
    cam = torch.tensor([0.0, 0.0, 1.0], device=cuda)
    outs = []
    for k in (True, False):
        ops.reset_launches()
        outs.append(render_rays_eval(models, rays,
                                     cfg.replace(eval_use_pallas=k),
                                     render_depth=True, normal_cam_dir=cam,
                                     noise=(jit, u)))
        assert (ops.LAUNCHES["ref_dir_fwd"] == 1) == k
    assert float(outs[1][1]["depth"].std()) > 0.1   # not a blank batch
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-4, atol=2e-4)
    for key in ("depth", "normal"):
        torch.testing.assert_close(outs[0][1][key], outs[1][1][key],
                                   rtol=1e-4, atol=2e-4, msg=key)


# ---------------------------------------------------------------------------
# the Ref-NeRF training kernels
# ---------------------------------------------------------------------------

# The normal target -g / max(1e-5, |g|) is held against the plain target on
# the kernel's own activations (g is a pullback through their ReLU masks;
# a mask the plain forward sets the other way moves g by a unit's whole
# term), weighted by |g|, as the relative Frobenius error
# ||(t_kernel - t_plain) |g||| / ||g||: g passes the bf16 layers and the
# encoding's 2^9 frequency, and where |g| is small next to its own rounding
# noise its direction is that noise (3 of 12,291 components 0.5 apart at
# H = 48, O = 80, N = 4,097 on an H100 80GB HBM3).  bf16 gets the
# activations' own bound (1e-2); f32 is also held elementwise where |g|
# exceeds DGRAD_MIN_NORM, a thousand times the clamp.
DGRAD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
DGRAD_MIN_NORM = 1e-2
# The Ref-NeRF backwards round each 64-row tile's weight grad to bf16, as
# the TPU kernels do per grid step.  A delta that the kernel and the plain
# version round one ulp apart (f32 sums in another order) moves the tile's
# partial by about 1e-4 of itself, and then a few percent of the rounded
# partials land one bf16 ulp (2^-8) apart: 7.9e-4 on an H100 80GB HBM3 at
# N = 70.  The bf16 backward with no per-layer cast reads 5e-3 or more.
REF_GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-3}
HEAD_GROUPS = ((0, 1), (1, 2), (2, 5), (5, 8), (8, 11), (11, None))


def _dheads_rel(got, want):
    """The worst relative Frobenius error over the column groups of
    d(heads): rho, density, normal, diffuse, tint, bottleneck."""
    return max(_rel_err(got[:, a:b], want[:, a:b]) for a, b in HEAD_GROUPS)


def _assert_ref_train_match(cuda, dtype, n, per_ray, tile=64, **model):
    """ref_spa_fwd_res, ref_spa_bwd, ref_dir_fwd_res and ref_dir_bwd against
    their plain versions on the same operands (the backwards on the kernels'
    own activations); each launches once.  In bf16 the plain backwards with
    no per-layer cast (operands upcast to f32) must read beyond
    REF_GRAD_REL."""
    ide_level, use_srgb = model.get("ide_level", 4), model.get("use_srgb",
                                                               False)
    m, enc, dirs = _ref_operands(cuda, dtype, n, per_ray, n + 1, **model)
    gen = torch.Generator(device=cuda).manual_seed(n + 2)
    pos = enc[:, :3].float().contiguous()
    spa_ws, dir_ws = m.kernel_weights()
    nb = m.bottleneck_dim
    noise = (0.05 * torch.randn((n, nb), generator=gen, device=cuda)).to(dtype)
    g_heads = torch.randn((n, 11 + nb), generator=gen, device=cuda)
    g_rgb, g_nrm = torch.randn((2, n, 3), generator=gen, device=cuda)
    g_den = torch.randn((n,), generator=gen, device=cuda)
    ops.reset_launches()
    heads, dgrad, sacts = ops.ref_spa_fwd_res(spa_ws, enc, pos)
    sgrads = ops.ref_spa_bwd(spa_ws, enc, g_heads, sacts, tile=tile)
    rgb, nrm, den, dacts = ops.ref_dir_fwd_res(dir_ws, heads, dirs, per_ray,
                                               noise, ide_level, use_srgb)
    dheads, dgrads = ops.ref_dir_bwd(dir_ws, heads, dirs, per_ray, noise,
                                     g_rgb, g_nrm, g_den, dacts, ide_level,
                                     use_srgb, tile=tile)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == dict(dict.fromkeys(ops.LAUNCHES, 0),
                                ref_spa_fwd_res=1, ref_spa_bwd=1,
                                ref_dir_fwd_res=1, ref_dir_bwd=1)
    pheads, pdgrad, pacts = ops.ref_spa_fwd_res_plain(spa_ws, enc, pos)
    torch.testing.assert_close(heads, pheads, **TOLS[dtype])
    for a, pa in zip(sacts, pacts):
        torch.testing.assert_close(a.float(), pa.float(), **TOLS[dtype])
    g = ops.ref_fused.density_grad_plain(spa_ws, enc, pos, sacts)
    pdgrad = ops.ref_fused.normal_target(g)
    g = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    assert _rel_err(dgrad * g, pdgrad * g) < DGRAD_REL[dtype]
    live = g[:, 0] > DGRAD_MIN_NORM
    assert int(live.sum()) >= 0.99 * n - 1
    if dtype == torch.float32:
        torch.testing.assert_close(dgrad[live], pdgrad[live], **TOLS[dtype])
    want = ops.ref_spa_bwd_plain(spa_ws, enc, g_heads, sacts, tile)
    lim = REF_GRAD_REL[dtype]
    for i, (a, b) in enumerate(zip(sgrads, want)):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel_err(a, b) < lim, ("spa", i, _rel_err(a, b))
    prgb, pnrm, pden, pdacts = ops.ref_dir_fwd_res_plain(
        dir_ws, heads, dirs, per_ray, noise, ide_level, use_srgb)
    for name, a, b in (("rgb", rgb, prgb), ("normal", nrm, pnrm),
                       ("density", den, pden)):
        torch.testing.assert_close(a, b, **TOLS[dtype], msg=name)
    for a, pa in zip(dacts, pdacts):
        torch.testing.assert_close(a.float(), pa.float(), **TOLS[dtype])
    pdheads, pdgrads = ops.ref_dir_bwd_plain(
        dir_ws, heads, dirs, per_ray, noise, g_rgb, g_nrm, g_den, dacts,
        ide_level, use_srgb, tile)
    assert _dheads_rel(dheads, pdheads) < lim, _dheads_rel(dheads, pdheads)
    for i, (a, b) in enumerate(zip(dgrads, pdgrads)):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel_err(a, b) < lim, ("dir", i, _rel_err(a, b))
    if dtype == torch.bfloat16 and n > 1:
        def up(ts):
            return [t.float() for t in ts]
        uncast = ops.ref_spa_bwd_plain(up(spa_ws), enc.float(), g_heads,
                                       up(sacts), tile)
        assert max(map(_rel_err, uncast, want)) > lim
        _, uncast = ops.ref_dir_bwd_plain(
            up(dir_ws), heads, dirs, per_ray, noise.float(), g_rgb, g_nrm,
            g_den, up(dacts), ide_level, use_srgb, tile)
        assert max(map(_rel_err, uncast, pdgrads)) > lim


@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("n, per_ray", [(1, 1), (70, 7), (4097, 17)])
@pytest.mark.parametrize("hidden, output_dim", [(256, 256), (48, 80)])
def test_ref_train_kernels_match_plain(cuda, dtype, n, per_ray, hidden,
                                       output_dim):
    """The four Ref-NeRF training kernels against their plain versions: a
    single point, ragged last tiles and weight-grad tiles of 64 rows, and a
    trunk whose width H differs from the output_dim O."""
    _assert_ref_train_match(cuda, dtype, n, per_ray, hidden=hidden,
                            output_dim=output_dim)


@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("ide_level, use_srgb", [(2, True), (2, False),
                                                 (4, True)])
def test_ref_train_kernels_levels_and_srgb(cuda, dtype, ide_level, use_srgb):
    """The training kernels at IDE level 2 and with the sRGB curve."""
    _assert_ref_train_match(cuda, dtype, 4097, 17, hidden=64, output_dim=64,
                            ide_level=ide_level, use_srgb=use_srgb)


def test_ref_train_kernels_raise_on_bad_operands(cuda):
    """A CUDA call with a CPU weight or a noise of the wrong dtype raises
    instead of running the plain version, and launches nothing."""
    m, enc, dirs = _ref_operands(cuda, torch.float32, 70, 7, 0, hidden=32)
    spa_ws, dir_ws = m.kernel_weights()
    pos = enc[:, :3].contiguous()
    heads, _, sacts = ops.ref_spa_fwd_res_plain(spa_ws, enc, pos)
    ops.reset_launches()
    with pytest.raises(ValueError, match="weight 3 is on cpu"):
        ops.ref_spa_fwd_res(spa_ws[:3] + (spa_ws[3].cpu(),) + spa_ws[4:],
                            enc, pos)
    with pytest.raises(ValueError, match="pos is on cpu"):
        ops.ref_spa_fwd_res(spa_ws, enc, pos.cpu())
    with pytest.raises(ValueError, match="g_heads must be"):
        ops.ref_spa_bwd(spa_ws, enc, heads[:, :100].contiguous(), sacts)
    with pytest.raises(ValueError, match="noise must be"):
        ops.ref_dir_fwd_res(dir_ws, heads, dirs, 7,
                            torch.zeros((70, 128), device=cuda,
                                        dtype=torch.bfloat16))
    g = torch.zeros((70, 3), device=cuda)
    _, _, _, dacts = ops.ref_dir_fwd_res_plain(dir_ws, heads, dirs, 7)
    with pytest.raises(ValueError, match="activation 7 is on cpu"):
        ops.ref_dir_bwd(dir_ws, heads, dirs, 7, None, g, g, g[:, 0].clone(),
                        dacts[:7] + (dacts[7].cpu(),))
    assert not any(ops.LAUNCHES.values())


def test_ref_train_step_kernels_match_module_path(cuda, monkeypatch):
    """One f32 Ref-NeRF step's loss and parameter grads through the kernels'
    autograd and through the nn.Module path, same weights, rays and noise,
    bottleneck noise off; the kernel route launches each training kernel
    once, the module route none."""
    cfg = PipelineConfig(model="ref", n_coarse=16, n_fine=32, nerf_width=64,
                         prop_width=64, ray_batch=300, bottleneck_noise=0.0,
                         pallas_tile=256)
    models = make_models(cfg, cuda)
    for i, m in enumerate(models):
        _randomize(m, 40 + i, gain=1.0)
    rng = np.random.default_rng(3)
    rays = np.concatenate([rng.normal(0, 0.2, (300, 3)) + [0, 0, 4.0],
                           rng.normal(0, 0.3, (300, 3)) + [0, 0, -1.0]], -1)
    rays = torch.tensor(rays, dtype=torch.float32, device=cuda)
    gt = torch.tensor(rng.uniform(size=(300, 3)), dtype=torch.float32,
                      device=cuda)
    jit = torch.tensor(rng.uniform(size=(300, 16)), dtype=torch.float32,
                       device=cuda)
    u = torch.tensor(np.sort(rng.uniform(size=(300, 33)), -1),
                     dtype=torch.float32, device=cuda)
    params = train_parameters(models)
    out = []
    for use_kernels in (True, False):
        ops.reset_launches()
        loss, metrics = compute_loss(models, rays, gt,
                                     cfg.replace(use_pallas=use_kernels),
                                     noise=(jit, u))
        grads = torch.autograd.grad(loss, params)
        out.append((loss, metrics, grads, dict(ops.LAUNCHES)))
    assert out[0][3] == dict(dict.fromkeys(ops.LAUNCHES, 0), prop_mlp_fwd=1,
                             prop_mlp_bwd=1, ref_spa_fwd_res=1,
                             ref_spa_bwd=1, ref_dir_fwd_res=1, ref_dir_bwd=1)
    assert not any(out[1][3].values())
    assert float(out[1][1]["normal_loss"]) > 0.0
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-4, atol=1e-6)
    rels = [_rel_err(g, w) for g, w in zip(out[0][2], out[1][2])]
    assert max(rels) < 1e-2, rels


# ---------------------------------------------------------------------------
# the recompute forms (store_residuals=False) and the hybrid route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("n", [1, 70, 4099])
@pytest.mark.parametrize("width", [48, 256])
def test_vanilla_recompute_kernel_matches_plain(cuda, dtype, n, width):
    """vanilla_mlp_bwd_recompute against the residual pair on the same
    operands (equal bit for bit: the same forward bits, the same K-splits
    summed in the same order) and against its plain version, which runs on
    the kernel's forward (vanilla_mlp_fwd_res): a plain forward rounds
    elsewhere in bf16, and a ReLU mask set the other way moves a grad by a
    unit's whole term.  At a few dozen points one delta rounded one bf16
    ulp apart (f32 sums in another order) moves a grad by 1.8e-4 of itself
    (width 256, N = 70 on an H100 80GB HBM3), so bf16 is held to
    REF_GRAD_REL's 2e-3, below the 3.6e-3 of the uncast control.  The grads
    do not depend on how many K-splits a chunk takes (one, or the
    default)."""
    v = _randomize(VanillaNeRF(hidden=width, bottleneck=width - 8,
                               dtype=dtype), 4).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(n + 11)
    x = (torch.rand((n, v.d_x), generator=gen, device=cuda) * 2 - 1).to(dtype)
    d = (torch.rand((n, v.d_d), generator=gen, device=cuda) * 2 - 1).to(dtype)
    g_rgb = torch.randn((3, n), generator=gen, device=cuda)
    g_sig = torch.randn((n,), generator=gen, device=cuda)
    vw = v.kernel_weights()
    ops.reset_launches()
    grads = ops.vanilla_mlp_bwd_recompute(vw, x, d, g_rgb, g_sig)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops.fused_mlp, "CHUNK_ROWS", 1)    # one K-split a chunk
        one = ops.vanilla_mlp_bwd_recompute(vw, x, d, g_rgb, g_sig)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["vanilla_mlp_bwd_recompute"] == 2
    rgb3, _, acts = ops.vanilla_mlp_fwd_res(vw, x, d)
    want = ops.vanilla_mlp_bwd_recompute_plain(vw, x, d, g_rgb, g_sig,
                                               fwd=(rgb3, acts))
    res = ops.vanilla_mlp_bwd(vw, x, d, g_rgb, g_sig, rgb3, acts)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel_err(g, w) < REF_GRAD_REL[dtype], (i, _rel_err(g, w))
        assert torch.equal(g, one[i]) and torch.equal(g, res[i]), i


def _assert_ref_recompute_match(cuda, dtype, n, per_ray, tile=64, **model):
    """ref_spa_fwd_grad, ref_spa_bwd_recompute and ref_dir_bwd_recompute
    against their plain versions (the backwards with chunks of two tiles,
    and with the default chunks: equal); the
    training forward without stored activations gives the residual form's
    heads and normal target bit for bit.  The plain backwards run on the
    residual forwards' activations, which the recompute kernels rebuild bit
    for bit (see test_vanilla_recompute_kernel_matches_plain).  In bf16 the
    plain backwards with no per-layer cast must read beyond REF_GRAD_REL."""
    ide_level, use_srgb = model.get("ide_level", 4), model.get("use_srgb",
                                                               False)
    m, enc, dirs = _ref_operands(cuda, dtype, n, per_ray, n + 5, **model)
    gen = torch.Generator(device=cuda).manual_seed(n + 6)
    pos = enc[:, :3].float().contiguous()
    spa_ws, dir_ws = m.kernel_weights()
    nb = m.bottleneck_dim
    noise = (0.05 * torch.randn((n, nb), generator=gen, device=cuda)).to(dtype)
    g_heads = torch.randn((n, 11 + nb), generator=gen, device=cuda)
    g_rgb, g_nrm = torch.randn((2, n, 3), generator=gen, device=cuda)
    g_den = torch.randn((n,), generator=gen, device=cuda)
    dir_args = (dir_ws, None, dirs, per_ray, noise, g_rgb, g_nrm, g_den,
                ide_level, use_srgb)
    ops.reset_launches()
    heads, dgrad = ops.ref_spa_fwd_grad(spa_ws, enc, pos)
    dir_args = (dir_ws, heads) + dir_args[2:]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops.fused_mlp, "CHUNK_ROWS", 2 * tile)
        sgrads = ops.ref_spa_bwd_recompute(spa_ws, enc, g_heads, tile=tile)
        dheads, dgrads = ops.ref_dir_bwd_recompute(*dir_args, tile=tile)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == dict(dict.fromkeys(ops.LAUNCHES, 0),
                                ref_spa_fwd_grad=1, ref_spa_bwd_recompute=1,
                                ref_dir_bwd_recompute=1)
    rheads, rdgrad, sacts = ops.ref_spa_fwd_res(spa_ws, enc, pos)
    assert torch.equal(heads, rheads) and torch.equal(dgrad, rdgrad)
    dacts = ops.ref_dir_fwd_res(dir_ws, heads, dirs, per_ray, noise,
                                ide_level, use_srgb)[3]
    lim = REF_GRAD_REL[dtype]
    want = ops.ref_spa_bwd_recompute_plain(spa_ws, enc, g_heads, tile,
                                           acts=sacts)
    default = ops.ref_spa_bwd_recompute(spa_ws, enc, g_heads, tile=tile)
    for i, (a, b) in enumerate(zip(sgrads, want)):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel_err(a, b) < lim, ("spa", i, _rel_err(a, b))
        assert torch.equal(a, default[i]), ("spa", i)
    pdheads, pdgrads = ops.ref_dir_bwd_recompute_plain(*dir_args, tile,
                                                       acts=dacts)
    assert _dheads_rel(dheads, pdheads) < lim, _dheads_rel(dheads, pdheads)
    ddefault = ops.ref_dir_bwd_recompute(*dir_args, tile=tile)
    assert torch.equal(dheads, ddefault[0])
    for i, (a, b) in enumerate(zip(dgrads, pdgrads)):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel_err(a, b) < lim, ("dir", i, _rel_err(a, b))
        assert torch.equal(a, ddefault[1][i]), ("dir", i)
    if dtype == torch.bfloat16 and n > 1:
        def up(ts):
            return [t.float() for t in ts]
        uncast = ops.ref_spa_bwd_recompute_plain(up(spa_ws), enc.float(),
                                                 g_heads, tile, up(sacts))
        assert max(map(_rel_err, uncast, want)) > lim
        _, uncast = ops.ref_dir_bwd_recompute_plain(
            up(dir_ws), heads, dirs, per_ray, noise.float(), g_rgb, g_nrm,
            g_den, ide_level, use_srgb, tile, up(dacts))
        assert max(map(_rel_err, uncast, pdgrads)) > lim


@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("n, per_ray", [(1, 1), (70, 7), (4097, 17)])
@pytest.mark.parametrize("hidden, output_dim", [(256, 256), (48, 80)])
def test_ref_recompute_kernels_match_plain(cuda, dtype, n, per_ray, hidden,
                                           output_dim):
    """The three Ref-NeRF recompute-form kernels against their plain
    versions: a single point, ragged last tiles, chunks of two 64-row tiles
    (33 chunks at N = 4097), and widths that are no multiple of the 32-bit
    mask words (48, 80)."""
    _assert_ref_recompute_match(cuda, dtype, n, per_ray, hidden=hidden,
                                output_dim=output_dim)


@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("ide_level, use_srgb", [(2, True), (4, True)])
def test_ref_recompute_kernels_levels_and_srgb(cuda, dtype, ide_level,
                                               use_srgb):
    _assert_ref_recompute_match(cuda, dtype, 4097, 17, hidden=64,
                                output_dim=64, ide_level=ide_level,
                                use_srgb=use_srgb)


@pytest.mark.parametrize("model, kw, kernels", [
    ("vanilla", dict(store_residuals=False),
     ("prop_mlp_fwd", "prop_mlp_bwd", "vanilla_mlp_fwd",
      "vanilla_mlp_bwd_recompute")),
    ("ref", dict(store_residuals=False),
     ("prop_mlp_fwd", "prop_mlp_bwd", "ref_spa_fwd_grad", "ref_dir_fwd",
      "ref_dir_bwd_recompute", "ref_spa_bwd_recompute")),
    ("ref", dict(ref_kernels="hybrid"),
     ("prop_mlp_fwd", "prop_mlp_bwd", "ref_spa_fwd_grad",
      "ref_spa_bwd_recompute"))])
def test_recompute_train_steps_match_module_path(cuda, model, kw, kernels):
    """One f32 step of the recompute forms and of the hybrid route on the
    inputs of the residual step tests above: each kernel of the route
    launches once and no other; the loss and grads agree with the nn.Module
    path as the residual steps' do, and the recompute forms' grads with the
    residual form's (the vanilla net's bit for bit; the Ref-NeRF spatial
    net's sums differ in order only)."""
    ref = model == "ref"
    cfg = PipelineConfig(model=model, n_coarse=16, n_fine=32, nerf_width=64,
                         prop_width=64, ray_batch=300, bottleneck_noise=0.0,
                         pallas_tile=256)
    models = make_models(cfg, cuda)
    for i, m in enumerate(models):
        _randomize(m, (40 if ref else 20) + i, gain=1.0)
    rng = np.random.default_rng(3 if ref else 1)
    rays = np.concatenate([rng.normal(0, 0.2, (300, 3)) + [0, 0, 4.0],
                           rng.normal(0, 0.3, (300, 3)) + [0, 0, -1.0]], -1)
    rays = torch.tensor(rays, dtype=torch.float32, device=cuda)
    gt = torch.tensor(rng.uniform(size=(300, 3)), dtype=torch.float32,
                      device=cuda)
    jit = torch.tensor(rng.uniform(size=(300, 16)), dtype=torch.float32,
                       device=cuda)
    u = torch.tensor(np.sort(rng.uniform(size=(300, 33)), -1),
                     dtype=torch.float32, device=cuda)
    params = train_parameters(models)
    out = []
    for route in (cfg.replace(**kw), cfg, cfg.replace(use_pallas=False)):
        ops.reset_launches()
        loss, _ = compute_loss(models, rays, gt, route, noise=(jit, u))
        grads = torch.autograd.grad(loss, params)
        out.append((loss, grads, dict(ops.LAUNCHES)))
    assert out[0][2] == dict(dict.fromkeys(ops.LAUNCHES, 0),
                             **dict.fromkeys(kernels, 1)), out[0][2]
    assert not any(out[2][2].values())
    torch.testing.assert_close(out[0][0], out[2][0], rtol=1e-4, atol=1e-6)
    rels = [_rel_err(g, w) for g, w in zip(out[0][1], out[2][1])]
    assert max(rels) < 1e-2, rels
    res = [_rel_err(g, w) for g, w in zip(out[0][1], out[1][1])]
    if not ref:
        assert all(map(torch.equal, out[0][1], out[1][1])), res
    elif "store_residuals" in kw:
        assert max(res) < GRAD_REL[torch.float32], res


# ---------------------------------------------------------------------------
# the proposal net's residual pair (prop_store_residuals=True)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("n", [1, 70, 4099])
@pytest.mark.parametrize("width", [48, 256])
def test_prop_res_kernels_match_plain(cuda, dtype, n, width):
    """prop_mlp_fwd_res gives prop_mlp_fwd's density bit for bit and
    activations within TOLS of the plain forward's; prop_mlp_bwd_res on
    them gives prop_mlp_bwd's grads bit for bit (the same delta pass without
    the rebuild, the same K-splits summed in the same order) and is within
    GRAD_REL of its plain version.  Both backwards give the same grads with
    one K-split a chunk (two chunks at N = 4099) as with the default chunks.
    In bf16 the plain backward with no per-layer cast reads beyond
    GRAD_REL."""
    p = _randomize(ProposalNetwork(hidden=width, dtype=dtype), 5).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(n + 13)
    x = (torch.rand((n, 63), generator=gen, device=cuda) * 2 - 1).to(dtype)
    g = torch.randn((n,), generator=gen, device=cuda)
    pw = p.kernel_weights()
    ops.reset_launches()
    den, acts = ops.prop_mlp_fwd_res(pw, x)
    grads = ops.prop_mlp_bwd_res(pw, x, g, acts)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == dict(dict.fromkeys(ops.LAUNCHES, 0),
                                prop_mlp_fwd_res=1, prop_mlp_bwd_res=1)
    assert torch.equal(den, ops.prop_mlp_fwd(pw, x))
    pden, pacts = ops.prop_mlp_fwd_res_plain(pw, x)
    torch.testing.assert_close(den, pden, **TOLS[dtype])
    for a, pa in zip(acts, pacts):
        torch.testing.assert_close(a.float(), pa.float(), **TOLS[dtype])
    recompute = ops.prop_mlp_bwd(pw, x, g)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops.fused_mlp, "CHUNK_ROWS", 1)    # one K-split a chunk
        one_res = ops.prop_mlp_bwd_res(pw, x, g, acts)
        one = ops.prop_mlp_bwd(pw, x, g)
    want = ops.prop_mlp_bwd_res_plain(pw, x, g, acts)
    for i, (a, w) in enumerate(zip(grads, want)):
        assert a.shape == w.shape and a.dtype == torch.float32
        assert _rel_err(a, w) < GRAD_REL[dtype], (i, _rel_err(a, w))
        assert torch.equal(a, recompute[i]), i
        assert torch.equal(a, one_res[i]) and torch.equal(a, one[i]), i
    if dtype == torch.bfloat16 and n > 1:
        uncast = ops.prop_mlp_bwd_res_plain([t.float() for t in pw],
                                            x.float(), g,
                                            [a.float() for a in acts])
        assert max(map(_rel_err, uncast, want)) > GRAD_REL[dtype]


@pytest.mark.parametrize("model, kernels", [
    ("vanilla", ("prop_mlp_fwd_res", "prop_mlp_bwd_res",
                 "vanilla_mlp_fwd_res", "vanilla_mlp_bwd")),
    ("ref", ("prop_mlp_fwd_res", "prop_mlp_bwd_res", "ref_spa_fwd_res",
             "ref_spa_bwd", "ref_dir_fwd_res", "ref_dir_bwd"))])
def test_prop_res_train_steps_match_module_path(cuda, model, kernels):
    """One f32 step with prop_store_residuals=True on the inputs of the
    residual step tests above: each kernel of the route launches once and
    no other; the loss and grads agree with the nn.Module path as the
    residual steps' do, and every grad equals the step's with the proposal
    net's recompute pair bit for bit."""
    ref = model == "ref"
    cfg = PipelineConfig(model=model, n_coarse=16, n_fine=32, nerf_width=64,
                         prop_width=64, ray_batch=300, bottleneck_noise=0.0,
                         pallas_tile=256)
    models = make_models(cfg, cuda)
    for i, m in enumerate(models):
        _randomize(m, (40 if ref else 20) + i, gain=1.0)
    rng = np.random.default_rng(3 if ref else 1)
    rays = np.concatenate([rng.normal(0, 0.2, (300, 3)) + [0, 0, 4.0],
                           rng.normal(0, 0.3, (300, 3)) + [0, 0, -1.0]], -1)
    rays = torch.tensor(rays, dtype=torch.float32, device=cuda)
    gt = torch.tensor(rng.uniform(size=(300, 3)), dtype=torch.float32,
                      device=cuda)
    jit = torch.tensor(rng.uniform(size=(300, 16)), dtype=torch.float32,
                       device=cuda)
    u = torch.tensor(np.sort(rng.uniform(size=(300, 33)), -1),
                     dtype=torch.float32, device=cuda)
    params = train_parameters(models)
    out = []
    for route in (cfg.replace(prop_store_residuals=True), cfg,
                  cfg.replace(use_pallas=False)):
        ops.reset_launches()
        loss, _ = compute_loss(models, rays, gt, route, noise=(jit, u))
        grads = torch.autograd.grad(loss, params)
        out.append((loss, grads, dict(ops.LAUNCHES)))
    assert out[0][2] == dict(dict.fromkeys(ops.LAUNCHES, 0),
                             **dict.fromkeys(kernels, 1)), out[0][2]
    assert not any(out[2][2].values())
    torch.testing.assert_close(out[0][0], out[2][0], rtol=1e-4, atol=1e-6)
    rels = [_rel_err(g, w) for g, w in zip(out[0][1], out[2][1])]
    assert max(rels) < 1e-2, rels
    assert torch.equal(out[0][0], out[1][0])
    assert all(map(torch.equal, out[0][1], out[1][1]))


# ---------------------------------------------------------------------------
# the directional kernels' dissection
# ---------------------------------------------------------------------------

STAGES = ("trunk", "reflect", "vander", "polar", "full")
MODES = ("recompute", "dheads", "wgrads", "full")


@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("n, per_ray", [(1, 1), (70, 7), (4097, 17)])
@pytest.mark.parametrize("hidden, output_dim", [(256, 256), (48, 80)])
def test_dissect_kernels_match_plain(cuda, dtype, n, per_ray, hidden,
                                     output_dim):
    """Every stage of ref_dir_fwd_dissect within TOLS of its plain version,
    stage "full" equal to ref_dir_fwd bit for bit; every mode of
    ref_dir_bwd_dissect within REF_GRAD_REL of its plain version on the
    forward kernel's activations (chunks of two 64-row tiles), zero where the
    mode computes nothing, mode "full" equal to ref_dir_bwd_recompute bit
    for bit and the rebuild mode's rgb, normal and density equal to the
    forward kernel's."""
    m, _, dirs = _ref_operands(cuda, dtype, n, per_ray, n + 9,
                               hidden=hidden, output_dim=output_dim)
    gen = torch.Generator(device=cuda).manual_seed(n + 10)
    _, dir_ws = m.kernel_weights()
    nb = m.bottleneck_dim
    n_ch = (dir_ws[0].shape[0] - nb - 1) // 2
    heads = torch.randn((n, 11 + nb), generator=gen, device=cuda)
    noise = (0.05 * torch.randn((n, nb), generator=gen, device=cuda)).to(dtype)
    rows = 0.1 * torch.randn((2 * n_ch + 1, n), generator=gen, device=cuda)
    g_rgb, g_nrm = torch.randn((2, n, 3), generator=gen, device=cuda)
    g_den = torch.randn((n,), generator=gen, device=cuda)
    ops.reset_launches()
    for stage in STAGES:
        out = ops.ref_dir_fwd_dissect(dir_ws, heads, dirs, per_ray, stage,
                                      noise, rows)
        want = ops.ref_dir_fwd_dissect_plain(dir_ws, heads, dirs, per_ray,
                                             stage, noise, rows)
        for name, a, b in zip(("rgb", "normal", "density"), out, want):
            torch.testing.assert_close(a, b, **TOLS[dtype],
                                       msg=f"{stage} {name}")
    shipped = ops.ref_dir_fwd(dir_ws, heads, dirs, per_ray, noise)
    assert all(map(torch.equal, out, shipped))
    dacts = ops.ref_dir_fwd_res(dir_ws, heads, dirs, per_ray, noise)[3]
    args = (dir_ws, heads, dirs, per_ray, noise, g_rgb, g_nrm, g_den)
    lim = REF_GRAD_REL[dtype]
    for mode in MODES:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ops.fused_mlp, "CHUNK_ROWS", 128)
            dh, grads = ops.ref_dir_bwd_dissect(*args, mode, tile=64)
        pdh, pgrads = ops.ref_dir_bwd_dissect_plain(*args, mode, tile=64,
                                                    acts=dacts)
        if mode == "recompute":
            torch.testing.assert_close(dh, pdh, **TOLS[dtype])
            assert torch.equal(dh[:, :3], shipped[0])
            assert torch.equal(dh[:, 3:6], shipped[1])
            assert torch.equal(dh[:, 6], shipped[2])
        elif mode != "wgrads":
            assert _dheads_rel(dh, pdh) < lim, (mode, _dheads_rel(dh, pdh))
        if mode in ("recompute", "dheads"):
            assert not any(bool(g.any()) for g in grads), mode
        else:
            for i, (a, b) in enumerate(zip(grads, pgrads)):
                assert _rel_err(a, b) < lim, (mode, i, _rel_err(a, b))
        if mode == "wgrads":
            assert not bool(dh.any())
    full = ops.ref_dir_bwd_recompute(*args, tile=64)
    assert torch.equal(dh, full[0])
    assert all(map(torch.equal, grads, full[1]))
    assert ops.LAUNCHES["ref_dir_fwd_dissect"] == len(STAGES)
    assert ops.LAUNCHES["ref_dir_bwd_dissect"] == len(MODES)
