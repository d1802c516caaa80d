"""The CUDA kernels of nerf_tpu_torch against their plain versions, and the
eval path and the training step through them against the nn.Module path,
on the card.

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Every test skips without a CUDA device.  This file imports no JAX, so with
``--noconftest`` (tests/conftest.py sets JAX up) it runs on a machine that
has PyTorch and a card only.
"""

import contextlib

import numpy as np
import pytest
import torch

from nerf_tpu_torch import ops
from nerf_tpu_torch.core import sampling
from nerf_tpu_torch.core.encoding import cat_pos_pe
from nerf_tpu_torch.models import ProposalNetwork, RefNeRF, VanillaNeRF
from nerf_tpu_torch.ops.dense import pack_mask
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
# A bf16 backward on the tensor cores sums its delta products in another
# order than cuBLAS, and a delta rounded one ulp apart makes a few dozen
# values of the next layer round the other way: at width 256 its chain
# parts from the plain version about as far as the plain version parts
# from itself with its delta products summed in f64.  So in bf16 a backward
# is held against the plain version with f64 sums, within the larger of
# GRAD_REL and this factor times the plain version's own distance from it
# (chip_smoke.py's BWD_ORDER_FACTOR, where PERF.md has the readings).
BWD_ORDER_FACTOR = 1.25
# stored activations of a whole chain against the plain forward's, as the
# relative Frobenius error of each (chip_smoke.py's ACT_REL)
ACT_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
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


def _vanilla_layers(ws, x, d, acts):
    """Each of vanilla_mlp_fwd_res's 9 activations as the plain layer
    (ops.dense_layer_plain) computes it from the kernel's own activation
    before it: h1 h2 h3 h4, z5 from [x, h4], z6, z7, bvec (no ReLU), r1
    from [bvec, d]."""
    h1, h2, h3, h4, z5, z6, z7, bvec, _ = acts

    def layer(a0, i, a1=None, relu=True):
        w1 = ws[i + 1] if a1 is not None else None
        b = ws[i + (2 if a1 is not None else 1)]
        return ops.dense_layer_plain(a0, ws[i], b, a1, w1, relu=relu)[0]

    return [layer(x, 0), layer(h1, 2), layer(h2, 4), layer(h3, 6),
            layer(x, 8, h4), layer(z5, 11), layer(z6, 13),
            layer(z7, 17, relu=False), layer(bvec, 19, d)]


@contextlib.contextmanager
def _f64_delta_products():
    """Within, the plain backwards sum their delta products (fused_mlp's
    ``_dwt``, which ref_fused shares) in f64."""
    def f64(delta, w):
        return (delta.double() @ w.double().T).float()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops.fused_mlp, "_dwt", f64)
        mp.setattr(ops.ref_fused, "_dwt", f64)
        yield


def _bwd_reference(dtype, plain, *args):
    """(reference grads, limit) of a backward: in f32 its plain version and
    GRAD_REL; in bf16 the plain version with its delta products summed in
    f64, and the larger of GRAD_REL and BWD_ORDER_FACTOR times the plain
    version's own distance from it (chip_smoke.py's order_reference)."""
    want = plain(*args)
    if dtype != torch.bfloat16:
        return want, GRAD_REL[dtype]
    with _f64_delta_products():
        ref = plain(*args)
    own = max(map(_rel_err, want, ref))
    return ref, max(GRAD_REL[dtype], BWD_ORDER_FACTOR * own)


def _rel_err(got, want):
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-30))


@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("n", [1, 70, 4099])
@pytest.mark.parametrize("width", [48, 256])
def test_training_kernels_match_plain(cuda, dtype, n, width):
    """vanilla_mlp_fwd_res, vanilla_mlp_bwd and prop_mlp_bwd against their
    plain versions on the same operands; each launches once.  Each stored
    activation is held within TOLS against the plain layer on the kernel's
    own input of that layer, and the chain against the plain forward's
    within ACT_REL: at He's scale a value that rounds one ulp apart in an
    early layer carries on through up to eight bf16 layers, and the
    kernel's tensor-core sums round elsewhere than the plain version's
    (chip_smoke.py's order_sensitivity: the plain version itself parts by
    as much when only the order of its f32 sums changes).  prop_mlp_bwd
    rebuilds its forward: its grads are held against the plain backward on
    prop_mlp_fwd_res's activations, which the rebuild equals bit for bit
    (test_prop_res_kernels_match_plain), as chip_smoke.py holds the
    recompute backwards.  In bf16 both are held against their plain
    versions with the delta products summed in f64 (_bwd_reference), and a
    control, the plain backwards with no per-layer cast (run on operands
    upcast to f32), must read beyond that limit."""
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
    for a, pa, la in zip(acts, pacts, _vanilla_layers(vw, x, d, acts)):
        torch.testing.assert_close(a.float(), la.float(), **TOLS[dtype])
        assert _rel_err(a.float(), pa.float()) < ACT_REL[dtype]
    # the same stored activations for both backwards: the masks agree
    want, lim = _bwd_reference(dtype, ops.vanilla_mlp_bwd_plain, vw, x, d,
                               g_rgb, g_sig, rgb3, acts)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel_err(g, w) < lim, (i, _rel_err(g, w), lim)
    pacts = ops.prop_mlp_fwd_res(pw, x)[1]
    pwant, plim = _bwd_reference(dtype, ops.prop_mlp_bwd_res_plain, pw, x,
                                 g_sig, pacts)
    for i, (g, w) in enumerate(zip(pgrads, pwant)):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel_err(g, w) < plim, (i, _rel_err(g, w), plim)
    if dtype == torch.bfloat16:
        def up(ts):
            return [t.float() for t in ts]
        uncast = ops.vanilla_mlp_bwd_plain(up(vw), x.float(), d.float(),
                                           g_rgb, g_sig, rgb3, up(acts))
        assert max(map(_rel_err, uncast, want)) > lim
        uncast = ops.prop_mlp_bwd_plain(up(pw), x.float(), g_sig)
        assert max(map(_rel_err, uncast, pwant)) > plim


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


def _assert_frame_identities(ws, enc, pos):
    """Each of ref_spa_fwd_res's 8 stored activations equals
    ops.dense_layer (the layer tile on its own 64-row frame) of its stored
    inputs, z5 through the two-operand form; ref_spa_fwd's heads and
    ref_spa_fwd_grad's heads and normal target equal ref_spa_fwd_res's, bit
    for bit; the heads meet the plain version's.  Returns the heads and the
    normal target."""
    heads, dgrad, acts = ops.ref_spa_fwd_res(ws, enc, pos)
    (w0, b0, w1, b1, w2, b2, w3, b3, w4a, w4b, b4, w5, b5, w6, b6, w7,
     b7) = ws[:17]
    inputs = [(enc, w0, b0), (acts[0], w1, b1), (acts[1], w2, b2),
              (acts[2], w3, b3), (enc, w4a, b4, acts[3], w4b),
              (acts[4], w5, b5), (acts[5], w6, b6), (acts[6], w7, b7)]
    for i, (a, op) in enumerate(zip(acts, inputs)):
        assert torch.equal(a, ops.dense_layer(*op)[0]), i
    assert torch.equal(ops.ref_spa_fwd(ws, enc), heads)
    g_heads, g_dgrad = ops.ref_spa_fwd_grad(ws, enc, pos)
    assert torch.equal(g_heads, heads) and torch.equal(g_dgrad, dgrad)
    assert bool(torch.isfinite(heads).all() and torch.isfinite(dgrad).all())
    torch.testing.assert_close(heads, ops.ref_spa_plain(ws, enc),
                               **TOLS[torch.bfloat16])
    return heads, dgrad


@pytest.mark.parametrize("n", [1, 127, 129, 50_689])
@pytest.mark.parametrize("hidden, output_dim", [(256, 256), (48, 80)])
def test_ref_spa_frame_identities(cuda, n, hidden, output_dim):
    """The bf16 spatial forwards' persistent frame (csrc/spa_frame.cuh), bit
    for bit (_assert_frame_identities).  At one point, either side of the
    frame's 128-point tile and 50,689 points (more than three tiles for
    each block of an H100's 132 SMs)."""
    m, enc, _ = _ref_operands(cuda, torch.bfloat16, n, 1, n + 3,
                              hidden=hidden, output_dim=output_dim)
    _assert_frame_identities(m.kernel_weights()[0], enc,
                             enc[:, :3].float().contiguous())


def test_ref_spa_frame_wide_widths(cuda):
    """Trunks wider than the frame's 256-column pass take two passes a
    layer into a second activation buffer.  Where two buffers of 128 rows
    do not fit (the training forms above 256 wide, every form at 512), the
    frame runs one consumer warpgroup on 64-point tiles; at 512 wide the
    training forms also read the narrow heads' weights and the encoding's
    tables from device memory.  Every form meets its plain version and the
    identities hold bit for bit as at 256, ragged tiles included.  Above
    the frame's widest fit (528 in the training forms, 704 in the eval
    form) each launcher chooses the 64-row tile by shape, up to the widest
    that tile ran before the frame (712, 616 and 776), and each launch
    reports its body (ops.BODIES); one step wider raises, as it did."""
    tol = TOLS[torch.bfloat16]
    name = ops.ref_fused.spa_body_name
    # (H = O, the body of each form: the frame's consumer warpgroups, 0 for
    # the 64-row tile, None where the width raises)
    cases = (((320, 256), (2, 1, 1)), ((512, 256), (1, 1, 1)),
             ((512, 512), (1, 1, 1)), ((528, 528), (1, 1, 1)),
             ((536, 536), (1, 0, 0)), ((616, 616), (1, 0, 0)),
             ((624, 624), (1, 0, None)), ((704, 704), (1, 0, None)),
             ((712, 712), (0, 0, None)), ((720, 720), (0, None, None)),
             ((776, 776), (0, None, None)), ((784, 784), (None,) * 3))
    for seed, ((hidden, output_dim), cons) in enumerate(cases):
        m, enc, _ = _ref_operands(cuda, torch.bfloat16, 4099, 1, 5 + seed,
                                  hidden=hidden, output_dim=output_dim)
        ws = m.kernel_weights()[0]
        pos = enc[:, :3].float().contiguous()
        if None not in cons:
            _assert_frame_identities(ws, enc, pos)
            acts = ops.ref_spa_fwd_res(ws, enc, pos)[2]
            for a, pa in zip(acts,
                             ops.ref_spa_fwd_res_plain(ws, enc, pos)[2]):
                torch.testing.assert_close(a.float(), pa.float(), **tol)
        plain = ops.ref_spa_plain(ws, enc)
        for form, c in zip(("eval", "res", "grad"), cons):
            fn = {"eval": lambda: ops.ref_spa_fwd(ws, enc),
                  "res": lambda: ops.ref_spa_fwd_res(ws, enc, pos)[0],
                  "grad": lambda: ops.ref_spa_fwd_grad(ws, enc, pos)[0]}[form]
            kernel = "ref_spa_fwd" + ("" if form == "eval" else "_" + form)
            if c is None:
                with pytest.raises(RuntimeError, match="launch failed"):
                    fn()
                continue
            ops.reset_launches()
            torch.testing.assert_close(fn(), plain, **tol)
            assert ops.BODIES == {kernel: {name(c, form): 1}}, (hidden, form)
    torch.cuda.synchronize()


def _vanilla_frame_operands(cuda, n, seed, h, bn, r):
    """A seeded bf16 vanilla weight tuple at trunk width h, bottleneck bn
    and rgb width r (weights N(0, 1 / fan_in), biases N(0, 0.25)), and the
    encodings of n points, uniform in [-1, 1]."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    shapes = [(63, h), (1, h), (h, h), (1, h), (h, h), (1, h), (h, h),
              (1, h), (63, h), (h, h), (1, h), (h, h), (1, h), (h, bn),
              (1, bn), (bn, 1), (1, 1), (bn, bn), (1, bn), (bn, r), (27, r),
              (1, r), (r, 3), (1, 3)]
    ws = []
    for i, shape in enumerate(shapes):
        t = torch.randn(shape, generator=gen, device=cuda)
        if i in ops.fused_mlp.VANILLA_BIASES:
            ws.append(0.5 * t)
        else:
            ws.append((t / shape[0] ** 0.5).to(torch.bfloat16))
    enc = [(torch.rand((n, k), generator=gen, device=cuda) * 2 - 1).to(
        torch.bfloat16) for k in (63, 27)]
    return ws, enc[0], enc[1]


def _assert_vanilla_frame_identities(ws, x, d, cons=2, layers=True):
    """vanilla_mlp_fwd's rgb3 and sigma equal vanilla_mlp_fwd_res's; with
    ``layers`` each of the 9 stored activations equals ops.dense_layer of
    its stored inputs (z5 and r1 through the two-operand form, bvec without
    the ReLU), bit for bit; every output is finite and meets the plain
    version's; each launch reports the body ``cons`` names (ops.BODIES: the
    frame's consumer warpgroups, 0 for the 64-row tile)."""
    ops.reset_launches()
    rgb3, sigma = ops.vanilla_mlp_fwd(ws, x, d)
    res = ops.vanilla_mlp_fwd_res(ws, x, d)
    name = ops.fused_mlp.vanilla_body_name
    assert ops.BODIES == {"vanilla_mlp_fwd": {name(cons, False): 1},
                          "vanilla_mlp_fwd_res": {name(cons, True): 1}}
    assert torch.equal(rgb3, res[0]) and torch.equal(sigma, res[1])
    acts = res[2]
    (w0, b0, w1, b1, w2, b2, w3, b3, w4a, w4b, b4, w5, b5, w6, b6, _, _, wb,
     bb, wr1a, wr1b, br1) = ws[:22]
    inputs = [(x, w0, b0), (acts[0], w1, b1), (acts[1], w2, b2),
              (acts[2], w3, b3), (x, w4a, b4, acts[3], w4b),
              (acts[4], w5, b5), (acts[5], w6, b6), (acts[6], wb, bb),
              (acts[7], wr1a, br1, d, wr1b)]
    for i, (a, op) in enumerate(zip(acts, inputs) if layers else ()):
        assert torch.equal(a, ops.dense_layer(*op, relu=i != 7)[0]), i
    assert all(bool(torch.isfinite(t).all())
               for t in (rgb3, sigma) + tuple(acts))
    prgb3, psigma = ops.vanilla_mlp_plain(ws, x, d)
    torch.testing.assert_close(rgb3, prgb3, **TOLS[torch.bfloat16])
    torch.testing.assert_close(sigma, psigma, **TOLS[torch.bfloat16])


@pytest.mark.parametrize("n", [1, 127, 129, 50_689])
@pytest.mark.parametrize("h, bn, r", [(256, 256, 128), (48, 40, 24),
                                      (64, 64, 32)])
def test_vanilla_frame_identities(cuda, n, h, bn, r):
    """The bf16 vanilla forwards' persistent frame (csrc/vanilla_frame.cuh),
    bit for bit (_assert_vanilla_frame_identities): at one point, either
    side of the frame's 128-point tile and 50,689 points (more than three
    tiles for each block of an H100's 132 SMs), at the model's widths and
    two narrow ones."""
    ws, x, d = _vanilla_frame_operands(cuda, n, n + h, h, bn, r)
    _assert_vanilla_frame_identities(ws, x, d, cons=2)


def test_vanilla_frame_wide_widths(cuda):
    """Above 256 wide the frame takes two passes a layer into a second
    activation buffer, on two consumer warpgroups while two buffers of 128
    rows fit and on one on 64-point tiles above; above the frame's widest
    fit (688) the launcher chooses the 64-row tile by shape, up to the
    widest that tile ran before the frame (760); 768 raises, as it did.
    At 760 ops.dense_layer's own block cannot hold the skip layer (its
    mask words beside the 64-row tile's buffers), so the stored activations
    are held there to the plain version's alone (ACT_REL, as at every
    width)."""
    # (H, B, R, the frame's consumer warpgroups; 0: the 64-row tile)
    cases = ((320, 320, 160, 2), (512, 512, 256, 1), (688, 688, 344, 1),
             (696, 696, 344, 0), (744, 744, 368, 0), (760, 760, 376, 0))
    for seed, (h, bn, r, cons) in enumerate(cases):
        ws, x, d = _vanilla_frame_operands(cuda, 4099, 60 + seed, h, bn, r)
        _assert_vanilla_frame_identities(ws, x, d, cons=cons,
                                         layers=h < 760)
        acts = ops.vanilla_mlp_fwd_res(ws, x, d)[2]
        plain = ops.vanilla_mlp_fwd_res_plain(ws, x, d)[2]
        for i, (a, pa) in enumerate(zip(acts, plain)):
            rel = _rel_err(a.float(), pa.float())
            assert rel < ACT_REL[torch.bfloat16], (h, i, rel)
    ws, x, d = _vanilla_frame_operands(cuda, 70, 70, 768, 768, 384)
    for fn in (ops.vanilla_mlp_fwd, ops.vanilla_mlp_fwd_res):
        with pytest.raises(RuntimeError, match="launch failed"):
            fn(ws, x, d)
    torch.cuda.synchronize()


def _prop_frame_operands(cuda, n, seed, h):
    """A seeded bf16 proposal weight tuple at width h (weights N(0, 1 /
    fan_in), biases N(0, 0.25)), and the encodings of n points, uniform in
    [-1, 1]."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    ws = []
    for shape in ((63, h), (h, h), (h, h), (h, h), (h, 1)):
        w = torch.randn(shape, generator=gen, device=cuda)
        ws += [(w / shape[0] ** 0.5).to(torch.bfloat16),
               0.5 * torch.randn((1, shape[1]), generator=gen, device=cuda)]
    x = (torch.rand((n, 63), generator=gen, device=cuda) * 2 - 1).to(
        torch.bfloat16)
    return ws, x


def _assert_prop_frame_identities(ws, x, cons=2, layers=True):
    """prop_mlp_fwd's density equals prop_mlp_fwd_res's; with ``layers``
    each stored h1 .. h4 equals ops.dense_layer of its stored input (h1 of
    x), bit for bit;
    every output is finite and the density meets the plain version's; each
    launch reports the body ``cons`` names (ops.BODIES: the frame's
    consumer warpgroups, 0 for the 64-row tile)."""
    ops.reset_launches()
    density = ops.prop_mlp_fwd(ws, x)
    dres, acts = ops.prop_mlp_fwd_res(ws, x)
    name = ops.fused_mlp.prop_body_name
    assert ops.BODIES == {"prop_mlp_fwd": {name(cons, False): 1},
                          "prop_mlp_fwd_res": {name(cons, True): 1}}
    assert torch.equal(density, dres)
    for i, (a, a_in) in enumerate(zip(acts, (x,) + tuple(acts[:3]))
                                  if layers else ()):
        assert torch.equal(a, ops.dense_layer(a_in, ws[2 * i],
                                              ws[2 * i + 1])[0]), i
    assert all(bool(torch.isfinite(t).all()) for t in (density,) + acts)
    torch.testing.assert_close(density, ops.prop_mlp_plain(ws, x),
                               **TOLS[torch.bfloat16])


@pytest.mark.parametrize("n", [1, 127, 129, 50_689])
@pytest.mark.parametrize("h", [256, 48, 64])
def test_prop_frame_identities(cuda, n, h):
    """The bf16 proposal forwards' persistent frame (csrc/prop_frame.cuh),
    bit for bit (_assert_prop_frame_identities): at one point, either side
    of the frame's 128-point tile and 50,689 points, at the model's width
    and two narrow ones."""
    ws, x = _prop_frame_operands(cuda, n, n + h, h)
    _assert_prop_frame_identities(ws, x, cons=2)


def test_prop_frame_wide_widths(cuda):
    """Above 256 wide the frame takes two passes a layer into a second
    activation buffer, on two consumer warpgroups while two buffers of 128
    rows fit and on one on 64-point tiles above; above the frame's widest
    fit the launcher chooses the 64-row tile by shape, up to the widest
    that tile ran before the frame (chip_smoke.py's PROP_TILE_WIDEST, 776);
    784 raises, as it did.  Past the frame the stored activations are held
    to the plain version's (ACT_REL), where ops.dense_layer's own block
    may not hold the layer."""
    # (H, the frame's consumer warpgroups; 0: the 64-row tile)
    cases = ((320, 2), (512, 1), (752, 1), (760, 0), (776, 0))
    for seed, (h, cons) in enumerate(cases):
        ws, x = _prop_frame_operands(cuda, 4099, 80 + seed, h)
        _assert_prop_frame_identities(ws, x, cons=cons, layers=cons > 0)
        acts = ops.prop_mlp_fwd_res(ws, x)[1]
        plain = ops.prop_mlp_fwd_res_plain(ws, x)[1]
        for i, (a, pa) in enumerate(zip(acts, plain)):
            rel = _rel_err(a.float(), pa.float())
            assert rel < ACT_REL[torch.bfloat16], (h, i, rel)
    ws, x = _prop_frame_operands(cuda, 70, 90, 784)
    for fn in (ops.prop_mlp_fwd, ops.prop_mlp_fwd_res):
        with pytest.raises(RuntimeError, match="launch failed"):
            fn(ws, x)
    torch.cuda.synchronize()


def _assert_dir_frame_identities(ws, heads, dirs, per_ray, noise=None,
                                 ide_level=4, use_srgb=False, cons=2):
    """ref_dir_fwd's rgb, normal and density equal ref_dir_fwd_dissect's
    "full" stage (the 64-row tile; its sRGB is off, so rgb is compared where
    sRGB is off) and ref_dir_fwd_res's; the stored activations h2, h3, h4,
    z6, z7 and z8 equal ops.dense_layer of their stored inputs, bit for bit;
    every output is finite and rgb meets the plain version's; each launch
    reports the body ``cons`` names (ops.BODIES: the frame's consumer
    warpgroups, 0 for the 64-row tile)."""
    args = (ws, heads, dirs, per_ray, noise, ide_level, use_srgb)
    ops.reset_launches()
    fwd = ops.ref_dir_fwd(*args)
    rgb, normal, density, acts = ops.ref_dir_fwd_res(*args)
    assert ops.BODIES == {
        name: {ops.ref_fused.dir_body_name(cons, res): 1}
        for name, res in (("ref_dir_fwd", False), ("ref_dir_fwd_res", True))}
    full = ops.ref_dir_fwd_dissect(ws, heads, dirs, per_ray, "full",
                                   noise=noise, ide_level=ide_level)
    for i in ((1, 2) if use_srgb else (0, 1, 2)):
        assert torch.equal(fwd[i], full[i]), i
    for i, a in enumerate((rgb, normal, density)):
        assert torch.equal(fwd[i], a), i
    for i in (1, 2, 3, 5, 6, 7):
        j = 2 * i if i < 4 else 2 * i + 1       # w_i's index in the tuple
        assert torch.equal(acts[i], ops.dense_layer(acts[i - 1], ws[j],
                                                    ws[j + 1])[0]), i
    assert all(bool(torch.isfinite(t).all()) for t in list(fwd) + list(acts))
    torch.testing.assert_close(
        fwd[0], ops.ref_dir_plain(*args)[0], **TOLS[torch.bfloat16])


def _dir_frame_operands(cuda, n, per_ray, seed, ide_level=4, noisy=False,
                        **model):
    """A randomized bf16 RefNeRF's directional weights, heads of n points
    N(0, 1) (the spatial kernels run narrower trunks than the 64-row
    directional tile does), the directions of n / per_ray rays and, with
    ``noisy``, a bottleneck noise."""
    m, _, dirs = _ref_operands(cuda, torch.bfloat16, n, per_ray, seed,
                               ide_level=ide_level, **model)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    heads = torch.randn((n, 11 + 128), generator=gen, device=cuda)
    noise = ((0.05 * torch.randn((n, 128), generator=gen,
                                 device=cuda)).to(torch.bfloat16)
             if noisy else None)
    return m.kernel_weights()[1], heads, dirs, noise


@pytest.mark.parametrize("n", [1, 127, 129, 50_689])
@pytest.mark.parametrize("hidden, output_dim", [(256, 256), (48, 80)])
def test_ref_dir_frame_identities(cuda, n, hidden, output_dim):
    """The bf16 directional forwards' persistent frame (csrc/dir_frame.cuh),
    bit for bit (_assert_dir_frame_identities): at one point, either side of
    the frame's 128-point tile and 50,689 points, with a few points a ray,
    at IDE levels 4 and 5, with and without noise and the sRGB curve."""
    per_ray = {1: 1, 127: 127, 129: 3, 50_689: 173}[n]
    level = 5 if n in (127, 50_689) else 4
    srgb = n == 129
    ws, heads, dirs, noise = _dir_frame_operands(
        cuda, n, per_ray, n + 11, ide_level=level, noisy=n != 129,
        hidden=hidden, output_dim=output_dim, use_srgb=srgb)
    _assert_dir_frame_identities(ws, heads, dirs, per_ray, noise, level,
                                 srgb, cons=2)


def test_ref_dir_frame_wide_widths(cuda):
    """Above 256 wide the frame takes two passes a layer and runs one
    consumer warpgroup on 64-point tiles, bit for bit as at 256.  Above the
    frame's widest fit (640 at IDE level 4) the launcher chooses the 64-row
    tile by shape, up to the widest that tile ran before the frame (712 at
    level 4); 720 raises, as it did."""
    # (H, O, the frame's consumer warpgroups; 0: the 64-row tile)
    cases = ((320, 256, 1), (512, 256, 1), (512, 512, 1), (640, 640, 1),
             (704, 704, 0), (712, 712, 0))
    for seed, (hidden, output_dim, cons) in enumerate(cases):
        ws, heads, dirs, noise = _dir_frame_operands(
            cuda, 4099, 1, 40 + seed, noisy=True, hidden=hidden,
            output_dim=output_dim)
        _assert_dir_frame_identities(ws, heads, dirs, 1, noise, cons=cons)
    ws, heads, dirs, _ = _dir_frame_operands(cuda, 70, 7, 50, hidden=720,
                                             output_dim=720)
    for fn in (ops.ref_dir_fwd, ops.ref_dir_fwd_res):
        with pytest.raises(RuntimeError, match="launch failed"):
            fn(ws, heads, dirs, 7)
    torch.cuda.synchronize()


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


def _spa_bwd_operands(cuda, n, seed, hidden, output_dim):
    """A randomized RefNeRF's bf16 spatial weights (_ref_operands), the
    encodings and positions of n points, and a heads' cotangent N(0, 1)."""
    m, enc, _ = _ref_operands(cuda, torch.bfloat16, n, 1, seed,
                              hidden=hidden, output_dim=output_dim)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    g = torch.randn((n, 11 + m.bottleneck_dim), generator=gen, device=cuda)
    return m.kernel_weights()[0], enc, enc[:, :3].float().contiguous(), g


def _assert_spa_bwd_deltas(ws, g, acts, deltas, recompute):
    """The deltas of a spatial backward (d1 .. d7, d(inter)) against
    ops.delta_layer, bit for bit: d(inter) from the heads' three pullbacks
    added in the 64-row tile's order (g_rt's, g_nct's, g_bn's masked by
    inter; the reverse in the recompute form), each of d7 .. d1 from the
    delta before it, its layer's W and the activation that masks it."""
    heads = [(g[:, :2], ws[17]), (g[:, 2:11], ws[19]), (g[:, 11:], ws[21])]
    if recompute:
        heads.reverse()
    (a0, w0), (a1, w1), (a2, w2) = [(a.to(torch.bfloat16).contiguous(), w)
                                    for a, w in heads]
    t = ops.delta_layer(a0, w0)[0]
    t = ops.delta_layer(a1, w1, add=t)[0]
    assert torch.equal(deltas[7],
                       ops.delta_layer(a2, w2, act=acts[7], add=t)[0])
    for j, w in enumerate((ws[15], ws[13], ws[11], ws[9], ws[6], ws[4],
                           ws[2])):
        assert torch.equal(deltas[6 - j], ops.delta_layer(
            deltas[7 - j], w, act=acts[6 - j])[0]), j


def _assert_spa_bwd_frame(ws, enc, pos, g, cons, fwd=True, tile=64):
    """ref_spa_bwd (on the plain forward's activations) and
    ref_spa_bwd_recompute over at most a chunk of points: each launch
    reports the body that ``cons`` names for its form (ops.BODIES: the
    frame's consumer warpgroups, 0 for the 64-row tile; None: the form
    raises); the residual form's rounded heads' cotangents equal g's
    columns cast to bf16 and its deltas meet _assert_spa_bwd_deltas; the
    recompute form's deltas too, in its order, on the activations it
    rebuilt, which equal ref_spa_fwd_res's (with ``fwd``: where that
    forward runs); the grads of both are finite and meet the plain
    versions' (REF_GRAD_REL, the recompute form's on its rebuilt
    activations)."""
    name = ops.ref_fused.spa_bwd_body_name
    lim = REF_GRAD_REL[torch.bfloat16]
    acts = ops.ref_spa_fwd_res_plain(ws, enc, pos)[2]
    for form, c in zip(("res", "recompute"), cons):
        rc = form == "recompute"
        kernel = "ref_spa_bwd_recompute" if rc else "ref_spa_bwd"
        if rc:
            def call():
                return ops.ref_fused._spa_bwd_recompute_launch(ws, enc, g,
                                                               tile)
        else:
            def call():
                return ops.ref_fused._spa_bwd_launch(ws, enc, g, acts, tile)
        if c is None:
            with pytest.raises(RuntimeError, match="launch failed"):
                call()
            continue
        ops.reset_launches()
        out = call()
        torch.cuda.synchronize()
        assert ops.BODIES == {kernel: {name(c, form): 1}}, form
        grads, deltas = out[0], out[-1]
        if rc:
            racts = out[1]
            if fwd:
                for a, b in zip(racts, ops.ref_spa_fwd_res(ws, enc, pos)[2]):
                    assert torch.equal(a, b)
            want = ops.ref_spa_bwd_recompute_plain(ws, enc, g, tile,
                                                   acts=racts)
        else:
            racts = acts
            for d, (a, b) in zip(deltas[8:], ((0, 2), (2, 11), (11, None))):
                assert torch.equal(d, g[:, a:b].to(torch.bfloat16))
            want = ops.ref_spa_bwd_plain(ws, enc, g, acts, tile)
        _assert_spa_bwd_deltas(ws, g, racts, deltas, rc)
        for i, (a, b) in enumerate(zip(grads, want)):
            assert bool(torch.isfinite(a).all()), (form, i)
            assert _rel_err(a, b) < lim, (form, i, _rel_err(a, b))


@pytest.mark.parametrize("n", [1, 127, 129, 4099])
@pytest.mark.parametrize("hidden, output_dim", [(256, 256), (48, 80)])
def test_spa_bwd_frame_identities(cuda, n, hidden, output_dim):
    """The bf16 spatial backwards' delta passes on the persistent frame
    (csrc/spa_bwd_frame.cuh), two consumer warpgroups on 128-point tiles,
    bit for bit (_assert_spa_bwd_frame): at one point, either side of the
    frame's tile and 4099 points (ragged 64-row weight-grad tiles)."""
    ws, enc, pos, g = _spa_bwd_operands(cuda, n, n + 7, hidden, output_dim)
    _assert_spa_bwd_frame(ws, enc, pos, g, (2, 2))


def test_spa_bwd_frame_wide_widths(cuda):
    """Above 256 wide each form runs one consumer warpgroup on 64-point
    tiles, its layers in two passes into a second activation buffer, to
    its widest fit (496 residual, 520 recompute on an H100 80GB HBM3); above
    it the launcher chooses the 64-row tile by shape, up to the widest that
    tile ran before the frame (chip_smoke.py's SPA_BWD_TILE_WIDEST: 768 and
    736); one step wider raises, as it did.  The identities hold on either
    body (_assert_spa_bwd_frame; past 712 wide, where ref_spa_fwd_res
    raises, the recompute form's rebuilt activations are not held to it)."""
    # (H = O, the body of each form: the frame's consumer warpgroups, 0 for
    # the 64-row tile, None where the width raises)
    cases = ((320, (1, 1)), (496, (1, 1)), (504, (0, 1)), (520, (0, 1)),
             (528, (0, 0)), (736, (0, 0)), (744, (0, None)),
             (768, (0, None)), (776, (None, None)))
    for seed, (w, cons) in enumerate(cases):
        ws, enc, pos, g = _spa_bwd_operands(cuda, 300, 40 + seed, w, w)
        _assert_spa_bwd_frame(ws, enc, pos, g, cons, fwd=w <= 712)
    torch.cuda.synchronize()


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
    GRAD_REL of its plain version (in bf16 the limit of _bwd_reference).
    Both backwards give the same grads with one K-split a chunk (two chunks
    at N = 4099) as with the default chunks.  In bf16 the plain backward
    with no per-layer cast reads beyond that limit."""
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
    want, lim = _bwd_reference(dtype, ops.prop_mlp_bwd_res_plain, pw, x, g,
                               acts)
    for i, (a, w) in enumerate(zip(grads, want)):
        assert a.shape == w.shape and a.dtype == torch.float32
        assert _rel_err(a, w) < lim, (i, _rel_err(a, w), lim)
        assert torch.equal(a, recompute[i]), i
        assert torch.equal(a, one_res[i]) and torch.equal(a, one[i]), i
    if dtype == torch.bfloat16 and n > 1:
        uncast = ops.prop_mlp_bwd_res_plain([t.float() for t in pw],
                                            x.float(), g,
                                            [a.float() for a in acts])
        assert max(map(_rel_err, uncast, want)) > lim


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


# ---------------------------------------------------------------------------
# the split-K weight-grad pass on its own (ops.wgrad_reduce)
# ---------------------------------------------------------------------------

# the pass against its plain version, as the relative Frobenius error of
# each grad: GRAD_REL for unrounded partials (vanilla and proposal lists),
# chip_smoke.py's REF_GRAD_REL (8e-4) for partials rounded per split (the
# Ref-NeRF lists: a split's partial summed in another order may round to the
# neighbouring bf16 value)
WGRAD_REL = {False: GRAD_REL[torch.bfloat16], True: 8e-4}
# a ragged last split; 40 splits of two chunks, so that a block walks
# several (tile, split) items
WGRAD_N, WGRAD_ROWS, WGRAD_CHUNK = 5000, 128, 2048


def _wgrad_jobs(cuda, m, k, layout, dtype=torch.bfloat16, seed=0):
    """A (N, m) in ``dtype`` and delta (N, k): contiguous in ``dtype`` or
    in f32, or columns [2, 2 + k) of an (N, k + 11) f32 or ``dtype`` array
    (an f32 one is the strided, offset heads' cotangent of the spatial
    recompute backward); a second job shares delta with a 256-wide A and no
    bias.  In bf16 they take every staging path of csrc/wgrad.cuh: 16-byte
    copies, spans (63- and 27-wide A, the strided bf16 delta), float4 (the
    contiguous f32 delta of width 128 or 256) and elements."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.randn((WGRAD_N, m), generator=gen, device=cuda).to(dtype)
    a2 = torch.randn((WGRAD_N, 256), generator=gen, device=cuda).to(dtype)
    dt = torch.float32 if "f32" in layout else dtype
    if layout.startswith("strided"):
        wide = torch.randn((WGRAD_N, k + 11), generator=gen, device=cuda)
        d = wide.to(dt)[:, 2:2 + k]
    else:
        d = torch.randn((WGRAD_N, k), generator=gen, device=cuda).to(dt)
    return [(a, d, True), (a2, d, False)]


WGRAD_LAYOUTS = ["contiguous", "f32", "strided_f32", "strided_bf16"]


@pytest.mark.parametrize("round_partial", [False, True])
@pytest.mark.parametrize("layout", WGRAD_LAYOUTS)
@pytest.mark.parametrize("k", [1, 3, 9, 128, 256])
@pytest.mark.parametrize("m", [63, 27, 128, 256])
def test_wgrad_kernel_matches_plain(cuda, m, k, layout, round_partial):
    """The bf16 tensor-core pass against wgrad_reduce_plain on the same
    jobs (misaligned 63- and 27-wide A, 1- to 9-wide heads, f32 deltas,
    strided deltas at an offset), two launches equal bit for bit, and the
    chunked
    walk (two splits a chunk, reduced onto the sums so far) equal to one
    pass bit for bit."""
    jobs = _wgrad_jobs(cuda, m, k, layout, seed=m * 1000 + k)
    ops.reset_launches()
    got = ops.wgrad_reduce(jobs, WGRAD_ROWS, round_partial)
    again = ops.wgrad_reduce(jobs, WGRAD_ROWS, round_partial)
    walked = None
    for c0 in range(0, WGRAD_N, WGRAD_CHUNK):
        walked = ops.wgrad_reduce(
            [(a[c0:c0 + WGRAD_CHUNK], d[c0:c0 + WGRAD_CHUNK], b)
             for a, d, b in jobs], WGRAD_ROWS, round_partial, grads=walked)
    want = ops.wgrad_reduce_plain(jobs, WGRAD_ROWS, round_partial)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["wgrad_reduce"] == 5
    assert [tuple(g.shape) for g in got] == [(m, k), (1, k), (256, k)]
    for i, (a, b) in enumerate(zip(got, want)):
        assert _rel_err(a, b) < WGRAD_REL[round_partial], (i, _rel_err(a, b))
    assert all(map(torch.equal, got, again))
    assert all(map(torch.equal, got, walked))


@pytest.mark.parametrize("layout", ["contiguous", "strided_f32"])
@pytest.mark.parametrize("m, k", [(63, 256), (256, 3), (256, 256)])
def test_wgrad_f32_body_matches_plain(cuda, m, k, layout):
    """f32 operands take the CUDA-core body in full f32: within 1e-5 of the
    plain version's f32 products (no TF32, which keeps about three digits),
    two launches equal bit for bit."""
    jobs = _wgrad_jobs(cuda, m, k, layout, dtype=torch.float32, seed=k)
    got = ops.wgrad_reduce(jobs, WGRAD_ROWS, False)
    again = ops.wgrad_reduce(jobs, WGRAD_ROWS, False)
    want = ops.wgrad_reduce_plain(jobs, WGRAD_ROWS, False)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert _rel_err(a, b) < 1e-5, (i, _rel_err(a, b))
    assert all(map(torch.equal, got, again))


WGRAD_GATE_SHAPES = [(256, 256), (63, 256)]
WGRAD_GATE_FACTOR = 1.0


@pytest.mark.parametrize("m, k", WGRAD_GATE_SHAPES)
def test_wgrad_rounding_gate(cuda, m, k):
    """The bf16 pass adds each k-step's tensor-core sum of 16 points to an
    f32 sum: its weight grad lies at most as far (relative Frobenius error)
    from the splits summed in f64 (wgrad_reduce_f64) as the f32 sum taken
    point by point in order (wgrad_reduce_in_order), at the trunk job (A
    and delta read by TMA) and the 63-wide first-layer job (A staged by the
    threads).  A pass that chains its k-steps through the tensor cores'
    truncating accumulator reads above it (tools/tile_variants' wchain,
    PERF.md)."""
    from nerf_tpu_torch.ops import wgrad as wgrad_lib

    gen = torch.Generator(device=cuda).manual_seed(18)
    a = torch.randn((131_072, m), generator=gen, device=cuda)
    a = (a.relu() if m != 63 else torch.rand(
        (131_072, m), generator=gen, device=cuda) * 2 - 1)
    d = torch.rand((131_072, k), generator=gen, device=cuda) * 2 - 1
    jobs = [(a.to(torch.bfloat16), d.to(torch.bfloat16), True)]
    exact = wgrad_lib.wgrad_reduce_f64(jobs, 4096)[0]
    got = wgrad_lib.summation_error(ops.wgrad_reduce(jobs, 4096)[0], exact)
    in_order = wgrad_lib.summation_error(
        wgrad_lib.wgrad_reduce_in_order(jobs, 4096)[0], exact)
    assert 0 < in_order["rel"]
    assert got["rel"] <= WGRAD_GATE_FACTOR * in_order["rel"], (got, in_order)


@pytest.mark.parametrize("rows", [100, 4095, 1])
def test_wgrad_ragged_splits_match_plain(cuda, rows):
    """K-splits whose size is no multiple of the pass's 64-point chunks, so
    that a chunk of the TMA-read operands reaches into the next split: the
    rows past a split's end count as zeros.  The trunk job and a 63-wide
    job, against wgrad_reduce_plain, two launches equal bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(rows)
    n = 9_000 if rows > 1 else 70

    def g(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
    d = g(n, 256)
    jobs = [(g(n, 256), d, True), (g(n, 63), d, False), (g(n, 128), g(n, 128),
                                                        True)]
    got = ops.wgrad_reduce(jobs, rows)
    again = ops.wgrad_reduce(jobs, rows)
    want = ops.wgrad_reduce_plain(jobs, rows)
    torch.cuda.synchronize()
    for i, (x, y) in enumerate(zip(got, want)):
        assert _rel_err(x, y) < WGRAD_REL[False], (i, _rel_err(x, y))
    assert all(map(torch.equal, got, again))


@pytest.mark.parametrize("offset", [0, 1, 3])
def test_wgrad_odd_stride_f32_delta_matches_plain(cuda, offset):
    """An f32 delta read in place from a wider array of odd row stride (13
    floats: no 16-byte rows) at an odd offset, as the heads' strided
    cotangent is read, beside a bf16 delta of odd stride; the threads stage
    both and round the f32 one.  Against wgrad_reduce_plain, the bias from
    the unrounded values."""
    gen = torch.Generator(device=cuda).manual_seed(offset)
    n = 5_000
    wide = torch.randn((n, 13), generator=gen, device=cuda)
    wide16 = torch.randn((n, 13), generator=gen, device=cuda).to(
        torch.bfloat16)
    a = torch.randn((n, 256), generator=gen, device=cuda).to(torch.bfloat16)
    jobs = [(a, wide[:, offset:offset + 9], True),
            (a, wide16[:, offset:offset + 3], True)]
    got = ops.wgrad_reduce(jobs, 128)
    want = ops.wgrad_reduce_plain(jobs, 128)
    torch.cuda.synchronize()
    for i, (x, y) in enumerate(zip(got, want)):
        assert _rel_err(x, y) < WGRAD_REL[False], (i, _rel_err(x, y))


def test_wgrad_rejects_cpu_jobs_on_the_card(cuda):
    (a, d, b), _ = _wgrad_jobs(cuda, 64, 64, "contiguous")
    with pytest.raises(ValueError, match="is on cpu"):
        ops.wgrad_reduce([(a, d.cpu(), b)], WGRAD_ROWS)


# ---------------------------------------------------------------------------
# the forward layer tile on its own (ops.dense_layer)
# ---------------------------------------------------------------------------

# the trunk inputs and hidden widths of the fused kernels' layers (one
# product), and their skip layers (two)
DENSE_KS = [(63,), (27,), (167,), (128,), (256,), (63, 256), (167, 256),
            (256, 27)]


def _dense_operands(cuda, n, ks, n_out, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    acts = [(torch.rand((n, k), generator=gen, device=cuda) * 2 - 1).to(dtype)
            for k in ks]
    ws = [(torch.randn((k, n_out), generator=gen, device=cuda)
           * (2.0 / sum(ks)) ** 0.5).to(dtype) for k in ks]
    b = torch.randn(n_out, generator=gen, device=cuda) * 0.5
    return acts, ws, b


def _dense_call(fn, acts, ws, b, **kw):
    a1 = acts[1] if len(acts) > 1 else None
    w1 = ws[1] if len(ws) > 1 else None
    return fn(acts[0], ws[0], b, a1, w1, **kw)


@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("n_out", [128, 256])
@pytest.mark.parametrize("ks", DENSE_KS)
def test_dense_layer_matches_plain(cuda, ks, n_out, dtype):
    """The tile alone against its plain version within TOLS at the fused
    kernels' layer shapes (misaligned 63-, 27- and 167-wide inputs, the
    skip layers) over a single row, a ragged second tile and a ragged 65th;
    its stored rows equal its output and its mask bits are its output's
    ``> 0``, bit for bit; two launches equal bit for bit.  bf16 runs on the
    tensor cores, f32 on the CUDA cores in full f32."""
    for n in (1, 70, 4099):
        acts, ws, b = _dense_operands(cuda, n, ks, n_out, dtype, seed=n)
        ops.reset_launches()
        out, stored, bits = _dense_call(ops.dense_layer, acts, ws, b,
                                        store=True, mask=True)
        again, _, _ = _dense_call(ops.dense_layer, acts, ws, b)
        want, _, _ = _dense_call(ops.dense_layer_plain, acts, ws, b)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["dense_layer"] == 2
        torch.testing.assert_close(out.float(), want.float(), **TOLS[dtype])
        assert torch.equal(out, again)
        assert torch.equal(out, stored)
        assert torch.equal(bits, pack_mask(out))


@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("ks, n_out", [((63,), 48), ((48,), 40), ((40,), 48),
                                       ((48, 27), 24), ((40,), 80),
                                       ((80,), 80), ((48,), 552)])
def test_dense_layer_narrow_and_wide(cuda, ks, n_out, dtype):
    """The card tests' narrow widths (k-steps past a 40- or 48-wide input,
    output words split between the warps' halves, a half with no column)
    and a layer wider than one 256-column pass with a ragged last pass,
    without the ReLU too."""
    acts, ws, b = _dense_operands(cuda, 4099, ks, n_out, dtype, seed=n_out)
    for relu in (True, False):
        out, stored, bits = _dense_call(ops.dense_layer, acts, ws, b,
                                        relu=relu, store=True, mask=True)
        want, _, _ = _dense_call(ops.dense_layer_plain, acts, ws, b,
                                 relu=relu)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), want.float(), **TOLS[dtype])
        assert torch.equal(out, stored)
        assert torch.equal(bits, pack_mask(out))


def test_bf16_tile_widths_must_be_multiples_of_8(cuda):
    """The bf16 tile takes output widths that are multiples of 8: the
    layer's entry rejects others before a launch, a fused kernel's launch
    returns the error; neither runs another route."""
    acts, ws, b = _dense_operands(cuda, 70, (63,), 36, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.dense_layer(acts[0], ws[0], b)
    p = ProposalNetwork(hidden=36, dtype=torch.bfloat16).to(cuda)
    x = torch.zeros((70, 63), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="prop_mlp_fwd launch failed"):
        ops.prop_mlp_fwd(p.kernel_weights(), x)
    f = ProposalNetwork(hidden=36).to(cuda)
    torch.testing.assert_close(
        ops.prop_mlp_fwd(f.kernel_weights(), x.float()),
        ops.prop_mlp_plain(f.kernel_weights(), x.float()),
        **TOLS[torch.float32])


# ---------------------------------------------------------------------------
# the backwards' delta pass on its own (ops.delta_layer)
# ---------------------------------------------------------------------------

# (k_dim, n_out, form): the heads' k_dim of 0, 2, 3 and 9, narrow and odd
# widths (63 and 167 as the encoding's and the directional input's, 37 and
# 5 below a word and an n-tile), a k-step past a 40-wide delta, and a layer
# wider than one 256-column pass with a ragged last pass
DELTA_NARROW = [(0, 48, "gs"), (2, 40, "add_act"), (3, 24, "act"),
                (9, 48, "add"), (48, 63, "f32"), (40, 167, "none"),
                (48, 167, "add"), (40, 37, "bits"), (24, 5, "act"),
                (48, 552, "gs"), (3, 48, "bits")]


def _delta_operands(cuda, n, k, n_out, form, dtype, seed):
    """Deltas U(-1, 1), the forward matrix N(0, 1 / n_out), activations
    N(0, 1), gs U(-1, 1), wcol N(0, 1 / n_out), the ADD operand U(-1, 1);
    delta_layer's keyword arguments for ``form``."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def u(*shape):
        return (torch.rand(shape, generator=gen, device=cuda) * 2
                - 1).to(dtype)

    def g(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda)
                * scale).to(dtype)

    kw = dict(a=u(n, k), w=g(n_out, k, scale=n_out ** -0.5))
    act = g(n, n_out)
    if form in ("act", "gs", "add_act"):
        kw["act"] = act
    if form == "bits":
        kw["bits"] = pack_mask(act)
    if form == "gs":
        kw["gs"], kw["wcol"] = u(n), g(n_out, scale=n_out ** -0.5)
    if form in ("add", "add_act"):
        kw["add"] = u(n, n_out)
    kw["store"] = torch.float32 if form == "f32" else dtype
    return kw


@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("k, n_out, form", DELTA_NARROW)
def test_delta_layer_matches_plain(cuda, k, n_out, form, dtype):
    """The pass alone against its plain version within TOLS over a single
    row, a ragged second tile and a ragged 65th: the heads' narrow k_dim (0:
    the K = 1 term alone; 2, 3, 9: one zero-padded k-step), odd and narrow
    n_out (pairs of columns stored one by one), every form; its stored rows
    equal its output (or, in f32, round to it) and two launches equal bit for
    bit.  bf16 runs on the tensor cores, f32 on the CUDA cores."""
    for n in (1, 70, 4099):
        kw = _delta_operands(cuda, n, k, n_out, form, dtype, seed=n + k)
        ops.reset_launches()
        out, stored = ops.delta_layer(**kw)
        again, _ = ops.delta_layer(**kw)
        want, want_stored = ops.delta_layer_plain(**kw)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["delta_layer"] == 2
        torch.testing.assert_close(out.float(), want.float(), **TOLS[dtype])
        torch.testing.assert_close(stored.float(), want_stored.float(),
                                   **TOLS[dtype])
        assert torch.equal(out, again)
        assert torch.equal(stored.to(dtype), out)


# the delta pass's rounding gate (chip_smoke.py's DELTA_GATE_*): the 256 ->
# 256 trunk layer and the pullback into the 167-wide directional input,
# unmasked, on 131,072 seeded rows; the share of the pass's bf16 outputs off
# the pass summed in f64 and rounded may be at most the in-order f32 sum's
DELTA_GATE_SHAPES = [(256, 256), (256, 167)]
DELTA_GATE_FACTOR = 1.0


@pytest.mark.parametrize("k, n_out", DELTA_GATE_SHAPES)
def test_delta_rounding_gate(cuda, k, n_out):
    """The bf16 pass adds each k-step's tensor-core sum to an f32 sum in
    the order of k: at most as many of its outputs differ from the
    correctly rounded pass (delta_layer_f64) as of the f32 sum taken term
    by term in order (delta_layer_in_order).  A pass that chains its
    k-steps through the tensor cores' truncating accumulator reads above
    it (tools/tile_variants' dchain, PERF.md)."""
    from nerf_tpu_torch.ops import delta as delta_lib
    from nerf_tpu_torch.ops.dense import rounding_share

    kw = _delta_operands(cuda, 131_072, k, n_out, "none", torch.bfloat16,
                         seed=17)
    kw.pop("store")
    exact = delta_lib.delta_layer_f64(**kw)
    got = rounding_share(ops.delta_layer(**kw)[0], exact)
    in_order = rounding_share(delta_lib.delta_layer_in_order(**kw), exact)
    assert 0 < in_order
    assert got <= DELTA_GATE_FACTOR * in_order, (got, in_order)


def test_delta_chain_of_head_and_trunk_passes(cuda):
    """A directional backward's chain through ops.delta_layer in bf16, each
    pass on the previous pass's output from the card: the z8 head (k_dim 3,
    one zero-padded k-step on mma.sync), two masked 256 -> 256 trunk passes
    (wgmma from the TMA ring), the pullback into the 167-wide input with the
    K = 9 and K = 2 heads' pullbacks added to it (ADD), and a ragged row
    count; every pass within TOLS of its plain version on the same
    operands, and its stored rows equal its output."""
    bf16, n = torch.bfloat16, 4099
    gen = torch.Generator(device=cuda).manual_seed(5)

    def g(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda)
                * scale).to(bf16)

    a = g(n, 3)
    steps = [dict(w=g(256, 3, scale=256 ** -0.5), act=g(n, 256)),
             dict(w=g(256, 256, scale=256 ** -0.5), act=g(n, 256)),
             dict(w=g(256, 256, scale=256 ** -0.5), act=g(n, 256)),
             dict(w=g(167, 256, scale=167 ** -0.5))]
    for i, kw in enumerate(steps):
        kw = dict(kw, a=a, store=bf16)
        if i == len(steps) - 1:
            head9 = ops.delta_layer(g(n, 9), g(167, 9, scale=0.3))[0]
            kw["add"] = ops.delta_layer(g(n, 2), g(167, 2, scale=0.3),
                                        add=head9)[0]
        out, stored = ops.delta_layer(**kw)
        want, _ = ops.delta_layer_plain(**kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), want.float(), **TOLS[bf16])
        assert torch.equal(stored, out)
        a = out
