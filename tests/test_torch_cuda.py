"""The CUDA kernels of nerf_tpu_torch against their plain versions, and the
eval path through them against the nn.Module path, on the card.

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Every test skips without a CUDA device.  This file imports no JAX, so with
``--noconftest`` (tests/conftest.py sets JAX up) it runs on a machine that
has PyTorch and a card only.
"""

import numpy as np
import pytest
import torch

from nerf_tpu_torch import ops
from nerf_tpu_torch.models import ProposalNetwork, VanillaNeRF
from nerf_tpu_torch.train.config import PipelineConfig
from nerf_tpu_torch.train.pipeline import make_models, render_rays_eval

pytestmark = pytest.mark.cuda

# bf16: both sides round every layer to bf16 but sum in another order, so a
# value at a rounding boundary may differ by one bf16 ulp and carry on;
# f32: summation order alone.
TOLS = {torch.float32: dict(rtol=1e-4, atol=1e-5),
        torch.bfloat16: dict(rtol=2e-2, atol=1e-2)}


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
