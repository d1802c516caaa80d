"""The forward layer tile on its own (nerf_tpu_torch.ops.dense): its plain
version against float64 products and against the Pallas kernels' own layer
math (``_dense``, ``_relu`` and the cast of nerf_tpu/ops/fused_mlp.py) at
the fused kernels' layer shapes, the skip form, ragged row counts and the
ReLU mask bits; the wrapper's dispatch and checks; the changes that
nerf_tpu_torch.tools.tile_variants makes to the tile's sources.  The CUDA
tile is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one thread per worker)
from nerf_tpu.ops.fused_mlp import _dense, _relu
from nerf_tpu_torch import ops
from nerf_tpu_torch.ops import dense as dense_lib
from nerf_tpu_torch.ops.dense import mask_words, pack_mask
from nerf_tpu_torch.tools import tile_variants

BF16, F32 = torch.bfloat16, torch.float32
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}
U32 = 2.0 ** -24        # f32 unit roundoff
U16 = 2.0 ** -8         # bf16 unit roundoff (8 significant bits)
N = 70                  # a ragged second tile of 64 rows

# the trunk inputs (PE of position, PE of direction, the directional input
# nb + 2C + 1) and the hidden widths of the fused kernels' layers
K_WIDTHS = [63, 27, 167, 128, 256]
# the skip layers: [x, h4] of both trunks, [bvec, enc_d] of the vanilla net
SKIPS = [(63, 256, 256), (167, 256, 256), (256, 27, 128)]


def _operands(n, ks, n_out, dtype, seed):
    """Row operands U(-1, 1) and matrices N(0, 2 / fan_in) in ``dtype``,
    one per width of ``ks``, and an N(0, 0.25) f32 bias."""
    rng = np.random.default_rng(seed)
    fan_in = sum(ks)
    acts = [torch.from_numpy(rng.uniform(-1, 1, (n, k))).to(dtype)
            for k in ks]
    ws = [torch.from_numpy(rng.normal(size=(k, n_out))
                           * np.sqrt(2.0 / fan_in)).to(dtype) for k in ks]
    b = torch.from_numpy(rng.normal(size=(n_out,)) * 0.5).to(F32)
    return acts, ws, b


def _exact(acts, ws, b):
    """float64 act sum and sum of |a| |w| over every product, plus |b|."""
    acc = sum(a.double() @ w.double() for a, w in zip(acts, ws))
    mag = sum(a.double().abs() @ w.double().abs() for a, w in zip(acts, ws))
    return acc + b.double(), mag + b.double().abs()


def _bound(acts, ws, b, dtype, relu=True):
    """(the float64 layer, the most a layer in ``dtype`` may part from it):
    the f32 sums' error, (terms + 2) u32 sum |a||w| (any order of
    summation, twice for the two dots of a skip layer), then one rounding
    to the compute dtype, u16 |v| in bf16."""
    acc, mag = _exact(acts, ws, b)
    want = torch.relu(acc) if relu else acc
    terms = sum(a.shape[1] for a in acts)
    bound = 2 * (terms + 2) * U32 * mag
    if dtype == BF16:
        bound = bound + U16 * want.abs()
    return want, bound * 1.01 + 1e-30


def _assert_within(got, want, bound):
    err = (got.double() - want.double()).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


def _assert_layer(out, acts, ws, b, relu=True):
    """out and the Pallas layer math on the same operands each within one
    rounding of the float64 layer, so within two of each other."""
    want, bound = _bound(acts, ws, b, out.dtype, relu)
    jax_out = _jax_layer(acts, ws, b, relu)
    _assert_within(out, want, bound)
    _assert_within(jax_out, want, bound)
    _assert_within(out, jax_out, 2 * bound)


def _jax_layer(acts, ws, b, relu=True):
    """The Pallas kernels' layer math: _dense of each product (the bias
    with the last, as ``_dense(x, w4a) + _dense(h4, w4b, b4)``), _relu,
    the cast to the compute dtype."""
    cd = JDT[acts[0].dtype]
    jb = jnp.asarray(b.numpy().reshape(1, -1))
    parts = [_dense(jnp.asarray(a.float().numpy()).astype(cd),
                    jnp.asarray(w.float().numpy()).astype(cd),
                    jb if i == len(acts) - 1 else None)
             for i, (a, w) in enumerate(zip(acts, ws))]
    out = sum(parts[1:], parts[0])
    out = _relu(out) if relu else out
    return torch.from_numpy(np.array(out.astype(cd).astype(jnp.float32),
                                     dtype=np.float32))


def _plain(acts, ws, b, **kw):
    a1 = acts[1] if len(acts) > 1 else None
    w1 = ws[1] if len(ws) > 1 else None
    return ops.dense_layer(acts[0], ws[0], b, a1, w1, device="cpu", **kw)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("n_out", [128, 256])
@pytest.mark.parametrize("k", K_WIDTHS)
def test_plain_layer_matches_float64_and_jax(k, n_out, dtype):
    """dense_layer on the CPU within one rounding of the float64 layer, and
    so is the Pallas kernels' own layer math on the same operands; the two
    differ only where an f32 sum taken in another order rounds to the
    neighbouring bf16 value."""
    acts, ws, b = _operands(N, [k], n_out, dtype, seed=k * 1000 + n_out)
    out, stored, bits = _plain(acts, ws, b)
    assert out.shape == (N, n_out) and out.dtype == dtype
    assert stored is None and bits is None
    _assert_layer(out, acts, ws, b)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("k0, k1, n_out", SKIPS)
def test_plain_skip_layer_matches_float64_and_jax(k0, k1, n_out, dtype):
    """The skip form a0 @ w0 + a1 @ w1 + b: one f32 accumulator here, two
    f32 dots added in the Pallas kernels; both within one rounding of the
    float64 layer."""
    acts, ws, b = _operands(N, [k0, k1], n_out, dtype, seed=k0 + k1)
    out, _, _ = _plain(acts, ws, b)
    _assert_layer(out, acts, ws, b)


def test_plain_layer_without_relu():
    """The vanilla net's bottleneck layer (relu=False) keeps its negative
    values."""
    acts, ws, b = _operands(N, [256], 256, BF16, seed=5)
    out, _, _ = _plain(acts, ws, b, relu=False)
    assert bool((out < 0).any())
    _assert_layer(out, acts, ws, b, relu=False)


@pytest.mark.parametrize("n", [1, 70, 4099])
def test_plain_ragged_rows_store_and_mask(n):
    """A single row, a ragged second tile and a ragged 65th: the stored rows
    equal the output, and the mask bits are out > 0, bit c % 32 of word
    c // 32."""
    acts, ws, b = _operands(n, [63], 256, BF16, seed=n)
    out, stored, bits = _plain(acts, ws, b, store=True, mask=True)
    assert torch.equal(stored, out)
    assert bits.shape == (n, 8) and bits.dtype == torch.int32
    on = (out > 0).numpy()
    words = np.packbits(on.reshape(n, 8, 32)[:, :, ::-1], axis=-1,
                        bitorder="big").view(">u4")[..., 0]
    assert np.array_equal(bits.numpy().view(np.uint32), words)
    _assert_within(out, *_bound(acts, ws, b, BF16))


@pytest.mark.parametrize("n_out", [24, 40, 48, 80, 256])
def test_pack_mask_widths(n_out):
    """The bits of the narrow widths of the card tests: the last word holds
    the leftover columns in its low bits and zeros above."""
    rng = np.random.default_rng(n_out)
    out = torch.from_numpy(rng.normal(size=(5, n_out))).to(BF16)
    bits = pack_mask(out).numpy().view(np.uint32)
    assert bits.shape == (5, mask_words(n_out))
    for c in range(n_out):
        assert np.array_equal((bits[:, c // 32] >> (c % 32)) & 1,
                              (out[:, c] > 0).numpy().astype(np.uint32))
    if n_out % 32:
        assert not (bits[:, -1] >> (n_out % 32)).any()


def test_wrapper_runs_on_the_card_unless_the_cpu_is_asked_for():
    """Without ``device="cpu"`` the wrapper asks for a card: here there is
    none, so it raises rather than running the plain version quietly."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    acts, ws, b = _operands(4, [63], 128, BF16, seed=0)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ops.dense_layer(acts[0], ws[0], b)


@pytest.mark.parametrize("n_out", [4, 12, 250])
def test_wrapper_rejects_widths_that_are_not_multiples_of_8(n_out):
    acts, ws, b = _operands(4, [63], n_out, BF16, seed=n_out)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.dense_layer(acts[0], ws[0], b, device="cpu")


def test_wrapper_rejects_bad_operands():
    acts, ws, b = _operands(4, [63, 27], 128, BF16, seed=1)
    with pytest.raises(ValueError, match="come together"):
        ops.dense_layer(acts[0], ws[0], b, acts[1], device="cpu")
    with pytest.raises(ValueError, match="w0 must be"):
        ops.dense_layer(acts[0], ws[1], b, device="cpu")
    with pytest.raises(ValueError, match="b must be"):
        ops.dense_layer(acts[0], ws[0], b.to(BF16), device="cpu")
    with pytest.raises(ValueError, match="a1 must be"):
        ops.dense_layer(acts[0], ws[0], b, acts[1].float(), ws[1],
                        device="cpu")


def test_cpu_calls_count_no_launch():
    """The plain version on the CPU is no launch of the kernel."""
    acts, ws, b = _operands(N, [63, 256], 256, BF16, seed=2)
    ops.reset_launches()
    _plain(acts, ws, b, store=True, mask=True)
    assert ops.LAUNCHES["dense_layer"] == 0


def test_in_order_sum_is_the_sequential_f32_sum():
    """dense_layer_in_order (the rounding gate's yardstick on the card) adds
    the products to an f32 sum one k at a time, a0's columns then a1's, as
    a numpy loop in float32 does; then the bias, ReLU and cast."""
    acts, ws, b = _operands(5, [7, 9], 8, BF16, seed=3)
    got = dense_lib.dense_layer_in_order(acts[0], ws[0], b, acts[1], ws[1])
    a = np.concatenate([x.float().numpy() for x in acts], 1)
    w = np.concatenate([x.float().numpy() for x in ws], 0)
    acc = np.zeros((5, 8), np.float32)
    for k in range(a.shape[1]):
        acc = acc + a[:, k:k + 1] * w[k:k + 1]
    want = torch.relu(torch.from_numpy(acc + b.numpy())).to(BF16)
    assert acc.dtype == np.float32
    assert torch.equal(got, want)


def test_rounding_share_on_a_hand_built_layer():
    """Column 0 sums 1, 2^-8, 2^-24, 2^-24 (every other column 1 alone).
    Exactly it is 1 + 2^-8 + 2^-23, which rounds up to the bf16 value
    1 + 2^-7; in order in f32 each 2^-24 is a tie that rounds back to 1 +
    2^-8, which rounds to even, 1.  So the in-order sum differs from the
    f64 layer in column 0 alone: a share of 1/8 of the outputs."""
    a0 = torch.ones((2, 4), dtype=BF16)
    w0 = torch.zeros((4, 8), dtype=F32)
    w0[0] = 1.0
    w0[1:, 0] = torch.tensor([2.0 ** -8, 2.0 ** -24, 2.0 ** -24])
    w0, b = w0.to(BF16), torch.zeros(8)
    exact = dense_lib.dense_layer_f64(a0, w0, b)
    in_order = dense_lib.dense_layer_in_order(a0, w0, b)
    assert exact[:, 0].float().tolist() == [1 + 2.0 ** -7] * 2
    assert in_order[:, 0].float().tolist() == [1.0] * 2
    assert torch.equal(exact[:, 1:], in_order[:, 1:])
    assert dense_lib.rounding_share(in_order, exact) == 1 / 8
    assert dense_lib.rounding_share(exact, exact) == 0.0


def test_map_encode_timer_takes_bf16_card_matrices_only():
    """ops.dense.map_encode_us times the host's tensor-map encoding of a
    bf16 weight on the card; it refuses what no kernel reads as a ring's
    weight before it loads the library."""
    for w in (torch.zeros((16, 8), dtype=BF16), torch.zeros((16, 8)),
              torch.zeros((16, 8), dtype=BF16).t()):
        with pytest.raises(ValueError, match="bf16 CUDA"):
            dense_lib.map_encode_us(w)


@pytest.mark.parametrize("name", list(tile_variants.VARIANTS))
def test_tile_variants_apply_to_the_shipped_sources(name, tmp_path):
    """Each design alternative that nerf_tpu_torch.tools.tile_variants
    measures on the card still finds the text it changes exactly once in
    the shipped csrc/mlp_tile.cuh and csrc/dense.cu, or for the weight-grad
    pass's variants in csrc/wgrad.cuh alone and for the persistent frame's
    in its two files alone, csrc/spa_frame.cuh and csrc/dir_frame.cuh (the
    tool copies the package and patches the copy), and changes something
    unless it is the shipped code (shipped, and wgrad and frame: the
    shipped pass or frame read alone)."""
    src = tile_variants.PACKAGE / "ops" / "csrc"
    root = tmp_path / "nerf_tpu_torch"
    shutil.copytree(src, root / "ops" / "csrc")
    before = {p.name: p.read_text() for p in src.iterdir()}
    tile_variants.patched_sources(name, root)
    after = {p.name: p.read_text() for p in (root / "ops" / "csrc").iterdir()}
    changed = [n for n in before if before[n] != after[n]]
    assert bool(changed) == (name not in ("shipped", "wgrad", "frame"))
    assert set(changed) <= ({"wgrad.cuh"}
                            if name in tile_variants.WGRAD_VARIANTS
                            else {"spa_frame.cuh", "dir_frame.cuh"}
                            if name in tile_variants.FRAME_VARIANTS
                            else {"mlp_tile.cuh", "dense.cu"})


def test_tile_variants_refuse_a_change_that_no_longer_applies(tmp_path):
    root = tmp_path / "nerf_tpu_torch"
    shutil.copytree(tile_variants.PACKAGE / "ops" / "csrc",
                    root / "ops" / "csrc")
    tile_variants.patched_sources("ring4", root)
    with pytest.raises(ValueError, match="0 times"):
        tile_variants.patched_sources("ring4", root)
