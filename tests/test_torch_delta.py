"""The backwards' delta pass on its own (nerf_tpu_torch.ops.delta): its plain
version against float64 products and against the Pallas backwards' own
chain-rule math (``_dwt`` and ``jnp.where(act > 0, ...).astype(cd)`` of
nerf_tpu/ops/fused_mlp.py) at every (k_dim, n_out) and form of the fused
kernels' delta passes, ragged row counts, the ADD, gs wcol^T, bit-mask and
f32-store forms; the wrapper's dispatch and checks.  The CUDA pass is held
against the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (one thread per worker)
from nerf_tpu.ops.fused_mlp import _dwt
from nerf_tpu_torch import ops
from nerf_tpu_torch.ops import delta as delta_lib
from nerf_tpu_torch.ops.dense import mask_words, pack_mask

BF16, F32 = torch.bfloat16, torch.float32
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}
U32 = 2.0 ** -24        # f32 unit roundoff
U16 = 2.0 ** -8         # bf16 unit roundoff (8 significant bits)
N = 70                  # a ragged second tile of 64 rows

# (k_dim, n_out, form) of every delta pass of the main paths: the vanilla
# dr1, dbvec (f32 rows), dz7 (the sigma term) and trunk layers; the
# proposal's dh4 (the K = 1 term alone); Ref-NeRF's d(inter) as three
# pullbacks summed, the density gradient's first layer and trunk with
# stored activations or mask bits, the directional head and the two
# pullbacks into its 167-wide input; the density gradient's 63-wide pullback
# into the encoding takes the f32 form's product
SHAPES = [(3, 128, "act"), (128, 256, "f32"), (256, 256, "gs"),
          (256, 256, "act"), (0, 256, "gs"), (2, 256, "none"),
          (9, 256, "add"), (128, 256, "add_act"), (2, 256, "act"),
          (2, 256, "bits"), (256, 256, "bits"), (256, 63, "f32"),
          (3, 256, "act"), (256, 167, "none"), (256, 167, "add"),
          (2, 256, "add_act")]


def _operands(n, k, n_out, form, dtype, seed):
    """Deltas U(-1, 1) (n, k), the forward matrix N(0, 1 / n_out) (n_out,
    k), activations N(0, 1) (about half of them masked), gs U(-1, 1), wcol
    N(0, 1 / n_out), the ADD operand U(-1, 1); as keyword arguments of
    delta_layer for ``form``."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.asarray(x)).to(dtype)

    kw = dict(a=t(rng.uniform(-1, 1, (n, k))),
              w=t(rng.normal(size=(n_out, k)) / np.sqrt(n_out)))
    act = t(rng.normal(size=(n, n_out)))
    if form in ("act", "gs", "add_act"):
        kw["act"] = act
    if form == "bits":
        kw["bits"] = pack_mask(act)
    if form == "gs":
        kw["gs"] = t(rng.uniform(-1, 1, (n,)))
        kw["wcol"] = t(rng.normal(size=(n_out,)) / np.sqrt(n_out))
    if form in ("add", "add_act"):
        kw["add"] = t(rng.uniform(-1, 1, (n, n_out)))
    if form == "f32":
        kw["store"] = F32
    return kw, act


def _exact(kw, act):
    """The float64 pass before its final rounding, the magnitude its f32
    sums may be off by (any order: (terms + 2) u32 sum |a||w|), and the
    mask."""
    a, w = kw["a"].double(), kw["w"].double()
    acc, mag = a @ w.t(), a.abs() @ w.abs().t()
    terms = a.shape[1]
    if "gs" in kw:
        term = kw["gs"].double().reshape(-1, 1) * kw["wcol"].double()
        acc, mag, terms = acc + term, mag + term.abs(), terms + 1
    bound = (terms + 2) * U32 * mag
    on = (act > 0) if any(m in kw for m in ("act", "bits")) else None
    return acc, bound, on


def _bound(kw, act, dtype):
    """(the float64 pass, the most a pass in ``dtype`` may part from it):
    the f32 sums' error, then each rounding: with ADD the product's to the
    compute dtype (u16 of it in bf16) and the f32 add's; then the output's
    (u16 in bf16)."""
    acc, bound, on = _exact(kw, act)
    if "add" in kw:
        if dtype == BF16:
            bound = bound + U16 * (acc.abs() + bound)
        acc = acc + kw["add"].double()
        bound = bound + U32 * (acc.abs() + bound)
    if dtype == BF16:
        bound = bound + U16 * (acc.abs() + bound)
    if on is not None:
        acc = torch.where(on, acc, torch.zeros_like(acc))
        bound = torch.where(on, bound, torch.zeros_like(bound))
    return acc, bound * 1.01 + 1e-30


def _assert_within(got, want, bound):
    err = (got.double() - want.double()).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


def _jax_pass(kw, act):
    """The Pallas backwards' math on the same operands: ``_dwt`` (the K = 1
    term as the vanilla dz7's dot_general of gsig (1, T) with wsig), the
    ADD as ref_fused.py's ``dwt(...).astype(cd) + prev``, then
    ``jnp.where(act > 0, ., 0).astype(cd)``."""
    cd = JDT[kw["a"].dtype]

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(cd)

    v = _dwt(j(kw["a"]), j(kw["w"]))
    if "gs" in kw:
        v = v + jax.lax.dot_general(
            j(kw["gs"]).reshape(1, -1), j(kw["wcol"]).reshape(-1, 1),
            (((0,), (1,)), ((), ())), preferred_element_type=jnp.float32)
    if "add" in kw:
        v = (v.astype(cd) + j(kw["add"])).astype(jnp.float32)
    if "act" in kw or "bits" in kw:
        v = jnp.where(j(act).astype(jnp.float32) > 0, v, 0.0)
    return torch.from_numpy(np.array(v.astype(cd).astype(jnp.float32),
                                     dtype=np.float32))


def _plain(kw):
    return ops.delta_layer(device="cpu", **kw)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("k, n_out, form", SHAPES)
def test_plain_pass_matches_float64_and_jax(k, n_out, form, dtype):
    """delta_layer on the CPU within its roundings of the float64 pass at
    every delta shape and form of the fused backwards, and so is the Pallas
    backwards' own math on the same operands; the two differ only where an
    f32 sum taken in another order rounds to the neighbouring bf16 value."""
    kw, act = _operands(N, k, n_out, form, dtype, seed=k * 1000 + n_out)
    out, stored = _plain(kw)
    assert out.shape == (N, n_out) and out.dtype == dtype
    want, bound = _bound(kw, act, dtype)
    jax_out = _jax_pass(kw, act)
    _assert_within(out, want, bound)
    _assert_within(jax_out, want, bound)
    _assert_within(out, jax_out, 2 * bound)
    if form == "f32":
        assert stored.dtype == F32
        _assert_within(stored, *_bound(kw, act, F32))
        assert torch.equal(stored.to(dtype), out)
    else:
        assert stored is None


@pytest.mark.parametrize("n", [1, 70, 4099])
@pytest.mark.parametrize("form", ["act", "bits", "gs", "add_act"])
def test_plain_ragged_rows_and_mask_forms(n, form):
    """A single row, a ragged second tile and a ragged 65th: the bits and the
    stored activations mask alike, masked values are exact zeros, and a
    store in the compute dtype equals the output."""
    kw, act = _operands(n, 256, 256, form, BF16, seed=n)
    out, stored = _plain(dict(kw, store=BF16))
    assert torch.equal(stored, out)
    assert bool((out[act <= 0] == 0).all())
    _assert_within(out, *_bound(kw, act, BF16))
    if form == "bits":
        other, _ = _plain(dict(kw, bits=None, act=act))
        assert torch.equal(other, out)


def test_plain_add_rounds_the_product_first():
    """ADD rounds the product to the compute dtype before it adds: in bf16
    the product 1 + 2^-8 rounds (to even) to 1, and 1 + 2^-8 again to 1;
    summed unrounded, 1 + 2^-7 would be exact.  In f32 nothing rounds."""
    a = torch.tensor([[1.0, 2.0 ** -8]])
    w = torch.tensor([[1.0, 1.0]])
    add = torch.tensor([[2.0 ** -8]])
    out, _ = _plain(dict(a=a.to(BF16), w=w.to(BF16), add=add.to(BF16)))
    assert float(out) == 1.0
    out, _ = _plain(dict(a=a, w=w, add=add))
    assert float(out) == 1.0 + 2.0 ** -7


def test_plain_gs_term_alone_is_an_outer_product():
    """k_dim = 0 (the proposal's dh4): the product is empty and the pass is
    mask(gs wcol^T)."""
    kw, act = _operands(N, 0, 256, "gs", F32, seed=3)
    out, _ = _plain(kw)
    want = torch.where(act > 0, kw["gs"].reshape(-1, 1) * kw["wcol"], 0.0)
    assert torch.equal(out, want)


@pytest.mark.parametrize("width", [63, 128, 167, 256])
def test_unpack_mask_inverts_pack_mask(width):
    rng = np.random.default_rng(width)
    act = torch.from_numpy(rng.normal(size=(9, width))).to(BF16)
    on = delta_lib.unpack_mask(pack_mask(act), width)
    assert on.shape == (9, width) and torch.equal(on, act > 0)


def test_wrapper_runs_on_the_card_unless_the_cpu_is_asked_for():
    """Without ``device="cpu"`` the wrapper asks for a card: here there is
    none, so it raises rather than running the plain version quietly."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    kw, _ = _operands(4, 256, 256, "act", BF16, seed=0)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ops.delta_layer(**kw)


def test_wrapper_rejects_bad_operands():
    kw, act = _operands(4, 9, 256, "gs", BF16, seed=1)
    with pytest.raises(ValueError, match="come together"):
        ops.delta_layer(kw["a"], kw["w"], gs=kw["gs"], device="cpu")
    with pytest.raises(ValueError, match="w must be"):
        ops.delta_layer(kw["a"], kw["w"].t().contiguous(), device="cpu")
    with pytest.raises(ValueError, match="give one"):
        ops.delta_layer(kw["a"], kw["w"], act=act, bits=pack_mask(act),
                        device="cpu")
    with pytest.raises(ValueError, match="act must be"):
        ops.delta_layer(kw["a"], kw["w"], act=act.float(), device="cpu")
    with pytest.raises(ValueError, match="bits must be"):
        ops.delta_layer(kw["a"], kw["w"], bits=pack_mask(act)[:, :4],
                        device="cpu")
    with pytest.raises(ValueError, match="add must be"):
        ops.delta_layer(kw["a"], kw["w"], add=act[:3], device="cpu")
    with pytest.raises(ValueError, match="store must be"):
        ops.delta_layer(kw["a"], kw["w"], store=torch.float16, device="cpu")


@pytest.mark.parametrize("k, n_out", [(1024, 1024), (2048, 128)])
def test_wrapper_rejects_widths_beyond_a_block(k, n_out):
    """A block holds its rows of a and of the output in shared memory: the
    wrapper rejects widths whose block would not fit an H100's 227 KB."""
    kw, _ = _operands(2, k, n_out, "none", BF16, seed=k)
    assert delta_lib.block_bytes(k, n_out, BF16) > delta_lib.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        ops.delta_layer(device="cpu", **kw)


def test_block_bytes_of_the_main_path_shapes_fit():
    for k, n_out, form in SHAPES:
        for dtype in (BF16, F32):
            assert delta_lib.block_bytes(k, n_out, dtype, form == "bits") \
                <= delta_lib.SMEM_LIMIT
    assert mask_words(167) == 6


def test_cpu_calls_count_no_launch():
    """The plain version on the CPU is no launch of the kernel."""
    kw, _ = _operands(N, 256, 256, "gs", BF16, seed=2)
    ops.reset_launches()
    _plain(kw)
    assert ops.LAUNCHES["delta_layer"] == 0


def test_kernel_ab_times_kernels_that_chip_smoke_checks():
    """kernel_ab.py times each kernel with a checkout's own chip_smoke.py:
    every kernel it times is one whose main-path case it builds (or the
    dissection, which the tool times through bench_ref_kernels), and the
    code of a turn compiles."""
    import chip_smoke
    import kernel_ab

    assert set(kernel_ab.DELTA_PASS_KERNELS) <= set(chip_smoke.KERNELS)
    assert "ref_dir_bwd_dissect" in kernel_ab.DELTA_PASS_KERNELS
    compile(kernel_ab.TURN, "turn", "exec")


@pytest.mark.parametrize("form", ["none", "act", "bits", "gs", "add",
                                  "add_act"])
def test_f64_pass_is_the_numpy_float64_pass_rounded(form):
    """delta_layer_f64 (the rounding gate's exact pass on the card) is the
    float64 product of the upcast operands (and the K = 1 term in float64),
    rounded to f32, then ADD, mask and cast as the plain version takes
    them: the same as numpy's float64 pass finished that way."""
    kw, act = _operands(N, 40, 24, form, BF16, seed=7)
    got = delta_lib.delta_layer_f64(**kw)
    a = kw["a"].double().numpy()
    w = kw["w"].double().numpy()
    acc = a @ w.T
    if "gs" in kw:
        acc = acc + (kw["gs"].double().numpy()[:, None]
                     * kw["wcol"].double().numpy()[None, :])
    acc = torch.from_numpy(acc.astype(np.float32))
    if "add" in kw:
        acc = acc.to(BF16).float() + kw["add"].float()
    if "act" in kw or "bits" in kw:
        acc = torch.where(act.float() > 0, acc, 0.0)
    assert got.dtype == BF16 and got.shape == (N, 24)
    assert torch.equal(got, acc.to(BF16))


@pytest.mark.parametrize("form", ["none", "act", "gs", "add_act"])
def test_in_order_pass_is_the_sequential_f32_sum(form):
    """delta_layer_in_order adds each k term to an f32 sum in the order of
    k, as a numpy loop in float32 does; then the K = 1 term, ADD, mask and
    cast as the plain version takes them."""
    kw, act = _operands(5, 11, 9, form, BF16, seed=8)
    got = delta_lib.delta_layer_in_order(**kw)
    a, w = kw["a"].float().numpy(), kw["w"].float().numpy()
    acc = np.zeros((5, 9), np.float32)
    for k in range(a.shape[1]):
        acc = acc + a[:, k:k + 1] * w[:, k][None, :]
    assert acc.dtype == np.float32
    acc = torch.from_numpy(acc)
    if "gs" in kw:
        acc = acc + kw["gs"].float().reshape(-1, 1) * kw["wcol"].float()
    if "add" in kw:
        acc = acc.to(BF16).float() + kw["add"].float()
    if "act" in kw:
        acc = torch.where(act.float() > 0, acc, 0.0)
    assert torch.equal(got, acc.to(BF16))


def test_delta_rounding_share_on_a_hand_built_pass():
    """Output column 0 sums 1, 2^-8, 2^-24, 2^-24 over k (every other
    column 1 alone).  Exactly it is 1 + 2^-8 + 2^-23, which rounds up to
    the bf16 value 1 + 2^-7; in order in f32 each 2^-24 is a tie that
    rounds back to 1 + 2^-8, which rounds to even, 1.  So the in-order
    pass differs from the f64 pass in column 0 alone, a share of 1/8, and
    the plain version (one f32 product) is held to the same yardstick."""
    from nerf_tpu_torch.ops.dense import rounding_share

    a = torch.ones((2, 4), dtype=BF16)
    w = torch.zeros((8, 4), dtype=F32)
    w[:, 0] = 1.0
    w[0, 1:] = torch.tensor([2.0 ** -8, 2.0 ** -24, 2.0 ** -24])
    w = w.to(BF16)
    exact = delta_lib.delta_layer_f64(a, w)
    in_order = delta_lib.delta_layer_in_order(a, w)
    assert exact[:, 0].float().tolist() == [1 + 2.0 ** -7] * 2
    assert in_order[:, 0].float().tolist() == [1.0] * 2
    assert torch.equal(exact[:, 1:], in_order[:, 1:])
    assert rounding_share(in_order, exact) == 1 / 8
    assert rounding_share(exact, exact) == 0.0
    # a mask that zeroes column 0 hides the difference
    act = torch.ones((2, 8), dtype=BF16)
    act[:, 0] = -1
    assert rounding_share(delta_lib.delta_layer_in_order(a, w, act=act),
                          delta_lib.delta_layer_f64(a, w, act=act)) == 0.0
