"""Time the fused kernels of two checkouts in turns on one card.

    python3 kernel_ab.py --other DIR [--steps] [--tile | --spa | --dir |
                                               --vanilla | --prop |
                                               --spa_bwd] > ab.json

DIR is another checkout of this repository (for example ``git archive`` of
an earlier commit unpacked under ``build/``).  Each turn is one process
started in a checkout's root: it builds that checkout's kernels, then times
the delta pass alone (``ops.delta_layer`` at three delta shapes of a
Ref-NeRF step's 196,608 rows, ``DELTA_AB_SHAPES``, with ``torch.mm`` of the
same operands beside it), the weight-grad pass alone (``ops.wgrad_reduce``
at the five job lists of one default step's backwards,
``chip_smoke.wgrad_lists``, walked as the backwards walk them, timed by
``chip_smoke.cuda_device_ms``, with one ``torch.mm(A^T, delta)`` a job
beside it), each kernel whose delta pass runs
``delta_tile``, bf16 and f32, with that checkout's own ``chip_smoke.py``
(``kernel_case``: the main-path shapes and seeded operands of its kernel
checks; ``cuda_ms``: the median of 20 CUDA-event timings after a warm-up),
and ``ref_dir_bwd_dissect`` with its own
``nerf_tpu_torch.tools.bench_ref_kernels --dissect`` (the "full" mode), and
the trainer's default step of each model (``chip_smoke.profile_trainer``:
ms a step, host issue ms, device ms, busy share); with ptxas's registers
and spills of every bf16 kernel that runs the tile or the delta pass, from
the turn's own build.  The turns run other, this, this, other, so that a
drift of the card's clocks shows as a difference between the two turns of
one checkout.  With
``--steps`` each turn also takes ``chip_smoke.step_check``'s readings of
the six f32 training steps (both models; residual, recompute and proposal
residual forms): the kernels' loss and their grads' errors against the
nn.Module path, which two checkouts whose f32 kernels are the same code
read to the last digit.

With ``--tile`` the turns time instead what runs the forward layer tile
(``dense_tile``), in bf16: the layer alone (``ops.dense_layer``, every
layer shape of ``chip_smoke.DENSE_SHAPES`` at an eval chunk's 786,432 rows,
with ``torch.addmm`` beside it), the forwards and the backwards that
rebuild their forward (``TILE_KERNELS``, ``ref_dir_fwd_dissect``'s "full"
stage), a warm 400x400 frame of each model (``chip_smoke.profile_frame``:
wall seconds, device ms, busy share) and the trainer's default step of
each model (``chip_smoke.profile_trainer``: ms a step, host issue ms,
device ms, busy share); ptxas's registers and spills of each kernel that
runs the tile, from the turn's own build; and, where the checkout has it,
the host's microseconds for one encoding of a 256 x 256 weight's tensor
map (``ops.dense.map_encode_us``), which every bf16 launch of a tile
kernel pays once for each weight that its tiles read.

With ``--spa`` the turns time the Ref-NeRF spatial net's fused forwards in
bf16 (``SPA_KERNELS``: ``ref_spa_fwd`` at an eval chunk's 786,432 points,
``ref_spa_fwd_res`` and ``ref_spa_fwd_grad`` at a default step's 196,608,
``chip_smoke.kernel_case``'s operands, ``cuda_ms``; and the sha1 of each
kernel's outputs, which two checkouts whose kernels sum alike read alike),
a warm 400x400
Ref-NeRF frame (``chip_smoke.profile_frame``: wall seconds, device ms, busy
share) and the trainer's default ``-t`` step (``profile_trainer``: ms a
step, host issue ms, device ms, busy share, rays/s), and beside it the
vanilla and ``-m`` steps, which do not run the spatial net, as a reading
of the host's pace in each turn, with ptxas's registers
and spills of every bf16 kernel that runs the tile, the delta pass or the
spatial frame, from the turn's own build.  With ``--dir`` the turns
take the same readings of the directional net's fused forwards in bf16
(``DIR_KERNELS``: ``ref_dir_fwd`` at an eval chunk's 786,432 points,
``ref_dir_fwd_res`` at a default step's 196,608, and the sha1 of each
one's outputs, and of a second case of each with sRGB on), with the same
frame and steps beside them.  With ``--vanilla`` the turns time the
vanilla net's two fused forwards in bf16 (``VANILLA_KERNELS``:
``vanilla_mlp_fwd`` at an eval chunk's 524,288 points,
``vanilla_mlp_fwd_res`` at a default step's 131,072, on the vanilla path's
encodings and on the ``-m`` path's IPE encodings at the same points, each
with the sha1 of its outputs), a warm 400x400 vanilla and ``-m`` frame
(wall seconds, device ms, busy share) and the trainer's default vanilla,
``-m`` and ``-t`` steps, with ptxas's registers and spills of every bf16
kernel that runs the tile, the delta pass or the frame.  With ``--prop``
the turns time the proposal net's two fused forwards in bf16
(``PROP_KERNELS``: ``prop_mlp_fwd`` at an eval chunk's 262,144 points,
``prop_mlp_fwd_res`` at a default step's 65,536, ``kernel_case``'s
operands, ``cuda_ms``, each with the sha1 of its density and stored
activations), a warm 400x400 vanilla and Ref-NeRF frame (wall seconds,
device ms, busy share) and the trainer's default vanilla and ``-t`` steps,
with ptxas's registers and spills; and each form's width scan
(``PROP_WIDTHS``, 300 points a width: whether it ran and, where the
checkout reports one, the body it ran), which reads the widest that a
checkout runs.  With ``--spa_bwd`` the turns time the Ref-NeRF spatial
net's two fused backwards in bf16 (``SPA_BWD_KERNELS``: ``ref_spa_bwd``
and ``ref_spa_bwd_recompute`` at a default step's 196,608 points,
``kernel_case``'s operands, ``cuda_ms``), each with the sha1 of its 23
grads and, for ``ref_spa_bwd``, of the 11 deltas its C entry writes (the
tuple of 11 tensors that the wrapper hands it), the device time of each of
its launches by kernel (torch.profiler over 5 calls: the delta kernel, the
weight-grad pass, the reduction), the host's time to issue one call (the
median of 11, each from an idle card), each form's width scan
(``SPA_BWD_WIDTHS``, H = O, 300 points a width: whether it ran, the body
where the checkout reports one, the grads finite), and the trainer's
default ``-t`` step and the ``-t --ref_kernels hybrid`` step (ms a step,
host issue ms, device ms, busy share, rays/s, the top device kernels a
step).  Prints one JSON object: each turn's readings by
"kernel/dtype" (and its step readings), and the card's name and power
limit.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the kernels whose delta pass runs delta_tile (PERF.md's rows 2, 4, 5, 6,
# 8 and 9)
DELTA_PASS_KERNELS = ("vanilla_mlp_bwd", "vanilla_mlp_bwd_recompute",
                      "prop_mlp_bwd", "prop_mlp_bwd_res", "ref_spa_fwd_res",
                      "ref_spa_fwd_grad", "ref_spa_bwd",
                      "ref_spa_bwd_recompute", "ref_dir_bwd",
                      "ref_dir_bwd_recompute", "ref_dir_bwd_dissect")

# the kernels that run the forward layer tile: the forwards (PERF.md's rows
# 1, 3, 5, 7 and 10) and the backwards that rebuild their forward
TILE_KERNELS = ("vanilla_mlp_fwd", "vanilla_mlp_fwd_res", "prop_mlp_fwd",
                "prop_mlp_fwd_res", "ref_spa_fwd", "ref_spa_fwd_res",
                "ref_spa_fwd_grad", "ref_dir_fwd", "ref_dir_fwd_res",
                "ref_dir_fwd_dissect", "vanilla_mlp_bwd_recompute",
                "prop_mlp_bwd", "ref_spa_bwd_recompute",
                "ref_dir_bwd_recompute")

# the Ref-NeRF spatial net's fused forwards (PERF.md's row 5)
SPA_KERNELS = ("ref_spa_fwd", "ref_spa_fwd_res", "ref_spa_fwd_grad")
# the Ref-NeRF directional net's fused forwards (PERF.md's row 7)
DIR_KERNELS = ("ref_dir_fwd", "ref_dir_fwd_res")
# the vanilla net's fused forwards (PERF.md's row 1)
VANILLA_KERNELS = ("vanilla_mlp_fwd", "vanilla_mlp_fwd_res")
# the proposal net's fused forwards (PERF.md's row 3), and the widths of
# their scan in each turn
PROP_KERNELS = ("prop_mlp_fwd", "prop_mlp_fwd_res")
PROP_WIDTHS = tuple(range(640, 800, 8))
# the Ref-NeRF spatial net's fused backwards (PERF.md's row 6), and the
# widths of their scan in each turn
SPA_BWD_KERNELS = ("ref_spa_bwd", "ref_spa_bwd_recompute")
SPA_BWD_WIDTHS = tuple(range(472, 800, 8))

# one turn of --spa_bwd, run with the checkout's root as the working
# directory
SPA_BWD_TURN = r"""
import hashlib, json, sys, tempfile, time
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from nerf_tpu_torch import ops
from nerf_tpu_torch.ops import build, ref_fused
names, widths = json.loads(sys.argv[1]), json.loads(sys.argv[2])
reports = build.build()
out = {"ptxas": {k: v for k, v in cs.tile_ptxas(reports).items()
                 if "bfloat16" in k}}
gen = torch.Generator(device="cuda").manual_seed(0)
bf16 = torch.bfloat16


def digest(t, h):
    if isinstance(t, (tuple, list)):
        for u in t:
            digest(u, h)
    else:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h


def with_deltas(call):
    # (what call returns, the 11 tensors that the wrapper handed its C
    # entry as the deltas: d1 .. d8, g_rt, g_nct, g_bn)
    seen, plain = [], ref_fused.pointers

    def spy(ts):
        seen.append(tuple(ts))
        return plain(ts)

    ref_fused.pointers = spy
    try:
        res = call()
        torch.cuda.synchronize()
    finally:
        ref_fused.pointers = plain
    return res, next(t for t in seen if len(t) == 11)


def body(name, before):
    after = getattr(ops, "BODIES", {}).get(name, {})
    ran = [b for b, c in after.items() if c != before.get(b, 0)]
    return ran[0] if ran else "ran"


for name in names:
    args, kernel = cs.kernel_case(name, bf16, gen)[:2]
    out[name + "/bf16"] = cs.cuda_ms(lambda: kernel(*args), 20)
    host = []
    for _ in range(11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernel(*args)
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    out[name + "/host_issue_ms"] = sorted(host)[len(host) // 2]
    if name == "ref_spa_bwd":
        grads, deltas = with_deltas(lambda: kernel(*args))
        out[name + "/sha1_deltas"] = digest(deltas,
                                            hashlib.sha1()).hexdigest()
        del deltas
    else:
        grads = kernel(*args)
    out[name + "/sha1"] = digest(grads, hashlib.sha1()).hexdigest()
    del grads
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            kernel(*args)
        torch.cuda.synchronize()
    out[name + "/device_ms"] = [[k, v / 5]
                                for k, v in cs.device_times(prof, 8)[1]]
    del args, prof
    torch.cuda.empty_cache()
    scan = {}
    for w in widths:
        ws = cs.random_weights(cs.ref_spa_shapes(h=w, o=w), gen, bf16,
                               gain=cs.REF_GAIN)
        x = cs.ref_points(gen, bf16, 300)[1]
        g = torch.randn((300, ref_fused.HEAD_FIXED + 128), generator=gen,
                        device="cuda")
        before = dict(getattr(ops, "BODIES", {}).get(name, {}))
        try:
            if name == "ref_spa_bwd":
                acts = tuple(torch.relu(torch.randn(
                    (300, w), generator=gen, device="cuda")).to(bf16)
                    for _ in range(8))
                grads = ops.ref_spa_bwd(ws, x, g, acts)
            else:
                grads = ops.ref_spa_bwd_recompute(ws, x, g)
            torch.cuda.synchronize()
        except RuntimeError:
            scan[w] = None
            continue
        scan[w] = [body(name, before),
                   all(bool(torch.isfinite(t).all()) for t in grads)]
        del ws, x, g, grads
    out[name + "/widths"] = scan
    out[name + "/widest"] = max((w for w, b in scan.items() if b),
                                default=None)
with tempfile.TemporaryDirectory() as tmp:
    cs.write_train_split(tmp)
    for key, extra in (("ref", ("-t",)),
                       ("hybrid", ("-t", "--ref_kernels", "hybrid"))):
        r = cs.profile_trainer(tmp, 3, *extra)
        out["step/" + key] = {k: r[k] for k in (
            "step_ms_median", "host_issue_ms_per_step", "device_ms_per_step",
            "device_busy_share", "rays_per_s", "top_device_ms_per_step")}
print(json.dumps(out))
"""

# one turn of --prop, run with the checkout's root as the working directory
PROP_TURN = r"""
import json, sys, tempfile
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import hashlib
import chip_smoke as cs
from nerf_tpu_torch import ops
from nerf_tpu_torch.ops import build
names, widths = json.loads(sys.argv[1]), json.loads(sys.argv[2])
reports = build.build()
out = {"ptxas": {k: v for k, v in cs.tile_ptxas(reports).items()
                 if "bfloat16" in k}}
gen = torch.Generator(device="cuda").manual_seed(0)
bf16 = torch.bfloat16


def digest(t, h):
    if isinstance(t, (tuple, list)):
        for u in t:
            digest(u, h)
    else:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h


for name in names:
    args, kernel = cs.kernel_case(name, bf16, gen)[:2]
    out[name + "/bf16"] = cs.cuda_ms(lambda: kernel(*args), 20)
    out[name + "/sha1"] = digest(kernel(*args), hashlib.sha1()).hexdigest()
    del args
    torch.cuda.empty_cache()
    fn, scan = getattr(ops, name), {}
    for w in widths:
        ws = cs.random_weights(cs.prop_shapes(h=w), gen, bf16)
        x = cs._encodings(gen, bf16, 300, dd=False)[0]
        before = dict(getattr(ops, "BODIES", {}).get(name, {}))
        try:
            fn(ws, x)
            torch.cuda.synchronize()
        except RuntimeError:
            scan[w] = None
            continue
        after = getattr(ops, "BODIES", {}).get(name, {})
        ran = [b for b, c in after.items() if c != before.get(b, 0)]
        scan[w] = ran[0] if ran else "ran"
    out[name + "/widths"] = scan
    out[name + "/widest"] = max((w for w, b in scan.items() if b),
                                default=None)
for model in ("vanilla", "ref"):
    r = cs.profile_frame(model)
    out["frame/" + model] = {k: r[k] for k in ("frame_s", "device_ms",
                                                "device_busy_share")}
with tempfile.TemporaryDirectory() as tmp:
    cs.write_train_split(tmp)
    for model, epochs, extra in (("vanilla", 5, ()), ("ref", 3, ("-t",))):
        r = cs.profile_trainer(tmp, epochs, *extra)
        out["step/" + model] = {k: r[k] for k in (
            "step_ms_median", "host_issue_ms_per_step", "device_ms_per_step",
            "device_busy_share", "rays_per_s")}
print(json.dumps(out))
"""

# one turn of --vanilla, run with the checkout's root as the working
# directory: each kernel on the vanilla path's encodings ("pe") and on the
# -m path's IPE encodings at the same points ("ipe")
VANILLA_TURN = r"""
import json, sys, tempfile
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import hashlib
import chip_smoke as cs
from nerf_tpu_torch.ops import build
names = json.loads(sys.argv[1])
reports = build.build()
out = {"ptxas": {k: v for k, v in cs.tile_ptxas(reports).items()
                 if "bfloat16" in k}}
gen = torch.Generator(device="cuda").manual_seed(0)


def digest(t, h):
    if isinstance(t, (tuple, list)):
        for u in t:
            digest(u, h)
    else:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h


for name in names:
    rays = cs.CHUNK if name == "vanilla_mlp_fwd" else cs.RAYS
    for label, ipe in (("pe", None), ("ipe", (rays, cs.N_FINE))):
        args, kernel = cs.kernel_case(name, torch.bfloat16, gen,
                                      ipe=ipe)[:2]
        key = "%s/%s" % (name, label)
        out[key + "/bf16"] = cs.cuda_ms(lambda: kernel(*args), 20)
        out[key + "/sha1"] = digest(kernel(*args), hashlib.sha1()).hexdigest()
        del args
        torch.cuda.empty_cache()
for model in ("vanilla", "mip"):
    r = cs.profile_frame(model)
    out["frame/" + model] = {k: r[k] for k in ("frame_s", "device_ms",
                                                "device_busy_share")}
with tempfile.TemporaryDirectory() as tmp:
    cs.write_train_split(tmp)
    for model, epochs, extra in (("vanilla", 5, ()),
                                 ("mip", 5, ("-m", "--name", "mip_1")),
                                 ("ref", 3, ("-t",))):
        r = cs.profile_trainer(tmp, epochs, *extra)
        out["step/" + model] = {k: r[k] for k in (
            "step_ms_median", "host_issue_ms_per_step", "device_ms_per_step",
            "device_busy_share", "rays_per_s")}
print(json.dumps(out))
"""

# one turn of --spa (and of --dir, with DIR_KERNELS), run with the
# checkout's root as the working directory
SPA_TURN = r"""
import json, sys, tempfile
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import hashlib
import chip_smoke as cs
from nerf_tpu_torch.ops import build
names = json.loads(sys.argv[1])
reports = build.build()
out = {"ptxas": {k: v for k, v in cs.tile_ptxas(reports).items()
                 if "bfloat16" in k}}
gen = torch.Generator(device="cuda").manual_seed(0)


def digest(t, h):
    if isinstance(t, (tuple, list)):
        for u in t:
            digest(u, h)
    else:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h


for name in names:
    args, kernel = cs.kernel_case(name, torch.bfloat16, gen)[:2]
    out[name + "/bf16"] = cs.cuda_ms(lambda: kernel(*args), 20)
    out[name + "/sha1"] = digest(kernel(*args), hashlib.sha1()).hexdigest()
    del args
    if name.startswith("ref_dir"):   # and with sRGB on
        args, kernel = cs.kernel_case(name, torch.bfloat16, gen,
                                      use_srgb=True)[:2]
        out[name + "/sha1_srgb"] = digest(kernel(*args),
                                          hashlib.sha1()).hexdigest()
        del args
    torch.cuda.empty_cache()
r = cs.profile_frame("ref")
out["frame/ref"] = {k: r[k] for k in ("frame_s", "device_ms",
                                      "device_busy_share")}
with tempfile.TemporaryDirectory() as tmp:
    cs.write_train_split(tmp)
    for model, epochs, extra in (("ref", 3, ("-t",)), ("vanilla", 5, ()),
                                 ("mip", 5, ("-m", "--name", "mip_1"))):
        r = cs.profile_trainer(tmp, epochs, *extra)
        out["step/" + model] = {k: r[k] for k in (
            "step_ms_median", "host_issue_ms_per_step", "device_ms_per_step",
            "device_busy_share", "rays_per_s")}
print(json.dumps(out))
"""

# one turn of --tile, run with the checkout's root as the working directory
TILE_TURN = r"""
import json, sys, tempfile
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from nerf_tpu_torch import ops
from nerf_tpu_torch.ops import build
from nerf_tpu_torch.tools import bench_ref_kernels
names = json.loads(sys.argv[1])
reports = build.build()
out = {"ptxas": {k: v for k, v in cs.tile_ptxas(reports).items()
                 if "bfloat16" in k}}
gen = torch.Generator(device="cuda").manual_seed(0)
bf16 = torch.bfloat16
from nerf_tpu_torch.ops import dense as dense_lib
if hasattr(dense_lib, "map_encode_us"):
    w = torch.randn((256, 256), generator=gen, device="cuda").to(bf16)
    out["map_encode_us"] = [dense_lib.map_encode_us(w) for _ in range(3)]
for ks, n_out in cs.DENSE_SHAPES:
    acts, ws, b = cs.dense_operands(gen, cs.DENSE_N[0], ks, n_out, bf16)
    cat_a = torch.cat(acts, 1) if len(acts) > 1 else acts[0]
    cat_w = torch.cat(ws, 0) if len(ws) > 1 else ws[0]
    bias = b.to(bf16).reshape(1, -1)
    key = "dense_layer[%s->%d]/bf16" % ("+".join(map(str, ks)), n_out)
    out[key] = cs.cuda_ms(lambda: cs.dense_call(ops.dense_layer, acts, ws,
                                                b), 20)
    out[key.replace("dense_layer", "addmm")] = cs.cuda_ms(
        lambda: torch.addmm(bias, cat_a, cat_w), 20)
    del acts, ws, cat_a, cat_w
    torch.cuda.empty_cache()
for name in names:
    if name == "ref_dir_fwd_dissect":
        res = bench_ref_kernels.main(["--dissect_fwd", "--dtype", "bf16"])
        out[name + "/bf16"] = res["fwd_stages"]["full"]
        continue
    args, kernel = cs.kernel_case(name, bf16, gen)[:2]
    out[name + "/bf16"] = cs.cuda_ms(lambda: kernel(*args), 20)
    del args
    torch.cuda.empty_cache()
for model in ("vanilla", "ref"):
    r = cs.profile_frame(model)
    out["frame/" + model] = {k: r[k] for k in ("frame_s", "device_ms",
                                                "device_busy_share")}
with tempfile.TemporaryDirectory() as tmp:
    cs.write_train_split(tmp)
    for model, extra in (("vanilla", ()), ("ref", ("-t",))):
        r = cs.profile_trainer(tmp, 5 if model == "vanilla" else 3, *extra)
        out["step/" + model] = {k: r[k] for k in (
            "step_ms_median", "host_issue_ms_per_step", "device_ms_per_step",
            "device_busy_share", "rays_per_s")}
print(json.dumps(out))
"""

# the delta pass alone in the default turn: (k_dim, n_out, form) of the
# 256 -> 256 masked trunk layer, the pullback into the directional net's
# 167-wide input and the vanilla dbvec-like 128 -> 256 pass with ADD
DELTA_AB_SHAPES = ((256, 256, "act"), (256, 167, "none"),
                   (128, 256, "add_act"))

# one turn, run with the checkout's root as the working directory
TURN = r"""
import json, sys, tempfile
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from nerf_tpu_torch import ops
from nerf_tpu_torch.ops import build
from nerf_tpu_torch.tools import bench_ref_kernels
names, steps = json.loads(sys.argv[1]), sys.argv[2] == "1"
shapes = json.loads(sys.argv[3])
reports = build.build()
out = {"ptxas": {k: v for k, v in cs.tile_ptxas(reports).items()
                 if "bfloat16" in k},
       "ptxas_wgrad": cs.wgrad_ptxas(reports).get("wgrad")}
gen = torch.Generator(device="cuda").manual_seed(0)
for lst, (jobs, rows, rnd, chunk) in cs.wgrad_lists(gen):
    pieces = cs.wgrad_walk(jobs, chunk)
    key = "wgrad_reduce[%s]/bf16" % lst
    out[key] = cs.cuda_device_ms(lambda: cs.wgrad_call(
        pieces, rows, rnd, ops.wgrad_reduce), 20)
    lib = [(a, d.to(torch.bfloat16)) for a, d, _ in jobs]
    out[key.replace("wgrad_reduce", "mm")] = cs.cuda_device_ms(
        lambda: [torch.mm(a.T, d) for a, d in lib], 20)
    del jobs, pieces, lib
    torch.cuda.empty_cache()
for k, n_out, form in shapes:
    kw = cs.delta_operands(gen, cs.DELTA_N[1], k, n_out, form,
                           torch.bfloat16)
    kw["store"] = None
    key = "delta_layer[%d->%d %s]/bf16" % (k, n_out, form)
    out[key] = cs.cuda_ms(lambda: ops.delta_layer(**kw), 20)
    a, wt = kw["a"], kw["w"].t()
    out[key.replace("delta_layer", "mm")] = cs.cuda_ms(
        lambda: torch.mm(a, wt), 20)
    del kw, a, wt
    torch.cuda.empty_cache()
for name in names:
    for dt in ("bf16", "f32"):
        if name == "ref_dir_bwd_dissect":
            res = bench_ref_kernels.main(["--dissect", "--dtype", dt])
            out[f"{name}/{dt}"] = res["bwd_modes"]["full"]
            continue
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
        args, kernel = cs.kernel_case(name, dtype, gen)[:2]
        out[f"{name}/{dt}"] = cs.cuda_ms(lambda: kernel(*args), 20)
        del args
        torch.cuda.empty_cache()
if steps:
    for model in ("vanilla", "ref"):
        for form, kw in (("res", {}),
                         ("recompute", {"store_residuals": False}),
                         ("prop_res", {"prop_res": True})):
            r = cs.step_check(model, **kw)
            out[f"step/{model}/{form}"] = {
                k: r[k] for k in ("loss_kernels", "grad_rel_err_max",
                                  "grad_rel_err_median", "per_call_vs_plain")}
with tempfile.TemporaryDirectory() as tmp:
    cs.write_train_split(tmp)
    for model, extra in (("vanilla", ()), ("ref", ("-t",))):
        r = cs.profile_trainer(tmp, 5 if model == "vanilla" else 3, *extra)
        out["step/" + model] = {k: r[k] for k in (
            "step_ms_median", "host_issue_ms_per_step", "device_ms_per_step",
            "device_busy_share", "rays_per_s")}
print(json.dumps(out))
"""


def turn(root: Path, steps: bool, mode: str | None = None) -> dict:
    """One checkout's timings (and step readings), in a process of its
    own; ``mode`` "tile", "spa", "dir", "vanilla", "prop" or "spa_bwd"
    picks another turn than the default one."""
    cmd = ([sys.executable, "-c", TILE_TURN, json.dumps(TILE_KERNELS)]
           if mode == "tile" else
           [sys.executable, "-c", SPA_TURN, json.dumps(SPA_KERNELS)]
           if mode == "spa" else
           [sys.executable, "-c", SPA_TURN, json.dumps(DIR_KERNELS)]
           if mode == "dir" else
           [sys.executable, "-c", VANILLA_TURN, json.dumps(VANILLA_KERNELS)]
           if mode == "vanilla" else
           [sys.executable, "-c", PROP_TURN, json.dumps(PROP_KERNELS),
            json.dumps(PROP_WIDTHS)]
           if mode == "prop" else
           [sys.executable, "-c", SPA_BWD_TURN, json.dumps(SPA_BWD_KERNELS),
            json.dumps(SPA_BWD_WIDTHS)]
           if mode == "spa_bwd" else
           [sys.executable, "-c", TURN, json.dumps(DELTA_PASS_KERNELS),
            "1" if steps else "0", json.dumps(DELTA_AB_SHAPES)])
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"the turn in {root} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python3 kernel_ab.py",
        description="time the fused kernels of two checkouts in turns")
    ap.add_argument("--other", required=True, type=Path,
                    help="the root of the other checkout")
    ap.add_argument("--steps", action="store_true",
                    help="also read the six f32 training steps")
    ap.add_argument("--tile", action="store_true",
                    help="time what runs the forward layer tile instead")
    ap.add_argument("--spa", action="store_true",
                    help="time the spatial net's fused forwards, a Ref-NeRF "
                         "frame and step instead")
    ap.add_argument("--dir", action="store_true",
                    help="time the directional net's fused forwards, a "
                         "Ref-NeRF frame and step instead")
    ap.add_argument("--vanilla", action="store_true",
                    help="time the vanilla net's fused forwards, the "
                         "vanilla and -m frames and steps instead")
    ap.add_argument("--prop", action="store_true",
                    help="time the proposal net's fused forwards and scan "
                         "their widths, the vanilla and Ref-NeRF frames "
                         "and steps instead")
    ap.add_argument("--spa_bwd", action="store_true",
                    help="time the spatial net's fused backwards and scan "
                         "their widths, the -t and hybrid steps instead")
    args = ap.parse_args(argv)
    mode = next((m for m in ("tile", "spa", "dir", "vanilla", "prop",
                             "spa_bwd")
                 if getattr(args, m)), None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    order = [("other", args.other.resolve()), ("this", ROOT),
             ("this", ROOT), ("other", args.other.resolve())]
    turns = []
    for label, root in order:
        turns.append(dict(tree=label, root=str(root),
                          ms=turn(root, args.steps, mode)))
        print(json.dumps(turns[-1]), file=sys.stderr, flush=True)
    res = dict(nvidia_smi=smi, turns=turns)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
