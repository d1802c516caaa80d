"""Time the fused kernels of two checkouts in turns on one card.

    python3 kernel_ab.py --other DIR [--steps] > ab.json

DIR is another checkout of this repository (for example ``git archive`` of
an earlier commit unpacked under ``build/``).  Each turn is one process
started in a checkout's root: it builds that checkout's kernels, then times
each kernel whose delta pass runs ``delta_tile``, bf16 and f32, with that
checkout's own ``chip_smoke.py`` (``kernel_case``: the main-path shapes and
seeded operands of its kernel checks; ``cuda_ms``: the median of 20
CUDA-event timings after a warm-up), and ``ref_dir_bwd_dissect`` with its
own ``nerf_tpu_torch.tools.bench_ref_kernels --dissect`` (the "full" mode).
The
turns run other, this, this, other, so that a drift of the card's clocks
shows as a difference between the two turns of one checkout.  With
``--steps`` each turn also takes ``chip_smoke.step_check``'s readings of
the six f32 training steps (both models; residual, recompute and proposal
residual forms): the kernels' loss and their grads' errors against the
nn.Module path, which two checkouts whose f32 kernels are the same code
read to the last digit.  Prints one JSON object: each turn's ms by
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

# one turn, run with the checkout's root as the working directory
TURN = r"""
import json, sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from nerf_tpu_torch.ops import build
from nerf_tpu_torch.tools import bench_ref_kernels
names, steps = json.loads(sys.argv[1]), sys.argv[2] == "1"
build.build()
gen = torch.Generator(device="cuda").manual_seed(0)
out = {}
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
print(json.dumps(out))
"""


def turn(root: Path, steps: bool) -> dict:
    """One checkout's timings (and step readings), in a process of its
    own."""
    proc = subprocess.run(
        [sys.executable, "-c", TURN, json.dumps(DELTA_PASS_KERNELS),
         "1" if steps else "0"], cwd=root,
        capture_output=True, text=True, check=False)
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
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    order = [("other", args.other.resolve()), ("this", ROOT),
             ("this", ROOT), ("other", args.other.resolve())]
    turns = []
    for label, root in order:
        turns.append(dict(tree=label, root=str(root),
                          ms=turn(root, args.steps)))
        print(json.dumps(turns[-1]), file=sys.stderr, flush=True)
    res = dict(nvidia_smi=smi, turns=turns)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
