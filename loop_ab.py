"""Read the trainer's epoch loop of one or two checkouts on one card.

    python3 loop_ab.py --other DIR > ab.json

DIR is another checkout of this repository (for example ``git archive`` of
an earlier commit unpacked under ``build/``).  Each turn is one process
started in a checkout's root, on the default bf16 vanilla step (1024 rays,
``-s -w``) over ``chip_smoke.py``'s 20-view 400x400 train split, with that
checkout's own ``cli.trainer.Trainer``:

- ``run_epoch_rays_per_s``: 1024 over the ms per step of
  ``Trainer.run_epoch`` (its steps issued back to back, then a
  synchronize), the median of 3 epochs after a warm one, as PERF.md §2
  measures it;
- ``Trainer.train()`` over EPOCHS epochs, each ``run_epoch`` between two
  CUDA events: at each boundary between two epochs, the device's ms from
  the end of the earlier epoch's work to the start of the later's
  (``gap_ms``: idle, but for the few device operations the loop issues
  between them, such as the metrics' copy), and each epoch's period on the
  device's clock, start to start, as rays/s;
- ``Trainer.train()`` once more under ``torch.profiler``, each
  ``run_epoch`` also marked by a ``record_function``: the device's idle ms
  at each boundary (``profiled_idle_ms``: from the end of the last device
  operation launched by the earlier epoch to the start of the first one
  launched by the later, the operations between them counted as busy) and
  the periods (``profiled_period_ms``).  The profiler slows the host,
  which sets the pace of this step, so these periods are longer.

The turns run other, this, this, other, so that a drift of the card's
clocks shows as a difference between the two turns of one checkout.  The
other checkout's kernels are copied from this one's build where their
sources are the same (the library's name carries their hash).  Prints one
JSON object: each turn's readings and the card's name and power limit.
``chip_smoke.py`` takes the same readings of its own checkout
(``turn``).  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EPOCHS = 4          # three boundaries
RAYS = 1024

# one turn, run with the checkout's root as the working directory
TURN = r"""
import json, os, sys, time
import torch
from torch.profiler import ProfilerActivity, profile, record_function
from nerf_tpu_torch.cli.flags import get_parser
from nerf_tpu_torch.cli.trainer import Trainer
argv, workdir = json.loads(sys.argv[1]), sys.argv[2]
os.chdir(workdir)
trainer = Trainer(get_parser().parse_args(argv), "cuda")
trainer.run_epoch(0)
torch.cuda.synchronize()
times = []
for ep in range(1, 4):
    t0 = time.perf_counter()
    trainer.run_epoch(ep)
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
run_epoch = trainer.run_epoch
marks = []
def marked(ep):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with record_function(f"epoch_{ep}"):
        start.record()
        out = run_epoch(ep)
        end.record()
    marks.append((start, end))
    return out
trainer.run_epoch = marked
trainer.train()
torch.cuda.synchronize()
gap = [marks[i][1].elapsed_time(marks[i + 1][0])
       for i in range(len(marks) - 1)]
period = [marks[i][0].elapsed_time(marks[i + 1][0])
          for i in range(len(marks) - 1)]
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    trainer.train()
trace = os.path.join(workdir, "loop_trace.json")
prof.export_chrome_trace(trace)
print(json.dumps({"trace": trace, "run_epoch_s": times, "gap_ms": gap,
                  "period_ms": period,
                  "steps_per_epoch": len(trainer.train_set)}))
"""

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def boundaries(trace: dict, epochs: int) -> dict:
    """Idle ms at each epoch boundary and each epoch's device period, from
    a chrome trace of ``Trainer.train()`` with ``epoch_<n>`` marks."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    marks = {int(e["name"].split("_")[1]): (e["ts"], e["ts"] + e["dur"])
             for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("epoch_")}
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    device = sorted((e["ts"], e["ts"] + e["dur"], e.get("args", {})
                     .get("correlation")) for e in events
                    if e.get("cat") in DEVICE_CATS)
    spans = {}
    for start, end, corr in device:
        t = launched.get(corr)
        for ep, (lo, hi) in marks.items():
            if t is not None and lo <= t <= hi:
                first, last = spans.get(ep, (start, end))
                spans[ep] = (min(first, start), max(last, end))
    out = {"idle_ms": [], "period_ms": []}
    for ep in range(epochs - 1):
        if ep not in spans or ep + 1 not in spans:
            raise RuntimeError(f"no device work marked for epoch {ep} or "
                               f"{ep + 1}: the trace holds "
                               f"{sorted(spans)}")
        lo, hi = spans[ep][1], spans[ep + 1][0]
        busy, cursor = 0.0, lo
        for start, end, _ in device:
            s, e = max(start, cursor), min(end, hi)
            if e > s:
                busy += e - s
                cursor = e
        out["idle_ms"].append(max(hi - lo, 0.0) / 1e3 - busy / 1e3)
        out["period_ms"].append((spans[ep + 1][0] - spans[ep][0]) / 1e3)
    return out


def turn(root: Path, argv: list, workdir: str) -> dict:
    """The readings of the checkout at ``root``, in a process of its own
    that trains with ``argv`` in ``workdir``."""
    proc = subprocess.run(
        [sys.executable, "-c", TURN, json.dumps(argv), workdir], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root)), capture_output=True,
        text=True, check=False, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the turn in {root} failed:\n{proc.stderr}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(res["trace"]) as f:
        trace = json.load(f)
    os.remove(res["trace"])
    steps = res["steps_per_epoch"]
    step_s = statistics.median(res["run_epoch_s"]) / steps
    profiled = boundaries(trace, EPOCHS)
    return dict(run_epoch_ms_per_step=step_s * 1e3,
                run_epoch_rays_per_s=RAYS / step_s, gap_ms=res["gap_ms"],
                period_ms=res["period_ms"],
                rays_per_s=[steps * RAYS / (p * 1e-3)
                            for p in res["period_ms"]],
                profiled_idle_ms=profiled["idle_ms"],
                profiled_period_ms=profiled["period_ms"])


def copy_kernels(other: Path) -> list:
    """Copy this checkout's built libraries into ``other``'s build
    directory where it has none of the same name (same sources)."""
    from nerf_tpu_torch.ops import build

    dest = other / "build" / "nerf_tpu_torch"
    dest.mkdir(parents=True, exist_ok=True)
    copied = []
    for lib in build.BUILD_DIR.glob("*.so"):
        if not (dest / lib.name).exists():
            shutil.copy2(lib, dest / lib.name)
            copied.append(lib.name)
    return copied


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python3 loop_ab.py",
        description="read the trainer's epoch loop of two checkouts in "
                    "turns")
    ap.add_argument("--other", required=True, type=Path,
                    help="the root of the other checkout")
    args = ap.parse_args(argv)
    import chip_smoke
    from nerf_tpu_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build()
    other = args.other.resolve()
    copied = copy_kernels(other)
    order = [("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other)]
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_train_split(tmp)
        train_argv = loop_argv(chip_smoke, tmp)
        for label, root in order:
            turns.append(dict(tree=label, root=str(root),
                              **turn(root, train_argv, tmp)))
            print(json.dumps(turns[-1]), file=sys.stderr, flush=True)
    res = dict(nvidia_smi=smi, copied_kernels=copied, turns=turns)
    print(json.dumps(res))
    return res


def loop_argv(smoke, tmp: str) -> list:
    """The turns' command line: ``chip_smoke.py``'s train flags over EPOCHS
    epochs, the eval render only at the end (the default ``--ckpt_dir``:
    a trainer from before the rotating window refuses another)."""
    return smoke.train_argv(tmp, "--output_time", "100000", "--log_dir",
                            os.path.join(tmp, "logs", "loop"), "--name",
                            "loop_1", epochs=EPOCHS)


if __name__ == "__main__":
    main()
