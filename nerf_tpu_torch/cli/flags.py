"""Shared CLI flag surface (port of nerf_tpu/cli/flags.py, flag for flag).

The port parses every flag of the JAX package, so a command line works
unchanged; flags of paths that are not ported yet are accepted, and the
path raises when it is reached.  Departures of the JAX package from the
reference CLI carry over: --opt_mode maps {O1, O2, native} -> bf16 compute
and none -> fp32; --dataset_root replaces the reference's hardcoded paths;
--pe_period_scale and -v/--visualize are accepted and ignored.
"""

from __future__ import annotations

import argparse

from nerf_tpu_torch.train.config import PipelineConfig


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="nerf_tpu_torch: NeRF / Ref-NeRF / proposal-distillation on NVIDIA Hopper (PyTorch + CUDA port of nerf_tpu)"
    )
    p.add_argument("--epochs", type=int, default=2400, help="Training lasts for . epochs")
    p.add_argument("--max_save", type=int, default=3, help="Check point max save number")
    p.add_argument("--sample_ray_num", type=int, default=1024, help="<x> rays to sample per training time")
    p.add_argument("--coarse_sample_pnum", type=int, default=64, help="Points to sample in coarse net")
    p.add_argument("--fine_sample_pnum", type=int, default=128, help="Points to sample in fine net")
    p.add_argument("--eval_time", type=int, default=5, help="Metrics output interval (train iters)")
    p.add_argument("--output_time", type=int, default=20, help="Image output interval (epochs)")
    p.add_argument("--center_crop_iter", type=int, default=0, help="Use center crop for the first . iters")
    p.add_argument("--prop_net_width", type=int, default=256, help="Width of proposal network")
    p.add_argument("--nerf_net_width", type=int, default=256, help="Width of nerf network")
    p.add_argument("--near", type=float, default=2.0, help="Nearest sample depth")
    p.add_argument("--far", type=float, default=6.0, help="Farthest sample depth")
    p.add_argument("--center_crop_x", type=float, default=0.5, help="Center crop x axis ratio")
    p.add_argument("--center_crop_y", type=float, default=0.5, help="Center crop y axis ratio")
    p.add_argument("--name", type=str, default="model_1", help="Model name for loading")
    p.add_argument("--dataset_name", type=str, default="lego", help="Input dataset name in nerf synthetic dataset")
    p.add_argument("--dataset_root", type=str, default="..", help="Directory containing <dataset_name>/ (reference used '..')")
    p.add_argument("--img_scale", type=float, default=0.5, help="Scale of the image")
    p.add_argument("--scene_scale", type=float, default=1.0, help="Scale of the scene")
    p.add_argument("--grad_clip", type=float, default=-0.01, help="Gradient clipping parameter (negative = no clipping)")
    p.add_argument("--pe_period_scale", type=float, default=0.5, help="[dead in reference; accepted and ignored]")
    # opt related
    p.add_argument("--opt_mode", type=str, default="O1", help="Mixed precision: none (fp32) | native/O1/O2 (bf16 compute)")
    p.add_argument("--min_ratio", type=float, default=0.01, help="Minimum for now_lr / lr")
    p.add_argument("--decay_rate", type=float, default=0.1, help="After <decay step>, lr = lr * <decay_rate>")
    p.add_argument("--decay_step", type=int, default=100000, help="After <decay step>, lr = lr * <decay_rate>")
    p.add_argument("--warmup_step", type=int, default=500, help="Warm up step (from lowest lr to starting lr)")
    p.add_argument("--lr", type=float, default=1.5e-4, help="Start lr")
    # short bool options
    p.add_argument("-d", "--del_dir", default=False, action="store_true", help="Delete dir ./logs and start new records")
    p.add_argument("-l", "--load", default=False, action="store_true", help="Load checkpoint or trained model.")
    p.add_argument("-s", "--use_scaler", default=False, action="store_true", help="bf16 mixed-precision compute")
    p.add_argument("-b", "--debug", default=False, action="store_true",
                   help="Code debugging: module-attributed NaN detection "
                        "(training; not ported yet). Also forces f32 compute")
    p.add_argument("-v", "--visualize", default=False, action="store_true", help="[dead in reference; accepted and ignored]")
    p.add_argument("-r", "--do_render", default=False, action="store_true", help="Only render the result")
    p.add_argument("-w", "--white_bkg", default=False, action="store_true", help="Output white background")
    p.add_argument("-t", "--ref_nerf", default=False, action="store_true", help="Use Ref-NeRF model")
    p.add_argument("-u", "--use_srgb", default=False, action="store_true", help="Whether to use srgb in the output or not")
    p.add_argument("-e", "--eval_poses", default=False, action="store_true", help="Use test set poses to render image")
    # long bool options
    p.add_argument("--render_depth", default=False, action="store_true", help="Render depth image")
    p.add_argument("--render_normal", default=False, action="store_true", help="Render normal image")
    p.add_argument("--prop_normal", default=False, action="store_true", help="(For proposal net) Whether to learn normals")
    # ref nerf options
    p.add_argument("--ide_level", type=int, default=4, help="Max level of spherical harmonics to be used")
    p.add_argument("--bottle_neck_noise", type=float, default=0.02, help="Noise std for perturbing bottle_neck vector")
    p.add_argument("--second_order_normals", default=False, action="store_true",
                   help="differentiate THROUGH the density-gradient normal "
                        "targets (true second-order autodiff). The reference's "
                        "autograd.grad call leaves create_graph=False "
                        "(train.py:168), so its targets are detached "
                        "constants — the default here reproduces that and is "
                        "~25%% faster on the ref path")
    p.add_argument("--legacy_coarse_select", default=False, action="store_true",
                   help="reproduce the reference's coarse_grad_select "
                        "off-by-one (ref_model.py:108-117: the --prop_normal "
                        "coarse targets treat the last fine sample as coarse "
                        "and drop the real last coarse sample); default is "
                        "the corrected merge-rank mapping")
    # nerf_tpu extensions (not in the reference surface)
    p.add_argument("--seed", type=int, default=0, help="Base seed of the torch.Generator draws (the reference used the unseeded global RNG)")
    p.add_argument("--eval_chunk", type=int, default=4096, help="Rays per eval-render chunk")
    p.add_argument("--output_dir", type=str, default="./output", help="Rendered image output dir")
    p.add_argument("--log_dir", type=str, default="./logs", help="Metrics/tensorboard dir")
    p.add_argument("--ckpt_dir", type=str, default="./check_points", help="Checkpoint dir")
    p.add_argument("--no_tensorboard", default=False, action="store_true", help="JSONL metrics only")
    p.add_argument("--pallas", dest="pallas", default=None,
                   action="store_true",
                   help="force the fused MLP kernels on the training path "
                        "(ops/fused_mlp.py; the default)")
    p.add_argument("--no_pallas", dest="pallas", action="store_false",
                   help="force the per-layer nn.Module path instead of the "
                        "fused MLP kernels on the training path")
    p.add_argument("--pe_doubling", default=False, action="store_true",
                   help="angle-doubling spatial PE of the JAX package's "
                        "kernel paths; accepted and ignored by the port")
    p.add_argument("--ref_kernels", type=str, default="all",
                   choices=["hybrid", "all"],
                   help="Ref-NeRF kernel strategy: 'all' = the whole "
                        "fine net in the fused spatial and directional "
                        "kernels (train and render); 'hybrid' = the fused "
                        "spatial kernels (the recompute pair in training), "
                        "the directional net as the nn.Module")
    p.add_argument("--trace", type=str, default=None, metavar="DIR",
                   help="capture a profiler trace of one epoch into DIR "
                        "(training; not ported yet)")
    p.add_argument("--use_ipe", default=False, action="store_true",
                   help="Mip-NeRF integrated positional encoding for the "
                        "vanilla fine net (live version of the reference's "
                        "dormant IPE math, mip_methods.py:36-58)")
    p.add_argument("-m", "--mip_nerf", default=False, action="store_true",
                   help="true Mip-NeRF: ONE network at both levels with "
                        "conical-frustum IPE, no proposal net")
    p.add_argument("--distortion_weight", type=float, default=0.0,
                   help="mip-360 distortion regularizer weight (the "
                        "reference defines it but never uses it, "
                        "addtional.py:26-36)")
    p.add_argument("--entropy_weight", type=float, default=0.0,
                   help="InfoNeRF few-shot ray-entropy regularizer weight")
    p.add_argument("--entropy_threshold", type=float, default=0.1,
                   help="InfoNeRF ray-acc mask threshold")
    p.add_argument("--legacy_focal", default=False, action="store_true",
                   help="reproduce the reference's square-image focal quirk "
                        "(utils.py:103-105)")
    return p


def use_bf16_from_args(args) -> bool:
    """bf16 only under -s, disabled while debugging (the reference's
    `use_amp = args.use_scaler and not debugging`); --opt_mode none forces
    fp32 even with -s."""
    return (bool(args.use_scaler) and not args.debug
            and str(args.opt_mode).lower() != "none")


def config_from_args(args) -> PipelineConfig:
    mip = getattr(args, "mip_nerf", False)
    if mip and args.ref_nerf:
        raise SystemExit("error: -t/--ref_nerf and -m/--mip_nerf are exclusive")
    return PipelineConfig(
        model="ref" if args.ref_nerf else ("mip" if mip else "vanilla"),
        near=args.near,
        far=args.far,
        n_coarse=args.coarse_sample_pnum,
        n_fine=args.fine_sample_pnum,
        ray_batch=args.sample_ray_num,
        white_bkg=args.white_bkg,
        use_srgb=args.use_srgb,
        prop_normal=args.prop_normal,
        ide_level=args.ide_level,
        bottleneck_noise=args.bottle_neck_noise,
        nerf_width=args.nerf_net_width,
        prop_width=args.prop_net_width,
        use_bf16=use_bf16_from_args(args),
        # -b forces the per-layer path (unless --pallas is explicit): NaN
        # hooks cannot see inside a fused kernel
        use_pallas=(False if (args.debug and getattr(args, "pallas", None)
                              is None)
                    else getattr(args, "pallas", None)),
        use_ipe=getattr(args, "use_ipe", False) or mip,
        second_order_normals=getattr(args, "second_order_normals", False),
        legacy_coarse_select=getattr(args, "legacy_coarse_select", False),
        ref_kernels=getattr(args, "ref_kernels", "all"),
        pe_doubling=getattr(args, "pe_doubling", False),
        distortion_w=getattr(args, "distortion_weight", 0.0),
        entropy_w=getattr(args, "entropy_weight", 0.0),
        entropy_acc_threshold=getattr(args, "entropy_threshold", 0.1),
    )


def finalize_config(cfg, focal):
    """Resolve dataset-dependent config fields (IPE pixel base radius)."""
    if (cfg.use_ipe or cfg.model == "mip") and cfg.ipe_radius == 0.0:
        cfg = cfg.replace(ipe_radius=float(2.0 / (12.0 ** 0.5) / focal[0]))
    return cfg
