"""Procedural synthetic scenes (the port's own copy of
nerf_tpu/data/synthetic.py).

An analytic density/albedo field, rendered with the volume-rendering math
the models train with, gives a self-consistent multi-view dataset without
any download: the Gaussian-blob family (``_scene_params``, ``field_fn``,
optionally with view-dependent highlights) and the solid-objects family
(``_objects_scene_params``, ``field_fn_objects``).  ``render_gt_image``
renders one view by dense quadrature with the honest last bin width;
``make_synthetic_scene`` draws the train and test orbits from
``np.random.default_rng(seed + 1)``, as the JAX package does, so the same
seed gives the same poses and, to float rounding, the same images.
``write_blender_dataset`` writes a split in the Blender layout, PNGs
through ``utils/png.py``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from nerf_tpu_torch.core import rays as rays_lib
from nerf_tpu_torch.core.render import transmittance_weights
from nerf_tpu_torch.data.blender import BlenderDataset
from nerf_tpu_torch.device import resolve_device
from nerf_tpu_torch.utils.png import write_png

DEFAULT_FOV = 0.6911112070083618  # blender lego camera_angle_x


def _scene_params(seed: int, n_blobs: int = 5, specular: float = 0.0):
    """(centers (B, 3), scales (B,), colors (B, 3), peaks (B,)) f32 numpy
    arrays and the specular coefficient of a blob scene."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.7, 0.7, (n_blobs, 3)).astype(np.float32)
    scales = rng.uniform(0.15, 0.35, (n_blobs,)).astype(np.float32)
    colors = rng.uniform(0.1, 1.0, (n_blobs, 3)).astype(np.float32)
    peak = rng.uniform(20.0, 60.0, (n_blobs,)).astype(np.float32)
    return centers, scales, colors, peak, float(specular)


def field_fn(scene):
    """f(points (..., 3), dirs (..., 3) or None) -> (density, rgb) of a blob
    scene.  With a nonzero specular coefficient each blob adds a facing
    highlight ks * max(0, -d_hat . n_hat)^8, n_hat from the blob's center to
    the point."""
    centers, scales, colors, peak, specular = scene

    def f(pts, dirs=None):
        c, s, col, pk = (torch.as_tensor(a, device=pts.device)
                         for a in (centers, scales, colors, peak))
        d2 = torch.sum((pts[..., None, :] - c) ** 2, dim=-1)      # (..., B)
        contrib = pk * torch.exp(-0.5 * d2 / s ** 2)              # (..., B)
        density = torch.sum(contrib, dim=-1)
        w = contrib / (density[..., None] + 1e-8)
        rgb = w @ col
        if specular > 0.0 and dirs is not None:
            d_hat = dirs / (torch.linalg.vector_norm(dirs, dim=-1,
                                                     keepdim=True) + 1e-8)
            n_vec = pts[..., None, :] - c                         # (..., B, 3)
            n_hat = n_vec / (torch.linalg.vector_norm(n_vec, dim=-1,
                                                      keepdim=True) + 1e-8)
            facing = torch.clamp_min(
                -torch.sum(d_hat[..., None, :] * n_hat, dim=-1), 0.0)
            rgb = rgb + specular * torch.sum(w * facing ** 8, dim=-1,
                                             keepdim=True)
        return density, rgb

    return f


def _objects_scene_params(seed: int):
    """The solid-objects family: a pillar, two spheres and a torus over a
    checker-textured ground slab, their placements jittered by ``seed``;
    f32 numpy arrays."""
    rng = np.random.default_rng(seed)

    def jit3(s):
        return rng.uniform(-s, s, 3).astype(np.float32)

    return {
        "box_center": np.array([0.0, 0.0, -0.10], np.float32) + jit3(0.05),
        "box_half": np.array([0.16, 0.16, 0.45], np.float32),
        "sph_center": np.array([0.52, 0.36, -0.32], np.float32) + jit3(0.05),
        "sph_radius": np.float32(0.22),
        "tor_center": np.array([-0.46, 0.40, -0.46], np.float32) + jit3(0.04),
        "tor_R": np.float32(0.26),
        "tor_r": np.float32(0.09),
        "sph2_center": (np.array([-0.36, -0.46, -0.40], np.float32)
                        + jit3(0.04)),
        "sph2_radius": np.float32(0.15),
        "ground_z": np.float32(-0.56),
        "ground_ext": np.float32(1.15),
        "colors": rng.uniform(0.15, 0.95, (4, 3)).astype(np.float32),
        "checker": np.stack([
            rng.uniform(0.55, 0.9, 3), rng.uniform(0.05, 0.35, 3),
        ]).astype(np.float32),
    }


def field_fn_objects(params):
    """f(points, dirs) -> (density, rgb) of the objects family (diffuse):
    sigmoid-edged solids (edge 0.04) of peak density 60."""
    edge, peak = 0.04, 60.0

    def sig(x):
        return torch.sigmoid(x / edge)

    def f(pts, dirs=None):
        p = {k: torch.as_tensor(v, device=pts.device)
             for k, v in params.items()}
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
        rad = torch.sqrt(x * x + y * y + 1e-12)
        d_ground = (peak * torch.exp(-0.5 * ((z - p["ground_z"]) / 0.04) ** 2)
                    * torch.sigmoid((p["ground_ext"] - rad) / 0.08))
        t = torch.sigmoid(torch.sin(5.0 * x) * torch.sin(5.0 * y) / 0.15)
        c_ground = (p["checker"][0] * (1.0 - t[..., None])
                    + p["checker"][1] * t[..., None])
        db = torch.abs(pts - p["box_center"]) - p["box_half"]
        d_box = peak * torch.prod(sig(-db), dim=-1)
        r1 = torch.linalg.vector_norm(pts - p["sph_center"], dim=-1)
        d_sph = peak * sig(p["sph_radius"] - r1)
        r2 = torch.linalg.vector_norm(pts - p["sph2_center"], dim=-1)
        d_sph2 = peak * sig(p["sph2_radius"] - r2)
        dt = pts - p["tor_center"]
        ring = torch.sqrt(dt[..., 0] ** 2 + dt[..., 1] ** 2 + 1e-12) \
            - p["tor_R"]
        d_tor = peak * sig(p["tor_r"]
                           - torch.sqrt(ring ** 2 + dt[..., 2] ** 2 + 1e-12))
        dens = torch.stack([d_ground, d_box, d_sph, d_sph2, d_tor], dim=-1)
        density = torch.sum(dens, dim=-1)
        w = dens / (density[..., None] + 1e-8)
        grad1 = 0.6 + 0.4 * torch.sigmoid((z - p["sph_center"][2])
                                          / p["sph_radius"])
        cols = torch.stack([
            torch.broadcast_to(p["colors"][0], pts.shape),
            p["colors"][1] * grad1[..., None],
            torch.broadcast_to(p["colors"][2], pts.shape),
            torch.broadcast_to(p["colors"][3], pts.shape),
        ], dim=-2)                                        # (..., 4, 3)
        rgb = (w[..., :1] * c_ground
               + torch.sum(w[..., 1:, None] * cols, dim=-2))
        return density, rgb

    return f


@torch.no_grad()
def render_gt_image(scene, c2w, hw, focal, near=2.0, far=6.0, n_samples=192,
                    white_bkg=True, chunk=4096, device=None) -> np.ndarray:
    """The ground-truth (H, W, 3) f32 image of an analytic field by dense
    quadrature: ``n_samples`` bin centres on [near, far] and the honest last
    bin width instead of the 1e10 sentinel (whose saturation on the fields'
    never-zero tails would paint halos no model can fit).  ``scene`` is a
    blob scene tuple or a field f(points, dirs) -> (density, rgb).  Runs on
    ``device`` (``cuda`` unless ``device="cpu"``)."""
    dev = resolve_device(device)
    h, w = hw
    f = scene if callable(scene) else field_fn(scene)
    pose = torch.as_tensor(np.asarray(c2w, np.float32)[:3, :], device=dev)
    all_rays = rays_lib.full_image_rays(h, w, pose, focal)
    mids = torch.linspace(near, far, n_samples + 1, device=dev)
    zvals = 0.5 * (mids[1:] + mids[:-1])
    out = []
    for r in torch.split(all_rays, chunk):
        o, d = r[..., :3], r[..., 3:]
        norm = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        pts = o[:, None, :] + d[:, None, :] * zvals[None, :, None]
        density, rgb = f(pts, torch.broadcast_to(d[:, None, :], pts.shape))
        wgt = transmittance_weights(density, zvals[None, :] * norm,
                                    density_act=lambda x: x,
                                    final_delta=(far - near) / n_samples
                                    * norm)
        px = torch.sum(wgt[..., None] * rgb, dim=-2)
        if white_bkg:
            px = px + (1.0 - torch.sum(wgt, dim=-1, keepdim=True))
        out.append(px)
    img = torch.cat(out).reshape(h, w, 3)
    return img.cpu().numpy().clip(0.0, 1.0)


def make_synthetic_scene(n_train: int = 20, n_test: int = 4, hw=(100, 100),
                         seed: int = 0, fov: float = DEFAULT_FOV,
                         white_bkg: bool = True, n_samples: int = 192,
                         specular: float = 0.0, family: str = "blobs",
                         device=None):
    """(train, test, (train poses (N, 4, 4), test poses)) of an analytic
    scene: ``n_train`` and ``n_test`` orbit views at radius 4, the test
    orbit shifted by 7.3 degrees, elevations drawn from
    ``default_rng(seed + 1)``.  ``family`` is "blobs" (``specular`` > 0
    adds highlights) or "objects" (diffuse only).  The images are rendered
    on ``device`` (``cuda`` unless ``device="cpu"``)."""
    if family == "objects":
        if specular:
            raise ValueError("the objects family is diffuse-only")
        scene = field_fn_objects(_objects_scene_params(seed))
    elif family == "blobs":
        scene = _scene_params(seed, specular=specular)
    else:
        raise ValueError(f"unknown scene family {family!r}")
    focal = rays_lib.fov_to_focal(fov, hw)
    rng = np.random.default_rng(seed + 1)

    def gen(n, phase):
        thetas = np.linspace(-180, 180, n, endpoint=False) + phase
        phis = rng.uniform(-45, -15, n)
        poses4 = np.stack([rays_lib.pose_spherical(t, p, 4.0)
                           for t, p in zip(thetas, phis)])
        imgs = np.stack([
            render_gt_image(scene, p, hw, focal, white_bkg=white_bkg,
                            n_samples=n_samples, device=device)
            for p in poses4])
        return imgs.astype(np.float32), poses4.astype(np.float32)

    tr_imgs, tr_poses = gen(n_train, 0.0)
    te_imgs, te_poses = gen(n_test, 7.3)
    train = BlenderDataset(tr_imgs, tr_poses[:, :3, :], fov)
    test = BlenderDataset(te_imgs, te_poses[:, :3, :], fov)
    return train, test, (tr_poses, te_poses)


def write_blender_dataset(root: str, dataset: BlenderDataset,
                          poses4: np.ndarray, split: str = "train"):
    """Write ``dataset`` as ``root/<split>/r_<i>.png`` and
    ``root/transforms_<split>.json``, the layout ``BlenderDataset.load``
    reads."""
    img_dir = os.path.join(root, split)
    os.makedirs(img_dir, exist_ok=True)
    frames = []
    for i in range(len(dataset)):
        arr = (dataset.images[i] * 255.0 + 0.5).astype(np.uint8)
        write_png(os.path.join(img_dir, f"r_{i}.png"), arr)
        frames.append({"file_path": f"./{split}/r_{i}",
                       "transform_matrix": np.asarray(poses4[i]).tolist()})
    meta = {"camera_angle_x": float(dataset.fov), "frames": frames}
    with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
        json.dump(meta, f)
