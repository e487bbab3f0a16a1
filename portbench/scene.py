"""The benchmark's inputs, made from ``--seed`` on the device.

A configuration's ``scene`` block fixes the sizes: the cloud's point count
and spread, the arc of cameras (radius, half-angle, tilt, field of view),
the llffhold split and the image size. The seed draws the points, their
colours and the ground-truth images; the cameras are the same for every
seed, so every seed gives the same sizes of work.

The ground truth is a smooth colour field per training view: three octaves
of uniform noise (9×16, 27×48 and 81×144 cells, weights 1, 1/2, 1/4)
upsampled bilinearly to the image and squashed by a logistic into (0, 1).
Its content sets the loss and which Gaussians densify, not the sizes.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch

from portbench.reference.train import Inputs

OCTAVES = ((9, 16, 1.0), (27, 48, 0.5), (81, 144, 0.25))


def arc_cameras(sc: dict):
    """The configuration's views in name order: (c2w rotation [3, 3],
    centre [3]) float64, on an arc around the origin looking at it."""
    cams = []
    for a in np.linspace(-sc["arc_half_angle"], sc["arc_half_angle"], sc["views"]):
        v = np.array([sc["arc_tilt"] * math.sin(3 * a), a, 0.0])
        th = float(np.linalg.norm(v))
        k = v / th if th else v
        K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
        rot = np.eye(3) + math.sin(th) * K + (1 - math.cos(th)) * (K @ K)
        cams.append((rot, rot @ np.array([0.0, 0.0, -sc["arc_radius"]])))
    return cams


def train_views(sc: dict) -> list:
    """Indices of the training views: every ``llffhold``-th is held out."""
    return [i for i in range(sc["views"]) if i % sc["llffhold"] != 0]


def fov(sc: dict) -> tuple:
    fovx = sc["fovx"]
    return fovx, 2 * math.atan(math.tan(fovx / 2) * sc["height"] / sc["width"])


def make_inputs(cfg: dict, seed: int, device) -> Inputs:
    sc = cfg["scene"]
    gen = torch.Generator(device=device).manual_seed(seed)
    n = sc["points"]
    points = torch.randn((n, 3), generator=gen, device=device) * sc["cloud_sigma"]
    # colours as a COLMAP cloud stores them: bytes
    colors = torch.randint(0, 256, (n, 3), generator=gen, device=device).float() / 255.0
    cams = arc_cameras(sc)
    idx = train_views(sc)
    H, W = sc["height"], sc["width"]
    field = torch.zeros((len(idx), 3, H, W), device=device)
    for h, w, weight in OCTAVES:
        noise = torch.rand((len(idx), 3, h, w), generator=gen, device=device)
        field += weight * torch.nn.functional.interpolate(noise, size=(H, W), mode="bilinear",
                                                          align_corners=False)
    total = sum(o[2] for o in OCTAVES)
    gt = torch.sigmoid(6.0 * (field / total - 0.5)).permute(0, 2, 3, 1).contiguous()
    del field
    f64 = torch.float64
    fovx, fovy = fov(sc)
    return Inputs(points=points, colors=colors,
                  rotations=torch.tensor(np.stack([cams[i][0] for i in idx]), dtype=f64),
                  centers=torch.tensor(np.stack([cams[i][1] for i in idx]), dtype=f64),
                  gt=gt, fovx=fovx, fovy=fovy, curve_seed=seed)


def program_scene(cfg: dict, x: Inputs, seed: int):
    """The program's ``Scene`` over these inputs, as ``Scene.__init__``
    assembles one from a COLMAP dataset on disk (the images already
    decoded, on the device), the scene radius and camera metadata worked
    out by the program's own functions."""
    from deblurgs_tpu_torch.core.camera import CameraStatic, get_projection_matrix
    from deblurgs_tpu_torch.data.readers import (BasicPointCloud, CameraInfo, SceneInfo,
                                                 get_nerfpp_norm)
    from deblurgs_tpu_torch.data.scene import Scene

    sc = cfg["scene"]
    W, H = sc["width"], sc["height"]
    infos = []
    for i, (rot, center) in enumerate(arc_cameras(sc)):
        infos.append(CameraInfo(uid=i, R=rot, T=-rot.T @ center, FovY=x.fovy, FovX=x.fovx,
                                image=None, image_path="", image_name=f"{i:05d}",
                                width=W, height=H))
    train = [c for c in infos if int(c.image_name) % sc["llffhold"] != 0]
    test = [c for c in infos if int(c.image_name) % sc["llffhold"] == 0]
    pts = x.points.cpu().numpy()
    pcd = BasicPointCloud(pts, x.colors.cpu().numpy(), np.zeros_like(pts))
    scene = Scene.__new__(Scene)
    scene.model_path = None
    scene.white_background = False
    scene.info = SceneInfo(pcd, train, test, get_nerfpp_norm(train, pcd), "")
    scene.cameras_extent = scene.info.nerf_normalization["radius"]
    scene.train_images = x.gt
    scene.height, scene.width = H, W
    scene.camera_static = CameraStatic(width=W, height=H, tanfovx=math.tan(x.fovx * 0.5),
                                       tanfovy=math.tan(x.fovy * 0.5), znear=0.01, zfar=100.0)
    scene.proj = get_projection_matrix(0.01, 100.0, x.fovx, x.fovy, device="cpu").numpy()
    scene.rotations = np.stack([c.R for c in train])
    scene.centers = np.stack([-c.T @ c.R.T for c in train])
    scene._rng = random.Random(seed)
    scene._order = []
    scene.shuffle = True
    return scene
