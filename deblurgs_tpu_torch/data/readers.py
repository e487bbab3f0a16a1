"""Scene readers: COLMAP and Blender/NeRF-synthetic datasets (host numpy).

Counterpart of ``deblurgs_tpu/data/readers.py`` (reference
``scene/dataset_readers.py``), with the fork's additions: the llffhold
marker file ``hold=n`` in the scene root (``:231-237``), the split by
``int(image_name) % llffhold`` (``:244-246``), error-percentile point
pruning to ``num_initial_pcd`` (``:261-277``), the frustum-stratified
random init with per-camera depth bounds (``:278-294`` + ``pcd_init.py``)
and the min(pcd-camera 10th percentile, 1.1·camera spread) scene radius
(``getNerfppNorm``, ``:56-90``).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from deblurgs_tpu_torch.core.camera import focal2fov, fov2focal
from deblurgs_tpu_torch.core.sh import rgb_to_sh, sh_to_rgb
from deblurgs_tpu_torch.data import colmap, ply


class BasicPointCloud(NamedTuple):
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray          # c2w rotation (transposed COLMAP, glm convention)
    T: np.ndarray          # w2c translation
    FovY: float
    FovX: float
    image: object          # PIL.Image (lazily loaded)
    image_path: str
    image_name: str
    width: int
    height: int
    depth: Optional[np.ndarray] = None


class SceneInfo(NamedTuple):
    point_cloud: BasicPointCloud
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    ply_path: str


def get_nerfpp_norm(cam_infos, pcd: BasicPointCloud | None):
    """Scene radius heuristic (reference ``getNerfppNorm``)."""
    # c2w camera centre = -T @ R^T with R the c2w rotation
    centers = np.stack([-cam.T @ cam.R.T for cam in cam_infos])
    if pcd is not None:
        dist = np.linalg.norm(centers - pcd.points.mean(axis=0), axis=1)
        radius1 = np.percentile(dist, 10.0)
    else:
        radius1 = np.percentile(np.linalg.norm(centers - centers[:, None, :], axis=-1), 90)
    avg = centers.mean(axis=0, keepdims=True)
    radius2 = np.max(np.linalg.norm(centers - avg, axis=1)) * 1.1
    return {"translate": None, "radius": float(min(radius1, radius2))}


def get_bds(cam_infos, pcd: np.ndarray) -> np.ndarray:
    """Per-camera (near, far) depth bounds of the visible point cloud
    (reference ``get_bds``, ``dataset_readers.py:164-209``)."""
    h, w = cam_infos[0].height, cam_infos[0].width
    fx = fov2focal(cam_infos[0].FovX, w)
    fy = fov2focal(cam_infos[0].FovY, h)
    bds = []
    homog = np.pad(pcd, ((0, 0), (0, 1)), constant_values=1.0)
    for cam in cam_infos:
        w2c = np.eye(4)
        w2c[:3, :3] = cam.R.T
        w2c[:3, 3] = cam.T
        cc = (homog @ w2c.T)[:, :3]
        depths = cc[:, 2]
        valid = depths > 0.01
        px = cc[:, 0] / np.maximum(depths, 1e-8) * fx + w / 2
        py = cc[:, 1] / np.maximum(depths, 1e-8) * fy + h / 2
        valid &= (px >= 0) & (px < w) & (py >= 0) & (py < h)
        d = depths[valid] if valid.any() else depths
        bds.append([np.percentile(d, 0.1), np.percentile(d, 99.9)])
    return np.array(bds)


def random_pcd_init(cam_infos, near=0.0, far=8.0, num_pcd=100_000, bds=None,
                    seed=0) -> np.ndarray:
    """Frustum-stratified random point cloud (reference ``pcd_init.py:6-52``)."""
    rng = np.random.RandomState(seed)
    all_xyz = []
    d = 50
    num_per_cam = num_pcd // max(len(cam_infos) - 5, 1) + 2
    for i, cam in enumerate(cam_infos):
        w2c = np.eye(4)
        w2c[:3, :3] = cam.R.T
        w2c[:3, 3] = cam.T
        c2w = np.linalg.inv(w2c)

        w, h = cam.width, cam.height
        fx = fov2focal(cam.FovX, w) * 0.8   # spread wider than the FOV
        fy = fov2focal(cam.FovY, h) * 0.8

        stride_coeff = num_per_cam ** (-1 / 3)
        sh_, sw_ = max(int(h * stride_coeff), 1), max(int(w * stride_coeff), 1)
        xs, ys = np.meshgrid(np.linspace(0, w - 1, w), np.linspace(0, h - 1, h))
        pix = np.stack([xs, ys], -1)[::sh_, ::sw_].reshape(-1, 2)
        norm = np.stack([(pix[:, 0] - w / 2) / fx, (pix[:, 1] - h / 2) / fy], -1)
        norm = np.tile(norm, (d * 2, 1))

        cam_near = max(near, bds[i, 0] if bds is not None else 0.0)
        cam_far = min(far, bds[i, 1] if bds is not None else 1e9)
        depth = rng.random(norm.shape[0]) * (cam_far - cam_near) + cam_near
        cam_coords = np.concatenate([norm * depth[:, None], depth[:, None]], axis=-1)[:num_per_cam]
        homog = np.pad(cam_coords, ((0, 0), (0, 1)), constant_values=1.0)
        all_xyz.append((homog @ c2w.T)[:, :3])
    return np.concatenate(all_xyz, axis=0)[:num_pcd]


def _open_image(path):
    from PIL import Image

    return Image.open(path)


def read_colmap_cameras(extrinsics, intrinsics, images_folder) -> list:
    """Reference ``readColmapCameras`` (PINHOLE / SIMPLE_PINHOLE only)."""
    infos = []
    for key in extrinsics:
        extr = extrinsics[key]
        intr = intrinsics[extr.camera_id]
        R = np.transpose(colmap.qvec2rotmat(extr.qvec))
        T = np.array(extr.tvec)
        if intr.model == "SIMPLE_PINHOLE":
            fovy = focal2fov(intr.params[0], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        elif intr.model == "PINHOLE":
            fovy = focal2fov(intr.params[1], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        else:
            raise ValueError(
                f"Colmap camera model {intr.model} not handled: only "
                "undistorted (PINHOLE/SIMPLE_PINHOLE) supported")
        image_path = os.path.join(images_folder, os.path.basename(extr.name))
        if not os.path.exists(image_path):
            image_path = image_path[:-4] + ".jpg"
        infos.append(CameraInfo(
            uid=intr.id, R=R, T=T, FovY=fovy, FovX=fovx,
            image=_open_image(image_path), image_path=image_path,
            image_name=os.path.basename(image_path).split(".")[0],
            width=intr.width, height=intr.height,
        ))
    return sorted(infos, key=lambda c: c.image_name)


def read_colmap_scene(
    path: str,
    images: str = "images",
    eval_split: bool = False,
    llffhold: int = 0,
    num_initial_pcd: int = -1,
    random_init: bool = False,
    z_near: float = 0.2,
    z_far: float = 100.0,
    use_sigmoid: bool = False,
) -> SceneInfo:
    """Reference ``readColmapSceneInfo`` (``dataset_readers.py:211-308``)."""
    sparse = colmap.detect_sparse_dir(path)
    if sparse is None:
        raise FileNotFoundError(f"no sparse/ under {path}")
    try:
        extr = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    cam_infos = read_colmap_cameras(extr, intr, os.path.join(path, images))

    # llffhold marker file (fork addition, :231-237)
    if llffhold == 0:
        markers = [e for e in os.listdir(path) if "hold=" in e]
        if len(markers) > 1:
            raise ValueError(f"more than one llffhold indicator in {path}: {markers}")
        if markers:
            llffhold = int(markers[0].strip().split("=")[-1])

    if eval_split and llffhold > 0:
        train = [c for c in cam_infos if int(c.image_name) % llffhold != 0]
        test = [c for c in cam_infos if int(c.image_name) % llffhold == 0]
    else:
        if llffhold > 0 or eval_split:
            raise ValueError("eval and llffhold must be set together")
        train, test = cam_infos, []

    try:
        xyz, rgb, error = colmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
    except FileNotFoundError:
        xyz, rgb, error = colmap.read_points3d_text(os.path.join(sparse, "points3D.txt"))

    # error-percentile pruning (fork addition, :261-277)
    if num_initial_pcd > 0:
        error = error.reshape(-1)
        percent = min(num_initial_pcd / xyz.shape[0] * 100, 100.0)
        keep = error < np.percentile(error, percent)
        xyz, rgb = xyz[keep], rgb[keep]

    ply_path = os.path.join(sparse, "points3D.ply")
    try:
        ply.store_point_cloud(ply_path, xyz, rgb)
    except OSError:
        ply_path = os.path.join(path, "points3D.ply")
        ply.store_point_cloud(ply_path, xyz, rgb)

    if random_init:
        bound_near = (z_far - z_near) * 0.01
        bound_far = (z_far - z_near) * 0.30
        bds = get_bds(train, xyz)
        xyz = random_pcd_init(train, near=z_near + bound_near, far=z_far - bound_far,
                              num_pcd=100_000, bds=bds)
        colors = sh_to_rgb(rgb_to_sh(np.ones((xyz.shape[0], 3)) * 0.01, use_sigmoid),
                           use_sigmoid)
        ply_path = os.path.join(os.path.dirname(ply_path), "points3D_random_init.ply")
        ply.store_point_cloud(ply_path, xyz, np.clip(colors * 255, 0, 255))
        pcd = BasicPointCloud(xyz.astype(np.float32), colors.astype(np.float32),
                              np.zeros_like(xyz, dtype=np.float32))
    else:
        pcd = BasicPointCloud(*ply.fetch_point_cloud(ply_path))

    norm = get_nerfpp_norm(train, pcd=None if random_init else pcd)
    return SceneInfo(pcd, train, test, norm, ply_path)


def read_blender_scene(path, white_background=False, eval_split=False,
                       extension=".png") -> SceneInfo:
    """Reference ``readNerfSyntheticInfo`` (``dataset_readers.py:310-392``)."""
    from PIL import Image

    def read_transforms(fname):
        infos = []
        with open(os.path.join(path, fname)) as f:
            contents = json.load(f)
        fovx = contents["camera_angle_x"]
        for idx, frame in enumerate(contents["frames"]):
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # OpenGL → COLMAP axes
            w2c = np.linalg.inv(c2w)
            R = np.transpose(w2c[:3, :3])
            T = w2c[:3, 3]
            image_path = os.path.join(path, frame["file_path"] + extension)
            im = np.array(Image.open(image_path).convert("RGBA")) / 255.0
            bg = np.ones(3) if white_background else np.zeros(3)
            arr = im[:, :, :3] * im[:, :, 3:4] + bg * (1 - im[:, :, 3:4])
            image = Image.fromarray((arr * 255).astype(np.uint8), "RGB")
            fovy = focal2fov(fov2focal(fovx, image.size[0]), image.size[1])
            infos.append(CameraInfo(
                uid=idx, R=R, T=T, FovY=fovy, FovX=fovx, image=image,
                image_path=image_path, image_name=Path(image_path).stem,
                width=image.size[0], height=image.size[1],
            ))
        return infos

    train = read_transforms("transforms_train.json")
    test_file = os.path.join(path, "transforms_test.json")
    test = read_transforms("transforms_test.json") if os.path.exists(test_file) else []
    if not eval_split:
        train, test = train + test, []

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        xyz = random_pcd_init(train, near=2.0, far=8.0, num_pcd=100_000)
        shs = np.random.RandomState(0).random((xyz.shape[0], 3)) / 255.0
        ply.store_point_cloud(ply_path, xyz, np.clip(sh_to_rgb(shs) * 255, 0, 255))
    pcd = BasicPointCloud(*ply.fetch_point_cloud(ply_path))
    return SceneInfo(pcd, train, test, get_nerfpp_norm(train, pcd=None), ply_path)


def load_scene_info(source_path: str, **kwargs) -> SceneInfo:
    """Dataset-type dispatch (reference ``scene/__init__.py:50-56``)."""
    if (os.path.exists(os.path.join(source_path, "sparse"))
            or os.path.exists(os.path.join(source_path, "poses_bounds.npy"))):
        kwargs.pop("white_background", None)
        return read_colmap_scene(source_path, **kwargs)
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        kw = {k: v for k, v in kwargs.items() if k in ("white_background", "eval_split")}
        return read_blender_scene(source_path, **kw)
    raise ValueError(f"Could not recognize scene type at {source_path}")
