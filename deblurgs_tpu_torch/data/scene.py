"""Scene assembly: a dataset as host arrays plus the session's camera.

Counterpart of ``deblurgs_tpu/data/scene.py`` (reference ``scene/__init__.py``
class Scene + ``utils/camera_utils.py``): dataset-type dispatch, the model
dir's ``input.ply`` and ``cameras.json``, the resolution policy, the
training images stacked into one [n, H, W, 3] float32 array, the
epoch-style shuffled camera iterator and ``search_max_iteration``.
Everything here is numpy on the host; callers move what they render with
to the device.
"""

from __future__ import annotations

import json
import math
import os
import random
import re
import shutil

import numpy as np

from deblurgs_tpu_torch.core.camera import CameraStatic, fov2focal, get_projection_matrix
from deblurgs_tpu_torch.data.readers import SceneInfo, load_scene_info


def resolve_resolution(orig_w: int, orig_h: int, resolution: int,
                       resolution_scale: float = 1.0):
    """Reference ``loadCam`` policy (``camera_utils.py:21-58``): a divisor
    in {1, 2, 4, 8}, a target width, or -1: downscale to 1,600 px wide when
    wider."""
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def load_image(cam_info, resolution: int, resolution_scale: float = 1.0) -> np.ndarray:
    """PIL → float32 [H, W, 3] in [0, 1], alpha multiplied in (reference
    ``loadCam``)."""
    w, h = resolve_resolution(cam_info.width, cam_info.height, resolution, resolution_scale)
    arr = np.asarray(cam_info.image.resize((w, h)), dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, axis=-1)
    if arr.shape[-1] == 4:
        arr = arr[..., :3] * arr[..., 3:4]
    return np.clip(arr[..., :3], 0.0, 1.0)


def camera_to_json(uid, cam_info):
    """Reference ``camera_to_JSON`` (``camera_utils.py:68-88``)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = cam_info.R.transpose()
    Rt[:3, 3] = cam_info.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    return {
        "id": uid,
        "img_name": cam_info.image_name,
        "width": cam_info.width,
        "height": cam_info.height,
        "position": W2C[:3, 3].tolist(),
        "rotation": [r.tolist() for r in W2C[:3, :3]],
        "fy": fov2focal(cam_info.FovY, cam_info.height),
        "fx": fov2focal(cam_info.FovX, cam_info.width),
    }


class Scene:
    """Host-side scene session: numpy training data and camera metadata.
    ``znear=0.01, zfar=100`` as the reference ``Camera`` (``cameras.py:51-52``);
    ``proj`` is the row-vector projection as a float32 numpy array."""

    def __init__(self, source_path: str, model_path: str | None = None, *,
                 images: str = "images", resolution: int = -1,
                 eval_split: bool = False, llffhold: int = 0,
                 num_initial_pcd: int = -1, random_init: bool = False,
                 white_background: bool = False,
                 z_near: float = 0.2, z_far: float = 100.0,
                 use_sigmoid: bool = False, shuffle: bool = True, seed: int = 0,
                 load_indices=None):
        self.model_path = model_path
        self.white_background = white_background
        self.info: SceneInfo = load_scene_info(
            source_path, images=images, eval_split=eval_split,
            llffhold=llffhold, num_initial_pcd=num_initial_pcd,
            random_init=random_init, z_near=z_near, z_far=z_far,
            use_sigmoid=use_sigmoid, white_background=white_background,
        )
        self.cameras_extent = self.info.nerf_normalization["radius"]

        if model_path:
            os.makedirs(model_path, exist_ok=True)
            shutil.copyfile(self.info.ply_path, os.path.join(model_path, "input.ply"))
            cams = list(self.info.test_cameras) + list(self.info.train_cameras)
            with open(os.path.join(model_path, "cameras.json"), "w") as f:
                json.dump([camera_to_json(i, c) for i, c in enumerate(cams)], f)

        # a rank of a multi-process run decodes only its own images
        # (parallel/multihost.py host_local_camera_split); the other rows
        # stay zero and are never read on this rank
        first = load_image(self.info.train_cameras[0], resolution)
        n_train = len(self.info.train_cameras)
        self.train_images = np.zeros((n_train,) + first.shape, first.dtype)
        for i in range(n_train) if load_indices is None else load_indices:
            self.train_images[i] = (first if i == 0 else
                                    load_image(self.info.train_cameras[i], resolution))
        self.height, self.width = self.train_images.shape[1:3]

        c0 = self.info.train_cameras[0]
        self.camera_static = CameraStatic(
            width=self.width, height=self.height,
            tanfovx=math.tan(c0.FovX * 0.5), tanfovy=math.tan(c0.FovY * 0.5),
            znear=0.01, zfar=100.0,
        )
        self.proj = get_projection_matrix(0.01, 100.0, c0.FovX, c0.FovY, device="cpu").numpy()

        # c2w rotations and camera centres, for the motion model's init
        self.rotations = np.stack([c.R for c in self.info.train_cameras])
        self.centers = np.stack([-c.T @ c.R.T for c in self.info.train_cameras])

        self._rng = random.Random(seed)
        self._order: list[int] = []
        self.shuffle = shuffle

    @property
    def num_train(self) -> int:
        return len(self.info.train_cameras)

    def get_random_cam_idx(self) -> int:
        """Epoch-style shuffled iterator (reference ``scene/__init__.py:120-129``)."""
        if not self._order:
            self._order = list(range(self.num_train))
            if self.shuffle:
                self._rng.shuffle(self._order)
        return self._order.pop()

    def point_cloud_dir(self, iteration: int) -> str:
        return os.path.join(self.model_path, "point_cloud", f"iteration_{iteration}")

    @staticmethod
    def search_max_iteration(point_cloud_dir: str) -> int:
        """Reference ``searchForMaxIteration`` (``system_utils.py:27-29``)."""
        return max(int(re.sub(r"[^0-9]", "", f)) for f in os.listdir(point_cloud_dir))
