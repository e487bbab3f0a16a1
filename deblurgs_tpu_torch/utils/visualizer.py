"""Training observability (reference ``utils/visualization.py``, Visualizer).

Counterpart of ``deblurgs_tpu/utils/visualizer.py``, with the same artifacts:

- ``run(iteration)``: the scene from an auto-found zoom-out camera (binary
  search over the camera distance until every train camera projects inside
  the frame) with each image's sub-frame trajectory drawn as frustum cones
  (``:83-189``), captured at x^1.7-spaced shots; lines through cv2;
- ``visualize_alignment``: a 3×3 grid of the ν shutter positions
  (``:218-253``), drawn with PIL (the JAX package uses matplotlib);
- ``traj_render(iteration)``: blur / sub-frame / error-map PNGs for one
  training view (``:262-291``), written with PIL, the error map through
  ``eval.export.colormap("jet")``;
- ``save_video()``: the overview shots as ``vis/training.mp4`` (or ``.gif``
  where no mp4 writer exists, ``eval.export.make_video``).

Renders run on the state's device; projections and drawing on the host.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from deblurgs_tpu_torch.core.camera import c2w_to_view, make_camera_arrays
from deblurgs_tpu_torch.device import resolve_device
from deblurgs_tpu_torch.models import gaussians as gm
from deblurgs_tpu_torch.models import motion as motion_lib
from deblurgs_tpu_torch.ops.rasterize import render


def _to8(x) -> np.ndarray:
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def _save_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(arr).save(path)


class Visualizer:
    def __init__(self, scene, gcfg, mcfg, rcfg, model_path: str, total_iterations: int,
                 n_shots: int = 200, sh_degree: int | None = None,
                 vis_cam_idx: int | None = None, device="cuda"):
        self.scene = scene
        self.gcfg, self.mcfg, self.rcfg = gcfg, mcfg, rcfg
        self.model_path = model_path
        # reference ``--vis_cam_idx``: focus the overview on this camera's
        # nominal pose instead of the auto zoom-out search (train.py:267)
        self.vis_cam_idx = vis_cam_idx
        self.device = resolve_device(device)
        self.vis_dir = os.path.join(model_path, "vis")
        os.makedirs(self.vis_dir, exist_ok=True)
        # x^1.7-spaced shot schedule (reference ``:76-81``)
        xs = np.linspace(0, 1, n_shots) ** 1.7
        self.shot_iters = sorted(set((xs * total_iterations).astype(int).tolist()))
        self.frames: list = []
        self._vis_cam = None
        self.sh_degree = sh_degree if sh_degree is not None else gcfg.sh_degree
        self.camera_scale = 0.5  # frustum-cone size (reference `:134-135`)
        self._proj = torch.as_tensor(scene.proj, device=self.device)

    def _camera(self, rot, center):
        return make_camera_arrays(
            c2w_to_view(torch.as_tensor(rot, dtype=torch.float32, device=self.device),
                        torch.as_tensor(center, dtype=torch.float32, device=self.device)),
            self._proj)

    # -- zoom-out camera search (reference ``_get_visualization_camera``)
    def _get_vis_camera(self):
        if self._vis_cam is not None:
            return self._vis_cam
        if self.vis_cam_idx is not None:
            i = self.vis_cam_idx
            self._vis_cam = self._camera(self.scene.rotations[i], self.scene.centers[i])
            return self._vis_cam
        centers = np.asarray(self.scene.centers)
        mean_center = centers.mean(axis=0)
        # look along the mean camera forward axis, pulled back until all
        # camera centres project inside the frame
        from deblurgs_tpu_torch.eval.export import c2w_from_eye, mean_camera_pose

        c2ws = np.tile(np.eye(4), (len(centers), 1, 1))
        c2ws[:, :3, :3] = self.scene.rotations
        c2ws[:, :3, 3] = centers
        pivot = mean_camera_pose(c2ws)
        back = pivot[:3, 2]

        lo, hi = 0.1, 100.0
        chosen = None
        for _ in range(20):
            mid = 0.5 * (lo + hi)
            eye = mean_center - back * mid
            c2w = c2w_from_eye(eye, mean_center, pivot[:3, 1])
            cam = self._camera(c2w[:3, :3], c2w[:3, 3])
            _, ok = self._project(cam, centers)
            if ok:
                chosen = cam
                hi = mid
            else:
                lo = mid
        self._vis_cam = chosen or cam
        return self._vis_cam

    def _project(self, cam, pts):
        """Project world points: (pixel uv [n, 2] float32, all in frame)."""
        cs = self.scene.camera_static
        pts = np.asarray(pts, np.float32)
        hom = np.concatenate([pts, np.ones((len(pts), 1), np.float32)], axis=-1)
        clip = hom @ cam.full_proj.cpu().numpy()
        w = clip[:, 3:4] + np.float32(1e-7)
        ndc = clip[:, :2] / w
        u = ((ndc[:, 0] + 1) * cs.width - 1) * np.float32(0.5)
        v = ((ndc[:, 1] + 1) * cs.height - 1) * np.float32(0.5)
        in_frame = bool(np.all((clip[:, 3] > 0) & (u >= 0) & (u < cs.width)
                               & (v >= 0) & (v < cs.height)))
        return np.stack([u, v], -1), in_frame

    def _render(self, state, cam) -> torch.Tensor:
        rin = gm.render_inputs(state.params, self.gcfg)
        return render(rin["means3d"], rin["scales"], rin["rotations"], rin["opacities"],
                      rin["shs"], cam, self.scene.camera_static,
                      torch.zeros(3, device=self.device), cfg=self.rcfg,
                      sh_degree=self.sh_degree, active=state.aux.active).image

    def _nus(self, state) -> torch.Tensor:
        """Every image's sub-frame times [n, f] (no jitter)."""
        idx = torch.arange(state.motion.nu.shape[0], device=self.device)
        return motion_lib.sample_nus(state.motion, idx, self.mcfg)

    def cones(self, state, cam):
        """The frustum cones of every image's sub-frames as seen from
        ``cam``: (image index, pixel corners [5, 2] int) for each cone in
        front of it (reference ``draw_cone_on_render_img``,
        ``visualization.py:137-189``: apex + 4 image-plane corners at
        ±tan(fov/2))."""
        cs = self.scene.camera_static
        cone_local = np.array([
            [0.0, 0.0, 0.0],
            [cs.tanfovx, cs.tanfovy, 1.0],
            [cs.tanfovx, -cs.tanfovy, 1.0],
            [-cs.tanfovx, -cs.tanfovy, 1.0],
            [-cs.tanfovx, cs.tanfovy, 1.0],
        ]) * self.camera_scale                                    # [5, 3]
        n = self.scene.num_train
        with torch.no_grad():
            nu = self._nus(state)
            rots, centers = motion_lib._sample_c2w(
                state.motion, torch.arange(n, device=self.device), nu, self.mcfg)
        rots, centers = rots.cpu().numpy(), centers.cpu().numpy()
        view = cam.view.cpu().numpy()
        out = []
        for i in range(n):
            for r, c in zip(rots[i], centers[i]):
                world = cone_local @ r.T + c                      # [5, 3]
                uv, _ = self._project(cam, world)
                # skip cones behind the viewing camera (reference :176-177)
                hom = np.concatenate([world, np.ones((5, 1))], -1)
                if np.any((hom @ view)[:, 2] < 0.1):
                    continue
                out.append((i, uv.astype(int)))
        return out

    def run(self, iteration: int, state) -> Optional[np.ndarray]:
        """Capture an overview shot if this iteration is scheduled."""
        if iteration not in self.shot_iters:
            return None
        import cv2

        cam = self._get_vis_camera()
        with torch.no_grad():
            img = _to8(self._render(state, cam).cpu().numpy()).copy()
        connectivity = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
        for i, pix in self.cones(state, cam):
            color = tuple(int(c) for c in np.random.RandomState(i).randint(64, 255, 3))
            for a, b in connectivity:
                cv2.line(img, tuple(int(x) for x in pix[a]), tuple(int(x) for x in pix[b]),
                         color, 1)
        cv2.putText(img, f"it {iteration}", (8, 20), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (255, 255, 255), 1)
        self.frames.append(img)
        return img

    def visualize_alignment(self, iteration: int, state) -> str:
        """3×3 grid of each image's ν shutter positions on [0, 1]
        (reference ``visualize_alignment``), 720×720 like the JAX
        package's 9×9-inch figure at 80 dpi."""
        from PIL import Image, ImageDraw

        n = min(9, state.motion.nu.shape[0])
        with torch.no_grad():
            nus = self._nus(state)[:n].cpu().numpy()
        cell = 240
        img = Image.new("RGB", (3 * cell, 3 * cell), "white")
        draw = ImageDraw.Draw(img)
        x0, x1 = 20, cell - 12                  # the axis spans ν ∈ [-0.05, 1.05]
        for i in range(9):
            ox, oy = (i % 3) * cell, (i // 3) * cell
            draw.rectangle([ox + x0, oy + 24, ox + x1, oy + cell - 16], outline="black")
            if i >= n:
                continue
            draw.text((ox + cell // 2 - 18, oy + 6), f"cam {i}", fill="black")
            y = oy + (cell + 8) // 2
            for nu in nus[i]:
                x = ox + x0 + (nu + 0.05) / 1.1 * (x1 - x0)
                draw.ellipse([x - 2, y - 2, x + 2, y + 2], fill=(31, 119, 180))
        path = os.path.join(self.vis_dir, f"alignment_{iteration:06d}.png")
        img.save(path)
        return path

    def traj_render(self, iteration: int, state, cam_idx: int = 0) -> str:
        """Blur / sub-frames / error PNGs for one view (reference
        ``traj_render``)."""
        from deblurgs_tpu_torch.eval.export import colormap

        with torch.no_grad():
            nu = motion_lib.sample_nus(state.motion, [cam_idx], self.mcfg)
            cams = motion_lib.subframe_cameras_batch(state.motion, [cam_idx], nu,
                                                     self._proj, self.mcfg)
            imgs = [self._render(state, type(cams)(*(leaf[i] for leaf in cams)))
                    .cpu().numpy() for i in range(self.mcfg.n_subframes)]
        blur = np.mean(imgs, axis=0)
        gt = self.scene.train_images[cam_idx]
        err = np.abs(blur - gt).mean(-1)

        out_dir = os.path.join(self.vis_dir, f"traj_{iteration:06d}")
        os.makedirs(out_dir, exist_ok=True)
        _save_png(os.path.join(out_dir, "blur.png"), _to8(blur))
        _save_png(os.path.join(out_dir, "gt.png"), _to8(gt))
        _save_png(os.path.join(out_dir, "error.png"), _to8(colormap("jet", np.clip(err * 4, 0, 1))))
        for i in (0, len(imgs) // 2, len(imgs) - 1):
            _save_png(os.path.join(out_dir, f"subframe_{i:02d}.png"), _to8(imgs[i]))
        return out_dir

    def save_video(self) -> Optional[str]:
        """The overview shots as a video; returns the path written."""
        if not self.frames:
            return None
        from deblurgs_tpu_torch.eval.export import make_video

        return make_video(self.frames, os.path.join(self.vis_dir, "training.mp4"), fps=16)
