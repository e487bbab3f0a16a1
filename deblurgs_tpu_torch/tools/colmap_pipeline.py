"""COLMAP subprocess pipelines (require the ``colmap`` binary on PATH).

Counterpart of ``deblurgs_tpu/tools/colmap_pipeline.py``, the same
functions with the same commands and files. Three drivers, mirroring the
reference's command chains verbatim (SIFT affine-shape + domain-size-pooling flags, loosened mapper thresholds,
CPU SIFT):

- :func:`run_colmap` — field-capture ingestion: frames → features → match →
  map → bundle-adjust → (non-pinhole) undistort (``scripts/run_colmap.py:196-296``);
- :func:`triangulate` — fixed-pose point triangulation to build a COLMAP
  workspace from known cameras (``scripts/triangulation.py:33-150``);
- :func:`initialize_test_pose` — localize pose-less test images against
  *sharp mid-trajectory renders* of the trained scene: render train views,
  triangulate them at the trained poses, then register the test images into
  that model (``test.py:188-398``). The renders run on the session's
  device and are written with PIL.

The database, text-model and mask helpers need no ``colmap`` binary.
"""

from __future__ import annotations

import os
import shutil
import sqlite3
import subprocess

import numpy as np

from deblurgs_tpu_torch.core.camera import fov2focal
from deblurgs_tpu_torch.data import colmap as colmap_io

FLAG_EAS = 1


def colmap_available() -> bool:
    return shutil.which("colmap") is not None


def do_system(cmd: str):
    """Reference ``utils/system_utils.py:31-36`` (raise instead of exit)."""
    print(f"==== running: {cmd}")
    err = subprocess.call(cmd, shell=True)
    if err:
        raise RuntimeError(f"command failed with code {err}: {cmd}")


def _require_colmap():
    if not colmap_available():
        raise RuntimeError(
            "the `colmap` binary is required for this pipeline but was not "
            "found on PATH — install COLMAP or use an llffhold-style dataset "
            "with known test poses")


def read_db_images(db_path: str):
    """(image_id, name) rows in database order (reference ``colmap_reoder.read_db``)."""
    conn = sqlite3.connect(db_path)
    try:
        rows = conn.cursor().execute("SELECT image_id, name FROM images").fetchall()
    finally:
        conn.close()
    return rows


def _feature_extract(db, images, fx, fy, cx, cy, extra=""):
    do_system(
        "colmap feature_extractor "
        f"--database_path {db} --image_path {images} "
        f"--SiftExtraction.estimate_affine_shape {FLAG_EAS} "
        f"--SiftExtraction.domain_size_pooling {FLAG_EAS} "
        "--ImageReader.single_camera 1 "
        "--ImageReader.camera_model PINHOLE "
        "--SiftExtraction.use_gpu 0 "
        f'--ImageReader.camera_params "{fx},{fy},{cx},{cy}" ' + extra)


def _exhaustive_match(db):
    do_system(
        f"colmap exhaustive_matcher --database_path {db} "
        f"--SiftMatching.guided_matching {FLAG_EAS} --SiftMatching.use_gpu 0 ")


def _write_pinhole_intrinsics(sparse_dir, w, h, fx, fy):
    with open(os.path.join(sparse_dir, "cameras.txt"), "w") as fp:
        print("# \n" * 3, end="", file=fp)
        print(f"1 PINHOLE {w} {h} {fx} {fy} {w / 2} {h / 2}", file=fp)
    open(os.path.join(sparse_dir, "points3D.txt"), "w").close()


def _write_extrinsics_db_order(sparse_dir, db, pose_by_name: dict):
    """images.txt in database order (COLMAP requires matching image ids)."""
    with open(os.path.join(sparse_dir, "images.txt"), "w") as fp:
        print("# \n" * 4, end="", file=fp)
        for i, (_, name) in enumerate(read_db_images(db)):
            qvec, tvec = pose_by_name[name]
            q = " ".join(map(str, qvec))
            t = " ".join(map(str, tvec))
            print(f"{i + 1} {q} {t} 1 {name}", end="\n\n", file=fp)


def triangulate_known_poses(workspace, images_dir, pose_by_name: dict,
                            w, h, fx, fy):
    """features → match → point_triangulator at fixed poses.
    Returns the triangulated sparse dir."""
    _require_colmap()
    db = os.path.join(workspace, "database.db")
    sparse_in = os.path.join(workspace, "sparse", "1")
    sparse_out = os.path.join(workspace, "sparse", "2")
    os.makedirs(sparse_in, exist_ok=True)
    os.makedirs(sparse_out, exist_ok=True)

    _feature_extract(db, images_dir, fx, fy, w / 2, h / 2)
    _exhaustive_match(db)
    _write_pinhole_intrinsics(sparse_in, w, h, fx, fy)
    _write_extrinsics_db_order(sparse_in, db, pose_by_name)
    do_system(
        f"colmap point_triangulator --database_path {db} "
        f"--image_path {images_dir} --input_path {sparse_in} "
        f"--output_path {sparse_out}")
    return sparse_out, db


def initialize_test_pose(session, model_path: str,
                         source_path: str | None = None):
    """Register ``<source>/test_images`` against sharp train-view renders.

    Returns a list of CameraInfo with the recovered test poses (empty when
    nothing could be registered). Reference ``test.py:188-398``.
    """
    import torch
    from PIL import Image

    from deblurgs_tpu_torch.data.readers import CameraInfo
    from deblurgs_tpu_torch.eval.export import middle_c2ws, to_uint8
    from deblurgs_tpu_torch.eval.session import render_view
    from deblurgs_tpu_torch.models import motion as motion_lib

    _require_colmap()
    test_dir = os.path.join(source_path, "test_images") if source_path else None
    if not test_dir or not os.path.isdir(test_dir):
        print("No test_images directory detected — cannot register test poses")
        return []

    ws = os.path.join(model_path, "render_colmap")
    shutil.rmtree(ws, ignore_errors=True)
    imgs_dir = os.path.join(ws, "images_rendered")
    os.makedirs(imgs_dir)

    # render sharp mid-trajectory train views
    model = motion_lib.MotionModel(session.mcfg, **session.motion._asdict())
    with torch.no_grad():
        cams = motion_lib.middle_cameras(
            model, torch.as_tensor(session.scene.proj, device=session.device))
    c2ws = middle_c2ws(session)
    pose_by_name = {}
    cs = session.scene.camera_static
    fovx = 2 * np.arctan(cs.tanfovx)
    fovy = 2 * np.arctan(cs.tanfovy)
    fx, fy = fov2focal(fovx, cs.width), fov2focal(fovy, cs.height)
    n = session.scene.num_train
    for i in range(n):
        cam_i = type(cams)(*[leaf[i] for leaf in cams])
        img, _ = render_view(session, cam_i)
        name = f"{i:03d}_render.png"
        Image.fromarray(to_uint8(img)).save(os.path.join(imgs_dir, name))
        w2c = np.linalg.inv(c2ws[i])
        pose_by_name[name] = (colmap_io.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3])

    sparse_pcd, db = triangulate_known_poses(
        ws, imgs_dir, pose_by_name, cs.width, cs.height, fx, fy)

    # add test images to the same database + register
    tmp_test = os.path.join(ws, "test_images")
    os.makedirs(tmp_test)
    for i, fname in enumerate(sorted(os.listdir(test_dir))):
        Image.open(os.path.join(test_dir, fname)).save(
            os.path.join(tmp_test, f"{i:03d}.png"))

    _feature_extract(db, tmp_test, fx, fy, cs.width / 2, cs.height / 2)
    _exhaustive_match(db)

    sparse_final = os.path.join(ws, "sparse", "0")
    os.makedirs(sparse_final, exist_ok=True)
    do_system(f"colmap image_registrator --database_path {db} "
              f"--input_path {sparse_pcd} --output_path {sparse_final}")
    sparse_txt = os.path.join(ws, "sparse_txt")
    os.makedirs(sparse_txt, exist_ok=True)
    do_system(f"colmap model_converter --input_path {sparse_final} "
              f"--output_path {sparse_txt} --output_type TXT")

    # parse registered poses; keep only the (non-render) test images
    registered = colmap_io.read_images_text(
        os.path.join(sparse_txt, "images.txt"))
    infos = []
    for img in registered.values():
        if "render" in img.name:
            continue
        R = colmap_io.qvec2rotmat(img.qvec).T
        infos.append(CameraInfo(
            uid=img.id, R=R, T=np.array(img.tvec),
            FovY=fovy, FovX=fovx,
            image=Image.open(os.path.join(tmp_test, img.name)),
            image_path=os.path.join(tmp_test, img.name),
            image_name=os.path.splitext(img.name)[0],
            width=cs.width, height=cs.height,
        ))
    return sorted(infos, key=lambda c: c.image_name)


def prepare_masks(result_path: str, mask_path: str, reverse: bool = False):
    """Stage user masks for COLMAP feature extraction (reference
    ``move_mask``, ``run_colmap.py:297-339``).

    Copies the mask images verbatim to ``<result>/masks/`` (an archival
    copy, as the reference keeps — training consumes alpha masks only via
    RGBA image files, matching reference ``camera_utils.py:50-57``) and
    derives COLMAP feature-extraction masks in ``<result>/colmap_masks/``:
    the reference keeps features where the user mask is BLACK
    (``sum(mask, -1) == 0`` → 255) and ignores them elsewhere; ``reverse``
    flips that. COLMAP looks the mask up as ``<image filename>.png``, so
    names follow the actual files in ``images/`` (the reference hardcodes
    ``{i:05d}.jpg.png``, which only matches its own jpg writer).

    Masks pair with images by matching filename stem when the stems
    correspond; otherwise they pair by sorted order with a warning (the
    reference pairs by order silently)."""
    import sys

    from PIL import Image

    images_dir = os.path.join(result_path, "images")
    image_names = sorted(os.listdir(images_dir))
    mask_names = sorted(os.listdir(mask_path))
    stem = lambda n: os.path.splitext(n)[0]
    by_stem = {stem(m): m for m in mask_names}
    if all(stem(i) in by_stem for i in image_names) and \
            len(by_stem) == len(mask_names):
        mask_names = [by_stem[stem(i)] for i in image_names]
    elif [stem(m) for m in mask_names] != [stem(i) for i in image_names]:
        print(f"[masks] WARNING: mask filenames in {mask_path} do not "
              f"match image stems in {images_dir}; pairing by sorted "
              "order — verify the correspondence", file=sys.stderr)
    if len(mask_names) != len(image_names):
        raise ValueError(
            f"{len(mask_names)} masks in {mask_path} for "
            f"{len(image_names)} images in {images_dir}")
    mask_write = os.path.join(result_path, "masks")
    colmap_write = os.path.join(result_path, "colmap_masks")
    os.makedirs(mask_write, exist_ok=True)
    os.makedirs(colmap_write, exist_ok=True)
    for img_name, m_name in zip(image_names, mask_names):
        mask_img = Image.open(os.path.join(mask_path, m_name)).convert("RGB")
        mask_img.save(os.path.join(mask_write, m_name))
        with Image.open(os.path.join(images_dir, img_name)) as im:
            w, h = im.size
        arr = np.asarray(mask_img.resize((w, h), Image.NEAREST))
        keep = (arr.sum(axis=-1) == 0).astype(np.uint8) * 255
        if reverse:
            keep = 255 - keep
        Image.fromarray(keep, mode="L").save(
            os.path.join(colmap_write, img_name + ".png"))
    return mask_write, colmap_write


def reorder_images_txt(datadir: str, database_filename: str = "database.db",
                       sparse_dirname: str = "sparse_txt"):
    """Rewrite ``images.txt`` rows in database image-id order (standalone
    equivalent of reference ``utils/colmap_reoder.py``; the original is
    also kept in the old file's location semantics: the unsorted file is
    preserved as ``images_sorted.txt``)."""
    db_path = os.path.join(datadir, database_filename)
    images_txt = os.path.join(datadir, sparse_dirname, "images.txt")
    rows = read_db_images(db_path)                       # [(id, name), ...]
    # COLMAP's images.txt is TWO lines per image: the pose header and a
    # points2D line (possibly empty). Parse them as pairs — keying every
    # non-blank line by its last token would mis-read points lines as
    # headers whenever points2D is non-empty.
    with open(images_txt) as fp:
        lines = fp.read().splitlines()
    body = [l for l in lines if not l.startswith("#")]

    def looks_like_header(line: str) -> bool:
        # IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME — 10 tokens, the
        # first nine numeric (points lines are all-numeric X Y POINT3D_ID
        # triples, so a non-multiple-of-3 numeric prefix + name is a header)
        toks = line.split()
        if len(toks) != 10:
            return False
        try:
            int(toks[0]); int(toks[8])
            [float(t) for t in toks[1:8]]
        except ValueError:
            return False
        return True

    by_name = {}
    i = 0
    while i < len(body):
        if not body[i].strip():                          # stray blank
            i += 1
            continue
        header = body[i]
        nxt = body[i + 1] if i + 1 < len(body) else ""
        # the points2D line may be empty; some hand-made files omit it
        # entirely — only consume the next line when it is not a header
        points = "" if looks_like_header(nxt) else nxt
        by_name[header.split(" ")[-1]] = (header, points)
        i += 1 if looks_like_header(nxt) else 2
    shutil.move(images_txt,
                images_txt.replace("images.txt", "images_sorted.txt"))
    with open(images_txt, "w") as fp:
        for img_id, name in rows:
            entry = by_name.get(name)
            if entry is None:
                continue
            header, points = entry
            _, rest = header.split(" ", 1)
            # keep the two-lines-per-image contract (the reference's
            # colmap_reoder.py writes the trailing newline; our own
            # read_images_text consumes pairs)
            fp.write(f"{img_id} {rest}\n{points}\n")
    return images_txt


def run_colmap(result_path: str, camera_model: str = "OPENCV",
               matcher: str = "exhaustive", focal_length: float | None = None,
               refine_extra: bool | None = None):
    """Field-capture reconstruction (reference ``run_colmap`` command chain
    with its loosened mapper thresholds). If ``<result>/colmap_masks/``
    exists (see :func:`prepare_masks`) it feeds feature extraction
    (reference ``run_colmap.py:220-221``)."""
    _require_colmap()
    db = os.path.join(result_path, "database.db")
    images = os.path.join(result_path, "images")
    sparse = os.path.join(result_path, "sparse")
    text = os.path.join(result_path, "sparse_txt")
    mask = os.path.join(result_path, "colmap_masks")
    if os.path.exists(db):
        os.remove(db)

    refine_focal = int(focal_length is None)
    refine_extra = int("PINHOLE" not in camera_model
                       if refine_extra is None else refine_extra)
    extract_extra = "--SiftExtraction.max_num_features 8192 "
    if os.path.isdir(mask):
        extract_extra += f"--ImageReader.mask_path {mask} "
    do_system(
        "colmap feature_extractor "
        f"--ImageReader.camera_model {camera_model} "
        f"--SiftExtraction.estimate_affine_shape {FLAG_EAS} "
        f"--SiftExtraction.domain_size_pooling {FLAG_EAS} "
        "--ImageReader.single_camera 1 "
        f"--database_path {db} --image_path {images} "
        "--SiftExtraction.use_gpu 0 " + extract_extra)
    do_system(f"colmap {matcher}_matcher --SiftMatching.guided_matching "
              f"{FLAG_EAS} --database_path {db} --SiftMatching.use_gpu 0")
    shutil.rmtree(sparse, ignore_errors=True)
    os.makedirs(sparse)
    do_system(
        f"colmap mapper --database_path {db} --image_path {images} "
        f"--output_path {sparse} "
        "--Mapper.abs_pose_max_error 20 --Mapper.init_max_error 12 "
        "--Mapper.filter_max_reproj_error 8 --Mapper.init_max_reg_trials 5 "
        "--Mapper.max_reg_trials 5 --Mapper.min_num_matches 5 "
        "--Mapper.init_min_num_inliers 30 --Mapper.abs_pose_min_num_inliers 15 "
        "--Mapper.abs_pose_min_inlier_ratio 0.12 "
        "--Mapper.tri_ignore_two_view_tracks 1 "
        "--Mapper.ba_local_max_num_iterations 100 "
        "--Mapper.ba_global_max_num_iterations 100 "
        f"--Mapper.ba_refine_focal_length {refine_focal} "
        "--Mapper.ba_refine_principal_point 0 "
        f"--Mapper.ba_refine_extra_params {refine_extra} ")
    do_system(
        f"colmap bundle_adjuster --input_path {sparse}/0 "
        f"--output_path {sparse}/0 "
        "--BundleAdjustment.refine_principal_point 0 "
        f"--BundleAdjustment.refine_extra_params {refine_extra} "
        f"--BundleAdjustment.refine_focal_length {refine_focal}")

    if "PINHOLE" not in camera_model:
        dense = os.path.join(result_path, "dense")
        os.makedirs(dense, exist_ok=True)
        do_system(f"colmap image_undistorter --image_path {images} "
                  f"--input_path {sparse}/0 --output_path {dense}")
        shutil.rmtree(images)
        shutil.rmtree(sparse)
        os.makedirs(sparse)
        shutil.move(os.path.join(dense, "images"), images)
        shutil.move(os.path.join(dense, "sparse"), os.path.join(sparse, "0"))
        shutil.rmtree(dense, ignore_errors=True)

    shutil.rmtree(text, ignore_errors=True)
    os.makedirs(text)
    do_system(f"colmap model_converter --input_path {sparse}/0 "
              f"--output_path {text} --output_type TXT")


def extract_video_frames(video_path: str, out_dir: str, downsample: int = 1,
                         clip=(0.0, 1.0), resize: float = 1.0):
    """Video → frame PNGs (reference ``run_colmap.get_images`` via cv2)."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    lo, hi = int(total * clip[0]), int(total * clip[1])
    idx = out_i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if lo <= idx < hi and (idx - lo) % downsample == 0:
            if resize != 1.0:
                frame = cv2.resize(frame, None, fx=resize, fy=resize)
            cv2.imwrite(os.path.join(out_dir, f"{out_i:05d}.png"), frame)
            out_i += 1
        idx += 1
    cap.release()
    return out_i
