"""KITTI raw-file IO for the host data path: calibration, label lines, the
KITTI txt writer, the on-disk object-split reader and writer, and the
annotator's click-file bridge. NumPy copy of ws3d_tpu/datasets/kitti_io.py
(the same matrix conventions: P2 / R0 / Tr_velo2cam, rect camera
coordinates x right, y down, z forward; the same label line format), so the
port reads and writes the same files as the JAX package."""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ws3d_tpu_torch.utils.profiling import span

CLASS_IDS = {"Car": 1, "Pedestrian": 2, "Cyclist": 3, "Van": 4}


def cls_type_to_id(cls_type: str) -> int:
    return CLASS_IDS.get(cls_type, -1)


class Calibration:
    """KITTI calibration: lidar -> rect and rect -> image projections."""

    def __init__(self, P2: np.ndarray, R0: np.ndarray, V2C: np.ndarray):
        self.P2 = P2.astype(np.float32)          # (3, 4)
        self.R0 = R0.astype(np.float32)          # (3, 3)
        self.V2C = V2C.astype(np.float32)        # (3, 4)
        self.cu, self.cv = self.P2[0, 2], self.P2[1, 2]
        self.fu, self.fv = self.P2[0, 0], self.P2[1, 1]
        self.tx = self.P2[0, 3] / (-self.fu)
        self.ty = self.P2[1, 3] / (-self.fv)

    @classmethod
    def from_file(cls, path: str) -> "Calibration":
        with open(path) as f:
            lines = f.readlines()
        vals = {}
        for line in lines:
            if ":" in line:
                key, _, rest = line.partition(":")
                vals[key.strip()] = np.array(rest.split(), dtype=np.float32)
        return cls(vals["P2"].reshape(3, 4),
                   vals["R0_rect"].reshape(3, 3) if "R0_rect" in vals
                   else vals["R0"].reshape(3, 3),
                   vals["Tr_velo_to_cam"].reshape(3, 4) if "Tr_velo_to_cam" in vals
                   else vals["Tr_velo2cam"].reshape(3, 4))

    @classmethod
    def identity(cls, fu: float = 700.0, cu: float = 600.0,
                 cv: float = 180.0) -> "Calibration":
        """A synthetic camera: rect == lidar frame."""
        P2 = np.array([[fu, 0, cu, 0], [0, fu, cv, 0], [0, 0, 1, 0]],
                      np.float32)
        return cls(P2, np.eye(3, dtype=np.float32),
                   np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32))

    @classmethod
    def realistic(cls) -> "Calibration":
        """Real-KITTI-style calibration (the public devkit example values):
        offset principal point, camera baseline in P2[:, 3], a non-identity
        R0 rectification rotation and the velodyne->camera axis swap."""
        P2 = np.array([[721.5377, 0.0, 609.5593, 44.85728],
                       [0.0, 721.5377, 172.854, 0.2163791],
                       [0.0, 0.0, 1.0, 0.002745884]], np.float32)
        R0 = np.array([[0.9999239, 0.00983776, -0.007445048],
                       [-0.009869795, 0.9999421, -0.004278459],
                       [0.007402527, 0.004351614, 0.9999631]], np.float32)
        V2C = np.array([[0.007533745, -0.9999714, -0.000616602, -0.004069766],
                        [0.01480249, 0.000728073, -0.9998902, -0.07631618],
                        [0.9998621, 0.00752379, 0.01480755, -0.2717806]],
                       np.float32)
        return cls(P2, R0, V2C)

    def rect_to_lidar(self, pts_rect: np.ndarray) -> np.ndarray:
        """Inverse of lidar_to_rect."""
        cam = pts_rect @ np.linalg.inv(self.R0).T
        R, t = self.V2C[:, :3], self.V2C[:, 3]
        return (cam - t) @ np.linalg.inv(R).T

    @staticmethod
    def _hom(pts: np.ndarray) -> np.ndarray:
        return np.hstack((pts, np.ones((pts.shape[0], 1), dtype=np.float32)))

    def lidar_to_rect(self, pts_lidar: np.ndarray) -> np.ndarray:
        return self._hom(pts_lidar) @ (self.V2C.T @ self.R0.T)

    def rect_to_img(self, pts_rect: np.ndarray):
        hom = self._hom(pts_rect) @ self.P2.T
        img = hom[:, 0:2] / hom[:, 2:3]
        depth = hom[:, 2] - self.P2.T[3, 2]
        return img, depth

    def lidar_to_img(self, pts_lidar: np.ndarray):
        return self.rect_to_img(self.lidar_to_rect(pts_lidar))

    def img_to_rect(self, u: np.ndarray, v: np.ndarray,
                    depth_rect: np.ndarray) -> np.ndarray:
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return np.stack([x, y, depth_rect], axis=1).astype(np.float32)

    def corners3d_to_img_boxes(self, corners3d: np.ndarray):
        """(N, 8, 3) rect corners -> ((N, 4) [x1 y1 x2 y2], (N, 8, 2))."""
        n = corners3d.shape[0]
        hom = np.concatenate([corners3d, np.ones((n, 8, 1))], axis=2)
        pts = hom @ self.P2.T
        x = pts[:, :, 0] / pts[:, :, 2]
        y = pts[:, :, 1] / pts[:, :, 2]
        boxes = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
        return boxes, np.stack([x, y], axis=2)


@dataclass
class Object3d:
    """One KITTI label line."""
    cls_type: str
    trucation: float
    occlusion: float
    alpha: float
    box2d: np.ndarray            # (4,) x1 y1 x2 y2
    h: float
    w: float
    l: float
    pos: np.ndarray              # (3,) rect coords, bottom-center
    ry: float
    score: float = -1.0

    @property
    def cls_id(self) -> int:
        return cls_type_to_id(self.cls_type)

    @property
    def level(self) -> int:
        """KITTI difficulty: 1 easy / 2 moderate / 3 hard / 4 unknown."""
        height = float(self.box2d[3]) - float(self.box2d[1]) + 1
        if height >= 40 and self.trucation <= 0.15 and self.occlusion <= 0:
            return 1
        if height >= 25 and self.trucation <= 0.3 and self.occlusion <= 1:
            return 2
        if height >= 25 and self.trucation <= 0.5 and self.occlusion <= 2:
            return 3
        return 4

    @classmethod
    def from_line(cls, line: str) -> "Object3d":
        lab = line.strip().split(" ")
        return cls(cls_type=lab[0], trucation=float(lab[1]),
                   occlusion=float(lab[2]), alpha=float(lab[3]),
                   box2d=np.array(lab[4:8], dtype=np.float32),
                   h=float(lab[8]), w=float(lab[9]), l=float(lab[10]),
                   pos=np.array(lab[11:14], dtype=np.float32),
                   ry=float(lab[14]),
                   score=float(lab[15]) if len(lab) == 16 else -1.0)

    def to_box3d(self) -> np.ndarray:
        """-> (7,) [x, y, z, h, w, l, ry] bottom-y."""
        return np.array([*self.pos, self.h, self.w, self.l, self.ry],
                        dtype=np.float32)

    def to_kitti_line(self) -> str:
        vals = (self.cls_type, self.trucation, int(self.occlusion), self.alpha,
                *self.box2d, self.h, self.w, self.l, *self.pos, self.ry)
        s = ("%s %.2f %d %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f "
             "%.2f %.2f") % vals
        if self.score >= 0:
            s += " %.4f" % self.score
        return s


def get_objects_from_label(path: str) -> List[Object3d]:
    with open(path) as f:
        return [Object3d.from_line(line) for line in f if line.strip()]


def objs_to_boxes3d(objs: List[Object3d]) -> np.ndarray:
    if not objs:
        return np.zeros((0, 7), dtype=np.float32)
    return np.stack([o.to_box3d() for o in objs])


def boxes3d_to_corners3d_np(boxes3d: np.ndarray) -> np.ndarray:
    """(N, 7) (x, y, z, h, w, l, ry) bottom-y -> (N, 8, 3) corners: the
    NumPy twin of ops.boxes.boxes3d_to_corners3d for the host-side
    writers."""
    x, y, z = boxes3d[:, 0:1], boxes3d[:, 1:2], boxes3d[:, 2:3]
    h, w, l, ry = (boxes3d[:, 3:4], boxes3d[:, 4:5], boxes3d[:, 5:6],
                   boxes3d[:, 6])
    xs = np.array([0.5, 0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5]) * l
    zs = np.array([0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5, 0.5]) * w
    ys = np.array([0.0, 0.0, 0.0, 0.0, -1.0, -1.0, -1.0, -1.0]) * h
    c, s = np.cos(ry)[:, None], np.sin(ry)[:, None]
    xr = xs * c + zs * s + x
    zr = -xs * s + zs * c + z
    return np.stack([xr, ys + y, zr], axis=-1).astype(np.float32)


@span("kitti_io.save")
def save_kitti_format(sample_id, calib, bbox3d, out_dir, scores, img_shape,
                      classes="Car"):
    """KITTI txt writer: project the corners, clip them to the image and
    drop boxes covering more than 80 % of it; one %06d.txt a sample, empty
    when there is no box. Writes the same bytes as the JAX package's
    writer for the same inputs."""
    import math
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "%06d.txt" % sample_id)
    bbox3d = np.asarray(bbox3d)
    if bbox3d.shape[0] == 0:
        open(path, "w").close()
        return
    corners = boxes3d_to_corners3d_np(bbox3d)
    img_boxes, _ = calib.corners3d_to_img_boxes(corners)
    img_boxes[:, [0, 2]] = np.clip(img_boxes[:, [0, 2]], 0, img_shape[1] - 1)
    img_boxes[:, [1, 3]] = np.clip(img_boxes[:, [1, 3]], 0, img_shape[0] - 1)
    w = img_boxes[:, 2] - img_boxes[:, 0]
    h = img_boxes[:, 3] - img_boxes[:, 1]
    ok = (w < img_shape[1] * 0.8) & (h < img_shape[0] * 0.8)
    with open(path, "w") as f:
        for k in range(bbox3d.shape[0]):
            if not ok[k]:
                continue
            x, z, ry = bbox3d[k, 0], bbox3d[k, 2], bbox3d[k, 6]
            beta = math.atan2(z, x)
            alpha = -np.sign(beta) * np.pi / 2 + beta + ry
            print("%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f "
                  "%.4f %.4f %.4f %.4f"
                  % (classes, alpha, img_boxes[k, 0], img_boxes[k, 1],
                     img_boxes[k, 2], img_boxes[k, 3], bbox3d[k, 3],
                     bbox3d[k, 4], bbox3d[k, 5], bbox3d[k, 0], bbox3d[k, 1],
                     bbox3d[k, 2], bbox3d[k, 6], scores[k]), file=f)


@dataclass
class KittiScene:
    """Everything loaded for one frame."""
    sample_id: int
    pts_lidar: np.ndarray                      # (N, 4) x y z intensity
    calib: Calibration
    image_shape: tuple                         # (H, W)
    labels: List[Object3d] = field(default_factory=list)
    noise_labels: List[Object3d] = field(default_factory=list)  # weak clicks

    @property
    def pts_rect(self) -> np.ndarray:
        return self.calib.lidar_to_rect(self.pts_lidar[:, 0:3])

    @property
    def pts_intensity(self) -> np.ndarray:
        return self.pts_lidar[:, 3]


class KittiRaw:
    """Filesystem reader for a KITTI object split:
    root/object/{training,testing}/{velodyne,calib,label_2,<noise_dir>,image_2}
    and root/ImageSets/<split>.txt."""

    def __init__(self, root_dir: str, split: str = "train",
                 noise_dir: Optional[str] = "label_noise"):
        self.split = split
        is_test = split == "test"
        self.imageset_dir = os.path.join(root_dir, "object",
                                         "testing" if is_test else "training")
        split_file = os.path.join(root_dir, "ImageSets", split + ".txt")
        if os.path.exists(split_file):
            with open(split_file) as f:
                self.sample_ids = [int(x) for x in f.read().splitlines() if x]
        else:
            self.sample_ids = []
        self.noise_dir = noise_dir

    def _path(self, sub: str, sample_id: int, ext: str) -> str:
        return os.path.join(self.imageset_dir, sub, "%06d%s" % (sample_id, ext))

    def get_lidar(self, sample_id: int) -> np.ndarray:
        return np.fromfile(self._path("velodyne", sample_id, ".bin"),
                           dtype=np.float32).reshape(-1, 4)

    def get_calib(self, sample_id: int) -> Calibration:
        return Calibration.from_file(self._path("calib", sample_id, ".txt"))

    def get_label(self, sample_id: int) -> List[Object3d]:
        return get_objects_from_label(self._path("label_2", sample_id, ".txt"))

    def get_noise_label(self, sample_id: int) -> List[Object3d]:
        if not self.noise_dir:
            raise ValueError("KittiRaw has no noise_dir")
        return get_objects_from_label(
            self._path(self.noise_dir, sample_id, ".txt"))

    def get_image_shape(self, sample_id: int) -> tuple:
        path = self._path("image_2", sample_id, ".png")
        if os.path.exists(path):
            try:
                from PIL import Image
                with Image.open(path) as im:
                    w, h = im.size
                return h, w
            except ImportError:
                pass
        return (375, 1242)   # canonical KITTI size fallback

    def get_scene(self, sample_id: int, with_noise: bool = False) -> KittiScene:
        labels = []
        label_path = self._path("label_2", sample_id, ".txt")
        if os.path.exists(label_path):
            labels = get_objects_from_label(label_path)
        noise = []
        if with_noise and self.noise_dir:
            npath = self._path(self.noise_dir, sample_id, ".txt")
            if os.path.exists(npath):
                noise = get_objects_from_label(npath)
        return KittiScene(sample_id=sample_id,
                          pts_lidar=self.get_lidar(sample_id),
                          calib=self.get_calib(sample_id),
                          image_shape=self.get_image_shape(sample_id),
                          labels=labels, noise_labels=noise)


def clicks_to_noise_labels(label_w_path: str, out_dir: str,
                           mean_hwl=(1.53, 1.63, 3.88),
                           ground_y: float = 1.65,
                           sample_ids=None):
    """Bridge from the annotator's ``label_w/label.txt`` 5-tuple lines
    (``sample_id x z gt_x gt_z``) to the KITTI-format ``label_noise``
    directory the datasets train from.

    Only x/z are meaningful in weak labels; y, dims and ry are filled with
    the ground level and the Car mean size. Writes one ``%06d.txt`` per
    sample id (ids listed in `sample_ids` but absent from the click file
    get an empty file). Returns {sample_id: click_count}.
    """
    os.makedirs(out_dir, exist_ok=True)
    per_sample = {}
    with open(label_w_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            sid = int(parts[0])
            x, z = float(parts[1]), float(parts[2])
            per_sample.setdefault(sid, []).append((x, z))
    for sid in set(per_sample) | set(sample_ids or []):
        clicks = per_sample.get(sid, [])
        with open(os.path.join(out_dir, "%06d.txt" % sid), "w") as f:
            for x, z in clicks:
                obj = Object3d(
                    cls_type="Car", trucation=0.0, occlusion=0.0,
                    alpha=-10.0,
                    box2d=np.array([0, 0, 50, 50], np.float32),
                    h=float(mean_hwl[0]), w=float(mean_hwl[1]),
                    l=float(mean_hwl[2]),
                    pos=np.array([x, ground_y, z], np.float32), ry=0.0)
                f.write(obj.to_kitti_line() + "\n")
    return {sid: len(per_sample.get(sid, [])) for sid
            in set(per_sample) | set(sample_ids or [])}


def write_kitti_tree(root: str, scenes, split: str = "train",
                     write_noise: bool = True,
                     extra_splits=()) -> None:
    """Write scenes in the on-disk KITTI object layout KittiRaw reads:
    object/training/{velodyne (N, 4) float32 bins, calib txt, label_2,
    label_noise} and ImageSets/<split>.txt (plus each of `extra_splits`,
    (name, sample ids) pairs)."""
    base = os.path.join(root, "object", "training")
    subs = ["velodyne", "calib", "label_2"] + (
        ["label_noise"] if write_noise else [])
    for sub in subs:
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
    ids = []
    for scene in scenes:
        sid = scene.sample_id
        ids.append("%06d" % sid)
        scene.pts_lidar.astype(np.float32).tofile(
            os.path.join(base, "velodyne", "%06d.bin" % sid))
        P2 = scene.calib.P2.reshape(-1)
        R0 = scene.calib.R0.reshape(-1)
        V2C = scene.calib.V2C.reshape(-1)
        with open(os.path.join(base, "calib", "%06d.txt" % sid), "w") as f:
            f.write("P0: " + " ".join(["0"] * 12) + "\n")
            f.write("P1: " + " ".join(["0"] * 12) + "\n")
            f.write("P2: " + " ".join("%.6f" % v for v in P2) + "\n")
            f.write("P3: " + " ".join(["0"] * 12) + "\n")
            f.write("R0_rect: " + " ".join("%.6f" % v for v in R0) + "\n")
            f.write("Tr_velo_to_cam: "
                    + " ".join("%.6f" % v for v in V2C) + "\n")
        pairs = [("label_2", scene.labels)]
        if write_noise:
            pairs.append(("label_noise", scene.noise_labels))
        for sub, objs in pairs:
            with open(os.path.join(base, sub, "%06d.txt" % sid), "w") as f:
                for o in objs:
                    f.write(o.to_kitti_line() + "\n")
    with open(os.path.join(root, "ImageSets", split + ".txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    for name, sel in extra_splits:
        with open(os.path.join(root, "ImageSets", name + ".txt"), "w") as f:
            f.write("\n".join("%06d" % s for s in sel) + "\n")
