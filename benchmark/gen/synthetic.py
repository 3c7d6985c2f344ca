"""Frozen copy of the port's synthetic KITTI-like scene generator
(datasets/synthetic.py): the same seed gives the same scenes. Ground plane,
occluded car shells, clutter and weak BEV-click labels in rect
coordinates."""
from __future__ import annotations

from typing import List

import numpy as np

from benchmark.gen.kitti_min import Calibration, KittiScene, Object3d

GROUND_Y = 1.65
CAR_MEAN_HWL = np.array([1.53, 1.63, 3.88], np.float32)
PED_MEAN_HWL = np.array([1.75, 0.62, 0.82], np.float32)
CYC_MEAN_HWL = np.array([1.72, 0.60, 1.76], np.float32)

_XS = np.array([0.5, 0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5])
_ZS = np.array([0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5, 0.5])
_YS = np.array([0.0, 0.0, 0.0, 0.0, -1.0, -1.0, -1.0, -1.0])


def _corners3d_np(b: np.ndarray) -> np.ndarray:
    """Box corners for one (7,) box, in NumPy."""
    h, w, l, ry = b[3], b[4], b[5], b[6]
    x_c, z_c, y_c = l * _XS, w * _ZS, h * _YS
    c, s = np.cos(ry), np.sin(ry)
    xr = c * x_c + s * z_c
    zr = -s * x_c + c * z_c
    return np.stack([xr + b[0], y_c + b[1], zr + b[2]], axis=-1)


def _roof_profile(t: np.ndarray, h: float) -> np.ndarray:
    """Car top height (y offset from the bottom, NEGATIVE = up) as a
    function of normalized length position t = lx / l in [-0.5, 0.5].
    Forward is +t: trunk deck | cabin | windshield slope | hood. The
    fore-aft asymmetry makes ry sign observable from geometry alone."""
    trunk, hood = 0.76 * h, 0.55 * h
    top = np.full_like(t, h, dtype=np.float64)
    top = np.where(t < -0.34, trunk, top)                       # trunk deck
    slope = h + (t - 0.06) / (0.30 - 0.06) * (hood - h)         # windshield
    top = np.where(t >= 0.06, np.maximum(slope, hood), top)
    top = np.where(t >= 0.30, hood, top)                        # hood
    return -top


def _car_surface_points(rng: np.random.RandomState, box: np.ndarray,
                        n: int) -> np.ndarray:
    """Sample points on the asymmetric shell of a car box (7,) bottom-y.
    Local frame: x along length (forward = +x), z along width, y down."""
    x, y, z, h, w, l, ry = box
    face = rng.randint(0, 6, n)   # 0 rear, 1 front, 2/3 sides, 4/5 top
    lx = rng.uniform(-l / 2, l / 2, n)
    lz = rng.uniform(-w / 2, w / 2, n)
    lx = np.where(face == 0, -l / 2, np.where(face == 1, l / 2, lx))
    lz = np.where(face == 2, -w / 2, np.where(face == 3, w / 2, lz))
    roof = _roof_profile(lx / l, h)          # (n,) negative heights
    # sides/front/rear: y uniform between roof(t) and ground (0);
    # top faces: y exactly at roof(t) — the profile IS the asymmetry
    lyy = np.where(face >= 4, roof, rng.rand(n) * (-roof) + roof)
    c, s = np.cos(ry), np.sin(ry)
    pts = np.empty((n, 3), np.float32)
    pts[:, 0] = c * lx + s * lz + x
    pts[:, 1] = lyy + y
    pts[:, 2] = -s * lx + c * lz + z
    pts += rng.randn(n, 3).astype(np.float32) * 0.02
    return pts


def _box_shell_points(rng: np.random.RandomState, box: np.ndarray,
                      n: int) -> np.ndarray:
    """Symmetric box shell (vans, cyclists): 4 sides + roof."""
    x, y, z, h, w, l, ry = box
    lx = rng.uniform(-l / 2, l / 2, n)
    lyy = rng.uniform(-h, 0, n)
    lz = rng.uniform(-w / 2, w / 2, n)
    face = rng.randint(0, 5, n)
    lx = np.where(face == 0, -l / 2, np.where(face == 1, l / 2, lx))
    lz = np.where(face == 2, -w / 2, np.where(face == 3, w / 2, lz))
    lyy = np.where(face == 4, -h, lyy)
    c, s = np.cos(ry), np.sin(ry)
    pts = np.empty((n, 3), np.float32)
    pts[:, 0] = c * lx + s * lz + x
    pts[:, 1] = lyy + y
    pts[:, 2] = -s * lx + c * lz + z
    pts += rng.randn(n, 3).astype(np.float32) * 0.02
    return pts


def _cylinder_points(rng: np.random.RandomState, center_xz, h: float,
                     r: float, n: int, y0: float = GROUND_Y) -> np.ndarray:
    """Vertical cylinder surface (pedestrians, poles)."""
    theta = rng.uniform(0, 2 * np.pi, n)
    pts = np.empty((n, 3), np.float32)
    pts[:, 0] = center_xz[0] + r * np.cos(theta)
    pts[:, 2] = center_xz[1] + r * np.sin(theta)
    pts[:, 1] = y0 - rng.rand(n) * h
    pts += rng.randn(n, 3).astype(np.float32) * 0.02
    return pts


def _ray_blocked(pts: np.ndarray, boxes: np.ndarray,
                 owner: np.ndarray, box_ids: np.ndarray,
                 shrink: float = 1.0, margin: float = 0.06) -> np.ndarray:
    """Which points are shadowed by a solid box between them and the sensor.

    Ray-cast from the origin (sensor at (0,0,0) in rect coords) to each
    point; a point is blocked if the BEV segment enters a box's rotated
    rectangle at parameter t < 1 and the ray height at entry is below the
    box roof. `owner[i] == box_ids[j]` exempts a point from its own box
    (pass shrink < 1 with owner == box to get SELF-occlusion: back-face
    points cross the shrunken body, on-face points do not).

    pts (N,3) rect; boxes (K,7) bottom-y. Returns bool (N,).
    """
    n = pts.shape[0]
    blocked = np.zeros(n, bool)
    if n == 0 or boxes.shape[0] == 0:
        return blocked
    eps = 1e-9
    for j in range(boxes.shape[0]):
        bx, by, bz, h, w, l, ry = boxes[j]
        c, s = np.cos(ry), np.sin(ry)
        # origin and points in the box BEV frame (x along length)
        ox = c * (0 - bx) - s * (0 - bz)
        oz = s * (0 - bx) + c * (0 - bz)
        px = c * (pts[:, 0] - bx) - s * (pts[:, 2] - bz)
        pz = s * (pts[:, 0] - bx) + c * (pts[:, 2] - bz)
        dx, dz = px - ox, pz - oz
        hx, hz = shrink * l / 2, shrink * w / 2
        with np.errstate(divide="ignore", invalid="ignore"):
            t0x = (-hx - ox) / np.where(np.abs(dx) < eps, eps, dx)
            t1x = (hx - ox) / np.where(np.abs(dx) < eps, eps, dx)
            t0z = (-hz - oz) / np.where(np.abs(dz) < eps, eps, dz)
            t1z = (hz - oz) / np.where(np.abs(dz) < eps, eps, dz)
        t_enter = np.maximum(np.minimum(t0x, t1x), np.minimum(t0z, t1z))
        t_exit = np.minimum(np.maximum(t0x, t1x), np.maximum(t0z, t1z))
        hit = (t_enter < t_exit) & (t_exit > 0) & (t_enter < 1.0 - 1e-3)
        # ray height at entry (origin y = 0): below the roof -> blocked
        y_entry = np.clip(t_enter, 0.0, 1.0) * pts[:, 1]
        hit &= y_entry > (by - h) + margin
        hit &= owner != box_ids[j]
        blocked |= hit
    return blocked


def _occlusion_level(frac: float) -> int:
    """KITTI occlusion label from the fraction of returns lost to other
    objects: 0 fully visible / 1 partly / 2 largely occluded."""
    if frac < 0.15:
        return 0
    if frac < 0.55:
        return 1
    return 2


class SyntheticKitti:
    """Deterministic synthetic scene source: `get_scene(i)` mirrors
    KittiRaw.get_scene."""

    def __init__(self, num_scenes: int = 64, max_cars: int = 6,
                 points_per_scene: int = 18000, seed: int = 0,
                 click_noise: float = 0.2, realistic: bool = False):
        """realistic=True additionally exercises the real-data calibration
        paths the identity fixture cannot: non-identity calibration (offset
        principal point, R0 rotation, velodyne axis swap — velodyne bins
        live in the TRUE lidar frame)."""
        self.num_scenes = num_scenes
        self.max_cars = max_cars
        self.points_per_scene = points_per_scene
        self.seed = seed
        self.click_noise = click_noise
        self.realistic = realistic
        self.sample_ids = list(range(num_scenes))
        # scenes are a pure function of (seed, sample_id) — memoize them:
        # training loops call get_scene per sample per step, and the v2
        # ray-cast occlusion makes generation ~20 ms/scene on the single
        # host core (a 96-scene cache is ~30 MB)
        self._cache: dict = {}

    @staticmethod
    def _place(rng, placed_xz, draw, min_gap: float = 6.0, tries: int = 25):
        """Draw (z, x-wedge-halfwidth) via `draw` until the BEV center is at
        least min_gap from every placed object center (6 m > max car
        diagonal ~4.7 m: real KITTI cars never interpenetrate; overlapping
        fixtures created merged point blobs whose NMS kill read as false
        misses). Returns None when the try budget is exhausted — the CALLER
        MUST SKIP the object (round-4 advisor: silently keeping the last
        overlapping draw made the invariant best-effort)."""
        for _ in range(tries):
            z, half = draw()
            x = rng.uniform(-half, half) * z
            if all(np.hypot(x - p[0], z - p[1]) >= min_gap for p in placed_xz):
                return z, x
        return None

    def _place_behind(self, rng, placed_xz, occluder_xz, min_gap: float = 6.0,
                      tries: int = 25):
        """Place a car partially BEHIND an existing one (same azimuth ± a
        small offset, 7-22 m deeper) so inter-object occlusion — and with it
        the moderate/hard difficulty buckets — actually occurs."""
        ox, oz = occluder_xz
        az = np.arctan2(ox, oz)
        for _ in range(tries):
            r = np.hypot(ox, oz) + rng.uniform(7.0, 22.0)
            # offset wide enough that PARTIAL occlusion dominates (a car
            # half-width ~0.8 m subtends ~0.03 rad at 30 m; centered-only
            # placement produced mostly occ=2, starving the occ=1 band)
            a = az + rng.uniform(-0.09, 0.09)
            x, z = r * np.sin(a), r * np.cos(a)
            if z > 68.0 or abs(x / max(z, 1e-3)) > self._wedge:
                continue
            if all(np.hypot(x - p[0], z - p[1]) >= min_gap for p in placed_xz):
                return z, x
        return None

    @property
    def _wedge(self) -> float:
        # keep objects inside the camera FOV (identity calib:
        # u = 700 x/z + 600 in [0, 1242) -> x/z in [-0.857, 0.917));
        # the realistic calib's wedge is narrower
        return 0.55 if self.realistic else 0.75

    def get_scene(self, sample_id: int, with_noise: bool = True) -> KittiScene:
        key = (int(sample_id), bool(with_noise))
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        scene = self._generate(sample_id, with_noise)
        if len(self._cache) < 4096:
            self._cache[key] = scene
        return scene

    def _generate(self, sample_id: int, with_noise: bool) -> KittiScene:
        rng = np.random.RandomState(self.seed * 100003 + sample_id)
        n_cars = rng.randint(1, self.max_cars + 1)

        # --- object placement -------------------------------------------
        boxes: List[np.ndarray] = []
        classes: List[str] = []
        placed_xz: List[np.ndarray] = []

        def near_biased():
            # near-biased depth (sqrt of uniform) like real KITTI — without
            # it the easy bucket (2D height>=40 px needs z<~28 m) is so
            # small the official 41-point AP's thresholds-per-valid-gt cap
            # artificially deflates easy AP
            return 8 + 58 * rng.rand() ** 2, self._wedge

        for k in range(n_cars):
            hwl = CAR_MEAN_HWL * (1 + rng.randn(3) * 0.05)
            cls_name = "Car"
            spot = None
            # deliberately stack some cars behind others: occlusion labels
            # must correspond to actually-shadowed returns, which random
            # independent placement rarely produces
            vehicles = [p for p, c in zip(placed_xz, classes)
                        if c in ("Car", "Van")]
            if vehicles and rng.rand() < 0.45:
                spot = self._place_behind(
                    rng, placed_xz, vehicles[rng.randint(len(vehicles))])
            if spot is None:
                spot = self._place(rng, placed_xz, near_biased)
            if spot is None:
                continue                      # skip: never overlap
            z, x = spot
            if k > 0 and rng.rand() < 0.2:
                cls_name = "Van"
                hwl = hwl * np.array([1.45, 1.15, 1.3], np.float32)
            ry = rng.uniform(-np.pi, np.pi)
            placed_xz.append(np.array([x, z]))
            boxes.append(np.array([x, GROUND_Y, z, *hwl, ry], np.float32))
            classes.append(cls_name)

        # clutter GT: pedestrians and the odd cyclist (FP bait for the Car
        # detector; the AP harness must gate them out by class)
        for _ in range(rng.randint(0, 3)):
            spot = self._place(rng, placed_xz,
                               lambda: (6 + 40 * rng.rand(), self._wedge),
                               min_gap=3.0)
            if spot is None:
                continue
            z, x = spot
            hwl = PED_MEAN_HWL * (1 + rng.randn(3) * 0.06)
            placed_xz.append(np.array([x, z]))
            boxes.append(np.array([x, GROUND_Y, z, *hwl,
                                   rng.uniform(-np.pi, np.pi)], np.float32))
            classes.append("Pedestrian")
        if rng.rand() < 0.3:
            spot = self._place(rng, placed_xz,
                               lambda: (6 + 40 * rng.rand(), self._wedge),
                               min_gap=3.0)
            if spot is not None:
                z, x = spot
                hwl = CYC_MEAN_HWL * (1 + rng.randn(3) * 0.06)
                placed_xz.append(np.array([x, z]))
                boxes.append(np.array([x, GROUND_Y, z, *hwl,
                                       rng.uniform(-np.pi, np.pi)],
                                      np.float32))
                classes.append("Cyclist")

        # --- object returns (distance-scaled density) -------------------
        obj_pts: List[np.ndarray] = []
        obj_owner: List[np.ndarray] = []
        box_arr = (np.stack(boxes) if boxes
                   else np.zeros((0, 7), np.float32))
        box_ids = np.arange(box_arr.shape[0])
        # only solid vehicle bodies occlude; pedestrians/cyclists are thin
        solid = np.array([c in ("Car", "Van") for c in classes], bool)
        for j, (b, cls_name) in enumerate(zip(boxes, classes)):
            z = max(float(b[2]), 4.0)
            if cls_name in ("Car", "Van"):
                n = int(np.clip(9000.0 / z, 80, 620))
                pts = (_car_surface_points(rng, b, n) if cls_name == "Car"
                       else _box_shell_points(rng, b, n))
                # self-occlusion: back-face returns cross the (shrunken)
                # body on the way to the sensor -> removed, like a real
                # one-sided LiDAR scan
                own = np.full(pts.shape[0], -1)
                keep = ~_ray_blocked(pts, b[None], own, np.array([j]),
                                     shrink=0.86)
                pts = pts[keep]
            else:
                n = int(np.clip(2600.0 / z, 30, 160))
                pts = _cylinder_points(rng, (b[0], b[2]), b[3],
                                       0.55 * b[4], n)
            obj_pts.append(pts)
            obj_owner.append(np.full(pts.shape[0], j))

        # --- unlabeled clutter: poles + vegetation blobs -----------------
        clutter: List[np.ndarray] = []
        for _ in range(rng.randint(2, 6)):      # thin poles
            spot = self._place(rng, placed_xz,
                               lambda: (5 + 55 * rng.rand(), self._wedge),
                               min_gap=2.0)
            if spot is None:
                continue
            z, x = spot
            clutter.append(_cylinder_points(
                rng, (x, z), rng.uniform(2.5, 5.0), 0.12,
                max(12, int(900 / z))))
        for _ in range(rng.randint(1, 4)):      # amorphous bushes/walls
            spot = self._place(rng, placed_xz,
                               lambda: (6 + 50 * rng.rand(), self._wedge),
                               min_gap=4.0)
            if spot is None:
                continue
            z, x = spot
            nb = max(40, int(4000 / z))
            sig = rng.uniform(0.3, 1.3, 3)
            blob = np.empty((nb, 3), np.float32)
            blob[:, 0] = x + rng.randn(nb) * sig[0]
            blob[:, 2] = z + rng.randn(nb) * sig[2]
            blob[:, 1] = GROUND_Y - np.abs(rng.randn(nb)) * sig[1]
            clutter.append(blob)

        # --- inter-object occlusion: shadowed returns vanish -------------
        solid_boxes = box_arr[solid]
        solid_ids = box_ids[solid]
        occ_frac = np.zeros(box_arr.shape[0])
        kept_obj: List[np.ndarray] = []
        for j, pts in enumerate(obj_pts):
            own = obj_owner[j]
            blocked = _ray_blocked(pts, solid_boxes, own, solid_ids)
            occ_frac[j] = blocked.mean() if pts.shape[0] else 1.0
            kept_obj.append(pts[~blocked])
        kept_clutter = [c[~_ray_blocked(c, solid_boxes,
                                        np.full(c.shape[0], -1), solid_ids)]
                        for c in clutter]

        # --- ground (generated post-shadow so the point budget holds: the
        # shadows behind vehicles stay empty, like real LiDAR, but the
        # scene still carries ~points_per_scene returns) -------------------
        n_obj = sum(p.shape[0] for p in kept_obj + kept_clutter)
        n_bg = max(self.points_per_scene - n_obj, 0)
        draw = int(n_bg * 1.6) + 64
        ground = np.empty((draw, 3), np.float32)
        gz = rng.uniform(0.5, 70, draw)
        ground[:, 0] = rng.uniform(-self._wedge, self._wedge, draw) * gz
        ground[:, 2] = gz
        ground[:, 1] = GROUND_Y + rng.randn(draw) * 0.05
        ground = ground[~_ray_blocked(ground, solid_boxes,
                                      np.full(draw, -1), solid_ids)][:n_bg]

        pieces = [ground] + kept_clutter + kept_obj
        pts_rect = np.concatenate([p for p in pieces if p.shape[0]], axis=0)
        intensity = rng.rand(pts_rect.shape[0], 1).astype(np.float32)
        calib = (Calibration.realistic() if self.realistic
                 else Calibration.identity())
        pts_vel = (calib.rect_to_lidar(pts_rect) if self.realistic
                   else pts_rect)
        pts_lidar = np.hstack([pts_vel, intensity]).astype(np.float32)

        # --- labels -------------------------------------------------------
        labels: List[Object3d] = []
        noise_labels: List[Object3d] = []
        for j, (b, cls_name) in enumerate(zip(boxes, classes)):
            corners = _corners3d_np(b)
            img_boxes, _ = calib.corners3d_to_img_boxes(corners[None])
            box2d = img_boxes[0].astype(np.float32)
            # KITTI truncation = fraction of the object outside the image
            # (labels derive from the image): compute it from the projected
            # box clipped to the 1242x375 frame, so FOV-edge cars leave the
            # easy bucket exactly as real labels would.
            area = max((box2d[2] - box2d[0]) * (box2d[3] - box2d[1]), 1e-6)
            cw = max(min(box2d[2], 1242.0) - max(box2d[0], 0.0), 0.0)
            ch = max(min(box2d[3], 375.0) - max(box2d[1], 0.0), 0.0)
            trunc = round(1.0 - cw * ch / area, 2)
            occ = _occlusion_level(float(occ_frac[j]))
            obj = Object3d(cls_type=cls_name, trucation=trunc, occlusion=occ,
                           alpha=-np.arctan2(b[0], b[2]) + b[6],
                           box2d=box2d, h=b[3], w=b[4], l=b[5],
                           pos=b[0:3].copy(), ry=b[6])
            labels.append(obj)
            if cls_name in ("Car", "Van"):
                # weak BEV clicks exist only for vehicles (the reference's
                # annotator clicks car centers, annotation.py:150-168)
                nb = b.copy()
                nb[0] += rng.randn() * self.click_noise
                nb[2] += rng.randn() * self.click_noise
                noise_labels.append(Object3d(
                    cls_type=cls_name, trucation=trunc, occlusion=occ,
                    alpha=obj.alpha, box2d=box2d, h=b[3], w=b[4], l=b[5],
                    pos=nb[0:3].copy(), ry=b[6]))
        # DontCare regions: 2D-only ignore boxes (KITTI -1/-1000 fields)
        for _ in range(rng.randint(0, 3)):
            u = rng.uniform(0, 1100)
            v = rng.uniform(120, 250)
            dc2d = np.array([u, v, u + rng.uniform(20, 80),
                             v + rng.uniform(10, 30)], np.float32)
            labels.append(Object3d(
                cls_type="DontCare", trucation=-1.0, occlusion=-1.0,
                alpha=-10.0, box2d=dc2d, h=-1.0, w=-1.0, l=-1.0,
                pos=np.array([-1000.0, -1000.0, -1000.0], np.float32),
                ry=-10.0))

        return KittiScene(sample_id=sample_id, pts_lidar=pts_lidar,
                          calib=calib, image_shape=(375, 1242),
                          labels=labels,
                          noise_labels=noise_labels if with_noise else [])
