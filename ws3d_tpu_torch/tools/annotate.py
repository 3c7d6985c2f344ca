"""BEV click annotation tool on the port (the flow of tools/annotate.py).

    python -m ws3d_tpu_torch.tools.annotate --synthetic --headless \\
        --scenes 2 --to_noise --output_dir out

The interactive mode (matplotlib, with a display) shows the camera image,
a zoomed BEV pane and the global BEV: a click on the image seeds the zoom
at the nearest projected point, a click on the BEV records a weak centre
label. --headless (or no DISPLAY) simulates the annotator from the ground
truth: one BEV click per Car/Van with 0.3 m Gaussian jitter, seeded by
--seed. A click is kept when it lands within 3 m of a ground-truth centre;
kept clicks go to OUTPUT_DIR/label_w/label.txt as `sample_id x z gt_x
gt_z`, and --to_noise converts them into the KITTI-format
OUTPUT_DIR/label_noise/ directory the loaders train from. Host only: no
model, no device.
"""
from __future__ import annotations

import os
import sys

import numpy as np

from ws3d_tpu_torch.datasets.kitti_io import (clicks_to_noise_labels,
                                              objs_to_boxes3d)
from ws3d_tpu_torch.tools.train_rpn import (base_parser, close_log,
                                            make_scene_source, setup)


class AnnotationSession:
    """Click state and label writing, apart from any UI."""

    def __init__(self, out_dir: str, accept_radius: float = 3.0):
        self.out_dir = out_dir
        self.accept_radius = accept_radius
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "label.txt")
        self.records = []

    def click(self, sample_id: int, x: float, z: float,
              gt_centers: np.ndarray):
        """Record a BEV click when it lies within accept_radius of a
        ground-truth centre; returns the record or None."""
        if gt_centers.shape[0] == 0:
            return None
        d = np.hypot(gt_centers[:, 0] - x, gt_centers[:, 2] - z)
        j = int(d.argmin())
        if d[j] > self.accept_radius:
            return None
        rec = (sample_id, x, z, float(gt_centers[j, 0]),
               float(gt_centers[j, 2]))
        self.records.append(rec)
        return rec

    def flush(self) -> int:
        with open(self.path, "a") as f:
            for r in self.records:
                f.write("%06d %.4f %.4f %.4f %.4f\n" % r)
        n = len(self.records)
        self.records = []
        return n


def nearest_projected_point(pts_image: np.ndarray, img_x: float,
                            img_y: float) -> int:
    """Image click -> index of the nearest projected point (L1 in image
    space)."""
    d = (np.abs(pts_image[:, 0] - img_x)
         + np.abs(pts_image[:, 1] - img_y))
    return int(np.argmin(d))


def load_scene_image(args, sid):
    """The camera image of a KITTI tree's scene, None for synthetic scenes
    or a missing file (the pane then shows the projected points)."""
    if args.synthetic or not args.data_root:
        return None
    path = os.path.join(args.data_root, "object", "training", "image_2",
                        "%06d.png" % sid)
    if not os.path.isfile(path):
        return None
    from PIL import Image
    return np.asarray(Image.open(path))


def _car_boxes(scene) -> np.ndarray:
    return objs_to_boxes3d([o for o in scene.labels
                            if o.cls_type in ("Car", "Van")])


def _to_noise(args, src, session, log) -> None:
    counts = clicks_to_noise_labels(
        session.path, os.path.join(args.output_dir, "label_noise"),
        sample_ids=list(src.sample_ids[: args.scenes]))
    log.info("label_noise dir written (%d scenes, %d clicks)",
             len(counts), sum(counts.values()))


def run_headless(args, log) -> None:
    """Simulate an annotator: an image click on each object's projection
    seeds the zoom at the nearest projected point in front of the camera,
    then one jittered BEV click per ground-truth centre."""
    rng = np.random.RandomState(args.seed)
    src = make_scene_source(args, num_scenes=args.scenes)
    session = AnnotationSession(os.path.join(args.output_dir, "label_w"))
    for sid in src.sample_ids[: args.scenes]:
        scene = src.get_scene(sid)
        pts_rect = scene.pts_rect
        pts_image, depth = scene.calib.rect_to_img(pts_rect)
        ok = ((depth > 0) & (pts_image[:, 0] >= 0)
              & (pts_image[:, 0] < scene.image_shape[1])
              & (pts_image[:, 1] >= 0)
              & (pts_image[:, 1] < scene.image_shape[0]))
        cand_img, cand_rect = pts_image[ok], pts_rect[ok]
        gts = _car_boxes(scene)
        seeded = 0
        for g in gts:
            if cand_img.shape[0]:
                uv, _ = scene.calib.rect_to_img(g[None, 0:3])
                j = nearest_projected_point(cand_img, uv[0, 0], uv[0, 1])
                if np.hypot(cand_rect[j, 0] - g[0],
                            cand_rect[j, 2] - g[2]) < 8.0:
                    seeded += 1
            session.click(sid, g[0] + rng.randn() * 0.3,
                          g[2] + rng.randn() * 0.3, gts)
        n = session.flush()
        log.info("scene %06d: %d clicks accepted (%d/%d image-seeded)",
                 sid, n, seeded, len(gts))
    log.info("labels -> %s", session.path)
    if args.to_noise:
        _to_noise(args, src, session, log)


def run_interactive(args, log) -> None:
    """The three-pane annotator: camera image, zoom BEV (a click is a weak
    centre label with Gaussian heat), global BEV heatmap."""
    import matplotlib.pyplot as plt

    src = make_scene_source(args, num_scenes=args.scenes)
    session = AnnotationSession(os.path.join(args.output_dir, "label_w"))
    for sid in src.sample_ids[: args.scenes]:
        scene = src.get_scene(sid)
        pts = scene.pts_rect
        pts_image, depth = scene.calib.rect_to_img(pts)
        gts = _car_boxes(scene)
        heat = np.zeros(pts.shape[0], np.float32)
        image = load_scene_image(args, sid)

        fig = plt.figure(figsize=(16, 9))
        ax_img = fig.add_axes([0.04, 0.55, 0.92, 0.40])
        ax_zoom = fig.add_axes([0.04, 0.06, 0.44, 0.42])
        ax_global = fig.add_axes([0.54, 0.06, 0.42, 0.42],
                                 facecolor="dimgray")
        if image is not None:
            ax_img.imshow(image)
        else:
            ax_img.scatter(pts_image[:, 0], pts_image[:, 1], s=1, c=depth,
                           cmap="viridis")
            ax_img.set_ylim(scene.image_shape[0], 0)
            ax_img.set_xlim(0, scene.image_shape[1])
        ax_img.set_title(f"image — scene {sid:06d} (click seeds BEV zoom)")

        def draw_bev():
            ax_zoom.set_xlabel("x [m]")
            ax_zoom.set_ylabel("z [m]")
            ax_zoom.set_title("zoom BEV (click = label)")
            ax_global.cla()
            ax_global.scatter(pts[:, 0], pts[:, 2], s=2,
                              c=heat if heat.any()
                              else np.clip(1.8 - pts[:, 1], 0, 3),
                              cmap="rainbow")
            ax_global.set_xlim(-40, 40)
            ax_global.set_ylim(0, 70)
            ax_global.set_title("global BEV heatmap")

        def draw_zoom(cx, cz):
            ax_zoom.cla()
            ax_zoom.scatter(pts[:, 0], pts[:, 2], s=2,
                            c=np.clip(1.8 - pts[:, 1], 0, 3), cmap="viridis")
            ax_zoom.set_xlim(cx - 5, cx + 5)
            ax_zoom.set_ylim(cz - 5, cz + 5)
            ax_zoom.set_title("zoom BEV (click = label)")

        draw_bev()

        def on_click(event):
            nonlocal heat
            if event.inaxes is None or event.xdata is None:
                return
            if event.inaxes is ax_img:
                j = nearest_projected_point(pts_image, event.xdata,
                                            event.ydata)
                draw_zoom(pts[j, 0], pts[j, 2])
                fig.canvas.draw_idle()
                return
            if event.inaxes is ax_global:
                draw_zoom(event.xdata, event.ydata)
                fig.canvas.draw_idle()
                return
            rec = session.click(sid, event.xdata, event.ydata, gts)
            d = np.sqrt((pts[:, 0] - event.xdata) ** 2
                        + (pts[:, 1] - 0.8) ** 2
                        + (pts[:, 2] - event.ydata) ** 2)
            heat += np.exp(-0.5 * d * d / 2.0).astype(np.float32)
            ax_zoom.scatter([event.xdata], [event.ydata], marker="x",
                            s=120, c="red" if rec is not None else "gray")
            draw_bev()
            fig.canvas.draw_idle()

        fig.canvas.mpl_connect("button_press_event", on_click)
        plt.show()
        n = session.flush()
        log.info("scene %06d: %d clicks accepted", sid, n)
    if args.to_noise:
        _to_noise(args, src, session, log)


def main(argv=None) -> int:
    p = base_parser("BEV click weak-label annotation tool")
    p.add_argument("--scenes", type=int, default=4)
    p.add_argument("--headless", action="store_true",
                   help="simulate clicks from the ground truth (no display)")
    p.add_argument("--to_noise", action="store_true",
                   help="also convert label_w/label.txt into the "
                        "KITTI-format label_noise/ directory")
    args = p.parse_args(argv)
    _, log = setup(args, "annotate")
    try:
        if args.headless or not os.environ.get("DISPLAY"):
            run_headless(args, log)
        else:
            run_interactive(args, log)
        return 0
    finally:
        close_log(log)


if __name__ == "__main__":
    sys.exit(main())
