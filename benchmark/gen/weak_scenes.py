"""Scene traffic for the stage-1 training cells: `num` synthetic scenes
(benchmark/gen/synthetic.py) generated in set-up and held in memory, as a
file-backed loader reads KITTI from the page cache, behind the interface of
a scene source that the port's loaders read (`sample_ids`,
`get_scene(i, with_noise)`). The records gain what a KITTI record of the
port has: `Object3d.to_box3d` and `KittiScene.pts_rect` /
`pts_intensity`. Every synthetic scene has at least one car, so each has a
weak label."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from benchmark.gen import kitti_min
from benchmark.gen.synthetic import SyntheticKitti


@dataclass
class Object3d(kitti_min.Object3d):
    def to_box3d(self) -> np.ndarray:
        """-> (7,) [x, y, z, h, w, l, ry] bottom-y."""
        return np.array([*self.pos, self.h, self.w, self.l, self.ry],
                        dtype=np.float32)


@dataclass
class KittiScene(kitti_min.KittiScene):
    @property
    def pts_rect(self) -> np.ndarray:
        return self.calib.lidar_to_rect(self.pts_lidar[:, 0:3])

    @property
    def pts_intensity(self) -> np.ndarray:
        return self.pts_lidar[:, 3]


def _objects(objs):
    return [Object3d(**{f.name: getattr(o, f.name)
                        for f in dataclasses.fields(o)}) for o in objs]


class HeldScenes:
    """`num` scenes of SyntheticKitti(seed, max_cars, points_per_scene),
    generated once; without noise a scene's weak labels are left out, as
    SyntheticKitti leaves them out."""

    def __init__(self, num: int, seed: int, max_cars: int = 6,
                 points_per_scene: int = 20000):
        src = SyntheticKitti(num_scenes=num, max_cars=max_cars,
                             points_per_scene=points_per_scene, seed=seed)
        self.sample_ids = list(range(num))
        self._scenes = []
        for i in self.sample_ids:
            s = src._generate(i, True)
            self._scenes.append(KittiScene(
                sample_id=s.sample_id, pts_lidar=s.pts_lidar, calib=s.calib,
                image_shape=s.image_shape, labels=_objects(s.labels),
                noise_labels=_objects(s.noise_labels)))

    def get_scene(self, sample_id: int, with_noise: bool = True):
        scene = self._scenes[int(sample_id)]
        return scene if with_noise else dataclasses.replace(
            scene, noise_labels=[])
