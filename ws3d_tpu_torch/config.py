"""Configuration tree for ws3d_tpu_torch (a copy of ws3d_tpu/config.py).

A nested tree with strict-typed YAML merge and ``key.subkey=value`` CLI
overrides. It reads the same ``tools/cfgs/*.yaml`` files by path; the key
names (including the ``TPU`` block of shared pipeline knobs) are unchanged so
one YAML configures both packages.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np
import yaml


class ConfigNode(dict):
    """A dict with attribute access and strict-typed deep merge."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ConfigNode":
        node = ConfigNode()
        for k, v in d.items():
            node[k] = ConfigNode.from_dict(v) if isinstance(v, dict) else v
        return node

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, ConfigNode) else v)
            for k, v in self.items()
        }

    def clone(self) -> "ConfigNode":
        return ConfigNode.from_dict(copy.deepcopy(self.to_dict()))

    def merge(self, other: Dict[str, Any], strict: bool = True) -> "ConfigNode":
        """Recursively merge ``other`` into a copy of self (strict types)."""
        out = self.clone()
        _merge_into(out, other, strict=strict, path="")
        return out


def _merge_into(dst: ConfigNode, src: Dict[str, Any], strict: bool, path: str) -> None:
    for k, v in src.items():
        full = f"{path}.{k}" if path else k
        if strict and k not in dst:
            raise KeyError(f"unknown config key: {full}")
        if isinstance(v, dict) and isinstance(dst.get(k), ConfigNode):
            _merge_into(dst[k], v, strict, full)
        else:
            if strict and k in dst and dst[k] is not None and v is not None:
                old, new = dst[k], v
                ok = (
                    type(old) is type(new)
                    or isinstance(old, (int, float)) and isinstance(new, (int, float))
                    or isinstance(old, list) and isinstance(new, list)
                )
                if not ok:
                    raise TypeError(
                        f"type mismatch for {full}: {type(old).__name__} vs {type(new).__name__}"
                    )
            dst[k] = ConfigNode.from_dict(v) if isinstance(v, dict) else v


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def parse_overrides(pairs: List[str]) -> Dict[str, Any]:
    """Parse ``a.b.c=value`` CLI overrides (values parsed as YAML scalars)."""
    out: Dict[str, Any] = {}
    for pair in pairs:
        key, _, raw = pair.partition("=")
        if not _:
            raise ValueError(f"override must be key=value, got {pair!r}")
        node = out
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(raw)
    return out


# ---------------------------------------------------------------------------
# Defaults — functional mirror of the reference defaults + weakly*.yaml values
# (see the upstream WS3D lib/config.py and tools/cfgs/weakly{RPN,RCNN,IOUN}.yaml).
# ---------------------------------------------------------------------------

def default_config() -> ConfigNode:
    return ConfigNode.from_dict({
        "CLASSES": "Car",
        "INCLUDE_SIMILAR_TYPE": True,
        # augmentation
        "AUG_DATA": True,
        "AUG_METHOD_LIST": ["rotation", "scaling", "flip"],
        "AUG_METHOD_PROB": [1.0, 1.0, 0.5],
        "AUG_ROT_RANGE": 18,
        "GT_AUG_ENABLED": True,
        "GT_EXTRA_NUM": 15,
        "GT_AUG_RAND_NUM": True,
        "GT_AUG_APPLY_PROB": 1.0,
        "GT_AUG_HARD_RATIO": 0.6,
        "PC_REDUCE_BY_RANGE": True,
        "PC_AREA_SCOPE": [[-40.0, 40.0], [-3.0, 3.0], [0.0, 70.4]],
        "CLS_MEAN_SIZE": [[1.52563191462, 1.62856739989, 3.88311640418]],
        # context-attention residual before each stage-2 SA module
        # (models/rcnn.py:context_attention; off in every shipped yaml)
        "ATTENTION": False,
        "CASCADE": 1,
        # TPU-specific knobs (new in this framework)
        "TPU": {
            "COMPUTE_DTYPE": "float32",   # or "bfloat16" for MXU-heavy paths
            # z-sort every scene cloud in the data loaders (ascending rect
            # z). Neighborhoods become contiguous index windows, letting the
            # backbone's first SA stage run the windowed fused kernel
            # (ops/fused_sa_window_pallas.py) instead of ~11.5 ns/row XLA
            # gathers. Point order is an arbitrary loader choice in the
            # reference too; ball-query first-k tie-breaks follow the order.
            "SORT_POINTS_Z": True,
            "MAX_PROPOSALS": 64,          # fixed K proposals per scene
            "BALL_QUERY_CHUNK": 512,      # M-axis chunk for distance tiles
            "THREE_NN_CHUNK": 2048,       # n-axis chunk for FP distance tiles
            "USE_PALLAS": True,           # pallas kernels on TPU where available
            # Stage-2 compaction budgets (0 = off). RCNN: pool the B*K
            # slots and run the trunk on only the top B*budget live slots.
            # Off by default: measured occupancy on the fitted bench is
            # ~63.6/64 (the RPN proposes far more than the final ~3
            # detections/scene), so trunk compaction would spill. IOUN:
            # run the cascade on only the top B*budget rcnn-score-gate
            # survivors — the reference consumes the cascade output only
            # where norm_rcnn>0.3 (eval_auto.py:426-436), so this is
            # semantics-exact as long as nothing spills (`spilled` output).
            # Measured gate pass rate on the fitted bench: mean 22.6/scene,
            # max 34/scene, per-16-scene-batch total 346-375 of 1024 — 28
            # pooled slots/scene clears the observed max with margin.
            "RCNN_BUDGET_PER_SCENE": 0,
            "IOUN_BUDGET_PER_SCENE": 28,
        },
        "RPN": {
            "ENABLED": True,
            "FIXED": False,
            "USE_INTENSITY": True,
            "Gaussian_Center": True,
            "GAUSS_HEIGHT": 0.707,
            "GAUSS_STATUS": 0.7,
            "GAUSS_COV": 1.5,
            "LOC_SCOPE": 4.0,
            "LOC_BIN_SIZE": 0.8,
            "BACKBONE": "pointnet2_msg",
            "USE_BN": True,
            "NUM_POINTS": 16384,
            "SA_CONFIG": {
                "NPOINTS": [4096, 1024, 256, 64],
                "RADIUS": [[0.1, 0.5], [0.5, 1.0], [1.0, 2.0], [2.0, 4.0]],
                "NSAMPLE": [[16, 32], [16, 32], [16, 32], [16, 32]],
                "MLPS": [
                    [[16, 16, 32], [32, 32, 64]],
                    [[64, 64, 128], [64, 96, 128]],
                    [[128, 196, 256], [128, 196, 256]],
                    [[256, 256, 512], [256, 384, 512]],
                ],
            },
            "FP_MLPS": [[128, 128], [256, 256], [512, 512], [512, 512]],
            "CLS_FC": [128],
            "REG_FC": [128],
            "DP_RATIO": 0.5,
            "LOSS_CLS": "SigmoidFocalLoss",
            "FG_WEIGHT": 15,
            "FOCAL_ALPHA": [0.25, 0.75],
            "FOCAL_GAMMA": 2.0,
            "REG_LOSS_WEIGHT": [1.0, 1.0, 1.0, 1.0],
            "LOSS_WEIGHT": [1.0, 1.0],
            # legacy top-N proposal NMS flavor (pipeline/proposal_layer.py)
            "NMS_TYPE": "normal",
            "SCORE_THRESH": 0.3,
        },
        "RCNN": {
            "ENABLED": False,
            # crop input layout guard (models/rcnn.py:rcnn_from_config)
            "ROI_SAMPLE_JIT": True,
            # RoI sampling tree -> pipeline/roi_target.py:sample_rois_cfg
            "REG_AUG_METHOD": "multiple",
            "ROI_FG_AUG_TIMES": 10,
            "USE_RPN_FEATURES": True,
            "USE_MASK": True,
            "MASK_TYPE": "seg",
            "USE_INTENSITY": False,
            "USE_DEPTH": False,
            "USE_SEG_SCORE": False,
            "GT_GUIDE_CENTER_FEATURE": True,
            "POOL_EXTRA_WIDTH": 1.0,
            "LOC_SCOPE": 1.5,
            "LOC_BIN_SIZE": 0.5,
            "LOC_XZ_FINE": False,
            "NUM_HEAD_BIN": 12,
            "LOC_Y_BY_BIN": False,
            "LOC_Y_SCOPE": 0.5,
            "LOC_Y_BIN_SIZE": 0.25,
            "SIZE_RES_ON_ROI": False,
            "NUM_CENTER_SAMPLE": 128,
            "USE_BN": False,
            "DP_RATIO": 0.0,
            "BACKBONE": "pointnet",
            "XYZ_UP_LAYER": [128, 128],
            "NUM_POINTS": 512,
            "SA_CONFIG": {
                "NPOINTS": [256, 128, 32, -1],
                "RADIUS": [0.2, 0.4, 1.0, 100],
                "NSAMPLE": [16, 32, 64, 64],
                "MLPS": [
                    [128, 128, 128],
                    [128, 128, 128],
                    [128, 128, 256],
                    [256, 256, 512],
                ],
            },
            "CLS_FC": [256, 256],
            "REG_FC": [256, 256],
            "LOSS_CLS": "BinaryCrossEntropy",
            "FOCAL_ALPHA": [0.25, 0.75],
            "FOCAL_GAMMA": 2.0,
            "CLS_WEIGHT": [1.0, 1.0, 1.0],
            "CLS_FG_THRESH": 0.6,
            "CLS_BG_THRESH": 0.45,
            "CLS_BG_THRESH_LO": 0.05,
            "REG_FG_THRESH": 0.55,
            "FG_RATIO": 0.5,
            "ROI_PER_IMAGE": 32,
            "HARD_BG_RATIO": 0.8,
            "SCORE_THRESH": 0.1,
            "NMS_THRESH": 0.1,
        },
        "IOUN": {
            "ENABLED": False,
            "USE_BN": False,
            "DP_RATIO": 0.0,
            "XYZ_UP_LAYER": [128, 128],
            "NUM_POINTS": 512,
            "LOC_SCOPE": 1.5,
            "LOC_BIN_SIZE": 0.5,
            "LOC_XZ_FINE": False,
            "NUM_HEAD_BIN": 12,
            "LOC_Y_BY_BIN": False,
            "LOC_Y_SCOPE": 0.5,
            "LOC_Y_BIN_SIZE": 0.25,
            "SA_CONFIG": {
                "NPOINTS": [256, 128, 32, -1],
                "RADIUS": [0.2, 0.4, 1.0, 100],
                "NSAMPLE": [16, 32, 64, 64],
                "MLPS": [
                    [128, 128, 128],
                    [128, 128, 128],
                    [128, 128, 256],
                    [256, 256, 512],
                ],
            },
            "CLS_FC": [256, 256],
            "REG_FC": [256, 256],
            "SCORE_THRESH": 0.3,
        },
        "TRAIN": {
            "SPLIT": "train",
            "VAL_SPLIT": "small_val",
            "LR": 0.002,
            "LR_CLIP": 1e-05,
            "LR_DECAY": 0.5,
            "DECAY_STEP_LIST": [100, 150, 180, 200],
            "LR_WARMUP": True,
            "WARMUP_MIN": 0.0002,
            "WARMUP_EPOCH": 1,
            "BN_MOMENTUM": 0.1,
            "BN_DECAY": 0.5,
            "BNM_CLIP": 0.01,
            "BN_DECAY_STEP_LIST": [1000],
            "OPTIMIZER": "adam_onecycle",
            "WEIGHT_DECAY": 0.001,
            "MOMENTUM": 0.9,
            "MOMS": [0.95, 0.85],
            "DIV_FACTOR": 10.0,
            "PCT_START": 0.4,
            "GRAD_NORM_CLIP": 1.0,
            # legacy top-N proposal knobs (pipeline/proposal_layer.py)
            "RPN_PRE_NMS_TOP_N": 9000,
            "RPN_POST_NMS_TOP_N": 2048,
            "RPN_NMS_THRESH": 0.85,
            "RPN_DISTANCE_BASED_PROPOSE": False,
            "BATCH_SIZE": 16,
        },
        "TEST": {
            "SPLIT": "val",
            # legacy top-N proposal knobs (pipeline/proposal_layer.py)
            "RPN_PRE_NMS_TOP_N": 9000,
            "RPN_POST_NMS_TOP_N": 100,
            "RPN_NMS_THRESH": 0.8,
            "RPN_DISTANCE_BASED_PROPOSE": False,
        },
    })


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[List[str]] = None) -> ConfigNode:
    cfg = default_config()
    if yaml_path:
        cfg = cfg.merge(load_yaml(yaml_path), strict=False)
    if overrides:
        cfg = cfg.merge(parse_overrides(overrides), strict=True)
    return cfg


def mean_size(cfg: ConfigNode) -> np.ndarray:
    return np.asarray(cfg.CLS_MEAN_SIZE[0], dtype=np.float32)


def compute_dtype(cfg: ConfigNode):
    """cfg.TPU.COMPUTE_DTYPE as the models take it (ws3d_tpu/models/rpn.py:
    _compute_dtype): torch.bfloat16 for "bfloat16", None for "float32";
    any other name raises."""
    import torch
    name = str(cfg.TPU.COMPUTE_DTYPE)
    if name == "bfloat16":
        return torch.bfloat16
    if name == "float32":
        return None
    raise ValueError(f"TPU.COMPUTE_DTYPE {name!r}: expected 'float32' or "
                     f"'bfloat16'")

