"""The official KITTI AP metric, host NumPy: 41-recall-point threshold
selection, difficulty gating by occlusion, truncation and box height,
ignore and DontCare handling, precision max-smoothing, 11-point
interpolated AP. Copy of ws3d_tpu/eval/kitti_ap.py.

The rotated BEV/3D overlaps and the per-frame statistics run in the host
C++ library (ws3d_tpu_torch.native over csrc/ws3d_host.cpp) where it loads,
else in NumPy (rotate_iou_np and compute_statistics below); both give the
same numbers. `native` (True, False, or None for "where it loads") picks
the path of a call.

Annos are dicts with name, truncated, occluded, alpha, bbox (N, 4),
dimensions (N, 3) in (l, h, w) order, location (N, 3), rotation_y (N,) and,
for detections, score (N,).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ws3d_tpu_torch import native as _native
from ws3d_tpu_torch.eval.rotate_iou_np import rotate_iou_eval as _np_rotate_iou


def use_native(native: Optional[bool] = None) -> bool:
    """Whether a call with `native` runs the C++ library: None where it
    loads; True requires it (raises where it cannot be loaded)."""
    if native is None:
        return _native.available()
    if native and not _native.available():
        raise RuntimeError(f"the host library {_native.LIB_PATH} cannot be "
                           f"built or loaded")
    return bool(native)


def rotate_iou_eval(boxes, qboxes, criterion=-1, native=None):
    if use_native(native):
        return _native.rotate_iou_eval(boxes, qboxes, criterion)
    return _np_rotate_iou(boxes, qboxes, criterion)


N_SAMPLE_PTS = 41
NO_DETECTION = -10000000.0

CLASS_NAMES = ["car", "pedestrian", "cyclist", "van", "person_sitting"]
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]


# ---------------------------------------------------------------------------
# Annotation IO
# ---------------------------------------------------------------------------

def empty_anno() -> Dict[str, np.ndarray]:
    return {"name": np.array([]), "truncated": np.array([]),
            "occluded": np.array([]), "alpha": np.array([]),
            "bbox": np.zeros((0, 4)), "dimensions": np.zeros((0, 3)),
            "location": np.zeros((0, 3)), "rotation_y": np.array([]),
            "score": np.array([])}


def anno_from_lines(lines: List[str]) -> Dict[str, np.ndarray]:
    content = [line.strip().split(" ") for line in lines if line.strip()]
    if not content:
        return empty_anno()
    anno = {
        "name": np.array([x[0] for x in content]),
        "truncated": np.array([float(x[1]) for x in content]),
        "occluded": np.array([int(float(x[2])) for x in content]),
        "alpha": np.array([float(x[3]) for x in content]),
        "bbox": np.array([[float(v) for v in x[4:8]] for x in content]).reshape(-1, 4),
        # KITTI line order is h, w, l -> store (l, h, w) like kitti_common
        "dimensions": np.array([[float(v) for v in x[8:11]]
                                for x in content]).reshape(-1, 3)[:, [2, 0, 1]],
        "location": np.array([[float(v) for v in x[11:14]]
                              for x in content]).reshape(-1, 3),
        "rotation_y": np.array([float(x[14]) for x in content]),
    }
    if len(content[0]) == 16:
        anno["score"] = np.array([float(x[15]) for x in content])
    else:
        anno["score"] = np.zeros((anno["bbox"].shape[0],))
    return anno


def get_label_anno(path: str) -> Dict[str, np.ndarray]:
    with open(path) as f:
        return anno_from_lines(f.readlines())


def get_label_annos(label_dir: str,
                    image_ids: Sequence[int]) -> List[Dict[str, np.ndarray]]:
    return [get_label_anno(os.path.join(label_dir, "%06d.txt" % i))
            for i in image_ids]


def annos_from_objects(objects_per_frame) -> List[Dict[str, np.ndarray]]:
    """Build annos from lists of datasets.kitti_io.Object3d."""
    out = []
    for objs in objects_per_frame:
        if not objs:
            out.append(empty_anno())
            continue
        out.append({
            "name": np.array([o.cls_type for o in objs]),
            "truncated": np.array([o.trucation for o in objs]),
            "occluded": np.array([o.occlusion for o in objs]),
            "alpha": np.array([o.alpha for o in objs]),
            "bbox": np.stack([o.box2d for o in objs]).astype(np.float64),
            "dimensions": np.array([[o.l, o.h, o.w] for o in objs]),
            "location": np.stack([o.pos for o in objs]).astype(np.float64),
            "rotation_y": np.array([o.ry for o in objs]),
            "score": np.array([o.score for o in objs]),
        })
    return out


# ---------------------------------------------------------------------------
# Overlap matrices
# ---------------------------------------------------------------------------

def image_box_overlap(boxes: np.ndarray, query_boxes: np.ndarray,
                      criterion: int = -1) -> np.ndarray:
    """Axis-aligned 2D box overlap, vectorised."""
    N, K = boxes.shape[0], query_boxes.shape[0]
    if N == 0 or K == 0:
        return np.zeros((N, K))
    iw = (np.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], query_boxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], query_boxes[None, :, 1]))
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    inter = np.where((iw > 0) & (ih > 0), inter, 0.0)
    area_b = ((boxes[:, 2] - boxes[:, 0])
              * (boxes[:, 3] - boxes[:, 1]))[:, None]
    area_q = ((query_boxes[:, 2] - query_boxes[:, 0])
              * (query_boxes[:, 3] - query_boxes[:, 1]))[None, :]
    if criterion == -1:
        ua = area_b + area_q - inter
    elif criterion == 0:
        ua = np.broadcast_to(area_b, inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area_q, inter.shape)
    else:
        ua = np.ones_like(inter)
    return np.where(inter > 0, inter / np.maximum(ua, 1e-12), 0.0)


def bev_box_overlap(boxes: np.ndarray, qboxes: np.ndarray,
                    criterion: int = -1, native=None) -> np.ndarray:
    """(N, 5) [x, z, l, w, ry] rotated BEV IoU."""
    return rotate_iou_eval(boxes, qboxes, criterion, native)


def d3_box_overlap(boxes: np.ndarray, qboxes: np.ndarray,
                   criterion: int = -1, native=None) -> np.ndarray:
    """(N, 7) camera boxes [x, y, z, l, h, w, ry] -> 3D IoU: rotated BEV
    intersection x height overlap."""
    inter_bev = rotate_iou_eval(boxes[:, [0, 2, 3, 5, 6]],
                                qboxes[:, [0, 2, 3, 5, 6]], 2, native)
    N, K = boxes.shape[0], qboxes.shape[0]
    if N == 0 or K == 0:
        return np.zeros((N, K))
    iw = (np.minimum(boxes[:, None, 1], qboxes[None, :, 1])
          - np.maximum(boxes[:, None, 1] - boxes[:, None, 4],
                       qboxes[None, :, 1] - qboxes[None, :, 4]))
    vol1 = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol2 = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    inter = np.where(iw > 0, iw * inter_bev, 0.0)
    if criterion == -1:
        ua = vol1 + vol2 - inter
    elif criterion == 0:
        ua = np.broadcast_to(vol1, inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(vol2, inter.shape)
    else:
        # raw intersection volume, matching d3_box_overlap_kernel's ua = 1.0
        ua = np.ones_like(inter)
    return np.where(inter > 0, inter / np.maximum(ua, 1e-12), 0.0)


# ---------------------------------------------------------------------------
# Per-frame statistics
# ---------------------------------------------------------------------------

def clean_data(gt_anno, dt_anno, current_class: int, difficulty: int):
    cls_name = CLASS_NAMES[current_class]
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    num_valid_gt = 0
    for i in range(len(gt_anno["name"])):
        gt_name = str(gt_anno["name"][i]).lower()
        height = gt_anno["bbox"][i, 3] - gt_anno["bbox"][i, 1]
        if gt_name == cls_name:
            valid_class = 1
        elif cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
                  or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if str(gt_anno["name"][i]) == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])
    for i in range(len(dt_anno["name"])):
        valid_class = 1 if str(dt_anno["name"][i]).lower() == cls_name else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """tp, fp, fn, similarity and the matched scores of one frame; overlaps
    is (num_dt, num_gt)."""
    det_size = dt_datas.shape[0]
    gt_size = gt_datas.shape[0]
    dt_scores = dt_datas[:, -1]
    dt_alphas = dt_datas[:, 4]
    gt_alphas = gt_datas[:, 4]
    dt_bboxes = dt_datas[:, :4]

    assigned = [False] * det_size
    ignored_threshold = [dt_scores[j] < thresh if compute_fp else False
                         for j in range(det_size)]
    tp = fp = fn = 0
    similarity = 0.0
    thresholds = []
    delta = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            dt_score = dt_scores[j]
            if (not compute_fp and overlap > min_overlap
                    and dt_score > valid_detection):
                det_idx = j
                valid_detection = dt_score
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_det[j] == 0):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == NO_DETECTION and ignored_det[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif (valid_detection != NO_DETECTION
              and (ignored_gt[i] == 1 or ignored_det[det_idx] == 1)):
            assigned[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned[det_idx] = True

    if compute_fp:
        for j in range(det_size):
            if not (assigned[j] or ignored_det[j] in (-1, 1)
                    or ignored_threshold[j]):
                fp += 1
        nstuff = 0
        if metric == 0 and len(dc_bboxes) > 0:
            dc = np.stack(dc_bboxes, 0) if isinstance(dc_bboxes, list) else dc_bboxes
            overlaps_dt_dc = image_box_overlap(dt_bboxes, dc, 0)
            for i in range(dc.shape[0]):
                for j in range(det_size):
                    if (assigned[j] or ignored_det[j] in (-1, 1)
                            or ignored_threshold[j]):
                        continue
                    if overlaps_dt_dc[j, i] > min_overlap:
                        assigned[j] = True
                        nstuff += 1
        fp -= nstuff
        if compute_aos:
            tmp = [0.0] * fp + [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(tmp)) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.array(thresholds)


def get_thresholds(scores: np.ndarray, num_gt: int,
                   num_sample_pts: int = N_SAMPLE_PTS) -> List[float]:
    """41-recall-point score threshold selection."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1.0 / (num_sample_pts - 1.0)
    return thresholds


# ---------------------------------------------------------------------------
# Full eval
# ---------------------------------------------------------------------------

def _prepare_data(gt_annos, dt_annos, current_class, difficulty):
    gt_datas_list, dt_datas_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_num_valid_gt = 0
    for i in range(len(gt_annos)):
        num_valid_gt, ignored_gt, ignored_det, dc_bboxes = clean_data(
            gt_annos[i], dt_annos[i], current_class, difficulty)
        ignored_gts.append(np.array(ignored_gt, np.int64))
        ignored_dets.append(np.array(ignored_det, np.int64))
        dontcares.append(np.stack(dc_bboxes, 0).astype(np.float64)
                         if dc_bboxes else np.zeros((0, 4)))
        total_num_valid_gt += num_valid_gt
        gt_datas_list.append(np.concatenate(
            [gt_annos[i]["bbox"], gt_annos[i]["alpha"][..., None]], 1))
        dt_datas_list.append(np.concatenate(
            [dt_annos[i]["bbox"], dt_annos[i]["alpha"][..., None],
             dt_annos[i]["score"][..., None]], 1))
    return (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
            dontcares, total_num_valid_gt)


def _frame_overlaps(gt_annos, dt_annos, metric, native=None):
    """Per-frame (num_dt, num_gt) overlap matrices."""
    overlaps = []
    for gt, dt in zip(gt_annos, dt_annos):
        if metric == 0:
            ov = image_box_overlap(dt["bbox"], gt["bbox"])
        elif metric == 1:
            def bev(a):
                return np.concatenate(
                    [a["location"][:, [0, 2]], a["dimensions"][:, [0, 2]],
                     a["rotation_y"][..., None]], axis=1)
            ov = bev_box_overlap(bev(dt), bev(gt),
                                 native=native).astype(np.float64)
        else:
            def cam(a):
                return np.concatenate(
                    [a["location"], a["dimensions"],
                     a["rotation_y"][..., None]], axis=1)
            ov = d3_box_overlap(cam(dt), cam(gt),
                                native=native).astype(np.float64)
        overlaps.append(ov)
    return overlaps


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False, native=None):
    """Precision, recall and orientation similarity at the 41 recall
    points; min_overlaps: (num_minoverlap, 3 metrics, num_class)."""
    if len(gt_annos) != len(dt_annos):
        raise ValueError(f"{len(gt_annos)} gt frames but {len(dt_annos)} "
                         f"detection frames")
    fast = use_native(native)
    overlaps = _frame_overlaps(gt_annos, dt_annos, metric, fast)
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    num_minoverlap = len(min_overlaps)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap,
                          N_SAMPLE_PTS])
    recall = np.zeros_like(precision)
    aos = np.zeros_like(precision)
    for m, current_class in enumerate(current_classes):
        for ld, difficulty in enumerate(difficultys):
            (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
             dontcares, total_num_valid_gt) = _prepare_data(
                gt_annos, dt_annos, current_class, difficulty)
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                stats_fn = (_native.compute_statistics if fast
                            else compute_statistics)
                thresholdss = []
                for i in range(len(gt_annos)):
                    _, _, _, _, th = stats_fn(
                        overlaps[i], gt_datas_list[i], dt_datas_list[i],
                        ignored_gts[i], ignored_dets[i], dontcares[i],
                        metric, min_overlap, thresh=0.0, compute_fp=False)
                    thresholdss += list(th)
                if total_num_valid_gt == 0:
                    continue
                thresholds = get_thresholds(np.array(thresholdss),
                                            total_num_valid_gt)
                pr = np.zeros([len(thresholds), 4])
                if fast:
                    th_arr = np.asarray(thresholds, np.float64)
                    for i in range(len(gt_annos)):
                        _native.fused_statistics(
                            overlaps[i], gt_datas_list[i], dt_datas_list[i],
                            ignored_gts[i], ignored_dets[i], dontcares[i],
                            metric, min_overlap, th_arr, compute_aos, pr)
                else:
                    for i in range(len(gt_annos)):
                        for t, thresh in enumerate(thresholds):
                            tp, fp, fn, sim, _ = compute_statistics(
                                overlaps[i], gt_datas_list[i],
                                dt_datas_list[i], ignored_gts[i],
                                ignored_dets[i], dontcares[i],
                                metric, min_overlap, thresh=thresh,
                                compute_fp=True, compute_aos=compute_aos)
                            pr[t, 0] += tp
                            pr[t, 1] += fp
                            pr[t, 2] += fn
                            if sim != -1:
                                pr[t, 3] += sim
                for i in range(len(thresholds)):
                    recall[m, ld, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, ld, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, ld, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                for i in range(len(thresholds)):
                    precision[m, ld, k, i] = np.max(precision[m, ld, k, i:])
                    recall[m, ld, k, i] = np.max(recall[m, ld, k, i:])
                    if compute_aos:
                        aos[m, ld, k, i] = np.max(aos[m, ld, k, i:])
    return {"recall": recall, "precision": precision, "orientation": aos}


def get_mAP(prec: np.ndarray) -> np.ndarray:
    """11-point interpolated AP sampled from the 41 points."""
    return sum(prec[..., i] for i in range(0, prec.shape[-1], 4)) / 11 * 100


def get_mAP_41point(prec: np.ndarray) -> np.ndarray:
    return sum(prec[..., i] for i in range(prec.shape[-1])) / 41 * 100


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
            compute_aos=False, native=None):
    difficultys = [0, 1, 2]
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                     min_overlaps, compute_aos, native)
    mAP_bbox = get_mAP(ret["precision"])
    mAP_aos = get_mAP(ret["orientation"]) if compute_aos else None
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1,
                     min_overlaps, native=native)
    mAP_bev = get_mAP(ret["precision"])
    ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2,
                     min_overlaps, native=native)
    mAP_3d = get_mAP(ret["precision"])
    return mAP_bbox, mAP_bev, mAP_3d, mAP_aos


def do_coco_style_eval(gt_annos, dt_annos, current_classes, overlap_ranges,
                       compute_aos=False, native=None):
    """COCO-style AP averaged over an overlap range; overlap_ranges:
    (3, 3 metrics, num_class) [start, stop, num]."""
    min_overlaps = np.zeros([10, *overlap_ranges.shape[1:]])
    for i in range(overlap_ranges.shape[1]):
        for j in range(overlap_ranges.shape[2]):
            min_overlaps[:, i, j] = np.linspace(*overlap_ranges[:, i, j])
    mAP_bbox, mAP_bev, mAP_3d, mAP_aos = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos,
        native)
    mAP_bbox = mAP_bbox.mean(-1)
    mAP_bev = mAP_bev.mean(-1)
    mAP_3d = mAP_3d.mean(-1)
    if mAP_aos is not None:
        mAP_aos = mAP_aos.mean(-1)
    return mAP_bbox, mAP_bev, mAP_3d, mAP_aos


NAME_TO_CLASS = {"Car": 0, "Pedestrian": 1, "Cyclist": 2, "Van": 3,
                 "Person_sitting": 4}


def get_official_eval_result(gt_annos, dt_annos, current_classes,
                             native=None):
    """bbox / bev / 3d (and aos) AP at 0.7 and 0.5 overlap: -> (the
    official table as text, a dict of the Car APs)."""
    overlap_0_7 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5]] * 3)
    overlap_0_5 = np.array([[0.7, 0.5, 0.5, 0.7, 0.5],
                            [0.5, 0.25, 0.25, 0.5, 0.25],
                            [0.5, 0.25, 0.25, 0.5, 0.25]])
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [NAME_TO_CLASS[c] if isinstance(c, str) else c
                       for c in current_classes]
    min_overlaps = min_overlaps[:, :, current_classes]
    compute_aos = any(
        len(a["alpha"]) > 0 and a["alpha"][0] != -10 for a in dt_annos)
    mAPbbox, mAPbev, mAP3d, mAPaos = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos,
        native)

    class_names = {v: k for k, v in NAME_TO_CLASS.items()}
    result = ""
    for j, curcls in enumerate(current_classes):
        for i in range(min_overlaps.shape[0]):
            result += ("%s AP@%.2f, %.2f, %.2f:\n"
                       % (class_names[curcls], *min_overlaps[i, :, j]))
            result += "bbox AP:%.4f, %.4f, %.4f\n" % tuple(mAPbbox[j, :, i])
            result += "bev  AP:%.4f, %.4f, %.4f\n" % tuple(mAPbev[j, :, i])
            result += "3d   AP:%.4f, %.4f, %.4f\n" % tuple(mAP3d[j, :, i])
            if compute_aos:
                result += "aos  AP:%.2f, %.2f, %.2f\n" % tuple(mAPaos[j, :, i])
    ret_dict = {
        "Car_3d_easy": mAP3d[0, 0, 0], "Car_3d_moderate": mAP3d[0, 1, 0],
        "Car_3d_hard": mAP3d[0, 2, 0],
        "Car_bev_easy": mAPbev[0, 0, 0], "Car_bev_moderate": mAPbev[0, 1, 0],
        "Car_bev_hard": mAPbev[0, 2, 0],
        "Car_image_easy": mAPbbox[0, 0, 0],
        "Car_image_moderate": mAPbbox[0, 1, 0],
        "Car_image_hard": mAPbbox[0, 2, 0],
    }
    if compute_aos:
        ret_dict.update({"Car_aos_easy": mAPaos[0, 0, 0],
                         "Car_aos_moderate": mAPaos[0, 1, 0],
                         "Car_aos_hard": mAPaos[0, 2, 0]})
    return result, ret_dict
