"""Point-cloud ops. Modules holding a CUDA kernel: sampling (FPS), fused_sa
(windowed and full fused SA), fused_sa_idx (SA with given indices),
interpolate (3-NN interpolation, its windowed form for z-sorted clouds, and
the 3-NN search of its backward), crop_gather (cylinder crop over all
points or each centre's z-window), ball_query (multi-scale ball query, in
its pad-with-first and wrap-pad modes). The box geometry, IoU, NMS, RoI
pooling and GIoU below are plain PyTorch."""
from ws3d_tpu_torch.ops.boxes import (  # noqa: F401
    boxes3d_to_bev, boxes3d_to_corners3d, enlarge_box3d,
    points_in_rotated_boxes, rotate_points_along_y, rotation_matrix_y)
from ws3d_tpu_torch.ops.giou import (  # noqa: F401
    gious_3d_loss, ious_3d_loss, paired_giou3d, paired_iou3d)
from ws3d_tpu_torch.ops.iou3d import (  # noqa: F401
    boxes_iou3d, boxes_iou_bev, rotated_overlap_bev)
from ws3d_tpu_torch.ops.nms import (  # noqa: F401
    radius_nms, rotated_nms, score_threshold_topk)
from ws3d_tpu_torch.ops.roipool import cylinder_crop, roipool3d  # noqa: F401
