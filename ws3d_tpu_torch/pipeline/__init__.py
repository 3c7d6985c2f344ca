from ws3d_tpu_torch.pipeline.inference import (  # noqa: F401
    crop_for_rcnn_batched, finalize_detections, make_two_stage_fn,
    rpn_propose)
