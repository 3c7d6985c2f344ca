from ws3d_tpu_torch.eval.kitti_ap import (  # noqa: F401
    annos_from_objects, eval_class, get_label_annos, get_mAP, get_mAP_41point,
    get_official_eval_result)
