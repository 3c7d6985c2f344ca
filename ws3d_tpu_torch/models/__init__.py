from ws3d_tpu_torch.models.detector import PointRCNN, build_model  # noqa: F401
