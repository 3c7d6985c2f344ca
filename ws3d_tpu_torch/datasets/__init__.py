from ws3d_tpu_torch.datasets.rpn_dataset import RPNDataset  # noqa: F401
from ws3d_tpu_torch.datasets.synthetic import SyntheticKitti  # noqa: F401
