from ws3d_tpu_torch.datasets.boxplace_dataset import (  # noqa: F401
    BoxPlaceDataset, synthetic_proposal_database)
from ws3d_tpu_torch.datasets.rpn_dataset import RPNDataset  # noqa: F401
from ws3d_tpu_torch.datasets.synthetic import SyntheticKitti  # noqa: F401
