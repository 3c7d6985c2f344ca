"""The RCNN stage of the stage-2 training (the public flow's
train_cascade1): ws3d_tpu_torch.tools.train_cascade --stage rcnn.

    python -m ws3d_tpu_torch.tools.train_cascade1 --synthetic --steps 2 \\
        --batch 8 --npoints 128 --cpu --output_dir out
"""
import sys

from ws3d_tpu_torch.tools import train_cascade


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    return train_cascade.main(argv + ["--stage", "rcnn"])


if __name__ == "__main__":
    sys.exit(main())
