"""The IOUN cascade stage of the stage-2 training on a frozen RCNN trunk
(the public flow's train_cascade_later): ws3d_tpu_torch.tools.train_cascade
--stage ioun; --ckpt loads the RCNN pretrain.

    python -m ws3d_tpu_torch.tools.train_cascade_later --synthetic \\
        --steps 2 --batch 8 --npoints 128 --cpu --ckpt out/rcnn_ckpt.pt \\
        --output_dir out_ioun
"""
import sys

from ws3d_tpu_torch.tools import train_cascade


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    return train_cascade.main(argv + ["--stage", "ioun"])


if __name__ == "__main__":
    sys.exit(main())
