"""ws3d_tpu_torch — the PyTorch/CUDA port of ws3d_tpu for NVIDIA Hopper.

Plain tensor code is PyTorch; every TPU kernel of the ported path is a CUDA
kernel written by hand (csrc/), built at first use. Entry points run on CUDA
unless the caller passes device="cpu", where each kernel's plain PyTorch
version runs instead. The package imports neither JAX nor ws3d_tpu.

The dense layers are plain f32 matmuls and expect PyTorch's default
``torch.backends.cuda.matmul.allow_tf32 = False``; the package sets no
global flag itself.
"""
__version__ = "0.1.0"
