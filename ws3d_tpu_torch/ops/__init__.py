"""Point-cloud ops. Modules holding a CUDA kernel: sampling (FPS), fused_sa
(windowed and full fused SA), interpolate (3-NN interpolation), crop_gather
(cylinder crop)."""
