"""Point-cloud ops. Modules holding a CUDA kernel: sampling (FPS), fused_sa
(windowed and full fused SA), interpolate (3-NN interpolation and the 3-NN
search of its backward), crop_gather (cylinder crop), ball_query
(multi-scale ball query)."""
