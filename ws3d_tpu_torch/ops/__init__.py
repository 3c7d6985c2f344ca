"""Point-cloud ops. Modules holding a CUDA kernel: sampling (FPS), fused_sa
(windowed and full fused SA), fused_sa_idx (SA with given indices),
interpolate (3-NN interpolation, its windowed form for z-sorted clouds, and
the 3-NN search of its backward), crop_gather (cylinder crop over all
points or each centre's z-window), ball_query (multi-scale ball query, in
its pad-with-first and wrap-pad modes)."""
