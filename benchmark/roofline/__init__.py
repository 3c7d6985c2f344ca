"""The yardstick of the per-layer shares: the H100's peaks and the
operations and bytes that each counted kernel call needs, from its
shapes."""
