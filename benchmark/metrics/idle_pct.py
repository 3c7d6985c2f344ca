"""Device: the share of the traced window in which no kernel, copy or
memset runs, in %."""
from benchmark.metrics.common import idle_pct as read  # noqa: F401
