"""Loader (datasets/boxplace_dataset.py): host ms inside the loader's
next(), on the prefetch thread, a batch drawn in the traced window."""
from benchmark.metrics.common import mean_ms


def read(rec):
    return mean_ms(rec, "loader_s")
