"""Pipeline glue (pipeline/inference.py: the proposal layer with its
greedy sweep, and finalize_detections with its self-NMS sweep): host ms a
batch inside the `rpn_propose` and `finalize_detections` spans."""
from benchmark.metrics.common import host_ms


def read(rec):
    return host_ms(rec, "propose", "finalize")
