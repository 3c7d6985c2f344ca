"""What every cell shares: finding a cell's files by name, the device
checks, the host spans the drivers record around the calls into each
layer, the per-layer metric readers, and the result line.

A cell is found from BENCHMARK.json alone: its `config` names a
configuration whose `file` holds the configuration as it is run, its
`traffic` names benchmark/traffic/<traffic>.json, which names its driver
(benchmark/drivers/<driver>.py) and holds the traffic's parameters and the
limits of its check of outputs. A per-layer metric <name> is read by
benchmark/metrics/<name>.py or, where that file does not exist, by the
reader of its quantity: <kind>.<quantity> by
benchmark/metrics/<quantity>.py, so that the cells of different end-to-end
metrics share one reader. Adding a cell, a configuration or a metric
adds files and entries and edits none.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import sys
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "ws3d_tpu")


# -- finding a cell ----------------------------------------------------
def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, name: str) -> dict:
    """The workload entry `name` of BENCHMARK.json with its configuration
    entry and file, its traffic file, and the metrics that apply to it."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = dict(cells[name])
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cell["config_entry"] = conf
    cell["config_file"] = load_json(os.path.join(root, conf["file"]))
    cell["traffic_file"] = load_json(os.path.join(
        BENCH_DIR, "traffic", cell["traffic"] + ".json"))

    def applies(m):
        return name in m.get("workloads", cells)
    cell["end_to_end"] = [m for m in bench["end_to_end"] if applies(m)]
    moved = {m["name"] for m in cell["end_to_end"]}
    cell["per_layer"] = [m for m in bench["per_layer"]
                         if applies(m) and m["moves"] in moved]
    return cell


def program_config(cell: dict):
    """The program's configuration object: its defaults with every value
    of the configuration file merged over them (strictly: a key the
    program does not know raises)."""
    from ws3d_tpu_torch.config import load_config
    return load_config().merge(cell["config_file"]["config"], strict=True)


def missing_device(chips: int) -> Optional[str]:
    import torch
    if not torch.cuda.is_available():
        return "no CUDA device is visible"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} CUDA devices, "
                f"{torch.cuda.device_count()} are visible")
    return None


def set_cache_dirs(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds
    its library into ws3d_tpu_torch/_build/ itself)."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")


def jax_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


# -- host spans ----------------------------------------------------------
class Spans:
    """Host time and calls of the benchmark's spans around the calls into
    each layer. While `on`, each wrapped call runs inside
    torch.profiler.record_function("bench::<name>") and adds its host
    seconds to `host[name]`; `calls[name]` keeps what `note` returns for
    each call (shapes for the roofline). Off, a wrapped call costs one
    flag test."""

    def __init__(self):
        self.on = False
        self.host: Dict[str, float] = {}
        self.calls: Dict[str, list] = {}
        self.lock = threading.Lock()

    def reset(self):
        with self.lock:
            self.host, self.calls = {}, {}

    def add(self, name: str, seconds: float, note=None):
        with self.lock:
            self.host[name] = self.host.get(name, 0.0) + seconds
            if note is not None:
                self.calls.setdefault(name, []).append(note)

    @contextmanager
    def span(self, name: str, note=None):
        if not self.on:
            yield
            return
        from torch.profiler import record_function
        t0 = time.perf_counter()
        with record_function("bench::" + name):
            yield
        self.add(name, time.perf_counter() - t0, note)

    def wrap(self, name: str, fn: Callable,
             note: Optional[Callable] = None) -> Callable:
        def wrapped(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            with self.span(name, note(*args, **kwargs) if note else None):
                return fn(*args, **kwargs)
        return wrapped


# -- the run ------------------------------------------------------------
class Context:
    """What a driver gets: the cell, its configuration (the file's tree
    and the program's object), the run's arguments and the spans."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 t_start: float, device=None, overrides=None):
        overrides = dict(overrides or {})
        tree = _merged(cell["config_file"]["config"],
                       overrides.pop("config", {}))
        self.cell = dict(cell, config_file=dict(cell["config_file"],
                                                config=tree))
        self.traffic = dict(cell["traffic_file"])
        self.traffic.update(overrides)
        self.cfg_tree = tree
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = trace
        self.t_start = t_start
        self.device = device
        self.spans = Spans()


def _merged(tree: dict, over: dict) -> dict:
    """A copy of `tree` with `over`'s values merged in (a test's small
    sizes)."""
    out = json.loads(json.dumps(tree))
    for k, v in over.items():
        out[k] = _merged(out[k], v) if isinstance(v, dict) else v
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, overrides=None) -> dict:
    """Run the cell's driver and assemble the result line's fields."""
    ctx = Context(cell, seed, seconds, trace, t_start, device, overrides)
    driver = importlib.import_module(
        "benchmark.drivers." + ctx.traffic["driver"])
    out = driver.run(ctx)
    units = {m["name"]: m["unit"] for m in
             cell["end_to_end"] + cell["per_layer"]}
    if trace:
        values = {}
        for m in cell["per_layer"]:
            v = read_metric(m["name"], out["record"])
            if v is not None:
                values[m["name"]] = v
    else:
        values = {m["name"]: out["end_to_end"][m["name"]]
                  for m in cell["end_to_end"]}
    result = {"correct": bool(out["correct"]),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]),
              "metrics": {k: {"value": float(v), "unit": units[k]}
                          for k, v in values.items()},
              "device": out["device"]}
    if trace:
        result["breakdown"] = out["record"]["breakdown"]
    result["checks"] = out["checks"]
    return result


def metric_file(name: str) -> str:
    """benchmark/metrics/<name>.py, or for <kind>.<quantity> without a file
    of its own, benchmark/metrics/<quantity>.py."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(BENCH_DIR, "metrics",
                            name.split(".", 1)[1] + ".py")
    return path


def read_metric(name: str, record: dict):
    """The metric's reader's read(record): a number, or None when the
    record holds nothing for it."""
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def device_fields(device, trace_record: Optional[dict] = None) -> dict:
    import torch
    if device is not None and torch.device(device).type == "cpu":
        out = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    else:
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    if trace_record is not None:
        out["busy_s"] = trace_record["busy_s"]
        out["window_s"] = trace_record["window_s"]
    return out


def card_note() -> str:
    """The card's name, power limit, SM clock and power draw, as
    nvidia-smi reads them (for the earlier lines of a run)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw", "--format=csv,noheader"], capture_output=True,
            text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi not readable"


def emit(result: dict) -> None:
    """The numbers compared beside their limits as the last lines of
    standard error, then the result as the last line of standard
    output."""
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation."""
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=100, method="inclusive")
                 [int(round(q)) - 1])
