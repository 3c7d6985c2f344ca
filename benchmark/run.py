"""The benchmark of ws3d_tpu_torch: one cell, one run, one result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout. The cell is an entry of `workloads` in
BENCHMARK.json; its `traffic` names benchmark/traffic/<traffic>.json (the
driver and its parameters) and its `config` names the configuration file
that BENCHMARK.json lists. The driver, benchmark/drivers/<driver>.py, does
the set-up (timed as setup_s), warms up, runs a closed loop for --seconds
(with --trace 1 a profiled stretch of it instead), checks the outputs
against the plain reference, and returns the result. The last line of
standard output is that result as one JSON object; the numbers compared
and their limits are also the last lines of standard error.

Exits 2 without printing a result when there is no CUDA card (or fewer
than the cell asks for), and 3 when the process has loaded JAX or the JAX
package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark import harness
    try:
        cell = harness.load_cell(ROOT, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    missing = harness.missing_device(cell["chips"])
    if missing:
        print(f"benchmark: {missing}", file=sys.stderr)
        return 2
    harness.set_cache_dirs(ROOT)
    result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), t_start=T_START)
    loaded = harness.jax_modules()
    if loaded:
        print(f"benchmark: the process loaded {loaded}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
