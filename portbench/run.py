#!/usr/bin/env python3
"""The PyTorch port's benchmark, one run of one cell:

    python3 portbench/run.py --workload cartpole.opt --seed 7 --seconds 30 --trace 0

from the root of a checkout that holds ``mcpilco_tpu_torch``, on a machine
with the cards the cell asks for.  Prints the run's result as one JSON line,
last on standard output, and the numbers the check compared, each beside its
limit, last on standard error.  With no CUDA card, or fewer than the cell
needs, it prints no result and exits with 2.  The program's kernel builds
stay inside the checkout: the port builds its library under
``mcpilco_tpu_torch/_build/``, and any PyTorch extension or Triton cache
goes under ``.portbench_cache/`` at the checkout's root.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, ROOT)
    with open(os.path.join(ROOT, "portbench", "workloads", f"{args.workload}.json")) as f:
        chips = json.load(f)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from portbench import harness

    return harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                            T_START)


if __name__ == "__main__":
    raise SystemExit(main())
