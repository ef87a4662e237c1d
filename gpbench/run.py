"""Run one benchmark cell once on the card and print its result line.

    python3 -m gpbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``--trace 0`` measures the cell's
end-to-end metrics over a window of ``--seconds``; ``--trace 1`` records
a few chunks with the profiler and reports the per-layer metrics.  Both
check what the window produced against the reference.  The last lines of
standard error are the numbers compared, each beside its limit; the last
line of standard output is the result, one JSON object.  Exits nonzero,
printing no result, when the card is missing, or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """When this process started, on the ``time.perf_counter`` clock."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


STARTED = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "gigapaxos_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``gigapaxos_tpu_torch`` is not ``gigapaxos_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _caches() -> None:
    """Every cache the run may write lives at a fixed path in the checkout
    (the program builds its kernels into ``build/kernels``)."""
    base = os.path.join(ROOT, "build", "gpbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()

    import torch

    from gpbench import harness

    cell = harness.find_cell(harness.read_json(os.path.join(ROOT, "BENCHMARK.json")),
                             args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"gpbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         "cuda:0", STARTED)
    found = forbidden_modules()
    if found:
        print(f"gpbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    print(json.dumps({k: v for k, v in result.items() if k != "checks"}), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
