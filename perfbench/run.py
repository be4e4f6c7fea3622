"""Run one cell of the benchmark of ``penguin_tpu_torch`` on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared with its limit.
The same numbers end standard error.  Exits with 2, printing no result,
when there is no CUDA card or fewer than the cell asks for, and with 3 when
the process holds JAX or the JAX package once the run is over.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# fixed cache directories inside the checkout, so that only a checkout's
# first run builds or compiles: the port's CUDA library goes to its own
# _build/, and a Triton or extension kernel a later change adds lands here
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".perfbench_cache" / sub)
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "penguin_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the port must not pull in,
    compared whole (``penguin_tpu_torch`` is not ``penguin_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness import Bench, run_cell

    bench = Bench(ROOT)
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: cell {args.workload} needs {chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f"; no result", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    result, check = run_cell(bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), device, T_START)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process holds {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    result["check"] = check
    print(f"card: {result['device']['power_limit']}", file=sys.stderr)
    for key, c in check.items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
