"""Run one cell of the port's benchmark:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout holding the port (``src/repro_torch``) and a
CUDA card.  Prints informational lines, then the result as one JSON object
on the last line of standard output; the numbers of the correctness check
beside their limits are the last lines of standard error.  Exits non-zero,
printing no result, without a card, without the port, or where a module of
JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
CACHES = REPO / "build" / "portbench"
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(CACHES / sub)
# the program's fault-injection plan, if one is set, is not the system's
os.environ.pop("REPRO_TORCH_FAULT_PLAN", None)
sys.path[:0] = [str(REPO), str(REPO / "src")]


def main() -> int:
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"portbench: the port is not in this checkout ({exc})",
              file=sys.stderr)
        return 4
    from portbench.harness import main as run
    return run(sys.argv[1:], T_START)


if __name__ == "__main__":
    sys.exit(main())
