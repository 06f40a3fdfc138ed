"""codecbench: the benchmark of the PyTorch and CUDA port (`dsv2_tpu_torch`)
on one NVIDIA GPU.

    python3 codecbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. The cells, metrics and bounds are in
BENCHMARK.json; what each name points to is a file under codecbench/
(see harness.py). The last line of standard output is the run's result
as one JSON object; the numbers the check compared, each beside its
limit, are the last lines of standard error. Exits non-zero, printing
no result, when no GPU is visible, or when a run has loaded `jax`,
`jaxlib`, `flax` or `dsv2_tpu`.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def setup_env():
    """Every build and kernel cache inside the checkout, at fixed paths,
    and the checkout's root, not this folder, where imports start."""
    cache = os.path.join(ROOT, "build", "codecbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["DSV2_TORCH_DEVICE"] = "cuda"
    for k in ("DSV2_TRACE", "DSV2_XPROF"):
        os.environ.pop(k, None)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]


def main(argv=None):
    setup_env()
    from codecbench import harness
    try:
        return harness.run(sys.argv[1:] if argv is None else argv, ROOT,
                           t_start=T_START)
    except harness.BenchError as exc:
        print("codecbench: %s" % exc, file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
