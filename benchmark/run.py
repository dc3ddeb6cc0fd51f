"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the program (``vcagan_torch``).  The cell's configuration, traffic and
limits are files under ``benchmark/`` named by ``BENCHMARK.json``; the
traffic's ``kind`` names the generator in ``benchmark/kinds/``.  With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the device trace's summary.

It exits non-zero, printing no result, without CUDA or with fewer cards
than the cell asks for, where the program is absent, and where ``jax``,
``jaxlib``, ``flax`` or the JAX package is loaded once the run is over.
Build and kernel caches stay in fixed directories inside the checkout.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "vcagan")


def _environment() -> None:
    """Compiler caches at fixed paths inside the checkout, for a program
    that brings Triton, ``torch.compile`` or a PyTorch extension (the
    port's own kernels build into ``vcagan_torch/_build``)."""
    cache = os.path.join(ROOT, "benchmark", ".cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(cache, sub)


def loaded_forbidden() -> list:
    """Modules whose top-level name is one of ``FORBIDDEN``, compared whole."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    import torch

    from benchmark.harness import result, spec

    bench = spec.load_benchmark(ROOT)
    spec.validate(bench)
    cell = spec.load_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    try:
        importlib.import_module("vcagan_torch")
    except ImportError as err:
        print(f"benchmark: the program is not in this checkout ({err})", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    kind = importlib.import_module(f"benchmark.kinds.{cell.traffic['kind']}")
    device = torch.device("cuda", 0)
    outcome = kind.run(cell, args.seed, args.seconds, bool(args.trace), device, STARTED)
    outcome.device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                      "count": cell.chips}
    line = result.line(cell, outcome, bool(args.trace))
    found = loaded_forbidden()
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    result.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
