"""The benchmark's one command, run from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It runs one cell of ``BENCHMARK.json`` on the card and prints, as the
last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` and ``device`` (with ``--trace 1``
the per-layer metrics and ``breakdown``), then ``check``: each number
compared for correctness beside its limit. Without a CUDA card, with
fewer cards than the cell asks for, or with JAX loaded once the window
has closed, it prints no result and exits non-zero.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
# Every build and kernel cache at a fixed path inside the checkout.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "perfbench", sub)
os.environ["USE_FLAX"] = "0"

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
