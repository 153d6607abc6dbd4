"""The benchmark of the PyTorch and CUDA port on the H100:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout (``BENCHMARK.json`` names the cells)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
