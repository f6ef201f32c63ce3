"""Entry point: ``python -m arches_bench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout."""

import sys

from arches_bench.harness import main

if __name__ == "__main__":
    sys.exit(main())
