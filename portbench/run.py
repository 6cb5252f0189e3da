"""Run one cell of the port's benchmark once; see portbench/README.md.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path[0:1] = [ROOT]
    from portbench.harness.main import main

    sys.exit(main())
