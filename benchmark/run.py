"""Run one cell of the benchmark on this machine's chips and print its
result line (the last line of standard output).

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

--control puts the configuration's control in the program's place and
--fault <name> plants a fault in the program: checks of the comparison that
decides `correct`, not benchmark runs.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default="", help="plant a fault (benchmark/lib/faults.py)")
    a = p.parse_args(argv)
    from benchmark.lib import runner

    rc, result = runner.run(a.workload, a.seed, a.seconds, bool(a.trace), T_START,
                            control=a.control, fault=a.fault)
    if rc or result is None:
        return rc or 1
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
