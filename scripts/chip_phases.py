"""Run some phases of a checkout's chip_smoke.py, each a number of times, on
one NVIDIA GPU.

    python scripts/chip_phases.py [--root DIR] [--repeat N] [--seed S] [--build] PHASE...

Imports chip_smoke.py (and so txt2vid_tpu_torch) from DIR, by default this
checkout, so a `git archive` of another commit unpacked under build/ runs
its own phases: e.g. `--root build/parent families` beside `families`
compares two trees' phase families on one card. Runs phase device first and,
with --build, phase build (the kernels; phase families needs none). Each
PHASE is a chip_smoke.phase_<PHASE>(seed) that takes only the seed
(families, parallel, ingest, txt, serve, train, ...); each run prints its
seconds. Exits non-zero on the first failing phase.
"""

import argparse
import sys
import time
from pathlib import Path


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--build", action="store_true")
    p.add_argument("phases", nargs="+")
    args = p.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke
    print(f"chip_phases: chip_smoke from {chip_smoke.__file__}")
    _, smi = chip_smoke.phase_device()
    if args.build:
        chip_smoke.phase_build()
    for i in range(args.repeat):
        for name in args.phases:
            t0 = time.perf_counter()
            getattr(chip_smoke, f"phase_{name}")(args.seed)
            print(f"chip_phases: run {i + 1} of {args.repeat}: phase {name}: "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
    print(smi)


if __name__ == "__main__":
    main()
