"""The port's step rates in two trees of the repo, run in turn in one call,
so that a change is priced against its parent on one card.

    python3 price_step.py OTHER_TREE [--pairs 3] [--steps 20]

Runs OTHER_TREE, this tree, OTHER_TREE, this tree, ... (``--pairs`` runs
of each), every run in fresh processes in its tree:

* ``largesteps_torch.benchmarks.bench``'s ``bench_step_nefertiti`` (the
  large-F path at nefertiti, ``--steps`` steps, rebins included) and
  ``bench_step`` (the main path's step, ``opt_iters_per_s``);
* the multiscale figure's ``--quick`` leg (``python -m
  largesteps_torch.figures.multiscale --quick``), whose JSON lines give
  each remesh's host seconds and each epoch's it/s.

Prints one JSON line a run (its tree, its order, the bench lines and the
leg's lines), then the card's name and power limit.  Needs a card.
"""
import argparse
import json
import os
import subprocess
import sys

BENCH = ("import json; from largesteps_torch.benchmarks import bench; "
         "lines = bench.bench_step_nefertiti(steps={steps}) "
         "+ [bench.bench_step()]; print(json.dumps(lines))")


def _json_lines(text):
    out = []
    for line in text.splitlines():
        if line.startswith("{"):
            try:
                out.append(json.loads(line))
            except ValueError:
                pass
    return out


def run(tree, steps):
    """One run in ``tree``: its bench lines and multiscale leg lines."""
    def call(*args):
        p = subprocess.run([sys.executable, *args], cwd=tree, text=True,
                           capture_output=True, check=False)
        if p.returncode:
            raise RuntimeError(f"{args} in {tree}: rc {p.returncode}\n"
                               f"{p.stderr[-2000:]}")
        return p.stdout
    bench = json.loads(call("-c", BENCH.format(steps=steps))
                       .strip().splitlines()[-1])
    leg = _json_lines(call("-m", "largesteps_torch.figures.multiscale",
                           "--quick"))
    return {"bench": {b["metric"]: b["value"] for b in bench},
            "multiscale": leg}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the tree to price against (its root)")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(args.other)
    for i in range(args.pairs):
        for name, tree in (("other", other), ("this", here)):
            print(json.dumps({"tree": name, "pair": i,
                              **run(tree, args.steps)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
