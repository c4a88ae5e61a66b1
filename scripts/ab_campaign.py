#!/usr/bin/env python3
"""Run the paper's campaign grid in two source trees on one card.

Each tree is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory, and the working
tree).  Every run is a fresh process that imports ``repro_torch`` from that
tree and drives ``chip_smoke.py``'s phase-6 grid (Llama 3.1 8B and
SmolVLM, both modes, nodes 3-28 nm: 28 cells in 4 batches of 7 x 64 lanes,
4,613 episodes a cell, default gate, seed 0) through ``python -m
repro_torch.launch.dse --campaign`` on ``cuda``, into a fresh campaign
root under the git-ignored ``experiments/campaigns/ab_campaign/``.  The
kernels of both trees are built first, so no timed run includes ``nvcc``.
Runs go in the order given (default P C C P), one JSON line each: the
grid's wall time, the kernels' launch counts and every cell's ppa_score;
then one line naming the cells whose ppa_score differs between the trees'
first runs (a new sum order in a kernel is a new search).

    python3 scripts/ab_campaign.py --trees experiments/dse/parent .
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r"""
import json, os, shutil, sys, time
import torch
tree, root, mode, grid = sys.argv[1:5]
sys.path.insert(0, tree + "/src")
from repro_torch.kernels import build, ops
if mode == "build":
    build.library()
    print(json.dumps({"built": build.build().name}))
    raise SystemExit
from repro_torch.campaign import CampaignStore
from repro_torch.launch import dse
spec = json.loads(grid)
shutil.rmtree(root, ignore_errors=True)
os.makedirs(root)
path = os.path.join(root, "grid.json")
with open(path, "w") as f:
    json.dump(spec, f)
ops.reset_launch_counts()
torch.cuda.synchronize()
t = time.perf_counter()
dse.main(["--campaign", path, "--campaign-root", root, "--device", "cuda"])
torch.cuda.synchronize()
wall = time.perf_counter() - t
store = CampaignStore.open(os.path.join(root, spec["name"]))
scores = {cid: s["ppa_score"] for cid, s in sorted(store.summaries().items())}
print(json.dumps(dict(wall_s=wall, cells=len(scores),
                      launches=ops.launch_counts(), ppa_score=scores)))
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, required=True, metavar=("P", "C"))
    ap.add_argument("--order", default="PCCP")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    from chip_smoke import GRID
    trees = dict(zip("PC", (os.path.abspath(t) for t in a.trees)))
    out = os.path.join(ROOT, "experiments", "campaigns", "ab_campaign")

    def call(label, mode, run=0):
        res = subprocess.run(
            [sys.executable, "-c", RUN, trees[label],
             os.path.join(out, f"{run}{label}"), mode, json.dumps(GRID)],
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            sys.exit(f"{label} {mode} failed:\n{res.stderr[-4000:]}")
        return json.loads(res.stdout.strip().splitlines()[-1])

    for label in "PC":
        print(json.dumps(dict(tree=label, **call(label, "build"))),
              flush=True)
    first = {}
    for i, label in enumerate(a.order):
        res = call(label, "time", i)
        first.setdefault(label, res["ppa_score"])
        print(json.dumps(dict(run=i, tree=label, **res)), flush=True)
    if len(first) == 2:
        moved = {cid: [first["P"][cid], first["C"].get(cid)]
                 for cid in first["P"] if first["P"][cid]
                 != first["C"].get(cid)}
        print(json.dumps(dict(cells_moved=len(moved), moved=moved)),
              flush=True)


if __name__ == "__main__":
    main()
