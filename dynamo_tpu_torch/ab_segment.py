"""Compare the segment attention kernel of two checkouts on one card.

    python3 -m dynamo_tpu_torch.ab_segment OTHER_TREE

OTHER_TREE is another checkout of the repo, for example the parent
commit's `git archive` unpacked into `build/`.  The trees run in turn,
other, this, this, other, each in a process of its own that builds its
kernels and times `chip_smoke.py` phase 3's three timed segment cases
(the Qwen2.5-VL-7B full and windowed layers over a 1288x728 image, CLIP
ViT-L/14-336 over two images) with its own `segment_case`, on the same
seeded inputs.  Prints the card line, each case's line tagged with
`"tree": "other"|"this"`, then one summary line per case: the mean device
ms of each tree, SDPA's (the four runs'), and this tree's bounds.  Needs a
CUDA card; takes about a minute per process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import json, sys, torch
import chip_smoke as cs
from dynamo_tpu_torch.ops import _build
_build.build_all()
# the first launch of the fill kernel behind time_ms's L2 flush loads it
# lazily and waits for the device, which the timing guard refuses
torch.empty(32 << 20, device="cuda").zero_()
torch.cuda.synchronize()
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
lay = cs.segment_layouts()
for name, cu, nh, hd in (("full", lay["full"], 16, 80), ("windowed", lay["window"], 16, 80),
                         ("clip", lay["clip"], 16, 64)):
    res = cs.segment_case(name, gen, cu, nh, hd, timed=True)
    print(json.dumps(dict(res, tree=sys.argv[1])), flush=True)
"""


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(argv[0])
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    lines = []
    for label in ("other", "this", "this", "other"):
        tree = other if label == "other" else ROOT
        proc = subprocess.run([sys.executable, "-c", _CHILD, label], cwd=tree,
                              env={**os.environ, "PYTHONPATH": tree},
                              capture_output=True, text=True)
        if proc.returncode:
            print(f"ab_segment: the {label} tree failed ({proc.returncode}):\n"
                  f"{proc.stderr[-3000:]}", file=sys.stderr)
            return 1
        for ln in proc.stdout.splitlines():
            if ln.startswith("{"):
                print(ln, flush=True)
                lines.append(json.loads(ln))
    for case in ("full", "windowed", "clip"):
        rows = [r for r in lines if r["case"] == case]
        this = [r for r in rows if r["tree"] == "this"]

        def mean(key, rs):
            return sum(r[key] for r in rs) / len(rs)

        print(json.dumps({
            "case": case,
            "this_ms": mean("ms", this),
            "other_ms": mean("ms", [r for r in rows if r["tree"] == "other"]),
            "library_ms": mean("library_ms", rows),
            "this_max_rel_err": max(r["max_rel_err"] for r in this),
            **{k: this[0][k] for k in ("bound_ms", "bound_by", "f32_bound_ms",
                                       "flops", "bytes")},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
