"""Compare `chip_smoke.py` phase 8 between two checkouts on one card.

    python3 -m dynamo_tpu_torch.ab_device_loop OTHER_TREE [ARMS]

OTHER_TREE is another checkout of the repo, for example the parent
commit's `git archive` unpacked into `build/`.  The trees run in turn,
other, this, this, other, each in a process of its own that builds its
kernels, makes phase 4's seeded and sharpened Llama-3.1-8B and runs
`phase_device_loop` over the arms whose names start with a letter of
ARMS (default "ab": arms (a) and (b)).  Prints the card line, then each
arm's latency and trace lines tagged with `"tree": "other"|"this"`.
Needs a CUDA card; takes about 100 s per process.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import sys, torch
import chip_smoke as cs
label, arms = sys.argv[1], sys.argv[2]
cs.DEVICE_LOOP_ARMS = {k: v for k, v in cs.DEVICE_LOOP_ARMS.items() if k[0] in arms}
cs.spec_accepting = lambda cfg: None
emit = cs.emit
cs.emit = lambda obj: (emit(dict(obj, tree=label))
                       if obj.get("what") in ("latency", "trace") else None)
from dynamo_tpu_torch.models import LLAMA_3_1_8B, init_params
from dynamo_tpu_torch.ops import _build
_build.build_all()
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
model = init_params(LLAMA_3_1_8B, gen, dtype=torch.bfloat16, device="cuda")
cs.sharpen(model)
cs.phase_device_loop(model, LLAMA_3_1_8B)
"""


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(argv[0])
    arms = argv[1] if len(argv) > 1 else "ab"
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    for label in ("other", "this", "this", "other"):
        tree = other if label == "other" else ROOT
        proc = subprocess.run([sys.executable, "-c", _CHILD, label, arms],
                              cwd=tree, env={**os.environ, "PYTHONPATH": tree})
        if proc.returncode:
            print(f"ab_device_loop: the {label} tree failed "
                  f"({proc.returncode})", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
