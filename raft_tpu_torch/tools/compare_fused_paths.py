"""Time the steady, lossy and check-quorum fused paths of one source tree
with that tree's own `chip_smoke.py` timing phases, and print one JSON
line: the ticks/s samples and median, the fused kernel's time, the
profiled device-busy microseconds and the fused fraction of each path.

    python3 raft_tpu_torch/tools/compare_fused_paths.py TREE LABEL [OUT.jsonl]

Run it as a file, not with `-m`: the tree's own `raft_tpu_torch` must be
the one imported.  To compare two commits, unpack each into a directory
(`git archive`) and run the script on them in turn on one card, for
example parent, change, change, parent; OUT.jsonl (optional) collects
the lines.  Needs a CUDA card and builds the tree's kernels.
"""

import json
import os
import sys


def main(argv):
    root, label = os.path.abspath(argv[0]), argv[1]
    out = os.path.abspath(argv[2]) if len(argv) > 2 else None
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda")
    cs.phase_build()
    cfg, st, _ = cs.run_main_path(dev)
    result = {"tree": label, "card": cs.card_line()}
    for name, t in (
        ("steady", cs.phase_timing(dev, cfg, st)),
        ("lossy", cs.phase_lossy_timing(dev, cs.lossy_settle(dev, cs.G))),
        ("damped", cs.phase_damped_timing(dev, cs.damped_settle(dev, cs.G))),
    ):
        result[name] = dict(
            median=t["ticks_per_s_median"], samples=t["ticks_per_s"],
            kernel_ms=t["ms"], busy_us=t["profile"]["busy_us"],
            wall_us=t["profile"]["wall_us"], fused_frac=t["fused_frac"])
    line = json.dumps(result)
    print("RESULT " + line, flush=True)
    if out is not None:
        with open(out, "a", encoding="utf-8") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
