"""Time two source trees' steady, lossy and check-quorum fused paths in ONE
process, alternating between the trees, and print one JSON line a run
(the same fields as compare_fused_paths.py).

    python3 raft_tpu_torch/tools/interleave_fused_paths.py \\
        TREE_A LABEL_A TREE_B LABEL_B [PAIRS] [OUT.jsonl]

compare_fused_paths.py runs each tree in its own process, so the host
noise of one process start, one build and one settle lands on one tree.
Here both trees' `raft_tpu_torch` and `chip_smoke` are imported side by
side (each tree's modules are put back in `sys.modules` before its turn),
the three settled states are built once with tree A's code, and each of
PAIRS pairs times every path's loop with each tree's own `chip_smoke.py`
timing phase, A first in even pairs and B first in odd ones.  Run it as a
file; it needs a CUDA card and builds both trees' kernels.
"""

import json
import os
import sys

_OWN = ("chip_smoke", "raft_tpu_torch")


def _is_own(name):
    return name in _OWN or name.startswith("raft_tpu_torch.")


def _import_tree(root):
    """Import `root`'s chip_smoke (and with it its raft_tpu_torch); return
    (the module, the tree's sys.modules entries), removing them from
    sys.modules."""
    _use({})
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    mods = {k: v for k, v in sys.modules.items() if _is_own(k)}
    for k in mods:
        del sys.modules[k]
    return chip_smoke, mods


def _use(mods):
    for k in [k for k in sys.modules if _is_own(k)]:
        del sys.modules[k]
    sys.modules.update(mods)


def main(argv):
    (root_a, label_a, root_b, label_b), rest = argv[:4], argv[4:]
    pairs = int(rest[0]) if rest else 5
    out = os.path.abspath(rest[1]) if len(rest) > 1 else None
    import torch

    dev = torch.device("cuda")
    trees = {}
    for label, root in ((label_a, root_a), (label_b, root_b)):
        cs, mods = _import_tree(os.path.abspath(root))
        _use(mods)
        cs.phase_build()
        trees[label] = (cs, mods)
    cs, mods = trees[label_a]
    _use(mods)
    cfg, st_main, _ = cs.run_main_path(dev)
    settled = dict(steady=st_main, lossy=cs.lossy_settle(dev, cs.G),
                   damped=cs.damped_settle(dev, cs.G))
    for i in range(pairs):
        order = (label_a, label_b) if i % 2 == 0 else (label_b, label_a)
        for label in order:
            cs, mods = trees[label]
            _use(mods)
            result = {"tree": label, "pair": i, "card": cs.card_line()}
            for name, t in (
                ("steady", cs.phase_timing(dev, cfg, settled["steady"])),
                ("lossy", cs.phase_lossy_timing(dev, settled["lossy"])),
                ("damped", cs.phase_damped_timing(dev, settled["damped"])),
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
