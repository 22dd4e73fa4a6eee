"""Time the damped or the chaos kernel's instances of one source tree on the
card, each held exactly to its plain version first, and print one JSON
line: per instance the cold and hot device milliseconds, the bound of the
plain version's work (`damped_work`, `chaos_work`) and of the body's
(`damped_body_work`, `chaos_body_work`, where the tree has it) and, where
the tree's library reports it, the occupancy (registers, local bytes,
shared bytes a block, threads a block, resident blocks an SM).

    python3 raft_tpu_torch/tools/damped_kernel_times.py TREE LABEL [OUT.jsonl]
        [--kernel damped|chaos] [--variant agree=registers|shared]
        [--variant min_blocks=N]

`--kernel damped` (the default) times the instances of `PERF.md` §6's
damped rows, from the tree's `chip_smoke.py` helpers on the check-quorum
settled state at 100,000 groups: P = 5 at k = 32 bare, `with_loss` (1 %)
and `with_health`; at k = 8 `with_health`, and `with_loss with_health`
(2 %) on 100,000 and on the last 50,000 groups, each at group base 0 and
50,000; P = 3, 7, 8, 11 and 15 at k = 32 bare, and P = 7 `with_loss
with_health` at k = 8.  `--kernel chaos` times §6's chaos rows on the
lossy-settled state at 100,000 groups under 1 % loss: P = 5 at k = 32
bare and `with_health`, `with_health` at k = 16 (the autopilot's
cadence), k = 32 bare on the last 50,000 groups at group base 50,000 (a
mesh rank's block); P = 3, 7, 8, 9 and 11 to 15 at k = 32 bare.

`--variant` measures a layout that the kernel does not ship: the tool
copies the tree's `csrc/` into `build/`, rewrites one constant of the
kernel's shape (`DampedShape` in `damped_round.cu`, `ChaosShape` in
`chaos_round.cu`) in the copy (`agree=registers` or `agree=shared` keeps
the `[P, P]` agree block there at every P, `min_blocks=N` asks
`__launch_bounds__` for N resident blocks at every P) and builds the
kernel from the copy; the tree's own sources and libraries stay as they
are.

Run it as a file, not with `-m`: the tree's own `raft_tpu_torch` is the
one imported.  To compare commits, unpack each into a directory (`git
archive`) and run the script on them in turn on one card (parent, change,
change, parent); OUT.jsonl (optional) collects the lines.  Needs a CUDA
card.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

G, P, WIDE_P, K, K8, K16 = 100_000, 5, 8, 32, 8, 16
HALF = 50_000
# (name, P, rounds, loss per ten thousand or 0, with_health, groups, base)
DAMPED_ROWS = (
    ("cq k=32", P, K, 0, False, G, 0),
    ("with_loss k=32", P, K, 100, False, G, 0),
    ("with_health k=32", P, K, 0, True, G, 0),
    ("with_health k=8", P, K8, 0, True, G, 0),
    ("with_loss with_health k=8", P, K8, 200, True, G, 0),
    ("with_loss with_health k=8 base 50000", P, K8, 200, True, G, HALF),
    ("with_loss with_health k=8 on 50000", P, K8, 200, True, HALF, 0),
    ("with_loss with_health k=8 on 50000 base 50000", P, K8, 200, True, HALF, HALF),
    ("P=8 cq k=32", WIDE_P, K, 0, False, G, 0),
    ("P=3 cq k=32", 3, K, 0, False, G, 0),
    ("P=7 cq k=32", 7, K, 0, False, G, 0),
    ("P=7 with_loss with_health k=8", 7, K8, 200, True, G, 0),
    ("P=11 cq k=32", 11, K, 0, False, G, 0),
    ("P=15 cq k=32", 15, K, 0, False, G, 0),
)
# The chaos kernel's rows, all at the lossy path's 1 % loss.
CHAOS_ROWS = (
    ("k=32", P, K, 100, False, G, 0),
    ("with_health k=32", P, K, 100, True, G, 0),
    ("with_health k=16", P, K16, 100, True, G, 0),
    ("k=32 on 50000 base 50000", P, K, 100, False, HALF, HALF),
    ("P=8 k=32", WIDE_P, K, 100, False, G, 0),
    ("P=3 k=32", 3, K, 100, False, G, 0),
    ("P=7 k=32", 7, K, 100, False, G, 0),
    ("P=9 k=32", 9, K, 100, False, G, 0),
    ("P=11 k=32", 11, K, 100, False, G, 0),
    ("P=12 k=32", 12, K, 100, False, G, 0),
    ("P=13 k=32", 13, K, 100, False, G, 0),
    ("P=14 k=32", 14, K, 100, False, G, 0),
    ("P=15 k=32", 15, K, 100, False, G, 0),
)
ROWS = {"damped": DAMPED_ROWS, "chaos": CHAOS_ROWS}
# The shape constants of csrc/{kernel}_round.cu that each variant rewrites
# (both kernels' shapes name them so).
SHAPE_CONSTANTS = {
    "agree": "static constexpr bool kShared",
    "min_blocks": "static constexpr int kMinBlocks",
}
PLACES = {"registers": "false", "shared": "true"}


def variant_csrc(build_dir, csrc, kernel, variants):
    """A copy of `csrc` under `build_dir` with `variants` ({"agree":
    "registers" or "shared", "min_blocks": N}) written into its
    `{kernel}_round.cu`."""
    tag = "-".join(f"{k}{v}" for k, v in sorted(variants.items()))
    out = Path(build_dir) / f"{kernel}_variant_{tag}" / "csrc"
    shutil.rmtree(out.parent, ignore_errors=True)
    shutil.copytree(csrc, out)
    src = out / f"{kernel}_round.cu"
    text = src.read_text()
    for key, value in variants.items():
        head = SHAPE_CONSTANTS[key]
        pattern = re.compile(re.escape(head) + r" = [^;]*;")
        if len(pattern.findall(text)) != 1:
            raise SystemExit(f"{src}: no single {head} to rewrite")
        value = PLACES[value] if key == "agree" else str(int(value))
        text = pattern.sub(f"{head} = {value};", text)
    src.write_text(text)
    return out


def kernel_api(cs, kernel):
    """(library loader, wrapper, plain version, output names, the plain
    version's work, the body's work or None, the occupancy call's flag
    arguments for (loss, health), the settle for P, and the operands and
    keywords of a row) of `kernel` from the tree's chip_smoke.py; each
    work count takes (P, G, rounds, with_loss=, with_health=)."""
    import torch

    from raft_tpu_torch.multiraft import _build

    def planes(n, loss, dev):
        crashed = torch.zeros((n, G), dtype=torch.bool, device=dev)
        append = torch.ones(G, dtype=torch.int32, device=dev)
        rates = torch.full((n, n, G), loss, dtype=torch.int32, device=dev) if loss else None
        return crashed, append, rates

    if kernel == "damped":
        def operands(st, n, loss, dev):
            return cs.fused_step.damped_operands(st, *planes(n, loss, dev)), dict(
                round_base=cs.CQ_SETTLE, election_tick=cs.CQ_TICK, heartbeat_tick=1,
                with_cq=True)

        return (_build.load_damped_cuda, cs.damped_rounds, cs.damped_rounds_reference,
                cs.DAMPED_OUTPUTS, cs.damped_work, getattr(cs, "damped_body_work", None),
                lambda loss, health: (1, int(bool(loss)), int(health)),
                cs.damped_settle, operands)

    def operands(st, n, loss, dev):
        return cs.fused_step.chaos_operands(st, *planes(n, loss, dev)), dict(
            round_base=cs.LOSSY_SETTLE, election_tick=cs.LOSSY_TICK, heartbeat_tick=1)

    def lossy(count):  # the chaos kernel always draws: with_loss is implied
        if count is None:
            return None
        return lambda *work, with_loss=True, **flags: count(*work, **flags)

    return (_build.load_chaos_cuda, cs.chaos_rounds, cs.chaos_rounds_reference,
            cs.CHAOS_OUTPUTS, lossy(cs.chaos_work), lossy(getattr(cs, "chaos_body_work", None)),
            lambda loss, health: (int(health),), cs.lossy_settle, operands)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree")
    ap.add_argument("label")
    ap.add_argument("out", nargs="?")
    ap.add_argument("--kernel", choices=sorted(ROWS), default="damped")
    ap.add_argument("--variant", action="append", default=[],
                    help="agree=registers|shared or min_blocks=N")
    opts = ap.parse_args(argv)
    variants = dict(v.split("=", 1) for v in opts.variant)
    if not set(variants) <= set(SHAPE_CONSTANTS) or variants.get("agree", "registers") not in PLACES:
        ap.error(f"--variant takes agree=registers|shared or min_blocks=N, not {opts.variant}")
    root = os.path.abspath(opts.tree)
    out = os.path.abspath(opts.out) if opts.out else None
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from raft_tpu_torch.multiraft import _build

    (load, kernel, reference, names, plain_work, body_work, occ_flags, settle,
     operands) = kernel_api(cs, opts.kernel)
    rows = ROWS[opts.kernel]
    peers = sorted({row[1] for row in rows})
    if variants:
        _build.CSRC = variant_csrc(_build.BUILD_DIR, _build.CSRC, opts.kernel, variants)
    with ThreadPoolExecutor(len(peers)) as pool:
        libs = dict(zip(peers, pool.map(load, peers)))
    for name, (log, secs) in _build.build_log.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"build {name} {variants} in {secs:.1f}s: {len(regs)} instances, "
              f"registers {sorted(set(r.split('Used')[1].split(',')[0] for r in regs))}")
    dev = torch.device("cuda")
    occupancy = f"{opts.kernel}_round_occupancy"
    result = {"tree": opts.label, "kernel": opts.kernel, "variant": variants,
              "card": cs.card_line(), "rows": {}}
    settled = {n: settle(dev, G, n) for n in peers}
    for name, n, rounds, loss, health, groups, base in rows:
        args, kw = operands(settled[n], n, loss, dev)
        args = tuple(None if a is None else a[..., G - groups:].contiguous()
                     for a in args)
        tsc = cs.random_tsc(groups, 6, dev) if health else None
        kw = dict(kw, rounds=rounds, group_base=base)
        cs.compare(kernel, reference, names, args, kw, name, tsc)
        full = args + ((tsc,) if health else ())
        work = (n, groups, rounds)
        flags = dict(with_loss=bool(loss), with_health=health)
        t = cs.kernel_times(dev, kernel, reference, full, kw, plain_work(*work, **flags))
        row = dict(ms=t["ms"], hot_ms=t["hot_ms"], bound_ms=t["bound_ms"],
                   share=t["bound_ms"] / t["ms"])
        if body_work is not None:
            nbytes, ops = body_work(*work, **flags)
            body_ms = max(nbytes / cs.HBM_BYTES_PER_S, ops / cs.OPS_PER_S) * 1e3
            row.update(body_bound_ms=body_ms, body_share=body_ms / t["ms"])
        if hasattr(libs[n], occupancy):
            occ = (ctypes.c_int * 5)()
            rc = getattr(libs[n], occupancy)(n, *occ_flags(loss, health), occ)
            if rc != 0:
                raise RuntimeError(f"{occupancy} failed: CUDA error {rc}")
            row.update(zip(("registers", "local_bytes", "shared_bytes", "threads",
                            "blocks_per_sm"), occ))
        result["rows"][name] = row
        print(f"{opts.label} {opts.kernel} {name}: {json.dumps(row)}", flush=True)
    line = json.dumps(result)
    print("RESULT " + line, flush=True)
    if out is not None:
        with open(out, "a", encoding="utf-8") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
