"""Time the damped, the chaos or the steady kernel's instances of one source
tree on the card, each held exactly to its plain version first, and print
one JSON line: per instance the cold and hot device milliseconds, the
bound of the plain version's work (`damped_work`, `chaos_work`,
`steady_work`) and of the body's (`damped_body_work`, `chaos_body_work`,
`steady_wide_body_work`, where the tree has it) and, where the tree's
library reports it, the occupancy (registers, local bytes, shared bytes a
block, threads a block, resident blocks an SM).

    python3 raft_tpu_torch/tools/damped_kernel_times.py TREE LABEL [OUT.jsonl]
        [--kernel damped|chaos|steady] [--variant agree=registers|shared]
        [--variant min_blocks=N] [--variant half_warp=N]
        [--variant select=rounds] [--peers P,P,...]

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
`--kernel steady` times the steady kernel past P = 7 at k = 32 on
100,000 groups settled through `run_compiled` (P = 8 to 65) or on
synthetic settled planes (`synthetic_steady_operands`: P = 96 and 128,
and P = 200 at k = 8, too wide for the general step's [P, P, G] planes at
this size): P = 8 to 15 on the tree's own instances, P = 8 to 12 also on
the warp instance (where the tree has one: `steady_kernel.launch` on
`_build.load_steady_warp_cuda()`), P = 16, 33, 64 and 65 bare, P = 65
`with_health`, and P = 16, 65 and 128 with the peer after each group's
leader down in every third group (`crashed`: the one-leader selections
then take radix steps) on the tree's instance for them; a P the tree's
kernel refuses is recorded as refused.

`--variant` measures a layout that the kernel does not ship: the tool
copies the tree's `csrc/` into `build/`, rewrites one constant of the
kernel's shape (`DampedShape` in `damped_round.cu`, `ChaosShape` in
`chaos_round.cu`, `kHalfWarpPeers` in `steady_warp_body.cuh`) in the copy
(`agree=registers` or `agree=shared` keeps the `[P, P]` agree block there
at every P, `min_blocks=N` asks `__launch_bounds__` for N resident blocks
at every P, `half_warp=N` gives groups up to P = N half a warp, 0 none;
`select=rounds` takes out the steady warp body's one-leader closed form,
so that every sent round runs the general selection) and builds the
kernel from the copy; the tree's own sources and libraries
stay as they are.

`--peers` keeps only the rows at those peer counts.

Run it as a file, not with `-m`: the tree's own `raft_tpu_torch` is the
one imported.  To compare commits, unpack each into a directory (`git
archive`) and run the script on them in turn on one card (parent, change,
change, parent); OUT.jsonl (optional) collects the lines.  Needs a CUDA
card.
"""

import argparse
import ctypes
import functools
import json
import os
import re
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

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
# The steady kernel's rows; "warp" runs the warp instance below its switch
# (P = 13), beside the thread-a-group instances there, "synthetic" the
# synthetic settled planes.
STEADY_ROWS = tuple(
    (f"P={n} k=32", n, K, 0, False, G, 0) for n in range(8, 16)
) + tuple(
    (f"P={n} k=32 warp", n, K, 0, False, G, 0) for n in range(8, 13)
) + (
    ("P=16 k=32", 16, K, 0, False, G, 0),
    ("P=33 k=32", 33, K, 0, False, G, 0),
    ("P=64 k=32", 64, K, 0, False, G, 0),
    ("P=65 k=32", 65, K, 0, False, G, 0),
    ("P=65 with_health k=32", 65, K, 0, True, G, 0),
    ("P=96 k=32 synthetic", 96, K, 0, False, G, 0),
    ("P=128 k=32 synthetic", 128, K, 0, False, G, 0),
    ("P=200 k=8 synthetic", 200, K8, 0, False, G, 0),
    ("P=16 k=32 crashed", 16, K, 0, False, G, 0),
    ("P=65 k=32 crashed", 65, K, 0, False, G, 0),
    ("P=128 k=32 synthetic crashed", 128, K, 0, False, G, 0),
)
ROWS = {"damped": DAMPED_ROWS, "chaos": CHAOS_ROWS, "steady": STEADY_ROWS}
# The shape constants that each variant rewrites: (the file of csrc/, with
# {kernel} for the kernel's name, and the constant's declaration).  The
# chaos and damped shapes name the first two so; half_warp is the steady
# warp body's widest half-warp group.
SHAPE_CONSTANTS = {
    "agree": ("{kernel}_round.cu", "static constexpr bool kShared"),
    "min_blocks": ("{kernel}_round.cu", "static constexpr int kMinBlocks"),
    "half_warp": ("steady_warp_body.cuh", "constexpr int kHalfWarpPeers"),
}
PLACES = {"registers": "false", "shared": "true"}
# The variants that rewrite a condition instead: (file, the text, its
# replacement by value).  select=rounds makes the one-leader tests false.
CONDITIONS = {
    "select": ("steady_warp_body.cuh", "n_lead == 1", {"rounds": "false"}),
}


def variant_csrc(build_dir, csrc, kernel, variants):
    """A copy of `csrc` under `build_dir` with `variants` ({"agree":
    "registers" or "shared", "min_blocks": N, "half_warp": N, "select":
    "rounds"}) written into the files SHAPE_CONSTANTS and CONDITIONS
    name."""
    tag = "-".join(f"{k}{v}" for k, v in sorted(variants.items()))
    out = Path(build_dir) / f"{kernel}_variant_{tag}" / "csrc"
    shutil.rmtree(out.parent, ignore_errors=True)
    shutil.copytree(csrc, out)
    for key, value in variants.items():
        if key in CONDITIONS:
            name, text, by_value = CONDITIONS[key]
            src = out / name
            body = src.read_text()
            if text not in body:
                raise SystemExit(f"{src}: no {text} to rewrite")
            src.write_text(body.replace(text, by_value[value]))
            continue
        name, head = SHAPE_CONSTANTS[key]
        src = out / name.format(kernel=kernel)
        text = src.read_text()
        pattern = re.compile(re.escape(head) + r" = [^;]*;")
        if len(pattern.findall(text)) != 1:
            raise SystemExit(f"{src}: no single {head} to rewrite")
        value = PLACES[value] if key == "agree" else str(int(value))
        src.write_text(pattern.sub(f"{head} = {value};", text))
    return out


STEADY_OUTPUTS = ("ee", "hb", "li", "lt", "matched", "commit")


def synthetic_steady_operands(n_peers, n_groups, dev):
    """steady_rounds' operands for a settled horizon at any width without
    the general step: every peer a member and a voter, alive, at term 5;
    the acting leader in slot g % P of group g, every log at index 100 (the
    acting row too), commit 100, the term's first index 50, one append a
    round; election timers spread over 0..9."""
    import torch

    i32 = torch.int32
    shape = (n_peers, n_groups)
    idx = torch.arange(n_groups, device=dev)
    state = torch.zeros(shape, dtype=i32, device=dev)
    state[idx % n_peers, idx] = 2
    ee = (torch.arange(n_peers * n_groups, device=dev) % 10).to(i32).view(shape)

    def full(v, s=shape, dtype=i32):
        return torch.full(s, v, dtype=dtype, device=dev)

    return (state, full(5), ee, full(0), full(100), full(5), full(100), full(100),
            full(True, dtype=torch.bool), full(True, dtype=torch.bool),
            full(False, dtype=torch.bool), full(50, (n_groups,)), full(1, (n_groups,)))


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

    if kernel == "steady":
        steady = cs.steady_kernel

        def steady_settle(dev, groups, n):
            cfg = cs.sim.SimConfig(n_groups=groups, n_peers=n)
            return cs.compiled_settle(cfg, dev, cs.SETTLE)

        def operands(st, n, loss, dev):
            crashed, append, _ = planes(n, 0, dev)
            return cs.fused_step.steady_operands(st, crashed, append), dict(
                election_tick=10, heartbeat_tick=1)

        def body_work(*work, with_loss=False, **flags):
            if not hasattr(steady, "steady_wide_body_work"):
                return None
            return steady.steady_wide_body_work(*work, **flags)

        return (_build.load_steady_cuda, cs.steady_rounds, cs.steady_rounds_reference,
                STEADY_OUTPUTS, lambda *work, with_loss=False, **flags: cs.steady_work(
                    *work, **flags), body_work, lambda loss, health: (int(health),),
                steady_settle, operands)

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
                    help="agree=registers|shared, min_blocks=N, half_warp=N or "
                    "select=rounds")
    ap.add_argument("--peers", default="", help="only the rows at these P (P,P,...)")
    opts = ap.parse_args(argv)
    variants = dict(v.split("=", 1) for v in opts.variant)
    if (not set(variants) <= set(SHAPE_CONSTANTS) | set(CONDITIONS)
            or variants.get("agree", "registers") not in PLACES
            or variants.get("select", "rounds") != "rounds"):
        ap.error("--variant takes agree=registers|shared, min_blocks=N, half_warp=N or "
                 f"select=rounds, not {opts.variant}")
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
    if opts.peers:
        keep = {int(n) for n in opts.peers.split(",")}
        rows = tuple(r for r in rows if r[1] in keep)
    peers = sorted({row[1] for row in rows})
    if variants:
        _build.CSRC = variant_csrc(_build.BUILD_DIR, _build.CSRC, opts.kernel, variants)
    loads = dict(zip(peers, peers))
    if opts.kernel == "steady" and hasattr(_build, "load_steady_warp_cuda"):
        loads["warp"] = None  # the warp instance, for P = 8..12 too
    with ThreadPoolExecutor(len(loads)) as pool:
        libs = dict(zip(loads, pool.map(
            lambda n: _build.load_steady_warp_cuda() if n is None else load(n),
            loads.values())))
    for name, (log, secs) in _build.build_log.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"build {name} {variants} in {secs:.1f}s: {len(regs)} instances, "
              f"registers {sorted(set(r.split('Used')[1].split(',')[0] for r in regs))}")
    dev = torch.device("cuda")
    occupancy = f"{opts.kernel}_round_occupancy"
    result = {"tree": opts.label, "kernel": opts.kernel, "variant": variants,
              "card": cs.card_line(), "rows": {}}
    steady = opts.kernel == "steady"
    settled = {n: settle(dev, G, n) for n in peers
               if not any(r[1] == n and "synthetic" in r[0] for r in rows)}
    warp_peers = getattr(_build, "STEADY_WARP_PEERS", None)
    for name, n, rounds, loss, health, groups, base in rows:
        warp = name.endswith(" warp")
        if warp and warp_peers is None:
            continue  # the tree has no warp instance
        # The warp rows name the warp library explicitly.
        run = (functools.partial(cs.steady_kernel.launch, libs["warp"]) if warp
               else kernel)
        if "synthetic" in name:
            args, kw = synthetic_steady_operands(n, groups, dev), dict(
                election_tick=10, heartbeat_tick=1)
        else:
            args, kw = operands(settled[n], n, loss, dev)
        if name.endswith(" crashed"):  # chip_smoke's crash_followers reads st.state
            crashed = cs.crash_followers(SimpleNamespace(state=args[0]), n, G, dev)
            args = args[:10] + (crashed,) + args[11:]
        args = tuple(None if a is None else a[..., G - groups:].contiguous()
                     for a in args)
        tsc = cs.random_tsc(groups, 6, dev) if health else None
        kw = dict(kw, rounds=rounds) if steady else dict(kw, rounds=rounds, group_base=base)
        full = args + ((tsc,) if health else ())
        work = (n, groups, rounds)
        flags = dict(with_loss=bool(loss), with_health=health)
        try:
            cs.compare(run, reference, names, args, kw, name, tsc)
            t = cs.kernel_times(dev, run, reference, full, kw,
                                plain_work(*work, **flags))
        except ValueError as err:  # a peer count the tree's kernel refuses
            result["rows"][name] = dict(refused=str(err))
            print(f"{opts.label} {opts.kernel} {name}: refused: {err}", flush=True)
            continue
        row = dict(ms=t["ms"], hot_ms=t["hot_ms"], bound_ms=t["bound_ms"],
                   share=t["bound_ms"] / t["ms"], plain_ms=t["plain_ms"])
        on_warp = steady and warp_peers is not None and (warp or n >= warp_peers)
        body = body_work(*work, **flags) if body_work is not None else None
        if body is not None and (on_warp or not steady):
            if steady:
                selections = cs.steady_kernel.warp_selections(
                    *(args[i] for i in (0, 8, 9, 10, 6)))
                body = body_work(*work, selections=selections, **flags)
                row["selections"] = selections
            nbytes, ops = body
            body_ms = max(nbytes / cs.HBM_BYTES_PER_S, ops / cs.OPS_PER_S) * 1e3
            row.update(body_bound_ms=body_ms, body_share=body_ms / t["ms"])
        lib = libs["warp"] if on_warp else libs[n]
        if hasattr(lib, occupancy):
            occ = (ctypes.c_int * 5)()
            rc = getattr(lib, occupancy)(n, *occ_flags(loss, health), occ)
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
