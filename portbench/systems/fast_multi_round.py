"""The system under test: the port's multi-Raft engine, `raft_tpu_torch`,
driven through its dispatcher.

A configuration names its system (`"system"`), a module under systems/
with a class `Program(conf, device)`; these modules are the only ones of
the benchmark that import the program.  The benchmark takes from this one the entry that the window drives
(`fused_step.fast_multi_round(cfg, k, count_fused=True)`: a block of k
rounds on the fused kernel when the whole-batch steady predicate holds,
else k general `sim.step`s), the general step and initial state that
set-up settles with, and the fused kernels' names, which the trace
reader looks for.
"""

from __future__ import annotations


class Program:
    """A deployment's engine.  Every state it returns is fresh: the
    program never writes a plane in place, so the harness may keep a
    block's input and output states."""

    def __init__(self, conf: dict, device):
        from raft_tpu_torch.multiraft import fused_step, sim

        self._sim, self._fused = sim, fused_step
        self.device = device
        self.k = conf["block_rounds"]
        self.cfg = sim.SimConfig(
            n_groups=conf["n_groups"], n_peers=conf["n_peers"],
            election_tick=conf["election_tick"],
            heartbeat_tick=conf["heartbeat_tick"],
            check_quorum=conf["check_quorum"], pre_vote=conf["pre_vote"],
        )
        damped = conf["check_quorum"] or conf["pre_vote"]
        # csrc/damped_round.cu or csrc/steady_round.cu (P <= 12).
        self.fused_kernel = "damped_round_kernel" if damped else "steady_round_kernel"
        self._block = fused_step.fast_multi_round(self.cfg, self.k, count_fused=True)

    def prepare(self) -> None:
        """Build the fused kernel's library, or load it from the build
        cache (the checkout's `build/`)."""
        if self.device.type != "cuda":
            return
        from raft_tpu_torch.multiraft import _build

        load = (_build.load_damped_cuda if self.fused_kernel.startswith("damped")
                else _build.load_steady_cuda)
        load(self.cfg.n_peers)

    def init_state(self):
        return self._sim.init_state(self.cfg, device=self.device)

    def step(self, st, crashed, append):
        """One general round (set-up's settle)."""
        return self._sim.step(self.cfg, st, crashed, append)

    def steady(self, st, crashed) -> bool:
        """The dispatcher's whole-batch predicate for a k-round block."""
        return bool(self._fused.steady_predicate(self.cfg, st, crashed, horizon=self.k))

    def block(self, st, crashed, append, fused: int):
        """k rounds; returns (state, fused group-rounds so far), the count
        a Python int."""
        return self._block(st, crashed, append, fused)
