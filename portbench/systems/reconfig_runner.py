"""The system under test for deployments that state their membership and
run conf changes: the port's multi-Raft engine, `raft_tpu_torch`, driven
through its dispatcher and its reconfig runner.

A configuration may state `voters` and `learners` (1-based slots; a slot
in neither is empty, and without either key every slot votes); the fleet
starts in that membership.  A block in which no chain of conf changes
starts or runs is the dispatcher's, `fused_step.fast_multi_round(cfg, k,
count_fused=True)`, as in systems/fast_multi_round.py.  Any other block
is k rounds of the reconfig runner's round, `reconfig._runner_body`
(`sim.step(reconfig_propose=)`, the commit gate, `kernels.apply_confchange`),
over a one-block schedule that holds the groups' chains and, where the
block crashes a peer, its crash mask.  One host `bool()` a block picks
the branch, and one more a chain block whether it crashes a peer.

The state is the program's `SimState` with the conf-change protocol's
fields beside it, under the names the benchmark's reference gives them
(reference/confchange.py): the runner's `ReconfigState` (stage, op
pointer, owner, index, term), each group's chain length and its steps'
target masks.
"""

from __future__ import annotations

from collections import namedtuple

import torch

# The conf-change fields of the state, and the deepest chain (PD's
# move-peer), as reference/confchange.py names and sizes them.
CC_FIELDS = ("cc_stage", "cc_step", "cc_owner", "cc_index", "cc_term", "cc_len",
             "cc_voter", "cc_outgoing", "cc_learner")
STEPS = 4


class Program:
    """A deployment's engine, membership and conf changes included.  Every
    state it returns is fresh."""

    def __init__(self, conf: dict, device):
        from raft_tpu_torch.multiraft import chaos, fused_step, kernels, reconfig, sim

        self._sim, self._fused, self._chaos = sim, fused_step, chaos
        self._kernels, self._reconfig = kernels, reconfig
        self.device = device
        self.k = conf["block_rounds"]
        self.cfg = sim.SimConfig(
            n_groups=conf["n_groups"], n_peers=conf["n_peers"],
            election_tick=conf["election_tick"],
            heartbeat_tick=conf["heartbeat_tick"],
            check_quorum=conf["check_quorum"], pre_vote=conf["pre_vote"],
        )
        P, G = self.cfg.n_peers, self.cfg.n_groups
        self.voters = conf.get("voters", list(range(1, P + 1)))
        self.learners = conf.get("learners", [])
        damped = conf["check_quorum"] or conf["pre_vote"]
        self.fused_kernel = "damped_round_kernel" if damped else "steady_round_kernel"
        self.State = namedtuple("ReconfigRunnerState", sim.SimState._fields + CC_FIELDS)
        self._n_sim = len(sim.SimState._fields)
        self._block = fused_step.fast_multi_round(self.cfg, self.k, count_fused=True)
        self._health = None
        # The one-block fault schedule's fixed planes: every link up, no loss.
        self._links = kernels.pack_bits(
            torch.ones((P * P, G), dtype=torch.bool, device=device))[None]
        self._no_loss = kernels.pack_u16_pairs(
            torch.zeros((P * P, G), dtype=torch.int32, device=device))[None]

    def prepare(self) -> None:
        """Build the fused kernel's library, or load it from the build
        cache (the checkout's `build/`)."""
        if self.device.type != "cuda":
            return
        from raft_tpu_torch.multiraft import _build

        load = (_build.load_damped_cuda if self.fused_kernel.startswith("damped")
                else _build.load_steady_cuda)
        load(self.cfg.n_peers)

    def _mask(self, slots):
        m = torch.zeros((self.cfg.n_peers, self.cfg.n_groups), dtype=torch.bool,
                        device=self.device)
        for s in slots:
            m[s - 1] = True
        return m

    def init_state(self):
        P, G = self.cfg.n_peers, self.cfg.n_groups
        st = self._sim.init_state(self.cfg, self._mask(self.voters), None,
                                  self._mask(self.learners), device=self.device)
        z = torch.zeros((G,), dtype=torch.int32, device=self.device)
        m = torch.zeros((STEPS, P, G), dtype=torch.bool, device=self.device)
        return self.State(*st, z, z.clone(), z.clone(), z.clone(), z.clone(), z.clone(),
                          m, m.clone(), m.clone())

    def _split(self, st):
        return self._sim.SimState(*st[:self._n_sim]), st[self._n_sim:]

    def step(self, st, crashed, append):
        """One general round (set-up's settle); no chain runs."""
        sim_st, cc = self._split(st)
        return self.State(*self._sim.step(self.cfg, sim_st, crashed, append), *cc)

    def steady(self, st, crashed) -> bool:
        """The dispatcher's whole-batch predicate for a k-round block, over
        the members: the predicate asks every alive slot to be at the
        leader's term, and an empty slot, which no leader replicates to,
        never is.  The dispatcher itself asks the whole predicate, so a
        fleet with an empty slot runs its blocks on the general branch."""
        sim_st, _ = self._split(st)
        empty = ~(sim_st.voter_mask | sim_st.outgoing_mask | sim_st.learner_mask)
        return bool(self._fused.steady_predicate(self.cfg, sim_st, crashed | empty,
                                                 horizon=self.k))

    def _start(self, st, req):
        """The request's chains, in the groups whose chain has ended."""
        K = req.voter.shape[0]
        if K > STEPS:
            raise ValueError(f"a chain of {K} steps; the state holds {STEPS}")
        take = req.start & (st.cc_step >= st.cc_len) & (st.cc_stage == 0)

        def pad(m, old):
            out = torch.zeros_like(old)
            out[:K] = m
            return torch.where(take[None, None, :], out, old)

        voter = pad(req.voter, st.cc_voter)
        # A step whose target has no voter ends the chain.
        steps = torch.cumprod(voter.any(1).to(torch.int32), 0).sum(0, dtype=torch.int32)
        return st._replace(
            cc_stage=torch.where(take, 0, st.cc_stage),
            cc_step=torch.where(take, 0, st.cc_step),
            cc_len=torch.where(take, steps, st.cc_len), cc_voter=voter,
            cc_outgoing=pad(req.outgoing, st.cc_outgoing),
            cc_learner=pad(req.learner, st.cc_learner))

    def block(self, st, crashed, append, fused: int, confchanges=None):
        """k rounds; returns (state, fused group-rounds so far), the count
        a Python int."""
        if confchanges is not None:
            st = self._start(st, confchanges)
        sim_st, cc = self._split(st)
        if not bool(((st.cc_step < st.cc_len) | (st.cc_stage > 0)).any()):
            out, fused = self._block(sim_st, crashed, append, fused)
            return self.State(*out, *cc), fused
        return self._chain_block(st, sim_st, crashed, append), fused

    def _chain_block(self, st, sim_st, crashed, append):
        """k rounds of the reconfig runner's round over the groups' chains."""
        reconfig, P, G, k = self._reconfig, self.cfg.n_peers, self.cfg.n_groups, self.k
        dev = self.device
        # Each step adds and removes members against the step before it;
        # the first, against the masks now (once applied it never reapplies).
        member = st.cc_voter | st.cc_outgoing | st.cc_learner
        now = sim_st.voter_mask | sim_st.outgoing_mask | sim_st.learner_mask
        before = torch.cat([now[None], member[:-1]])
        no_round = torch.zeros((k,), dtype=torch.int32)
        sched = reconfig.CompiledReconfig(
            phase_of_round=no_round, append=append[None],
            op_start=torch.zeros((STEPS, G), dtype=torch.int32, device=dev),
            n_ops=st.cc_len, tgt_voter=st.cc_voter, tgt_outgoing=st.cc_outgoing,
            tgt_learner=st.cc_learner, added=member & ~before, removed=before & ~member,
            n_peers=P)
        # The runner takes crashes from a fault schedule, which routes a
        # plain configuration's round through the link-gated one: only a
        # block with a crash gets one.
        faults = None
        if bool(crashed.any()):
            faults = self._chaos.CompiledChaos(
                phase_of_round=no_round, link_packed=self._links, loss_packed=self._no_loss,
                crashed_packed=self._kernels.pack_bits(crashed)[None],
                append=torch.zeros((1, G), dtype=torch.int32, device=dev), n_peers=P)
        body = reconfig._runner_body(self.cfg, sched, faults)
        if self._health is None:
            self._health = self._sim.init_health(self.cfg, dev)
        rst = reconfig.ReconfigState(
            stage=st.cc_stage, op_ptr=st.cc_step, prop_owner=st.cc_owner,
            prop_index=st.cc_index, prop_term=st.cc_term,
            prev_voter=sim_st.voter_mask, prev_outgoing=sim_st.outgoing_mask)
        carry = (sim_st, self._health, rst) + reconfig._zero_accumulators(dev)
        for r in range(k):
            carry = body(carry, r)
        out, self._health, rst = carry[:3]
        return self.State(*out, rst.stage, rst.op_ptr, rst.prop_owner, rst.prop_index,
                          rst.prop_term, st.cc_len, st.cc_voter, st.cc_outgoing,
                          st.cc_learner)
