"""CUDA-graph capture with a device-side branch.

The reference advances many rounds as one jitted `lax.scan`, and inside a
round it gates the plain step's election phase with `lax.cond(any(req))`
(`raft_tpu/multiraft/sim.py`, the plain `step`).  The port's counterpart of
the scan is a CUDA graph of one round, replayed (`sim.ClusterSim
.run_compiled`); its counterpart of the cond is :func:`cond`:

  * outside a capture it is a host branch, `true_fn(*operands)` if the
    0-d bool `pred` holds, else `false_fn(*operands)`: one device sync,
    the eager rounds' behaviour;
  * while a graph is being captured inside a :class:`Capture`, it captures
    the true branch into a graph of its own (a private memory pool, on a
    side stream) and adds that graph to the outer capture as the body of a
    CUDA conditional IF node (`csrc/graph_cond.cu`).  The false branch's
    values are written into the true branch's outputs just before the
    node, so at replay the device picks, with no host sync, and what
    follows reads one set of tensors.

Both branches must return tuples of tensors of equal shapes and dtypes and
be pure (no in-place writes to their operands), as `lax.cond`'s branches
are.  PyTorch 2.11 has no conditional node of its own (its
`torch._higher_order_ops.cudagraph_conditional_nodes` came later), so the
node is added through the CUDA runtime on the capturing stream.
"""

from __future__ import annotations

import contextvars
import ctypes
from typing import Callable, List, Sequence, Tuple

import torch

from . import _build

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("graph_capture", default=None)


class Capture:
    """The bookkeeping of one graph capture: the branch graphs that
    :func:`cond` adds (kept alive with their memory pools for as long as
    this object lives, which must be as long as the outer graph) and the
    side stream their captures run on.  Enter it around the captured code:

        cap = Capture()
        with torch.cuda.graph(g, capture_error_mode="relaxed"), cap:
            out = fn(*static_inputs)
    """

    def __init__(self) -> None:
        self.bodies: List[Tuple[torch.cuda.CUDAGraph, Tuple[torch.Tensor, ...]]] = []
        self.side = torch.cuda.Stream()
        self._token = None

    def __enter__(self) -> "Capture":
        self._token = _ACTIVE.set(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.reset(self._token)

    def body_nodes(self) -> int:
        """The branch graphs' nodes, summed."""
        return sum(node_count(g) for g, _ in self.bodies)


def node_count(graph: torch.cuda.CUDAGraph) -> int:
    """The top-level node count of a graph captured with keep_graph=True
    (a conditional node counts one; its body is counted apart)."""
    n = ctypes.c_ulonglong(0)
    rc = _build.load_graph_cuda().graph_node_count(
        ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.byref(n)
    )
    if rc != 0:
        raise RuntimeError(f"cudaGraphGetNodes failed: CUDA error {rc}")
    return n.value


def cond(
    pred: torch.Tensor,
    true_fn: Callable[..., Sequence[torch.Tensor]],
    false_fn: Callable[..., Sequence[torch.Tensor]],
    operands: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, ...]:
    """`true_fn(*operands)` where the 0-d bool `pred` is True, else
    `false_fn(*operands)`: a host branch outside a CUDA graph capture, a
    conditional node inside one (module docstring)."""
    if not (pred.is_cuda and torch.cuda.is_current_stream_capturing()):
        return tuple(true_fn(*operands) if bool(pred) else false_fn(*operands))
    cap = _ACTIVE.get()
    if cap is None:
        raise RuntimeError(
            "graphs.cond inside a CUDA graph capture needs an active "
            "graphs.Capture to hold its branch graph"
        )
    outer = torch.cuda.current_stream()
    default = tuple(false_fn(*operands))
    body = torch.cuda.CUDAGraph(keep_graph=True)
    taken = {t.data_ptr() for t in operands}
    with torch.cuda.stream(cap.side):
        body.capture_begin(capture_error_mode="relaxed")
        try:
            # An output that is an operand would be overwritten by the
            # false branch's copy below: give it storage of its own.
            outs = tuple(
                o.clone() if o.data_ptr() in taken else o
                for o in true_fn(*operands)
            )
        finally:
            body.capture_end()
    if [(o.shape, o.dtype) for o in outs] != [(d.shape, d.dtype) for d in default]:
        raise ValueError("graphs.cond: the branches' outputs differ in shape or dtype")
    for o, d in zip(outs, default):
        o.copy_(d)
    rc = _build.load_graph_cuda().graph_if_node(
        ctypes.c_void_p(outer.cuda_stream), ctypes.c_void_p(pred.data_ptr()),
        ctypes.c_void_p(body.raw_cuda_graph()),
    )
    if rc != 0:
        raise RuntimeError(f"adding the conditional graph node failed: CUDA error {rc}")
    cap.bodies.append((body, outs))
    return outs
