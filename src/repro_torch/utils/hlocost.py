"""Loop-aware cost counting of one call: FLOPs, bytes and collectives
(``repro.utils.hlocost`` counterpart).

The reference parses a compiled HLO module and multiplies each while-loop
body by its trip count, because XLA's own cost analysis counts a loop body
once. Eager PyTorch has no HLO and no loops of its own: every layer and
every micro-batch dispatches its operators again. So ``analyze`` runs the
function under a ``TorchDispatchMode`` and counts each ATen operator as it
is dispatched, forward and backward alike, which is loop-aware by
construction. It works on fake tensors (``FakeTensorMode``), so a
full-size model is counted without allocating its memory.

What is counted, per dispatched operator (the port's own model, written to
mirror the reference's choices; it is not XLA's cost model):

  * ``dot_flops``: the operators in ``torch.utils.flop_counter``'s registry
    (mm, bmm, addmm, baddbmm, convolution, SDPA), by its formulas (2·M·N·K);
  * ``flops``: ``dot_flops`` plus, for elementwise and reducing operators
    (``_ELEMENTWISE_FLOPS``, after the reference's list), one per output
    element (a few for the fused composites, softmax and SiLU);
  * ``bytes``: operand plus result bytes of the operators that must touch
    device memory (``_HBM_OPS``: matmuls, reductions, sort / top-k,
    concatenation, padding, random fills). Gathers and index reads count
    twice their result (the window read and written); index_put / scatter
    and copies into an existing tensor twice their update. Views, layout
    changes and elementwise math count no bytes: they are taken to fuse
    into their neighbours, as in the reference's fusion-optimistic model.
    A slice is a view in eager PyTorch, so its bytes are those its reader
    counts;
  * collectives (c10d and functional): result bytes per participant and a
    count, under the reference's kind names (``"all-gather"``, ...).

``kernelized=True`` leaves out the bytes of the attention-score matmuls
(the reference's ``VMEM_SCORE_MARKERS``): every batched matmul whose two
operands are both activations, that is, derived from no tensor of
``weights`` (default: the leaves of the first argument) through views,
casts and collectives. A flash kernel keeps those scores on chip.

``CostCounter.was_read`` tells whether any operator but a view read a
tensor's storage: an argument that nothing reads is one a compiled program
drops (``jax.jit``'s ``keep_unused=False``), and the dry run leaves it out of
the arguments' bytes, as the reference's compiled cells do.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "_c10d_functional_autograd")

_PRIM_DEVICE = torch.ops.prim.device.default  # a ``.device`` read: no work
_BATCHED_DOTS = {"bmm", "baddbmm"}

# flops per output element (the reference's _ELEMENTWISE_FLOPS, by ATen name)
_ELEMENTWISE_FLOPS = {
    **dict.fromkeys((
        "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "abs",
        "neg", "exp", "tanh", "log", "rsqrt", "sqrt", "pow", "eq", "ne", "lt", "le", "gt", "ge", "where",
        "logical_and", "logical_or", "bitwise_and", "bitwise_or", "floor", "ceil", "sin", "cos", "_to_copy",
        "sigmoid", "reciprocal", "erf", "log1p", "expm1", "exp2", "sign", "square",
        "sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all", "argmax", "argmin", "cumsum",
        "logsumexp",
    ), 1),
    "silu": 2, "gelu": 4, "_softmax": 3, "_log_softmax": 3, "softplus": 3,
}

# operators whose operands and result cross device memory
_HBM_OPS = {
    "mm", "bmm", "addmm", "baddbmm", "convolution", "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_flash_attention", "_scaled_dot_product_cudnn_attention",
    "sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all", "argmax", "argmin", "var", "std",
    "logsumexp", "cumsum", "_softmax", "_log_softmax", "sort", "topk",
    "cat", "constant_pad_nd", "randn", "rand", "normal_", "uniform_", "bernoulli_", "randint",
}
# reads a window of its source: 2 x the result
_WINDOW_READS = {"index_select", "gather", "index", "embedding", "take", "narrow_copy", "slice_copy"}
# writes a window of its destination: 2 x the update (the last tensor operand)
_WINDOW_WRITES = {"index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_", "scatter_add",
                  "scatter_add_", "scatter_reduce", "index_add", "index_add_", "index_copy", "index_copy_",
                  "slice_scatter", "select_scatter", "copy_"}
# ops through which a weight stays a weight (kernelized mode's provenance)
_WEIGHT_KEEPING = {"_to_copy", "clone", "contiguous", "t", "transpose", "permute", "expand", "view",
                   "_unsafe_view", "reshape", "select", "slice", "unsqueeze", "squeeze", "split", "cat",
                   "detach", "alias", "wait_tensor", "all_gather_into_tensor", "as_strided", "unbind",
                   "split_with_sizes", "chunk"}


def _tensors(tree: Any) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor):
    """A weak key of ``t``'s storage, shared by its views (a wrapper
    tensor's, as a ``DTensor``'s local block's); None for a tensor with none."""
    local = getattr(t, "_local_tensor", None)
    try:
        return StorageWeakRef((local if local is not None else t).untyped_storage())
    except (RuntimeError, NotImplementedError):
        return None


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _numel(tree: Any) -> int:
    return sum(t.numel() for t in _tensors(tree))


@dataclass
class HloCost:
    """The reference's fields, filled by ``analyze``."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: dict = field(default_factory=dict)
    collective_count: dict = field(default_factory=dict)
    dot_flops: float = 0.0

    def add_collective(self, kind: str, nbytes: float, count: float) -> None:
        self.collective_bytes += nbytes
        self.collective_by_kind[kind] = self.collective_by_kind.get(kind, 0.0) + nbytes
        self.collective_count[kind] = self.collective_count.get(kind, 0.0) + count


class CostCounter(TorchDispatchMode):
    """The dispatch mode behind ``analyze``; enter it around any code and
    read ``cost`` afterwards. ``weights`` seeds the kernelized mode's
    provenance (ignored unless ``kernelized``)."""

    def __init__(self, *, kernelized: bool = False, weights: Any = None):
        super().__init__()
        self.cost = HloCost()
        self.kernelized = kernelized
        self.repeat = 1  # each counted operator stands for this many (``repeats``)
        self._weights = WeakIdKeyDictionary()
        for t in _tensors(weights):
            self._weights[t] = True
        self._read: set = set()  # storages an operator read (``was_read``)

    def _is_weight(self, t) -> bool:
        return isinstance(t, torch.Tensor) and t in self._weights

    @contextlib.contextmanager
    def repeats(self, n: int):
        """Count what runs inside as ``n`` runs of it: the counterpart of the
        reference's loop body × trip count, for a loop whose iterations are
        alike in every shape (a train step's micro-batches), run once."""
        outer, self.repeat = self.repeat, self.repeat * n
        try:
            yield
        finally:
            self.repeat = outer

    def was_read(self, t: torch.Tensor) -> bool:
        """True when an operator other than a view (or a ``prim`` query of
        its metadata) read ``t``'s storage while the counter was on."""
        return _storage(t) in self._read

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace != "prim" and not getattr(func, "is_view", False):
            self._read.update(_storage(t) for t in _tensors((args, kwargs)))
        out = func(*args, **kwargs)
        if func is not _PRIM_DEVICE:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        ns, name = func.namespace, packet.__name__
        cost, n = self.cost, self.repeat
        if self.kernelized:
            self._keep_weight(name, args, out)
        if ns in _COLLECTIVE_NAMESPACES:
            if name in _COLLECTIVES:
                # result bytes per participant: a functional op's output; a
                # c10d op writes (or sends) the tensors of its first operand
                cost.add_collective(_COLLECTIVES[name], n * float(_nbytes(args[0] if ns == "c10d" else out)), n)
            return
        if ns != "aten":
            return
        if packet in flop_registry:
            f = n * float(flop_registry[packet](*args, **kwargs, out_val=out))
            cost.flops += f
            cost.dot_flops += f
        elif name in _ELEMENTWISE_FLOPS:
            cost.flops += n * _ELEMENTWISE_FLOPS[name] * _numel(out)
        if name in _HBM_OPS:
            if self.kernelized and name in _BATCHED_DOTS and not any(self._is_weight(a) for a in args[-2:]):
                return  # an attention-score matmul: on chip under a flash kernel
            cost.bytes += n * (_nbytes(out) + _nbytes((args, kwargs)))
        elif name in _WINDOW_READS:
            cost.bytes += n * 2 * _nbytes(out)
        elif name in _WINDOW_WRITES:
            operands = _tensors((args, kwargs))
            cost.bytes += n * 2 * (_nbytes(operands[-1]) if len(operands) > 1 else 0)

    def _keep_weight(self, name: str, args, out) -> None:
        if name in _WEIGHT_KEEPING and any(self._is_weight(a) for a in _tensors(args)):
            for t in _tensors(out):
                self._weights[t] = True


def analyze(fn: Callable, *args, kernelized: bool = False, **kwargs) -> HloCost:
    """The cost of one call ``fn(*args, **kwargs)`` (module docstring); the
    kernelized mode's weights are the leaves of the first argument."""
    counter = CostCounter(kernelized=kernelized, weights=args[0] if args else None)
    with counter:
        fn(*args, **kwargs)
    return counter.cost
