"""Operation counts of plain PyTorch circuits, for roofline shares
(counterpart of :mod:`lifeapi_tpu.utils.roofline`).

The port's kernels are integer code, so the roofline that matters is
32-bit lane-ops a second against the card's integer issue rate.  This
module counts the lane-ops of a function mechanically: it traces the
function to an aten graph (``torch.fx.experimental.proxy_tensor.make_fx``)
and adds up the output elements of every node that computes.  Counted over
a kernel's plain circuit (its semantics, not its code), the numerator of a
share stays put when the kernel is rewritten.

Unit: one 32-bit lane-op.  An element of a 64-bit type counts 2, as the
JAX module counts one 64-bit word-op as 2 lane-ops; an element of a type of
32 bits or fewer counts 1.  So the same elementwise function written in
both packages gets the same count.

Plumbing counts 0 (the counterpart of ``_FREE_PRIMS``): views, reshapes,
expands, permutes, slices, selects, squeezes and unsqueezes, aliases,
detach, copies (``clone``, ``cat``, ``stack``), dtype conversions, and
fills of a constant, which a fused kernel keeps in registers or never
materialises.  Rolls are counted, one op an element, as the JAX module
counts the concatenates of its rolls.

Peak model: the card issues one warp instruction a clock on each of the 4
schedulers of an SM, so its 32-bit lane-op peak is SMs x 4 x 32 x
``clocks.max.sm`` (read with ``nvidia-smi``).  This is the ceiling for
elementwise integer work; instructions that issue at half rate (LOP3 on
Hopper issues at most every other clock) keep a kernel below it.
"""

from __future__ import annotations

import operator
import subprocess

import torch
from torch.fx.experimental.proxy_tensor import make_fx

from .._device import resolve

SCHEDULERS_PER_SM = 4
LANES = 32

_FREE_OPS = {  # aten names, as make_fx records them after decomposition
    # views
    "view", "_unsafe_view", "expand", "permute", "transpose", "t", "slice", "select",
    "squeeze", "unsqueeze", "alias", "as_strided", "unbind", "split", "split_with_sizes",
    "unfold", "diagonal", "detach", "lift_fresh_copy",
    # copies and dtype conversions
    "clone", "copy_", "_to_copy", "cat", "stack",
    # fills of a constant
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "empty", "empty_like",
    "empty_strided", "new_zeros", "new_ones", "new_full", "new_empty", "scalar_tensor",
    "fill_", "zero_",
}
_COMMUTATIVE = {"bitwise_and", "bitwise_or", "bitwise_xor", "add", "mul", "maximum",
                "minimum"}
_MATMUL_OPS = {"mm", "bmm", "addmm", "baddbmm", "mv", "addmv", "dot"}  # matmul decomposes to these


def _graph(fn, example_args):
    """The aten graph of one evaluation of ``fn``.  Tensor arguments are
    cloned first, so that one tensor passed twice is two inputs, as two
    operands are two variables of a jaxpr."""
    args = [a.clone() if isinstance(a, torch.Tensor) else a for a in example_args]
    return make_fx(fn)(*args).graph


def _op_name(node):
    """The aten operator's name without its overload (``bitwise_and`` of
    ``aten.bitwise_and.Tensor``), or None for a node that is not an aten
    call."""
    if node.op != "call_function" or node.target is operator.getitem:
        return None
    packet = getattr(node.target, "overloadpacket", None)
    return getattr(packet, "__name__", str(node.target)).split(".")[-1]


def _tensors(value):
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    return []


def _lane_weight(t):
    """Lane-ops an element of ``t`` counts: 2 for a 64-bit type, else 1."""
    return max(1, t.element_size() // 4)


def _node_lane_ops(node):
    """Lane-ops of one node: its outputs' elements, each weighed by its
    type; 0 for plumbing and for nodes that are not aten calls."""
    name = _op_name(node)
    if name is None or name in _FREE_OPS:
        return 0
    return sum(t.numel() * _lane_weight(t) for t in _tensors(node.meta.get("val")))


def _has_effect(node):
    """A node that writes into a tensor or draws random numbers: never
    merged with another, never dropped."""
    schema = getattr(node.target, "_schema", None)
    tags = getattr(node.target, "tags", ())
    return bool(schema is not None and schema.is_mutable) \
        or torch.Tag.nondeterministic_seeded in tags


def _count(graph):
    return sum(_node_lane_ops(node) for node in graph.nodes)


def _cse_count(graph):
    """Lane-ops after value-numbering CSE and dead-code elimination (the
    counterpart of ``_cse_count_jaxpr``): two nodes with the same operator
    and the same operands (sorted for the commutative ones; literals by
    value) count once, and nodes whose results never reach an output count
    0."""
    vn = {}  # node -> value number
    seen = {}  # key -> value number

    def number(key):
        if key not in seen:
            seen[key] = len(seen)
        return seen[key]

    def operand(a):
        if isinstance(a, torch.fx.Node):
            return ("node", vn[a])
        if isinstance(a, (list, tuple)):
            return ("seq", tuple(operand(x) for x in a))
        return ("lit", type(a).__name__, repr(a))

    kept = []
    for node in graph.nodes:
        if node.op == "placeholder":
            vn[node] = number(("input", node.name))
        elif node.op == "get_attr":
            t = getattr(graph.owning_module, node.target)
            vn[node] = number(("constant", str(t.dtype), tuple(t.shape),
                               t.detach().cpu().numpy().tobytes()))
        elif node.op == "call_function":
            ops = [operand(a) for a in node.args]
            if _op_name(node) in _COMMUTATIVE and len(ops) >= 2:
                ops[:2] = sorted(ops[:2], key=repr)
            key = (str(node.target), tuple(ops),
                   tuple(sorted((k, operand(v)) for k, v in node.kwargs.items())))
            if _has_effect(node):
                key = ("effect", node.name)
            if key in seen:
                vn[node] = seen[key]
            else:
                vn[node] = number(key)
                kept.append(node)

    live = set()
    outputs = [n for n in graph.nodes if n.op == "output"]
    for out in outputs:
        live.update(vn[a] for a in out.all_input_nodes)
    total = 0
    for node in reversed(kept):
        if vn[node] not in live and not _has_effect(node):
            continue
        live.update(vn[a] for a in node.all_input_nodes)
        total += _node_lane_ops(node)
    return total


def lane_ops(fn, *example_args):
    """32-bit lane-ops of one evaluation of ``fn`` (a loop BODY: host-side
    control flow is traced as the example arguments take it): every
    counted node contributes its output elements, 2 for each element of a
    64-bit type.  A count before CSE: an upper bound on what a compiled
    kernel of the same circuit executes."""
    return _count(_graph(fn, example_args))


def lane_ops_cse(fn, *example_args):
    """Lane-ops of one evaluation of ``fn`` after value-numbering CSE and
    dead-code elimination: the executed-op estimate that stands in the
    numerator of a roofline share."""
    return _cse_count(_graph(fn, example_args))


def _matmul_flops(graph):
    total = 0
    for node in graph.nodes:
        if _op_name(node) not in _MATMUL_OPS:
            continue
        out = _tensors(node.meta["val"])[0]
        mats = [a.meta["val"] for a in node.args if isinstance(a, torch.fx.Node)]
        # the contracted dimension is the left operand's last (addmm,
        # baddbmm and addmv lead with the addend)
        total += 2 * out.numel() * mats[-2].shape[-1]
    return total


def matmul_flops(fn, *example_args):
    """FLOP of the matrix products of one evaluation of ``fn``, 2 * M * N * K
    a product (a batched one times its batch): the tensor-core numerator."""
    return _matmul_flops(_graph(fn, example_args))


def compiled_cost_analysis(fn, *example_args):
    """The counterpart of XLA's cost analysis, with its key names.  PyTorch
    has no compiler cost model, so the figures are those of ``fn`` run as
    eager torch: ``flops`` is :func:`matmul_flops`, and ``bytes accessed``
    the bytes of every counted node's tensor inputs and outputs (each node
    reads its operands from memory and writes its results back)."""
    graph = _graph(fn, example_args)
    nbytes = 0
    for node in graph.nodes:
        if _node_lane_ops(node) == 0:
            continue
        ins = [t for a in node.all_input_nodes for t in _tensors(a.meta.get("val"))]
        for t in ins + _tensors(node.meta.get("val")):
            nbytes += t.numel() * t.element_size()
    return {"flops": float(_matmul_flops(graph)), "bytes accessed": float(nbytes)}


def card_issue_peak(device=None):
    """Warp instructions a second the card can issue at most: SMs x 4
    schedulers x the SM clock's maximum (``nvidia-smi clocks.max.sm``).
    Raises without CUDA; there is no constant to fall back on."""
    if not torch.cuda.is_available():
        raise RuntimeError("card_issue_peak reads a CUDA card, but "
                           "torch.cuda.is_available() is False")
    index = resolve(device, who="card_issue_peak reads").index
    index = torch.cuda.current_device() if index is None else index
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout.split()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * SCHEDULERS_PER_SM * float(out[index]) * 1e6


def pct_of_peak(achieved_lane_ops_per_s, peak=None):
    """``achieved`` as a percentage of ``peak`` lane-ops a second; ``None``
    reads the card's 32-bit lane-op peak (:func:`card_issue_peak` x 32)."""
    if peak is None:
        peak = card_issue_peak() * LANES
    return 100.0 * achieved_lane_ops_per_s / peak


# -- canned counters over the kernels' plain circuits ------------------------

_BATCH = 8  # boards traced at once; the count is per board


def _device(device):
    return resolve(device, who="the counters trace")


def _per_board(fn, args, post_cse):
    return (lane_ops_cse if post_cse else lane_ops)(fn, *args) // _BATCH


def step_lane_ops_per_board(post_cse=False, device=None):
    """Lane-ops a board a generation of the Life step (``core.step.step``,
    the plain circuit of kernels [1] and [4]) on ``int64[64]`` boards."""
    from ..core import step as S

    boards = torch.zeros(_BATCH, 64, dtype=torch.int64, device=_device(device))
    return _per_board(S.step, (boards,), post_cse)


def fixpoint_step_lane_ops_per_board(post_cse=False, device=None):
    """Lane-ops a board of one full propagation step (sync, update, signal,
    apply: ``ops.stable_cuda.propagate_step_plain``, the plain circuit of
    kernel A, [5]) on the 10 planes ``int64[10, 64]``; only the planes are
    an output, as the JAX counter keeps ``_step_planes``'s first."""
    from ..ops import stable_cuda as SC
    from ..stable import bitplane as BP

    planes = torch.zeros(_BATCH, BP.N_PLANES, 64, dtype=torch.int64, device=_device(device))
    return _per_board(lambda p: SC.propagate_step_plain(p)[0], (planes,), post_cse)


def simple_step_lane_ops_per_board(post_cse=False, device=None):
    """Lane-ops a board of one simple-rule iteration: the two 9-counts and
    ``stable.bitplane.simple_circuit``, as the JAX counter builds it."""
    from ..stable import bitplane as BP

    z = torch.zeros(_BATCH, 64, dtype=torch.int64, device=_device(device))

    def body(state, unknown):
        return BP.simple_circuit(state, unknown, BP._counts_nibble(state),
                                 BP._counts_nibble(unknown))

    return _per_board(body, (z, z), post_cse)
