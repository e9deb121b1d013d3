"""Padding-taint abstract interpretation over traced aten graphs (the port
of the reference's ``analysis/taint.py``, which walks closed jaxprs).

The ragged-fleet contract pads every bucket's user axis to a common
``k_pad`` and promises padded lanes never influence active rows.  The
test suite checks this for specific grids; this pass proves it for *all
inputs* by abstract interpretation of the program the bucket runs, traced
by ``api.lowering.trace_bucket`` to a ``torch.fx.GraphModule`` of aten
ops, with each kernel one stand-in node (``kernels.probe``).

Abstract domain (the reference's, verbatim)
-------------------------------------------
Each value gets an :class:`AbsVal`:

* ``digits`` — which output axes are user-lane structured.  A
  :class:`Digit` ``(axis, sub_stride, extent)`` survives reshapes that
  merge the user axis with others (e.g. ``(K, slot) -> (K*slot,)``): the
  lane of flat coordinate ``c`` is ``(c // sub_stride) % extent``.
* ``lanes`` — what padded-lane elements hold: :class:`Known` (a concrete
  scalar, evaluated through every op), :class:`Same` (elementwise equal
  to another value's elements — how parameter deltas cancel to zero in
  the ``local_steps > 1`` path), or :data:`VARIANT` (arbitrary finite
  values).
* ``const`` — whole-array constant scalar, for concrete folding.
* ``poison`` — violation tags that have influenced this value.

The theorem per reduction site: a cross-user reduction is mask-dominated
iff the abstract padded-lane value is the **identity of its monoid**
(``sum``↔0, ``amax``↔-inf, ``all``↔True, ...); a contraction over the
user axis (``mm``/``bmm``) is safe iff either side's padded lanes are
``Known(0)``.  Everything else that would let a padded lane reach an
active output (indexing along the user axis, scatters writing across
lanes, prefix sums along it) is flagged at the site.

Stated assumptions (recorded as INFO findings on every certificate):
padded-lane inputs are finite (``0 * x == 0`` needs ``x`` finite — the
engine's schedules guarantee this) and index-typed padded lanes are
in-bounds (``pad_schedule`` writes index 0).

Transfer rules, by aten op
--------------------------
The rules go by the op of each node (``aten.<op>``, any overload):
pointwise ops (``torch.Tag.pointwise``) evaluate Known lanes concretely
by running the op on 0-dim tensors of the operands' dtypes, and apply the
reference's algebra otherwise (``mul`` by Known(0), ``sub`` of equal
``Same`` lanes, ...), extended to autograd's pointwise backward ops
(``threshold_backward``, ``silu_backward``: a Known(0) gradient stays
Known(0)); views and ``_unsafe_view`` go through ``Digit``'s
``sub_stride``; ``expand``, ``permute``, ``select`` / ``slice`` /
``split`` / ``unbind``, ``cat`` / ``stack``, ``constant_pad_nd`` and the
``*_backward`` scatters of ``select`` / ``slice`` move digits; reductions
along a non-user axis fold Known lanes by running the op on a constant
tensor of the reduced extent; ``index.Tensor``, ``gather`` and
``scatter_add`` are the reference's gather / scatter rules; ``bmm`` / ``mm``
its ``dot_general`` rule.  An aten op with no rule that consumes a
user-lane-structured value is ``taint.unhandled-primitive``.

**Kernel stand-ins.**  Each ``repro_torch::<kernel>`` node treats its
operands' leading axis independently — SBC's segments, attention's and
the SSD scan's batch (the SSD's per-copy decay ``A`` by copy) — and
mixes along every other axis, so a user digit on another axis of an
operand is ``taint.kernel-over-user-axis``.  Their lane rules are the
kernels' algebra on a zero padded lane: ``sbc_stats`` of a Known(0)
segment is Known(0) (no value is positive or negative), and
``sbc_apply`` maps a Known(0) segment to Known(0) in the approximation
and in the residual — the step the SBC residual's output contract rests
on.  Attention's output is Known(0) when V's lanes are, its backward
gradients when dO's (and dK's when D's too); the SSD's output when x's,
its five gradients when dy's.  ``chip_smoke.py`` holds these rules on the
card.
"""
from __future__ import annotations

import math
import operator
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch
import torch.fx
from torch.utils import _pytree as pytree

from repro_torch.analysis.report import AuditReport, Severity

__all__ = ["LaneLabel", "OutContract", "AbsVal", "Digit", "Known", "Same",
           "VARIANT", "NO_LABEL", "analyze_graph"]


# ---------------------------------------------------------------------------
# abstract domain
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Digit:
    """One user-lane-structured axis of a value.

    ``lane(coord) = (coord // sub_stride) % extent`` — ``sub_stride`` and
    ``extent`` keep lane identity through axis merges; a plain user axis
    is ``Digit(axis, 1, K)``.
    """
    axis: int
    sub_stride: int
    extent: int


@dataclass(frozen=True)
class Known:
    """Padded lanes hold exactly this scalar (tracked concretely)."""
    value: object

    def __repr__(self):
        return f"Known({self.value})"


@dataclass(frozen=True)
class Same:
    """Padded lanes equal the corresponding elements of value ``ref``."""
    ref: object  # a graph node (identity compared)

    def __hash__(self):
        return hash(id(self.ref))

    def __eq__(self, other):
        return isinstance(other, Same) and self.ref is other.ref


class _Variant:
    def __repr__(self):
        return "VARIANT"


VARIANT = _Variant()


@dataclass(frozen=True)
class AbsVal:
    """Abstract value: lane structure + padded-lane contents + constness."""
    digits: tuple = ()          # tuple[Digit], sorted by axis
    lanes: object = None        # Known | Same | VARIANT; None iff no digits
    const: object = None        # scalar if the whole array is constant
    poison: frozenset = frozenset()

    @property
    def marked(self) -> bool:
        return bool(self.digits)

    def digit_axes(self):
        return {d.axis for d in self.digits}


CLEAN = AbsVal()


def _known_zero(lanes) -> bool:
    return isinstance(lanes, Known) and not np.any(np.asarray(lanes.value))


def _join_lanes(a, b):
    if a == b:
        return a
    return VARIANT


# ---------------------------------------------------------------------------
# labels / contracts (the analysis API surface)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LaneLabel:
    """Input label: ``axis`` is the user axis of this (flattened) input.

    ``lanes`` is what padded lanes hold: a scalar (``Known``) or the
    string ``"variant"`` (arbitrary — e.g. schedule indices, whose
    masking the program must therefore re-establish itself).
    ``axis=None`` marks an unlabeled input.
    """
    axis: Optional[int] = None
    lanes: object = "variant"


NO_LABEL = LaneLabel(axis=None)


@dataclass(frozen=True)
class OutContract:
    """Output contract: padded lanes of ``axis`` must be Known(``value``).

    Used for carry outputs that feed the next period (the SBC residual):
    proving the contract at the output IS the inductive step that makes
    the certificate hold across a horizon.  ``axis=None`` is the contract
    of a carry whose next-period label is :data:`NO_LABEL` (the global
    parameters): the output carries no user-lane structure at all.
    """
    axis: Optional[int]
    value: object = 0.0


# ---------------------------------------------------------------------------
# op tables
# ---------------------------------------------------------------------------

# monoid identities: reduction op -> identity check on scalar c
_REDUCE_IDENTITY = {
    "sum": lambda c, dt: float(c) == 0.0,
    "prod": lambda c, dt: float(c) == 1.0,
    "amax": lambda c, dt: (bool(c) is False if dt == torch.bool else
                           (c == -math.inf if dt.is_floating_point else
                            c == torch.iinfo(dt).min)),
    "amin": lambda c, dt: (bool(c) is True if dt == torch.bool else
                           (c == math.inf if dt.is_floating_point else
                            c == torch.iinfo(dt).max)),
    "any": lambda c, dt: bool(c) is False,
    "all": lambda c, dt: bool(c) is True,
    "logsumexp": lambda c, dt: c == -math.inf,
    # a mean divides by the padded extent; order-sensitive picks never
    # have an identity
    "mean": lambda c, dt: False,
    "argmax": lambda c, dt: False,
    "argmin": lambda c, dt: False,
}

# ops that map each lane to itself along an axis param (the axis is the
# only place lanes could mix); the finding when that axis is a user axis
_ALONG_AXIS = {
    "_softmax": "taint.unmasked-reduction",
    "_log_softmax": "taint.unmasked-reduction",
    "_softmax_backward_data": "taint.unmasked-reduction",
    "_log_softmax_backward_data": "taint.unmasked-reduction",
    "cumsum": "taint.cumulative-over-user-axis",
    "cumprod": "taint.cumulative-over-user-axis",
    "logcumsumexp": "taint.cumulative-over-user-axis",
}

# ops whose output is Known(0) on padded lanes when the listed operand's
# lanes are Known(0) (finite other operands): "*" is any operand.  The
# autograd backward ops scale their incoming gradient (operand 0)
_ZERO_IN = {
    "mul": "*", "div": (0,), "threshold_backward": (0,),
    "silu_backward": (0,), "sigmoid_backward": (0,),
    "tanh_backward": (0,), "gelu_backward": (0,),
    "_softmax_backward_data": (0,), "_log_softmax_backward_data": (0,),
}

# element-for-element copies: output elements equal the input's
_ALIAS = {"clone", "detach", "alias", "lift_fresh_copy"}

# constructors of a whole-array constant: the op's fill value
_CONST_FILL = {"zeros": 0, "zeros_like": 0, "new_zeros": 0, "ones": 1,
               "ones_like": 1, "new_ones": 1}
_CONST_FILL_ARG = {"full": "fill_value", "full_like": "fill_value",
                   "new_full": "fill_value", "scalar_tensor": "s"}

# no cap on a fold's constant tensor beyond this many elements
_FOLD_LIMIT = 1 << 22


def _op_name(target) -> str:
    """``aten.add`` / ``repro_torch.sbc_stats`` for an OpOverload
    (``python.<name>`` for any other callable)."""
    if isinstance(target, torch._ops.OpOverload):
        return f"{target.namespace}.{target._opname}"
    return f"python.{getattr(target, '__name__', target)}"


def _named_args(node) -> dict:
    """The node's arguments by schema name, defaults filled in."""
    out = {}
    for i, arg in enumerate(node.target._schema.arguments):
        if i < len(node.args):
            out[arg.name] = node.args[i]
        elif arg.name in node.kwargs:
            out[arg.name] = node.kwargs[arg.name]
        elif arg.has_default_value():
            out[arg.name] = arg.default_value
    return out


def _val(node):
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else None


def _shape(x) -> tuple:
    v = _val(x)
    if isinstance(v, torch.Tensor):
        return tuple(v.shape)
    return ()


def _dtype(x):
    v = _val(x)
    if isinstance(v, torch.Tensor):
        return v.dtype
    if isinstance(x, bool):
        return torch.bool
    if isinstance(x, int):
        return torch.int64
    return torch.float32


def _norm_dims(dim, rank: int) -> tuple:
    """A dim argument (int, list, None or [] = all) as sorted axes."""
    if dim is None or (isinstance(dim, (list, tuple)) and not dim):
        return tuple(range(rank))
    if isinstance(dim, int):
        dim = [dim]
    return tuple(sorted({d % max(rank, 1) for d in dim}))


def _item(t: torch.Tensor):
    return t.reshape(-1)[0].item()


def _uniform(t: torch.Tensor):
    """The scalar every element of ``t`` holds, else None."""
    if not isinstance(t, torch.Tensor) or t.numel() == 0:
        return None
    first = t.reshape(-1)[:1]
    if t.is_floating_point() and bool(first.isnan().all()):
        return _item(first) if bool(t.isnan().all()) else None
    return _item(first) if bool((t == first).all()) else None


def _call(node, subst: dict):
    """Run the node's op on concrete tensors (``subst`` maps each tensor
    operand to one), on the CPU; None when the op refuses them."""
    def conv(a):
        if isinstance(a, torch.fx.Node):
            return subst[a]
        if isinstance(a, torch.device):
            return torch.device("cpu")
        return a
    args = pytree.tree_map(conv, tuple(node.args))
    kwargs = {k: conv(v) for k, v in node.kwargs.items()}
    try:
        with torch.no_grad():
            return node.target(*args, **kwargs)
    except (RuntimeError, TypeError, ValueError):
        return None


def _row_major_strides(shape):
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    return strides


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------


class _Interp:
    def __init__(self, report: AuditReport, program: str):
        self.report = report
        self.program = program
        self.assumptions = set()
        self.n_eqns = 0
        self.n_certified = 0   # mask-dominated cross-user reductions proven
        self.alias = {}        # node -> canonical node (element-equal values)
        self.env = {}

    # -- bookkeeping --------------------------------------------------------

    def _finding(self, check, where, detail):
        self.report.add(check, Severity.ERROR, f"{self.program}:{where}",
                        detail)
        return frozenset([f"{check}@{where}"])

    def _assume(self, text):
        self.assumptions.add(text)

    def _assume_finite(self):
        self._assume("padded-lane operands are finite (0 * x == 0)")

    def canon(self, v):
        while v in self.alias:
            v = self.alias[v]
        return v

    # -- env helpers --------------------------------------------------------

    def read(self, x) -> AbsVal:
        if isinstance(x, torch.fx.Node):
            return self.env.get(x, CLEAN)
        if isinstance(x, (bool, int, float)):
            return AbsVal(const=x)
        return CLEAN

    def lane_of(self, x, a: AbsVal):
        """This operand's contribution to padded-lane elements."""
        if a.marked:
            return a.lanes
        if a.const is not None:
            return Known(a.const)
        if isinstance(x, torch.fx.Node):
            return Same(self.canon(x))
        return VARIANT

    # -- main walk ----------------------------------------------------------

    def run(self, gm: torch.fx.GraphModule, in_vals):
        placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
        assert len(placeholders) == len(in_vals), \
            f"input arity {len(placeholders)} != {len(in_vals)} labels"
        self.env = dict(zip(placeholders, in_vals))
        outs = []
        for node in gm.graph.nodes:
            if node.op == "get_attr":
                const = getattr(gm, node.target)
                c = _uniform(const) if isinstance(const, torch.Tensor) \
                    and const.numel() <= _FOLD_LIMIT else None
                self.env[node] = AbsVal(const=c)
            elif node.op == "call_function":
                self.n_eqns += 1
                self.env[node] = self.eval_node(node)
            elif node.op == "output":
                outs = [self.read(o) for o in pytree.tree_leaves(node.args[0])
                        if isinstance(o, torch.fx.Node)]
        return outs

    def _operands(self, node):
        return [a for a in pytree.tree_leaves((node.args, node.kwargs))
                if isinstance(a, torch.fx.Node)]

    def eval_node(self, node):
        if node.target is operator.getitem:
            src, i = node.args
            return self.env[src][i]
        ins = [(a, self.read(a)) for a in self._operands(node)]
        poison = frozenset().union(*(a.poison for _, a in ins)) \
            if ins else frozenset()
        name = _op_name(node.target)
        ns, op = name.split(".", 1)
        handler = getattr(self, f"_{ns}_{op}", None)
        if handler is not None:
            out = handler(node)
        elif ns == "aten" and op in _ALIAS:
            out = self._alias(node)
        elif ns == "aten" and op in _REDUCE_IDENTITY:
            out = self._reduce(node, op)
        elif ns == "aten" and op in _ALONG_AXIS:
            out = self._along_axis(node, op)
        elif ns == "aten" and (op in _CONST_FILL or op in _CONST_FILL_ARG):
            out = self._const_fill(node, op)
        elif ns == "aten" and torch.Tag.pointwise in node.target.tags:
            out = self._elementwise(node, op)
        elif not any(a.marked for _, a in ins):
            out = CLEAN if not isinstance(_val(node), (tuple, list)) \
                else tuple(CLEAN for _ in _val(node))
        else:
            out = self._unknown(node, name)
        if isinstance(out, (tuple, list)):
            return tuple(replace(o, poison=o.poison | poison) for o in out)
        return replace(out, poison=out.poison | poison)

    # elementwise family -----------------------------------------------------

    def _merge_digits(self, node, operands):
        """Union the operands' digits onto the (right-aligned, broadcast)
        output."""
        out_shape = _shape(node)
        digits = {}
        agree = True
        for x in operands:
            a = self.read(x)
            rank = len(_shape(x))
            for d in a.digits:
                ax = d.axis + (len(out_shape) - rank)
                nd = Digit(ax, d.sub_stride, d.extent)
                prev = digits.get(ax)
                if prev is None:
                    digits[ax] = nd
                elif prev != nd:
                    digits[ax] = Digit(ax, 1, out_shape[ax])
                    agree = False
        return tuple(sorted(digits.values(), key=lambda d: d.axis)), agree

    def _concrete(self, node, lanes: dict):
        """The op on 0-dim operands holding the Known lanes (``lanes``
        maps each tensor operand to its scalar); None if not uniform."""
        try:
            subst = {x: torch.tensor(v, dtype=_dtype(x))
                     for x, v in lanes.items()}
        except (RuntimeError, TypeError, OverflowError):
            return None
        out = _call(node, subst)
        return _uniform(out) if isinstance(out, torch.Tensor) else None

    def _elementwise(self, node, op):
        operands = [x for x in pytree.tree_leaves((node.args, node.kwargs))
                    if isinstance(x, torch.fx.Node)]
        digits, agree = self._merge_digits(node, operands)
        if not digits:
            consts = {x: self.read(x).const for x in operands}
            if all(c is not None for c in consts.values()):
                return AbsVal(const=self._concrete(node, consts))
            return CLEAN
        lanes = {x: self.lane_of(x, self.read(x)) for x in operands}
        out = self._combine_lanes(node, op, lanes) if agree else VARIANT
        return AbsVal(digits=digits, lanes=out)

    def _combine_lanes(self, node, op, lanes: dict):
        values = list(lanes.values())
        if all(isinstance(x, Known) for x in values):
            c = self._concrete(node, {x: v.value for x, v in lanes.items()})
            return VARIANT if c is None else Known(c)
        zero_in = _ZERO_IN.get(op)
        if zero_in is not None:
            # scalar operands (Python numbers) are not graph nodes: a
            # Known(0) among the nodes is what decides
            pos = [i for i, a in enumerate(node.args)
                   if isinstance(a, torch.fx.Node)]
            hit = [lanes[node.args[i]] for i in pos
                   if zero_in == "*" or i in zero_in]
            scalar_zero = zero_in == "*" and any(
                isinstance(a, (int, float)) and a == 0 for a in node.args)
            if any(_known_zero(x) for x in hit) or scalar_zero:
                self._assume_finite()
                if op == "div":
                    self._assume("padded-lane denominators are nonzero "
                                 "(0 / d == 0)")
                return Known(0.0 if _dtype(node).is_floating_point else 0)
        if op in ("bitwise_and", "logical_and") and any(
                isinstance(x, Known) and not x.value for x in values):
            return Known(False)
        if op in ("bitwise_or", "logical_or") and any(
                isinstance(x, Known) and bool(x.value) for x in values):
            return Known(True)
        if op == "where":
            pred, a, b = (lanes.get(x, Known(x)) if isinstance(
                x, torch.fx.Node) else Known(x) for x in node.args[:3])
            if isinstance(pred, Known):
                return a if bool(pred.value) else b
            return _join_lanes(a, b)
        if op in ("add", "sub") and len(node.args) >= 2:
            left, right = (lanes.get(x, Known(x)) if isinstance(
                x, torch.fx.Node) else Known(x) for x in node.args[:2])
            if op == "sub" and isinstance(left, Same) and left == right:
                return Known(0.0 if _dtype(node).is_floating_point else 0)
            if isinstance(left, Same) and _known_zero(right):
                return left
            if op == "add" and isinstance(right, Same) and _known_zero(left):
                return right
        return VARIANT

    def _alias(self, node):
        x = node.args[0]
        a = self.read(x)
        if isinstance(x, torch.fx.Node):
            self.alias[node] = self.canon(x)
        return a

    def _aten__to_copy(self, node):
        x = node.args[0]
        a = self.read(x)
        out_dtype = _dtype(node)
        in_dtype = _dtype(x)
        const = a.const
        if const is not None:
            const = _item(torch.tensor(const, dtype=in_dtype).to(out_dtype))
        lanes = a.lanes
        if isinstance(lanes, Known):
            lanes = Known(_item(torch.tensor(lanes.value, dtype=in_dtype)
                                .to(out_dtype)))
        elif isinstance(lanes, Same) and (in_dtype.is_floating_point
                                          != out_dtype.is_floating_point):
            lanes = VARIANT
        if in_dtype == out_dtype:
            self.alias[node] = self.canon(x)
        return AbsVal(digits=a.digits, lanes=lanes, const=const)

    def _const_fill(self, node, op):
        if op in _CONST_FILL:
            return AbsVal(const=_CONST_FILL[op])
        value = _named_args(node)[_CONST_FILL_ARG[op]]
        if isinstance(value, torch.fx.Node):
            return AbsVal(const=self.read(value).const)
        return AbsVal(const=value)

    # reductions -------------------------------------------------------------

    def _reduce(self, node, op):
        args = _named_args(node)
        x = args["self"]
        a = self.read(x)
        in_shape = _shape(x)
        axes = _norm_dims(args.get("dim"), len(in_shape))
        keepdim = bool(args.get("keepdim", False))
        hit = [d for d in a.digits if d.axis in axes]
        remaining = [d for d in a.digits if d.axis not in axes]
        new_digits = tuple(remaining) if keepdim else tuple(
            Digit(d.axis - sum(1 for ax in axes if ax < d.axis),
                  d.sub_stride, d.extent) for d in remaining)
        poison = frozenset()
        where = node.name
        if hit:
            ok = (isinstance(a.lanes, Known)
                  and _REDUCE_IDENTITY[op](a.lanes.value, _dtype(x)))
            if ok:
                self.n_certified += 1
                lanes = Known(0 if _dtype(node) != torch.bool else False) \
                    if op == "sum" else a.lanes
            else:
                poison = self._finding(
                    "taint.unmasked-reduction", where,
                    f"{op} over user axis/axes {[d.axis for d in hit]} with "
                    f"padded lanes {a.lanes} — not the monoid identity, "
                    "padded users leak into active outputs")
                lanes = VARIANT
        elif isinstance(a.lanes, Known) and op not in ("argmax", "argmin"):
            lanes = self._fold(node, x, a.lanes.value, axes)
        else:
            lanes = VARIANT
        if not new_digits:
            return AbsVal(poison=poison)
        return AbsVal(digits=new_digits, lanes=lanes, poison=poison)

    def _fold(self, node, x, c, axes):
        """Known(c) lanes through a lane-local op along ``axes``: the op
        on a constant tensor of the extent along them."""
        in_shape = _shape(x)
        small = [s if ax in axes else 1 for ax, s in enumerate(in_shape)]
        if math.prod(small) > _FOLD_LIMIT:
            return VARIANT
        subst = {o: torch.full(small if o is x else _shape(o), 0,
                               dtype=_dtype(o))
                 for o in self._operands(node)}
        subst[x] = torch.full(small, c, dtype=_dtype(x))
        out = _call(node, subst)
        v = _uniform(out if isinstance(out, torch.Tensor) else None)
        return VARIANT if v is None else Known(v)

    def _along_axis(self, node, op):
        args = _named_args(node)
        x = node.args[0]
        a = self.read(x)
        dim = args["dim"] % max(len(_shape(x)), 1)
        operands = self._operands(node)
        digits, agree = self._merge_digits(node, operands)
        if not digits:
            return CLEAN
        if any(d.axis == dim for d in digits):
            poison = self._finding(
                _ALONG_AXIS[op], node.name,
                f"{op} along user axis {dim}: results mix padded and "
                "active lanes")
            return AbsVal(digits=digits, lanes=VARIANT, poison=poison)
        lanes = {o: self.lane_of(o, self.read(o)) for o in operands}
        zero_in = _ZERO_IN.get(op)
        if zero_in is not None and _known_zero(lanes[node.args[0]]):
            self._assume_finite()
            return AbsVal(digits=digits, lanes=Known(0.0))
        if agree and len(operands) == 1 and isinstance(a.lanes, Known):
            return AbsVal(digits=digits,
                          lanes=self._fold(node, x, a.lanes.value, (dim,)))
        return AbsVal(digits=digits, lanes=VARIANT)

    # shape ops -------------------------------------------------------------

    def _reshape(self, node):
        x = node.args[0]
        a = self.read(x)
        in_shape = _shape(x)
        out_shape = _shape(node)
        if not a.marked:
            return AbsVal(const=a.const)
        in_strides = _row_major_strides(in_shape)
        out_strides = _row_major_strides(out_shape)
        digits = []
        degraded = False
        for d in a.digits:
            g = in_strides[d.axis] * d.sub_stride  # global flat stride
            placed = False
            for j, (so, sz) in enumerate(zip(out_strides, out_shape)):
                if (g % so == 0 and so <= g and g * d.extent <= so * sz):
                    digits.append(Digit(j, g // so, d.extent))
                    placed = True
                    break
            if not placed:
                # lane structure split across axes: widen every axis the
                # digit's span overlaps
                degraded = True
                span_lo, span_hi = g, g * d.extent
                for j, (so, sz) in enumerate(zip(out_strides, out_shape)):
                    if so < span_hi and so * sz > span_lo // max(1, sz):
                        digits.append(Digit(j, 1, sz))
        dd = {}
        for d in digits:
            dd[d.axis] = d if d.axis not in dd else Digit(
                d.axis, 1, out_shape[d.axis])
        return AbsVal(digits=tuple(sorted(dd.values(), key=lambda d: d.axis)),
                      lanes=a.lanes if not degraded else VARIANT)

    _aten_view = _aten__unsafe_view = _aten_reshape = _reshape

    def _aten_expand(self, node):
        x = node.args[0]
        a = self.read(x)
        shift = len(_shape(node)) - len(_shape(x))
        if a.const is None:
            # broadcasting preserves element correspondence along kept axes
            self.alias[node] = self.canon(x)
        return AbsVal(digits=tuple(Digit(d.axis + shift, d.sub_stride,
                                         d.extent) for d in a.digits),
                      lanes=a.lanes, const=a.const)

    def _aten_unsqueeze(self, node):
        x, dim = node.args[:2]
        a = self.read(x)
        dim = dim % len(_shape(node))
        if a.const is None:
            self.alias[node] = self.canon(x)
        return AbsVal(digits=tuple(
            Digit(d.axis + (d.axis >= dim), d.sub_stride, d.extent)
            for d in a.digits), lanes=a.lanes, const=a.const)

    def _aten_squeeze(self, node):
        x = node.args[0]
        a = self.read(x)
        in_shape = _shape(x)
        dims = _norm_dims(node.args[1] if len(node.args) > 1 else None,
                          len(in_shape))
        dims = tuple(ax for ax in dims if in_shape[ax] == 1)
        digits = tuple(
            Digit(d.axis - sum(1 for ax in dims if ax < d.axis),
                  d.sub_stride, d.extent)
            for d in a.digits if d.axis not in dims)
        if a.const is None:
            self.alias[node] = self.canon(x)
        return AbsVal(digits=digits, lanes=a.lanes if digits else None,
                      const=a.const)

    def _permuted(self, a: AbsVal, perm):
        inv = {old: new for new, old in enumerate(perm)}
        return AbsVal(digits=tuple(sorted(
            (Digit(inv[d.axis], d.sub_stride, d.extent) for d in a.digits),
            key=lambda d: d.axis)), lanes=a.lanes, const=a.const)

    def _aten_permute(self, node):
        x, dims = node.args[:2]
        rank = len(_shape(x))
        return self._permuted(self.read(x), [d % rank for d in dims])

    def _aten_transpose(self, node):
        x, d0, d1 = node.args[:3]
        rank = len(_shape(x))
        perm = list(range(rank))
        perm[d0 % rank], perm[d1 % rank] = perm[d1 % rank], perm[d0 % rank]
        return self._permuted(self.read(x), perm)

    def _aten_t(self, node):
        rank = len(_shape(node.args[0]))
        return self._permuted(self.read(node.args[0]),
                              list(range(rank))[::-1])

    def _select(self, node, x, dim):
        a = self.read(x)
        rank = len(_shape(x))
        dim = dim % rank
        poison = frozenset()
        if any(d.axis == dim for d in a.digits):
            poison = self._finding(
                "taint.gather-over-user-axis", node.name,
                f"select along user axis {dim}: one lane's data surfaces "
                "as an unstructured value")
        digits = tuple(Digit(d.axis - (d.axis > dim), d.sub_stride, d.extent)
                       for d in a.digits if d.axis != dim)
        return AbsVal(digits=digits, lanes=a.lanes if digits else None,
                      const=a.const, poison=poison)

    def _aten_select(self, node):
        return self._select(node, node.args[0], node.args[1])

    def _aten_unbind(self, node):
        x = node.args[0]
        dim = node.args[1] if len(node.args) > 1 else 0
        return tuple(self._select(node, x, dim) for _ in _val(node))

    def _sliced(self, a: AbsVal, dim: int, full: bool, out_size: int):
        """``a`` with axis ``dim`` cut (``full``: nothing cut)."""
        digits = []
        lanes = a.lanes
        for d in a.digits:
            if d.axis != dim or full:
                digits.append(d)
            else:
                digits.append(Digit(dim, 1, out_size))
                if not isinstance(lanes, Known):
                    lanes = VARIANT
        return AbsVal(digits=tuple(digits), lanes=lanes if digits else None,
                      const=a.const)

    def _aten_slice(self, node):
        args = _named_args(node)
        x = args["self"]
        in_shape = _shape(x)
        dim = args["dim"] % len(in_shape)
        out_size = _shape(node)[dim]
        return self._sliced(self.read(x), dim, out_size == in_shape[dim],
                            out_size)

    def _split(self, node):
        x = node.args[0]
        in_shape = _shape(x)
        dim = _named_args(node)["dim"] % len(in_shape)
        a = self.read(x)
        return tuple(self._sliced(a, dim, part.shape[dim] == in_shape[dim],
                                  part.shape[dim]) for part in _val(node))

    _aten_split = _aten_split_with_sizes = _split

    def _aten_cat(self, node):
        tensors = list(node.args[0])
        out_shape = _shape(node)
        dim = (node.args[1] if len(node.args) > 1 else 0) % len(out_shape)
        digits, agree = self._merge_digits(node, tensors)
        if not digits:
            return CLEAN
        lanes = None
        for t in tensors:
            contrib = self.lane_of(t, self.read(t))
            lanes = contrib if lanes is None else _join_lanes(lanes, contrib)
        digits = tuple(d if d.axis != dim else Digit(dim, 1, out_shape[dim])
                       for d in digits)
        return AbsVal(digits=digits, lanes=lanes if agree else VARIANT)

    def _aten_stack(self, node):
        tensors = list(node.args[0])
        out_rank = len(_shape(node))
        dim = (node.args[1] if len(node.args) > 1 else 0) % out_rank
        digits = {}
        agree = True
        lanes = None
        for t in tensors:
            a = self.read(t)
            for d in a.digits:
                nd = Digit(d.axis + (d.axis >= dim), d.sub_stride, d.extent)
                prev = digits.setdefault(nd.axis, nd)
                if prev != nd:
                    agree = False
            contrib = self.lane_of(t, a)
            lanes = contrib if lanes is None else _join_lanes(lanes, contrib)
        if not digits:
            return CLEAN
        return AbsVal(digits=tuple(sorted(digits.values(),
                                          key=lambda d: d.axis)),
                      lanes=lanes if agree else VARIANT)

    def _aten_constant_pad_nd(self, node):
        args = _named_args(node)
        x = args["self"]
        pad = list(args["pad"])
        value = args.get("value", 0)
        a = self.read(x)
        out_shape = _shape(node)
        rank = len(out_shape)
        padded = {rank - 1 - i // 2 for i, p in enumerate(pad) if p}
        digits = []
        lanes = a.lanes
        for d in a.digits:
            if d.axis in padded:
                digits.append(Digit(d.axis, 1, out_shape[d.axis]))
                lanes = _join_lanes(lanes, Known(value))
            else:
                digits.append(d)
        return AbsVal(digits=tuple(digits), lanes=lanes)

    def _scatter_into_zeros(self, node, grad, dim, inserted: bool):
        """``select_backward`` / ``slice_backward``: ``grad`` placed into a
        zero tensor along ``dim`` (a new axis for select)."""
        a = self.read(grad)
        out_shape = _shape(node)
        dim = dim % len(out_shape)
        digits = []
        for d in a.digits:
            if inserted:
                digits.append(Digit(d.axis + (d.axis >= dim), d.sub_stride,
                                    d.extent))
            elif d.axis == dim:
                digits.append(Digit(dim, 1, out_shape[dim]))
            else:
                digits.append(d)
        if not digits:
            return CLEAN
        return AbsVal(digits=tuple(digits),
                      lanes=_join_lanes(a.lanes, Known(0.0))
                      if not _known_zero(a.lanes) else a.lanes)

    def _aten_select_backward(self, node):
        args = _named_args(node)
        return self._scatter_into_zeros(node, args["grad_output"],
                                        args["dim"], True)

    def _aten_slice_backward(self, node):
        args = _named_args(node)
        return self._scatter_into_zeros(node, args["grad_output"],
                                        args["dim"], False)

    # contraction / indexing -------------------------------------------------

    def _dot(self, node, lv, rv, lc, rc, lb, rb):
        la, ra = self.read(lv), self.read(rv)
        l_rank, r_rank = len(_shape(lv)), len(_shape(rv))
        l_free = [ax for ax in range(l_rank) if ax not in lc and ax not in lb]
        r_free = [ax for ax in range(r_rank) if ax not in rc and ax not in rb]
        l_lane = self.lane_of(lv, la)
        r_lane = self.lane_of(rv, ra)
        poison = frozenset()
        # contracted user axes: the cross-user reduction case
        contracted_hit = [d for d in la.digits if d.axis in lc] + \
                         [d for d in ra.digits if d.axis in rc]
        if contracted_hit:
            if _known_zero(l_lane) or _known_zero(r_lane):
                self.n_certified += 1
                self._assume_finite()
            else:
                poison = self._finding(
                    "taint.unmasked-contraction", node.name,
                    f"{_op_name(node.target)} contracts user axis with "
                    f"padded lanes lhs={l_lane} rhs={r_lane} — neither side "
                    "is Known(0), padded users leak into the product")
        out_digits = []

        def out_pos_l(ax):
            if ax in lb:
                return lb.index(ax)
            return len(lb) + l_free.index(ax)

        def out_pos_r(ax):
            if ax in rb:
                return rb.index(ax)
            return len(lb) + len(l_free) + r_free.index(ax)

        for d in la.digits:
            if d.axis not in lc:
                out_digits.append(Digit(out_pos_l(d.axis), d.sub_stride,
                                        d.extent))
        for d in ra.digits:
            if d.axis in rc:
                continue
            pos = out_pos_r(d.axis)
            if not any(x.axis == pos for x in out_digits):
                out_digits.append(Digit(pos, d.sub_stride, d.extent))
        out_digits = tuple(sorted(out_digits, key=lambda d: d.axis))
        if not out_digits:
            return AbsVal(poison=poison)
        zero = _known_zero(l_lane) or _known_zero(r_lane)
        if zero:
            self._assume_finite()
        return AbsVal(digits=out_digits, lanes=Known(0.0) if zero else VARIANT,
                      poison=poison)

    def _aten_bmm(self, node):
        return self._dot(node, node.args[0], node.args[1], (2,), (1,),
                         (0,), (0,))

    def _aten_mm(self, node):
        return self._dot(node, node.args[0], node.args[1], (1,), (0,),
                         (), ())

    def _aten_index(self, node):
        x, indices = node.args[:2]
        a = self.read(x)
        in_rank = len(_shape(x))
        out_shape = _shape(node)
        pos = [i for i, t in enumerate(indices) if t is not None]
        idx_rank = len(out_shape) - (in_rank - len(pos))
        adjacent = pos == list(range(pos[0], pos[-1] + 1))
        first = pos[0] if adjacent else 0
        poison = frozenset()
        digits = {}
        lanes = None

        def add(ax, d, contrib):
            nonlocal lanes
            digits.setdefault(ax, Digit(ax, d.sub_stride, d.extent))
            lanes = contrib if lanes is None else _join_lanes(lanes, contrib)

        kept = [ax for ax in range(in_rank) if ax not in pos]
        for d in a.digits:
            if d.axis in pos:
                poison |= self._finding(
                    "taint.gather-over-user-axis", node.name,
                    f"index along user axis {d.axis}: padded-lane data can "
                    "surface at arbitrary output positions")
                continue
            j = kept.index(d.axis)
            ax = j if adjacent and d.axis < first else j + idx_rank
            add(ax, d, a.lanes if isinstance(a.lanes, Known) else VARIANT)
        # index-side digits: an indexed element of a padded lane is an
        # arbitrary row of x (a uniform x keeps its value)
        picked = Known(a.const) if (a.const is not None and not a.marked) \
            else VARIANT
        for t in indices:
            if t is None:
                continue
            ta = self.read(t)
            shift = idx_rank - len(_shape(t))
            for d in ta.digits:
                add(first + d.axis + shift, d, picked)
        if not digits:
            return AbsVal(poison=poison)
        return AbsVal(digits=tuple(sorted(digits.values(),
                                          key=lambda d: d.axis)),
                      lanes=lanes, poison=poison)

    def _aten_gather(self, node):
        args = _named_args(node)
        x, index = args["self"], args["index"]
        dim = args["dim"] % len(_shape(x))
        a, ia = self.read(x), self.read(index)
        poison = frozenset()
        if any(d.axis == dim for d in a.digits):
            poison = self._finding(
                "taint.gather-over-user-axis", node.name,
                f"gather along user axis {dim}: padded-lane data can "
                "surface at arbitrary output positions")
        digits = {d.axis: d for d in a.digits if d.axis != dim}
        lanes = None
        for d in a.digits:
            if d.axis != dim:
                contrib = a.lanes if isinstance(a.lanes, Known) else VARIANT
                lanes = contrib if lanes is None else _join_lanes(lanes,
                                                                  contrib)
        for d in ia.digits:
            if d.axis in digits:
                continue
            digits[d.axis] = d
            contrib = Known(a.const) if a.const is not None else VARIANT
            lanes = contrib if lanes is None else _join_lanes(lanes, contrib)
        if isinstance(lanes, Known) and ia.marked:
            self._assume("index-typed padded lanes are in-bounds "
                         "(pad_schedule writes index 0)")
        if not digits:
            return AbsVal(poison=poison)
        return AbsVal(digits=tuple(sorted(digits.values(),
                                          key=lambda d: d.axis)),
                      lanes=lanes, poison=poison)

    def _aten_scatter_add(self, node):
        args = _named_args(node)
        x, index, src = args["self"], args["index"], args["src"]
        dim = args["dim"] % len(_shape(x))
        a, ia, sa = self.read(x), self.read(index), self.read(src)
        u_lane = self.lane_of(src, sa)
        o_lane = self.lane_of(x, a)
        poison = frozenset()
        if any(d.axis == dim for d in sa.digits + ia.digits) \
                and not _known_zero(u_lane):
            poison = self._finding(
                "taint.scatter-across-user-axis", node.name,
                f"scatter-add writes user-lane updates (lanes={u_lane}) "
                "at index-selected positions: padded-lane data can land in "
                "active rows")
        digits = {}
        for d in a.digits + sa.digits + ia.digits:
            if d.axis == dim:
                digits[dim] = Digit(dim, 1, _shape(node)[dim])
            else:
                digits.setdefault(d.axis, d)
        if not digits:
            return AbsVal(poison=poison)
        lanes = o_lane if _known_zero(u_lane) else VARIANT
        return AbsVal(digits=tuple(sorted(digits.values(),
                                          key=lambda d: d.axis)),
                      lanes=lanes, poison=poison)

    # kernel stand-ins -------------------------------------------------------

    def _lead(self, node, operands, label: str):
        """The digit on axis 0 of the operands (each treats axis 0
        independently); a digit on any other axis is a finding."""
        poison = frozenset()
        lead = None
        for x in operands:
            a = self.read(x)
            for d in a.digits:
                if d.axis != 0:
                    poison |= self._finding(
                        "taint.kernel-over-user-axis", node.name,
                        f"{label} mixes along axis {d.axis} of an operand, "
                        "a user axis: it treats only axis 0 independently")
                elif lead is None:
                    lead = d
        return lead, poison

    def _zero_if(self, *xs):
        if all(_known_zero(self.lane_of(x, self.read(x))) for x in xs):
            self._assume_finite()
            return Known(0.0)
        return VARIANT

    def _repro_torch_sbc_stats(self, node):
        x, thr = node.args[:2]
        lead, poison = self._lead(node, (x, thr), "sbc_stats")
        # a zero segment has no positive and no negative value: its sums
        # and counts are 0 whatever its threshold
        out = AbsVal(digits=(lead,), lanes=self._zero_if(x)) \
            if lead is not None else CLEAN
        return replace(out, poison=poison)

    def _repro_torch_sbc_apply(self, node):
        x, scalars = node.args[:2]
        lead, poison = self._lead(node, (x, scalars), "sbc_apply")
        if lead is None:
            return (CLEAN, CLEAN)
        # a zero value is never kept: out 0, residual 0 - 0
        lanes = self._zero_if(x)
        out = AbsVal(digits=(lead,), lanes=lanes, poison=poison)
        return (out, out)

    def _attn(self, node, label, outs_of):
        operands = [a for a in node.args if isinstance(a, torch.fx.Node)]
        lead, poison = self._lead(node, operands, label)
        vals = tuple(AbsVal(digits=(lead,), lanes=lanes, poison=poison)
                     if lead is not None else AbsVal(poison=poison)
                     for lanes in outs_of(lead))
        return vals if isinstance(_val(node), (tuple, list)) else vals[0]

    def _repro_torch_flash_attention_fwd(self, node):
        q, k, v = node.args[:3]
        # o = softmax(q kᵀ) v: zero when v is; lse is data
        return self._attn(node, "flash_attention_fwd",
                          lambda d: (self._zero_if(v), VARIANT))

    def _repro_torch_flash_attention_bwd_dq(self, node):
        do = node.args[5]
        # dP = dO vᵀ and D = rowsum(dO∘O) vanish with dO
        return self._attn(node, "flash_attention_bwd_dq",
                          lambda d: (self._zero_if(do), self._zero_if(do)))

    def _repro_torch_flash_attention_bwd_dkdv(self, node):
        do, dsum = node.args[4], node.args[5]
        # dV = Pᵀ dO; dK = dSᵀ q with dS = P∘(dP − D)
        return self._attn(node, "flash_attention_bwd_dkdv",
                          lambda d: (self._zero_if(do, dsum),
                                     self._zero_if(do)))

    def _repro_torch_ssd_scan_fwd(self, node):
        x, dt, A, Bm, Cm = node.args[:5]
        lead, poison = self._lead(node, (x, dt, Bm, Cm)
                                  + ((A,) if len(_shape(A)) == 2 else ()),
                                  "ssd_scan_fwd")
        if lead is None:
            return AbsVal(poison=poison)
        # y = C·h with h a sum of dt·B·x terms: zero when x is
        return AbsVal(digits=(lead,), lanes=self._zero_if(x), poison=poison)

    def _repro_torch_ssd_scan_bwd(self, node):
        x, dt, A, Bm, Cm, dy = node.args[:6]
        per_copy = len(_shape(A)) == 2
        lead, poison = self._lead(node, (x, dt, Bm, Cm, dy)
                                  + ((A,) if per_copy else ()),
                                  "ssd_scan_bwd")
        if lead is None:
            return tuple(AbsVal(poison=poison) for _ in range(5))
        zero = self._zero_if(dy)
        batch = AbsVal(digits=(lead,), lanes=zero, poison=poison)
        # A (copies, H): copy c owns B / copies consecutive sequences, so
        # its dA sums within one lane iff a lane spans whole copies
        per = _shape(x)[0] // _shape(A)[0] if per_copy else 0
        if per_copy and lead.sub_stride % per == 0:
            dA = AbsVal(digits=(Digit(0, lead.sub_stride // per,
                                      lead.extent),),
                        lanes=zero, poison=poison)
        elif _known_zero(zero):
            # dA sums over sequences of several lanes: a cross-user
            # reduction, safe iff the padded lanes' dy is zero
            self.n_certified += 1
            dA = AbsVal(poison=poison)
        else:
            dA = AbsVal(poison=poison | self._finding(
                "taint.unmasked-reduction", node.name,
                "ssd_scan_bwd sums dA over sequences of several lanes "
                f"with padded dy lanes {zero}"))
        return (batch, batch, dA, batch, batch)

    # fallback ---------------------------------------------------------------

    def _unknown(self, node, name):
        poison = self._finding(
            "taint.unhandled-primitive", node.name,
            f"op '{name}' has no transfer rule but consumes a "
            "user-lane-structured value")
        vals = _val(node)
        outs = []
        for t in (vals if isinstance(vals, (tuple, list)) else [vals]):
            shape = tuple(t.shape) if isinstance(t, torch.Tensor) else ()
            digits = tuple(Digit(ax, 1, s) for ax, s in enumerate(shape)
                           if s > 1)
            outs.append(AbsVal(digits=digits,
                               lanes=VARIANT if digits else None,
                               poison=poison))
        return tuple(outs) if isinstance(vals, (tuple, list)) else outs[0]


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------


def analyze_graph(gm: torch.fx.GraphModule, in_labels, out_contracts=None, *,
                  program: str = "program",
                  report: Optional[AuditReport] = None) -> AuditReport:
    """Run the padding-taint pass over one traced program.

    ``in_labels``: one :class:`LaneLabel` (or :data:`NO_LABEL`) per
    placeholder of ``gm`` (its flattened inputs, in order).
    ``out_contracts``: optional dict mapping flattened output index →
    :class:`OutContract` (padded lanes of that output must provably hold
    the contract value — the period-resumption induction).  Findings land
    in ``report`` (new one if None) and a per-program summary in
    ``report.programs[program]``.
    """
    if report is None:
        report = AuditReport()
    interp = _Interp(report, program)
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    in_vals = []
    for i, (node, label) in enumerate(zip(placeholders, in_labels)):
        if label is None or label.axis is None:
            in_vals.append(CLEAN)
            continue
        shape = _shape(node)
        assert 0 <= label.axis < len(shape), \
            f"label axis {label.axis} out of range for input {i} {shape}"
        lanes = VARIANT if label.lanes == "variant" else Known(label.lanes)
        in_vals.append(AbsVal(
            digits=(Digit(label.axis, 1, shape[label.axis]),), lanes=lanes))
    outs = interp.run(gm, in_vals)
    n_poisoned = 0
    for i, o in enumerate(outs):
        if o.poison:
            n_poisoned += 1
            report.add("taint.poisoned-output", Severity.ERROR,
                       f"{program}:out[{i}]",
                       f"output {i} is influenced by taint violations: "
                       f"{sorted(o.poison)}")
    for i, contract in (out_contracts or {}).items():
        o = outs[i]
        if contract.axis is None:
            ok = not o.marked
            want = "no user-lane structure"
        else:
            ok = any(d.axis == contract.axis for d in o.digits) and \
                isinstance(o.lanes, Known) and \
                float(o.lanes.value) == float(contract.value)
            # an unmarked constant output equal to the contract also
            # satisfies
            ok = ok or (not o.marked and o.const is not None
                        and float(o.const) == float(contract.value))
            want = (f"Known({contract.value}) on padded lanes of axis "
                    f"{contract.axis}")
        if not ok:
            report.add("taint.output-contract", Severity.ERROR,
                       f"{program}:out[{i}]",
                       f"output {i} must hold {want}; analysis derived "
                       f"digits={o.digits} lanes={o.lanes}")
    for text in sorted(interp.assumptions):
        report.add("taint.assumption", Severity.INFO, program, text)
    report.programs[program] = {
        "pass": "taint",
        "n_eqns": interp.n_eqns,
        "n_certified_reductions": interp.n_certified,
        "n_outputs": len(outs),
        "n_poisoned_outputs": n_poisoned,
        "assumptions": sorted(interp.assumptions),
        "ok": not any(f.severity is Severity.ERROR
                      for f in report.findings
                      if f.where.startswith(program)),
    }
    return report
