"""Trace a user env's PyTorch step into a step functor for the rollout kernels.

Counterpart of the JAX package's ``Env.generic_lane_functions``
(``tfmpc_tpu/models/base.py``), which vmaps an env's public ``transition``,
``cost`` and ``final_cost`` over the lanes and traces them into the body of
its Pallas rollout kernels. Here the three are traced on one scenario
(``x [n]``, ``u [m]``) with ``make_fx`` in fake mode, at the call's dtype
and dims, into a graph of plain aten ops (no ``torch.compile``, no Inductor,
no Triton), and the graph is emitted as C++ source for a functor in the
contract of ``csrc/envs.cuh``: ``stage_cost``, ``final_cost``, ``Pre
prep(x)``, ``row(pre, i, x, u, x_i, u_i)``, ``param_elems()`` and
``each_param(f)``, over ``Dims<kAnyDim>``. ``csrc/rollout_user.cuh``
compiles it into the generic rollout kernel's K2, K3 and K5
(``_build.user_library``).

Every float tensor the step reads from the env (a ``_tensor_constant`` of
the trace) is a parameter array: a pointer the kernel copies into shared
memory once a block, read at launch. So the source depends on the graph,
the shapes and the dtype, not on the parameter values, and a new env
instance with other values reuses the build. Two kinds of value are
literals in the source instead: Python scalars in the step, cast to the
operation's dtype as torch's type promotion casts them, and integer
tensors that depend on no input (a constant index list, ``x[[0, 2, 1]]``,
an ``arange``, an integer tensor of the env), evaluated when the source is
emitted. An env whose integer constants change gets another source.

The functor evaluates each node lazily at the index it is read at: row i of
the next state computes only the elements that row depends on, pushing the
index back through elementwise and broadcast ops, views and index maps
(pads, flips, rolls, repeats, diagonals, constant indexing, splits),
reductions, scans and matrix products (row i of ``A v`` is one dot
product). ``prep`` holds what every row reads whole: the nodes that depend
on x but not on u and that a row reads at an index independent of i
(navigation's lambda(x), a vector under a contraction), at most
``PREP_MAX_ELEMS`` values each. A node that depends on u and that every
row reads whole (a product ``A (B u)``) is recomputed in every row.
Reductions, scans and products sum in index order from zero, ``pow`` by 2
and 3 are products, as torch computes them; each op keeps torch's
semantics where C's differ (``round`` to even, ``remainder`` with the
divisor's sign, ``sign(NaN) = 0``, the NaN that ``max``, ``clamp`` and the
norms propagate); the stage and final costs are evaluated whole.

Linear algebra on one square matrix of the step (at most 8x8) and sorts
along a dim (at most PREP_MAX_ELEMS values) are read whole
(``_Body.whole``): a short loop fills a local array once a method, before
the loops and branches that read it. Solves, inverses and determinants go
through an LU factor with partial pivoting as LAPACK's getf2 takes it
(``lu_factor``/``lu_solve`` too), ``cholesky``/``cholesky_solve`` through
a Cholesky factor column by column, and ``solve_triangular`` substitutes
directly; the factor of a matrix that depends on x and not on u is
``prep``'s, so each row does only the substitutions. A kernel cannot
raise: where torch's step raises for a singular or indefinite matrix
(``_linalg_check_errors``, dropped here), the functor gives what the
arithmetic gives, inf or NaN. Sorts keep their float values: element k of
a slice is its element of stable rank k, NaN the largest, an O(L^2)
count (``sort``, ``topk``, ``kthvalue``, ``median``).

Integer values computed from the state or the controls (int64 and int32,
``int64_t``/``int32_t``) are nodes like the floats, computed at the index
they are read at: ``argmax``/``argmin`` and the indices of max/min over a
dim (the first extreme, NaN the extreme), of sorts (each element's stable
rank), ``bucketize``/``searchsorted`` (torch's binary search), float to
integer casts (toward zero; NaN, the infinities and values past the
type's range give its least value, as torch's CPU casts), integer
arithmetic as torch's (wrapping; floor division and ``remainder`` with
the divisor's sign; a division or remainder by zero, which raises in
torch, gives 0), comparisons, ``clamp``, ``where``. Reads at indices
computed at run time (``index.Tensor`` with run-time index tensors
broadcast among constant ones and None slots, ``gather``,
``index_select``) wrap a negative index and clamp one still out of range
into the dim, as JAX's ``x[i]`` does: torch raises there, a kernel
cannot. A step written for one scenario reads at 0-d integer tensors
(``vals[torch.bucketize(x[0], knots)]``), where torch's indexing calls
``.item()``: ``trace_step`` traces under ``ScalarIndexMode``, which reads
there through a 1-element index instead, the same values.

An op outside ``SUPPORTED_OPS`` that ``torch._decomp`` decomposes is traced
again through its decomposition, which keeps torch's semantics by
construction: the activations (``softplus`` with its threshold, ``gelu``,
``silu``, ``elu``, ``leaky_relu``, ``hardtanh``), ``_softmax``,
``_log_softmax`` and ``logsumexp`` (shifted by its max, 0 where that max
is infinite), ``xlogy``, ``logaddexp``, ``lerp``, ``addcmul``,
``hardswish``, ``mish``, ``dist``, ``frac``, ...; the source's header
names the ops that went that way. A step the functor cannot express raises
``NotImplementedError`` naming the op or node and the two opt-outs: any
other op (eigen- and singular-value decompositions, random ops, random
indices included), a data-dependent branch or shape (``nonzero``, a mask),
an output of the wrong shape or dtype, ``searchsorted`` with a
``sorter``, a batch of matrices or right-hand sides within the step,
``solve(left=False)``, a matrix or sort beyond the local arrays' size.
"""

from __future__ import annotations

import math
import operator
import re
import weakref
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
from torch._decomp import decomposition_table, get_decompositions
from torch._subclasses.fake_tensor import DynamicOutputShapeException
from torch.fx.experimental.proxy_tensor import make_fx
from torch.overrides import TorchFunctionMode

from tfmpc_tpu_torch.models.base import USER_STEP_ID, DeviceStep

aten = torch.ops.aten

OPT_OUTS = ("run with use_pallas=False, or return None from the env's "
            "device_step() to keep its rollouts on the plain PyTorch path")
# the most values of one node that ``prep`` holds for the rows
PREP_MAX_ELEMS = 64

_CTYPES = {torch.float32: "float", torch.float64: "double",
           torch.bool: "bool", torch.int64: "int64_t", torch.int32: "int32_t"}
_DTYPES = {"float": torch.float32, "double": torch.float64}
# the integer C types, each with the unsigned type its wrapping arithmetic
# goes through and its least value
_INTS = {"int64_t": ("uint64_t", -2 ** 63), "int32_t": ("uint32_t", -2 ** 31)}
_ROW = "i"  # row()'s index: an index expression that names it depends on i

# -- ops ----------------------------------------------------------------------

# views: (node, output index) -> the index of their input
_VIEWS = {
    aten.unsqueeze.default, aten.squeeze.dim, aten.squeeze_.dim,
    aten.squeeze.dims, aten.squeeze.default, aten.unsqueeze_.default,
    aten.permute.default, aten.t.default, aten.transpose.int,
    aten.expand.default, aten.view.default, aten._unsafe_view.default,
    aten.reshape.default, aten.select.int, aten.slice.Tensor,
    aten.clone.default, aten.alias.default, aten.detach.default,
    aten.lift_fresh_copy.default,
}
# literal tensors: their value depends on no input
_LITERALS = {
    aten.zeros_like.default, aten.ones_like.default,
    aten.full_like.default, aten.full.default, aten.zeros.default,
    aten.ones.default, aten.scalar_tensor.default, aten.eye.default,
    aten.new_zeros.default, aten.new_ones.default, aten.new_full.default,
}
_UNARY = {
    aten.neg.default: lambda T, a: f"(-{a})",
    aten.reciprocal.default: lambda T, a: f"({T}(1) / {a})",
    aten.sqrt.default: lambda T, a: f"{_f('sqrt', T)}({a})",
    aten.rsqrt.default: lambda T, a: f"({T}(1) / {_f('sqrt', T)}({a}))",
    aten.exp.default: lambda T, a: f"{_f('exp', T)}({a})",
    aten.expm1.default: lambda T, a: f"{_f('expm1', T)}({a})",
    aten.log.default: lambda T, a: f"{_f('log', T)}({a})",
    aten.log1p.default: lambda T, a: f"{_f('log1p', T)}({a})",
    aten.sin.default: lambda T, a: f"{_f('sin', T)}({a})",
    aten.cos.default: lambda T, a: f"{_f('cos', T)}({a})",
    aten.tanh.default: lambda T, a: f"{_f('tanh', T)}({a})",
    aten.abs.default: lambda T, a: f"{_f('fabs', T)}({a})",
    aten.sigmoid.default:
        lambda T, a: f"({T}(1) / ({T}(1) + {_f('exp', T)}(-{a})))",
    # max(v, 0) that keeps NaN, as torch.relu does
    aten.relu.default: lambda T, a: f"({a} < {T}(0) ? {T}(0) : {a})",
    aten.logical_not.default: lambda T, a: f"(!{a})",
    # round half to even, as torch.round
    aten.round.default: lambda T, a: f"{_f('rint', T)}({a})",
    # 0 at 0 and at NaN, as torch.sign
    aten.sign.default:
        lambda T, a: f"({a} > {T}(0) ? {T}(1) : {a} < {T}(0) ? {T}(-1) "
                     f": {T}(0))",
}
_UNARY[aten.sgn.default] = _UNARY[aten.sign.default]   # sign, for reals
for _name in ("atan", "tan", "sinh", "cosh", "asin", "acos", "asinh", "acosh",
              "atanh", "erf", "erfc", "exp2", "log2", "log10", "floor",
              "ceil", "trunc"):
    _UNARY[getattr(aten, _name).default] = \
        lambda T, a, _name=_name: f"{_f(_name, T)}({a})"
# bool of a float operand, read at its own type (decompositions use it)
_PREDICATES = {
    aten.isnan.default: lambda T, a: f"({a} != {a})",
    aten.isinf.default:
        lambda T, a: f"({_f('fabs', T)}({a}) == {_literal(math.inf, T)})",
    aten.isfinite.default:
        lambda T, a: f"({_f('fabs', T)}({a}) < {_literal(math.inf, T)})",
}
_BINARY = {
    aten.mul.Tensor: lambda T, a, b: f"({a} * {b})",
    aten.mul.Scalar: lambda T, a, b: f"({a} * {b})",
    aten.div.Tensor: lambda T, a, b: f"({a} / {b})",
    aten.div.Scalar: lambda T, a, b: f"({a} / {b})",
    aten.pow.Tensor_Tensor: lambda T, a, b: f"{_f('pow', T)}({a}, {b})",
    aten.pow.Scalar: lambda T, a, b: f"{_f('pow', T)}({a}, {b})",
    # NaN if either is NaN, as torch.minimum and torch.maximum
    aten.minimum.default:
        lambda T, a, b: f"({a} != {a} || {a} < {b} ? {a} : {b} != {b} "
                        f"? {b} : {b} < {a} ? {b} : {a})",
    aten.maximum.default:
        lambda T, a, b: f"({a} != {a} || {a} > {b} ? {a} : {b} != {b} "
                        f"? {b} : {b} > {a} ? {b} : {a})",
    aten.logical_and.default: lambda T, a, b: f"({a} && {b})",
    aten.logical_or.default: lambda T, a, b: f"({a} || {b})",
    aten.atan2.default: lambda T, a, b: f"{_f('atan2', T)}({a}, {b})",
    aten.hypot.default: lambda T, a, b: f"{_f('hypot', T)}({a}, {b})",
    aten.copysign.Tensor:
        lambda T, a, b: f"{_f('copysign', T)}({a}, {b})",
    aten.copysign.Scalar:
        lambda T, a, b: f"{_f('copysign', T)}({a}, {b})",
    # the dividend's sign, as torch.fmod
    aten.fmod.Tensor: lambda T, a, b: f"{_f('fmod', T)}({a}, {b})",
    aten.fmod.Scalar: lambda T, a, b: f"{_f('fmod', T)}({a}, {b})",
    # 0 at NaN, as torch.heaviside
    aten.heaviside.default:
        lambda T, a, b: f"({a} == {T}(0) ? {b} : {a} > {T}(0) ? {T}(1) "
                        f": {T}(0))",
}
# the divisor's sign, as torch.remainder: fmod moved by the divisor
_REMAINDER = {aten.remainder.Tensor, aten.remainder.Scalar}
# elementwise ops with scalar options (read in ``_Body._options``)
_OPTIONS = {aten.nan_to_num.default, aten.round.decimals,
            aten.masked_fill.Scalar, aten.masked_fill.Tensor}
_COMPARE = {}
for _name, _sym in (("gt", ">"), ("lt", "<"), ("ge", ">="), ("le", "<="),
                    ("eq", "=="), ("ne", "!=")):
    for _overload in ("Tensor", "Scalar"):
        _COMPARE[getattr(getattr(aten, _name), _overload)] = _sym
_ADD = {aten.add.Tensor: 1, aten.add.Scalar: 1, aten.sub.Tensor: -1,
        aten.sub.Scalar: -1}
_CLAMP = {aten.clamp.default, aten.clamp.Tensor, aten.clamp_min.default,
          aten.clamp_max.default}
_WHERE = {aten.where.self, aten.where.ScalarSelf, aten.where.ScalarOther,
          aten.where.Scalar}
_REDUCE = {aten.sum.dim_IntList, aten.sum.default, aten.mean.dim,
           aten.mean.default, aten.prod.dim_int, aten.prod.default,
           aten.amax.default, aten.amin.default, aten.max.default,
           aten.min.default}
# reductions and scans over dims, each with its own arithmetic
_NORMS = {aten.linalg_vector_norm.default}
_SCANS = {aten.cumsum.default: "+", aten.cumprod.default: "*"}
_MOMENTS = {aten.var.correction, aten.std.correction}
_OTHER_REDUCE = {aten.trace.default, aten._cdist_forward.default} | _MOMENTS
_MATMUL = {aten.mm.default, aten.mv.default, aten.dot.default,
           aten.addmm.default, aten.addmv.default, aten.bmm.default}
# index maps: each element of the output is one element of the input (or
# a literal outside it), or, for the cross product, a few
_INDEX_MAPS = {aten.constant_pad_nd.default, aten.flip.default,
               aten.roll.default, aten.repeat.default,
               aten.diagonal.default, aten.diag_embed.default,
               aten.index.Tensor}
# the triangles of a matrix: index maps with a literal 0 outside
_TRIANGLES = {aten.tril.default: "<=", aten.triu.default: ">="}
# nodes read whole (``_Body.whole``): each is a short loop that fills a
# local array of at most PREP_MAX_ELEMS values, once a method. Linear
# algebra on one matrix of the step (2-D, at most 8x8): solves, inverses,
# determinants and the triangular solves on an LU factor with partial
# pivoting or a Cholesky factor; ``(op, outputs read)``
_LINALG_MULTI = {
    aten._linalg_solve_ex.default: (0,), aten.linalg_inv_ex.default: (0,),
    aten._linalg_det.default: (0,), aten._linalg_slogdet.default: (0, 1),
    aten.linalg_cholesky_ex.default: (0,),
    aten.linalg_lu_factor_ex.default: (0, 1),   # 1: the pivots, for lu_solve
}
_LINALG = {aten.cholesky_solve.default, aten.linalg_lu_solve.default,
           aten.linalg_solve_triangular.default}
# sorts along a dim: element k of the values is the input of stable rank k
# (NaN sorts as the largest), and of the indices that input's index
_SORTS_MULTI = {aten.sort.default: (0, 1), aten.sort.stable: (0, 1),
                aten.topk.default: (0, 1), aten.kthvalue.default: (0, 1),
                aten.median.dim: (0, 1)}
_SORTS = {aten.median.default}
_WHOLE_MULTI = {**_LINALG_MULTI, **_SORTS_MULTI}
_WHOLE = set(_WHOLE_MULTI) | _LINALG | _SORTS
# nodes with more than one output, read only through ``operator.getitem``
# (the values and indices of max/min over a dim; the outputs of the nodes
# read whole that ``_WHOLE_MULTI`` names)
_MULTI = {aten.max.dim, aten.min.dim, aten.split_with_sizes.default,
          aten.split.Tensor, aten.unbind.int} | set(_WHOLE_MULTI)
_OTHER = {aten.pow.Tensor_Scalar, aten.rsub.Scalar, aten._to_copy.default,
          aten.cat.default, aten.stack.default, aten.linalg_cross.default,
          operator.getitem}
# ops that compute integers: the index of the first largest (smallest)
# element, NaN the extreme; binary searches as torch's (the count of the
# sorted values below, or not above, each value); reads at indices
# computed at run time (negative ones wrap, ones out of range are clamped
# into it, as JAX's ``x[i]``); rounding divisions (of floats too)
_ARG_EXTREME = {aten.argmax.default: True, aten.argmin.default: False}
_SEARCH = {aten.bucketize.Tensor, aten.searchsorted.Tensor}
_GATHER = {aten.gather.default, aten.index_select.default}
_DIVIDE = {aten.floor_divide.default, aten.floor_divide.Scalar,
           aten.div.Tensor_mode, aten.div.Scalar_mode}
_INTEGER = set(_ARG_EXTREME) | _SEARCH | _GATHER | _DIVIDE

SUPPORTED_OPS = frozenset(
    set(_VIEWS) | set(_LITERALS) | set(_UNARY) | set(_PREDICATES)
    | set(_BINARY) | _REMAINDER | _OPTIONS | set(_COMPARE) | set(_ADD)
    | _CLAMP | _WHERE | _REDUCE | _NORMS | set(_SCANS)
    | _OTHER_REDUCE | _MATMUL | _INDEX_MAPS | set(_TRIANGLES) | _MULTI
    | _WHOLE | _OTHER | _INTEGER)
# the ops whose emitter computes an integer output in integer arithmetic
# (wrapping as torch's; a division by zero, which raises in torch, gives
# 0); any other op with an integer output is refused
_INT_OPS = frozenset(
    set(_VIEWS) | set(_LITERALS) | _INDEX_MAPS | set(_TRIANGLES) | _WHERE
    | _CLAMP | _REMAINDER | _INTEGER | set(_ADD) | {
        aten.neg.default, aten.abs.default, aten.sign.default,
        aten.sgn.default, aten.relu.default, aten.floor.default,
        aten.ceil.default, aten.round.default, aten.trunc.default,
        aten.mul.Tensor, aten.mul.Scalar, aten.rsub.Scalar,
        aten.minimum.default, aten.maximum.default, aten.fmod.Tensor,
        aten.fmod.Scalar, aten.masked_fill.Scalar, aten.masked_fill.Tensor,
        aten.sum.dim_IntList, aten.sum.default, aten.amax.default,
        aten.amin.default, aten.max.default, aten.min.default,
        aten.cumsum.default, aten._to_copy.default, aten.cat.default,
        aten.stack.default, operator.getitem})


def _f(name: str, T: str) -> str:
    """The C math function ``name`` for the scalar type ``T`` (``expf``
    for float, ``exp`` for double)."""
    return name + "f" if T == "float" else name


def _op_name(target) -> str:
    return str(target).replace("aten.", "aten::", 1)


def _refuse(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the generated rollout functor cannot express it; "
        f"{OPT_OUTS}")


# -- index expressions --------------------------------------------------------
# An index is an int (known when the source is emitted) or a C++ expression.

def _iadd(a, b):
    if isinstance(a, int) and isinstance(b, int):
        return a + b
    if a == 0:
        return b
    if b == 0:
        return a
    return f"({a} + {b})"


def _imul(a, k: int):
    if isinstance(a, int):
        return a * k
    if k == 1:
        return a
    if k == 0:
        return 0
    return f"({a} * {k})"


def _idiv(a, k: int):
    if isinstance(a, int):
        return a // k
    return a if k == 1 else f"({a} / {k})"


def _imod(a, k: int):
    if isinstance(a, int):
        return a % k
    return 0 if k == 1 else f"({a} % {k})"


def _flat(idx, shape):
    """The row-major offset of ``idx`` in a contiguous ``shape``."""
    off, stride = 0, 1
    for ix, size in zip(reversed(idx), reversed(shape)):
        off = _iadd(off, _imul(ix, stride))
        stride *= size
    return off


def _uses_row(idx) -> bool:
    return any(isinstance(ix, str) and re.search(rf"\b{_ROW}\b", ix)
               for ix in idx)


def _literal(v, T: str) -> str:
    if isinstance(v, bool) or T == "bool":
        return "true" if v else "false"
    if T in _INTS:   # an infinity is the type's bound (a max's start)
        least = _INTS[T][1]
        if isinstance(v, float) and math.isinf(v):
            v = least if v < 0 else -least - 1
        v = int(v)
        return f"({T}({v + 1}) - 1)" if v == least else f"{T}({v})"
    v = float(v)
    if math.isnan(v):
        return f"({T}(0) / {T}(0))"
    if math.isinf(v):
        return f"({'-' if v < 0 else ''}{T}(1) / {T}(0))"
    return f"{T}({v!r})"


def _cast(expr: str, src: str, dst: str) -> str:
    if src == dst:
        return expr
    if dst == "bool":
        return f"({expr} != {src}(0))"
    if dst in _INTS and src in _DTYPES:
        # toward zero; NaN, the infinities and values past the type's range
        # give its least value, as torch's CPU casts
        least = _INTS[dst][1]
        return (f"({expr} >= {float(least)!r} && {expr} < {float(-least)!r} "
                f"? static_cast<{dst}>({expr}) : {_literal(least, dst)})")
    return f"static_cast<{dst}>({expr})"


def _wrap(T: str, a: str, op: str, b: str) -> str:
    """``a op b`` in the integer type ``T``, wrapping as torch's integer
    arithmetic does (through the unsigned type: C's signed overflow is
    undefined)."""
    U = _INTS[T][0]
    return (f"static_cast<{T}>(static_cast<{U}>({a}) {op} "
            f"static_cast<{U}>({b}))")


# -- the traced graph ---------------------------------------------------------

class _Graph:
    """The traced step: its nodes' shapes, C types and dependence on u, and
    the parameter arrays."""

    def __init__(self, gm, name: str, n: int, m: int, dtype):
        self.gm, self.name, self.n, self.m = gm, name, n, m
        self.S = _CTYPES[dtype]
        nodes = list(gm.graph.nodes)
        self.pos = {nd: k for k, nd in enumerate(nodes)}
        self.x, self.u = [nd for nd in nodes if nd.op == "placeholder"]
        (outs,) = [nd.args[0] for nd in nodes if nd.op == "output"]
        self.xn, self.cost, self.final = outs
        self._check_outputs()
        self.shape, self.ctype, self.dep_u = {}, {}, {}
        live = self._live()
        self.params: List[str] = []  # get_attr targets, in graph order
        # integer tensors that depend on no input: their values, evaluated
        # here (literals in the source)
        self.consts: Dict[object, torch.Tensor] = {}
        for nd in nodes:
            if nd not in live:
                continue
            val = nd.meta.get("val")
            if isinstance(val, torch.Tensor) and not all(
                    isinstance(d, int) for d in val.shape):
                raise _refuse(f"{name}: node {nd.name} "
                              f"({_op_name(nd.target)}) has a data-dependent "
                              f"shape {list(val.shape)}")
            if nd.op == "call_function" and nd.target in _MULTI:
                self._check_multi(nd, live)
                self.dep_u[nd] = any(self.dep_u[a] for a in _node_args(nd))
                if nd.target in _WHOLE_MULTI:
                    self._check_whole(nd)
                continue
            integer = isinstance(val, torch.Tensor) and not (
                val.is_floating_point() or val.is_complex()
                or val.dtype == torch.bool)
            if integer and self._integer_constant(nd, val):
                continue
            if nd.op == "call_function" and nd.target not in SUPPORTED_OPS:
                raise _refuse(f"{name}: aten op {_op_name(nd.target)} (node "
                              f"{nd.name}) is not supported")
            if not isinstance(val, torch.Tensor):
                raise _refuse(f"{name}: node {nd.name} ({nd.target}) is not "
                              "a tensor")
            if nd.op == "call_function" and nd.target is operator.getitem \
                    and nd.args[0].target is aten.linalg_lu_factor_ex.default \
                    and nd.args[1] == 1:
                if not self._pivots(nd, live):
                    raise _refuse(f"{name}: node {nd.name} reads the pivots "
                                  "of aten::linalg_lu_factor_ex other than "
                                  "as lu_solve's")
                self.dep_u[nd] = self.dep_u[nd.args[0]]
                continue
            if val.dtype not in _CTYPES or integer and (
                    nd.op == "call_function" and nd.target not in _INT_OPS):
                raise _refuse(f"{name}: node {nd.name} "
                              f"({_op_name(nd.target)}) has dtype "
                              f"{val.dtype}: the functor computes float32, "
                              "float64 and bool values, and int64 and int32 "
                              "ones through the ops of its integer family")
            if nd.op == "call_function" and nd.target is operator.getitem \
                    and nd.args[0].target not in _MULTI:
                raise _refuse(f"{name}: node {nd.name} reads an output of "
                              f"{_op_name(nd.args[0].target)}")
            if nd.op == "call_function" and nd.target is operator.getitem \
                    and nd.args[1] not in _WHOLE_MULTI.get(
                        nd.args[0].target, (nd.args[1],)):
                raise _refuse(f"{name}: node {nd.name} reads output "
                              f"{nd.args[1]} of "
                              f"{_op_name(nd.args[0].target)}")
            if nd.op == "call_function" and nd.target in _WHOLE:
                self._check_whole(nd)
            self.shape[nd] = tuple(int(s) for s in val.shape)
            self.ctype[nd] = _CTYPES[val.dtype]
            literal = nd.op == "call_function" and nd.target in _LITERALS
            self.dep_u[nd] = nd is self.u or (
                not literal and any(self.dep_u[a] for a in _node_args(nd)))
            if nd.op == "get_attr" and nd.target not in self.params:
                self.params.append(nd.target)
            if nd.op == "call_function" and nd.target not in SUPPORTED_OPS:
                raise _refuse(f"{name}: aten op {_op_name(nd.target)} (node "
                              f"{nd.name}) is not supported")
            if nd.op == "call_function" and nd.target in (
                    aten.squeeze_.dim, aten.unsqueeze_.default) \
                    and len(nd.args[0].users) != 1:
                raise _refuse(f"{name}: in-place {_op_name(nd.target)} (node "
                              f"{nd.name}) on a tensor used elsewhere")
        self.param_shape = {t: tuple(getattr(gm, t).shape)
                            for t in self.params}
        self.param_index = {t: k for k, t in enumerate(self.params)}
        self._names: Dict[object, str] = {}
        self._count = 0

    def _check_multi(self, nd, live):
        """A node with several outputs: every user an ``operator.getitem``
        (the integer outputs, if read, are refused as integer values)."""
        for user in nd.users:
            if user in live and not (user.op == "call_function"
                                     and user.target is operator.getitem):
                raise _refuse(f"{self.name}: {_op_name(nd.target)} (node "
                              f"{nd.name}) is read whole by {user.name}")

    def _pivots(self, nd, live) -> bool:
        """The pivots of ``lu_factor``, read only as ``lu_solve``'s: the
        one integer value computed from the state that a step may hold."""
        return (nd.target is operator.getitem
                and nd.args[0].target is aten.linalg_lu_factor_ex.default
                and nd.args[1] == 1
                and all(user.target is aten.linalg_lu_solve.default
                        and user.args[1] is nd and user.args[0] is not nd
                        and user.args[2] is not nd
                        for user in nd.users if user in live))

    def _check_whole(self, nd):
        """A node read whole: its matrices 2-D, square where factored, and
        each operand and output at most PREP_MAX_ELEMS values (the local
        arrays of ``_Body.whole``); the options the functor cannot take
        refused."""
        t, what = nd.target, f"{self.name}: {_op_name(nd.target)} (node " \
                             f"{nd.name})"
        shapes = [tuple(a.meta["val"].shape) for a in _node_args(nd)
                  if isinstance(a.meta.get("val"), torch.Tensor)
                  and a.meta["val"].is_floating_point()]
        for shape in shapes:
            if math.prod(shape) > PREP_MAX_ELEMS:
                raise _refuse(f"{what} reads a tensor of shape "
                              f"{list(shape)}: the functor holds at most "
                              f"{PREP_MAX_ELEMS} values of one (an 8x8 "
                              "matrix)")
        if t in _SORTS_MULTI or t in _SORTS:
            if t is aten.topk.default and not _opt(nd, 4, "sorted", True):
                raise _refuse(f"{what}: topk(sorted=False), whose order is "
                              "torch's implementation's")
            return
        mat = nd.args[1 if t is aten.cholesky_solve.default else 0]
        shape = tuple(mat.meta["val"].shape)
        if len(shape) != 2 or shape[0] != shape[1]:
            raise _refuse(f"{what}: a matrix of shape {list(shape)} (the "
                          "functor solves and factors one square matrix of "
                          "the step, not a batch)")
        rhs = {aten._linalg_solve_ex.default: 1, aten.cholesky_solve.default: 0,
               aten.linalg_lu_solve.default: 2,
               aten.linalg_solve_triangular.default: 1}.get(t)
        if rhs is not None and len(nd.args[rhs].meta["val"].shape) > 2:
            raise _refuse(f"{what}: a batch of right-hand sides of shape "
                          f"{list(nd.args[rhs].meta['val'].shape)}")
        if t is aten._linalg_solve_ex.default and not _opt(nd, 2, "left",
                                                           True):
            raise _refuse(f"{what}: solve(left=False)")
        if t is aten.linalg_lu_solve.default and (
                not _opt(nd, 3, "left", True) or _opt(nd, 4, "adjoint",
                                                      False)):
            raise _refuse(f"{what}: lu_solve(left=False or adjoint=True)")

    def _integer_constant(self, nd, val) -> bool:
        """An integer node that depends on no input (an integer tensor of
        the env, an ``arange``, or an op of such nodes only): its value is
        evaluated now, and read as literals (``consts``). False for one
        computed from the state, the controls or a float parameter, which
        the functor computes. Random integers are refused: a draw evaluated
        once would be every step's."""
        if torch.Tag.nondeterministic_seeded in getattr(nd.target, "tags",
                                                        ()):
            raise _refuse(f"{self.name}: node {nd.name} "
                          f"({_op_name(nd.target)}) has dtype {val.dtype}: "
                          "random ops are not supported (a draw evaluated "
                          "once would be every step's)")
        if nd.op not in ("get_attr", "call_function") or any(
                a not in self.consts for a in _node_args(nd)):
            return False
        if nd.op == "get_attr":
            value = getattr(self.gm, nd.target).detach().cpu()
        else:
            sub = lambda a: self.consts[a] if isinstance(  # noqa: E731
                a, torch.fx.Node) else a
            args_ = [[sub(b) for b in a] if isinstance(a, (list, tuple)) else
                     sub(a) for a in nd.args]
            kwargs = {k: sub(v) for k, v in nd.kwargs.items()}
            if "device" in kwargs:
                kwargs["device"] = "cpu"
            value = nd.target(*args_, **kwargs).detach().cpu()
        self.consts[nd] = value
        self.dep_u[nd] = False
        self.shape[nd] = tuple(value.shape)
        # read as a value at its own type (a literal of the values)
        self.ctype[nd] = _CTYPES.get(value.dtype, "int64_t")
        return True

    def _check_outputs(self):
        n, m = self.n, self.m
        for node, want, what in ((self.xn, (n,), "transition(x [n], u [m])"),
                                 (self.cost, (), "cost(x [n], u [m])"),
                                 (self.final, (), "final_cost(x [n])")):
            val = getattr(node, "meta", {}).get("val")
            got = tuple(val.shape) if isinstance(val, torch.Tensor) else None
            if got != want:
                raise _refuse(f"{self.name}: {what} returned shape {got}, "
                              f"not {want}")
            if not val.is_floating_point():
                raise _refuse(f"{self.name}: {what} returned dtype "
                              f"{val.dtype}, not a floating-point one")

    def _live(self):
        live, todo = set(), [self.xn, self.cost, self.final]
        while todo:
            nd = todo.pop()
            if nd not in live:
                live.add(nd)
                todo.extend(_node_args(nd))
        return live

    def fresh(self, prefix: str) -> str:
        self._count += 1
        return f"{prefix}{self._count}"

    def hoist_name(self, node) -> str:
        if node not in self._names:
            self._names[node] = f"h{len(self._names)}"
        return self._names[node]

    def hoistable(self, node) -> bool:
        """A computed node that depends on no control: ``prep`` may hold
        it for the rows (a view or an index map only moves what it reads;
        the outputs of a factorization are its factor's, which ``prep``
        holds instead, ``whole``)."""
        t = node.target
        moves = t in _VIEWS or t in _LITERALS or t in _INDEX_MAPS \
            or t in _TRIANGLES or t in _GATHER or node in self.consts or (
                t is operator.getitem and node.args[0].target in (
                    aten.split_with_sizes.default, aten.split.Tensor,
                    aten.unbind.int, aten.linalg_lu_factor_ex.default,
                    aten.linalg_cholesky_ex.default))
        return (node.op == "call_function" and not moves
                and not self.dep_u[node]
                and math.prod(self.shape[node]) <= PREP_MAX_ELEMS)

    @staticmethod
    def read_whole(node) -> bool:
        """A node whose every element is computed with the others
        (``_Body.whole``): ``prep`` holds it whatever index a row reads."""
        return node.target in _WHOLE or (
            node.target is operator.getitem
            and node.args[0].target in _WHOLE_MULTI)


class _Elems(NamedTuple):
    """Elements computed at an index (``at(sub)``) over ``shape``: what a
    fold reads where no node holds it (cdist's row differences)."""

    shape: tuple
    at: Callable


def _opt(node, k: int, name: str, default):
    """Argument ``k`` of ``node``, or its keyword ``name``."""
    if len(node.args) > k:
        return node.args[k]
    return node.kwargs.get(name, default)


def _dims(dim, r: int):
    """The sorted dims a reduction's ``dim`` argument names (all for
    None or [])."""
    if dim is None or (isinstance(dim, (list, tuple)) and len(dim) == 0):
        return list(range(r))
    return sorted({d % r for d in ([dim] if isinstance(dim, int) else dim)})


def _node_args(node):
    """The graph nodes among ``node``'s arguments (lists included)."""
    out = []
    for a in list(node.args) + list(node.kwargs.values()):
        if isinstance(a, (list, tuple)):
            out.extend(b for b in a if isinstance(b, torch.fx.Node))
        elif isinstance(a, torch.fx.Node):
            out.append(a)
    return out


# -- emission -----------------------------------------------------------------

class _Body:
    """The statements of one method of the functor. ``mode`` is ``"scan"``
    (row()'s first pass: finds what prep holds), ``"row"``, ``"prep"`` or
    ``"whole"`` (the costs). ``work`` counts the statements it runs, each
    times its loops' trip counts."""

    def __init__(self, g: _Graph, mode: str, hoisted=None):
        self.g, self.mode = g, mode
        self.hoisted = set() if hoisted is None else hoisted
        self.made: set = set()  # prep: the hoisted nodes already in r
        self.lines: List[str] = []
        self.scopes: List[dict] = [{}]
        self.trips: List[int] = [1]  # the open scopes' trip counts
        self.opened: List[int] = []  # the open scopes' first lines
        self.wholes: dict = {}       # whole()'s arrays, by key
        self._if_at: dict = {}       # the last if's line, by depth
        self.depth = 2
        self.work = 0

    def line(self, s: str):
        self.lines.append("  " * self.depth + s)

    def op(self, s: str):
        """A statement that computes: counted in ``work``."""
        self.line(s)
        self.work += math.prod(self.trips)

    def tmp(self, T: str, expr: str) -> str:
        name = self.g.fresh("t")
        self.op(f"const {T} {name} = {expr};")
        return name

    def open(self, head: str, trips: int = 1):
        # an else's scope opens where its if's did (whole() emits before)
        if head.startswith("else"):
            self.opened.append(self._if_at[self.depth])
        else:
            self.opened.append(len(self.lines))
            if head.startswith("if"):
                self._if_at[self.depth] = len(self.lines)
        self.line(head + " {")
        self.depth += 1
        self.scopes.append({})
        self.trips.append(trips)

    def close(self, tail: str = "}"):
        self.scopes.pop()
        self.trips.pop()
        self.opened.pop()
        self.depth -= 1
        self.line(tail)

    def loop_range(self, lo, hi, trips: int, down: bool = False) -> str:
        """A loop over lo..hi-1 (index expressions), or hi-1 down to lo."""
        k = self.g.fresh("k")
        head = f"for (int {k} = {hi}; {k}-- > {lo};)" if down else \
            f"for (int {k} = {lo}; {k} < {hi}; ++{k})"
        self.open(head, trips)
        return k

    def loop(self, size: int, end=None) -> str:
        """A loop over 0..size-1, or over 0..end-1 for an ``end`` at most
        ``size`` (counted in ``work`` as ``size`` trips)."""
        k = self.g.fresh("k")
        self.open(f"for (int {k} = 0; {k} < {size if end is None else end}; "
                  f"++{k})", size)
        return k

    def select(self, T: str, cond: str, inside, outside: str) -> str:
        """``cond ? inside() : outside``, with ``inside()``'s statements
        run only under ``cond`` (it may read an index that is valid only
        there)."""
        out = self.g.fresh("c")
        self.line(f"{T} {out};")
        self.open(f"if ({cond})")
        self.line(f"{out} = {inside()};")
        self.close()
        self.open("else")
        self.line(f"{out} = {outside};")
        self.close()
        return out

    # the value of element ``idx`` of ``node``, as type ``T``
    def val(self, node, idx, T: Optional[str] = None) -> str:
        if not isinstance(node, torch.fx.Node):  # a Python scalar
            return _literal(node, T or self.g.S)
        idx = tuple(idx)
        key = (node, idx)
        expr = next((s[key] for s in reversed(self.scopes) if key in s),
                    None)
        if expr is None:
            expr = self._value(node, idx)
            self.scopes[-1][key] = expr
        return expr if T is None else _cast(expr, self.g.ctype[node], T)

    def _value(self, node, idx) -> str:
        g = self.g
        T = g.ctype[node]
        if node is g.x or node is g.u:
            return f"{'x' if node is g.x else 'u'}[{idx[0]}]"
        if node.op == "get_attr":
            read = f"p[{g.param_index[node.target]}]" \
                   f"[{_flat(idx, g.shape[node])}]"
            return _cast(read, g.S, T)
        if node in g.consts:   # an integer constant read as a value
            values = g.consts[node].reshape(-1).tolist()
            flat = _flat(idx, g.shape[node])
            if isinstance(flat, int):
                return _literal(values[flat], T)
            return self._lookup(values, flat, T)
        anywhere = not _uses_row(idx) or g.read_whole(node)
        if self.mode == "scan" and anywhere and g.hoistable(node):
            self.hoisted.add(node)
            return _literal(0, T)
        if self.mode == "row" and node in self.hoisted and anywhere:
            return f"pre.{g.hoist_name(node)}[{_flat(idx, g.shape[node])}]"
        if self.mode == "prep" and node in self.made:
            return f"r.{g.hoist_name(node)}[{_flat(idx, g.shape[node])}]"
        t = node.target
        if t in _VIEWS:
            return self._view(node, idx)
        if g.read_whole(node):
            return self._whole_element(node, idx)
        if t is operator.getitem:
            return self._getitem(node, idx)
        if t in _TRIANGLES:
            return self._triangle(node, idx)
        if t in _INDEX_MAPS:
            return self._index_map(node, idx)
        if t in _LITERALS:
            return self._literal_node(node, idx)
        if t in _REDUCE:
            return self._reduce(node, idx)
        if t in _NORMS:
            return self._norm(node, idx)
        if t in _SCANS:
            return self._scan(node, idx)
        if t in _MOMENTS:
            return self._moments(node, idx)
        if t is aten.trace.default:  # the diagonal's sum, in order
            src = node.args[0]
            # min(rows, cols) terms, as torch.trace: loop the shorter dim
            d = 0 if g.shape[src][0] <= g.shape[src][1] else 1
            return self.fold(src, [None, None], [d], T, _literal(0, T),
                             "{a} = {a} + {v};", tie={1 - d: d})
        if t is aten._cdist_forward.default:
            return self._cdist(node, idx)
        if t in _MATMUL:
            return self._matmul(node, idx)
        if t in (aten.cat.default, aten.stack.default):
            return self._concat(node, idx)
        if t is aten.linalg_cross.default:
            return self._cross(node, idx)
        if t in _ARG_EXTREME:
            src, r = node.args[0], len(g.shape[node.args[0]])
            dim = _opt(node, 1, "dim", None)
            dims = list(range(r)) if dim is None else [dim % max(r, 1)]
            sub = self._reduced(idx, r, dims, bool(_opt(node, 2, "keepdim",
                                                        False)))
            return self._arg_extreme(src, sub, dims if r else [],
                                     _ARG_EXTREME[t])
        if t in _SEARCH:   # int32 for ``out_int32``
            return _cast(self._search(node, idx), "int64_t", T)
        if t in _GATHER:
            return self._gather(node, idx)
        return self.tmp(T, self._elementwise(node, idx))

    def arg(self, a, idx, out_shape, T: str) -> str:
        """Operand ``a`` of an elementwise node at the node's ``idx``,
        broadcast and cast to ``T``."""
        if not isinstance(a, torch.fx.Node):
            return _literal(a, T)
        shape = self.g.shape[a]
        lead = len(out_shape) - len(shape)
        sub = tuple(0 if s == 1 else idx[lead + d]
                    for d, s in enumerate(shape))
        return self.val(a, sub, T)

    def _elementwise(self, node, idx) -> str:
        g, t, args = self.g, node.target, node.args
        T, shape = g.ctype[node], g.shape[node]
        A = lambda a, ty=T: self.arg(a, idx, shape, ty)  # noqa: E731
        if t in _DIVIDE:
            return self._divide(node, A)
        if T in _INTS and (t in _ADD or t in _REMAINDER or t in (
                aten.neg.default, aten.abs.default, aten.mul.Tensor,
                aten.mul.Scalar, aten.rsub.Scalar, aten.fmod.Tensor,
                aten.fmod.Scalar, aten.floor.default, aten.ceil.default,
                aten.round.default, aten.trunc.default)):
            return self._integer_arithmetic(node, A)
        if t in _UNARY:
            return _UNARY[t](T, A(args[0]))
        if t in _PREDICATES:
            return _PREDICATES[t](g.ctype[args[0]],
                                  A(args[0], g.ctype[args[0]]))
        if t in _BINARY:
            return _BINARY[t](T, A(args[0]), A(args[1]))
        if t in _REMAINDER:
            a, b = A(args[0]), A(args[1])
            r = self.tmp(T, f"{_f('fmod', T)}({a}, {b})")
            return (f"({r} != {T}(0) && (({b} < {T}(0)) != ({r} < {T}(0))) "
                    f"? {r} + {b} : {r})")
        if t in _OPTIONS:
            return self._options(node, A)
        if t in _ADD:
            alpha = node.kwargs.get("alpha", args[2] if len(args) > 2 else 1)
            b = A(args[1])
            if alpha != 1:
                b = f"({_literal(alpha, T)} * {b})"
            return f"({A(args[0])} {'+' if _ADD[t] > 0 else '-'} {b})"
        if t is aten.rsub.Scalar:
            alpha = node.kwargs.get("alpha", args[2] if len(args) > 2 else 1)
            a = A(args[0])
            if alpha != 1:
                a = f"({_literal(alpha, T)} * {a})"
            return f"({A(args[1])} - {a})"
        if t in _COMPARE:
            C = _CTYPES[torch.result_type(*(
                a.meta["val"] if isinstance(a, torch.fx.Node) else a
                for a in args[:2]))]
            return f"({A(args[0], C)} {_COMPARE[t]} {A(args[1], C)})"
        if t is aten.pow.Tensor_Scalar:
            return self._pow(A(args[0]), args[1], T)
        if t in _CLAMP:
            v = self.tmp(T, A(args[0]))
            if t is aten.clamp_min.default:
                lo, hi = args[1], None
            elif t is aten.clamp_max.default:
                lo, hi = None, args[1]
            else:
                lo = node.kwargs.get("min", args[1] if len(args) > 1 else None)
                hi = node.kwargs.get("max", args[2] if len(args) > 2 else None)
            # the bound for a value past it, NaN kept (torch.clamp)
            if lo is not None:
                b = A(lo)
                v = self.tmp(T, f"({v} < {b} ? {b} : {v})")
            if hi is not None:
                b = A(hi)
                v = f"({v} > {b} ? {b} : {v})"
            return v
        if t in _WHERE:
            return f"({A(args[0], 'bool')} ? {A(args[1])} : {A(args[2])})"
        if t is aten._to_copy.default:
            return A(args[0])
        raise _refuse(f"{g.name}: aten op {_op_name(t)} (node {node.name})")

    def _options(self, node, A) -> str:
        """The elementwise ops with scalar options, in torch's arithmetic."""
        t, T = node.target, self.g.ctype[node]
        lit = lambda v: _literal(v, T)  # noqa: E731
        if t in (aten.masked_fill.Scalar, aten.masked_fill.Tensor):
            return f"({A(node.args[1], 'bool')} ? {A(node.args[2])} " \
                   f": {A(node.args[0])})"
        a = A(node.args[0])
        if t is aten.nan_to_num.default:
            info = torch.finfo(node.meta["val"].dtype)
            nan, pos, neg = (_opt(node, k, name, None) for k, name in (
                (1, "nan"), (2, "posinf"), (3, "neginf")))
            return (f"({a} != {a} ? {lit(0 if nan is None else nan)} : "
                    f"{a} == {lit(math.inf)} ? "
                    f"{lit(info.max if pos is None else pos)} : "
                    f"{a} == {lit(-math.inf)} ? "
                    f"{lit(info.min if neg is None else neg)} : {a})")
        # round(x, decimals): as torch, through a power of ten
        decimals = _opt(node, 1, "decimals", 0)
        ten = lit(10.0 ** abs(decimals))
        rint = _f("rint", T)
        if decimals < 0:
            return f"({rint}({a} / {ten}) * {ten})"
        return f"({rint}({a} * {ten}) / {ten})"

    def _integer_arithmetic(self, node, A) -> str:
        """Integer add, sub, mul, neg, abs, remainder and fmod as torch
        computes them: wrapping, a remainder with the divisor's sign (fmod's
        with the dividend's), 0 for a remainder by 0, which raises in torch;
        floor, ceil, round and trunc keep an integer."""
        t, args, T = node.target, node.args, self.g.ctype[node]
        zero = _literal(0, T)
        if t in (aten.floor.default, aten.ceil.default, aten.round.default,
                 aten.trunc.default):
            return A(args[0])
        if t is aten.neg.default:
            return _wrap(T, zero, "-", A(args[0]))
        if t is aten.abs.default:
            a = self.tmp(T, A(args[0]))
            return f"({a} < {zero} ? {_wrap(T, zero, '-', a)} : {a})"
        if t in (aten.mul.Tensor, aten.mul.Scalar):
            return _wrap(T, A(args[0]), "*", A(args[1]))
        if t in _ADD or t is aten.rsub.Scalar:
            alpha = node.kwargs.get("alpha", args[2] if len(args) > 2 else 1)
            a, b = A(args[0]), A(args[1])
            if t is aten.rsub.Scalar:
                a, b = b, a
            if alpha != 1:
                b = _wrap(T, _literal(alpha, T), "*", b)
            return _wrap(T, a, "+" if _ADD.get(t, -1) > 0 else "-", b)
        a, b = self.tmp(T, A(args[0])), self.tmp(T, A(args[1]))
        r = self.tmp(T, f"({b} == {zero} || {b} == {_literal(-1, T)} ? "
                        f"{zero} : {a} % {b})")
        if t in _REMAINDER:
            return (f"({r} != {zero} && (({r} < {zero}) != ({b} < {zero})) "
                    f"? {r} + {b} : {r})")
        return r

    def _divide(self, node, A) -> str:
        """``floor_divide`` and ``div`` with ``rounding_mode``, as torch's
        ``div_floor_integer``/``div_floor_floating`` and truncations: an
        integer quotient by 0 is 0 (torch's kernels' value; its CPU
        raises), a float one IEEE's."""
        t, args, T = node.target, node.args, self.g.ctype[node]
        if t in (aten.floor_divide.default, aten.floor_divide.Scalar):
            mode = "floor"
        else:
            mode = node.kwargs.get("rounding_mode")
        a, b = self.tmp(T, A(args[0])), self.tmp(T, A(args[1]))
        if mode is None:
            return f"({a} / {b})"
        zero = _literal(0, T)
        if T in _INTS:
            q = self.tmp(T, f"({b} == {zero} ? {zero} : {b} == "
                            f"{_literal(-1, T)} ? {_wrap(T, zero, '-', a)} "
                            f": {a} / {b})")
            if mode == "trunc":
                return q
            return (f"({b} != {zero} && {b} != {_literal(-1, T)} && {a} % "
                    f"{b} != {zero} && (({a} < {zero}) != ({b} < {zero})) ? "
                    f"{q} - 1 : {q})")
        if mode == "trunc":
            return f"{_f('trunc', T)}({a} / {b})"
        mod = self.tmp(T, f"{_f('fmod', T)}({a}, {b})")
        div = self.tmp(T, f"({a} - {mod}) / {b}")
        div = self.tmp(T, f"({mod} != {zero} && (({b} < {zero}) != ({mod} < "
                          f"{zero})) ? {div} - {T}(1) : {div})")
        low = self.tmp(T, f"{_f('floor', T)}({div})")
        return (f"({b} == {zero} ? {a} / {b} : {div} != {zero} ? ({div} - "
                f"{low} > {T}(0.5) ? {low} + {T}(1) : {low}) : "
                f"{_f('copysign', T)}({zero}, {a} / {b}))")

    @staticmethod
    def _pow(a: str, e, T: str) -> str:
        """``a ** e`` for a Python scalar ``e``: products and roots where
        torch's pow kernel takes them."""
        if e == 2:
            return f"({a} * {a})"
        if e == 3:
            return f"({a} * {a} * {a})"
        if e == 1:
            return a
        if e == 0:
            return _literal(1, T)
        if e == 0.5:
            return f"{_f('sqrt', T)}({a})"
        if e == -0.5:
            return f"({T}(1) / {_f('sqrt', T)}({a}))"
        if e == -1:
            return f"({T}(1) / {a})"
        if e == -2:
            return f"({T}(1) / ({a} * {a}))"
        return f"{_f('pow', T)}({a}, {_literal(e, T)})"

    def _literal_node(self, node, idx) -> str:
        t, args, T = node.target, node.args, self.g.ctype[node]
        if t in (aten.zeros_like.default, aten.zeros.default,
                 aten.new_zeros.default):
            return _literal(0, T)
        if t in (aten.ones_like.default, aten.ones.default,
                 aten.new_ones.default):
            return _literal(1, T)
        if t is aten.eye.default:
            return self.tmp(T, f"({idx[0]} == {idx[1]} ? {_literal(1, T)} "
                               f": {_literal(0, T)})")
        if t is aten.scalar_tensor.default:
            return _literal(args[0], T)
        return _literal(args[1] if t is aten.full.default
                        or t is aten.full_like.default else args[2], T)

    def _view(self, node, idx) -> str:
        g, t, args = self.g, node.target, node.args
        src = args[0]
        shape, ishape = g.shape[node], g.shape[src]
        r = len(ishape)
        if t in (aten.clone.default, aten.alias.default, aten.detach.default,
                 aten.lift_fresh_copy.default):
            return self.val(src, idx)
        if t in (aten.unsqueeze.default, aten.unsqueeze_.default):
            d = args[1] % len(shape)
            return self.val(src, idx[:d] + idx[d + 1:])
        if t in (aten.squeeze.dim, aten.squeeze_.dim, aten.squeeze.dims,
                 aten.squeeze.default):
            dims = (range(r) if t is aten.squeeze.default
                    else [args[1]] if isinstance(args[1], int) else args[1])
            gone = {d % r for d in dims if ishape[d % r] == 1} if r else set()
            it = iter(idx)
            return self.val(src, tuple(0 if d in gone else next(it)
                                       for d in range(r)))
        if t is aten.permute.default:
            sub = [0] * r
            for j, d in enumerate(args[1]):
                sub[d % r] = idx[j]
            return self.val(src, sub)
        if t is aten.t.default:
            return self.val(src, idx[::-1])
        if t is aten.transpose.int:
            sub = list(idx)
            a, b = args[1] % r, args[2] % r
            sub[a], sub[b] = idx[b], idx[a]
            return self.val(src, sub)
        if t is aten.expand.default:
            lead = len(shape) - r
            return self.val(src, tuple(0 if s == 1 else idx[lead + d]
                                       for d, s in enumerate(ishape)))
        if t is aten.select.int:
            d = args[1] % r
            return self.val(src, idx[:d] + (args[2] % ishape[d],) + idx[d:])
        if t is aten.slice.Tensor:
            d = args[1] % r if len(args) > 1 else 0
            start = args[2] if len(args) > 2 and args[2] is not None else 0
            step = args[4] if len(args) > 4 else 1
            start = min(max(start + ishape[d] if start < 0 else start, 0),
                        ishape[d])
            sub = list(idx)
            sub[d] = _iadd(start, _imul(idx[d], step))
            return self.val(src, sub)
        # view / reshape: through the row-major offset
        if [s for s in shape if s != 1] == [s for s in ishape if s != 1]:
            it = iter(ix for ix, s in zip(idx, shape) if s != 1)
            return self.val(src, tuple(0 if s == 1 else next(it)
                                       for s in ishape))
        return self.val(src, self._unflat(_flat(idx, shape), ishape))

    def fold(self, src, sub, dims, T: str, init: str, step: str,
             end=None, tie=None) -> str:
        """An accumulator over ``src[sub]`` with ``sub[d]`` looped for each
        d in ``dims``, in index order: ``step`` (a format of the
        accumulator ``{a}`` and the element ``{v}``) from ``init``; ``src``
        is a node or ``_Elems``, elements computed at the index. ``end``
        bounds the one loop at an index expression; ``tie`` reads dim e at
        dim d's loop index (``{e: d}``, a diagonal)."""
        computed = isinstance(src, _Elems)
        shape = src.shape if computed else self.g.shape[src]
        acc = self.g.fresh("r")
        self.line(f"{T} {acc} = {init};")
        sub = list(sub)
        for d in dims:
            sub[d] = self.loop(shape[d], end)
        for e, d in (tie or {}).items():
            sub[e] = sub[d]
        v = src.at(sub) if computed else self.val(src, sub, T)
        self.op(step.format(a=acc, v=v))
        for _ in dims:
            self.close()
        return acc

    @staticmethod
    def _reduced(idx, r: int, dims, keep: bool) -> list:
        """The input index of an output ``idx`` of a reduction over
        ``dims``: None at the reduced dims."""
        it = iter(idx)
        sub: list = []
        for d in range(r):
            if d in dims:
                sub.append(None)
                if keep:
                    next(it)
            else:
                sub.append(next(it))
        return sub

    @staticmethod
    def _max_step(larger: bool, f=lambda v: v) -> str:
        """A max (or min) step of ``f(v)`` that keeps a NaN, as torch."""
        v = f("{v}")
        return (f"{{a}} = ({v} != {v} || {v} {'>' if larger else '<'} {{a}})"
                f" ? {v} : {{a}};")

    def _reduce(self, node, idx) -> str:
        g, t, args = self.g, node.target, node.args
        src = args[0]
        ishape, T = g.shape[src], g.ctype[node]
        r = len(ishape)
        if t in (aten.sum.default, aten.mean.default, aten.prod.default,
                 aten.max.default, aten.min.default) or len(args) < 2:
            dims, keep = list(range(r)), False
        else:
            dims = _dims(args[1], r)
            keep = bool(_opt(node, 2, "keepdim", False))
        sub = self._reduced(idx, r, dims, keep)
        if t in (aten.prod.dim_int, aten.prod.default):
            init, step = _literal(1, T), "{a} = {a} * {v};"
        elif t in (aten.amax.default, aten.max.default):
            init, step = _literal(-math.inf, T), self._max_step(True)
        elif t in (aten.amin.default, aten.min.default):
            init, step = _literal(math.inf, T), self._max_step(False)
        else:
            init, step = _literal(0, T), "{a} = {a} + {v};"
        acc = self.fold(src, sub, dims, T, init, step)
        if t in (aten.mean.dim, aten.mean.default):
            count = math.prod(ishape[d] for d in dims)
            return self.tmp(T, f"({acc} / {_literal(count, T)})")
        return acc

    def _pnorm(self, src, sub, dims, T: str, p: float) -> str:
        """The ``p``-norm of ``src`` over ``dims`` as torch's norm kernels
        compute it: sqrt of the sum of squares at 2, the sum of |v| at 1,
        the count of nonzeros at 0, the largest (smallest) |v| at +inf
        (-inf), else (sum |v|^p)^(1/p)."""
        fabs = lambda v: f"{_f('fabs', T)}({v})"  # noqa: E731
        if p == 2:
            acc = self.fold(src, sub, dims, T, _literal(0, T),
                            "{a} = {a} + {v} * {v};")
            return self.tmp(T, f"{_f('sqrt', T)}({acc})")
        if p == 1:
            return self.fold(src, sub, dims, T, _literal(0, T),
                             f"{{a}} = {{a}} + {fabs('{v}')};")
        if p == 0:
            return self.fold(src, sub, dims, T, _literal(0, T),
                             f"{{a}} = {{a}} + ({{v}} != {T}(0) ? {T}(1) "
                             f": {T}(0));")
        if math.isinf(p):
            return self.fold(src, sub, dims, T, _literal(max(-p, 0), T),
                             self._max_step(p > 0, fabs))
        acc = self.fold(src, sub, dims, T, _literal(0, T),
                        f"{{a}} = {{a}} + {_f('pow', T)}({fabs('{v}')}, "
                        f"{_literal(p, T)});")
        return self.tmp(T, f"{_f('pow', T)}({acc}, {_literal(1.0 / p, T)})")

    def _norm(self, node, idx) -> str:
        """``linalg_vector_norm(x, ord, dim, keepdim)``."""
        src, T = node.args[0], self.g.ctype[node]
        r = len(self.g.shape[src])
        dims = _dims(_opt(node, 2, "dim", None), r)
        sub = self._reduced(idx, r, dims, bool(_opt(node, 3, "keepdim",
                                                    False)))
        return self._pnorm(src, sub, dims, T, float(_opt(node, 1, "ord", 2)))

    def _moments(self, node, idx) -> str:
        """``var``/``std`` over dims: the squared deviations from the mean
        summed in order (two passes), over N - correction."""
        src, T = node.args[0], self.g.ctype[node]
        ishape = self.g.shape[src]
        dims = _dims(_opt(node, 1, "dim", None), len(ishape))
        sub = self._reduced(idx, len(ishape), dims,
                            bool(node.kwargs.get("keepdim", False)))
        count = math.prod(ishape[d] for d in dims)
        correction = node.kwargs.get("correction")
        correction = 1 if correction is None else correction
        total = self.fold(src, sub, dims, T, _literal(0, T),
                          "{a} = {a} + {v};")
        mean = self.tmp(T, f"({total} / {_literal(count, T)})")
        acc = self.fold(src, sub, dims, T, _literal(0, T),
                        f"{{a}} = {{a}} + ({{v}} - {mean}) * ({{v}} - "
                        f"{mean});")
        var = self.tmp(T, f"({acc} / {_literal(count - correction, T)})")
        if node.target is aten.std.correction:
            return self.tmp(T, f"{_f('sqrt', T)}({var})")
        return var

    def _scan(self, node, idx) -> str:
        """``cumsum``/``cumprod``: element j along the dim folds 0..j in
        order."""
        src, T = node.args[0], self.g.ctype[node]
        d = node.args[1] % len(self.g.shape[src])
        sub = list(idx)
        sub[d] = None
        op = _SCANS[node.target]
        return self.fold(src, sub, [d], T, _literal(1 if op == "*" else 0, T),
                         f"{{a}} = {{a}} {op} {{v}};", end=_iadd(idx[d], 1))

    def _cdist(self, node, idx) -> str:
        """``_cdist_forward(x1 [..., P, M], x2 [..., R, M], p)``: the p-norm
        of each row difference, the batch dims broadcast."""
        g = self.g
        a, b, p = node.args[0], node.args[1], float(node.args[2])
        T = g.ctype[node]
        batch = idx[:-2]

        def rows(x, i, k):
            shape = g.shape[x][:-2]
            lead = len(batch) - len(shape)
            return tuple(0 if s == 1 else batch[lead + d]
                         for d, s in enumerate(shape)) + (i, k)

        diff = _Elems((g.shape[a][-1],), lambda sub: self.tmp(
            T, f"({self.val(a, rows(a, idx[-2], sub[0]), T)} - "
               f"{self.val(b, rows(b, idx[-1], sub[0]), T)})"))
        return self._pnorm(diff, [None], [0], T, p)

    def _matmul(self, node, idx) -> str:
        g, t, args = self.g, node.target, node.args
        T = g.ctype[node]
        bias = None
        if t in (aten.addmm.default, aten.addmv.default):
            bias, args = args[0], args[1:]
        a, b = args[0], args[1]
        K = g.shape[a][-1]
        acc = g.fresh("r")
        self.line(f"{T} {acc} = {_literal(0, T)};")
        k = self.loop(K)
        if t is aten.bmm.default:  # a batch of matrix products
            ia, ib = (idx[0], idx[1], k), (idx[0], k, idx[2])
        else:
            ia = (idx[0], k) if len(g.shape[a]) == 2 else (k,)
            ib = (k, idx[-1]) if len(g.shape[b]) == 2 else (k,)
        self.op(f"{acc} = {acc} + {self.val(a, ia, T)} * "
                  f"{self.val(b, ib, T)};")
        self.close()
        if bias is None:
            return acc
        beta = node.kwargs.get("beta", 1)
        alpha = node.kwargs.get("alpha", 1)
        bv = self.arg(bias, idx, g.shape[node], T)
        if beta != 1:
            bv = f"({_literal(beta, T)} * {bv})"
        mv = acc if alpha == 1 else f"({_literal(alpha, T)} * {acc})"
        return self.tmp(T, f"({bv} + {mv})")

    def _unflat(self, off, shape) -> list:
        """The index in ``shape`` of the row-major offset ``off``."""
        if not isinstance(off, int):
            off = self.tmp("int", off)
        sub, stride = [], math.prod(shape)
        for s in shape:
            stride //= s
            sub.append(_imod(_idiv(off, stride), s))
        return sub

    def _lookup(self, values: list, flat, T: str = "int"):
        """``values[flat]`` for an index known when the source is emitted
        or computed at run time: an affine expression where the values are
        one (integer indices), else a chain of conditionals of literals of
        type ``T``."""
        if isinstance(flat, int):
            return values[flat] if T == "int" else _literal(values[flat], T)
        step = values[1] - values[0] if len(values) > 1 else 0
        if T == "int" and all(v == values[0] + k * step
                              for k, v in enumerate(values)):
            return _iadd(values[0], _imul(flat, step))
        f = self.tmp("int", flat)
        lit = (lambda v: str(v)) if T == "int" else (  # noqa: E731
            lambda v: _literal(v, T))
        chain = lit(values[-1])
        for k in range(len(values) - 2, -1, -1):
            chain = f"({f} == {k} ? {lit(values[k])} : {chain})"
        return self.tmp(T, chain)

    def _index_at(self, index, sub, size: int):
        """Element ``sub`` of the integer node ``index``, an index into a
        dim of ``size``: negative values wrap, and values still outside
        0..size-1 are clamped into it, as JAX's ``x[i]`` (torch raises;
        a kernel cannot). Constant indices are checked here instead."""
        g = self.g
        if index in g.consts:
            values = g.consts[index].reshape(-1).tolist()
            if any(not -size <= v < size for v in values):
                raise _refuse(f"{g.name}: node {index.name} indexes a dim "
                              f"of size {size} at {values}")
            return self._lookup([v % size for v in values],
                                _flat(sub, g.shape[index]))
        v = self.tmp("int64_t", self.val(index, sub, "int64_t"))
        w = self.tmp("int64_t", f"({v} < 0 ? {v} + {size} : {v})")
        return self.tmp("int", f"({w} < 0 ? 0 : {w} > {size - 1} ? "
                               f"{size - 1} : static_cast<int>({w}))")

    def _arg_extreme(self, src, sub, dims, larger: bool) -> str:
        """The index of the first largest (smallest) element of ``src``
        over ``dims`` at ``sub`` (row-major over those dims, as torch's
        ``argmax`` flattens), a NaN the extreme (the first one), as
        torch's ``argmax``/``argmin`` and max/min's indices."""
        g = self.g
        T, shape = g.ctype[src], g.shape[src]
        best, at = g.fresh("m"), g.fresh("j")
        self.line(f"{T} {best} = "
                  f"{_literal(-math.inf if larger else math.inf, T)};")
        self.line(f"int64_t {at} = 0;")
        sub = list(sub)
        for d in dims:
            sub[d] = self.loop(shape[d])
        flat = _flat([sub[d] for d in dims], [shape[d] for d in dims])
        v = self.val(src, sub)
        self.op(f"if (!({best} != {best}) && ({v} != {v} || {v} "
                f"{'>' if larger else '<'} {best})) {{ {best} = {v}; "
                f"{at} = {flat}; }}")
        for _ in dims:
            self.close()
        return at

    def _search(self, node, idx) -> str:
        """``bucketize(v, boundaries, right)`` and ``searchsorted(seq, v,
        right or side)`` (1-D sequences, or one a row of v's leading dims):
        torch's binary search, the count of the sorted values below v (not
        above v with ``right``), NaN past them all."""
        g = self.g
        if node.target is aten.bucketize.Tensor:
            v, seq = node.args[0], node.args[1]
            row = ()
        else:
            seq, v = node.args[0], node.args[1]
            if node.kwargs.get("sorter") is not None:
                raise _refuse(f"{g.name}: aten::searchsorted (node "
                              f"{node.name}) with a sorter")
            row = tuple(idx[:-1]) if len(g.shape[seq]) > 1 else ()
        right = bool(node.kwargs.get("right", False)) \
            or node.kwargs.get("side") == "right"
        C = _CTYPES[torch.promote_types(v.meta["val"].dtype,
                                        seq.meta["val"].dtype)]
        x = self.tmp(C, self.val(v, idx, C))
        L = g.shape[seq][-1]
        lo, hi = g.fresh("lo"), g.fresh("hi")
        self.line(f"int64_t {lo} = 0, {hi} = {L};")
        self.open(f"while ({lo} < {hi})", max(1, math.ceil(math.log2(L + 1))))
        mid = self.tmp("int64_t", f"{lo} + (({hi} - {lo}) >> 1)")
        b = self.val(seq, row + (mid,), C)
        self.op(f"if (!({b} {'>' if right else '>='} {x})) {lo} = {mid} + 1;"
                f" else {hi} = {mid};")
        self.close()
        return lo

    def _gather(self, node, idx) -> str:
        """``gather(src, dim, index)``: the source at the index's element
        along dim; ``index_select(src, dim, index)``: at the index's
        element of idx[dim] (what ``take_along_dim`` decomposes into)."""
        g = self.g
        src, d, index = node.args[0], node.args[1], node.args[2]
        r = len(g.shape[src])
        if r == 0:
            return self.val(src, ())
        d %= r
        at = tuple(idx) if node.target is aten.gather.default else \
            ((idx[d],) if len(g.shape[index]) else ())
        sub = list(idx)
        sub[d] = self._index_at(index, at, g.shape[src][d])
        return self.val(src, sub)

    def _getitem(self, node, idx) -> str:
        """An output of a node with several: a split's part, an unbound
        slice, or the values or indices of max/min over a dim."""
        g = self.g
        parent, k = node.args
        t, src = parent.target, parent.args[0]
        T, ishape = g.ctype[node], g.shape[src]
        r = len(ishape)
        if t is aten.unbind.int:
            d = _opt(parent, 1, "dim", 0) % r
            return self.val(src, idx[:d] + (k,) + idx[d:])
        if t in (aten.split_with_sizes.default, aten.split.Tensor):
            d = _opt(parent, 2, "dim", 0) % r
            size = parent.args[1]
            off = sum(size[:k]) if t is aten.split_with_sizes.default \
                else k * size
            sub = list(idx)
            sub[d] = _iadd(idx[d], off)
            return self.val(src, sub)
        d = parent.args[1] % max(r, 1)
        sub = self._reduced(idx, r, [d], bool(_opt(parent, 2, "keepdim",
                                                   False)))
        larger = t is aten.max.dim
        if k == 1:
            return self._arg_extreme(src, sub, [d] if r else [], larger)
        return self.fold(src, sub, [d] if r else [], T,
                         _literal(-math.inf if larger else math.inf, T),
                         self._max_step(larger))

    def _index_map(self, node, idx) -> str:
        """Pads, flips, rolls, repeats, diagonals and constant indexing:
        the input's element at a mapped index (or a literal outside it)."""
        g, t, args = self.g, node.target, node.args
        src = args[0]
        T, shape, ishape = g.ctype[node], g.shape[node], g.shape[src]
        r = len(ishape)
        if t is aten.index.Tensor:
            return self._index(node, idx)
        if t is aten.flip.default:
            sub = list(idx)
            for d in {d % r for d in args[1]}:
                sub[d] = _iadd(ishape[d] - 1, _imul(idx[d], -1))
            return self.val(src, sub)
        if t is aten.roll.default:
            shifts = list(args[1])
            dims = list(_opt(node, 2, "dims", []))
            if not dims:  # the flattened tensor, rolled
                size = math.prod(ishape)
                off = _imod(_iadd(_flat(idx, ishape), -shifts[0] % size),
                            size)
                return self.val(src, self._unflat(off, ishape))
            sub = list(idx)
            for s, d in zip(shifts, dims):
                d %= r
                sub[d] = _imod(_iadd(sub[d], -s % ishape[d]), ishape[d])
            return self.val(src, sub)
        if t is aten.repeat.default:
            lead = len(shape) - r
            return self.val(src, tuple(_imod(idx[lead + d], s)
                                       for d, s in enumerate(ishape)))
        if t is aten.diagonal.default:
            off = _opt(node, 1, "offset", 0)
            d1 = _opt(node, 2, "dim1", 0) % r
            d2 = _opt(node, 3, "dim2", 1) % r
            sub = [None] * r
            for d, ix in zip([d for d in range(r) if d not in (d1, d2)],
                             idx[:-1]):
                sub[d] = ix
            sub[d1] = _iadd(idx[-1], max(-off, 0))
            sub[d2] = _iadd(idx[-1], max(off, 0))
            return self.val(src, sub)
        if t is aten.diag_embed.default:
            off = _opt(node, 1, "offset", 0)
            R = len(shape)
            d1 = _opt(node, 2, "dim1", -2) % R
            d2 = _opt(node, 3, "dim2", -1) % R
            a, b = idx[d1], idx[d2]
            sub = tuple(idx[d] for d in range(R) if d not in (d1, d2)) \
                + ((a if off >= 0 else b),)
            if isinstance(a, int) and isinstance(b, int):
                return self.val(src, sub) if b - a == off \
                    else _literal(0, T)
            return self.select(T, f"{_iadd(b, _imul(a, -1))} == {off}",
                               lambda: self.val(src, sub, T),
                               _literal(0, T))
        # constant_pad_nd: pads (or crops) from the last dim back
        pad, value = list(args[1]), _opt(node, 2, "value", 0)
        sub, conds = list(idx), []
        for k in range(len(pad) // 2):
            d = r - 1 - k
            before, after = pad[2 * k], pad[2 * k + 1]
            sub[d] = j = _iadd(idx[d], -before)
            if isinstance(j, int):
                if not 0 <= j < ishape[d]:
                    return _literal(value, T)
                continue
            if before > 0:
                conds.append(f"{j} >= 0")
            if after > 0:
                conds.append(f"{j} < {ishape[d]}")
        if not conds:
            return self.val(src, sub)
        return self.select(T, " && ".join(conds),
                           lambda: self.val(src, sub, T), _literal(value, T))

    def _index(self, node, idx) -> str:
        """``index.Tensor(x, indices)`` (None for a dim taken whole),
        torch's advanced indexing: the indices broadcast together; their
        dims replace the indexed ones where those are adjacent, else lead.
        An index tensor is a constant (its values literals) or computed at
        run time (``_index_at``)."""
        g = self.g
        src, indices = node.args[0], list(node.args[1])
        ishape = g.shape[src]
        r = len(ishape)
        pos = [d for d, ix in enumerate(indices) if ix is not None]
        bshape = tuple(torch.broadcast_shapes(*(g.shape[indices[d]]
                                                for d in pos)))
        nb = len(bshape)
        if pos == list(range(pos[0], pos[-1] + 1)):
            bidx = idx[pos[0]:pos[0] + nb]
            other = list(idx[:pos[0]]) + list(idx[pos[0] + nb:])
        else:
            bidx, other = idx[:nb], list(idx[nb:])
        sub = [None] * r
        for d, ix in zip([d for d in range(r) if d not in pos], other):
            sub[d] = ix
        for d in pos:
            shape = g.shape[indices[d]]
            lead = nb - len(shape)
            at = tuple(0 if s == 1 else bidx[lead + j]
                       for j, s in enumerate(shape))
            sub[d] = self._index_at(indices[d], at, ishape[d])
        return self.val(src, sub)

    def _cross(self, node, idx) -> str:
        """``linalg_cross(a, b, dim)``: element k is a_{k+1} b_{k+2} -
        a_{k+2} b_{k+1} (indices mod 3), the operands broadcast."""
        a, b = node.args[0], node.args[1]
        T, shape = self.g.ctype[node], self.g.shape[node]
        d = _opt(node, 2, "dim", -1) % len(shape)

        def at(x, c):
            ix = list(idx)
            ix[d] = c
            return self.arg(x, ix, shape, T)

        c1, c2 = (_imod(_iadd(idx[d], s), 3) for s in (1, 2))
        return self.tmp(T, f"({at(a, c1)} * {at(b, c2)} - "
                           f"{at(a, c2)} * {at(b, c1)})")

    def _concat(self, node, idx) -> str:
        g, args = self.g, node.args
        parts = list(args[0])
        T, shape = g.ctype[node], g.shape[node]
        d = (args[1] if len(args) > 1 else node.kwargs.get("dim", 0))
        d %= len(shape)
        stack = node.target is aten.stack.default
        sizes = [1 if stack else g.shape[p][d] for p in parts]
        # which part holds index j along d, and j's index inside it
        def sub(j, off):
            if stack:
                return idx[:d] + idx[d + 1:]
            return idx[:d] + (_iadd(j, -off) if off else j,) + idx[d + 1:]
        j = idx[d]
        if isinstance(j, int):
            off = 0
            for p, s in zip(parts, sizes):
                if j < off + s:
                    return self.val(p, sub(j, off), T)
                off += s
        out = g.fresh("c")
        self.line(f"{T} {out};")
        off = 0
        for k, (p, s) in enumerate(zip(parts, sizes)):
            if k == len(parts) - 1:
                self.open("else")
            else:
                self.open(f"{'else ' if k else ''}if ({j} < {off + s})")
            self.line(f"{out} = {self.val(p, sub(j, off), T)};")
            self.close()
            off += s
        return out

    # -- nodes read whole ---------------------------------------------------

    def whole(self, key, into=None) -> tuple:
        """The local arrays that hold the whole of ``key``: a node read
        whole (``_Graph.read_whole``; then ``(array, flat)``, ``flat(k,
        idx)`` the offset of element ``idx`` of output k), or the factor
        ``(kind, A, upper)`` of a matrix node A (``(factor, pivots)``,
        ``_factor``). Emitted once a method, before its outermost open
        scope (they read their operands whole, at indices of their own
        loops), so that a loop or a branch reads them without computing
        them again. ``prep`` holds the factor of a matrix that depends on
        no control, and the rows read it there; ``into`` names the arrays
        to fill (``prep``'s members) instead of local ones."""
        if key in self.wholes:
            return self.wholes[key]
        g = self.g
        if isinstance(key, tuple) and not g.dep_u[key[1]]:
            name = g.hoist_name(key)
            if self.mode == "scan":
                self.hoisted.add(key)
            if self.mode in ("scan", "row") and key in self.hoisted:
                return f"pre.{name}", f"pre.{name}p"
            if self.mode == "prep" and key in self.made:
                return f"r.{name}", f"r.{name}p"
        at = self.opened[0] if self.opened else len(self.lines)
        tail, self.lines = self.lines[at:], self.lines[:at]
        saved = self.scopes, self.trips, self.opened, self.depth, self._if_at
        self.scopes, self.trips, self.opened, self.depth, self._if_at = \
            self.scopes[:1], [1], [], 2, {}
        if isinstance(key, tuple):
            arrays = self._factor(*key, into)
        elif key.target in _LINALG_MULTI or key.target in _LINALG:
            arrays = self._linalg(key)
        else:
            arrays = self._sort(key)
        self.scopes, self.trips, self.opened, self.depth, self._if_at = saved
        shift = len(self.lines) - at
        self.opened = [k + shift for k in self.opened]
        self._if_at = {d: k + shift if k >= at else k
                       for d, k in self._if_at.items()}
        self.lines += tail
        self.wholes[key] = arrays
        return arrays

    def array(self, T: str, size: int) -> str:
        name = self.g.fresh("a")
        self.line(f"{T} {name}[{max(size, 1)}];")
        return name

    def fill(self, node, shape, T: str, at=lambda ks: ks) -> str:
        """A local array of ``node``'s elements over ``shape``, row-major:
        element ``ks`` is ``node``'s at ``at(ks)``."""
        a = self.array(T, math.prod(shape))
        ks = [self.loop(s) for s in shape]
        self.op(f"{a}[{_flat(ks, shape)}] = {self.val(node, at(ks), T)};")
        for _ in shape:
            self.close()
        return a

    def _whole_element(self, node, idx) -> str:
        k = 0
        if node.target is operator.getitem:
            node, k = node.args
        if node.target in (aten.linalg_lu_factor_ex.default,
                           aten.linalg_cholesky_ex.default):
            lu = node.target is aten.linalg_lu_factor_ex.default
            upper = not lu and bool(_opt(node, 1, "upper", False))
            a = self.whole(("lu" if lu else "chol", node.args[0], upper))[0]
            return f"{a}[{_flat(idx[::-1] if upper else idx, self.g.shape[node.args[0]])}]"
        a, flat = self.whole(node)
        if isinstance(a, dict):   # an array an output (a sort's)
            a = a[k]
        return f"{a}[{flat(k, idx)}]"

    def _factor(self, kind, A, upper, into):
        """The factor of A [n, n] in a local array (row-major): ``"lu"``,
        LU with partial pivoting as LAPACK's getf2 (the first largest |a|
        of the column, its row swapped whole, the column below scaled by
        the pivot's reciprocal, not at a zero pivot, so that a singular
        matrix keeps its zero and a solve divides by it), the unit lower
        factor below the diagonal and U on and above it, and the pivots;
        ``"chol"``, the lower Cholesky factor column by column as potf2
        (of A's upper triangle transposed where ``upper``; NaN where A is
        not positive definite), zeros above."""
        g = self.g
        T, n = g.ctype[A], g.shape[A][0]
        fabs = _f("fabs", T)
        if into is None:
            a = self.array(T, n * n)
            p = self.array("int", n) if kind == "lu" else None
        else:
            a, p = into
        E = lambda i, j: f"{a}[{i} * {n} + {j}]"  # noqa: E731
        ks = [self.loop(n), self.loop(n)]
        self.op(f"{E(*ks)} = {self.val(A, ks[::-1] if upper else ks, T)};")
        self.close()
        self.close()
        if kind == "lu":
            k = self.loop(n)
            q, big = g.fresh("q"), g.fresh("m")
            self.op(f"int {q} = {k};")
            self.op(f"{T} {big} = {fabs}({E(k, k)});")
            i = self.loop_range(f"{k} + 1", n, n)
            v = self.tmp(T, f"{fabs}({E(i, k)})")
            self.op(f"if ({v} > {big}) {{ {big} = {v}; {q} = {i}; }}")
            self.close()
            self.op(f"{p}[{k}] = {q};")
            self.open(f"if ({q} != {k})")
            j = self.loop(n)
            held = self.tmp(T, E(k, j))
            self.op(f"{E(k, j)} = {E(q, j)};")
            self.op(f"{E(q, j)} = {held};")
            self.close()
            self.close()
            d = self.tmp(T, E(k, k))
            tiny = _literal(torch.finfo(_DTYPES[T]).tiny, T)
            self.open(f"if ({fabs}({d}) >= {tiny})")
            r = self.tmp(T, f"{T}(1) / {d}")
            i = self.loop_range(f"{k} + 1", n, n)
            self.op(f"{E(i, k)} = {E(i, k)} * {r};")
            self.close()
            self.close()
            self.open(f"else if ({d} != {T}(0))")
            i = self.loop_range(f"{k} + 1", n, n)
            self.op(f"{E(i, k)} = {E(i, k)} / {d};")
            self.close()
            self.close()
            i = self.loop_range(f"{k} + 1", n, n)
            j = self.loop_range(f"{k} + 1", n, n)
            self.op(f"{E(i, j)} = {E(i, j)} - {E(i, k)} * {E(k, j)};")
            self.close()
            self.close()
            self.close()
            return a, p
        j = self.loop(n)
        s = g.fresh("s")
        self.op(f"{T} {s} = {E(j, j)};")
        k = self.loop_range(0, j, n)
        self.op(f"{s} = {s} - {E(j, k)} * {E(j, k)};")
        self.close()
        d = self.tmp(T, f"{_f('sqrt', T)}({s})")
        self.op(f"{E(j, j)} = {d};")
        r = self.tmp(T, f"{T}(1) / {d}")
        i = self.loop_range(f"{j} + 1", n, n)
        s = g.fresh("s")
        self.op(f"{T} {s} = {E(i, j)};")
        k = self.loop_range(0, j, n)
        self.op(f"{s} = {s} - {E(i, k)} * {E(j, k)};")
        self.close()
        self.op(f"{E(i, j)} = {s} * {r};")
        self.close()
        i = self.loop_range(0, j, n)
        self.op(f"{E(i, j)} = {T}(0);")
        self.close()
        self.close()
        return a, None

    def _substitute(self, a, x, n: int, C: int, T: str, lower: bool,
                    unit: bool = False, transposed: bool = False):
        """Solve with the triangle of ``a`` [n, n] in place over each of the
        C columns of ``x`` [n, C]: forward (``lower``, from the first row)
        or back, each row's terms in the order LAPACK's trsm takes them;
        ``transposed`` reads the triangle's transpose; ``unit`` takes its
        diagonal as 1."""
        A = (lambda i, j: f"{a}[{j} * {n} + {i}]") if transposed else \
            (lambda i, j: f"{a}[{i} * {n} + {j}]")
        c = self.loop(C)
        i = self.loop_range(0, n, n, down=not lower)
        s = self.g.fresh("s")
        X = lambda r: f"{x}[{r} * {C} + {c}]"  # noqa: E731
        self.op(f"{T} {s} = {X(i)};")
        j = self.loop_range(0, i, n) if lower else \
            self.loop_range(f"{i} + 1", n, n, down=not transposed)
        self.op(f"{s} = {s} - {A(i, j)} * {X(j)};")
        self.close()
        self.op(f"{X(i)} = {s};" if unit else f"{X(i)} = {s} / {A(i, i)};")
        self.close()
        self.close()

    def _pivot_rows(self, p, x, n: int, C: int, T: str):
        """The LU factor's row swaps, in order, on ``x`` [n, C]."""
        k = self.loop(n)
        q = self.tmp("int", f"{p}[{k}]")
        self.open(f"if ({q} != {k})")
        c = self.loop(C)
        held = self.tmp(T, f"{x}[{k} * {C} + {c}]")
        self.op(f"{x}[{k} * {C} + {c}] = {x}[{q} * {C} + {c}];")
        self.op(f"{x}[{q} * {C} + {c}] = {held};")
        self.close()
        self.close()
        self.close()

    def _linalg(self, node):
        """Solves, inverses, determinants: ``(array, flat)``."""
        g, t, args = self.g, node.target, node.args
        val = node.meta["val"]
        T = _CTYPES[(val[0] if isinstance(val, (list, tuple)) else val).dtype]
        if t in (aten._linalg_det.default, aten._linalg_slogdet.default):
            n = g.shape[args[0]][0]
            a, p = self.whole(("lu", args[0], False))
            swaps = g.fresh("s")
            self.op(f"int {swaps} = 0;")
            k = self.loop(n)
            self.op(f"{swaps} = {swaps} + ({p}[{k}] != {k} ? 1 : 0);")
            self.close()
            sign = f"({swaps} % 2 ? {T}(-1) : {T}(1))"
            out = self.array(T, 2)
            diag = _Elems((n,), lambda sub: f"{a}[{sub[0]} * {n} + {sub[0]}]")
            fold = lambda init, step: self.fold(  # noqa: E731
                diag, [None], [0], T, _literal(init, T), step)
            if t is aten._linalg_det.default:   # sign times prod(diag)
                d = fold(1, "{a} = {a} * {v};")
                self.op(f"{out}[0] = {sign} * {d};")
            else:   # prod(sgn(diag)) times sign; sum(log|diag|)
                d = fold(1, f"{{a}} = {{a}} * "
                            f"{_UNARY[aten.sign.default](T, '{v}')};")
                self.op(f"{out}[0] = {d} * {sign};")
                la = fold(0, f"{{a}} = {{a}} + {_f('log', T)}("
                             f"{_f('fabs', T)}({{v}}));")
                self.op(f"{out}[1] = {la};")
            return out, lambda k, idx: k
        if t in (aten._linalg_solve_ex.default, aten.linalg_inv_ex.default):
            A = args[0]
            n = g.shape[A][0]
            a, p = self.whole(("lu", A, False))
            if t is aten.linalg_inv_ex.default:   # solve(A, I)
                x, C, shape = self.array(T, n * n), n, (n, n)
                ks = [self.loop(n), self.loop(n)]
                self.op(f"{x}[{ks[0]} * {n} + {ks[1]}] = ({ks[0]} == {ks[1]}"
                        f" ? {T}(1) : {T}(0));")
                self.close()
                self.close()
            else:
                shape = g.shape[args[1]]
                C = shape[1] if len(shape) == 2 else 1
                x = self.fill(args[1], (n, C), T,
                              at=lambda ks: ks if len(shape) == 2 else ks[:1])
            self._pivot_rows(p, x, n, C, T)
            self._substitute(a, x, n, C, T, lower=True, unit=True)
            self._substitute(a, x, n, C, T, lower=False)
            return x, lambda k, idx: _flat(idx, shape)
        if t is aten.linalg_lu_solve.default:
            LU, piv, B = args[:3]
            n, shape = g.shape[LU][0], g.shape[B]
            a = self.fill(LU, (n, n), T)
            p = self.whole(("lu", piv.args[0].args[0], False))[1]
            x = self.fill(B, shape, T)
            self._pivot_rows(p, x, n, shape[1], T)
            self._substitute(a, x, n, shape[1], T, lower=True, unit=True)
            self._substitute(a, x, n, shape[1], T, lower=False)
            return x, lambda k, idx: _flat(idx, shape)
        if t is aten.cholesky_solve.default:   # L L^T x = b
            B, L = args[0], args[1]
            upper = bool(_opt(node, 2, "upper", False))
            n, shape = g.shape[L][0], g.shape[B]
            a = self.fill(L, (n, n), T, at=lambda ks: ks[::-1] if upper
                          else ks)
            x = self.fill(B, shape, T)
            self._substitute(a, x, n, shape[1], T, lower=True)
            self._substitute(a, x, n, shape[1], T, lower=False,
                             transposed=True)
            return x, lambda k, idx: _flat(idx, shape)
        # solve_triangular(A, B, upper, left, unitriangular); X A = B as
        # A^T X^T = B^T
        A, B = args[0], args[1]
        upper = bool(node.kwargs.get("upper", args[2] if len(args) > 2
                                     else False))
        left = bool(node.kwargs.get("left", True))
        unit = bool(node.kwargs.get("unitriangular", False))
        n, shape = g.shape[A][0], g.shape[B]
        flip = (lambda ks: ks) if left else (lambda ks: ks[::-1])
        a = self.fill(A, (n, n), T, at=flip)
        C = shape[1] if left else shape[0]
        x = self.fill(B, (n, C), T, at=flip)
        self._substitute(a, x, n, C, T, lower=upper != left, unit=unit)
        return x, lambda k, idx: _flat(flip(idx), (n, C))

    def _sort(self, node):
        """``sort``/``topk``/``kthvalue``/``median`` along a dim: element k
        of a slice's values is its element of stable rank k, NaN the
        largest (first in a descending sort), an O(L^2) count a slice of
        L, and of its indices that element's index; ``median`` the lower
        median, NaN (the first) where the slice holds one. ``({0: values,
        1: indices}, flat)``, arrays over the input's shape with the dim cut
        to the values kept."""
        g, t = self.g, node.target
        X = node.args[0]
        T, ishape = g.ctype[X], g.shape[X]
        if t is aten.median.default:   # every element, flattened
            ishape, read = (math.prod(ishape),), \
                (lambda ks: self._unflat(ks[0], g.shape[X]))
        else:
            read = lambda ks: ks  # noqa: E731
        r = len(ishape)
        dim = {aten.topk.default: (2, -1), aten.kthvalue.default: (2, -1),
               aten.median.dim: (1, None)}.get(t, (1, -1))
        d = 0 if t is aten.median.default else \
            _opt(node, dim[0], "dim", dim[1]) % max(r, 1)
        L = ishape[d] if r else 1
        descending, keep, rank = False, L, None
        if t in (aten.sort.default, aten.sort.stable):
            descending = bool(_opt(node, 2, "descending", False))
        elif t is aten.topk.default:
            descending = bool(_opt(node, 3, "largest", True))
            keep = node.args[1]
        elif t is aten.kthvalue.default:
            keep, rank = 1, node.args[1] - 1
        else:
            keep, rank = 1, (L - 1) // 2
        shape = tuple(keep if e == d else s for e, s in enumerate(ishape))
        out = self.array(T, math.prod(shape))
        at = self.array("int64_t", math.prod(shape))
        ks = [None] * r
        for e in range(r):
            if e != d:
                ks[e] = self.loop(ishape[e])
        v = self.array(T, L)
        ks[d] = self.loop(L)
        self.op(f"{v}[{ks[d]}] = {self.val(X, read(ks) if r else (), T)};")
        self.close()
        ahead = (lambda a, b: f"({a} > {b} || ({a} != {a} && {b} == {b}))") \
            if descending else \
            (lambda a, b: f"({a} < {b} || ({b} != {b} && {a} == {a}))")
        j = self.loop(L)
        n_ahead = g.fresh("q")
        self.op(f"int {n_ahead} = 0;")
        l = self.loop(L)
        a, b = f"{v}[{l}]", f"{v}[{j}]"
        self.op(f"{n_ahead} = {n_ahead} + ({ahead(a, b)} || ({l} < {j} && "
                f"!{ahead(b, a)}) ? 1 : 0);")
        self.close()
        pos = list(ks)
        pos[d] = n_ahead if rank is None else 0
        o = _flat(pos, shape)
        put = f"{{ {out}[{o}] = {v}[{j}]; {at}[{o}] = {j}; }}"
        if rank is not None:
            self.op(f"if ({n_ahead} == {rank}) {put}")
        else:
            self.op(put if keep == L else f"if ({n_ahead} < {keep}) {put}")
        self.close()
        if t in (aten.median.dim, aten.median.default):   # the first NaN
            k = self.loop(L)
            self.op(f"if ({v}[{k}] != {v}[{k}] && {out}[{o}] == {out}[{o}]) "
                    f"{{ {out}[{o}] = {v}[{k}]; {at}[{o}] = {k}; }}")
            self.close()
        for e in range(r):
            if e != d:
                self.close()
        arrays = {0: out, 1: at}
        if t is aten.median.default:
            return arrays, lambda k, idx: 0
        if rank is not None and not _opt(node, dim[0] + 1, "keepdim", False):
            return arrays, lambda k, idx: _flat(idx[:d] + (0,) + idx[d:],
                                                shape)
        return arrays, lambda k, idx: _flat(idx, shape)

    def _triangle(self, node, idx) -> str:
        """``tril``/``triu(A, diagonal)``: A's element where j - i is on the
        kept side of ``diagonal``, else 0."""
        T, src = self.g.ctype[node], node.args[0]
        k = _opt(node, 1, "diagonal", 0)
        diff = _iadd(idx[-1], _imul(idx[-2], -1))
        cmp = _TRIANGLES[node.target]
        if isinstance(diff, int):
            keep = diff <= k if cmp == "<=" else diff >= k
            return self.val(src, idx) if keep else _literal(0, T)
        return self.select(T, f"{diff} {cmp} {k}",
                           lambda: self.val(src, idx, T), _literal(0, T))


def _method(body: _Body, result: str) -> str:
    return "\n".join(body.lines + ["    return " + result + ";"])


def emit_source(gm, name: str, n: int, m: int, dtype):
    """The functor source of the traced step ``gm`` (``trace_step``), its
    parameter tensors in the order of its ``p`` array, and its work a step
    ``(serial, row)``: the statements of ``prep`` and ``stage_cost``,
    which a lane runs whole, and of one ``row``."""
    g = _Graph(gm, name, n, m, dtype)
    S = g.S
    scan = _Body(g, "scan")
    scan.val(g.xn, (_ROW,), S)
    # a factor (kind, A, upper) after its matrix A
    hoisted = sorted(scan.hoisted, key=lambda h: g.pos[h[1]] + 0.5
                     if isinstance(h, tuple) else g.pos[h])

    row = _Body(g, "row", set(hoisted))
    row_expr = row.val(g.xn, (_ROW,), S)

    prep = _Body(g, "prep")
    members = []
    for node in hoisted:
        name_ = g.hoist_name(node)
        if isinstance(node, tuple):   # a factor and the LU pivots
            kind, A, _ = node
            n_ = g.shape[A][0]
            members.append(f"    {g.ctype[A]} {name_}[{n_ * n_}];")
            if kind == "lu":
                members.append(f"    int {name_}p[{n_}];")
            prep.whole(node, into=(f"r.{name_}", f"r.{name_}p"))
            prep.made.add(node)
            continue
        shape = g.shape[node]
        members.append(f"    {g.ctype[node]} {name_}"
                       f"[{max(math.prod(shape), 1)}];")
        ks = [prep.loop(s) for s in shape]
        prep.line(f"r.{name_}[{_flat(ks, shape)}] = "
                  f"{prep.val(node, ks)};")
        for _ in shape:
            prep.close()
        prep.made.add(node)

    cost = _Body(g, "whole")
    cost_expr = cost.val(g.cost, (), S)
    final = _Body(g, "whole")
    final_expr = final.val(g.final, (), S)

    sizes = [math.prod(g.param_shape[t]) for t in g.params]
    each = "\n".join(f"    f(p[{k}], {s});" for k, s in enumerate(sizes))
    desc = ", ".join(f"p[{k}] {list(g.param_shape[t])}"
                     for k, t in enumerate(g.params)) or "none"
    decomposed = ", ".join(getattr(gm, "decomposed", ())) or "none"
    src = f"""\
// The step of {name}, traced from its transition, cost and final_cost by
// tfmpc_tpu_torch/ops/env_codegen.py at (n, m) = ({n}, {m}) in {S}.
// Parameters: {desc}.
// Traced through torch._decomp: {decomposed}.
#include <stdint.h>
namespace tfmpc {{

struct UserStep {{
  using S = {S};
  static constexpr int kN = {n}, kM = {m}, kParams = {len(sizes)};
  static constexpr int kParamElems = {sum(sizes)};
  const S* __restrict__ p[kParams > 0 ? kParams : 1];
  Dims<kAnyDim> dims;

  __host__ __device__ int param_elems() const {{ return kParamElems; }}
  template <class F>
  __device__ __forceinline__ void each_param(F&& f) {{
{each}
  }}

  // what every row reads whole
  struct Pre {{
{chr(10).join(members)}
  }};
  template <class X>
  __device__ __forceinline__ Pre prep(const X& x) const {{
    Pre r;
{_method(prep, "r")}
  }}

  // row i of the next state
  template <class X, class U>
  __device__ __forceinline__ S row(const Pre& pre, int i, const X& x,
                                   const U& u, S, S) const {{
{_method(row, row_expr)}
  }}

  template <class X, class U>
  __device__ __forceinline__ S stage_cost(const X& x, const U& u) const {{
{_method(cost, cost_expr)}
  }}

  template <class X>
  __device__ __forceinline__ S final_cost(const X& x) const {{
{_method(final, final_expr)}
  }}
}};

}}  // namespace tfmpc
"""
    return (src, [getattr(gm, t) for t in g.params],
            (prep.work + cost.work, row.work))


def trace_step(env, dtype, device):
    """``env``'s ``transition``, ``cost`` and ``final_cost`` on one
    scenario, traced with ``make_fx`` in fake mode: a graph module of aten
    ops returning ``(x_next [n], cost [], final_cost [])``. An op outside
    ``SUPPORTED_OPS`` that ``torch._decomp`` decomposes is traced again
    through its decomposition; ``gm.decomposed`` names those ops."""
    n, m = env.state_size, env.action_size
    name = type(env).__name__

    def step(x, u):
        return env.transition(x, u), env.cost(x, u), env.final_cost(x)

    x = torch.zeros(n, dtype=dtype, device=device)
    u = torch.zeros(m, dtype=dtype, device=device)
    table: dict = {}
    try:
        with torch.no_grad(), ScalarIndexMode():
            while True:
                gm = make_fx(step, tracing_mode="fake",
                             decomposition_table=table,
                             _allow_non_fake_inputs=True)(x, u)
                more = _decomposable(gm) - set(table)
                if not more:
                    break
                table.update(get_decompositions(list(more)))
    except RuntimeError as e:
        if isinstance(e, DynamicOutputShapeException):
            raise _refuse(f"{name}: a data-dependent shape in its step "
                          f"({type(e).__name__}: {e})") from e
        if "data-dependent" in str(e) or "data dependent" in str(e):
            raise _refuse(f"{name}: a data-dependent branch or value in "
                          f"its step ({type(e).__name__}: "
                          f"{str(e).splitlines()[0]})") from e
        raise _refuse(f"{name}: its step could not be traced "
                      f"({type(e).__name__}: {str(e).splitlines()[0]})") \
            from e
    gm.decomposed = sorted({_op_name(op) for op in table})
    return gm


def _decomposable(gm) -> set:
    """The ops of ``gm`` outside ``SUPPORTED_OPS`` that compute tensors
    and that ``torch._decomp`` decomposes."""
    out = set()
    for nd in gm.graph.nodes:
        val = nd.meta.get("val")
        if nd.op == "call_function" \
                and isinstance(val, (torch.Tensor, tuple, list)) \
                and nd.target not in SUPPORTED_OPS \
                and nd.target in decomposition_table:
            out.add(nd.target)
    return out


def _scalar_index(i) -> bool:
    return isinstance(i, torch.Tensor) and i.dim() == 0 and not (
        i.is_floating_point() or i.is_complex() or i.dtype == torch.bool)


class ScalarIndexMode(TorchFunctionMode):
    """Reads a tensor at 0-d integer tensors (``v[i]``, ``T[r, i]``, as
    a step written for one scenario indexes) through ``aten::index.Tensor``
    instead of ``.item()``, which a trace cannot take: torch's indexing
    selects at such an index as at the Python int it holds, so each is a
    1-element index followed by a squeeze, on its dim, before the rest of
    the index applies (other indices, slices, None, Ellipsis), which gives
    the same values."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__getitem__:
            v, index = args
            items = index if isinstance(index, tuple) else (index,)
            if any(_scalar_index(i) for i in items):
                return self._select(v, items)
        return func(*args, **(kwargs or {}))

    @staticmethod
    def _select(v, items):
        spans = sum(1 for i in items
                    if i is not None and i is not Ellipsis
                    and not isinstance(i, bool))
        d, picks, rest = 0, [], []
        for i in items:
            if i is Ellipsis:
                d += v.dim() - spans
            elif i is not None and not isinstance(i, bool):
                if _scalar_index(i):
                    picks.append((d, i))
                    d += 1
                    continue
                d += 1
            rest.append(i)
        for d, i in reversed(picks):
            v = aten.index.Tensor(v, [None] * d + [i.reshape(1)]).squeeze(d)
        return v[tuple(rest)] if rest else v


_STEPS: Dict[int, dict] = {}


def device_step(env, dtype, device) -> DeviceStep:
    """The generated ``DeviceStep`` of ``env`` at ``dtype`` on ``device``
    (``Env.generic_device_step``): traced once per env instance, dtype and
    device type, and kept while the env lives."""
    key = (dtype, torch.device(device).type)
    steps = _STEPS.get(id(env))
    if steps is None:
        steps = {}
        try:
            weakref.finalize(env, _STEPS.pop, id(env), None)
            _STEPS[id(env)] = steps
        except TypeError:  # not weakly referenceable: trace at every call
            pass
    if key not in steps:
        gm = trace_step(env, dtype, device)
        source, params, work = emit_source(
            gm, type(env).__name__, env.state_size, env.action_size, dtype)
        steps[key] = DeviceStep(env_id=USER_STEP_ID, params=tuple(params),
                                int_params=(), source=source, work=work)
    return steps[key]


HOST_PRELUDE = """\
// A host build of a generated step functor (g++), for tests: the CUDA
// qualifiers compile away and Dims comes from here, not envs.cuh.
#define __device__
#define __host__
#define __forceinline__ inline
#include <math.h>
namespace tfmpc {
constexpr int kAnyDim = 0;
template <int N>
struct Dims;
template <>
struct Dims<kAnyDim> {
  int n, m;
};
}  // namespace tfmpc
"""

HOST_HARNESS = """\
namespace {
using S = tfmpc::UserStep::S;
struct Vec {
  const S* v;
  S operator[](int i) const { return v[i]; }
};
}  // namespace

// Each of B scenarios (x [B, n], u [B, m], row-major) through prep, row
// (every i), stage_cost and final_cost: x_next [B, n], cost [B], final
// [B]. Returns 1 for a parameter count the functor does not take.
extern "C" int user_step_eval(const void* const* params, int n_params,
                              const void* x, const void* u, int B,
                              void* x_next, void* cost, void* final) {
  using tfmpc::UserStep;
  if (n_params != UserStep::kParams) return 1;
  UserStep step{};
  for (int k = 0; k < n_params; ++k)
    step.p[k] = static_cast<const S*>(params[k]);
  step.dims = tfmpc::Dims<tfmpc::kAnyDim>{UserStep::kN, UserStep::kM};
  const int n = UserStep::kN, m = UserStep::kM;
  for (int b = 0; b < B; ++b) {
    const Vec xv{static_cast<const S*>(x) + b * n};
    const Vec uv{static_cast<const S*>(u) + b * m};
    const auto pre = step.prep(xv);
    for (int i = 0; i < n; ++i)
      static_cast<S*>(x_next)[b * n + i] =
          step.row(pre, i, xv, uv, xv[i], i < m ? uv[i] : S(0));
    static_cast<S*>(cost)[b] = step.stage_cost(xv, uv);
    static_cast<S*>(final)[b] = step.final_cost(xv);
  }
  return 0;
}
"""


def host_source(source: str) -> str:
    """A host C++ program of the functor ``source``: ``HOST_PRELUDE``, the
    functor, and ``user_step_eval``, which loops ``prep``, ``row``,
    ``stage_cost`` and ``final_cost`` over a batch."""
    return HOST_PRELUDE + source + HOST_HARNESS
