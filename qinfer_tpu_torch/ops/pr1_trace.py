"""A model's torch pr1 traced into B1's functor (the traced route).

The JAX package's Pallas kernel takes any ``jnp`` pr1 that a model
supplies: Pallas traces it into the kernel's body
(``qinfer_tpu/ops/fused_update.py:239-259``, ``two_outcome_tile`` and
``binomial_tile``). This module does the same for B1 on the card.
``trace_pr1(fn, n_cols)`` records ``fn(scalars, off, *cols)`` with
``make_fx`` in fake mode on meta tensors of the single-bank layout
(``scalars`` (k,), each column (N,)) and reads the aten graph into a
``Pr1Program``: nodes over reads of the pr1's scalars ``s[j]`` (relative to
``off``), reads of column j of particle i, f32 literals and the ops below.
Its ``source`` is a ``struct UserPr1`` with the interface of
``csrc/fused_update.cuh``, which ``_build.user_library`` builds with B1's
kernels at first use, as it builds a hand-written one.

Each op is written with torch's CUDA semantics, so that the functor
computes what the pr1 computes on the card, op by op and in the graph's
order: products, sums and differences through the header's ``mul``,
``add`` and ``sub`` (no FMA contraction); IEEE division (``__fdiv_rn``) and
square root (``__fsqrt_rn``); ``cosf``, ``sinf``, ``expf``, ``logf``,
``fabsf``; a division by a Python scalar or a 0-d CPU tensor as the product
with its f32 reciprocal, as torch's CUDA division by a CPU scalar computes
it; ``maximum`` and ``minimum`` propagating NaN; ``clamp`` by constant
bounds letting NaN through (``clampf``); ``where`` and the six
comparisons; ``pow`` by 0, 1, 2, 3, 0.5, −1 and −2, the exponents that
torch's CUDA ``pow`` computes by products, a square root or a division;
views and broadcasts that move no particle. Python scalars are rounded to
f32 as torch rounds them and written exactly. A node that depends on the
scalars and literals alone is computed once a thread, in the constructor;
the others in ``operator()``. Ops of the graph that run on the host (on
0-d CPU tensors only) are computed here, by torch, into literals.

The tracer refuses, with a reason (``Refusal``): an op outside that table,
among them in-place ops (it reads values, not mutations), factories of a
particle's shape and ``addcmul``-like ops whose CUDA kernel may round a
product and a sum once; an op that reads across particles (a reduction,
``sort``, a gather, a select or view that moves particles); a branch or
``.item()`` on a tensor's value; a captured tensor that is not 0-d or that
lives on another device than the bank; integer or f64 arithmetic; a read of
the scalars before ``off`` or from their end; a pr1 of no column or more
than 16. A refused pr1 takes the column route (``ops.fused_update``).

``trace_pr1`` caches its result by the pr1 and ``n_cols``; a plain
function (a pr1 that ``_fused_pr1_parts`` builds afresh each call) by its
code, its defaults and its closure's values, so an update pays a lookup
and not a trace.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["trace_pr1", "Pr1Program", "Refusal", "evaluate"]

MAX_COLS = 16      # the tracer's own bound (kNarrowCols of csrc/fused_update.cuh)
_OFF = 3           # the offset the trace passes: the widest outcome head
_K = 256           # scalars of the traced layout, (k,)
_N = 4099          # particles of the traced layout, unlike _K and _T
_T = 5             # trials of the batched layout
_CACHE_SIZE = 512  # traces kept


class Node(NamedTuple):
    """One value of a ``Pr1Program``. ``op``: "scalar" (``args`` = (j,):
    the pr1's scalar j), "col" ((j,): column j of the particle), "lit"
    ((value, host): an f32 literal; ``host`` when torch holds it on the CPU,
    a Python scalar or a 0-d CPU tensor) or an op of ``_EXPR`` (``args``:
    the indices of its operands). ``uniform``: depends on the scalars and
    literals alone. ``dtype``: "f32" or "bool"."""

    op: str
    args: tuple
    uniform: bool
    dtype: str


@dataclass(frozen=True)
class Refusal:
    """A pr1 the tracer does not take, and why."""

    reason: str


@dataclass(frozen=True, eq=False)
class Pr1Program:
    """A traced pr1: ``nodes`` in the graph's order, ``out`` the node it
    returns, ``n_cols`` the columns it takes and ``n_scalars`` the scalars
    after ``off`` that it reads."""

    nodes: tuple
    out: int
    n_cols: int
    n_scalars: int

    @functools.cached_property
    def source(self):
        """The CUDA functor: ``struct UserPr1``."""
        return _emit(self)


# -- the cache ----------------------------------------------------------------

class _Ref:
    """An unhashable object in a cache key, by identity (held, so that its
    id is not reused)."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _Ref) and other.obj is self.obj


def _part(value):
    """A closure value or default in a cache key: a tuple part by part; a
    tensor, or a value that does not hash, by identity; any other value
    (a scalar, a frozen pr1) by its type and value."""
    if isinstance(value, tuple):
        return tuple(_part(v) for v in value)
    if isinstance(value, torch.Tensor):
        return _Ref(value)
    try:
        hash(value)
    except TypeError:
        return _Ref(value)
    return type(value), value


def _key(fn, n_cols):
    code = getattr(fn, "__code__", None)
    if code is None or hasattr(fn, "__self__"):  # a callable, a bound method
        return _part(fn), n_cols
    if fn.__closure__ is None and fn.__defaults__ is None and (
            fn.__kwdefaults__ is None):
        return code, n_cols
    cells = []
    for cell in fn.__closure__ or ():
        try:
            cells.append(_part(cell.cell_contents))
        except ValueError:  # a cell not yet bound
            cells.append(None)
    return (code, tuple(cells), _part(fn.__defaults__),
            _part(tuple(sorted((fn.__kwdefaults__ or {}).items()))), n_cols)


_TRACES = {}  # cache key -> Pr1Program | Refusal, oldest first


def trace_pr1(fn, n_cols):
    """The ``Pr1Program`` of ``fn(scalars, off, *cols) -> Pr(1)`` over
    ``n_cols`` columns, or the ``Refusal`` that says why not. Cached;
    ``trace_pr1.traces`` counts the traces made."""
    key = _key(fn, n_cols)
    found = _TRACES.get(key)
    if found is None:
        found = _trace(fn, n_cols)
        trace_pr1.traces += 1
        if len(_TRACES) >= _CACHE_SIZE:
            del _TRACES[next(iter(_TRACES))]
        _TRACES[key] = found
    return found


trace_pr1.traces = 0


def _trace(fn, n_cols, batched=False):
    """Traces ``fn`` in the single-bank layout, or with ``batched`` in the
    batched one (``scalars.T[:, :, None]`` (k, T, 1), columns (T, N), as
    the batched column route and ``_trial_pr1`` call a pr1)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    if not 1 <= n_cols <= MAX_COLS:
        return Refusal(f"the tracer takes 1 to {MAX_COLS} columns; got "
                       f"{n_cols}")
    frame = (_T, _N) if batched else (_N,)
    scalars = torch.empty((_K, _T, 1) if batched else (_K,), device="meta")
    cols = [torch.empty(frame, device="meta") for _ in range(n_cols)]
    try:
        gm = make_fx(lambda s, *c: fn(s, _OFF, *c), tracing_mode="fake",
                     _allow_non_fake_inputs=True)(scalars, *cols)
    # The user's code raised under the tracer (a branch on a value, a device
    # mismatch, its own error): the column route runs it as it is.
    except Exception as exc:  # noqa: BLE001
        first = (str(exc).strip().splitlines() or [""])[0][:200]
        return Refusal(f"the pr1 does not trace: {type(exc).__name__}: "
                       f"{first}")
    try:
        return _Reader(gm, n_cols, frame).program()
    except _Refused as exc:
        return Refusal(str(exc))


# -- reading the graph --------------------------------------------------------

class _Refused(Exception):
    pass


def _f32(x):
    """torch's f32 rounding of a Python scalar."""
    return np.float32(float(x))


_ACROSS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "std", "var",
           "logsumexp", "cumsum", "cumprod", "sort", "argsort", "topk",
           "gather", "index", "index_select", "take", "flip", "roll",
           "median", "norm", "softmax", "_softmax", "log_softmax",
           "_log_softmax", "argmax", "argmin", "slice", "narrow", "permute",
           "transpose", "t"}
_UNARY = {"neg": "neg", "cos": "cos", "sin": "sin", "exp": "exp",
          "log": "log", "sqrt": "sqrt", "abs": "abs",
          "reciprocal": "reciprocal"}
_BINARY = {"add": "add", "sub": "sub", "mul": "mul", "div": "div",
           "maximum": "maximum", "minimum": "minimum", "eq": "eq",
           "ne": "ne", "lt": "lt", "le": "le", "gt": "gt", "ge": "ge"}
_COMPARE = {"eq", "ne", "lt", "le", "gt", "ge"}
_IDENTITY = {"clone", "detach", "alias", "lift_fresh_copy", "expand",
             "unsqueeze", "squeeze", "view", "_unsafe_view", "reshape"}


def _aligned(shape, frame):
    """``shape`` right-aligned to the particles' frame: leading ones added,
    or dropped where it has more axes; None when it does not broadcast to
    the frame unchanged (one value a particle)."""
    shape = tuple(shape)
    while len(shape) > len(frame) and shape[0] == 1:
        shape = shape[1:]
    shape = (1,) * (len(frame) - len(shape)) + shape
    if len(shape) != len(frame) or any(d not in (1, f)
                                       for d, f in zip(shape, frame)):
        return None
    return shape


class _Reader:
    """Reads a traced graph into a ``Pr1Program``; raises ``_Refused``."""

    def __init__(self, gm, n_cols, frame):
        self.gm, self.n_cols, self.frame = gm, n_cols, frame
        self.nodes = []
        self.env = {}  # fx node -> node index, or "scalars"

    def add(self, op, args, dtype="f32"):
        if op == "scalar" or op == "lit":
            uniform = True
        elif op == "col":
            uniform = False
        else:
            uniform = all(self.nodes[a].uniform for a in args)
        self.nodes.append(Node(op, tuple(args), uniform, dtype))
        return len(self.nodes) - 1

    def lit(self, value, host=True):
        return self.add("lit", (_f32(value), host))

    def val(self, arg):
        """The node of an operand: a traced value, or a Python scalar."""
        if isinstance(arg, torch.fx.Node):
            found = self.env[arg]
            if found == "scalars":
                raise _Refused("the pr1 uses the scalars tensor whole; read "
                               "each scalar as scalars[off + j]")
            return found
        if isinstance(arg, (bool, int, float)):
            return self.lit(arg)
        raise _Refused(f"an operand of type {type(arg).__name__}")

    def program(self):
        placeholders = 0
        out = None
        for fx_node in self.gm.graph.nodes:
            if fx_node.op == "placeholder":
                self.env[fx_node] = ("scalars" if placeholders == 0 else
                                     self.add("col", (placeholders - 1,)))
                placeholders += 1
            elif fx_node.op == "get_attr":
                self.env[fx_node] = self.constant(
                    getattr(self.gm, fx_node.target))
            elif fx_node.op == "call_function":
                self.env[fx_node] = self.call(fx_node)
            elif fx_node.op == "output":
                out = fx_node.args[0]
                if isinstance(out, (tuple, list)) and len(out) == 1:
                    out = out[0]
            else:
                raise _Refused(f"a graph node of kind {fx_node.op}")
        if not isinstance(out, torch.fx.Node):
            raise _Refused("the pr1 returns no tensor of the trace")
        idx = self.val(out)
        if len(out.meta["val"].shape) > len(self.frame):
            raise _Refused(f"the pr1 returns a value of shape "
                           f"{tuple(out.meta['val'].shape)}")
        if self.nodes[idx].dtype != "f32":
            raise _Refused("the pr1 returns a bool tensor, not Pr(1)")
        reads = [n.args[0] for n in self.nodes if n.op == "scalar"]
        return Pr1Program(tuple(self.nodes), idx, self.n_cols,
                          max(reads, default=-1) + 1)

    def constant(self, tensor):
        if tensor.dim() != 0:
            raise _Refused(f"a captured tensor of shape {tuple(tensor.shape)} "
                           "(only 0-d tensors are literals; a wider one may "
                           "hold a value a particle)")
        if tensor.dtype == torch.bool or tensor.is_complex():
            raise _Refused(f"a captured {tensor.dtype} tensor")
        return self.lit(tensor.item(), host=tensor.device.type == "cpu")

    def call(self, fx_node):
        target = fx_node.target
        if not isinstance(target, torch._ops.OpOverload):
            raise _Refused(f"a call of {target!r} in the graph")
        name = target.overloadpacket.__name__
        if target._schema.is_mutable:
            raise _Refused(f"{target}: an in-place op (the tracer reads "
                           "values, not mutations)")
        val = fx_node.meta.get("val")
        if not isinstance(val, torch.Tensor):
            raise _Refused(f"{target}: reads a tensor's value on the host "
                           "(.item() or a branch on a value)")
        if val.dtype not in (torch.float32, torch.bool):
            raise _Refused(f"{target}: {val.dtype} arithmetic (B1 computes in "
                           "f32, op by op)")
        if _aligned(val.shape, self.frame) is None:
            raise _Refused(f"{target}: a value of shape {tuple(val.shape)} "
                           "does not keep one value a particle")
        idx = self.op(fx_node, target, name, val)
        if val.device.type == "cpu":  # torch computes it on the host: fold
            idx = self.fold(idx)
        return idx

    def fold(self, idx):
        """A node over host literals computed as torch computes it on the
        CPU, into a host literal."""
        node = self.nodes[idx]
        if node.op == "lit":
            return idx
        if node.dtype == "bool":
            raise _Refused("a comparison of host values")
        args = [torch.tensor(float(self.nodes[a].args[0])) for a in node.args]
        value = _f32(_TORCH[node.op](*args))
        self.nodes[idx] = Node("lit", (value, True), True, "f32")
        return idx

    def op(self, fx_node, target, name, val):
        args, kwargs = fx_node.args, fx_node.kwargs
        if name != "select" and any(self.env.get(a) == "scalars" for a in args
                                    if isinstance(a, torch.fx.Node)):
            raise _Refused(f"{target} of the scalars tensor whole; read each "
                           "scalar as scalars[off + j]")
        overload = target._overloadname
        dtype = "bool" if val.dtype == torch.bool else "f32"
        if name in _BINARY or name == "rsub":
            if kwargs.get("alpha", 1) != 1 or len(args) > 2:
                raise _Refused(f"{target} with alpha (torch may fuse its "
                               "product and sum)")
            if kwargs.get("rounding_mode") is not None:
                raise _Refused(f"{target} with a rounding mode")
            a, b = self.val(args[0]), self.val(args[1])
            if name == "rsub":
                return self.add("sub", (b, a))
            op = _BINARY[name]
            if op == "div" and self.host(args[1]):
                op = "div_scalar"
            if op not in _COMPARE and dtype != "f32":
                raise _Refused(f"{target}: bool arithmetic")
            return self.add(op, (a, b), dtype)
        if name in _UNARY:
            if dtype != "f32":
                raise _Refused(f"{target}: bool arithmetic")
            return self.add(_UNARY[name], (self.val(args[0]),))
        if name in _IDENTITY:
            return self.identity(fx_node, name, val)
        if name == "select":
            return self.select(fx_node)
        if name in ("clamp", "clamp_min", "clamp_max") and overload in (
                "default", ""):
            return self.clamp(name, args, kwargs)
        if name == "where":
            cond, a, b = (self.val(x) for x in args[:3])
            return self.add("where", (cond, a, b), dtype)
        if name == "pow" and overload == "Tensor_Scalar":
            return self.pow(self.val(args[0]), args[1])
        if name == "_to_copy":
            return self.to_copy(fx_node, kwargs, val)
        if name in ("full", "scalar_tensor"):
            if val.numel() != 1 or val.dtype != torch.float32:
                raise _Refused(f"{target}: a factory of shape "
                               f"{tuple(val.shape)}")
            value = args[1] if name == "full" else args[0]
            return self.lit(value, host=val.device.type == "cpu")
        if name in _ACROSS:
            raise _Refused(f"{target} reads across particles")
        raise _Refused(f"{target} is not in the tracer's op table")

    def host(self, arg):
        """True when torch holds the operand on the CPU as a scalar (a
        Python scalar, or a 0-d CPU tensor)."""
        if not isinstance(arg, torch.fx.Node):
            return True
        node = self.nodes[self.env[arg]]
        return node.op == "lit" and node.args[1]

    def identity(self, fx_node, name, val):
        src = fx_node.args[0]
        idx = self.val(src)
        shape_in = tuple(src.meta["val"].shape)
        if (name == "expand" or math.prod(shape_in) == 1
                or _aligned(shape_in, self.frame)
                == _aligned(val.shape, self.frame)):
            return idx
        raise _Refused(f"{fx_node.target}: a view from {shape_in} to "
                       f"{tuple(val.shape)} moves particles")

    def select(self, fx_node):
        src, dim, index = fx_node.args[:3]
        if self.env.get(src) == "scalars":
            if dim != 0:
                raise _Refused("a select of the scalars along another axis")
            if index < 0:
                raise _Refused("a read of the scalars from their end (read "
                               "scalars[off + j])")
            if index < _OFF:
                raise _Refused("a read of the outcome composition's scalars "
                               "(before off)")
            return self.add("scalar", (index - _OFF,))
        if math.prod(src.meta["val"].shape) == 1:
            return self.val(src)
        raise _Refused(f"{fx_node.target}: a select of one particle or trial")

    def clamp(self, name, args, kwargs):
        lo = args[1] if len(args) > 1 else kwargs.get("min")
        hi = args[2] if len(args) > 2 else kwargs.get("max")
        if name == "clamp_min":
            lo, hi = args[1], None
        elif name == "clamp_max":
            lo, hi = None, args[1]
        x = self.val(args[0])
        if lo is not None and hi is not None:
            if not _f32(lo) <= _f32(hi):
                raise _Refused("clamp with min > max")
            return self.add("clamp", (x, self.lit(lo), self.lit(hi)))
        if lo is not None:
            return self.add("clamp_min", (x, self.lit(lo)))
        if hi is not None:
            return self.add("clamp_max", (x, self.lit(hi)))
        raise _Refused("clamp without bounds")

    def pow(self, x, exponent):
        e = float(exponent)
        if e == 0.0:  # torch fills ones, NaN included
            return self.lit(1.0)
        if e == 1.0:
            return x
        if e == 0.5:
            return self.add("sqrt", (x,))
        if e == -1.0:
            return self.add("reciprocal", (x,))
        if e in (2.0, 3.0, -2.0):
            sq = self.add("mul", (x, x))
            if e == 3.0:
                return self.add("mul", (sq, x))
            return sq if e == 2.0 else self.add("reciprocal", (sq,))
        raise _Refused(f"pow by {exponent}: torch's CUDA result is powf's, "
                       "which the functor does not reproduce")

    def to_copy(self, fx_node, kwargs, val):
        src = fx_node.args[0]
        idx = self.val(src)
        if kwargs.get("device") is not None and val.device != src.meta[
                "val"].device:
            raise _Refused(f"{fx_node.target} to another device")
        if src.meta["val"].dtype == torch.bool and val.dtype == torch.float32:
            return self.add("float", (idx,))
        if src.meta["val"].dtype == val.dtype:
            return idx
        raise _Refused(f"{fx_node.target} from {src.meta['val'].dtype} to "
                       f"{val.dtype}")


# -- torch's CPU evaluation of a program --------------------------------------

_TORCH = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "div_scalar": torch.div, "neg": torch.neg, "cos": torch.cos,
    "sin": torch.sin, "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt,
    "abs": torch.abs, "reciprocal": torch.reciprocal,
    "maximum": torch.maximum, "minimum": torch.minimum, "eq": torch.eq,
    "ne": torch.ne, "lt": torch.lt, "le": torch.le, "gt": torch.gt,
    "ge": torch.ge, "where": torch.where,
    "clamp": lambda x, lo, hi: torch.clamp(x, float(lo), float(hi)),
    "clamp_min": lambda x, lo: torch.clamp(x, min=float(lo)),
    "clamp_max": lambda x, hi: torch.clamp(x, max=float(hi)),
    "float": lambda x: x.to(torch.float32),
}


def evaluate(program, scalars, off, *cols):
    """The program run with torch, op by op: what the pr1 computes, in any
    layout the pr1 takes (single bank, or batched with ``scalars.T[:, :,
    None]``). Host literals are Python scalars, the others 0-d tensors on
    the columns' device."""
    device = cols[0].device
    vals = []
    for node in program.nodes:
        if node.op == "scalar":
            v = scalars[off + node.args[0]]
        elif node.op == "col":
            v = cols[node.args[0]]
        elif node.op == "lit":
            value, host = node.args
            v = float(value) if host else torch.tensor(float(value),
                                                       device=device)
        else:
            v = _TORCH[node.op](*(vals[a] for a in node.args))
        vals.append(v)
    out = vals[program.out]
    return out if isinstance(out, torch.Tensor) else torch.tensor(
        out, device=device)


# -- emitting the functor -----------------------------------------------------

def _literal(value):
    """An f32 literal of C++ that reads back as exactly ``value``."""
    x = np.float32(value)
    bits = int(x.view(np.uint32))
    if not np.isfinite(x):
        return f"__int_as_float(0x{bits:08x})"
    text = f"{float(x):.9g}"  # nine digits name one f32
    if "e" not in text and "." not in text:
        text += ".0"
    return f"{text}f"


def _helper(name, body):
    return (f"static __device__ __forceinline__ float {name}_(float a, "
            f"float b) {{\n    return {body};\n  }}")


# The functions of torch's CUDA kernels that the functor defines where it
# uses them: maximum and minimum let NaN through from either side.
_HELPERS = {
    "maximum": _helper("maximum", "a != a ? a : (b != b ? b : fmaxf(a, b))"),
    "minimum": _helper("minimum", "a != a ? a : (b != b ? b : fminf(a, b))"),
    "clamp_min": _helper("clamp_min", "a < b ? b : a"),
    "clamp_max": _helper("clamp_max", "a > b ? b : a"),
}
_EXPR = {
    "add": "add({}, {})", "sub": "sub({}, {})", "mul": "mul({}, {})",
    "div": "__fdiv_rn({}, {})", "neg": "(-({}))", "cos": "cosf({})",
    "sin": "sinf({})", "exp": "expf({})", "log": "logf({})",
    "sqrt": "__fsqrt_rn({})", "abs": "fabsf({})",
    "reciprocal": "__fdiv_rn(1.0f, {})", "maximum": "maximum_({}, {})",
    "minimum": "minimum_({}, {})", "eq": "({} == {})", "ne": "({} != {})",
    "lt": "({} < {})", "le": "({} <= {})", "gt": "({} > {})",
    "ge": "({} >= {})", "where": "({} ? {} : {})",
    "clamp": "clampf({}, {}, {})", "clamp_min": "clamp_min_({}, {})",
    "clamp_max": "clamp_max_({}, {})", "float": "({} ? 1.0f : 0.0f)",
}


def _live(program):
    live, todo = set(), [program.out]
    while todo:
        k = todo.pop()
        if k not in live:
            live.add(k)
            if program.nodes[k].op not in ("scalar", "col", "lit"):
                todo.extend(program.nodes[k].args)
    return sorted(live)


def _emit(program):
    nodes = program.nodes
    live = _live(program)
    members = sorted({a for k in live if not nodes[k].uniform
                      and nodes[k].op not in ("scalar", "col", "lit")
                      for a in nodes[k].args
                      if nodes[a].uniform and nodes[a].op != "lit"}
                     | ({program.out} if nodes[program.out].uniform
                        and nodes[program.out].op != "lit" else set()))

    def ref(k, in_ctor):
        node = nodes[k]
        if node.op == "lit":
            return _literal(node.args[0])
        if node.uniform and not in_ctor:
            return f"u{k}"
        return f"v{k}"

    def expr(k, in_ctor):
        node = nodes[k]
        if node.op == "scalar":
            return f"s[{node.args[0]}]"
        if node.op == "col":
            return f"c({node.args[0]}, i)"
        if node.op == "div_scalar":  # torch's CUDA a / b by a CPU scalar b
            inv = np.float32(1.0) / np.float32(nodes[node.args[1]].args[0])
            return f"mul({ref(node.args[0], in_ctor)}, {_literal(inv)})"
        return _EXPR[node.op].format(*(ref(a, in_ctor) for a in node.args))

    ctor, body, helpers = [], [], []
    for k in live:
        node = nodes[k]
        if node.op == "lit":
            continue
        if node.op in _HELPERS and _HELPERS[node.op] not in helpers:
            helpers.append(_HELPERS[node.op])
        ctype = "bool" if node.dtype == "bool" else "float"
        line = f"const {ctype} v{k} = {expr(k, node.uniform)};"
        (ctor if node.uniform else body).append(line)
    ctor += [f"u{k} = v{k};" for k in members]
    body.append(f"return {ref(program.out, False)};")
    n = program.n_cols
    decls = [f"  {'bool' if nodes[k].dtype == 'bool' else 'float'} u{k};"
             for k in members]
    out = [
        "// Traced from a torch pr1 by qinfer_tpu_torch.ops.pr1_trace: one "
        "node a line,",
        "// in the graph's order, each rounded as torch rounds it on CUDA.",
        "struct UserPr1 {",
        f"  static constexpr int kMinCols = {n}, kMaxColsUsed = {n};",
        *decls,
        *(f"  {h}" for h in helpers),
        "  __device__ UserPr1(const float* s, const Consts&, int) {",
        "    (void)s;",
        *(f"    {line}" for line in ctor),
        "  }",
        "  template <class C>",
        "  __device__ __forceinline__ float operator()(const C& c, "
        "int64_t i) const {",
        *(f"    {line}" for line in body),
        "  }",
        "};",
    ]
    return "\n".join(out) + "\n"
