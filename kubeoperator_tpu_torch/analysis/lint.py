"""Static lint of the port's hot paths: the counterpart of the KO1xx rules
of ``kubeoperator_tpu/analysis/rules_jax.py`` that carry over to PyTorch,
on a minimal copy of the rule engine of ``kubeoperator_tpu/analysis/
core.py``.

A ``Rule`` inspects one parsed module (a ``ModuleContext``: its tree,
import aliases, which nodes sit in a loop body and which function
encloses each node) and yields ``Finding``\\ s. The rules:

* **KO101** — a host→device transfer inside a ``for``/``while`` body:
  ``torch.tensor(..., device=)``, ``torch.as_tensor(..., device=)``,
  or ``.to(<device>)``/``.cuda()`` of a value not known to be on the
  device. One copy and one launch per iteration.
* **KO102** — a device→host sync inside a loop: ``.cpu()``, ``.numpy()``,
  or ``.item()``/``.tolist()``/``int()``/``float()``/``bool()`` of a
  tensor (a name bound from a ``torch`` call or a tensor method). Each
  blocks the host on the device.
* **KO121** — in a class that defines ``_page_write``, an in-place write
  of a pool buffer (a name holding "pool": subscript assignment,
  ``index_put_``, ``index_copy_``, ``scatter_``, ``copy_``) anywhere but
  ``_page_write``/``_page_copy``: the write skips the block table's
  (slot, position) → (page, offset) translation.
* **KO122** — in a class that defines ``_gather_kv``, a subscript read of
  a pool buffer anywhere but the pool's read and write helpers: on a
  quantized pool it reads raw codes without their scales.
* **KO123** — in a class that defines ``_rewind``, a block-table write
  outside the truncation paths, or a position clamped inline
  (``torch.minimum``/``clamp(max=)`` into a pos-named target): rollbacks
  go through ``_rewind``.

The rules gate on the module importing ``torch``. A finding is silenced
by a pragma, ``# ko: lint-ok[<rule id>] <reason>``, on its line (or
alone on the line above; across a simple statement that spans lines),
naming the rule (``KO101``) or several, comma-separated; the reason is
mandatory, and a bare pragma is itself a finding (KO000), as is one that
names an unknown rule (KO001).

    python -m kubeoperator_tpu_torch.analysis.lint [paths] [--json]

exits 1 when a finding at ``warning`` or above remains.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator

SEVERITIES = ("info", "warning", "error")
_SEV_ORDER = {s: i for i, s in enumerate(SEVERITIES)}
SKIP_DIRS = {".git", "__pycache__", ".pytest_cache", "build", "dist"}
_PRAGMA_RE = re.compile(r"#\s*ko:\s*lint-ok\[([A-Za-z0-9_*,\s]+)\]\s*(.*)$")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source span."""

    rule: str
    severity: str
    path: str
    line: int
    col: int
    message: str
    hint: str = ""

    def format(self) -> str:
        text = (f"{self.path}:{self.line}:{self.col}: {self.severity} "
                f"{self.rule} {self.message}")
        return text + (f"\n    hint: {self.hint}" if self.hint else "")

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "path": self.path, "line": self.line, "col": self.col,
                "message": self.message, "hint": self.hint}


class Rule:
    """One static check: subclasses set the metadata and implement
    ``check`` over a ``ModuleContext``."""

    id: str = ""
    severity: str = "warning"
    title: str = ""
    hint: str = ""

    def check(self, ctx: "ModuleContext") -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: "ModuleContext", node: ast.AST,
                message: str) -> Finding:
        return Finding(rule=self.id, severity=self.severity, path=ctx.path,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0) + 1,
                       message=message, hint=self.hint)


RULES: dict[str, Rule] = {}


def register(cls: type) -> type:
    inst = cls()
    if inst.id in RULES:
        raise ValueError(f"duplicate rule id {inst.id}")
    RULES[inst.id] = inst
    return cls


class _TreeInfo:
    """Parents, loop-body membership and the enclosing function of every
    node. ``for``/``while`` bodies (and the per-element parts of a
    comprehension) are loop bodies; a loop's iterable and the body of a
    function defined inside a loop are not: a def's body runs when it is
    called."""

    def __init__(self, tree: ast.AST):
        self.parents: dict[ast.AST, ast.AST] = {}
        self.in_loop: set[ast.AST] = set()
        self.func_of: dict[ast.AST, ast.AST | None] = {}
        self._walk(tree, False, None)

    def _walk(self, node: ast.AST, loop: bool, func: ast.AST | None) -> None:
        self.func_of[node] = func
        if loop:
            self.in_loop.add(node)
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self._all((node.target, node.iter), loop, func, node)
            self._all(node.body + node.orelse, True, func, node)
        elif isinstance(node, ast.While):
            self._all((node.test,), loop, func, node)
            self._all(node.body + node.orelse, True, func, node)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            first = node.generators[0].iter
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
                self._walk(child, loop or child is not first, func)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda)):
            outer = (list(getattr(node, "decorator_list", []))
                     + list(node.args.defaults)
                     + [d for d in node.args.kw_defaults if d is not None])
            self._all(outer, loop, func, node)
            body = node.body if isinstance(node.body, list) else [node.body]
            self._all([node.args] + body, False, node, node)
        elif isinstance(node, ast.ClassDef):
            self._all(node.decorator_list + node.bases, loop, func, node)
            self._all(node.body, False, func, node)
        else:
            self._all(list(ast.iter_child_nodes(node)), loop, func, node)

    def _all(self, children: Iterable[ast.AST], loop: bool,
             func: ast.AST | None, parent: ast.AST) -> None:
        for child in children:
            self.parents[child] = parent
            self._walk(child, loop, func)


@dataclass
class ModuleContext:
    """What a rule needs of one module: source, tree, import aliases and
    the tree's parent, loop and function maps."""

    path: str
    text: str
    tree: ast.Module
    lines: list[str] = field(default_factory=list)
    import_map: dict[str, str] = field(default_factory=dict)
    has_torch: bool = False
    info: _TreeInfo | None = None
    _taint: "_Taint | None" = None

    @classmethod
    def parse(cls, path: str, text: str) -> "ModuleContext":
        tree = ast.parse(text, filename=path)
        ctx = cls(path=path, text=text, tree=tree, lines=text.splitlines())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    ctx.import_map[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    ctx.import_map[a.asname or a.name] = \
                        f"{node.module}.{a.name}"
        ctx.has_torch = any(m == "torch" or m.startswith("torch.")
                            for m in ctx.import_map.values())
        ctx.info = _TreeInfo(tree)
        return ctx

    def dotted(self, node: ast.AST) -> str | None:
        """``F.embedding`` → ``torch.nn.functional.embedding`` through the
        module's imports; None for anything but a dotted name."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self.import_map.get(node.id, node.id))
        return ".".join(reversed(parts))

    def in_loop(self, node: ast.AST) -> bool:
        return node in self.info.in_loop

    def enclosing_function(self, node: ast.AST) -> ast.AST | None:
        return self.info.func_of.get(node)

    def parent(self, node: ast.AST) -> ast.AST | None:
        return self.info.parents.get(node)

    def taint(self) -> "_Taint":
        """The module's tensor names (``_Taint``), built once."""
        if self._taint is None:
            self._taint = _Taint(self)
        return self._taint


# -- pragmas ------------------------------------------------------------------

@dataclass
class Pragma:
    line: int
    rules: tuple[str, ...]
    reason: str
    standalone: bool          # a comment-only line: covers the next line too
    col: int


def scan_pragmas(lines: list[str]) -> list[Pragma]:
    out = []
    for i, raw in enumerate(lines, start=1):
        m = _PRAGMA_RE.search(raw)
        if m:
            rules = tuple(r.strip() for r in m.group(1).split(",")
                          if r.strip())
            out.append(Pragma(line=i, rules=rules,
                              reason=m.group(2).strip(),
                              standalone=raw.lstrip().startswith("#"),
                              col=m.start() + 1))
    return out


def pragma_findings(path: str, pragmas: list[Pragma]) -> list[Finding]:
    out = []
    for p in pragmas:
        if not p.reason:
            out.append(Finding(
                rule="KO000", severity="error", path=path, line=p.line,
                col=p.col,
                message="lint-ok pragma without a reason: a suppression "
                        "must say why the invariant does not apply here",
                hint="write `# ko: lint-ok[<RULE>] <why this is safe>`"))
        for r in p.rules:
            if r != "*" and r not in RULES:
                out.append(Finding(
                    rule="KO001", severity="warning", path=path,
                    line=p.line, col=p.col,
                    message=f"lint-ok pragma names unknown rule {r!r}",
                    hint=f"the rule ids: {', '.join(RULES)}"))
    return out


_SIMPLE_STMTS = (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Expr,
                 ast.Return, ast.Raise, ast.Assert, ast.Delete)


def apply_pragmas(findings: list[Finding], pragmas: list[Pragma],
                  tree: ast.AST) -> tuple[list[Finding], int]:
    """Drop the findings a pragma covers: its own line, the next line for
    a standalone comment, and the whole of the innermost simple statement
    spanning lines that holds it. KO000 and KO001 are never
    suppressed."""
    extents = [(n.lineno, n.end_lineno) for n in ast.walk(tree)
               if isinstance(n, _SIMPLE_STMTS)
               and getattr(n, "end_lineno", n.lineno) > n.lineno]
    cover: dict[int, set[str]] = {}
    for p in pragmas:
        cover.setdefault(p.line, set()).update(p.rules)
        if p.standalone:
            cover.setdefault(p.line + 1, set()).update(p.rules)
    for line, ids in list(cover.items()):
        spans = [s for s in extents if s[0] <= line <= s[1]]
        if spans:
            a, b = min(spans, key=lambda s: s[1] - s[0])
            for covered in range(a, b + 1):
                cover.setdefault(covered, set()).update(ids)
    kept, suppressed = [], 0
    for f in findings:
        ids = cover.get(f.line, ())
        if f.rule not in ("KO000", "KO001") and (f.rule in ids or "*" in ids):
            suppressed += 1
        else:
            kept.append(f)
    return kept, suppressed


# -- helpers ------------------------------------------------------------------

def _root_name(node: ast.AST) -> str | None:
    """``self._pos`` → "self._pos", ``x[i].y`` → "x": the variable (or
    ``self`` attribute) an expression reads."""
    while isinstance(node, (ast.Subscript, ast.Call)) or (
            isinstance(node, ast.Attribute)
            and not (isinstance(node.value, ast.Name)
                     and node.value.id == "self")):
        node = node.func if isinstance(node, ast.Call) else node.value
    if isinstance(node, ast.Attribute):
        return f"self.{node.attr}"
    return node.id if isinstance(node, ast.Name) else None


def _targets(node: ast.AST) -> Iterator[str]:
    """Names an assignment target binds (``self.x`` as "self.x")."""
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        yield f"self.{node.attr}"
    elif isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _targets(elt)
    elif isinstance(node, ast.Starred):
        yield from _targets(node.value)


#: tensor methods whose result is on the receiver's device
_TENSOR_METHODS = {
    "float", "half", "bfloat16", "long", "int", "bool", "view", "reshape",
    "clone", "detach", "contiguous", "sum", "mean", "amax", "amin", "max",
    "min", "abs", "sqrt", "exp", "log", "argmax", "argmin", "softmax",
    "flatten", "permute", "transpose", "unsqueeze", "squeeze", "expand",
    "repeat", "gather", "index_select", "masked_fill", "clamp", "cumsum",
    "cumprod", "new_zeros", "new_ones", "new_full", "new_empty", "t",
    "matmul", "mm", "bmm", "add", "sub", "mul", "div", "pow", "neg",
    "narrow", "split", "chunk", "unbind", "norm", "prod", "any", "all",
    "type_as", "view_as", "reshape_as", "expand_as", "roll", "flip",
    "sort", "topk", "where", "eq", "ne", "lt", "le", "gt", "ge",
}


#: torch calls whose results are host values, not tensors
_HOST_RESULTS = {"torch.equal", "torch.allclose", "torch.is_tensor",
                 "torch.is_floating_point", "torch.numel", "torch.device",
                 "torch.Generator", "torch.get_num_threads"}
_HOST_PREFIXES = ("torch.cuda.", "torch.distributed.", "torch.backends.",
                  "torch.version.", "torch.profiler.", "torch.utils.")


class _Taint:
    """A cheap notion of "tensor" for one module: names bound from a
    ``torch`` call or from a tensor method of a tensor, per function, and
    ``self`` attributes bound so anywhere in the module. ``device`` holds
    the subset known to live on a device (bound with ``device=``, from a
    device value, or by ``.to(<device>)``/``.cuda()``)."""

    def __init__(self, ctx: ModuleContext):
        self.ctx = ctx
        self.by_func: dict[ast.AST | None, tuple[set, set]] = {}
        self.attrs: tuple[set, set] = (set(), set())
        for _ in range(2):                       # attrs feed functions
            for node in ast.walk(ctx.tree):
                if isinstance(node, (ast.Assign, ast.AnnAssign)) \
                        and node.value is not None:
                    self._bind(node, node.value)

    def _sets(self, func) -> tuple[set, set]:
        return self.by_func.setdefault(func, (set(), set()))

    def _bind(self, node: ast.AST, value: ast.AST) -> None:
        tensor, device = self.kind(value)
        if not tensor:
            return
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        func = self.ctx.enclosing_function(node)
        local = self._sets(func)
        for t in targets:
            for name in _targets(t):
                sets = self.attrs if name.startswith("self.") else local
                sets[0].add(name)
                if device:
                    sets[1].add(name)

    def _known(self, node: ast.AST) -> tuple[bool, bool]:
        name = _root_name(node)
        if name is None:
            return False, False
        func = self.ctx.enclosing_function(node)
        sets = self.attrs if name.startswith("self.") else self._sets(func)
        return name in sets[0], name in sets[1]

    def kind(self, value: ast.AST) -> tuple[bool, bool]:
        """(is a tensor, is known to be on a device) of an expression."""
        if isinstance(value, ast.Call):
            name = self.ctx.dotted(value.func) or ""
            on_dev = any(k.arg == "device" for k in value.keywords)
            if name.startswith("torch.") and name not in _HOST_RESULTS \
                    and not name.startswith(_HOST_PREFIXES):
                return True, on_dev
            if isinstance(value.func, ast.Attribute):
                attr = value.func.attr
                recv = self._known(value.func.value)
                if attr == "cuda" or (attr == "to" and _to_device(
                        self.ctx, value)):
                    return True, True
                if attr in ("cpu", "numpy"):
                    return attr == "cpu", False
                if recv[0] and (attr in _TENSOR_METHODS or attr == "to"):
                    return True, recv[1]
            return False, False
        if isinstance(value, (ast.BinOp, ast.UnaryOp, ast.Compare)):
            parts = ([value.left, value.right] if isinstance(value, ast.BinOp)
                     else [value.operand] if isinstance(value, ast.UnaryOp)
                     else [value.left, *value.comparators])
            kinds = [self.kind(p) for p in parts]
            return (any(k[0] for k in kinds), any(k[1] for k in kinds))
        if isinstance(value, (ast.Subscript, ast.Name, ast.Attribute)):
            return self._known(value)
        return False, False


_DTYPE_WORDS = ("float", "half", "bfloat", "int", "uint", "bool", "long",
                "double", "complex", "dtype", "dt")


def _looks_like_device(ctx: ModuleContext, arg: ast.AST) -> bool:
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value.split(":")[0] in ("cuda", "cpu", "meta")
    if isinstance(arg, ast.Call):
        return (ctx.dotted(arg.func) or "") == "torch.device"
    name = ctx.dotted(arg) or ""
    last = name.rsplit(".", 1)[-1].lower()
    if name.startswith("torch.") and last.startswith(_DTYPE_WORDS):
        return False
    return "dev" in last


def _to_device(ctx: ModuleContext, call: ast.Call) -> bool:
    """A ``.to(...)`` call that names a device (positionally first, or by
    ``device=``), as against a dtype-only cast."""
    if any(k.arg == "device" for k in call.keywords):
        return True
    return bool(call.args) and _looks_like_device(ctx, call.args[0])


# -- the rules ----------------------------------------------------------------

@register
class HostTransferInLoop(Rule):
    """KO101 — a host→device copy inside a loop body: one transfer and one
    launch per iteration."""

    id = "KO101"
    severity = "warning"
    title = "host->device transfer inside a loop"
    hint = ("stack the rows on the host (numpy) and move them once after "
            "the loop, with one torch.as_tensor(..., device=) and one "
            "batched write")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not ctx.has_torch:
            return
        taint = ctx.taint()
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call) and ctx.in_loop(node)):
                continue
            name = ctx.dotted(node.func)
            if name in ("torch.tensor", "torch.as_tensor") and any(
                    k.arg == "device" and not (
                        isinstance(k.value, ast.Constant)
                        and k.value.value == "cpu")
                    for k in node.keywords):
                yield self.finding(
                    ctx, node, f"{name}(..., device=) inside a loop body "
                               f"copies host data to the device once per "
                               f"iteration")
            elif isinstance(node.func, ast.Attribute) and (
                    node.func.attr == "cuda"
                    or (node.func.attr == "to" and _to_device(ctx, node))):
                if taint._known(node.func.value)[1]:
                    continue                    # already on the device
                if node.func.attr == "to" and node.args and isinstance(
                        node.args[0], ast.Constant) \
                        and node.args[0].value == "cpu":
                    continue                    # a device->host move: KO102
                yield self.finding(
                    ctx, node, f".{node.func.attr}(<device>) of a host value "
                               f"inside a loop body is one host->device copy "
                               f"per iteration")


@register
class HostSyncInLoop(Rule):
    """KO102 — a device→host sync inside a loop body: each one blocks the
    host until the device has caught up."""

    id = "KO102"
    severity = "warning"
    title = "device->host sync inside a loop"
    hint = ("read the values once outside the loop (one batched .cpu() "
            "or .tolist()) and index them on the host")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not ctx.has_torch:
            return
        taint = ctx.taint()
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call) and ctx.in_loop(node)):
                continue
            func = node.func
            if isinstance(func, ast.Attribute) and not node.args:
                if func.attr in ("cpu", "numpy"):
                    yield self.finding(
                        ctx, node, f".{func.attr}() inside a loop body "
                                   f"copies a tensor to the host once per "
                                   f"iteration")
                elif func.attr in ("item", "tolist") \
                        and taint.kind(func.value)[0]:
                    yield self.finding(
                        ctx, node, f".{func.attr}() of a tensor inside a "
                                   f"loop body is one blocking read per "
                                   f"iteration")
            elif isinstance(func, ast.Name) and func.id in (
                    "int", "float", "bool") and len(node.args) == 1 \
                    and taint.kind(node.args[0])[0]:
                yield self.finding(
                    ctx, node, f"{func.id}() of a tensor inside a loop body "
                               f"is one blocking read per iteration")


def _defines(cls: ast.ClassDef, name: str) -> bool:
    return any(isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
               and m.name == name for m in cls.body)


def _fn_name(ctx: ModuleContext, node: ast.AST) -> str:
    fn = ctx.enclosing_function(node)
    return getattr(fn, "name", "") if fn is not None else ""


_METADATA = {"shape", "dtype", "device", "ndim", "numel", "element_size",
             "size", "dim", "is_cuda", "stride"}


def _pool_base(expr: ast.AST) -> tuple[str | None, int]:
    """(name holding "pool", subscripts applied after it) of a subscript
    chain, e.g. ``self._pools[i][0][idx]`` → ("_pools", 3)."""
    depth = 0
    while isinstance(expr, (ast.Subscript, ast.Attribute)):
        if isinstance(expr, ast.Attribute):
            if "pool" in expr.attr.lower():
                return expr.attr, depth
            if expr.attr in _METADATA:
                return None, 0          # ``pool.shape[2]``: no element
        else:
            depth += 1
        expr = expr.value
    if isinstance(expr, ast.Name) and "pool" in expr.id.lower():
        return expr.id, depth
    return None, depth


def _pool_tensor_access(expr: ast.AST) -> str | None:
    """The pool buffer a subscript chain reaches into, if it indexes the
    buffer's elements: one subscript of a tensor name ("pool", "k_pool"),
    three of the per-layer list ``_pools`` (layer, then K/V, then
    pages)."""
    name, depth = _pool_base(expr)
    if name is None:
        return None
    need = 3 if name.lower().endswith("pools") else 1
    return name if depth >= need else None


_INPLACE_WRITES = {"index_put_", "index_copy_", "scatter_", "copy_",
                   "index_fill_", "masked_scatter_", "fill_", "zero_"}


@register
class PagedPoolWriteBypass(Rule):
    """KO121 — in an engine that defines ``_page_write``, an in-place
    write of a pool buffer anywhere but ``_page_write``/``_page_copy``
    skips the (slot, position) → (page, offset) translation: a raw write
    lands in whichever request owns that page."""

    id = "KO121"
    severity = "error"
    title = "page-table write discipline"
    hint = ("route the write through _page_write(pool, pages, offsets, "
            "vals) or _page_copy(pool, dst, src)")
    _ALLOWED = {"_page_write", "_page_copy"}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not ctx.has_torch:
            return
        for cls in ast.walk(ctx.tree):
            if not (isinstance(cls, ast.ClassDef)
                    and _defines(cls, "_page_write")):
                continue
            for node in ast.walk(cls):
                if _fn_name(ctx, node) in self._ALLOWED:
                    continue
                base = None
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    tgts = (node.targets if isinstance(node, ast.Assign)
                            else [node.target])
                    base = next((b for t in tgts
                                 if isinstance(t, ast.Subscript)
                                 for b in [_pool_tensor_access(t)]
                                 if b), None)
                elif isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _INPLACE_WRITES:
                    recv = node.func.value
                    b, depth = _pool_base(recv)
                    if b is not None and depth >= (
                            2 if b.lower().endswith("pools") else 0):
                        base = b
                if base is not None:
                    yield self.finding(
                        ctx, node, f"in-place write of paged pool buffer "
                                   f"'{base}' outside _page_write/"
                                   f"_page_copy: it skips the block "
                                   f"table's (page, offset) translation")


@register
class PagedPoolReadBypass(Rule):
    """KO122 — in an engine that defines ``_gather_kv``, a subscript read
    of a pool buffer anywhere but the pool's helpers: a quantized pool
    holds raw int8/fp8 codes, and the read skips their scales."""

    id = "KO122"
    severity = "error"
    title = "page-pool read discipline"
    hint = ("read through _gather_kv(pool, scale, idx); raw page moves "
            "belong in _page_copy/_page_export")
    _ALLOWED = {"_gather_kv", "_page_write", "_page_copy", "_page_export"}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not ctx.has_torch:
            return
        for cls in ast.walk(ctx.tree):
            if not (isinstance(cls, ast.ClassDef)
                    and _defines(cls, "_gather_kv")):
                continue
            for node in ast.walk(cls):
                if not (isinstance(node, ast.Subscript)
                        and isinstance(node.ctx, ast.Load)):
                    continue
                parent = ctx.parent(node)
                if isinstance(parent, ast.Subscript) and parent.value is node:
                    continue                    # the outer subscript reports
                if isinstance(parent, ast.Attribute) \
                        and parent.attr in _METADATA:
                    continue                    # .shape etc.: no data read
                if _fn_name(ctx, node) in self._ALLOWED:
                    continue
                base = _pool_tensor_access(node)
                if base is not None:
                    yield self.finding(
                        ctx, node, f"subscript read of paged pool buffer "
                                   f"'{base}' outside _gather_kv: on a "
                                   f"quantized pool it reads codes without "
                                   f"their scales")


def _bt_name(name: str) -> bool:
    n = name.lower()
    return (n.lstrip("_") in ("bt", "dbt", "bt_np", "dbt_np")
            or "block_table" in n)


def _clamps(expr: ast.AST) -> bool:
    """A ``minimum`` call or a ``clamp``/``clamp_`` with ``max=`` (or
    ``clamp_max``) anywhere in ``expr``."""
    for node in ast.walk(expr):
        if not isinstance(node, ast.Call):
            continue
        name = (node.func.attr if isinstance(node.func, ast.Attribute)
                else node.func.id if isinstance(node.func, ast.Name) else "")
        if name in ("minimum", "clamp_max", "clamp_max_"):
            return True
        if name in ("clamp", "clamp_") and (
                len(node.args) >= 2
                or any(k.arg == "max" for k in node.keywords)):
            return True
    return False


def _pos_named(node: ast.AST) -> bool:
    name = _root_name(node) or ""
    return "pos" in name.rsplit(".", 1)[-1].lower()


@register
class RewindBypass(Rule):
    """KO123 — in an engine that defines ``_rewind``, rollback has two
    legal moves: positions roll back through ``_rewind``, and speculative
    tail pages are reclaimed by block-table truncation on the release and
    admission paths. A block-table write elsewhere, or an inline clamp of
    a position vector, can leave a row's position above the KV its pages
    hold."""

    id = "KO123"
    severity = "error"
    title = "rewind discipline"
    hint = ("roll positions back through _rewind(...) and truncate block "
            "tables in release/_plan_entries/_push_block_tables only")
    _ALLOWED = {"_rewind", "release", "_plan_entries", "_push_block_tables",
                "__init__"}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not ctx.has_torch:
            return
        for cls in ast.walk(ctx.tree):
            if not (isinstance(cls, ast.ClassDef)
                    and _defines(cls, "_rewind")):
                continue
            for node in ast.walk(cls):
                if _fn_name(ctx, node) in self._ALLOWED:
                    continue
                if isinstance(node, ast.Subscript) \
                        and isinstance(node.ctx, ast.Store):
                    name = _root_name(node.value) or ""
                    if _bt_name(name.rsplit(".", 1)[-1]):
                        yield self.finding(
                            ctx, node, f"block table '{name}' written "
                                       f"outside the truncation paths: any "
                                       f"other write desyncs the table from "
                                       f"the allocator")
                        continue
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _INPLACE_WRITES:
                    name = _root_name(node.func.value) or ""
                    if _bt_name(name.rsplit(".", 1)[-1]):
                        yield self.finding(
                            ctx, node, f".{node.func.attr} on block table "
                                       f"'{name}' outside the truncation "
                                       f"paths")
                        continue
                    if _pos_named(node.func.value) and any(
                            _clamps(a) for a in node.args):
                        yield self.finding(
                            ctx, node, "position vector clamped inline "
                                       "(a minimum/clamp written into a "
                                       "pos-named tensor): roll back "
                                       "through _rewind")
                elif isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in ("clamp_", "clamp_max_") \
                        and _pos_named(node.func.value) and _clamps(node):
                    yield self.finding(
                        ctx, node, "position vector clamped in place: roll "
                                   "back through _rewind")
                elif isinstance(node, (ast.Assign, ast.AugAssign)):
                    tgts = (node.targets if isinstance(node, ast.Assign)
                            else [node.target])
                    if any(_pos_named(t) for t in tgts) \
                            and _clamps(node.value):
                        yield self.finding(
                            ctx, node, "position vector clamped inline "
                                       "(a minimum/clamp assigned to a "
                                       "pos-named target): roll back "
                                       "through _rewind")


# -- the engine ---------------------------------------------------------------

@dataclass
class LintResult:
    findings: list[Finding]
    suppressed: int
    files: int

    def counts(self) -> dict[str, int]:
        out = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            out[f.severity] += 1
        return out

    def failing(self) -> list[Finding]:
        """The findings at ``warning`` or above: the gate."""
        return [f for f in self.findings
                if _SEV_ORDER[f.severity] >= _SEV_ORDER["warning"]]

    def to_json(self) -> str:
        return json.dumps({"version": 1, "files": self.files,
                           "counts": self.counts(),
                           "suppressed": self.suppressed,
                           "findings": [f.to_dict() for f in self.findings]},
                          indent=2)


def lint_source(path: str, text: str) -> tuple[list[Finding], int]:
    """Every rule over one module's source, then its pragmas: (findings,
    the number suppressed). A file that does not parse is one KO002
    finding."""
    try:
        ctx = ModuleContext.parse(path, text)
    except SyntaxError as e:
        return [Finding(rule="KO002", severity="error", path=path,
                        line=e.lineno or 1, col=(e.offset or 0) + 1,
                        message=f"syntax error: {e.msg}")], 0
    findings = [f for rule in RULES.values() for f in rule.check(ctx)]
    pragmas = scan_pragmas(ctx.lines)
    findings += pragma_findings(path, pragmas)
    return apply_pragmas(findings, pragmas, ctx.tree)


def _iter_files(paths: Iterable[str]) -> Iterator[str]:
    for path in paths:
        if os.path.isfile(path):
            yield path
            continue
        for base, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in SKIP_DIRS)
            for name in sorted(files):
                if name.endswith(".py"):
                    yield os.path.join(base, name)


def lint_paths(paths: Iterable[str]) -> LintResult:
    """Lint every ``.py`` file under ``paths``."""
    findings: list[Finding] = []
    suppressed = files = 0
    for path in _iter_files(paths):
        files += 1
        found, supp = lint_source(path, Path(path).read_text(
            encoding="utf-8", errors="replace"))
        findings += found
        suppressed += supp
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return LintResult(findings=findings, suppressed=suppressed, files=files)


def default_paths() -> list[str]:
    """The port package and ``chip_smoke.py`` beside it."""
    root = Path(__file__).resolve().parents[2]
    return [str(root / "kubeoperator_tpu_torch"),
            str(root / "chip_smoke.py")]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kubeoperator_tpu_torch.analysis.lint",
        description="hot-path lint of the PyTorch port (KO101, KO102, "
                    "KO121-KO123)")
    ap.add_argument("paths", nargs="*",
                    help="files or directories (default: the port package "
                         "and chip_smoke.py)")
    ap.add_argument("--json", action="store_true", help="JSON report")
    args = ap.parse_args(argv)
    result = lint_paths(args.paths or default_paths())
    if args.json:
        print(result.to_json())
    else:
        for f in result.findings:
            print(f.format())
        c = result.counts()
        print(f"{result.files} files: {c['error']} errors, {c['warning']} "
              f"warnings, {c['info']} info, {result.suppressed} suppressed",
              file=sys.stderr)
    return 1 if result.failing() else 0


if __name__ == "__main__":
    sys.exit(main())
