"""The drone-lint rules of the PyTorch port (DL002, DL005, DL006, DL007).

Three rules carry over from the JAX package's ``repro.analysis.rules`` as
they are, with its severities, messages and columns:

  DL002  cache-key dataclasses (``EngineConfig``, ``ShapePolicy``,
         ``SemiringSweep``, ``VertexProgram`` subclasses — anything flowing
         into ``program_key``/``params_struct_key``) holding unhashable or
         mutable fields: list/dict/set annotations or defaults silently
         break ``RunnerCache`` keying.
  DL006  ``except Exception``/bare ``except`` that swallows the error:
         no re-raise, no logging, no use of the bound exception. Narrow the
         type and log at debug level, or annotate deliberate suppressions.
  DL007  raw ``cfg.edge_backend`` reads outside the engine's resolution
         layer. Since ``edge_backend='auto'`` the stored value may not name
         a backend a sweep can execute on — dispatching or cache-keying on
         it mis-handles 'auto'. Consume the field through
         ``resolve_edge_backend``/``resolve_partition_backends``/
         ``normalize_edge_backend`` only.

One is rewritten for the port's kernel wrappers:

  DL005  a CUDA kernel's launch unit without a dtype guard, or filling with
         a numeric literal. The port has no ``pallas_call``: a *launcher*
         is a function that passes tensors' ``.data_ptr()`` to a foreign
         (``ctypes``) entry. Its unit is every public module-level function
         that reaches it through the module's own functions (the wrapper a
         caller uses), with everything that wrapper reaches (the launcher,
         the plain version, the checks). Each such wrapper must make a
         dtype guard — an ``if``/``assert``/``raise`` that reads ``.dtype``
         — in its own body or in a module-level helper it calls, because a
         kernel handed the wrong dtype reads garbage rather than fails; and
         no ``torch.full``/``full_like``/``new_full``/``F.pad(value=)`` in
         the unit may fill with a numeric literal: fills come from
         ``tile_pad_identity``/``combine_identity``/``semiring_identity``
         (a 0-fill is wrong for min_plus). Index sentinels in modules
         without a launcher (the chunk plan's ``-1`` slots) are out of its
         scope.

DL001, DL003 and DL004 have no counterpart. They guard jax's tracing —
device arrays captured by a ``jit``/``shard_map``/``pallas_call`` closure,
``shard_map`` spec arity, Python branches on traced values — and eager
PyTorch traces nothing: a runner is a Python function over tensors, its
branches read concrete values, and ``torch.distributed`` takes no specs.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

from repro_torch.analysis.core import Finding, rule


def _qualname(node: ast.AST) -> Optional[str]:
    """Dotted name of a Name/Attribute chain, e.g. ``torch.full``."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# --------------------------------------------------------------------- #
#: dataclasses whose instances flow into RunnerCache keys
_KEY_DATACLASS_NAMES = {"EngineConfig", "ShapePolicy", "SemiringSweep",
                        "VertexProgram"}
_MUTABLE_ANNOS = {"list", "List", "dict", "Dict", "set", "Set",
                  "bytearray", "ndarray", "Array"}
_MUTABLE_CTORS = {"list", "dict", "set", "bytearray"}


def _dataclass_deco(cls: ast.ClassDef) -> Optional[ast.AST]:
    for dec in cls.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        q = _qualname(target) or ""
        if q.split(".")[-1] == "dataclass":
            return dec
    return None


def _is_frozen(dec: ast.AST) -> bool:
    if isinstance(dec, ast.Call):
        for kw in dec.keywords:
            if kw.arg == "frozen" and isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
    return False


def _anno_head(anno: ast.AST) -> Optional[str]:
    if isinstance(anno, ast.Subscript):
        anno = anno.value
    q = _qualname(anno)
    return q.split(".")[-1] if q else None


@rule("DL002", "error",
      "mutable/unhashable field on a cache-key dataclass")
def check_cache_key_fields(tree, src, path) -> Iterator[Finding]:
    """Frozen dataclasses, the named key dataclasses (``EngineConfig``,
    ``ShapePolicy``, ``SemiringSweep``, ``VertexProgram``), and
    ``VertexProgram`` subclasses all flow into ``program_key`` /
    ``RunnerCache`` keys and must stay hashable: no list/dict/set/ndarray
    annotations, no mutable defaults or default_factories. ``ClassVar``
    and ``Sequence``/``tuple`` annotations are fine."""
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        dec = _dataclass_deco(cls)
        if dec is None:
            continue
        base_names = {_qualname(b) or "" for b in cls.bases}
        base_tails = {b.split(".")[-1] for b in base_names}
        is_key = (_is_frozen(dec)
                  or cls.name in _KEY_DATACLASS_NAMES
                  or bool(base_tails & _KEY_DATACLASS_NAMES))
        if not is_key:
            continue
        for stmt in cls.body:
            if not isinstance(stmt, ast.AnnAssign) or \
                    not isinstance(stmt.target, ast.Name):
                continue
            head = _anno_head(stmt.annotation)
            if head == "ClassVar":
                continue
            fname = stmt.target.id
            if head in _MUTABLE_ANNOS:
                yield Finding(
                    rule="", path=path, line=stmt.lineno,
                    col=stmt.col_offset,
                    message=(f"cache-key dataclass `{cls.name}` field "
                             f"`{fname}` has unhashable annotation "
                             f"`{head}`; use a tuple/frozen type"))
                continue
            default = stmt.value
            if default is None:
                continue
            bad = None
            if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                bad = type(default).__name__.lower() + " literal"
            elif isinstance(default, ast.Call):
                q = _qualname(default.func) or ""
                tail = q.split(".")[-1]
                if tail in _MUTABLE_CTORS:
                    bad = f"{tail}() call"
                elif tail == "field":
                    for kw in default.keywords:
                        if kw.arg != "default_factory":
                            continue
                        fq = (_qualname(kw.value) or "").split(".")[-1]
                        if fq in _MUTABLE_CTORS or \
                                isinstance(kw.value, ast.Lambda):
                            bad = f"default_factory={fq or 'lambda'}"
            if bad:
                yield Finding(
                    rule="", path=path, line=stmt.lineno,
                    col=stmt.col_offset,
                    message=(f"cache-key dataclass `{cls.name}` field "
                             f"`{fname}` has mutable default ({bad}); "
                             f"cache keys must be hashable and immutable"))


# --------------------------------------------------------------------- #
#: tensor constructors whose second positional argument (or
#: ``fill_value=``) is the fill
_FILL_CALLS = {"full", "full_like", "new_full"}


def _module_functions(tree: ast.AST) -> Dict[str, ast.FunctionDef]:
    """name -> def of every function at module level."""
    return {n.name: n for n in getattr(tree, "body", [])
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _is_launcher(fn: ast.AST) -> bool:
    """A function that passes ``x.data_ptr()`` as a call argument: the
    port's launch of a ``ctypes`` kernel entry."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        for a in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(a, ast.Call) and \
                    isinstance(a.func, ast.Attribute) and \
                    a.func.attr == "data_ptr":
                return True
    return False


def _callees(fn: ast.AST, defs: Dict[str, ast.AST]) -> Set[str]:
    """Module-level functions ``fn`` calls by name."""
    return {n.func.id for n in ast.walk(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
            and n.func.id in defs}


def _reach(name: str, defs: Dict[str, ast.AST]) -> Set[str]:
    """``name`` and every module-level function it reaches."""
    seen: Set[str] = set()
    todo = [name]
    while todo:
        n = todo.pop()
        if n in seen:
            continue
        seen.add(n)
        todo += sorted(_callees(defs[n], defs) - seen)
    return seen


def _has_dtype_guard(fn: ast.AST) -> bool:
    """An ``if``/``assert``/``raise`` in ``fn`` that reads ``.dtype``."""
    for node in ast.walk(fn):
        if isinstance(node, (ast.If, ast.Assert, ast.Raise)):
            test = node.test if isinstance(node, (ast.If, ast.Assert)) \
                else node
            if any(isinstance(sub, ast.Attribute) and sub.attr == "dtype"
                   for sub in ast.walk(test)):
                return True
    return False


def _fill_arg(call: ast.Call) -> Optional[ast.AST]:
    """The fill value of a ``full``/``full_like``/``new_full``/``pad``."""
    tail = (_qualname(call.func) or "").split(".")[-1]
    if tail in _FILL_CALLS:
        for kw in call.keywords:
            if kw.arg == "fill_value":
                return kw.value
        return call.args[1] if len(call.args) >= 2 else None
    if tail == "pad":
        for kw in call.keywords:
            if kw.arg == "value":
                return kw.value
        return call.args[3] if len(call.args) >= 4 else None
    return None


def _numeric_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.UnaryOp):
        node = node.operand
    return isinstance(node, ast.Constant) and \
        isinstance(node.value, (int, float)) and \
        not isinstance(node.value, bool)


@rule("DL005", "error",
      "CUDA kernel launch unit without dtype guard or identity fills")
def check_kernel_contract(tree, src, path) -> Iterator[Finding]:
    """A function passing ``.data_ptr()`` to a call launches a CUDA kernel.
    Every public module-level function reaching it (or the launcher
    itself, when no public function does) must make a dtype guard — an
    ``if``/``assert``/``raise`` reading ``.dtype`` — in its own body or in
    a module-level helper it calls directly; and no function of that
    unit may fill a tensor with a numeric literal (``torch.full``/
    ``full_like``/``new_full``/``F.pad(value=)``): fills must come from
    ``tile_pad_identity``/``combine_identity``/``semiring_identity`` so
    min/max semirings keep their identity (a 0-fill corrupts min_plus)."""
    defs = _module_functions(tree)
    launchers = {n for n, fn in defs.items() if _is_launcher(fn)}
    if not launchers:
        return
    reach = {n: _reach(n, defs) for n in defs}
    wrappers = sorted(n for n in defs if not n.startswith("_")
                      and reach[n] & launchers)
    orphans = sorted(n for n in launchers
                     if not any(n in reach[w] for w in wrappers))
    unit: Set[str] = set()
    for w in wrappers + orphans:
        unit |= reach[w]
        fn = defs[w]
        helpers = [defs[c] for c in sorted(_callees(fn, defs))]
        if not any(_has_dtype_guard(f) for f in [fn] + helpers):
            via = ", ".join(f"`{n}`" for n in sorted(reach[w] & launchers))
            yield Finding(
                rule="", path=path, line=fn.lineno, col=fn.col_offset,
                message=(f"kernel wrapper `{w}` reaches launcher {via} "
                         f"without a dtype guard (if/assert/raise on "
                         f"`.dtype`, in it or in a module-level helper it "
                         f"calls)"))
    for name in sorted(unit, key=lambda n: defs[n].lineno):
        for node in ast.walk(defs[name]):
            if not isinstance(node, ast.Call):
                continue
            fill = _fill_arg(node)
            if fill is not None and _numeric_literal(fill):
                yield Finding(
                    rule="", path=path, line=node.lineno,
                    col=node.col_offset,
                    message=(f"kernel unit function `{name}` fills with "
                             f"numeric literal {ast.unparse(fill)}; use "
                             f"tile_pad_identity/combine_identity/"
                             f"semiring_identity"))


# --------------------------------------------------------------------- #
_LOG_CALL_ATTRS = {"debug", "info", "warning", "warn", "error", "exception",
                   "critical", "log", "set_exception"}


def _handler_is_silent(handler: ast.ExceptHandler) -> bool:
    """True when the handler neither re-raises, logs, nor uses the caught
    exception — i.e. the error vanishes."""
    bound = handler.name
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return False
        if isinstance(node, ast.Call):
            q = _qualname(node.func) or ""
            parts = q.split(".")
            if parts[-1] in _LOG_CALL_ATTRS:
                return False
            if parts[0] in ("warnings", "logging", "traceback"):
                return False
        if bound and isinstance(node, ast.Name) and node.id == bound and \
                isinstance(node.ctx, ast.Load):
            return False
    return True


#: the engine's sanctioned ``cfg.edge_backend`` consumers — the resolution
#: layer itself, plus the config's own construction-time validation
_EB_RESOLVERS = {"resolve_edge_backend", "resolve_partition_backends",
                 "normalize_edge_backend", "__post_init__"}


@rule("DL007", "error",
      "raw cfg.edge_backend read outside the resolution layer")
def check_raw_edge_backend(tree, src, path) -> Iterator[Finding]:
    """``EngineConfig.edge_backend`` may hold ``'auto'``, which no sweep can
    execute on — it resolves to a concrete per-partition backend only
    through the engine's resolution layer. Any other code branching or
    keying on the raw field treats 'auto' as a concrete backend and
    silently mis-dispatches (or splits cache keys that should dedupe).
    Flags ``Load`` reads of ``.edge_backend`` on a receiver named ``cfg``/
    ``config`` (``self.cfg`` included) outside the resolver functions."""

    def visit(node, fname) -> Iterator[Finding]:
        for child in ast.iter_child_nodes(node):
            inner = fname
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = child.name
            elif isinstance(child, ast.Attribute) and \
                    child.attr == "edge_backend" and \
                    isinstance(child.ctx, ast.Load) and \
                    fname not in _EB_RESOLVERS:
                recv = (_qualname(child.value) or "").split(".")[-1]
                if recv in ("cfg", "config"):
                    what = _qualname(child) or "cfg.edge_backend"
                    yield Finding(
                        rule="", path=path, line=child.lineno,
                        col=child.col_offset,
                        message=(f"raw `{what}` "
                                 f"read in `{fname}`: the field may hold "
                                 f"'auto'; go through resolve_edge_backend/"
                                 f"resolve_partition_backends/"
                                 f"normalize_edge_backend"))
            yield from visit(child, inner)

    yield from visit(tree, "<module>")


# --------------------------------------------------------------------- #
@rule("DL006", "warning",
      "broad except swallows the error silently")
def check_silent_handler(tree, src, path) -> Iterator[Finding]:
    """``except Exception``/bare ``except`` whose body neither re-raises,
    logs, nor touches the bound exception hides real failures (the
    ``runner_nbytes``/``get_abstract_mesh`` pattern this rule was written
    for). Catch the narrow expected type and log at debug level;
    ``# pragma: no cover`` paths are exempt."""
    lines = src.splitlines()

    def broad(tnode: Optional[ast.AST]) -> bool:
        if tnode is None:
            return True
        names = [tnode] if not isinstance(tnode, ast.Tuple) else tnode.elts
        for n in names:
            q = (_qualname(n) or "").split(".")[-1]
            if q in ("Exception", "BaseException"):
                return True
        return False

    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        for handler in node.handlers:
            if not broad(handler.type):
                continue
            hl = handler.lineno
            nearby = lines[max(0, hl - 2):hl + 1]
            if any("pragma: no cover" in ln for ln in nearby):
                continue
            if _handler_is_silent(handler):
                what = "bare except" if handler.type is None else \
                    "except Exception"
                yield Finding(
                    rule="", path=path, line=hl, col=handler.col_offset,
                    message=(f"{what} swallows the error (no raise/log/use "
                             f"of the exception); narrow the type and log "
                             f"at debug level"))
