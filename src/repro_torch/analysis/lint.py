"""Layer-1 static lint: AST passes over the coroutine runtime and the cache
hierarchy.  NOTHING here imports the checked code — every rule works on the
parse tree alone, so the lint runs in CI even when the runtime's own imports
(torch, numpy) are broken, and a rule can never be fooled by monkeypatching.

Rules (each Finding carries the rule name and fires at ``file:line``):

  op-unknown      a ``yield ("name", ...)`` names an op the registry does not
                  declare (only in modules that speak the protocol — i.e.
                  that yield at least one registered op)
  op-arity        a yielded op tuple carries the wrong operand count
  op-dispatch     a dispatcher (a function comparing one variable against two
                  or more registered op names) misses registered ops, or
                  matches names that are neither ops nor scheduler event kinds
  begin-load-pairing
                  a ``begin_load`` call is not matched by a window closer
                  (``finish_load`` / ``abort_load`` / an admit) on every
                  control-flow path of its function
  publish-in-locked
                  an ``on_publish`` hook fires while the most recent slot
                  state written in the function is LOCKED (or before any
                  published state was established at all)
  blocking-call-in-coroutine
                  a module-level search coroutine (generator function outside
                  any class) calls a blocking pool/cache method directly
                  instead of yielding an engine op / going through an accessor
  wall-clock      ``time.time()``-style calls in ``repro_torch.core`` sim
                  paths
  unseeded-rng    ``np.random.<legacy>`` / zero-arg ``default_rng()`` /
                  stdlib ``random`` calls, and torch's global generator
                  (``torch.rand`` / ``randn`` / ``randint`` / ``randperm`` /
                  ``normal`` / ``bernoulli`` without ``generator=``, and
                  ``torch.manual_seed``) in ``repro_torch.core`` sim paths
  set-iteration   a ``for`` loop over a set-typed local in
                  ``repro_torch.core`` (iteration order is
                  implementation-defined; use a dict or sort first)

The path-scoped rules (coroutine purity and the three determinism rules)
key on ``repro_torch/core`` in the file name: this package's simulator
proper.

Path-sensitivity of ``begin-load-pairing`` is deliberately lenient, with the
leniencies DOCUMENTED as part of the rule:

  1. a nested ``def`` that closes anywhere counts as closing at its def site
     (the completion-callback pattern: the closure runs when the I/O lands);
  2. a loop whose body closes counts as closing (the batch pattern: one
     closer per opened window, e.g. ``for v in missing: ... finish/admit``);
  3. closing is transitive through same-module helpers (a function whose own
     body always calls a closer is itself a closer — fixpoint);
  4. a ``begin_load`` whose enclosing statement is a ``return`` is pure
     delegation (a namespace-translating view), exempt from pairing;
  5. ``raise`` terminates a path acceptably (the window is torn down by the
     failing test/scenario, not leaked by the protocol).
"""

from __future__ import annotations

import ast
import dataclasses
import os

from repro_torch.analysis.registry import (
    BLOCKING_POOL_METHODS,
    ENGINE_OPS,
    EVENT_KINDS,
    WINDOW_CLOSERS,
)

_WALL_CLOCK_CALLS = frozenset({
    "time.time", "time.time_ns", "time.clock",
    "time.perf_counter", "time.perf_counter_ns",
    "time.monotonic", "time.monotonic_ns", "time.process_time",
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow", "date.today",
})

# torch's sampling functions that draw from the process-wide generator
# unless handed an explicit ``generator=`` (this package's idiom)
_TORCH_SAMPLERS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
})


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# ------------------------------------------------------------- tree helpers


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _terminal_name(node: ast.AST) -> str | None:
    """Last component of a Name/Attribute chain (``SlotState.LOCKED`` ->
    ``LOCKED``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _own_scope(fn: ast.AST):
    """The nodes of a function's own scope, excluding nested function defs.
    Yields in source (pre)order — the set-iteration rule's rebinding tracking
    depends on seeing assignments in the order they execute."""
    stack = list(ast.iter_child_nodes(fn))[::-1]
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(list(ast.iter_child_nodes(node))[::-1])


def _is_generator(fn: ast.AST) -> bool:
    return any(isinstance(n, (ast.Yield, ast.YieldFrom))
               for n in _own_scope(fn))


def _functions(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _is_core_path(path: str) -> bool:
    """The determinism rules apply to the simulator proper: this package's
    ``repro_torch/core``."""
    norm = path.replace(os.sep, "/")
    return "repro_torch/core" in norm


# ------------------------------------------------------------ op registry


def _rule_op_registry(tree: ast.AST, path: str) -> list[Finding]:
    findings: list[Finding] = []
    sites: list[tuple[ast.Tuple, str]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Yield) or not isinstance(node.value,
                                                             ast.Tuple):
            continue
        elts = node.value.elts
        if elts and isinstance(elts[0], ast.Constant) and isinstance(
            elts[0].value, str
        ):
            sites.append((node.value, elts[0].value))
    speaks_protocol = any(name in ENGINE_OPS for _, name in sites)
    for tup, name in sites:
        spec = ENGINE_OPS.get(name)
        if spec is None:
            if speaks_protocol:
                findings.append(Finding(
                    path, tup.lineno, "op-unknown",
                    f"yielded op {name!r} is not in the engine-op registry "
                    f"(known: {', '.join(sorted(ENGINE_OPS))})",
                ))
            continue
        arity = len(tup.elts) - 1
        if arity != spec.arity:
            findings.append(Finding(
                path, tup.lineno, "op-arity",
                f"op {name!r} yielded with {arity} operand(s), registry "
                f"declares {spec.arity}",
            ))
    return findings


def _rule_op_dispatch(tree: ast.AST, path: str) -> list[Finding]:
    findings: list[Finding] = []
    for fn in _functions(tree):
        compared: dict[str, set[str]] = {}
        first_line: dict[str, int] = {}
        for node in _own_scope(fn):
            if not isinstance(node, ast.Compare) or len(node.ops) != 1:
                continue
            if not isinstance(node.ops[0], (ast.Eq, ast.NotEq)):
                continue
            left, right = node.left, node.comparators[0]
            for var, const in ((left, right), (right, left)):
                if (isinstance(var, ast.Name)
                        and isinstance(const, ast.Constant)
                        and isinstance(const.value, str)):
                    compared.setdefault(var.id, set()).add(const.value)
                    first_line.setdefault(var.id, node.lineno)
        for var, names in compared.items():
            ops_seen = names & set(ENGINE_OPS)
            if len(ops_seen) < 2:
                continue  # not an op dispatcher (e.g. event-kind switches)
            missing = set(ENGINE_OPS) - names
            if missing:
                findings.append(Finding(
                    path, first_line[var], "op-dispatch",
                    f"dispatcher {fn.name!r} (on {var!r}) does not handle "
                    f"registered op(s): {', '.join(sorted(missing))}",
                ))
            extras = names - set(ENGINE_OPS) - EVENT_KINDS
            if extras:
                findings.append(Finding(
                    path, first_line[var], "op-dispatch",
                    f"dispatcher {fn.name!r} (on {var!r}) matches name(s) "
                    f"that are neither registered ops nor event kinds: "
                    f"{', '.join(sorted(extras))}",
                ))
    return findings


# --------------------------------------------------------- window pairing


def _transitive_closers(tree: ast.AST) -> set[str]:
    """Module function names whose body always reaches a window closer —
    fixpoint over same-module calls (leniency 3)."""
    bodies = {fn.name: fn for fn in _functions(tree)}
    closers: set[str] = set()

    def body_closes(fn: ast.AST, known: set[str]) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in (WINDOW_CLOSERS | known)):
                    return True
                if isinstance(node.func, ast.Name) and node.func.id in known:
                    return True
        return False

    changed = True
    while changed:
        changed = False
        for name, fn in bodies.items():
            if name not in closers and body_closes(fn, closers):
                closers.add(name)
                changed = True
    return closers


def _contains_closer(node: ast.AST, closers: set[str]) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            if (isinstance(n.func, ast.Attribute)
                    and n.func.attr in (WINDOW_CLOSERS | closers)):
                return True
            if isinstance(n.func, ast.Name) and n.func.id in closers:
                return True
    return False


def _closes_seq(stmts: list[ast.stmt], closers: set[str]) -> bool:
    """Does every control-flow path through ``stmts`` reach a closer?"""
    for i, st in enumerate(stmts):
        rest = stmts[i + 1:]
        if isinstance(st, ast.Return):
            return st.value is not None and _contains_closer(st.value, closers)
        if isinstance(st, ast.Raise):
            return True  # leniency 5
        if isinstance(st, ast.If):
            return (_closes_seq(st.body + rest, closers)
                    and _closes_seq(st.orelse + rest, closers))
        if isinstance(st, (ast.For, ast.While)):
            if _closes_seq(st.body, closers):
                return True  # leniency 2: the batch-closing loop
            continue  # zero-iteration path: keep scanning
        if isinstance(st, ast.Try):
            return _closes_seq(st.body + st.finalbody + rest, closers)
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _contains_closer(st, closers):
                return True  # leniency 1: the completion-callback pattern
            continue
        if _contains_closer(st, closers):
            return True
    return False


def _path_closes_after(stmts: list[ast.stmt], tail: list[ast.stmt],
                       call: ast.Call, closers: set[str]) -> bool | None:
    """Locate ``call`` inside ``stmts`` and decide whether every path from
    just after it (continuing into ``tail``) reaches a closer.  None when the
    call is not in this block."""
    for i, st in enumerate(stmts):
        if not any(n is call for n in ast.walk(st)):
            continue
        rest = stmts[i + 1:] + tail
        for block_name in ("body", "orelse", "finalbody"):
            block = getattr(st, block_name, None)
            if block:
                r = _path_closes_after(block, rest, call, closers)
                if r is not None:
                    return r
        return _closes_seq(rest, closers)
    return None


def _rule_begin_load_pairing(tree: ast.AST, path: str) -> list[Finding]:
    findings: list[Finding] = []
    closers = _transitive_closers(tree)
    for fn in _functions(tree):
        for node in _own_scope(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "begin_load"):
                continue
            # leniency 4: `return x.begin_load(...)` is pure delegation
            delegated = any(
                isinstance(st, ast.Return)
                and st.value is not None
                and any(n is node for n in ast.walk(st.value))
                for st in ast.walk(fn) if isinstance(st, ast.Return)
            )
            if delegated:
                continue
            closed = _path_closes_after(fn.body, [], node, closers)
            if closed is not True:
                findings.append(Finding(
                    path, node.lineno, "begin-load-pairing",
                    f"begin_load in {fn.name!r} is not matched by "
                    f"finish_load/abort_load/admit on every control-flow "
                    f"path",
                ))
    return findings


def _rule_publish_in_locked(tree: ast.AST, path: str) -> list[Finding]:
    findings: list[Finding] = []
    for fn in _functions(tree):
        state_writes: list[tuple[int, str | None]] = []
        hook_calls: list[ast.Call] = []
        for node in _own_scope(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Subscript)
                    and _terminal_name(node.targets[0].value) == "state"):
                state_writes.append((node.lineno,
                                     _terminal_name(node.value)))
            elif (isinstance(node, ast.Call)
                  and _terminal_name(node.func) == "on_publish"):
                hook_calls.append(node)
        if not hook_calls:
            continue
        state_writes.sort()
        for call in hook_calls:
            prior = [st for line, st in state_writes if line < call.lineno]
            if not prior:
                findings.append(Finding(
                    path, call.lineno, "publish-in-locked",
                    f"on_publish fires in {fn.name!r} before any slot state "
                    f"was established as published",
                ))
            elif prior[-1] == "LOCKED":
                findings.append(Finding(
                    path, call.lineno, "publish-in-locked",
                    f"on_publish fires in {fn.name!r} while the most recent "
                    f"slot state written is LOCKED (open window)",
                ))
    return findings


# ------------------------------------------------------- coroutine purity


def _rule_coroutine_purity(tree: ast.AST, path: str) -> list[Finding]:
    """Module-level search coroutines must talk to the pool/cache through an
    accessor or an engine op — never by calling blocking methods directly.
    Accessor METHODS (functions inside a class) are the allowed layer."""
    if not _is_core_path(path):
        return []
    findings: list[Finding] = []
    class_fns: set[ast.AST] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for fn in ast.walk(node):
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    class_fns.add(fn)
    for fn in _functions(tree):
        if fn in class_fns or not _is_generator(fn):
            continue
        for node in ast.walk(fn):  # whole subtree: nested helpers included
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in BLOCKING_POOL_METHODS):
                findings.append(Finding(
                    path, node.lineno, "blocking-call-in-coroutine",
                    f"coroutine {fn.name!r} calls blocking method "
                    f".{node.func.attr}() directly — yield the engine op or "
                    f"go through an accessor method",
                ))
    return findings


# ----------------------------------------------------------- determinism


def _rule_wall_clock(tree: ast.AST, path: str) -> list[Finding]:
    if not _is_core_path(path):
        return []
    findings: list[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func)
            if dotted in _WALL_CLOCK_CALLS:
                findings.append(Finding(
                    path, node.lineno, "wall-clock",
                    f"{dotted}() in a sim path — simulated time must come "
                    f"from the engine clock, not the host",
                ))
    return findings


def _rule_unseeded_rng(tree: ast.AST, path: str) -> list[Finding]:
    if not _is_core_path(path):
        return []
    findings: list[Finding] = []
    imports_random = any(
        isinstance(n, ast.Import) and any(a.name == "random" for a in n.names)
        for n in ast.walk(tree)
    )
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if dotted is None:
            continue
        parts = dotted.split(".")
        if dotted.endswith("default_rng") and not (node.args or node.keywords):
            findings.append(Finding(
                path, node.lineno, "unseeded-rng",
                "default_rng() without a seed — thread an explicit seed",
            ))
        elif (len(parts) >= 2 and parts[-2] == "random"
              and parts[0] in ("np", "numpy") and parts[-1] != "default_rng"):
            findings.append(Finding(
                path, node.lineno, "unseeded-rng",
                f"{dotted}() uses the legacy global RNG — use a seeded "
                f"np.random.default_rng(seed) Generator",
            ))
        elif imports_random and parts[0] == "random" and len(parts) == 2:
            findings.append(Finding(
                path, node.lineno, "unseeded-rng",
                f"stdlib {dotted}() in a sim path — use a seeded "
                f"np.random.default_rng(seed) Generator",
            ))
        elif dotted == "torch.manual_seed":
            findings.append(Finding(
                path, node.lineno, "unseeded-rng",
                "torch.manual_seed() reseeds the process-wide generator — "
                "draw from an explicit torch.Generator instead",
            ))
        elif (len(parts) == 2 and parts[0] == "torch"
              and parts[1] in _TORCH_SAMPLERS
              and not any(k.arg == "generator" for k in node.keywords)):
            findings.append(Finding(
                path, node.lineno, "unseeded-rng",
                f"{dotted}() without generator= draws from torch's global "
                f"RNG — pass a seeded torch.Generator",
            ))
    return findings


def _is_set_expr(val: ast.AST) -> bool:
    return (
        isinstance(val, (ast.Set, ast.SetComp))
        or (isinstance(val, ast.Call) and isinstance(val.func, ast.Name)
            and val.func.id in ("set", "frozenset"))
    )


def _rule_set_iteration(tree: ast.AST, path: str) -> list[Finding]:
    if not _is_core_path(path):
        return []
    findings: list[Finding] = []

    def scan_scope(scope: ast.AST, inherited: frozenset[str]) -> None:
        """Track set-typed names lexically: a closure iterating a set bound
        in an enclosing function is exactly the hazard this rule exists for
        (the scheduler's pool registry was one before it became a dict)."""
        set_vars = set(inherited)
        nested: list[ast.AST] = []
        for node in _own_scope(scope):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not scope:
                nested.append(node)
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                if _is_set_expr(node.value):
                    set_vars.add(node.targets[0].id)
                else:
                    set_vars.discard(node.targets[0].id)  # rebound
            elif isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name
            ):
                ann = _dotted(node.annotation) or ""
                if ann in ("set", "frozenset") or (
                    node.value is not None and _is_set_expr(node.value)
                ):
                    set_vars.add(node.target.id)
                else:
                    set_vars.discard(node.target.id)
        for node in _own_scope(scope):
            if not isinstance(node, ast.For):
                continue
            it = node.iter
            named_set = isinstance(it, ast.Name) and it.id in set_vars
            if _is_set_expr(it) or named_set:
                what = it.id if named_set else "a set expression"
                findings.append(Finding(
                    path, node.lineno, "set-iteration",
                    f"iterating {what} — set order is implementation-"
                    f"defined; iterate a dict (insertion-ordered) or sort",
                ))
        for fn in nested:
            scan_scope(fn, frozenset(set_vars))

    # module scope first; scan_scope recurses into every nested function
    # (class methods included — _own_scope descends through ClassDef)
    scan_scope(tree, frozenset())
    return findings


# ---------------------------------------------------------------- drivers


_RULES = (
    _rule_op_registry,
    _rule_op_dispatch,
    _rule_begin_load_pairing,
    _rule_publish_in_locked,
    _rule_coroutine_purity,
    _rule_wall_clock,
    _rule_unseeded_rng,
    _rule_set_iteration,
)


def run_lint_text(text: str, filename: str) -> list[Finding]:
    """Lint one source text under an (possibly synthetic) filename — the
    filename decides path-scoped rules (determinism applies to
    repro_torch/core)."""
    tree = ast.parse(text, filename=filename)
    findings: list[Finding] = []
    for rule in _RULES:
        findings.extend(rule(tree, filename))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def _iter_py_files(paths: list[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs.sort()
                for f in sorted(files):
                    if f.endswith(".py"):
                        out.append(os.path.join(root, f))
        elif p.endswith(".py"):
            out.append(p)
    return out


def run_lint(paths: list[str]) -> list[Finding]:
    """Lint every .py file under ``paths`` (files or directories)."""
    findings: list[Finding] = []
    for path in _iter_py_files(paths):
        with open(path, encoding="utf-8") as f:
            text = f.read()
        findings.extend(run_lint_text(text, path))
    return findings
