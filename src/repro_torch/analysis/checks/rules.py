"""The RPR rule set: machine-checked forms of the port's invariants.

Own copy of ``repro/analysis/checks/rules.py``, with RPR004 and RPR005 in
torch's forms.  Every rule is a ``Rule`` subclass with a stable code
(``RPR0xx``).  Rules see parsed modules (``runner.Module``: path + text +
ast) and yield ``Finding``s; the runner applies ``# noqa: RPR0xx``
suppressions and the baseline afterwards.  Rules that accept a semantic
annotation (RPR004's ``# sync-point: <reason>``) check it themselves — an
annotation documents the invariant at the site, a noqa merely silences it.

Scoping uses ``Module.pkg_path`` — the path relative to the
``repro_torch`` package root (``serving/engine.py``) — so the rules work
identically on the real tree and on test fixture trees.

| code   | invariant                                                    |
|--------|--------------------------------------------------------------|
| RPR001 | library code never calls bare ``print()`` (obs is the output)|
| RPR002 | no ``variant ==`` / ``kind ==`` dispatch outside seq_op.py   |
| RPR003 | ``Engine.run``'s drive loop never raises                     |
| RPR004 | host syncs in hot paths are explicit (``# sync-point:``)     |
| RPR005 | recomputed functions are pure (no time/random)               |
| RPR006 | fault points: firing sites <-> ``FAULT_POINTS`` catalog      |
| RPR007 | metric/event names follow the ``repro.obs`` naming schema    |
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from .findings import Finding, line_annotation


def _root_name(node: ast.AST) -> Optional[str]:
    """Leftmost Name of a Name/Attribute/Subscript/Call chain."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _dotted(node: ast.AST) -> Optional[str]:
    """``torch.cuda.synchronize`` for Attribute chains, ``print`` for
    Names."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


_FN_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _walk_own(root: ast.AST) -> List[ast.AST]:
    """Nodes belonging to ``root`` itself, NOT to functions nested in it.

    Scoping name-taint to a function's own statements keeps e.g. a
    ``x = torch.zeros(...)`` inside one method from poisoning the name
    ``key`` in every other method of the module.
    """
    out: List[ast.AST] = [root]

    def rec(n: ast.AST) -> None:
        for c in ast.iter_child_nodes(n):
            if isinstance(c, _FN_NODES):
                continue
            out.append(c)
            rec(c)

    rec(root)
    return out


class Rule:
    """Base: one invariant, one stable code."""

    code: str = "RPR000"
    name: str = "base"
    description: str = ""

    def check_module(self, mod) -> Iterator[Finding]:
        return iter(())

    def check_tree(self, mods) -> Iterator[Finding]:
        """Cross-file pass; runs once over all modules."""
        return iter(())

    def finding(self, mod, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        snippet = ""
        if 1 <= line <= len(mod.lines):
            snippet = mod.lines[line - 1].strip()
        return Finding(rule=self.code, path=mod.report_path, line=line,
                       col=col, message=message, snippet=snippet)


# --------------------------------------------------------------------------
# RPR001 — no bare print() in library code
# --------------------------------------------------------------------------


class BarePrintRule(Rule):
    code = "RPR001"
    name = "no-bare-print"
    description = (
        "Library code reports through obs (metrics/events) or a "
        "log= callable, never bare print().  CLIs under launch/ and "
        "analysis/, plus the obs validator and perfcheck CLIs, are "
        "user-facing and exempt."
    )

    EXEMPT_DIRS = ("launch/", "analysis/")
    EXEMPT_FILES = ("obs/validate.py", "obs/perfcheck.py")

    def check_module(self, mod):
        p = mod.pkg_path
        if p.startswith(self.EXEMPT_DIRS) or p in self.EXEMPT_FILES:
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id == "print":
                yield self.finding(
                    mod, node,
                    "bare print() in library code — emit through obs "
                    "or take a log= callable",
                )


# --------------------------------------------------------------------------
# RPR002 — operator dispatch lives in the SequenceOp registry only
# --------------------------------------------------------------------------


class DispatchLadderRule(Rule):
    code = "RPR002"
    name = "no-dispatch-ladder"
    description = (
        "The SequenceOp registry (models/seq_op.py) is the ONE place "
        "operator dispatch may live: comparing a bare `variant` or "
        "`kind` name anywhere else is a hand-synced ladder.  Attribute "
        "access (`shape_cfg.kind ==`) is config/HLO metadata and stays "
        "allowed."
    )

    EXEMPT_FILES = ("models/seq_op.py",)
    NAMES = ("variant", "kind")

    def check_module(self, mod):
        if mod.pkg_path in self.EXEMPT_FILES:
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Compare):
                continue
            # flag `variant == ...` / `kind == ...`: a bare name as the
            # LEFT operand of an ==/!= (matches the retired shell guard;
            # `x == kind` filter-style comparisons stay allowed)
            operands = [node.left] + list(node.comparators)
            for i, op in enumerate(node.ops):
                if not isinstance(op, (ast.Eq, ast.NotEq)):
                    continue
                left = operands[i]
                if isinstance(left, ast.Name) and left.id in self.NAMES:
                    yield self.finding(
                        mod, node,
                        f"operator dispatch on bare `{left.id}` outside "
                        "models/seq_op.py — register a SequenceOp "
                        "instead",
                    )


# --------------------------------------------------------------------------
# RPR003 — Engine.run's drive loop never raises
# --------------------------------------------------------------------------


class EngineRunNoRaiseRule(Rule):
    code = "RPR003"
    name = "engine-run-no-raise"
    description = (
        "Engine.run converts per-request failures into GenResult "
        "statuses; a `raise` inside its while drive loop would kill "
        "every in-flight request."
    )

    TARGET = "serving/engine.py"

    def check_module(self, mod):
        if mod.pkg_path != self.TARGET:
            return
        run_fn = None
        for cls in ast.walk(mod.tree):
            if isinstance(cls, ast.ClassDef) and cls.name == "Engine":
                for n in cls.body:
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)) \
                            and n.name == "run":
                        run_fn = n
        if run_fn is None:
            yield self.finding(
                mod, mod.tree,
                "Engine.run not found — the no-raise drive-loop contract "
                "has lost its anchor (rename it together with this rule)",
            )
            return
        loops = [n for n in ast.walk(run_fn) if isinstance(n, ast.While)]
        if not loops:
            yield self.finding(
                mod, run_fn, "Engine.run has no while drive loop"
            )
            return
        for loop in loops:
            for n in ast.walk(loop):
                if isinstance(n, ast.Raise):
                    yield self.finding(
                        mod, n,
                        "raise inside Engine.run's drive loop — "
                        "per-request failures must become GenResult "
                        "statuses",
                    )


# --------------------------------------------------------------------------
# RPR004 — host-sync discipline in the hot paths
# --------------------------------------------------------------------------


class _Taint:
    """Conservative per-function device/host classification of names.

    * device evidence: assigned from an expression with a ``torch.*`` /
      ``F.*`` call or a device name in it (tensors come from torch);
    * host evidence: assigned from a transfer (``.cpu()``, ``.tolist()``,
      ``.numpy()``, ``.item()``), ``np.*``, ``time.*``, ``len``/``int``/
      ``float`` results, or constants.

    Host evidence wins (``host = host.numpy()`` patterns): a name is
    *device* only with device evidence and no host evidence — unknown
    names never produce findings.
    """

    DEVICE_ROOTS = ("torch", "F")
    HOST_CALLS = ("len", "int", "float", "bool", "str", "repr", "round",
                  "sorted", "list", "tuple", "range")
    HOST_METHODS = ("cpu", "tolist", "numpy", "item")
    HOST_ROOTS = ("np", "numpy", "time", "math", "os")

    def __init__(self, nodes: Iterable[ast.AST]):
        self.device: Set[str] = set()
        self.host: Set[str] = set()
        for node in nodes:
            if isinstance(node, ast.Assign):
                names = self._target_names(node.targets)
                if not names:
                    continue
                if self._host_expr(node.value):
                    self.host.update(names)
                elif self.expr_on_device(node.value):
                    self.device.update(names)

    @staticmethod
    def _target_names(targets) -> List[str]:
        out = []
        for t in targets:
            if isinstance(t, ast.Name):
                out.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                out.extend(e.id for e in t.elts if isinstance(e, ast.Name))
        return out

    def _host_expr(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Call):
            if isinstance(e.func, ast.Attribute) and \
                    e.func.attr in self.HOST_METHODS:
                return True
            d = _dotted(e.func)
            if d in self.HOST_CALLS:
                return True
            if d is not None and d.split(".")[0] in self.HOST_ROOTS:
                return True
        if isinstance(e, ast.Tuple):
            return all(self._host_expr(x) for x in e.elts) and bool(e.elts)
        return isinstance(e, ast.Constant)

    def is_host(self, e: ast.AST) -> bool:
        """True when the expression is visibly a host value."""
        if isinstance(e, ast.Name):
            return e.id in self.host
        return self._host_expr(e)

    def expr_on_device(self, e: ast.AST) -> bool:
        """True when the expression visibly involves device values."""
        for n in ast.walk(e):
            if isinstance(n, ast.Call):
                if isinstance(n.func, ast.Attribute) and \
                        n.func.attr in self.HOST_METHODS:
                    continue
                d = _dotted(n.func)
                if d is not None and d.split(".")[0] in self.DEVICE_ROOTS:
                    return True
            if isinstance(n, ast.Name) and n.id in self.device \
                    and n.id not in self.host:
                return True
        return False


class HostSyncRule(Rule):
    code = "RPR004"
    name = "host-sync-discipline"
    description = (
        "serving/, kernels/ and models/ promise ONE host sync per "
        "admission and per decode block/round.  Every blocking transfer — "
        "`.item()`, `.cpu()`, `torch.cuda.synchronize()`, and `.tolist()` "
        "/ `.numpy()` of a value not already on the host — and every "
        "int()/float()/bool()/np.asarray() of a device value must carry a "
        "`# sync-point: <reason>` annotation on its line (or in the "
        "comment lines directly above it), so the intended "
        "syncs are self-documenting and a stray per-token sync cannot "
        "land silently."
    )

    SCOPES = ("serving/", "kernels/", "models/")
    ANNOTATION = "sync-point"
    ALWAYS = ("item", "cpu")  # methods that move device values to the host
    UNLESS_HOST = ("tolist", "numpy")  # free on a host value
    SYNC_CALLS = ("torch.cuda.synchronize",)
    CAST_FUNCS = ("int", "float", "bool")
    CAST_METHODS = ("np.asarray", "numpy.asarray")

    def _annotated(self, mod, node: ast.AST) -> bool:
        """Annotation may sit on any line of the flagged call's span, or in
        the comment lines directly above its first line."""
        lo = getattr(node, "lineno", 1)
        hi = getattr(node, "end_lineno", lo) or lo
        while lo > 1 and mod.lines[lo - 2].strip().startswith("#"):
            lo -= 1
        for i in range(lo, hi + 1):
            if i <= len(mod.lines) and line_annotation(
                mod.lines[i - 1], self.ANNOTATION
            ):
                return True
        return False

    def _scopes(self, mod):
        """Own-node lists for every function plus the module top level."""
        fns = [n for n in ast.walk(mod.tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda))]
        return [_walk_own(fn) for fn in fns] + [_walk_own(mod.tree)]

    def _transfer(self, node: ast.Call, taint: _Taint) -> Optional[str]:
        """The transfer ``node`` makes, or None."""
        d = _dotted(node.func)
        if d in self.SYNC_CALLS:
            return d
        if not isinstance(node.func, ast.Attribute):
            return None
        attr = node.func.attr
        if attr in self.ALWAYS or (
                attr in self.UNLESS_HOST
                and not taint.is_host(node.func.value)):
            return f".{attr}()"
        return None

    def check_module(self, mod):
        if not mod.pkg_path.startswith(self.SCOPES):
            return
        reported: Set[int] = set()
        for nodes in self._scopes(mod):
            taint = _Taint(nodes)
            for node in nodes:
                if not isinstance(node, ast.Call) or id(node) in reported:
                    continue
                what = self._transfer(node, taint)
                if what is not None:
                    if not self._annotated(mod, node):
                        reported.add(id(node))
                        yield self.finding(
                            mod, node,
                            f"blocking host sync `{what}` without a "
                            "`# sync-point: <reason>` annotation — hot "
                            "paths promise one explicit sync per "
                            "admission and per block/round",
                        )
                    continue
                d = _dotted(node.func)
                is_cast = (
                    isinstance(node.func, ast.Name)
                    and node.func.id in self.CAST_FUNCS
                ) or d in self.CAST_METHODS
                if is_cast and node.args and \
                        taint.expr_on_device(node.args[0]):
                    if not self._annotated(mod, node):
                        reported.add(id(node))
                        name = d or node.func.id
                        yield self.finding(
                            mod, node,
                            f"`{name}(...)` of a device value forces a "
                            "per-call host sync — hoist it onto the "
                            "block's one transfer, or annotate with "
                            "`# sync-point: <reason>`",
                        )


# --------------------------------------------------------------------------
# RPR005 — recomputed functions are pure
# --------------------------------------------------------------------------


class RecomputePurityRule(Rule):
    code = "RPR005"
    name = "recompute-purity"
    description = (
        "Functions that run again to give the same result must not read "
        "the clock or a host random source: the forward/backward of a "
        "torch.autograd.Function, a function given to "
        "torch.utils.checkpoint (remat recomputes it in the backward "
        "pass), and a kernel's plain version (the reference the kernel is "
        "held to).  time.* and random/np.random calls there make a "
        "recompute differ from the first run.  Use torch's seeded "
        "generators (checkpoint restores their state) and keep wall-clock "
        "on the host."
    )

    RECOMPUTERS = ("checkpoint",)
    FUNCTION_BASES = ("Function",)
    FUNCTION_METHODS = ("forward", "backward")
    PLAIN_SUFFIX = "_plain"
    BANNED_ROOTS = ("random",)
    BANNED_PREFIXES = ("time.", "np.random.", "numpy.random.",
                       "random.")

    def _recomputed_functions(self, mod) -> List[ast.AST]:
        defs: Dict[str, List[ast.AST]] = {}
        for n in ast.walk(mod.tree):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(n.name, []).append(n)
        found: List[ast.AST] = []
        # forward/backward of autograd.Function subclasses
        for cls in ast.walk(mod.tree):
            if isinstance(cls, ast.ClassDef) and any(
                (_dotted(b) or "").split(".")[-1] in self.FUNCTION_BASES
                for b in cls.bases
            ):
                found.extend(
                    n for n in cls.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and n.name in self.FUNCTION_METHODS)
        # kernels' plain versions
        for ns in defs.values():
            found.extend(fn for fn in ns
                         if fn.name.endswith(self.PLAIN_SUFFIX))
        # functions given to checkpoint (by name or inline lambda)
        for n in ast.walk(mod.tree):
            if isinstance(n, ast.Call) and \
                    (_dotted(n.func) or "").split(".")[-1] in \
                    self.RECOMPUTERS:
                for arg in n.args:
                    if isinstance(arg, ast.Name):
                        found.extend(defs.get(arg.id, ()))
                    elif isinstance(arg, ast.Lambda):
                        found.append(arg)
        # anything defined inside such a function runs with it
        out, seen = [], set()
        stack = list(found)
        while stack:
            fn = stack.pop()
            if id(fn) in seen:
                continue
            seen.add(id(fn))
            out.append(fn)
            for n in ast.walk(fn):
                if n is not fn and isinstance(
                    n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    stack.append(n)
        return out

    def check_module(self, mod):
        reported: Set[int] = set()
        for fn in self._recomputed_functions(mod):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or id(node) in reported:
                    continue
                d = _dotted(node.func)
                if d is None:
                    continue
                if any(d.startswith(p) for p in self.BANNED_PREFIXES) or \
                        d in self.BANNED_ROOTS:
                    reported.add(id(node))
                    fname = getattr(fn, "name", "<lambda>")
                    yield self.finding(
                        mod, node,
                        f"impure call `{d}(...)` inside recomputed function "
                        f"`{fname}` — a recompute would not repeat it; pass "
                        "a seeded generator or a host timestamp in as an "
                        "argument instead",
                    )


# --------------------------------------------------------------------------
# RPR006 — fault-point catalog <-> firing sites cross-check
# --------------------------------------------------------------------------


class FaultPointRule(Rule):
    code = "RPR006"
    name = "fault-point-crosscheck"
    description = (
        "Every FaultPlan firing site must name a point in "
        "runtime/faults.py FAULT_POINTS, and every catalog entry must "
        "have a live firing site — otherwise `--inject` can silently "
        "target a dead point (the schedule parses, nothing ever fires)."
    )

    CATALOG_FILE = "runtime/faults.py"
    CATALOG_NAME = "FAULT_POINTS"
    FIRE_METHODS = ("hit", "raise_if", "_raise_fault")

    def _catalog(self, mod) -> Optional[Dict[str, int]]:
        """point name -> lineno, from the FAULT_POINTS dict literal."""
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign):  # FAULT_POINTS: Dict[...]
                targets = [node.target]
            else:
                continue
            if any(
                isinstance(t, ast.Name) and t.id == self.CATALOG_NAME
                for t in targets
            ) and isinstance(node.value, ast.Dict):
                out = {}
                for k in node.value.keys:
                    if isinstance(k, ast.Constant) and isinstance(
                        k.value, str
                    ):
                        out[k.value] = k.lineno
                return out
        return None

    def _firing_sites(self, mod) -> Iterable[Tuple[str, ast.Call]]:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in self.FIRE_METHODS and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                yield node.args[0].value, node

    def check_tree(self, mods):
        catalog_mod = next(
            (m for m in mods if m.pkg_path == self.CATALOG_FILE), None
        )
        if catalog_mod is None:
            return  # linting a subtree without the catalog: nothing to do
        catalog = self._catalog(catalog_mod)
        if catalog is None:
            yield self.finding(
                catalog_mod, catalog_mod.tree,
                f"{self.CATALOG_NAME} dict literal not found in "
                f"{self.CATALOG_FILE} — the fault-point contract lost "
                "its catalog",
            )
            return
        fired: Set[str] = set()
        for mod in mods:
            if mod.pkg_path == self.CATALOG_FILE:
                continue
            for point, node in self._firing_sites(mod):
                fired.add(point)
                if point not in catalog:
                    yield self.finding(
                        mod, node,
                        f"firing site names unregistered fault point "
                        f"{point!r} — add it to FAULT_POINTS or fix the "
                        "typo (registered: "
                        f"{sorted(catalog)})",
                    )
        for point, lineno in sorted(catalog.items()):
            if point not in fired:
                anchor = ast.Module(body=[], type_ignores=[])
                anchor.lineno, anchor.col_offset = lineno, 0
                yield self.finding(
                    catalog_mod, anchor,
                    f"catalog entry {point!r} has no live firing site — "
                    "--inject would accept it and never fire (delete the "
                    "entry or wire plan.hit/raise_if at the owner)",
                )


# --------------------------------------------------------------------------
# RPR007 — obs naming schema
# --------------------------------------------------------------------------


class ObsNamingRule(Rule):
    code = "RPR007"
    name = "obs-naming"
    description = (
        "Metric names are `<subsystem>_<what>[_<unit>]` snake_case; "
        "counters end `_total`, histograms end in a unit "
        "(_seconds/_bytes/_tokens/_ratio), gauges carry neither.  "
        "Event/span names are dotted `<component>.<event>`.  Bench "
        "history rows (`bench_row`, repro.obs.perf) are slash-separated "
        "snake_case paths `<bench>/<row>[/<metric>]` — perfcheck and the "
        "report trend column key rows by these names.  Dashboards "
        "and the CI validator key on these shapes."
    )

    METRIC_RE = re.compile(r"^[a-z][a-z0-9]*(_[a-z0-9]+)+$")
    EVENT_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")
    BENCH_RE = re.compile(r"^[a-z][a-z0-9_]*(/[a-z0-9_]+)+$")
    HIST_UNITS = ("_seconds", "_bytes", "_tokens", "_ratio")
    METRIC_METHODS = ("counter", "gauge", "histogram")
    EVENT_METHODS = ("event", "span", "timer")
    BENCH_METHODS = ("bench_row",)

    def _bad_metric(self, family: str, name: str) -> Optional[str]:
        if not self.METRIC_RE.match(name):
            return (f"{family} name {name!r} is not "
                    "`<subsystem>_<what>` snake_case")
        if family == "counter" and not name.endswith("_total"):
            return f"counter name {name!r} must end `_total`"
        if family != "counter" and name.endswith("_total"):
            return (f"{family} name {name!r} ends `_total` — that suffix "
                    "is reserved for counters")
        if family == "histogram" and not name.endswith(self.HIST_UNITS):
            return (f"histogram name {name!r} must end in a unit "
                    f"({'/'.join(self.HIST_UNITS)})")
        return None

    def check_module(self, mod):
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            meth, name = node.func.attr, node.args[0].value
            if meth in self.METRIC_METHODS:
                msg = self._bad_metric(meth, name)
                if msg:
                    yield self.finding(mod, node, msg)
            elif meth in self.EVENT_METHODS:
                if not self.EVENT_RE.match(name):
                    yield self.finding(
                        mod, node,
                        f"{meth} name {name!r} is not dotted "
                        "`<component>.<event>` lowercase",
                    )
            elif meth in self.BENCH_METHODS:
                if not self.BENCH_RE.match(name):
                    yield self.finding(
                        mod, node,
                        f"{meth} name {name!r} is not a slash-separated "
                        "`<bench>/<row>[/<metric>]` snake_case path",
                    )


ALL_RULES: List[Rule] = [
    BarePrintRule(),
    DispatchLadderRule(),
    EngineRunNoRaiseRule(),
    HostSyncRule(),
    RecomputePurityRule(),
    FaultPointRule(),
    ObsNamingRule(),
]

RULES_BY_CODE: Dict[str, Rule] = {r.code: r for r in ALL_RULES}
