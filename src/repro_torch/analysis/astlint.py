"""AST lint pass of the PyTorch port: applies the `rules` catalog over
Python sources.

The linter is deliberately heuristic: it cannot know which values are
tensors, so inside a device scope (`rules.DEVICE_SCOPES`, nested
functions included) it flags every call that *would* read a tensor back
to the host, every branch whose test calls into torch or a tensor's
value methods, every float64 reference and every ``prod``/``cumprod``.
The checked-in baseline and inline suppressions absorb accepted
patterns.  What it guarantees is *ratchet* semantics: a NEW hazard
anywhere in the tree fails the gate until it is fixed or deliberately
baselined/suppressed with a reason.

The reference (`repro.analysis.astlint`) finds traced code by `jax.jit`
decorators; this visitor finds device code by qualified name, classes
included (``FusedEngine.segment``).  Reported scopes keep the
reference's form (enclosing function names only), so both linters give
the same finding for the same source.

Fingerprints are content-based — ``(rule, path, enclosing scope,
stripped source line, occurrence)`` — so violations survive unrelated
line shifts.  Inline suppression: ``# repro-lint: allow[RULE_ID]`` on
the flagged line, the comment both linters read.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
from pathlib import Path

from .rules import DEVICE_SCOPES, RULES, device_scopes_for

_NP_MODULE_NAMES = frozenset({"np", "numpy"})
_WALLCLOCK_FUNCS = frozenset(
    {"time", "perf_counter", "perf_counter_ns", "monotonic", "time_ns"})
# Legacy global-stream numpy RNG entry points (always unseeded).
_NP_RANDOM_GLOBAL = frozenset(
    {"rand", "randn", "randint", "random", "uniform", "normal", "choice",
     "permutation", "shuffle", "random_sample", "standard_normal"})
_STDLIB_RANDOM_FUNCS = frozenset(
    {"random", "randint", "randrange", "uniform", "normal", "gauss",
     "choice", "choices", "shuffle", "sample", "betavariate"})

# TH101: tensor methods / torch functions that read values to the host
# (a scalar, a list, a host copy, or an output whose size is data).
_HOST_READ_METHODS = frozenset(
    {"item", "tolist", "cpu", "numpy", "nonzero", "unique",
     "masked_select"})
_HOST_READ_FUNCS = frozenset(
    {"torch.nonzero", "torch.unique", "torch.unique_consecutive",
     "torch.masked_select", "torch.argwhere"})
# Builtins that turn a tensor into a Python scalar (_local_scalar_dense).
_SCALAR_BUILTINS = frozenset({"float", "int", "bool"})
# TH102: calls in a branch test that depend on a tensor's value.
_VALUE_METHODS = frozenset(
    {"any", "all", "item", "sum", "max", "min", "mean", "amax", "amin",
     "argmax", "argmin", "nonzero", "equal", "allclose", "isnan",
     "isinf", "isfinite", "count_nonzero", "tolist"})
# torch.* calls that read only metadata or global state, never values.
_TORCH_META_PREFIXES = ("torch.is_", "torch.cuda.", "torch.backends.",
                        "torch.get_", "torch.jit.", "torch.compiler.")
# TH103 / TH104
_TORCH_F64 = frozenset({"torch.float64", "torch.double"})
_PROD_FUNCS = frozenset({"prod", "cumprod"})


@dataclasses.dataclass
class LintViolation:
    rule: str
    path: str                 # POSIX relpath from the lint root
    line: int
    col: int
    scope: str                # enclosing qualname ("<module>" at top)
    snippet: str              # stripped source line
    message: str
    fingerprint: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.scope}] {self.snippet!r}\n    -> {self.message}")


def _fingerprint(rule: str, path: str, scope: str, snippet: str,
                 occurrence: int) -> str:
    key = f"{rule}|{path}|{scope}|{snippet}|{occurrence}"
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def _attr_chain(node: ast.AST) -> str:
    """Dotted name of an attribute/name chain ('torch.cuda.sync'), or ''."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_np_f64_ref(node: ast.AST) -> bool:
    """numpy's float64 (or builtin `float`, float64 as a dtype)."""
    if _attr_chain(node) in ("np.float64", "numpy.float64"):
        return True
    return isinstance(node, ast.Name) and node.id == "float"


def _is_device_ref(node: ast.AST) -> bool:
    """A device named in source: a string ('cpu', 'cuda:0'), a
    `torch.device(...)` call, or a name/attribute called ``device`` or
    ``dev``."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    if isinstance(node, ast.Call):
        return _attr_chain(node.func) == "torch.device"
    return _attr_chain(node).rsplit(".", 1)[-1] in ("device", "dev")


def _host_read_call(node: ast.Call, chain: str, head: str) -> bool:
    """TH101: does this call read a tensor back to the host or copy it
    to another device?"""
    attr = node.func.attr if isinstance(node.func, ast.Attribute) else ""
    if head in _NP_MODULE_NAMES or chain in _HOST_READ_FUNCS \
            or attr in _HOST_READ_METHODS:
        return True
    if chain in _SCALAR_BUILTINS and node.args \
            and not isinstance(node.args[0], ast.Constant):
        return True
    return attr == "to" and (
        (bool(node.args) and _is_device_ref(node.args[0]))
        or any(kw.arg == "device" for kw in node.keywords))


def _reads_tensor_value(test: ast.AST) -> bool:
    """Does a branch test call into torch or a tensor's value methods?
    Tests on configuration values (attributes, literals, `len`,
    `isinstance`) do not."""
    for n in ast.walk(test):
        if not isinstance(n, ast.Call):
            continue
        chain = _attr_chain(n.func)
        if chain.startswith("torch.") \
                and not chain.startswith(_TORCH_META_PREFIXES):
            return True
        if isinstance(n.func, ast.Attribute) \
                and n.func.attr in _VALUE_METHODS:
            return True
    return False


class _Linter(ast.NodeVisitor):
    def __init__(self, relpath: str, lines: list[str]):
        self.relpath = relpath
        self.lines = lines
        self.violations: list[LintViolation] = []
        self._seen: dict[tuple, int] = {}     # dedup/occurrence counter
        self.scope: list[str] = []            # function names (reported)
        self._qual: list[str] = []            # classes too (scope match)
        self._device_scopes = device_scopes_for(relpath)
        self._device_depth = 0

    # -- helpers -----------------------------------------------------------

    def _qualname(self) -> str:
        return ".".join(self.scope) if self.scope else "<module>"

    def _line(self, node: ast.AST) -> str:
        try:
            return self.lines[node.lineno - 1].strip()
        except (IndexError, AttributeError):
            return ""

    def _suppressed(self, node: ast.AST, rule: str) -> bool:
        return f"repro-lint: allow[{rule}]" in self._line(node)

    def report(self, rule: str, node: ast.AST) -> None:
        r = RULES[rule]
        if r.path_filters and not any(f in self.relpath
                                      for f in r.path_filters):
            return
        if any(f in self.relpath for f in r.path_excludes):
            return
        if self._suppressed(node, rule):
            return
        scope = self._qualname()
        snippet = self._line(node)
        key = (rule, scope, snippet)
        occ = self._seen.get(key, 0)
        self._seen[key] = occ + 1
        self.violations.append(LintViolation(
            rule=rule, path=self.relpath, line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0), scope=scope,
            snippet=snippet, message=r.message,
            fingerprint=_fingerprint(rule, self.relpath, scope, snippet,
                                     occ)))

    @property
    def _in_device(self) -> bool:
        return self._device_depth > 0

    # -- scopes: device-scope tracking + PY401 ----------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._qual.append(node.name)
        self.generic_visit(node)
        self._qual.pop()

    def _visit_func(self, node) -> None:
        self.scope.append(node.name)
        self._qual.append(node.name)
        is_device = ".".join(self._qual) in self._device_scopes
        self._check_mutable_defaults(node)
        self._device_depth += int(is_device)
        self.generic_visit(node)
        self._device_depth -= int(is_device)
        self._qual.pop()
        self.scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self.scope.append("<lambda>")
        self._qual.append("<lambda>")
        self.generic_visit(node)
        self._qual.pop()
        self.scope.pop()

    def _check_mutable_defaults(self, func) -> None:
        defaults = list(func.args.defaults) + [
            d for d in func.args.kw_defaults if d is not None]
        for d in defaults:
            if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                self.report("PY401", d)
            elif isinstance(d, ast.Call) and \
                    _attr_chain(d.func) in ("list", "dict", "set"):
                self.report("PY401", d)

    # -- branches on tensor values (TH102) ---------------------------------

    def visit_If(self, node: ast.If) -> None:
        if self._in_device and _reads_tensor_value(node.test):
            self.report("TH102", node)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        if self._in_device and _reads_tensor_value(node.test):
            self.report("TH102", node)
        self.generic_visit(node)

    # -- float64 names (TH103) ---------------------------------------------

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if self._in_device and _attr_chain(node) in _TORCH_F64:
            self.report("TH103", node)
        self.generic_visit(node)

    # -- calls: TH101 / TH103 / TH104 / ND201 / ND202 / OB601 --------------

    def _check_device_call(self, node: ast.Call, chain: str,
                           head: str) -> None:
        attr = node.func.attr if isinstance(node.func, ast.Attribute) \
            else ""
        if _host_read_call(node, chain, head):
            self.report("TH101", node)
        if attr == "double" \
                or any(kw.arg == "dtype" and _is_np_f64_ref(kw.value)
                       for kw in node.keywords) \
                or (attr == "astype" and node.args
                    and _is_np_f64_ref(node.args[0])):
            self.report("TH103", node)
        if attr in _PROD_FUNCS and head not in _NP_MODULE_NAMES \
                and head != "math":
            self.report("TH104", node)

    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        head = chain.split(".")[0] if chain else ""

        if self._in_device:
            self._check_device_call(node, chain, head)

        # nondeterminism (path-filtered to engine code by the rule)
        if chain.startswith(("np.random.", "numpy.random.")):
            fn = chain.rsplit(".", 1)[1]
            if fn in _NP_RANDOM_GLOBAL:
                self.report("ND201", node)
            elif fn == "default_rng" and not node.args:
                self.report("ND201", node)
        elif head == "random" and "." in chain \
                and chain.rsplit(".", 1)[1] in _STDLIB_RANDOM_FUNCS:
            self.report("ND201", node)
        elif chain in (f"time.{f}" for f in _WALLCLOCK_FUNCS):
            self.report("ND202", node)
            # OB601 applies everywhere outside the telemetry spine
            # (report() applies each rule's own path filters/excludes).
            self.report("OB601", node)
        self.generic_visit(node)

    # -- exception hygiene (EX301) ----------------------------------------

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        broad = node.type is None or _names_exception(node.type)
        if broad and not any(isinstance(n, ast.Raise)
                             for stmt in node.body
                             for n in ast.walk(stmt)):
            self.report("EX301", node)
        self.generic_visit(node)


def _names_exception(node: ast.AST) -> bool:
    if isinstance(node, ast.Tuple):
        return any(_names_exception(e) for e in node.elts)
    return _attr_chain(node) in ("Exception", "BaseException")


def lint_source(source: str, relpath: str) -> list[LintViolation]:
    """Lint one file's source text; `relpath` keys fingerprints,
    path-filtered rules and device scopes (use POSIX separators)."""
    tree = ast.parse(source, filename=relpath)
    linter = _Linter(relpath, source.splitlines())
    linter.visit(tree)
    return sorted(linter.violations, key=lambda v: (v.path, v.line, v.rule))


def lint_paths(root: str | Path) -> list[LintViolation]:
    """Lint every ``*.py`` under ``root/src/repro_torch``.  Returns
    violations sorted by (path, line, rule)."""
    root = Path(root)
    out: list[LintViolation] = []
    for p in sorted((root / "src" / "repro_torch").rglob("*.py")):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(root).as_posix()
        out.extend(lint_source(p.read_text(), rel))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def _qualnames(tree: ast.Module) -> set[str]:
    """Qualified names (classes included) of every def in a module."""
    out: set[str] = set()

    def walk(node, prefix):
        for ch in ast.iter_child_nodes(node):
            if isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                q = prefix + (ch.name,)
                if not isinstance(ch, ast.ClassDef):
                    out.add(".".join(q))
                walk(ch, q)
            else:
                walk(ch, prefix)
    walk(tree, ())
    return out


def unresolved_device_scopes(root: str | Path
                             ) -> list[tuple[str, str]]:
    """`DEVICE_SCOPES` entries that name no ``def`` under `root`: a
    rename in the engine would otherwise empty the TH1xx rules'
    reach without a sound."""
    root = Path(root)
    names: dict[str, set[str]] = {}
    for frag, qual in DEVICE_SCOPES:
        if frag not in names:
            p = root / frag
            names[frag] = _qualnames(ast.parse(p.read_text())) \
                if p.is_file() else set()
    return [(f, q) for f, q in DEVICE_SCOPES if q not in names[f]]


# ---------------------------------------------------------------------------
# Baseline: the ratchet.  `analysis_baseline.json` holds fingerprints of
# accepted violations; a scan classifies each finding as new (fails the
# gate), baselined (accepted), and each baseline entry with no current
# match as fixed (the baseline diff the report publishes).
# ---------------------------------------------------------------------------

def load_baseline(path: str | Path) -> dict:
    p = Path(path)
    if not p.exists():
        return {"version": 1, "entries": []}
    return json.loads(p.read_text())


def save_baseline(path: str | Path,
                  violations: list[LintViolation]) -> None:
    entries = [{"fingerprint": v.fingerprint, "rule": v.rule,
                "path": v.path, "scope": v.scope, "snippet": v.snippet}
               for v in violations]
    Path(path).write_text(json.dumps(
        {"version": 1, "entries": entries}, indent=1) + "\n")


def diff_baseline(violations: list[LintViolation], baseline: dict
                  ) -> tuple[list[LintViolation], list[LintViolation],
                             list[dict]]:
    """(new, baselined, fixed): violations not in the baseline, those
    accepted by it, and baseline entries with no current match (fixed
    or moved — the ratchet's progress report)."""
    known = {e["fingerprint"]: e for e in baseline.get("entries", [])}
    new = [v for v in violations if v.fingerprint not in known]
    old = [v for v in violations if v.fingerprint in known]
    live = {v.fingerprint for v in violations}
    fixed = [e for fp, e in known.items() if fp not in live]
    return new, old, fixed
