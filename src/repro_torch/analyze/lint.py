"""Codebase lint suite — host-sync safety of the kernel wrappers and
metrics-name drift; the port's counterpart of ``repro/analyze/lint.py``,
re-aimed at the port's sources.

**jit-safety** (``lint_jit_safety``): the reference's rule, with torch's
host syncs added.  Observability, clock, ``print`` and host-sync calls are flagged **inside
nested function definitions** — in the reference, the ``kernel()``/``run()``
closures that jit re-traces; in the port, the closures a kernel wrapper or
``codegen/kernel_backend.py`` builds once and calls on every forward, where
a host round-trip or an obs call costs every launch (the port's kernels
wait for their grid barrier's error word in C and count it through
``_build.count_host_sync``, at the wrapper's own level).  The lint walks
``src/repro_torch/kernels/`` and ``codegen/kernel_backend.py``.  Targets:
an obs chain (``OBS…``, ``obs_lib…``, ``_O…``, ``log…``), a wall-clock read
(``time.…``), ``print``, and a host sync: JAX's ``block_until_ready`` and
torch's ``synchronize``, ``item``, ``cpu`` and ``tolist``, on any receiver
(``t.abs().max().item()`` too).

**metrics drift** (``lint_metrics_drift``): counter/gauge/histogram names
referenced by ``obs/check.py`` or the port's tests (``tests/test_torch_*.py``)
via snapshot subscripts (``snap["counters"]["name"]``) that no
``registry.counter("name", …)`` call in ``src/repro_torch`` or those tests
registers — assertions that can only ever KeyError or silently
``.get(…, 0)`` their way past a renamed metric.  The reference's own tests
read the reference's metrics and stay out.

Both accept raw source strings (test fixtures) or walk the tree on disk.
"""

from __future__ import annotations

import ast
import os
import re

from .report import Finding

#: roots of attribute chains that mean "observability / logging" here
_OBS_ROOTS = {"OBS", "obs", "obs_lib", "_O", "log", "logger"}
#: time.<attr> calls that read the host clock
_TIME_ATTRS = {"sleep", "time", "perf_counter", "monotonic", "process_time"}
#: attributes that force a host sync wherever they appear (JAX's and torch's)
_SYNC_ATTRS = {"block_until_ready", "synchronize", "item", "cpu", "tolist"}

_REG_RE = re.compile(
    r"\.(counter|gauge|histogram)\(\s*[\"']([A-Za-z0-9_./-]+)[\"']")
_REF_RE = re.compile(
    r"\[[\"'](counters|gauges|histograms)[\"']\]"
    r"(?:\[[\"']([^\"']+)[\"']\]|\.get\(\s*[\"']([^\"']+)[\"'])")


def _chain(node: ast.AST) -> str | None:
    """``a.b.c`` attribute chain as a dotted string, or None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _unsafe_reason(call: ast.Call) -> tuple[str, str] | None:
    """(reason, the call's name) when ``call`` may not sit in a closure."""
    func = call.func
    chain = _chain(func)
    if chain is None:
        # a sync on a computed receiver: ``t.abs().max().item()``
        if isinstance(func, ast.Attribute) and func.attr in _SYNC_ATTRS:
            name = f"<expr>.{func.attr}"
            return f"host sync '{name}' inside a traced closure", name
        return None
    parts = chain.split(".")
    root, leaf = parts[0], parts[-1]
    if root in _OBS_ROOTS and len(parts) > 1:
        return f"obs call '{chain}' inside a traced closure", chain
    if root == "time" and leaf in _TIME_ATTRS:
        return f"host clock '{chain}' inside a traced closure", chain
    if leaf in _SYNC_ATTRS:
        return f"host sync '{chain}' inside a traced closure", chain
    if chain == "print":
        return "print() inside a traced closure", chain
    return None


class _JitVisitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.depth = 0          # function-def nesting depth
        self.stack: list[str] = []
        self.findings: list[Finding] = []

    def _visit_fn(self, node):
        self.depth += 1
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()
        self.depth -= 1

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Call(self, node: ast.Call):
        # depth >= 2 ⇒ we are inside a function nested in a function — the
        # closure a wrapper builds once and runs per call; enclosing-level
        # obs calls (depth 1) are the sanctioned build-time pattern
        if self.depth >= 2:
            hit = _unsafe_reason(node)
            if hit is not None:
                reason, name = hit
                self.findings.append(Finding(
                    kind="jit-unsafe-call", severity="error",
                    stage=self.path, node=f"{self.stack[-1]}.{name}",
                    detail=f"{reason} (line {node.lineno}) — hoist to the "
                    "enclosing compile-time scope"))
        self.generic_visit(node)


def lint_jit_safety(sources: dict[str, str]) -> list[Finding]:
    """``{path: source}`` → jit-safety findings."""
    out: list[Finding] = []
    for path, src in sorted(sources.items()):
        try:
            tree = ast.parse(src)
        except SyntaxError as exc:
            out.append(Finding(kind="jit-unsafe-call", severity="error",
                               stage=path, node="<parse>",
                               detail=f"source does not parse: {exc}"))
            continue
        v = _JitVisitor(path)
        v.visit(tree)
        out.extend(v.findings)
    return out


def lint_metrics_drift(registry_sources: dict[str, str],
                       reference_sources: dict[str, str]) -> list[Finding]:
    """Names referenced via snapshot subscripts but never registered."""
    registered: set[str] = set()
    for src in registry_sources.values():
        for _kind, name in _REG_RE.findall(src):
            registered.add(name)
    out: list[Finding] = []
    seen: set[tuple[str, str]] = set()
    for path, src in sorted(reference_sources.items()):
        for m in _REF_RE.finditer(src):
            kind = m.group(1)
            name = (m.group(2) or m.group(3)).split("{", 1)[0]
            if name in registered or (path, name) in seen:
                continue
            seen.add((path, name))
            out.append(Finding(
                kind="metrics-drift", severity="error", stage=path,
                node=name,
                detail=f"snapshot {kind}[{name!r}] is referenced here but "
                "no registry call registers that name"))
    return out


def _read_tree(root: str, suffix: str = ".py") -> dict[str, str]:
    srcs: dict[str, str] = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(suffix):
                path = os.path.join(dirpath, f)
                with open(path, encoding="utf-8") as fh:
                    srcs[path] = fh.read()
    return srcs


def lint_src(repo_root: str = ".") -> list[Finding]:
    """The ``--lint-src`` entry: jit-safety over ``src/repro_torch/kernels``
    + ``src/repro_torch/codegen/kernel_backend.py``, metrics drift over
    ``src/repro_torch`` + ``tests/test_torch_*.py``."""
    src_root = os.path.join(repo_root, "src", "repro_torch")
    jit_sources = _read_tree(os.path.join(src_root, "kernels"))
    kb = os.path.join(src_root, "codegen", "kernel_backend.py")
    if os.path.exists(kb):
        with open(kb, encoding="utf-8") as fh:
            jit_sources[kb] = fh.read()
    findings = lint_jit_safety(jit_sources)

    tests = {p: s for p, s in _read_tree(os.path.join(repo_root, "tests")).items()
             if os.path.basename(p).startswith("test_torch_")}
    registry = _read_tree(src_root)
    registry.update(tests)
    refs = {}
    check_py = os.path.join(src_root, "obs", "check.py")
    if check_py in registry:
        refs[check_py] = registry[check_py]
    refs.update(tests)
    findings.extend(lint_metrics_drift(registry, refs))
    return findings


__all__ = ["lint_jit_safety", "lint_metrics_drift", "lint_src"]
