"""Shared infrastructure of the port's lint (counterpart of
``paddle_tpu/analysis/common.py``, the port's own copy).

One :class:`SourceFile` per analyzed module (text, parsed AST and the
suppression table taken from its comments) and one :class:`Finding` per
reported defect. A finding is accepted without failing the gate only by an
**inline suppression**, ``# analysis: allow(<rule>) — <reason>``, on the
finding's line or in the comment block directly above or below it. The
reason is mandatory: an allow() without one is itself reported
(``suppression-missing-reason``). The JAX package's baseline file has no
counterpart: the port's gate is zero unsuppressed findings.

Analyzers are pure-AST (no import of the analyzed code), so the lint runs
on a machine without CUDA.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

#: ``# analysis: allow(rule-a, rule-b) — reason`` (em/en dash or ``-``/``:``
#: accepted before the reason; the reason itself is required)
_ALLOW_RE = re.compile(
    r"#\s*analysis:\s*allow\(\s*([a-zA-Z0-9_,\- ]+?)\s*\)"
    r"\s*(?:[—–:-]+\s*(?P<reason>\S.*))?$")


@dataclass(frozen=True)
class Finding:
    """One lint finding; ``scope`` is the enclosing qualname
    (``Class.method``, ``function`` or ``<module>``)."""

    rule: str
    path: str      # relative to the analysis root, forward slashes
    line: int
    scope: str
    message: str

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.message} "
                f"(in {self.scope})")


@dataclass
class Suppression:
    line: int
    rules: Tuple[str, ...]
    reason: str


class SourceFile:
    """One parsed module: raw text, AST, scope map, suppressions."""

    def __init__(self, path: str, relpath: str, text: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(text, filename=relpath)
        except SyntaxError as e:
            self.parse_error = f"{e.msg} (line {e.lineno})"
        self.suppressions: Dict[int, Suppression] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _ALLOW_RE.search(line) if "analysis:" in line else None
            if m is not None:
                rules = tuple(r.strip() for r in m.group(1).split(",")
                              if r.strip())
                self.suppressions[i] = Suppression(
                    i, rules, (m.group("reason") or "").strip())
        self._scopes: Optional[List[Tuple[int, int, str]]] = None

    def suppression_for(self, rule: str, line: int) -> Optional[Suppression]:
        """An allow() naming ``rule`` on the finding's line, in the
        contiguous comment block directly above it, or in the one directly
        below it."""
        def match(ln):
            sup = self.suppressions.get(ln)
            if sup is not None and (rule in sup.rules or "all" in sup.rules):
                return sup
            return None

        if match(line):
            return match(line)
        for step in (-1, 1):
            ln = line + step
            while 1 <= ln <= len(self.lines) \
                    and self.lines[ln - 1].strip().startswith("#"):
                if match(ln):
                    return match(ln)
                ln += step
        return None

    def scope_at(self, line: int) -> str:
        if self._scopes is None:
            spans: List[Tuple[int, int, str]] = []

            def visit(node: ast.AST, prefix: str) -> None:
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef)):
                        qual = (f"{prefix}.{child.name}" if prefix
                                else child.name)
                        spans.append((child.lineno, child.end_lineno, qual))
                        visit(child, qual)
                    else:
                        visit(child, prefix)

            if self.tree is not None:
                visit(self.tree, "")
            # innermost span wins: larger spans first, smaller override
            spans.sort(key=lambda s: -(s[1] - s[0]))
            self._scopes = spans
        best = "<module>"
        for lo, hi, qual in self._scopes:
            if lo <= line <= hi:
                best = qual
        return best

    def finding(self, rule: str, line: int, message: str) -> Finding:
        return Finding(rule, self.relpath, line, self.scope_at(line), message)


#: directory names never worth walking into
_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "build", "dist"}


def load_corpus(paths: Sequence[str], root: str) -> List[SourceFile]:
    """Every ``.py`` file under ``paths`` (files or directories, relative
    to ``root``), parsed, in sorted order."""
    files: List[str] = []
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(ap) and ap.endswith(".py"):
            files.append(ap)
        for dirpath, dirnames, filenames in os.walk(ap):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            files.extend(os.path.join(dirpath, f) for f in sorted(filenames)
                         if f.endswith(".py"))
    corpus = []
    for path in dict.fromkeys(files):
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
        corpus.append(SourceFile(path, os.path.relpath(path, root), text))
    return corpus


@dataclass
class Report:
    """One analysis run: unsuppressed findings (the gate), suppressed
    ones, files read and parse errors."""

    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    files: int = 0
    parse_errors: Dict[str, str] = field(default_factory=dict)
