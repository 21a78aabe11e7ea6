"""Rule framework: per-module AST context + the Rule base class.

Each rule is a stateless object with an ``id`` (``R001``..), a
``tag`` (the suppression token: ``# lint: host-sync-ok`` silences a
``host-sync`` finding on that line or the line above), an ``applies``
path predicate, and a ``check(ctx)`` returning findings.

Suppression syntax (checked against the finding's line and the line
immediately above it, so it works for multi-line expressions)::

    if int(dn) <= threshold:  # lint: host-sync-ok — host-driven loop
        break

A suppression should always carry a justification after the token; the
linter reports suppressed findings separately so reviewers can audit
them (``python -m repro_torch.launch.lint --show-suppressed``).
"""
from __future__ import annotations

import ast
import re
import tokenize
from io import StringIO

from repro_torch.analysis.findings import Finding

_SUPPRESS_RE = re.compile(r"lint:\s*([a-z0-9-]+(?:\s*,\s*[a-z0-9-]+)*)")


def _parse_suppressions(source: str) -> dict[int, set[str]]:
    """Map line number -> suppression tags found in comments on that line.

    Tokenized rather than regexed over raw lines so a ``# lint: ...-ok``
    inside a string literal is not treated as a suppression.
    """
    out: dict[int, set[str]] = {}
    try:
        tokens = tokenize.generate_tokens(StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if m:
                tags = {t.strip() for t in m.group(1).split(",")}
                out.setdefault(tok.start[0], set()).update(tags)
    except (tokenize.TokenError, IndentationError):
        pass
    return out


class ModuleContext:
    """Parsed view of one module handed to every rule."""

    def __init__(self, relpath: str, source: str, tree: ast.Module):
        self.relpath = relpath
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        self.suppressions = _parse_suppressions(source)

    @classmethod
    def from_source(cls, source: str, relpath: str) -> "ModuleContext":
        return cls(relpath, source, ast.parse(source))

    def is_suppressed(self, line: int, tag: str) -> bool:
        token = f"{tag}-ok"
        for ln in (line, line - 1):
            if token in self.suppressions.get(ln, ()):
                return True
        return False


class Rule:
    """Base class: concrete rules set id/tag/description and check()."""

    id: str = ""
    tag: str = ""
    description: str = ""

    def applies(self, relpath: str) -> bool:
        return True

    def check(self, ctx: ModuleContext) -> list[Finding]:
        raise NotImplementedError

    def finding(self, ctx: ModuleContext, node: ast.AST,
                message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(rule=self.id, path=ctx.relpath, line=line, col=col,
                       message=message,
                       suppressed=ctx.is_suppressed(line, self.tag))


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def names_in(node: ast.AST) -> set[str]:
    """All Name identifiers referenced anywhere under ``node``."""
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def assigned_names(target: ast.AST) -> list[str]:
    """Flat list of Name targets in an assignment target (handles
    tuple/list unpacking and starred targets)."""
    out: list[str] = []
    for n in ast.walk(target):
        if isinstance(n, ast.Name):
            out.append(n.id)
    return out


def function_map(tree: ast.Module) -> dict[int, ast.FunctionDef]:
    """``id(node) -> innermost enclosing FunctionDef`` for every node.

    ``ast.walk`` yields outer functions before nested ones, so a nested
    function's sweep overwrites its subtree with the tighter owner.
    """
    owner: dict[int, ast.FunctionDef] = {}
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef):
            for sub in ast.walk(fn):
                owner[id(sub)] = fn
    return owner


def module_int_constants(tree: ast.Module) -> dict[str, int]:
    """Module-level ``NAME = <int literal or shift/mult expr>`` bindings."""
    out: dict[str, int] = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            val = _const_int(stmt.value, {})
            if val is not None:
                out[stmt.targets[0].id] = val
    return out


def _const_int(node: ast.AST, env: dict[str, int]) -> int | None:
    """Evaluate an int-valued literal expression (+-*//<<** over literals
    and names in ``env``); None when symbolic."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.BinOp):
        left = _const_int(node.left, env)
        right = _const_int(node.right, env)
        if left is None or right is None:
            return None
        try:
            if isinstance(node.op, ast.Add):
                return left + right
            if isinstance(node.op, ast.Sub):
                return left - right
            if isinstance(node.op, ast.Mult):
                return left * right
            if isinstance(node.op, ast.FloorDiv):
                return left // right
            if isinstance(node.op, ast.LShift):
                return left << right
            if isinstance(node.op, ast.Pow):
                return left ** right
        except (ZeroDivisionError, OverflowError, ValueError):
            return None
    return None
