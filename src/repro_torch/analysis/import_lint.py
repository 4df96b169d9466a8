"""AST lint of the port's import rule: no JAX, nothing of the reference.

The port (``src/repro_torch``), its smoke script, its examples and its
tools run where JAX is absent, and they hold their own copy of whatever
they need from the reference package ``repro`` (even of modules of it
that import no JAX).  This lint turns that rule into a check, in the
reference's ``compat_lint`` form:

``IL001``  import of ``jax`` or of a module under it
           (``import jax.numpy``, ``from jax import lax``).
``IL002``  import of the reference package ``repro`` or a module under
           it (``from repro.core import schedule``); ``repro_torch`` is
           another package and is not matched.

Only absolute imports are read: a relative import stays inside the
package it is written in.  Scope: ``src/repro_torch``, ``chip_smoke.py``,
``examples/torch_*.py`` and ``tools``.  Tests are exempt: they import
both packages to hold the port to the reference.  The rule has no
exceptions, so the lint has no suppression mark.

``IL000`` is a file the lint cannot read (a syntax error), or a root
without the port's sources (``src/repro_torch``, ``chip_smoke.py``):
a lint that read nothing must not pass.
"""
from __future__ import annotations

import ast
import fnmatch
import os

from . import ERROR, Diagnostic

RULES = {
    "IL001": "no import of jax in the port",
    "IL002": "no import of the reference package repro in the port",
}

# (directory or file under the root, file-name pattern)
SCOPE = ((os.path.join("src", "repro_torch"), "*.py"),
         ("chip_smoke.py", None),
         ("examples", "torch_*.py"),
         ("tools", "*.py"))
# The scopes every checkout has: a root without them is not the repo's.
REQUIRED = (os.path.join("src", "repro_torch"), "chip_smoke.py")


def _under(dotted: str, top: str) -> bool:
    return dotted == top or dotted.startswith(top + ".")


def _check(dotted: str) -> "tuple[str, str] | None":
    if _under(dotted, "jax"):
        return "IL001", f"{dotted} is JAX: the port runs without it"
    if _under(dotted, "repro"):
        return "IL002", (f"{dotted} is the reference package: keep the "
                         f"port's own copy of what it needs")
    return None


def lint_file(path: str, rel: str | None = None) -> list[Diagnostic]:
    """Lint one Python file; ``rel`` overrides the location prefix."""
    with open(path, encoding="utf-8") as f:
        src = f.read()
    where = rel or path
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Diagnostic("IL000", ERROR, f"{where}:{e.lineno}",
                           f"syntax error: {e.msg}")]
    out: list[Diagnostic] = []

    def flag(lineno: int, dotted: str, text: str):
        hit = _check(dotted)
        if hit is None:
            return
        out.append(Diagnostic(hit[0], ERROR, f"{where}:{lineno}",
                              f"{text} — {hit[1]}"))

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                flag(node.lineno, alias.name, f"import {alias.name}")
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            names = ", ".join(a.name for a in node.names)
            flag(node.lineno, node.module,
                 f"from {node.module} import {names}")
    out.sort(key=lambda d: int(d.location.rsplit(":", 1)[1]))
    return out


def iter_source_files(root: str):
    """Yield ``(abs_path, rel_path)`` of every in-scope .py file."""
    for scope, pattern in SCOPE:
        base = os.path.join(root, scope)
        if os.path.isfile(base):
            yield base, scope
            continue
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__"
                                 and not d.startswith("."))
            for fn in sorted(filenames):
                if fn.endswith(".py") and fnmatch.fnmatch(fn, pattern):
                    abs_path = os.path.join(dirpath, fn)
                    yield abs_path, os.path.relpath(abs_path, root)


def lint_tree(root: str = ".") -> list[Diagnostic]:
    """Lint every in-scope source file under ``root``; an ``IL000``
    error for each of :data:`REQUIRED` that ``root`` lacks."""
    out = [Diagnostic("IL000", ERROR, scope,
                      f"not found under {os.path.abspath(root)}: run "
                      f"from the repository's root or pass --root")
           for scope in REQUIRED
           if not os.path.exists(os.path.join(root, scope))]
    for abs_path, rel in iter_source_files(root):
        out.extend(lint_file(abs_path, rel=rel))
    return out
