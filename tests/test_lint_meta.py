"""Meta-lint over the test tree and package: no shadowed definitions.

Round-4 review found ``test_api_conformance.py`` defining the same test
twice — Python keeps only the second, so the first silently never ran (the
exact mechanism by which a real test stops running).  ``ruff`` isn't in this
image, so this meta-test implements the F811 check directly with ``ast``:
within any scope (module or class body), a function/class name bound twice
is an error.  Decorated re-definitions that are *intentional* overloads
(``@overload``, ``@singledispatch`` registrations, ``property`` setters)
don't occur in this codebase; if one ever does, allowlist it here.
"""

import ast
import os

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOTS = ("tests", "pikazoo_tpu", "tools", "examples")


def _py_files():
    for root in _ROOTS:
        base = os.path.join(_REPO, root)
        for dirpath, _dirnames, filenames in os.walk(base):
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)
    for fn in ("bench.py", "__graft_entry__.py", "chip_smoke.py"):
        yield os.path.join(_REPO, fn)


def _duplicate_defs(path):
    """(name, first_line, dup_line) for every shadowed def in any scope."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    dups = []

    def scan(body, scope):
        seen = {}
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                decorators = {
                    d.id if isinstance(d, ast.Name)
                    else getattr(d, "attr", "")
                    for d in getattr(node, "decorator_list", [])
                }
                # property setters/deleters rebind the getter's name by
                # design; everything else is a shadowing bug.
                if not decorators & {"setter", "deleter", "overload",
                                     "register"}:
                    if node.name in seen:
                        dups.append((f"{scope}{node.name}",
                                     seen[node.name], node.lineno))
                    seen[node.name] = node.lineno
                if isinstance(node, ast.ClassDef):
                    scan(node.body, f"{scope}{node.name}.")
    scan(tree.body, "")
    return dups


def test_no_shadowed_definitions():
    problems = []
    n = 0
    for path in _py_files():
        n += 1
        for name, first, dup in _duplicate_defs(path):
            rel = os.path.relpath(path, _REPO)
            problems.append(f"{rel}:{dup}: '{name}' shadows the definition "
                            f"at line {first}")
    assert n > 30, f"lint walked only {n} files — roots misconfigured?"
    assert not problems, "\n".join(problems)


def test_test_files_define_at_least_one_test():
    """A test module with zero collectable tests is usually a naming or
    shadowing accident; fail loudly instead."""
    tests_dir = os.path.join(_REPO, "tests")
    for fn in sorted(os.listdir(tests_dir)):
        if not (fn.startswith("test_") and fn.endswith(".py")):
            continue
        with open(os.path.join(tests_dir, fn)) as f:
            tree = ast.parse(f.read(), filename=fn)
        names = [node.name for node in ast.walk(tree)
                 if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))]
        if not any(name.startswith("test_") for name in names):
            pytest.fail(f"{fn} defines no test_* functions")


def test_no_tpu_only_code_paths():
    """Nothing imports the Mosaic-TPU Pallas module or branches on a TPU
    platform: every path runs on the GPU or the CPU."""
    import re

    patterns = [re.compile(p) for p in (
        r"pallas\s+import\s+tpu", r"pallas\.tpu", r"pltpu",
        r"""[=!]=\s*["']tpu["']""", r"""["']tpu["']\s*[=!]=""",
        r"""in\s*\(\s*["']tpu["']""")]
    offenders = []
    for path in _py_files():
        rel = os.path.relpath(path, _REPO)
        if not rel.startswith(("pikazoo_tpu", "tools", "bench.py",
                               "chip_smoke.py")):
            continue
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                if any(p.search(line) for p in patterns):
                    offenders.append(f"{rel}:{lineno}: {line.strip()}")
    assert not offenders, "\n".join(offenders)
