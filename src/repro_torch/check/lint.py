"""AST lint for the port's own tree (the port of ``repro.check.lint``),
with the two of the reference's rules that mean something here:

``dispatch-in-loop``
    ``run_program`` / ``run_programs`` called inside a Python ``for`` /
    ``while`` body.  Each call is a dispatch of its own -- launch plans,
    the kernels' launches and a synchronisation per iteration -- where
    one ``run_programs`` over the batched lanes dispatches once.  Batch
    the programs, or hoist the call out of the loop.

``bench-schema``
    A ``BENCH_<name>.json`` artifact name that ``tools/bench.py`` does
    not write: the port reads the reference's artifacts (the headline
    and the engine comparators are held to them) and must not cite one
    that does not exist.

The reference's other two rules are about JAX and have no meaning in a
package that never imports it: ``vmap-over-scan`` (there is no
``vmap``: the lane axis is written out) and ``jit-needs-static``
(nothing is traced).  Nor does the schema-version half of
``bench-schema`` carry over: the port writes no bench artifact.

Suppress a finding with a ``# lint: ok`` comment on the flagged line,
and give the reason in that comment.  Pure stdlib (``ast`` +
``tokenize``), like the reference's.

::

    python -m repro_torch.check.lint            # the port's tree
    python -m repro_torch.check.lint chip_smoke.py src/repro_torch/core

The port's tree is ``src/repro_torch/``, ``tests/test_torch_*.py`` and
``chip_smoke.py``; the exit code is 1 when there are findings.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import io
import re
import sys
import tokenize
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Set

ROOT = Path(__file__).resolve().parents[3]
PRAGMA = re.compile(r"#\s*lint:\s*ok\b")
_BENCH_REF = re.compile(r"^BENCH_\w+\.json$")
_BENCH_ANY = re.compile(r"BENCH_\w+\.json")

#: callables whose per-iteration dispatch is the hazard
DISPATCH_NAMES = {"run_program", "run_programs"}
RULES = ("dispatch-in-loop", "bench-schema")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _call_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, bench_artifacts: Set[str]):
        self.path = path
        self.bench_artifacts = bench_artifacts
        self.loop_depth = 0
        self.findings: List[Finding] = []

    def _add(self, node: ast.AST, rule: str, message: str) -> None:
        self.findings.append(
            Finding(self.path, getattr(node, "lineno", 0), rule, message))

    def _loop(self, node) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_For = visit_AsyncFor = visit_While = _loop

    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node.func)
        if name in DISPATCH_NAMES and self.loop_depth > 0:
            self._add(node, "dispatch-in-loop",
                      f"{name}() inside a Python loop dispatches per "
                      f"iteration; batch the lanes into one run_programs "
                      f"call")
        self.generic_visit(node)

    def _visit_def(self, node) -> None:
        # a function defined in a loop is not called per iteration
        depth, self.loop_depth = self.loop_depth, 0
        self.generic_visit(node)
        self.loop_depth = depth

    visit_FunctionDef = visit_AsyncFunctionDef = _visit_def

    def visit_Constant(self, node: ast.Constant) -> None:
        if (isinstance(node.value, str)
                and _BENCH_REF.match(node.value)
                and self.bench_artifacts
                and node.value not in self.bench_artifacts):
            self._add(node, "bench-schema",
                      f"{node.value} is not an artifact tools/bench.py "
                      f"writes ({', '.join(sorted(self.bench_artifacts))})")
        self.generic_visit(node)


def _pragma_lines(source: str) -> Set[int]:
    out: Set[int] = set()
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT and PRAGMA.search(tok.string):
                out.add(tok.start[0])
    except tokenize.TokenizeError:
        pass
    return out


def bench_artifacts(root: Path) -> Set[str]:
    """The ``BENCH_*.json`` names ``tools/bench.py`` writes; empty (the
    rule off) where the file is absent."""
    bench = root / "tools" / "bench.py"
    if not bench.is_file():
        return set()
    return set(_BENCH_ANY.findall(bench.read_text()))


def lint_source(source: str, path: str, *,
                bench_names: Set[str] = frozenset()) -> List[Finding]:
    """Lint one module's source text; ``path`` labels the findings."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding(path, exc.lineno or 0, "syntax",
                        f"does not parse: {exc.msg}")]
    visitor = _Visitor(path, set(bench_names))
    visitor.visit(tree)
    suppressed = _pragma_lines(source)
    return [f for f in visitor.findings if f.line not in suppressed]


def lint_paths(root: Path, paths: Iterable[Path]) -> List[Finding]:
    names = bench_artifacts(root)
    out: List[Finding] = []
    for p in sorted(paths):
        rel = str(p.relative_to(root)) if p.is_relative_to(root) else str(p)
        out.extend(lint_source(p.read_text(), rel, bench_names=names))
    return sorted(out, key=lambda f: (f.path, f.line))


def port_files(root: Path) -> List[Path]:
    """The port's tree: ``src/repro_torch/**.py``, ``tests/test_torch_*.py``
    and ``chip_smoke.py``."""
    paths = sorted((root / "src" / "repro_torch").rglob("*.py"))
    paths += sorted((root / "tests").glob("test_torch_*.py"))
    smoke = root / "chip_smoke.py"
    return paths + ([smoke] if smoke.is_file() else [])


def lint_tree(root: Path = ROOT) -> List[Finding]:
    return lint_paths(root, port_files(root))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files or directories to lint (default: the "
                         "port's tree)")
    args = ap.parse_args(argv)
    if args.paths:
        files: List[Path] = []
        for p in args.paths:
            p = p.resolve()
            files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
        findings = lint_paths(ROOT, files)
    else:
        findings = lint_tree(ROOT)
    for f in findings:
        print(f)
    if findings:
        print(f"lint: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    print("lint: clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
