"""Nothing under vqabench/ imports JAX, Flax or the JAX package
(``vqa_tpu``, compared by whole top-level name: ``vqa_tpu_torch`` is the
port), and the plain references import nothing of the port either."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "vqa_tpu"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    names = set(top_level_imports(path))
    assert "vqa_tpu_torch" not in names and not names & FORBIDDEN


def test_whole_names_are_compared(monkeypatch):
    import types

    import vqa_tpu_torch  # noqa: F401  the port's name begins with vqa_tpu
    from vqabench.run import forbidden_modules

    assert "vqa_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "vqa_tpu.models",
                        types.ModuleType("vqa_tpu.models"))
    assert "vqa_tpu" in forbidden_modules()
