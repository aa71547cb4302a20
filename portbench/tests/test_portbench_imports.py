"""Nothing under portbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the port (top-level module names compared
whole)."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "mars5_tts_tpu"}


def imported(path: Path) -> set:
    """Top-level names of every module ``path`` imports; a relative import
    counts as ``.`` (its level) plus its module."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                out.add("." * node.level + (node.module or ""))
            else:
                out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f): imported(f) & FORBIDDEN for f in files if imported(f) & FORBIDDEN}
    assert not bad


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for f in files:
        names = imported(f)
        assert "mars5_tts_torch" not in names, f
        assert "portbench" not in names, f
        # relative imports stay inside the reference package
        assert not any(n.startswith("..") for n in names), f


def test_the_check_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import jax.numpy as jnp\nfrom mars5_tts_tpu.models import ar\n"
                 "import jaxtyping\nimport mars5_tts_torch\n")
    assert imported(f) & FORBIDDEN == {"jax", "mars5_tts_tpu"}
