"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program (whole top-level names)."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "f3d_gaus_tpu"}


def top_level_imports(path: Path) -> set:
    """The top-level names (before the first dot) of every absolute
    import in the file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_whole_names_compare_by_top_level():
    src = "import f3d_gaus_torch.ops\nfrom f3d_gaus_tpu import x\n"
    p = BENCH / "tests" / "_probe_imports.py"
    try:
        p.write_text(src)
        assert top_level_imports(p) == {"f3d_gaus_torch", "f3d_gaus_tpu"}
    finally:
        p.unlink()


def test_no_jax_anywhere_under_benchmark():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 30
    for f in files:
        assert not top_level_imports(f) & JAX_SIDE, f


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert len(files) >= 20
    for f in files:
        found = top_level_imports(f)
        assert "f3d_gaus_torch" not in found, f
        assert found <= {"torch", "numpy", "math", "typing", "dataclasses",
                         "__future__", "time", "glob", "os", "PIL", "yaml",
                         "collections", "functools"}, (f, found)
