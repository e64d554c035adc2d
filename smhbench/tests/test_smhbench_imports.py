"""Nothing the benchmark runs imports JAX or the JAX package, and its
reference imports nothing of the program under test: by an AST walk of
every module (top-level names compared whole) and in a fresh interpreter."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
NEVER = {"jax", "jaxlib", "flax", "smh_tpu"}
MODULES = sorted(p for p in ROOT.rglob("*.py") if "tests" not in p.relative_to(ROOT).parts)


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")) + [ROOT / "compare.py", ROOT / "traffic.py",
                                                                             ROOT / "frames.py"],
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (NEVER | {"smh_tpu_torch", "torch"})
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.module is None or not node.module.startswith(("harness", "readers", "profile")), path


def test_the_ast_walk_sees_the_top_level_name_whole():
    src = "import smh_tpu_torch.ops\nfrom smh_tpu import consts\nimport jaxlib.xla_client\n"
    tree_names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tree_names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tree_names.add(node.module.split(".")[0])
    assert tree_names & NEVER == {"smh_tpu", "jaxlib"}


def test_a_fresh_interpreter_importing_the_harness_loads_neither():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import smhbench.harness, smhbench.run, smhbench.control, smhbench.compare, smhbench.readers\n"
            "import smhbench.reference, smhbench.traffic\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % (str(ROOT.parent), NEVER))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_the_run_refuses_a_process_that_loaded_jax():
    from smhbench import harness

    assert harness.forbidden_modules() == sorted({m.split(".")[0] for m in sys.modules} & NEVER)
    sys.modules["smh_tpu"] = type(sys)("smh_tpu")
    try:
        assert "smh_tpu" in harness.forbidden_modules()
    finally:
        del sys.modules["smh_tpu"]
