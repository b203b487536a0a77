"""Nothing under portbench/ imports JAX or the JAX package (top-level
names compared whole), and the reference imports nothing of the port."""

import ast
import subprocess
import sys

import pytest

from portbench import harness

FILES = sorted(harness.HERE.rglob("*.py"))
PORT = "spectrogram_cube_clustering_tpu_torch"


def _imports(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return [n.split(".")[0] for n in names if n]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_no_jax(path):
    assert not set(_imports(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference")
                                        .glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_port(path):
    assert PORT not in _imports(path)
    assert "portbench" not in _imports(path)


def test_forbidden_names_are_compared_whole():
    import spectrogram_cube_clustering_tpu_torch  # noqa: F401  the port

    assert not [n for n in harness.forbidden_loaded() if PORT in n]


def test_without_a_card_no_result():
    """Without a usable CUDA card the command exits non-zero and prints
    nothing on standard output."""
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            f"sys.path.insert(0, {str(harness.ROOT)!r}); "
            "from portbench import run; "
            "sys.exit(run.main(['--workload', 'ris_aec_train', '--seed', "
            "'1', '--seconds', '1', '--trace', '0']))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=harness.ROOT)
    assert out.returncode != 0 and out.stdout == ""
