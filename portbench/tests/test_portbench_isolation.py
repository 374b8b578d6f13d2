"""What the benchmark may import and read.

Nothing under portbench/ imports JAX or the JAX package, comparing whole
top-level module names (the port's name begins with the JAX package's,
so a prefix match would be wrong); the reference imports nothing of the
port; the run path never reads the JAX package's benchmark files.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "music_style_transfer_ldm_tpu"}
PORT = "music_style_transfer_ldm_tpu_torch"


def imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not set(imported_roots(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in set(imported_roots(path))
    assert PORT not in path.read_text()


def test_whole_name_comparison():
    """The port's name starts with the JAX package's and is allowed."""
    assert PORT.split(".")[0] not in FORBIDDEN
    assert PORT.startswith("music_style_transfer_ldm_tpu")


@pytest.mark.parametrize("needle", ["bench.py", "docs/results", "BENCH_"])
def test_run_path_reads_no_jax_benchmark_file(needle):
    for path in FILES:
        if path.parent.name == "tests":
            continue
        assert needle not in path.read_text(), (path, needle)


def test_loading_the_harness_and_the_port_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.core, portbench.drivers.serve, "
            "portbench.drivers.train_ldm, "
            "portbench.calibrate; "
            "import music_style_transfer_ldm_tpu_torch.serving.engine, "
            "music_style_transfer_ldm_tpu_torch.training.train_ldm; "
            "print(portbench.core.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
