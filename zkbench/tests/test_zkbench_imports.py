"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level module name (the program's name begins with the JAX
package's); the reference and the yardstick import nothing of the
program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from zkbench import run

ZKBENCH = Path(__file__).resolve().parents[1]
ROOT = ZKBENCH.parent
PROGRAM = "keyless_zk_tpu_torch"
# modules that judge or measure: plain Python and numpy, none of the program
YARDSTICK = [*sorted((ZKBENCH / "reference").glob("*.py")), ZKBENCH / "signins.py", ZKBENCH / "stats.py",
             ZKBENCH / "yardstick.py", ZKBENCH / "trace.py", ZKBENCH / "readings.py",
             *sorted((ZKBENCH / "metrics").glob("*.py"))]


@pytest.mark.parametrize("loaded, flagged", [
    (["keyless_zk_tpu_torch", "keyless_zk_tpu_torch.service"], []),
    (["keyless_zk_tpu", "keyless_zk_tpu.groth16"], ["keyless_zk_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jax_cosmo", "keyless_zk_tpu_extra", "jaxtyping"], []),
])
def test_forbidden_modules_compares_whole_top_level_names(monkeypatch, loaded, flagged):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    for name in loaded:
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == flagged


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: str(p.relative_to(ZKBENCH)))
def test_the_reference_and_yardstick_import_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {PROGRAM, *run.FORBIDDEN}, tops
    if path.parent.name == "reference":
        assert tops <= {"__future__", "base64", "hashlib", "json", "functools"}, tops


def _loaded_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))  # noqa: S307 -- our own printout


def test_the_reference_process_loads_no_program():
    tops = _loaded_after("from zkbench.reference import judge")
    assert not tops & {PROGRAM, "torch", *run.FORBIDDEN}


def test_a_run_loads_no_jax():
    code = ("from zkbench import run, system, trace, yardstick, sweep, control\n"
            "import keyless_zk_tpu_torch.service.server, keyless_zk_tpu_torch.parallel.batch_prover\n"
            "import keyless_zk_tpu_torch.service.prover_state\n"
            "assert run.forbidden_modules() == [], run.forbidden_modules()")
    tops = _loaded_after(code)
    assert PROGRAM in tops and not tops & set(run.FORBIDDEN)
