"""The port stands alone: no module of ``deepspeed_tpu_torch`` and nothing in
``chip_smoke.py`` imports jax or anything of the JAX package
``deepspeed_tpu``, and importing the package loads neither."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "deepspeed_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, deepspeed_tpu_torch, deepspeed_tpu_torch.engine, "
            "deepspeed_tpu_torch.models, deepspeed_tpu_torch.weights, "
            "deepspeed_tpu_torch.zero3, deepspeed_tpu_torch.sparse, "
            "deepspeed_tpu_torch.checkpoint, "
            "deepspeed_tpu_torch.parallel.pipeline, "
            "deepspeed_tpu_torch.models.moe, "
            "deepspeed_tpu_torch.resilience.driver, "
            "deepspeed_tpu_torch.observability, "
            "deepspeed_tpu_torch.observability.__main__, "
            "deepspeed_tpu_torch.observability.fleet, "
            "deepspeed_tpu_torch.observability.health, "
            "deepspeed_tpu_torch.launcher.run, "
            "deepspeed_tpu_torch.launcher.launch, "
            "deepspeed_tpu_torch.utils.compile_cache; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deepspeed_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
