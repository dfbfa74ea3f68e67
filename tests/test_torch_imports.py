"""Import hygiene of the PyTorch port: `src/repro_torch/`,
`chip_smoke.py`, `chip_kernel_ab.py` and the port's examples
(`examples/torch_*.py`) import neither jax nor the JAX package `repro`,
and every module of the port imports with both blocked."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


EXAMPLES = ("torch_quickstart", "torch_multi_target_cosearch",
            "torch_dosa_search_lm", "torch_serve_lm", "torch_train_lm",
            "torch_autotune")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "chip_kernel_ab.py"] \
        + sorted((ROOT / "examples").glob("torch_*.py"))


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, root) for line, root in _imported_roots(tree)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_examples_have_counterparts_that_default_to_the_card():
    """One port example per reference example, each with a `--device`
    option whose default is "cuda"."""
    assert sorted(p.stem for p in (ROOT / "examples").glob("torch_*.py")) \
        == sorted(EXAMPLES)
    for name in EXAMPLES:
        tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
        device = [call for call in ast.walk(tree)
                  if isinstance(call, ast.Call)
                  and ast.unparse(call.func).endswith("add_argument")
                  and call.args and isinstance(call.args[0], ast.Constant)
                  and call.args[0].value == "--device"]
        assert len(device) == 1, name
        defaults = {kw.arg: ast.literal_eval(kw.value)
                    for kw in device[0].keywords if kw.arg == "default"}
        assert defaults == {"default": "cuda"}, name


def test_port_imports_with_jax_and_reference_blocked():
    mods = _port_modules()
    assert "repro_torch.core.search" in mods
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith('jax.')\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("module", [
    "repro_torch.obs.telemetry", "repro_torch.obs.history",
    "repro_torch.checkpoint.checkpoint", "repro_torch.runtime.faults",
    "repro_torch.runtime.search_checkpoint", "repro_torch.runtime.chaos",
    "repro_torch.core.fleet", "repro_torch.serve.cosearch_service",
    "repro_torch.serve.server", "repro_torch.runtime.fault_tolerance",
    "repro_torch.launch.train", "repro_torch.train.train_step",
    "repro_torch.train.optimizer", "repro_torch.data.pipeline",
    "repro_torch.workloads.lm_extract", "repro_torch.models.moe",
    "repro_torch.models.ssm", "repro_torch.models.lm",
    "repro_torch.launch.serve", "repro_torch.analysis.rules",
    "repro_torch.analysis.astlint", "repro_torch.analysis.contracts",
    "repro_torch.analysis.report", "repro_torch.analysis.__main__",
    "repro_torch.launch.cells", "repro_torch.launch.dryrun",
    "repro_torch.launch.hillclimb", "repro_torch.launch.mesh",
    "repro_torch.sharding.rules"])
def test_serving_slice_modules_are_held_to_the_rules(module):
    """The serving, training, LM-family, analysis and dry-run slices'
    modules are among the modules the blocked-import run above imports,
    and none
    calls a clock itself: `time.monotonic` appears only as a reference
    (a default to inject), never called."""
    assert module in _port_modules()
    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    tree = ast.parse(path.read_text())
    calls = [ast.unparse(n.func) for n in ast.walk(tree)
             if isinstance(n, ast.Call)]
    assert not [c for c in calls if c.startswith("time.")
                and c != "time.sleep"]
