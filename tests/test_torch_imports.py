"""Isolation of the port: ``src/repro_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the reference package, and the port's
entry points run on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_names(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_names(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_every_port_module_leaves_jax_out():
    """A fresh interpreter imports every module of the port: no JAX, no
    reference package, and no kernel built."""
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "from repro_torch.kernels import _build\n"
            "assert not _build._libs, 'a kernel was built at import'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_default_to_the_card():
    from repro_torch.core import PipelineConfig
    from repro_torch.core.aggregation import run_aggregation, run_queries
    from repro_torch.core.anomaly import iqr_detect
    from repro_torch.device import resolve_device
    assert PipelineConfig.__dataclass_fields__["device"].default == "cuda"
    for fn in (run_aggregation, run_queries, iqr_detect):
        assert fn.__defaults__[-1] == "cuda" or \
            fn.__kwdefaults__ and fn.__kwdefaults__.get("device") == "cuda"
    import inspect

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models.model import init_params
    from repro_torch.serve import ServeConfig, ServeEngine
    for fn in (ServeEngine.__init__, init_params):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert PipelineConfig().device == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelineConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        iqr_detect([1.0, 2.0, 3.0])
    with pytest.raises(ValueError):
        resolve_device("mps")
    cfg = get_smoke_config("mamba2-370m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, ServeConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(["--arch", "mamba2-370m", "--smoke"])


def test_training_entry_points_default_to_the_card(tmp_path):
    """Trainer, init_state, StragglerMonitor and the training CLI take
    ``device="cuda"`` by default and raise on a machine without a card."""
    import inspect

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.train import main as train_main
    from repro_torch.telemetry import StragglerMonitor
    from repro_torch.train import RunConfig, TrainConfig, Trainer, init_state
    for fn in (Trainer.__init__, init_state, StragglerMonitor.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    cfg = get_smoke_config("mamba2-370m")
    for make in (lambda: init_state(cfg), StragglerMonitor,
                 lambda: Trainer(cfg, TrainConfig(), DataConfig(2, 8),
                                 RunConfig(workdir=str(tmp_path)))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--arch", "mamba2-370m", "--smoke",
                    "--workdir", str(tmp_path)])


def test_every_cuda_source_is_built():
    """Every source under csrc/ goes into exactly one library: a ctypes
    library of its own, or the library of PyTorch operators."""
    from repro_torch.kernels import _build
    built = sorted(p.name for name in _build.LIBRARIES
                   for p in _build.inputs(name))
    assert built == sorted(p.name for p in (PORT / "csrc").iterdir()
                           if p.suffix in (".cu", ".cpp"))


def test_chip_smoke_refuses_without_a_card_or_the_tree(tmp_path):
    """Alone in a directory, or on a machine without a card, the smoke
    script exits non-zero and prints no result."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [lone]
    if not torch.cuda.is_available():
        runs.append(ROOT / "chip_smoke.py")
    for script in runs:
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=str(script.parent))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
