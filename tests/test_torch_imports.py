"""The port stands alone: it imports with JAX made unimportable, holds no
import of the JAX package, and its entry points refuse to run on a host
without CUDA unless the caller asks for the CPU."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)  # six test workers share the host

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "triton_dist_tpu_torch"

_IMPORT_ALL_WITHOUT_JAX = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import triton_dist_tpu_torch
names = [m.name for m in pkgutil.walk_packages(triton_dist_tpu_torch.__path__, "triton_dist_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules if k == "triton_dist_tpu" or k.startswith("triton_dist_tpu."))
assert not leaked, leaked
print(" ".join(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL_WITHOUT_JAX], cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    # every module of the package (all but its own __init__) was imported,
    # the mega backend's task graph, builder and kernels among them
    assert len(names) == len(list(PKG.rglob("*.py"))) - 1
    for mod in ("graph", "builder", "kernels"):
        assert f"triton_dist_tpu_torch.megakernel.{mod}" in names


_JAX_PACKAGE_IMPORT = re.compile(r"^\s*(from|import)\s+(jax\b|triton_dist_tpu(?!_torch)\b)", re.M)


@pytest.mark.parametrize("path", ["triton_dist_tpu_torch", "chip_smoke.py"])
def test_no_jax_or_jax_package_imports(path):
    root = REPO / path
    files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
    assert files
    offenders = [
        f"{f.relative_to(REPO)}: {m.group(0).strip()}"
        for f in files for m in _JAX_PACKAGE_IMPORT.finditer(f.read_text())
    ]
    assert not offenders, offenders


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    from triton_dist_tpu_torch import resolve_device
    from triton_dist_tpu_torch.models import PRESETS, DenseLLM, Qwen3MoE, init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PRESETS["test-dense"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DenseLLM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Qwen3MoE(PRESETS["test-moe"])
    assert resolve_device("cpu") == torch.device("cpu")
    assert DenseLLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).device.type == "cpu"


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a card the chip smoke exits nonzero and prints no result; so
    it does alone, away from the repository."""
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    for cwd in (REPO, tmp_path):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
