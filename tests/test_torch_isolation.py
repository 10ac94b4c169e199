"""The port stands alone: importing every ``repro_torch`` module (and
``chip_smoke.py``) pulls in neither ``jax`` nor the JAX package; entry
points refuse to run without a card unless the caller asks for the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _port_modules():
    pkg = SRC / "repro_torch"
    return sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts).replace(
            ".__init__", "")
        for p in pkg.rglob("*.py"))


def test_port_imports_no_jax_and_no_reference_package():
    mods = _port_modules()
    assert "repro_torch.kernels.ops" in mods
    code = (
        "import importlib, runpy, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"runpy.run_path({str(ROOT / 'chip_smoke.py')!r}, run_name='smoke')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('LEAKED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-4b").smoke()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke", "--prompt-len", "64", "--batch", "1"])
    r = serve.main(["--smoke", "--prompt-len", "64", "--batch", "1",
                    "--max-new", "2", "--device", "cpu"])
    assert r.tokens.shape == (1, 2) and r.device == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    from repro_torch.kernels.flash_attention import flash_attention_bhtd
    x = torch.zeros((1, 2, 4, 64), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        flash_attention_bhtd(x, x, x)
