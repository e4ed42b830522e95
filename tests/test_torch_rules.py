"""Rules of the port package: no JAX, nothing of ``repro``, card by default."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import DQF, DQFConfig

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")


def test_dqf_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        assert DQF(DQFConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DQF(DQFConfig())
    assert DQF(DQFConfig(), device="cpu").device.type == "cpu"


def test_quantized_config_is_refused():
    from repro_torch.core.types import QuantConfig
    with pytest.raises(NotImplementedError):
        DQF(DQFConfig(quant=QuantConfig(mode="sq8")), device="cpu")


def test_port_imports_no_jax_and_nothing_of_repro():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.convert,"
            " repro_torch.kernels.ops, repro_torch.kernels.fused_hop;"
            "bad = [m for m in sys.modules if m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'repro.'))]; print(bad)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_line_imports_jax_or_repro(path):
    bad = [line for line in path.read_text().splitlines()
           if IMPORT.match(line)]
    assert bad == []
