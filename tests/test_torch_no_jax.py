"""The port runs where JAX is absent: every module of the package imports
and a tiny clip encodes on the CPU with `jax` blocked from import."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "video_encoder_tpu_torch"

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import numpy as np
import video_encoder_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from video_encoder_tpu.codec import golden
from video_encoder_tpu.codec.config import EncoderConfig
from video_encoder_tpu.pipeline.encoder import GoldenEngine, encode_gop
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine
rng = np.random.default_rng(3)
frames = [golden.Frame.from_planes(
    rng.integers(0, 256, (32, 48), dtype=np.uint8),
    np.full((16, 24), 90, np.uint8), np.full((16, 24), 160, np.uint8))
    for _ in range(2)]
cfg = EncoderConfig(width=48, height=32, gop_n=2)
got, _ = GopEngine(cfg, device="cpu").encode_gop(frames, 0)
want, _ = encode_gop(cfg, GoldenEngine(), frames, 0, 0)
assert [p.to_bytes() for p in got] == [p.to_bytes() for p in want]
assert not any(k.startswith("jax.") for k in sys.modules), "jax leaked in"
print("NO_JAX_OK")
"""


def test_port_imports_and_encodes_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX_OK" in r.stdout


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if pat.search(p.read_text())]
    assert offenders == []
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert not pat.search(smoke)
    assert not re.search(r"^\s*(import|from)\s+video_encoder_tpu\b(?!_torch)",
                         smoke, re.M)
