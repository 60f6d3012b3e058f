"""The port runs where JAX and the JAX package are absent: no file of the
port or of chip_smoke.py imports `jax` or `video_encoder_tpu`, every
module of the package imports, and a small format-4 clip encodes on the
CPU with both blocked from import, to the golden model's bytes."""

import io
import os
import pathlib
import re
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "video_encoder_tpu_torch"

_SCRIPT = r"""
import importlib, io, pkgutil, sys
sys.modules["jax"] = None                 # any `import jax` now raises
sys.modules["video_encoder_tpu"] = None   # and so does the JAX package
import numpy as np
import video_encoder_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from video_encoder_tpu_torch.codec.bitstream import OrderedMux
from video_encoder_tpu_torch.codec.config import EncoderConfig
from video_encoder_tpu_torch.codec.frame import Frame
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine
rng = np.random.default_rng(3)
big = rng.integers(0, 256, (80, 112)).astype(np.int64)
big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) // 3
frames = []
for t in range(3):     # 2x2 means at an odd offset: half-pel motion
    o = big[3 * t:3 * t + 64, t:t + 96]
    y = (o[0::2, 0::2] + o[0::2, 1::2] + o[1::2, 0::2] + o[1::2, 1::2] + 2) // 4
    frames.append(Frame.from_planes(
        y.astype(np.uint8), np.full((16, 24), 90 + t, np.uint8),
        np.full((16, 24), 160, np.uint8)))
cfg = EncoderConfig(width=48, height=32, gop_n=3, format_version=4,
                    quant_matrix=True, chroma_qp_offset=2)
packets, _ = GopEngine(cfg, device="cpu").encode_gop(frames, 0)
buf = io.BytesIO()
mux = OrderedMux(buf, cfg, len(frames))
for p in packets:
    mux.push(p)
mux.close()
leaked = [k for k in sys.modules
          if k.split(".")[0] in ("jax", "jaxlib", "video_encoder_tpu")
          and sys.modules[k] is not None]
assert not leaked, leaked
print("STREAM " + buf.getvalue().hex())
"""


def _clip():
    """The clip of _SCRIPT, made again here from the same seed."""
    rng = np.random.default_rng(3)
    big = rng.integers(0, 256, (80, 112)).astype(np.int64)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)) // 3
    clip = []
    for t in range(3):
        o = big[3 * t:3 * t + 64, t:t + 96]
        y = (o[0::2, 0::2] + o[0::2, 1::2] + o[1::2, 0::2] + o[1::2, 1::2] + 2) // 4
        clip.append((y.astype(np.uint8), np.full((16, 24), 90 + t, np.uint8),
                     np.full((16, 24), 160, np.uint8)))
    return clip


def test_port_imports_and_encodes_without_jax():
    from video_encoder_tpu.codec.config import EncoderConfig
    from video_encoder_tpu.pipeline.encoder import GoldenEngine, encode_clip

    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("STREAM ")][-1]
    cfg = EncoderConfig(width=48, height=32, gop_n=3, format_version=4,
                        quant_matrix=True, chroma_qp_offset=2)
    want = io.BytesIO()
    encode_clip(cfg, _clip(), want, 3, engine=GoldenEngine())
    assert bytes.fromhex(line.split()[1]) == want.getvalue()


def test_port_sources_never_import_jax():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|video_encoder_tpu)(\.|\s|$)", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if pat.search(p.read_text())]
    assert offenders == []
    # the pattern does catch what it forbids, and lets the port's name pass
    assert pat.search("from video_encoder_tpu.codec import spec\n")
    assert pat.search("    import video_encoder_tpu\n")
    assert pat.search("import jax.numpy as jnp\n")
    assert not pat.search("from video_encoder_tpu_torch.codec import spec\n")
