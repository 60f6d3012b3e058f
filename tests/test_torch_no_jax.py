"""The port runs where JAX and the JAX package are absent: no file of the
port or of chip_smoke.py imports `jax` or `video_encoder_tpu`, every
module of the package imports, and a small format-4 clip encodes on the
CPU with both blocked from import, to the golden model's bytes; so do a
batched-GOP encode and a two-pass encode, to the bytes the port gives
in this process, and the port's own golden model encodes and decodes."""

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
    assert PKG / "pipeline" / "encoder.py" in files   # the two-pass module
    for mod in ("pipeline/device_engine.py", "pipeline/checkpoint.py",
                "pipeline/bitstream_writer.py", "utils/trace.py",
                "codec/golden.py", "codec/bitio.py"):
        assert PKG / mod in files
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if pat.search(p.read_text())]
    assert offenders == []
    # the pattern does catch what it forbids, and lets the port's name pass
    assert pat.search("from video_encoder_tpu.codec import spec\n")
    assert pat.search("    import video_encoder_tpu\n")
    assert pat.search("import jax.numpy as jnp\n")
    assert not pat.search("from video_encoder_tpu_torch.codec import spec\n")


_BATCH_SCRIPT = _SCRIPT[:_SCRIPT.index("rng = ")] + r"""
from video_encoder_tpu_torch.pipeline.encoder import encode_clip_twopass
rng = np.random.default_rng(8)
clip = [(rng.integers(0, 256, (32, 48), dtype=np.uint8),
         rng.integers(0, 256, (16, 24), dtype=np.uint8),
         rng.integers(0, 256, (16, 24), dtype=np.uint8)) for _ in range(6)]
cfg = EncoderConfig(width=48, height=32, gop_n=3, rc="bitrate", target_kbps=200)
eng = GopEngine(cfg, device="cpu")
frames = [Frame.from_planes(*p) for p in clip]
out = eng.finish(eng.start([frames[:3], frames[3:]], [0, 3], [24, 30]))
buf = io.BytesIO()
encode_clip_twopass(cfg, lambda: iter(clip), buf, 6, engine=eng)
leaked = [k for k in sys.modules
          if k.split(".")[0] in ("jax", "jaxlib", "video_encoder_tpu")
          and sys.modules[k] is not None]
assert not leaked, leaked
print("BATCH " + b"".join(p.to_bytes() for pk, _ in out for p in pk).hex())
print("TWOPASS " + buf.getvalue().hex())
"""


def test_batched_and_two_pass_encodes_run_without_jax():
    from video_encoder_tpu_torch.codec.config import EncoderConfig
    from video_encoder_tpu_torch.codec.frame import Frame
    from video_encoder_tpu_torch.pipeline.encoder import encode_clip_twopass
    from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _BATCH_SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = dict(ln.split(" ", 1) for ln in r.stdout.splitlines()
                 if ln.startswith(("BATCH ", "TWOPASS ")))
    rng = np.random.default_rng(8)
    clip = [(rng.integers(0, 256, (32, 48), dtype=np.uint8),
             rng.integers(0, 256, (16, 24), dtype=np.uint8),
             rng.integers(0, 256, (16, 24), dtype=np.uint8)) for _ in range(6)]
    cfg = EncoderConfig(width=48, height=32, gop_n=3, rc="bitrate",
                        target_kbps=200)
    eng = GopEngine(cfg, device="cpu")
    frames = [Frame.from_planes(*p) for p in clip]
    seq = [eng.encode_gop(frames[:3], 0, 24), eng.encode_gop(frames[3:], 3, 30)]
    want = b"".join(p.to_bytes() for pk, _ in seq for p in pk)
    assert bytes.fromhex(lines["BATCH"]) == want
    buf = io.BytesIO()
    encode_clip_twopass(cfg, lambda: iter(clip), buf, 6, engine=eng)
    assert bytes.fromhex(lines["TWOPASS"]) == buf.getvalue()


_TILE_SCRIPT = _SCRIPT[:_SCRIPT.index("rng = ")] + r"""
from video_encoder_tpu_torch.parallel.gop_parallel import ShardedGopEncoder
from video_encoder_tpu_torch.parallel.mesh import make_codec_mesh
rng = np.random.default_rng(8)
clip = [(rng.integers(0, 256, (32, 48), dtype=np.uint8),
         rng.integers(0, 256, (16, 24), dtype=np.uint8),
         rng.integers(0, 256, (16, 24), dtype=np.uint8)) for _ in range(6)]
cfg = EncoderConfig(width=48, height=32, gop_n=3, format_version=4,
                    intra_slice_mbrows=1, rc="vbv", target_kbps=200)
frames = [Frame.from_planes(*p) for p in clip]
senc = ShardedGopEncoder(cfg, make_codec_mesh(2, 2, "cpu"))
out = senc.finish(senc.start([frames[:3], frames[3:]], [0, 3]))
leaked = [k for k in sys.modules
          if k.split(".")[0] in ("jax", "jaxlib", "video_encoder_tpu")
          and sys.modules[k] is not None]
assert not leaked, leaked
print("TILED " + b"".join(p.to_bytes() for pk, _ in out for p in pk).hex())
"""


def test_tiled_encode_runs_without_jax():
    """The tile-sharded encoder (parallel/) with jax and the JAX package
    blocked: the unsharded engine's packets."""
    from video_encoder_tpu_torch.codec.config import EncoderConfig
    from video_encoder_tpu_torch.codec.frame import Frame
    from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

    assert PKG / "parallel" / "tiles.py" in PKG.rglob("*.py")   # in the scan
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _TILE_SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("TILED ")][-1]
    rng = np.random.default_rng(8)
    clip = [(rng.integers(0, 256, (32, 48), dtype=np.uint8),
             rng.integers(0, 256, (16, 24), dtype=np.uint8),
             rng.integers(0, 256, (16, 24), dtype=np.uint8)) for _ in range(6)]
    cfg = EncoderConfig(width=48, height=32, gop_n=3, format_version=4,
                        intra_slice_mbrows=1, rc="vbv", target_kbps=200)
    frames = [Frame.from_planes(*p) for p in clip]
    eng = GopEngine(cfg, device="cpu")
    want = eng.finish(eng.start([frames[:3], frames[3:]], [0, 3]))
    assert bytes.fromhex(line.split()[1]) == b"".join(
        p.to_bytes() for pk, _ in want for p in pk)


_DECODE_SCRIPT = _SCRIPT[:_SCRIPT.index("leaked = ")] + r"""
from video_encoder_tpu_torch.pipeline import decoder
data = buf.getvalue()
outs = {}
for name, run in (
        ("native", decoder.decode_clip_native),
        ("parallel", lambda f: decoder.decode_clip_parallel(f, 2)),
        ("gop", lambda f: decoder.decode_clip_gop(
            f, decoder.GopDecodeEngine(device="cpu"))),
        ("device", lambda f: decoder.decode_clip(
            f, decoder.DeviceDecodeEngine(device="cpu")))):
    _, frames = run(io.BytesIO(data))
    outs[name] = b"".join(p.tobytes() for f in frames for p in f)
leaked = [k for k in sys.modules
          if k.split(".")[0] in ("jax", "jaxlib", "video_encoder_tpu")
          and sys.modules[k] is not None]
assert not leaked, leaked
for name, raw in outs.items():
    print("DECODED " + name + " " + raw.hex())
"""


def test_decoders_run_without_jax():
    """The port's four decoders (pipeline/decoder.py) with jax and the JAX
    package blocked, on the format-4 stream of _SCRIPT: each gives the
    reference's C++ decode of it."""
    from video_encoder_tpu.codec.config import EncoderConfig
    from video_encoder_tpu.pipeline.decoder import decode_clip_native
    from video_encoder_tpu.pipeline.encoder import GoldenEngine, encode_clip

    assert PKG / "pipeline" / "decoder.py" in PKG.rglob("*.py")   # in the scan
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _DECODE_SCRIPT], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = {ln.split()[1]: bytes.fromhex(ln.split()[2])
           for ln in r.stdout.splitlines() if ln.startswith("DECODED ")}
    cfg = EncoderConfig(width=48, height=32, gop_n=3, format_version=4,
                        quant_matrix=True, chroma_qp_offset=2)
    stream = io.BytesIO()
    encode_clip(cfg, _clip(), stream, 3, engine=GoldenEngine())
    stream.seek(0)
    _, frames = decode_clip_native(stream)
    want = b"".join(p.tobytes() for f in frames for p in f)
    assert len(want) == 3 * 48 * 32 * 3 // 2
    assert got == {k: want for k in ("native", "parallel", "gop", "device")}


_PER_FRAME_SCRIPT = _SCRIPT[:_SCRIPT.index("rng = ")] + r"""
import os, tempfile
from video_encoder_tpu_torch.pipeline.device_engine import DeviceEngine
from video_encoder_tpu_torch.pipeline.encoder import (
    PerFrameGopAdapter, encode_clip, encode_clip_resumable)
from video_encoder_tpu_torch.utils.trace import StageTimer, trace
rng = np.random.default_rng(8)
clip = [(rng.integers(0, 256, (32, 48), dtype=np.uint8),
         rng.integers(0, 256, (16, 24), dtype=np.uint8),
         rng.integers(0, 256, (16, 24), dtype=np.uint8)) for _ in range(5)]
cfg = EncoderConfig(width=48, height=32, gop_n=2, rc="vbv", target_kbps=200)
buf = io.BytesIO()
tmp = tempfile.mkdtemp()
with trace(os.path.join(tmp, "tr")):
    encode_clip(cfg, clip, buf, 5, engine=DeviceEngine("cpu"))
assert os.listdir(os.path.join(tmp, "tr"))
out = os.path.join(tmp, "r.tvc")
encode_clip_resumable(cfg, clip, out, 5,
                      PerFrameGopAdapter(cfg, DeviceEngine("cpu")),
                      os.path.join(tmp, "ck.json"), timer=StageTimer())
leaked = [k for k in sys.modules
          if k.split(".")[0] in ("jax", "jaxlib", "video_encoder_tpu")
          and sys.modules[k] is not None]
assert not leaked, leaked
print("PERFRAME " + buf.getvalue().hex())
print("RESUMABLE " + open(out, "rb").read().hex())
"""


def test_per_frame_and_resumable_encodes_run_without_jax():
    """The per-frame engine's clip encode under a trace, and the
    checkpointed encode, with jax and the JAX package blocked: the golden
    model's stream, both."""
    from video_encoder_tpu.codec.config import EncoderConfig
    from video_encoder_tpu.pipeline.encoder import GoldenEngine, encode_clip

    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _PER_FRAME_SCRIPT], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = dict(ln.split(" ", 1) for ln in r.stdout.splitlines()
                 if ln.startswith(("PERFRAME ", "RESUMABLE ")))
    rng = np.random.default_rng(8)
    clip = [(rng.integers(0, 256, (32, 48), dtype=np.uint8),
             rng.integers(0, 256, (16, 24), dtype=np.uint8),
             rng.integers(0, 256, (16, 24), dtype=np.uint8)) for _ in range(5)]
    cfg = EncoderConfig(width=48, height=32, gop_n=2, rc="vbv",
                        target_kbps=200)
    want = io.BytesIO()
    encode_clip(cfg, clip, want, 5, engine=GoldenEngine())
    assert bytes.fromhex(lines["PERFRAME"]) == want.getvalue()
    assert bytes.fromhex(lines["RESUMABLE"]) == want.getvalue()


_GOLDEN_SCRIPT = _SCRIPT[:_SCRIPT.index("rng = ")] + r"""
from video_encoder_tpu_torch.pipeline import decoder
from video_encoder_tpu_torch.pipeline.encoder import GoldenEngine, encode_clip
rng = np.random.default_rng(8)
clip = [(rng.integers(0, 256, (32, 48), dtype=np.uint8),
         rng.integers(0, 256, (16, 24), dtype=np.uint8),
         rng.integers(0, 256, (16, 24), dtype=np.uint8)) for _ in range(5)]
cfg = EncoderConfig(width=48, height=32, gop_n=3, search="hier",
                    format_version=3, quant_matrix=True, rc="mb",
                    target_kbps=200)
buf = io.BytesIO()
encode_clip(cfg, clip, buf, 5, engine=GoldenEngine())
_, frames = decoder.decode_clip(io.BytesIO(buf.getvalue()),
                                decoder.GoldenDecodeEngine())
raw = b"".join(p.tobytes() for f in frames for p in f)
leaked = [k for k in sys.modules
          if k.split(".")[0] in ("jax", "jaxlib", "video_encoder_tpu")
          and sys.modules[k] is not None]
assert not leaked, leaked
print("GOLDEN " + buf.getvalue().hex())
print("DECODED " + raw.hex())
"""


def test_golden_encode_and_decode_run_without_jax():
    """The port's golden model (codec/golden.py) through its engines, with
    jax and the JAX package blocked: the reference golden model's stream
    (hier search, rc mb, format 3), and the C++ decoder's frames of it."""
    from video_encoder_tpu.codec.config import EncoderConfig
    from video_encoder_tpu.pipeline.decoder import decode_clip_native
    from video_encoder_tpu.pipeline.encoder import GoldenEngine, encode_clip

    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _GOLDEN_SCRIPT], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = dict(ln.split(" ", 1) for ln in r.stdout.splitlines()
                 if ln.startswith(("GOLDEN ", "DECODED ")))
    rng = np.random.default_rng(8)
    clip = [(rng.integers(0, 256, (32, 48), dtype=np.uint8),
             rng.integers(0, 256, (16, 24), dtype=np.uint8),
             rng.integers(0, 256, (16, 24), dtype=np.uint8)) for _ in range(5)]
    cfg = EncoderConfig(width=48, height=32, gop_n=3, search="hier",
                        format_version=3, quant_matrix=True, rc="mb",
                        target_kbps=200)
    want = io.BytesIO()
    encode_clip(cfg, clip, want, 5, engine=GoldenEngine())
    assert bytes.fromhex(lines["GOLDEN"]) == want.getvalue()
    want.seek(0)
    _, frames = decode_clip_native(want)
    assert bytes.fromhex(lines["DECODED"]) == b"".join(
        p.tobytes() for f in frames for p in f)
