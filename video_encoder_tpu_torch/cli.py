"""Command line of the port: encode on one device, decode/info/psnr on the
host.

    python -m video_encoder_tpu_torch.cli encode -i in.yuv -W 1920 -H 1080 -o out.tvc
    python -m video_encoder_tpu_torch.cli decode -i out.tvc -o dec.yuv
    python -m video_encoder_tpu_torch.cli info   -i out.tvc
    python -m video_encoder_tpu_torch.cli psnr   -a ref.yuv -b dec.yuv -W 1920 -H 1080

`encode` runs the GOP-resident engine (full or diamond search, formats 1
to 4, every rc mode) on `--device` (default cuda):

    python -m video_encoder_tpu_torch.cli encode -i in.yuv -W 1920 -H 1080 \
        -o out.tvc --search diamond --rc mb --kbps 12000
    python -m video_encoder_tpu_torch.cli encode -i in.yuv -W 1920 -H 1080 \
        -o out.tvc --format 4 --quant-matrix --chroma-qp-offset 2

Its streams are byte-identical to the reference CLI's. Decoding uses the
C++ parser of `oracle/oracle.cpp` through ctypes (`codec/native.py`).
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time

import numpy as np

from .codec import native
from .codec.bitstream import OrderedMux, read_stream_header
from .codec.config import EncoderConfig
from .codec.frame import Frame
from .io import yuv
from .pipeline.gop_engine import GopEngine
from .utils.metrics import RunSummary, psnr

# Encode flags of the reference CLI that the port does not take yet, with
# the ROADMAP.md item that ports them.
NOT_PORTED = {
    "--two-pass": "A10", "--engine": "A11", "--gop-batch": "A12",
    "--devices": "A13", "--tile": "A13", "--multiprocess": "A13",
    "--failover": "A14", "--checkpoint": "A14", "--trace": "A14",
    "--stage-timers": "A14",
}


def _add_dims(p):
    p.add_argument("-W", "--width", type=int, default=0)
    p.add_argument("-H", "--height", type=int, default=0)


def encode_gop_resident(cfg: EncoderConfig, eng: GopEngine, frames, fo,
                        n_frames: int, verbose: bool = False) -> RunSummary:
    """GOP-resident encode + ordered mux: GOP k+1 is read and uploaded while
    GOP k runs on the device."""
    mux = OrderedMux(fo, cfg, n_frames)
    summary = RunSummary()
    pending = None

    def drain(handle):
        packets, stats = eng.encode_gop_finish(handle)
        for p in packets:
            mux.push(p)
        for s in stats:
            summary.add(s)
            if verbose:
                print(s.to_json(), file=sys.stderr)

    def launch(gop, start):
        nonlocal pending
        handle = eng.encode_gop_start(gop, start)
        if pending is not None:
            drain(pending)
        pending = handle

    gop: list[Frame] = []
    start = 0
    for count, planes in enumerate(frames):
        if count >= n_frames:
            break
        gop.append(Frame.from_planes(*planes))
        if len(gop) == cfg.gop_n:
            launch(gop, start)
            start += len(gop)
            gop = []
    if gop:
        launch(gop, start)
    if pending is not None:
        drain(pending)
    mux.close()
    return summary


def cmd_encode(a) -> int:
    w, h, fps, frames = yuv.open_clip(a.input, a.width, a.height)
    cfg = EncoderConfig(
        width=w, height=h, gop_n=a.gop, base_qp=a.qp, search=a.search,
        rc=a.rc, target_kbps=a.kbps, fps_num=fps[0], fps_den=fps[1],
        format_version=a.format, chroma_qp_offset=a.chroma_qp_offset,
        quant_bias=a.quant_bias, vbv_kbits=a.vbv_kbits,
        quant_matrix=a.quant_matrix, intra_slice_mbrows=a.intra_slice,
    )
    eng = GopEngine(cfg, device=a.device)
    n_frames = a.frames
    if n_frames == 0:
        if a.input.endswith(".y4m"):
            print("error: --frames required for y4m input", file=sys.stderr)
            return 2
        n_frames = yuv.count_yuv_frames(a.input, w, h)

    t0 = time.perf_counter()
    with open(a.output, "wb") as fo:
        summary = encode_gop_resident(cfg, eng, frames, fo, n_frames,
                                      a.verbose)
    wall = time.perf_counter() - t0
    out = json.loads(summary.to_json())
    out["device"] = str(eng.device)
    out["wall_s"] = round(wall, 3)
    out["wall_fps"] = round(summary.frames / wall, 2) if wall else 0
    print(json.dumps(out))
    return 0


def decode_clip_native(f):
    """Whole-stream decode in C++ -> (info, iterator of (y, cb, cr))."""
    data = f.read()
    info = read_stream_header(io.BytesIO(data))
    frames_flat = native.decode_stream(data, info.width, info.height,
                                       info.frame_count)

    def frames():
        for i in range(info.frame_count):
            yield yuv.split_i420(frames_flat[i].tobytes(), info.width,
                                 info.height)

    return info, frames()


def cmd_decode(a) -> int:
    t0 = time.perf_counter()
    with open(a.input, "rb") as fi:
        info, frames = decode_clip_native(fi)
    n = 0
    with open(a.output, "wb") as fo:
        for y, cb, cr in frames:
            yuv.write_yuv_frame(fo, y, cb, cr)
            n += 1
    wall = time.perf_counter() - t0
    print(json.dumps({"frames": n, "width": info.width, "height": info.height,
                      "wall_s": round(wall, 3),
                      "fps": round(n / wall, 2) if wall else 0}))
    return 0


def cmd_info(a) -> int:
    with open(a.input, "rb") as f:
        info = read_stream_header(f)
    print(json.dumps(info.__dict__))
    return 0


def cmd_psnr(a) -> int:
    with open(a.a, "rb") as fa, open(a.b, "rb") as fb:
        stats = [
            (psnr(ya, yb), psnr(cba, cbb), psnr(cra, crb))
            for (ya, cba, cra), (yb, cbb, crb) in zip(
                yuv.read_yuv_frames(fa, a.width, a.height),
                yuv.read_yuv_frames(fb, a.width, a.height),
            )
        ]
    if not stats:
        print("error: no frames", file=sys.stderr)
        return 1
    arr = np.minimum(np.array(stats), 999.0)  # lossless planes -> cap
    print(json.dumps({
        "frames": len(stats),
        "psnr_y": round(float(arr[:, 0].mean()), 3),
        "psnr_cb": round(float(arr[:, 1].mean()), 3),
        "psnr_cr": round(float(arr[:, 2].mean()), 3),
    }))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="video_encoder_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("encode", help="raw YUV/Y4M -> TVC1 on one device")
    e.add_argument("-i", "--input", required=True)
    e.add_argument("-o", "--output", required=True)
    _add_dims(e)
    e.add_argument("--gop", type=int, default=30)
    e.add_argument("--qp", type=int, default=28)
    e.add_argument("--frames", type=int, default=0, help="0 = all")
    # hier is golden/oracle-only in the reference too
    e.add_argument("--search", choices=["full", "diamond"], default="full",
                   help="ME mode")
    e.add_argument("--rc", choices=["none", "adaptive", "bitrate", "vbv", "mb"],
                   default="none", help="rate control")
    e.add_argument("--kbps", type=int, default=0,
                   help="target rate of --rc bitrate/vbv/mb")
    e.add_argument("--vbv-kbits", type=int, default=0,
                   help="rc=vbv buffer size (0 = 8x per-frame target)")
    e.add_argument("--format", type=int, choices=[1, 2, 3, 4], default=1,
                   help="bitstream format: 1=TVC1, 2=v2 (mv pred, DC DPCM), "
                        "3=v3 (I-frame intra pred, quant matrix), "
                        "4=v4 (half-pel motion)")
    e.add_argument("--quant-matrix", action="store_true",
                   help="v3: per-frequency quant matrix (SPEC.md 13.2)")
    e.add_argument("--intra-slice", type=int, default=0,
                   help="v3: reset the I-frame vertical-intra predictor "
                        "every N MB rows (SPEC.md 13.3)")
    e.add_argument("--quant-bias", type=int, default=8,
                   help="AC quantizer rounding bias /16; 8=midpoint, "
                        "lower=deadzone (fewer bits, encoder-side only)")
    e.add_argument("--chroma-qp-offset", type=int, default=0,
                   help="v2+: chroma QP offset in [-12, 12]")
    e.add_argument("--device", default="cuda",
                   help="torch device to encode on (cuda, cuda:N or cpu)")
    e.add_argument("-v", "--verbose", action="store_true")
    e.set_defaults(fn=cmd_encode)

    d = sub.add_parser("decode", help="TVC1 -> raw YUV (C++ parser)")
    d.add_argument("-i", "--input", required=True)
    d.add_argument("-o", "--output", required=True)
    d.set_defaults(fn=cmd_decode)

    inf = sub.add_parser("info", help="dump stream header")
    inf.add_argument("-i", "--input", required=True)
    inf.set_defaults(fn=cmd_info)

    p = sub.add_parser("psnr", help="PSNR between two raw YUV files")
    p.add_argument("-a", required=True)
    p.add_argument("-b", required=True)
    _add_dims(p)
    p.set_defaults(fn=cmd_psnr)

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["encode"]:
        for arg in argv[1:]:
            flag = arg.split("=", 1)[0]
            if flag in NOT_PORTED:
                print(f"error: {flag} is not supported by the port yet "
                      f"(ROADMAP.md {NOT_PORTED[flag]}); the reference CLI "
                      "video_encoder_tpu.cli has it", file=sys.stderr)
                return 2
    a = ap.parse_args(argv)
    try:
        return a.fn(a)
    except (ValueError, FileNotFoundError, OSError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
