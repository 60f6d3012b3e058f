"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code not 0):

1. Device: requires CUDA; prints the card's name and power limit.
2. Build: compiles every kernel under video_encoder_tpu_torch/csrc/.
3. Kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (1088x1920 luma, 544x960 chroma, and the odd
   368x640 grid), exact equality (tolerance 0: the codec is integer-only),
   with both times.
4. Slice: the port CLI encodes a 1920x1080 I420 clip of 30 frames (GOP 30,
   qp 28, full search, format 1, rc none) in-process on the card; every
   kernel must have launched; the stream must be byte-identical to the C++
   oracle's; the oracle decodes it and PSNR-Y is checked. Then 640x360 at
   GOP 1 (odd 23-row MB grid).
5. Speed: device-resident 1080p GOP-30 encode fps and the CLI's wall fps.

The last two lines of standard output are the kernel table and
{"ok": true, "device": {...}}. Builds go to build/ (gitignored).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ORACLE_SRC = os.path.join(ROOT, "oracle", "oracle.cpp")
ORACLE_BIN = os.path.join(ROOT, "build", "oracle", "oracle")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def texture(rng, h: int, w: int) -> np.ndarray:
    """Smoothed random texture [h + 128, w + 128] int32 in [0, 255]."""
    base = rng.integers(0, 256, (h + 128, w + 128)).astype(np.int32)
    for _ in range(2):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
                + np.roll(base, 2, 0) + np.roll(base, 2, 1)) // 5
    return base


def synth_clip(t: int, h: int, w: int, seed: int):
    """Panning texture, a moving random patch, mild noise; flat chroma."""
    rng = np.random.default_rng(seed)
    base = texture(rng, h, w)
    ys, cbs, crs = [], [], []
    for k in range(t):
        y = base[2 * k: 2 * k + h, 3 * k: 3 * k + w] + rng.integers(-2, 3, (h, w))
        px, py = (200 + 11 * k) % max(w - 64, 1), (300 + 7 * k) % max(h - 64, 1)
        y[py: py + 64, px: px + 64] = rng.integers(0, 256, (64, 64))
        ys.append(np.clip(y, 0, 255).astype(np.uint8))
        cbs.append(np.full((h // 2, w // 2), 108 + k, np.uint8))
        crs.append(np.full((h // 2, w // 2), 148, np.uint8))
    return ys, cbs, crs


def time_ms(fn, budget_s: float = 0.5) -> float:
    """Mean device time of fn() in ms over a run of calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    iters = int(min(50, max(3, budget_s / max(time.perf_counter() - t0, 1e-6))))
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def max_abs_err(got, want) -> int:
    """Largest |got - want| over matching output tensors; raises unless
    they are equal (same dtype and shape, every element)."""
    err = 0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"dtype/shape {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        err = max(err, int((g.long() - w.long()).abs().max()) if g.numel() else 0)
    if err:
        raise AssertionError(f"kernel differs from its plain version: "
                             f"max |err| = {err}")
    return err


def phase_kernels(dev, card: str):
    """Each kernel against its plain version, exact; returns the table."""
    from video_encoder_tpu_torch.codec import entropy, tables
    from video_encoder_tpu_torch.ops import dispatch
    from video_encoder_tpu_torch.pipeline.gop_engine import block_words_for_qp

    rng = np.random.default_rng(7)

    def both(fn, *args):
        dispatch.force(None)
        got = fn(*args)
        dispatch.force("plain")
        want = fn(*args)
        dispatch.force(None)
        torch.cuda.synchronize()
        return got, want

    def timed(fn, *args):
        dispatch.force(None)
        ms = time_ms(lambda: fn(*args))
        dispatch.force("plain")
        plain_ms = time_ms(lambda: fn(*args))
        dispatch.force(None)
        return ms, plain_ms

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    rows = {}

    def record(name, src, replaces, err, ms=None, plain_ms=None):
        row = rows.setdefault(name, dict(
            name=name, route="cuda", source=f"video_encoder_tpu_torch/csrc/{src}",
            replaces=replaces, launches=0, max_abs_err=0, ms=None, plain_ms=None))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if ms is not None:
            row.update(ms=ms, plain_ms=plain_ms)

    luma = [(1088, 1920), (368, 640)]
    chroma = [(544, 960), (184, 320)]

    # full search: a pan that puts the best match at the (+16, -16) corner,
    # and a flat region where all 1089 candidates tie
    for h, w in luma:
        tex = texture(rng, h, w)
        cur = tex[64:64 + h, 64:64 + w].copy()
        ref = tex[48:48 + h, 80:80 + w] + rng.integers(-3, 4, (h, w))
        cur[:128, :256] = 100
        ref[:160, :288] = 100
        cur_t, ref_t = t32(cur), t32(np.clip(ref, 0, 255))
        got, want = both(dispatch.full_search, cur_t, ref_t)
        err = max_abs_err(got, want)
        corner = int(((got[0] == 16) & (got[1] == -16)).sum())
        ms = plain_ms = None
        if (h, w) == luma[0]:
            ms, plain_ms = timed(dispatch.full_search, cur_t, ref_t)
        record("full_search", "full_search.cu",
               "video_encoder_tpu/ops/pallas/sad.py:68", err, ms, plain_ms)
        log(f"kernel full_search {h}x{w}: equal, {corner} MBs at mv (16,-16)"
            + (f", {ms:.4f} ms vs plain {plain_ms:.4f} ms [{card}]" if ms else ""))

    # MC fetch: random mvs over the whole range, corners forced to the edges
    for (h, w), (ch, cw) in zip(luma, chroma):
        for name, (ph, pw), bs, fn in (
                ("mc_fetch_luma", (h, w), 16, dispatch.mc_fetch_luma_plane),
                ("mc_fetch_chroma", (ch, cw), 8, dispatch.mc_fetch_chroma_plane)):
            ref_t = t32(rng.integers(0, 256, (ph, pw)))
            nby, nbx = ph // bs, pw // bs
            dy = rng.integers(-bs, bs + 1, (nby, nbx))
            dx = rng.integers(-bs, bs + 1, (nby, nbx))
            for yy, xx, sy, sx in ((0, 0, -1, -1), (0, -1, -1, 1),
                                   (-1, 0, 1, -1), (-1, -1, 1, 1)):
                dy[yy, xx], dx[yy, xx] = sy * bs, sx * bs
            args = (ref_t, t32(dy), t32(dx))
            got, want = both(fn, *args)
            err = max_abs_err([got], [want])
            ms = plain_ms = None
            if (ph, pw) in ((1088, 1920), (544, 960)):
                ms, plain_ms = timed(fn, *args)
            record(name, "mc_fetch.cu",
                   "video_encoder_tpu/ops/pallas/sad.py:724", err, ms, plain_ms)
            log(f"kernel {name} {ph}x{pw}: equal"
                + (f", {ms:.4f} ms vs plain {plain_ms:.4f} ms [{card}]" if ms else ""))

    # code_plane: per-block qp mixing 1, 28 and 63; midpoint and deadzone
    # bias; block_pack on the levels it produces (qp 1 overflows 16 words)
    levels_for_pack = None
    for h, w in [(1088, 1920), (544, 960), (368, 640)]:
        tex = texture(rng, h, w)
        cur_t = t32(tex[:h, :w])
        pred_t = t32(np.clip(tex[3:3 + h, 5:5 + w] + rng.integers(-20, 21, (h, w)), 0, 255))
        qp = rng.choice([1, 28, 63], (h // 8, w // 8))
        q_blk = tables.load(dev).QSTEP[t32(qp).long()].contiguous()
        for qbias in (8, 5):
            got, want = both(dispatch.code_plane, cur_t, pred_t, q_blk, qbias)
            err = max_abs_err(got, want)
            ms = plain_ms = None
            if (h, w) == (1088, 1920) and qbias == 8:
                q28 = torch.full_like(q_blk, int(tables.load(dev).QSTEP[28]))
                ms, plain_ms = timed(dispatch.code_plane, cur_t, pred_t, q28, 8)
                levels_for_pack = dispatch.code_plane(cur_t, pred_t, q28, 8)[0]
            record("code_plane", "code_plane.cu",
                   "video_encoder_tpu/ops/pallas/codec.py:96", err, ms, plain_ms)
            log(f"kernel code_plane {h}x{w} qbias {qbias}: equal"
                + (f", {ms:.4f} ms vs plain {plain_ms:.4f} ms [{card}]" if ms else ""))
            for n_words in (16, entropy.BLOCK_WORDS_MAX):
                lv = got[0].reshape(-1, 64)
                gp, wp = both(dispatch.block_pack, lv, n_words)
                err = max_abs_err(gp, wp)
                over = int((gp[1] > 32 * n_words).sum())
                record("block_pack", "block_pack.cu",
                       "video_encoder_tpu/ops/pallas/entropy_pack.py:116", err)
                log(f"kernel block_pack {lv.shape[0]} blocks, {n_words} words: "
                    f"equal, {over} blocks overflow")

    # dense random levels at the quantizer's extremes: every block overflows
    lv = t32(rng.integers(-3925, 3926, (4096, 64)))
    gp, wp = both(dispatch.block_pack, lv, 16)
    max_abs_err(gp, wp)
    if not bool((gp[1] > 512).all()):
        raise AssertionError("dense blocks should overflow 16 words")
    bw = block_words_for_qp(28)
    ms, plain_ms = timed(dispatch.block_pack, levels_for_pack.reshape(-1, 64), bw)
    record("block_pack", "block_pack.cu",
           "video_encoder_tpu/ops/pallas/entropy_pack.py:116", 0, ms, plain_ms)
    log(f"kernel block_pack dense overflow: equal; 1080p luma qp 28, {bw} words: "
        f"{ms:.4f} ms vs plain {plain_ms:.4f} ms [{card}]")
    return rows


def build_oracle() -> None:
    """The C++ oracle, built into build/oracle/ (never into oracle/)."""
    os.makedirs(os.path.dirname(ORACLE_BIN), exist_ok=True)
    subprocess.run(["g++", "-O2", "-std=c++17", "-pthread", "-o", ORACLE_BIN,
                    ORACLE_SRC], check=True)


def write_clip(path, ys, cbs, crs):
    with open(path, "wb") as f:
        for y, cb, cr in zip(ys, cbs, crs):
            f.write(y.tobytes() + cb.tobytes() + cr.tobytes())


def phase_slice(tmp, w, h, n, gop, card, expect_all_kernels):
    """Port CLI encode on the card vs the C++ oracle, byte for byte."""
    from video_encoder_tpu_torch import cli
    from video_encoder_tpu_torch.ops.kernels import build

    ys, cbs, crs = synth_clip(n, h, w, seed=11)
    raw = os.path.join(tmp, f"in_{w}x{h}.yuv")
    ours = os.path.join(tmp, f"port_{w}x{h}.tvc")
    theirs = os.path.join(tmp, f"oracle_{w}x{h}.tvc")
    dec = os.path.join(tmp, f"dec_{w}x{h}.yuv")
    write_clip(raw, ys, cbs, crs)

    build.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["encode", "-i", raw, "-W", str(w), "-H", str(h),
                       "-o", ours, "--gop", str(gop), "--qp", "28",
                       "--search", "full", "--format", "1", "--rc", "none",
                       "--device", "cuda"])
    launches = dict(build.LAUNCHES)
    if rc != 0:
        raise RuntimeError(f"port encode exited {rc}")
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    missing = [k for k, v in launches.items() if v == 0 and (
        expect_all_kernels or k in ("code_plane", "block_pack"))]
    if missing:
        raise AssertionError(f"kernels not launched by the encode: {missing}")

    t0 = time.perf_counter()
    subprocess.run([ORACLE_BIN, "encode", raw, theirs, str(w), str(h),
                    str(gop), "28", "full", "none", "0"],
                   check=True, capture_output=True)
    oracle_s = time.perf_counter() - t0
    with open(ours, "rb") as f1, open(theirs, "rb") as f2:
        a, b = f1.read(), f2.read()
    if a != b:
        i = next((k for k in range(min(len(a), len(b))) if a[k] != b[k]),
                 min(len(a), len(b)))
        raise AssertionError(f"{w}x{h}: port stream ({len(a)} B) differs from "
                             f"the oracle's ({len(b)} B) at byte {i}")
    subprocess.run([ORACLE_BIN, "decode", theirs, dec], check=True,
                   capture_output=True)
    dy = np.fromfile(dec, np.uint8).reshape(n, h * w * 3 // 2)[:, :h * w]
    src = np.stack(ys).reshape(n, h * w).astype(np.float64)
    mse = float(((dy.astype(np.float64) - src) ** 2).mean())
    psnr_y = 10 * np.log10(255.0 ** 2 / mse)
    if not (np.isfinite(psnr_y) and psnr_y > 30.0):
        raise AssertionError(f"{w}x{h}: decoded PSNR-Y {psnr_y:.3f} dB")
    log(f"slice {w}x{h} GOP {gop}, {n} frames: port stream == oracle stream "
        f"({len(a)} bytes), oracle decode PSNR-Y {psnr_y:.4f} dB, "
        f"launches {launches}")
    log(f"  port CLI wall {summary['wall_s']} s = {summary['wall_fps']} fps "
        f"[{card}]; oracle CPU encode {oracle_s:.2f} s")
    return launches, summary, (ys, cbs, crs)


def phase_speed(clip, card):
    """Device-resident 1080p GOP-30 fps: upload once, loop, sync once."""
    from video_encoder_tpu_torch.pipeline.gop_engine import EncoderConfig, GopEngine

    ys, cbs, crs = clip
    h, w = ys[0].shape
    eng = GopEngine(EncoderConfig(width=w, height=h, gop_n=len(ys), base_qp=28),
                    device="cuda")

    def up(planes, mult):
        a = np.stack([np.pad(p, ((0, -p.shape[0] % mult), (0, -p.shape[1] % mult)),
                             mode="edge") for p in planes])
        return torch.from_numpy(a).cuda()

    y, cb, cr = up(ys, 16), up(cbs, 8), up(crs, 8)
    outs = eng.run(y, cb, cr, 28)
    torch.cuda.synchronize()
    if bool(outs["ovf"].any()):
        raise AssertionError("speed clip overflowed its budget")
    iters = 5
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        eng.run(y, cb, cr, 28)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fps = iters * len(ys) / dt
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"speed: device-resident {w}x{h} GOP {len(ys)} encode {fps:.3f} fps "
        f"({dt / (iters * len(ys)) * 1e3:.3f} ms/frame, {iters} GOPs, peak "
        f"{peak:.0f} MiB) [{card}]")
    return fps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs one GPU",
              file=sys.stderr)
        return 1
    from video_encoder_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    build.lib()
    log(f"build: kernels in {time.perf_counter() - t0:.2f} s (nvcc "
        f"{build.build_seconds:.2f} s)")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")

    rows = phase_kernels(dev, card)

    build_oracle()
    with tempfile.TemporaryDirectory() as tmp:
        launches, summary, clip = phase_slice(tmp, 1920, 1080, 30, 30, card, True)
        phase_slice(tmp, 640, 360, 30, 1, card, False)
    for name, row in rows.items():
        row["launches"] = launches[name]
    fps = phase_speed(clip, card)
    log(f"result: 1080p GOP-30 device-resident {fps:.3f} fps, CLI wall "
        f"{summary['wall_fps']} fps [{card}]")

    print(card)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
