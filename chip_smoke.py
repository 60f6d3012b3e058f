"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code not 0):

1. Device: requires CUDA; prints the card's name and power limit.
2. Build: compiles every kernel under video_encoder_tpu_torch/csrc/.
3. Kernels: each of the eight kernels against its plain PyTorch version
   on the card at the main paths' shapes (1088x1920 luma, 544x960 chroma,
   the odd 368x640 grid, the span strings of real 1080p and 320x192
   frames and dense overflowing pieces), exact equality (tolerance 0: the
   codec is integer-only), with both times.
4. Paths: the port CLI encodes a 1920x1080 I420 clip of 30 frames (GOP 30,
   qp 28, format 1) in-process on the card, once with full search and rc
   none and once, on a smoother texture, with diamond search, rc mb and
   --kbps 12000 (BASELINE config 3), each under the engine's default
   emit; each stream must be
   byte-identical to the C++ oracle's, the oracle decodes it and PSNR-Y is
   checked. The config-3 clip is then encoded in-process under the other
   emit and must give the same packets. Launch counts are zeroed before
   and read after each path; every kernel of a path must have launched.
   Then 640x360 at GOP 1 (odd 23-row MB grid).
5. Speed: device-resident 1080p GOP-30 encode fps, without and with each
   GOP's finish, for {full, rc none; diamond, rc mb} x {frame, chunks}
   (the emits timed in turns), each with its device ops per frame, busy
   share and top device times from torch.profiler, and the CLI's wall fps.

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


def texture(rng, h: int, w: int, passes: int = 2) -> np.ndarray:
    """Smoothed random texture [h + 128, w + 128] int32 in [0, 255]."""
    base = rng.integers(0, 256, (h + 128, w + 128)).astype(np.int32)
    for _ in range(passes):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
                + np.roll(base, 2, 0) + np.roll(base, 2, 1)) // 5
    return base


def synth_clip(t: int, h: int, w: int, seed: int, passes: int = 2):
    """Panning texture, a moving random patch, mild noise; flat chroma.
    More smoothing passes (contrast stretched back to 0-255) give the
    larger-scale texture that a diamond descent can follow: on the
    two-pass texture it stalls in a local minimum for about a third of
    the MBs."""
    rng = np.random.default_rng(seed)
    base = texture(rng, h, w, passes)
    if passes > 2:
        base = (base - base.min()) * 255 // max(int(np.ptp(base)), 1)
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

    # sad_map_even: the full-search pan (best even mv on the (+16, -16)
    # corner) and a flat region where all 289 candidates tie
    seen = [0, 0]
    for h, w in luma:
        tex = texture(rng, h, w)
        cur = tex[64:64 + h, 64:64 + w].copy()
        ref = tex[48:48 + h, 80:80 + w] + rng.integers(-3, 4, (h, w))
        cur[:128, :256] = 100
        ref[:160, :288] = 100
        cur_t, ref_t = t32(cur), t32(np.clip(ref, 0, 255))
        got, want = both(dispatch.sad_map_even, cur_t, ref_t)
        err = max_abs_err([got], [want])
        best = got.argmin(-1)
        corner = int((best == 16 * 17).sum())          # (dy, dx) = (16, -16)
        ties = int((got == got[..., :1]).all(-1).sum())
        ms = plain_ms = None
        if (h, w) == luma[0]:
            ms, plain_ms = timed(dispatch.sad_map_even, cur_t, ref_t)
        record("sad_map_even", "full_search.cu",
               "video_encoder_tpu/ops/pallas/sad.py:594", err, ms, plain_ms)
        log(f"kernel sad_map_even {h}x{w}: equal, {corner} MBs best at "
            f"(16,-16), {ties} MBs with all 289 tied"
            + (f", {ms:.4f} ms vs plain {plain_ms:.4f} ms [{card}]" if ms else ""))
        seen = [seen[0] + corner, seen[1] + ties]
    if not all(seen):
        raise AssertionError("sad_map_even: edge or tie case not exercised")

    # sad_at_mv: K = 4 candidates over the whole ±16 range, corners forced
    for h, w in luma:
        cur_t = t32(rng.integers(0, 256, (h, w)))
        ref_t = t32(rng.integers(0, 256, (h, w)))
        dy = rng.integers(-16, 17, (4, h // 16, w // 16))
        dx = rng.integers(-16, 17, (4, h // 16, w // 16))
        for k, (sy, sx) in enumerate(((-1, -1), (-1, 1), (1, -1), (1, 1))):
            dy[k, 0, 0], dx[k, 0, 0] = 16 * sy, 16 * sx
            dy[k, -1, -1], dx[k, -1, -1] = -16 * sy, -16 * sx
        args = (cur_t, ref_t, t32(dy), t32(dx))
        got, want = both(dispatch.sad_at_mv, *args)
        err = max_abs_err([got], [want])
        ms = plain_ms = None
        if (h, w) == luma[0]:
            ms, plain_ms = timed(dispatch.sad_at_mv, *args)
        record("sad_at_mv", "sad_at.cu",
               "video_encoder_tpu/ops/pallas/sad.py:852", err, ms, plain_ms)
        log(f"kernel sad_at_mv {h}x{w} K=4: equal"
            + (f", {ms:.4f} ms vs plain {plain_ms:.4f} ms [{card}]" if ms else ""))

    # span merges: the pieces of real frames (1080p: two stages at 16
    # words; 320x192: one stage) and dense pieces that overflow the budget
    for name, (h, w), dense in (("1080p frame", (1088, 1920), False),
                                ("320x192 frame", (192, 320), False),
                                ("dense pieces", (256, 128), True)):
        srcs, plan = span_sources(rng, dev, h, w, dense)
        got, want = both(dispatch.span_merge_mb, *srcs, plan.m1, plan.cw1,
                         plan.n1)
        err = max_abs_err(got, want)
        ms = plain_ms = None
        if name == "1080p frame":
            ms, plain_ms = timed(dispatch.span_merge_mb, *srcs, plan.m1,
                                 plan.cw1, plan.n1)
        record("span_merge_mb", "span_merge.cu",
               "video_encoder_tpu/ops/pallas/pack.py:448", err, ms, plain_ms)
        ovf = bool(got[2])
        log(f"kernel span_merge_mb {name}: {plan.n1} strings of {plan.m1} "
            f"pieces, {plan.cw1} words: equal, overflow {ovf}"
            + (f", {ms:.4f} ms vs plain {plain_ms:.4f} ms [{card}]" if ms else ""))
        if ovf != dense:
            raise AssertionError(f"span_merge_mb {name}: overflow {ovf}")
        if plan.two_stage:
            args = (got[0], got[1], plan.g, plan.stop, plan.cwf)
            got2, want2 = both(dispatch.span_merge, *args)
            err = max_abs_err(got2, want2)
            ms, plain_ms = timed(dispatch.span_merge, *args)
            record("span_merge", "span_merge.cu",
                   "video_encoder_tpu/ops/pallas/pack.py:296", err, ms, plain_ms)
            log(f"kernel span_merge {name}: {plan.n_strings} strings of "
                f"{plan.cwf} words: equal, overflow {bool(got2[2])}, "
                f"{ms:.4f} ms vs plain {plain_ms:.4f} ms [{card}]")
    return rows


def span_sources(rng, dev, h, w, dense):
    """Per-MB piece sources of one frame for the span merges: a real
    frame's (code_plane at qp 28, block_pack at 16 words, random
    vectors), or pieces of 300 bits that fit their 512-bit blocks but
    overflow the budgeted span width (tests/test_merge_budget_overflow.py)."""
    from video_encoder_tpu_torch.codec import entropy, pack, tables
    from video_encoder_tpu_torch.ops import dispatch

    nby, nbx = h // 16, w // 16
    q28 = int(tables.load(dev).QSTEP[28])
    if dense:
        def lv(bh, bw_):    # ~36 nonzero ±1..2 levels: 250-350 bits a block
            a = np.zeros((bh, bw_, 64), np.int32)
            m = rng.random(a.shape) < 0.55
            a[m] = rng.integers(1, 3, m.sum()) * rng.choice([-1, 1], m.sum())
            return torch.from_numpy(a).to(dev)
        levels = (lv(2 * nby, 2 * nbx), lv(nby, nbx), lv(nby, nbx))
    else:
        levels = []
        for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
            tex = texture(rng, ph, pw)
            cur = torch.from_numpy(tex[:ph, :pw].astype(np.int32)).to(dev)
            pred = np.clip(tex[:ph, :pw] + rng.integers(-3, 4, (ph, pw)), 0, 255)
            pred = torch.from_numpy(pred.astype(np.int32)).to(dev)
            q = torch.full((ph // 8, pw // 8), q28, dtype=torch.int32, device=dev)
            levels.append(dispatch.code_plane(cur, pred, q, 8)[0])

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    qpd = t32(rng.integers(-2, 3, (nby, nbx)))
    inter = torch.from_numpy(rng.random((nby, nbx)) < 0.7).to(dev)
    dy, dx = (t32(rng.integers(-16, 17, (nby, nbx))) for _ in range(2))
    (hw, yw, cbw, crw), bits7, _ = entropy._mb_sources(
        *levels, qpd, True, inter, dy, dx, 16)
    piece_bits = torch.nn.functional.pad(bits7, (0, 1)).reshape(-1).contiguous()
    srcs = (hw.contiguous(), yw.contiguous(), cbw.contiguous(),
            crw.contiguous(), piece_bits)
    return srcs, pack.span_plan(nby * nbx, 16)


def build_oracle() -> None:
    """The C++ oracle, built into build/oracle/ (never into oracle/)."""
    os.makedirs(os.path.dirname(ORACLE_BIN), exist_ok=True)
    subprocess.run(["g++", "-O2", "-std=c++17", "-pthread", "-o", ORACLE_BIN,
                    ORACLE_SRC], check=True)


def write_clip(path, ys, cbs, crs):
    with open(path, "wb") as f:
        for y, cb, cr in zip(ys, cbs, crs):
            f.write(y.tobytes() + cb.tobytes() + cr.tobytes())


FULL = dict(search="full", rc="none", kbps=0, passes=2)
# BASELINE config 3 on the four-pass texture, which spends about twice
# 12000 kbps at qp 28 without rate control, so the frame carry and the
# per-MB offsets both work
CONFIG3 = dict(search="diamond", rc="mb", kbps=12000, passes=4)
PATH_KERNELS = {   # the kernels each path must launch
    "full": ["full_search", "mc_fetch_luma", "mc_fetch_chroma", "code_plane",
             "block_pack"],
    "diamond": ["sad_map_even", "sad_at_mv", "mc_fetch_luma",
                "mc_fetch_chroma", "code_plane", "block_pack"],
    "chunks": ["span_merge_mb", "span_merge"],
}


def expected_kernels(search, emit, intra_only=False):
    if intra_only:
        return ["code_plane", "block_pack"]
    return PATH_KERNELS[search] + (PATH_KERNELS["chunks"] if emit == "chunks"
                                   else [])


def check_launches(what, launches, expected):
    missing = [k for k in expected if launches[k] == 0]
    if missing:
        raise AssertionError(f"{what}: kernels not launched: {missing}")


def phase_slice(tmp, w, h, n, gop, card, mode):
    """Port CLI encode on the card vs the C++ oracle, byte for byte.
    Returns (launches of this path, CLI summary, clip, packets)."""
    from video_encoder_tpu_torch import cli
    from video_encoder_tpu_torch.ops.kernels import build
    from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

    ys, cbs, crs = synth_clip(n, h, w, seed=11, passes=mode["passes"])
    tag = f"{w}x{h}_{mode['search']}_{mode['rc']}"
    raw = os.path.join(tmp, f"in_{tag}.yuv")
    ours = os.path.join(tmp, f"port_{tag}.tvc")
    theirs = os.path.join(tmp, f"oracle_{tag}.tvc")
    dec = os.path.join(tmp, f"dec_{tag}.yuv")
    write_clip(raw, ys, cbs, crs)

    build.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["encode", "-i", raw, "-W", str(w), "-H", str(h),
                       "-o", ours, "--gop", str(gop), "--qp", "28",
                       "--search", mode["search"], "--format", "1",
                       "--rc", mode["rc"], "--kbps", str(mode["kbps"]),
                       "--device", "cuda"])
    launches = dict(build.LAUNCHES)
    if rc != 0:
        raise RuntimeError(f"port encode exited {rc}")
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    check_launches(f"{tag} CLI encode", launches,
                   expected_kernels(mode["search"], GopEngine.emit, gop == 1))

    t0 = time.perf_counter()
    subprocess.run([ORACLE_BIN, "encode", raw, theirs, str(w), str(h),
                    str(gop), "28", mode["search"], mode["rc"],
                    str(mode["kbps"])], check=True, capture_output=True)
    oracle_s = time.perf_counter() - t0
    with open(ours, "rb") as f1, open(theirs, "rb") as f2:
        a, b = f1.read(), f2.read()
    if a != b:
        i = next((k for k in range(min(len(a), len(b))) if a[k] != b[k]),
                 min(len(a), len(b)))
        raise AssertionError(f"{tag}: port stream ({len(a)} B) differs from "
                             f"the oracle's ({len(b)} B) at byte {i}")
    subprocess.run([ORACLE_BIN, "decode", theirs, dec], check=True,
                   capture_output=True)
    dy = np.fromfile(dec, np.uint8).reshape(n, h * w * 3 // 2)[:, :h * w]
    src = np.stack(ys).reshape(n, h * w).astype(np.float64)
    mse = float(((dy.astype(np.float64) - src) ** 2).mean())
    psnr_y = 10 * np.log10(255.0 ** 2 / mse)
    if not (np.isfinite(psnr_y) and psnr_y > 30.0):
        raise AssertionError(f"{tag}: decoded PSNR-Y {psnr_y:.3f} dB")
    log(f"slice {tag} GOP {gop}, {n} frames, emit {GopEngine.emit}: port "
        f"stream == oracle stream ({len(a)} bytes), oracle decode PSNR-Y "
        f"{psnr_y:.4f} dB, launches {launches}")
    log(f"  port CLI wall {summary['wall_s']} s = {summary['wall_fps']} fps "
        f"[{card}]; oracle CPU encode {oracle_s:.2f} s")
    return launches, summary, (ys, cbs, crs), a


def phase_other_emit(clip, stream, card):
    """The config-3 clip in-process under the emit the CLI did not use:
    the same packets as the CLI's stream."""
    from video_encoder_tpu_torch.cli import OrderedMux
    from video_encoder_tpu_torch.ops.kernels import build
    from video_encoder_tpu_torch.pipeline.gop_engine import (EncoderConfig,
                                                             Frame, GopEngine)

    ys, cbs, crs = clip
    h, w = ys[0].shape
    emit = "chunks" if GopEngine.emit == "frame" else "frame"
    cfg = EncoderConfig(width=w, height=h, gop_n=len(ys), base_qp=28,
                        search=CONFIG3["search"], rc=CONFIG3["rc"],
                        target_kbps=CONFIG3["kbps"])
    frames = [Frame.from_planes(*p) for p in zip(ys, cbs, crs)]
    eng = GopEngine(cfg, device="cuda", emit=emit)
    build.reset_launches()
    packets, stats = eng.encode_gop(frames, 0)
    launches = dict(build.LAUNCHES)
    check_launches(f"config 3 in-process, emit {emit}", launches,
                   expected_kernels(CONFIG3["search"], emit))
    buf = io.BytesIO()
    mux = OrderedMux(buf, cfg, len(frames))
    for pkt in packets:
        mux.push(pkt)
    mux.close()
    if buf.getvalue() != stream:
        raise AssertionError(f"config 3 under emit {emit} differs from the "
                             "CLI's stream")
    qps = [st.base_qp for st in stats]
    log(f"other emit: config 3 in-process, emit {emit}: same stream "
        f"({len(stream)} bytes), frame qps {qps}, launches {launches}")
    if len(set(qps)) < 2:
        raise AssertionError("config 3: the rate control never moved qp")
    return launches


def device_ops(run_once, n_frames):
    """Device kernels (and memsets/copies) per frame, the device busy share
    and the largest device-time totals by name, of one GOP under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_once()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None, None, []
    by_name = {}
    for e in dev:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    busy = sum(us for _, us in by_name.values())
    span = (max(e.time_range.end for e in dev)
            - min(e.time_range.start for e in dev))
    return len(dev) / n_frames, busy / max(span, 1), [
        (name[:60], n, round(us / 1e3, 3)) for name, (n, us) in top]


def phase_speed(clips, card):
    """Device-resident 1080p GOP-30 fps (upload once, loop, sync once), and
    the same with each GOP's finish (sync, download, payload glue,
    packets), for {full rc none, diamond rc mb} x {frame, chunks}. The two
    emits are timed in turns (frame, chunks, chunks, frame) on one card;
    each figure is the mean of its two turns."""
    from video_encoder_tpu_torch.pipeline.gop_engine import (EncoderConfig,
                                                             Frame, GopEngine)

    def up(planes, mult):
        a = np.stack([np.pad(p, ((0, -p.shape[0] % mult), (0, -p.shape[1] % mult)),
                             mode="edge") for p in planes])
        return torch.from_numpy(a).cuda()

    results = {}
    for mode, (ys, cbs, crs) in clips:
        h, w = ys[0].shape
        n = len(ys)
        frames = [Frame.from_planes(*p) for p in zip(ys, cbs, crs)]
        y, cb, cr = up(ys, 16), up(cbs, 8), up(crs, 8)
        cfg = EncoderConfig(width=w, height=h, gop_n=n, base_qp=28,
                            search=mode["search"], rc=mode["rc"],
                            target_kbps=mode["kbps"])
        engines, reruns, times = {}, {}, {}
        for emit in ("frame", "chunks"):
            eng = engines[emit] = GopEngine(cfg, device="cuda", emit=emit)
            # the engine reruns a GOP that overflows its budgets
            reruns[emit] = bool(eng.run(y, cb, cr, 28)["ovf"].any())
            times[emit] = [0.0, 0.0]

        def gop(emit):
            eng = engines[emit]
            eng.run(y, cb, cr, 28)
            if reruns[emit]:
                eng.run(y, cb, cr, 28, xl=True)

        def finished_gop(emit):
            eng = engines[emit]
            eng.encode_gop_finish(dict(
                frames=frames, first_index=0, base_qp=28, y=y, cb=cb, cr=cr,
                outs=eng.run(y, cb, cr, 28), t0=time.perf_counter()))

        iters = 2
        for emit in ("frame", "chunks", "chunks", "frame"):
            gop(emit)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                gop(emit)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(iters):
                finished_gop(emit)
            t2 = time.perf_counter()
            times[emit][0] += t1 - t0
            times[emit][1] += t2 - t1
        for emit in ("frame", "chunks"):
            frames_timed = 2 * iters * n
            fps = frames_timed / times[emit][0]
            fin_fps = frames_timed / times[emit][1]
            torch.cuda.reset_peak_memory_stats()
            ops, busy, top = device_ops(lambda: gop(emit), n)
            peak = torch.cuda.max_memory_allocated() / 2**20
            key = f"{mode['search']}/{mode['rc']}/{emit}"
            results[key] = dict(resident=fps, with_finish=fin_fps)
            log(f"speed: device-resident {w}x{h} GOP {n} {key} {fps:.3f} fps "
                f"({1e3 / fps:.3f} ms/frame, {2 * iters} GOPs, rerun "
                f"{reruns[emit]}, peak {peak:.0f} MiB), with finish "
                f"{fin_fps:.3f} fps; one GOP traced: "
                f"{ops if ops is None else round(ops, 1)} device ops/frame, "
                f"device busy {busy if busy is None else round(100 * busy, 1)}"
                f" % [{card}]")
            log(f"  device ms per GOP by name (launches, ms): {top}")
    return results


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
    path_launches = []
    with tempfile.TemporaryDirectory() as tmp:
        launches, summary, clip, _ = phase_slice(tmp, 1920, 1080, 30, 30,
                                                 card, FULL)
        path_launches.append(launches)
        launches, summary3, clip3, stream3 = phase_slice(
            tmp, 1920, 1080, 30, 30, card, CONFIG3)
        path_launches.append(launches)
        path_launches.append(phase_other_emit(clip3, stream3, card))
        phase_slice(tmp, 640, 360, 30, 1, card, FULL)
    for name, row in rows.items():
        row["launches"] = sum(p[name] for p in path_launches)
    check_launches("the main paths", {k: r["launches"] for k, r in rows.items()},
                   list(rows))
    fps = phase_speed([(FULL, clip), (CONFIG3, clip3)], card)
    log(f"result: 1080p GOP-30 device-resident fps {json.dumps(fps)}; CLI wall "
        f"full {summary['wall_fps']} fps, config 3 {summary3['wall_fps']} fps "
        f"[{card}]")

    print(card)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
