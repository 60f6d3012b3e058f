"""GOP-resident encoder on one device: the port's production path.

Twin of `video_encoder_tpu/pipeline/gop_engine.py` for full search,
format 1, rc none and frame emit. A Python loop over the GOP's frames
replaces `lax.scan`; the reconstruction stays on the device as the next
frame's reference, and the kernels launch asynchronously on the current
stream. The host waits once per GOP, for the overflow flag: payload
capacity is budgeted, and a GOP whose pack overflows any budget is encoded
again at the exact worst-case capacities (the bytes are the same either
way, SPEC.md §11 invariant 2).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from video_encoder_tpu.codec.bitstream import FramePacket
from video_encoder_tpu.codec.config import EncoderConfig
from video_encoder_tpu.codec.golden import Frame
from video_encoder_tpu.utils.metrics import FrameStats

from ..codec import entropy, tables
from ..ops import dispatch, motion
from ..ops import transform as tx


def block_words_for_qp(qp: int) -> int:
    """Per-8x8-block word budget; finer quantizers keep more coefficients.
    An overflow re-encodes the GOP at the exact worst case."""
    if qp >= 28:
        return 16
    if qp >= 20:
        return entropy.BLOCK_WORDS_DEFAULT
    if qp >= 14:
        return 48
    return entropy.BLOCK_WORDS_MAX


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available "
            "(pass device='cpu' to run the plain PyTorch versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def predict_p_traced(cur_y, ref_y, ref_cb, ref_cr, icost):
    """P-frame prediction: full search, mode decision (sad <= intra cost),
    luma and chroma MC; intra MBs predict flat 128. Returns (dy, dx,
    is_inter, pred_y, pred_cb, pred_cr)."""
    dy, dx, best_sad = dispatch.full_search(cur_y, ref_y)
    is_inter = best_sad <= icost
    m_y = is_inter.repeat_interleave(tables.MB, 0).repeat_interleave(tables.MB, 1)
    m_c = is_inter.repeat_interleave(tables.BLK, 0).repeat_interleave(tables.BLK, 1)
    cdy, cdx = dy >> 1, dx >> 1   # arithmetic shift, SPEC.md §2
    pred_y = torch.where(m_y, dispatch.mc_fetch_luma_plane(ref_y, dy, dx), 128)
    pred_cb = torch.where(m_c, dispatch.mc_fetch_chroma_plane(ref_cb, cdy, cdx), 128)
    pred_cr = torch.where(m_c, dispatch.mc_fetch_chroma_plane(ref_cr, cdy, cdx), 128)
    return dy, dx, is_inter, pred_y, pred_cb, pred_cr


def predict_i_traced(cur_y, cur_cb, cur_cr):
    """I-frame 'prediction': flat 128 planes, zero vectors, all intra."""
    nby, nbx = cur_y.shape[0] // tables.MB, cur_y.shape[1] // tables.MB
    z = torch.zeros((nby, nbx), dtype=torch.int32, device=cur_y.device)
    return (z, z.clone(), z.bool(), torch.full_like(cur_y, 128),
            torch.full_like(cur_cb, 128), torch.full_like(cur_cr, 128))


def _sse(a, b):
    d = (a - b).long()
    return (d * d).sum()


def code_pack_traced(cur_y, cur_cb, cur_cr, pred_y, pred_cb, pred_cr,
                     dy, dx, is_inter, is_p: bool, base_qp: int, *,
                     block_words: int, cap_words: int, qbias: int = 8):
    """Transform/quant/recon of the three planes and the frame-emit pack.
    Returns a dict of device tensors: words [cap_words] int64, bits, ovf,
    n_inter, rec_y/rec_cb/rec_cr and sse [3] int64."""
    nby, nbx = dy.shape
    qp_mb = torch.full((nby, nbx), base_qp, dtype=torch.int32,
                       device=cur_y.device)
    qs = tx.qstep(qp_mb)
    qy = qs.repeat_interleave(2, 0).repeat_interleave(2, 1)
    lz_y, rec_y = dispatch.code_plane(cur_y, pred_y, qy, qbias)
    lz_cb, rec_cb = dispatch.code_plane(cur_cb, pred_cb, qs, qbias)
    lz_cr, rec_cr = dispatch.code_plane(cur_cr, pred_cr, qs, qbias)
    words, total_bits, _, ovf = entropy.pack_frame_planes(
        lz_y, lz_cb, lz_cr, qp_mb - base_qp, is_p, is_inter, dy, dx,
        block_words, cap_words,
    )
    return dict(
        words=words, bits=total_bits, ovf=ovf,
        n_inter=is_inter.sum(), rec_y=rec_y, rec_cb=rec_cb, rec_cr=rec_cr,
        sse=torch.stack([_sse(cur_y, rec_y), _sse(cur_cb, rec_cb),
                         _sse(cur_cr, rec_cr)]),
    )


class GopEngine:
    """Host driver of the GOP-resident path on one device.

    encode_gop(frames, first_index) -> (packets, stats). `device` is
    explicit and defaults to "cuda"; nothing moves to the CPU on its own.
    """

    def __init__(self, cfg: EncoderConfig, device="cuda", emit: str = "frame"):
        if cfg.search != "full":
            raise NotImplementedError(
                f"search={cfg.search!r} is not ported yet (ROADMAP.md A10: "
                "diamond; hier is golden/oracle-only)")
        if cfg.format_version != 1:
            raise NotImplementedError(
                f"format {cfg.format_version} is not ported yet "
                "(ROADMAP.md A10)")
        if cfg.rc != "none":
            raise NotImplementedError(
                f"rc={cfg.rc!r} is not ported yet (ROADMAP.md A10)")
        if cfg.gop_devices != 1 or cfg.tile_devices != 1:
            raise NotImplementedError(
                "multi-device encode is not ported yet (ROADMAP.md A13)")
        if emit != "frame":
            raise NotImplementedError(
                f"emit={emit!r} is not ported yet (ROADMAP.md A8: chunk "
                "emit with super_merge_mb)")
        self.cfg = cfg
        self.emit = emit
        self.device = resolve_device(device)

    def run(self, y, cb, cr, base_qp: int, xl: bool = False):
        """Encode one GOP of [T, H, W] / [T, H/2, W/2] uint8 planes already
        on the engine's device; launches only, no host wait. xl selects the
        worst-case block and frame capacities. Returns stacked per-frame
        device tensors (words, bits, ovf, n_inter, sse)."""
        n_mbs = (y.shape[1] // tables.MB) * (y.shape[2] // tables.MB)
        if xl:
            bw, cap = entropy.BLOCK_WORDS_MAX, entropy.max_words(n_mbs)
        else:
            bw, cap = block_words_for_qp(base_qp), entropy.capacity_words(n_mbs)
        ref = None
        outs = []
        for t in range(y.shape[0]):
            cur = (y[t].to(torch.int32), cb[t].to(torch.int32),
                   cr[t].to(torch.int32))
            if ref is None:
                pred = predict_i_traced(*cur)
            else:
                _, icost = motion.intra_cost_and_dc(cur[0])
                pred = predict_p_traced(cur[0], *ref, icost)
            dy, dx, is_inter, pred_y, pred_cb, pred_cr = pred
            out = code_pack_traced(
                *cur, pred_y, pred_cb, pred_cr, dy, dx, is_inter, t > 0,
                base_qp, block_words=bw, cap_words=cap,
                qbias=self.cfg.quant_bias,
            )
            ref = (out["rec_y"], out["rec_cb"], out["rec_cr"])
            outs.append(out)
        return {k: torch.stack([o[k] for o in outs])
                for k in ("words", "bits", "ovf", "n_inter", "sse")}

    def encode_gop_start(self, frames: list[Frame], first_index: int,
                         base_qp: int | None = None):
        """Upload a GOP and launch its encode without waiting for it."""
        base_qp = self.cfg.base_qp if base_qp is None else base_qp
        t0 = time.perf_counter()

        def up(planes):
            a = np.stack(planes).astype(np.uint8)
            return torch.from_numpy(a).to(self.device)

        y = up([f.y for f in frames])
        cb = up([f.cb for f in frames])
        cr = up([f.cr for f in frames])
        outs = self.run(y, cb, cr, base_qp)
        return dict(frames=frames, first_index=first_index, base_qp=base_qp,
                    y=y, cb=cb, cr=cr, outs=outs, t0=t0)

    def encode_gop_finish(self, handle) -> tuple[list[FramePacket],
                                                 list[FrameStats]]:
        frames = handle["frames"]
        first_index = handle["first_index"]
        outs = handle["outs"]
        if bool(outs["ovf"].any()):   # the GOP's one wait on the device
            outs = self.run(handle["y"], handle["cb"], handle["cr"],
                            handle["base_qp"], xl=True)
        small = torch.cat([outs["bits"][:, None], outs["n_inter"][:, None],
                           outs["sse"]], 1).cpu().numpy()
        bits, n_inter, sse = small[:, 0], small[:, 1], small[:, 2:]
        maxw = int(bits.max() + 31) // 32
        words = outs["words"][:, :maxw].cpu().numpy()
        ms_total = (time.perf_counter() - handle["t0"]) * 1e3

        n_mbs = (frames[0].y.shape[0] // tables.MB) * (frames[0].y.shape[1] // tables.MB)
        npix_y, npix_c = frames[0].y.size, frames[0].cb.size

        def psnr(s, n):
            return 10 * math.log10(255.0**2 * n / s) if s > 0 else math.inf

        packets, stats = [], []
        for t in range(len(frames)):
            nw = (int(bits[t]) + 31) // 32
            payload = words[t, :nw].astype(">u4").tobytes()
            ftype = 0 if t == 0 else 1
            qp = handle["base_qp"]
            packets.append(FramePacket(first_index + t, ftype, qp,
                                       int(bits[t]), payload))
            stats.append(FrameStats(
                index=first_index + t, frame_type=ftype, base_qp=qp,
                bits=int(bits[t]),
                psnr_y=psnr(sse[t, 0], npix_y),
                psnr_cb=psnr(sse[t, 1], npix_c),
                psnr_cr=psnr(sse[t, 2], npix_c),
                ms=ms_total / len(frames),
                n_intra_mb=n_mbs - int(n_inter[t]) if ftype else n_mbs,
                n_inter_mb=int(n_inter[t]) if ftype else 0,
            ))
        return packets, stats

    def encode_gop(self, frames: list[Frame], first_index: int,
                   base_qp: int | None = None):
        """Synchronous upload, encode and download of one GOP."""
        return self.encode_gop_finish(
            self.encode_gop_start(frames, first_index, base_qp))
