"""GOP-resident encoder on one device: the port's production path.

Twin of `video_encoder_tpu/pipeline/gop_engine.py` for full and diamond
search, formats 1 to 4 (chroma qp offset, quant matrix, intra slices,
half-pel vectors), every rc mode (none, adaptive, bitrate, vbv, mb) and
both emits (frame and chunks). A Python loop over the GOP's frames replaces `lax.scan`; the
reconstruction, the frame qp and the vbv fullness stay on the device as
the next frame's reference and rate-control carry, and the kernels launch asynchronously
on the current stream. The host waits once per GOP, for the overflow
flag: payload capacity is budgeted, and a GOP whose pack overflows any
budget is encoded again at the exact worst-case capacities (the bytes are
the same either way, SPEC.md §11 invariant 2).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..codec import entropy, spec, tables
from ..codec.bitstream import FramePacket
from ..codec.config import EncoderConfig
from ..codec.frame import Frame
from ..codec.mux import bit_concat
from ..ops import dispatch, motion
from ..ops import transform as tx
from ..utils.metrics import FrameStats


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


def mb_rc_offsets(est: torch.Tensor) -> torch.Tensor:
    """rc=mb per-MB qp offsets (SPEC.md §10.4) from pass-1 per-MB bits
    [nby, nbx]: the integer program of spec.mb_rc_offsets, in int64, with
    floor division and the arithmetic >> 7 (floor by 128 for either
    sign). Returns int32 in [-2, 2]."""
    est = est.long()
    nbx = est.shape[-1]
    row_tot = est.sum(-1, keepdim=True).clamp(min=1)
    share = torch.div(est * 1024, row_tot, rounding_mode="floor")
    spent = torch.cumsum(share, -1) - share
    plan = torch.div(torch.arange(nbx, device=est.device) * 1024, nbx,
                     rounding_mode="floor")
    return ((spent - plan) >> 7).clamp(-2, 2).int()


def rc_carry_step(rc: str, target_bits: int, vbv_bits: int,
                  qp: torch.Tensor, fullness: torch.Tensor,
                  bits: torch.Tensor):
    """Frame-level rate-control carry (SPEC.md §10): the next frame's qp
    and vbv fullness from this frame's payload bits, on the device (0-dim
    tensors, int32 qp and int64 fullness), so the GOP loop never waits on
    the host. rc=bitrate and rc=mb share the proportional term; rc=vbv is
    spec.vbv_next, adding the buffer-pressure term. All in int64: (bits -
    target) * 4 passes int32 at high rates."""
    if rc not in ("bitrate", "mb", "vbv") or target_bits <= 0:
        return qp, fullness
    bits = bits.long()
    delta = torch.div((bits - target_bits) * 4, target_bits,
                      rounding_mode="floor").clamp(-2, 2)
    if rc == "vbv":
        fullness = (fullness + target_bits - bits).clamp(0, vbv_bits)
        delta = (delta + (fullness < vbv_bits // 4).long()
                 - (fullness > (3 * vbv_bits) // 4).long())
    return (qp + delta).clamp(tables.QP_MIN, tables.QP_MAX).int(), fullness


def predict_p_traced(cur_y, ref_y, ref_cb, ref_cr, icost, search: str,
                     fmt: int = 1):
    """P-frame prediction: motion search (full or diamond, plus the
    half-pel refine of format 4), mode decision (sad <= intra cost), luma
    and chroma MC; intra MBs predict flat 128. Returns (dy, dx, is_inter,
    pred_y, pred_cb, pred_cr); for fmt >= 4 the vectors are in half-pels
    (SPEC.md §14), the chroma vector dy >> 1 in chroma half-pels."""
    search_fn = {"full": dispatch.full_search,
                 "diamond": dispatch.diamond_search}[search]
    dy, dx, best_sad = search_fn(cur_y, ref_y)
    if fmt >= 4:
        planes_y = motion.hpel_stack(ref_y)
        dy, dx, best_sad = dispatch.hpel_refine(cur_y, ref_y, dy, dx, planes_y)
    is_inter = best_sad <= icost
    m_y = is_inter.repeat_interleave(tables.MB, 0).repeat_interleave(tables.MB, 1)
    m_c = is_inter.repeat_interleave(tables.BLK, 0).repeat_interleave(tables.BLK, 1)
    cdy, cdx = dy >> 1, dx >> 1   # arithmetic shift, SPEC.md §2
    if fmt >= 4:
        fetched = (dispatch.mc_fetch_luma_plane_hpel(ref_y, dy, dx, planes_y),
                   dispatch.mc_fetch_chroma_plane_hpel(ref_cb, cdy, cdx),
                   dispatch.mc_fetch_chroma_plane_hpel(ref_cr, cdy, cdx))
    else:
        fetched = (dispatch.mc_fetch_luma_plane(ref_y, dy, dx),
                   dispatch.mc_fetch_chroma_plane(ref_cb, cdy, cdx),
                   dispatch.mc_fetch_chroma_plane(ref_cr, cdy, cdx))
    pred_y = torch.where(m_y, fetched[0], 128)
    pred_cb = torch.where(m_c, fetched[1], 128)
    pred_cr = torch.where(m_c, fetched[2], 128)
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


def _plane_qsteps(qp_mb, cqpo: int):
    """Per-8x8-block quantizer steps of the three planes from per-MB qps:
    luma on its [2 nby, 2 nbx] grid, chroma at clip(qp + cqpo) (SPEC.md
    §12.2; cqpo 0 is format 1's)."""
    qs = tx.qstep(qp_mb)
    qy = qs.repeat_interleave(2, 0).repeat_interleave(2, 1).contiguous()
    qc = qs if cqpo == 0 else tx.qstep(
        (qp_mb + cqpo).clamp(tables.QP_MIN, tables.QP_MAX))
    return qy, qc.contiguous(), qc.contiguous()


def _code_frame(cur, pred, qp_mb, cqpo: int = 0, qbias: int = 8,
                qmat: bool = False):
    """Transform/quant/recon of the three planes at per-MB qps:
    ((levels_y8, levels_cb, levels_cr), (rec_y, rec_cb, rec_cr))."""
    coded = [dispatch.code_plane(c, p, q, qbias, qmat)
             for c, p, q in zip(cur, pred, _plane_qsteps(qp_mb, cqpo))]
    return tuple(lv for lv, _ in coded), tuple(rec for _, rec in coded)


def _code_intra3(cur, qp_mb, cqpo: int, qbias: int, qmat: bool, islice: int):
    """I frame of format >= 3 (SPEC.md §13.1): the vertical-intra row scan
    of each plane; the predictor resets every islice MB rows (2 * islice
    luma block rows, islice chroma block rows; 0 = never)."""
    coded = [dispatch.intra_rows_code_plane(c, q, qbias, reset, qmat)
             for c, q, reset in zip(cur, _plane_qsteps(qp_mb, cqpo),
                                    (2 * islice, islice, islice))]
    return tuple(lv for lv, _ in coded), tuple(rec for _, rec in coded)


def code_pack_traced(cur, pred, dy, dx, is_inter, is_p: bool,
                     qp: torch.Tensor, icost=None, *, rc: str, emit: str,
                     block_words: int, cap_words: int, fmt: int = 1,
                     cqpo: int = 0, qbias: int = 8, qmat: bool = False,
                     islice: int = 0):
    """Transform/quant/recon of the three planes and the entropy pack at
    the frame qp (a 0-dim int32 device tensor). rc="adaptive" sets per-MB
    qps from the intra cost icost; rc="mb" first codes the frame at the
    flat qp for its per-MB bit counts only, whose row pace offsets set
    the per-MB qps of the real pass (SPEC.md §10.4); headers code qp_mb -
    qp. From format 2 on chroma quantizes at qp + cqpo; I frames of
    format >= 3 go through the row scan in place of the flat-128
    prediction. emit="frame" assembles the payload (words [cap_words]);
    emit="chunks" stops at span strings (words [C, cw], cbits [C]).
    Returns a dict of device tensors: words, (cbits,) bits, ovf, n_inter,
    rec (three planes) and sse [3] int64."""
    nby, nbx = dy.shape
    cqpo = cqpo if fmt >= 2 else 0

    def code(qps):
        if fmt >= 3 and not is_p:
            return _code_intra3(cur, qps, cqpo, qbias, qmat, islice)
        return _code_frame(cur, pred, qps, cqpo, qbias, qmat)

    flat = qp.reshape(1, 1).expand(nby, nbx)
    if rc == "adaptive":
        qp_mb = motion.adaptive_qp(qp, icost)
    elif rc == "mb":
        levels, _ = code(flat)
        est = entropy.frame_mb_bits(*levels, flat - qp, is_p, is_inter,
                                    dy, dx, block_words, fmt)
        qp_mb = (qp + mb_rc_offsets(est)).clamp(tables.QP_MIN, tables.QP_MAX)
    else:
        qp_mb = flat
    levels, rec = code(qp_mb)
    args = (*levels, qp_mb - qp, is_p, is_inter, dy, dx, block_words)
    if emit == "chunks":
        words, cbits, _, ovf = entropy.pack_frame_chunks(*args, fmt=fmt)
        out = dict(words=words, cbits=cbits, bits=cbits.sum(dtype=torch.int64))
    else:
        words, bits, _, ovf = entropy.pack_frame_planes(*args, cap_words,
                                                        fmt=fmt)
        out = dict(words=words, bits=bits)
    out.update(ovf=ovf, n_inter=is_inter.sum(), rec=rec,
               sse=torch.stack([_sse(c, r) for c, r in zip(cur, rec)]))
    return out


class GopEngine:
    """Host driver of the GOP-resident path on one device.

    encode_gop(frames, first_index) -> (packets, stats). `device` is
    explicit and defaults to "cuda"; nothing moves to the CPU on its own.
    `emit` is "frame" (the device assembles each payload) or "chunks"
    (span strings glued on the host); both give the same bytes. The
    default is the one measured faster on the card (PERF.md).
    """

    emit = "frame"

    def __init__(self, cfg: EncoderConfig, device="cuda",
                 emit: str | None = None):
        if cfg.search not in ("full", "diamond"):
            raise ValueError(
                f"search={cfg.search!r} is not a device-engine mode (full, "
                "diamond); hier is golden/oracle-only")
        if cfg.gop_devices != 1 or cfg.tile_devices != 1:
            raise NotImplementedError(
                "multi-device encode is not ported yet (ROADMAP.md A13)")
        if emit not in (None, "frame", "chunks"):
            raise ValueError(f"unknown emit {emit!r} (frame, chunks)")
        self.cfg = cfg
        self.emit = emit or self.emit
        self.device = resolve_device(device)

    def run(self, y, cb, cr, base_qp: int, xl: bool = False):
        """Encode one GOP of [T, H, W] / [T, H/2, W/2] uint8 planes already
        on the engine's device; launches only, no host wait. xl selects the
        worst-case block and frame capacities. The frame qp and the vbv
        fullness are device scalars carried from frame to frame. Returns stacked
        per-frame device tensors: words, bits, ovf, n_inter, qp, sse, and
        cbits [T, C] under chunk emit."""
        cfg = self.cfg
        n_mbs = (y.shape[1] // tables.MB) * (y.shape[2] // tables.MB)
        if xl:
            bw, cap = entropy.BLOCK_WORDS_MAX, entropy.max_words(n_mbs)
        else:
            bw, cap = block_words_for_qp(base_qp), entropy.capacity_words(n_mbs)
        target_bits, vbv_bits = cfg.target_bits_per_frame(), cfg.vbv_bits()
        qp = torch.full((), base_qp, dtype=torch.int32, device=y.device)
        fullness = torch.full((), spec.vbv_init(vbv_bits), dtype=torch.int64,
                              device=y.device)
        ref = None
        outs = []
        for t in range(y.shape[0]):
            cur = (y[t].to(torch.int32), cb[t].to(torch.int32),
                   cr[t].to(torch.int32))
            icost = None
            if ref is not None or cfg.rc == "adaptive":
                _, icost = motion.intra_cost_and_dc(cur[0])
            if ref is None:
                pred = predict_i_traced(*cur)
            else:
                pred = predict_p_traced(cur[0], *ref, icost, cfg.search,
                                        cfg.format_version)
            dy, dx, is_inter = pred[:3]
            out = code_pack_traced(
                cur, pred[3:], dy, dx, is_inter, t > 0, qp, icost, rc=cfg.rc,
                emit=self.emit, block_words=bw, cap_words=cap,
                fmt=cfg.format_version, cqpo=cfg.chroma_qp_offset,
                qbias=cfg.quant_bias, qmat=cfg.quant_matrix,
                islice=cfg.intra_slice_mbrows,
            )
            out["qp"] = qp
            qp, fullness = rc_carry_step(cfg.rc, target_bits, vbv_bits, qp,
                                         fullness, out["bits"])
            ref = out["rec"]
            outs.append(out)
        keys = ["words", "bits", "ovf", "n_inter", "qp", "sse"]
        if self.emit == "chunks":
            keys.append("cbits")
        return {k: torch.stack([o[k] for o in outs]) for k in keys}

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
        chunked = "cbits" in outs
        cols = [outs["bits"][:, None], outs["n_inter"][:, None],
                outs["qp"][:, None], outs["sse"]]
        if chunked:
            cols.append(outs["cbits"])
        small = torch.cat(cols, 1).cpu().numpy()
        bits, n_inter, qps, sse = small[:, 0], small[:, 1], small[:, 2], small[:, 3:6]
        if chunked:
            # only the words up to the GOP's longest span string, as the
            # low 32 bits of each int64 word
            cbits = small[:, 6:]
            maxw = max(int(cbits.max() + 31) // 32, 1)
            words = (outs["words"][:, :, :maxw].contiguous()
                     .view(torch.int32)[..., ::2].cpu().numpy().view(np.uint32))
        else:
            maxw = int(bits.max() + 31) // 32
            words = outs["words"][:, :maxw].cpu().numpy()
        ms_total = (time.perf_counter() - handle["t0"]) * 1e3

        n_mbs = (frames[0].y.shape[0] // tables.MB) * (frames[0].y.shape[1] // tables.MB)
        npix_y, npix_c = frames[0].y.size, frames[0].cb.size

        def psnr(s, n):
            return 10 * math.log10(255.0**2 * n / s) if s > 0 else math.inf

        packets, stats = [], []
        for t in range(len(frames)):
            if chunked:
                payload, nbits = bit_concat(
                    [(words[t, c], int(b)) for c, b in enumerate(cbits[t]) if b])
                if nbits != int(bits[t]):
                    raise RuntimeError(f"frame {first_index + t}: span "
                                       f"strings hold {nbits} bits, the "
                                       f"pack counted {int(bits[t])}")
            else:
                nw = (int(bits[t]) + 31) // 32
                payload = words[t, :nw].astype(">u4").tobytes()
            ftype = 0 if t == 0 else 1
            qp = int(qps[t])
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
