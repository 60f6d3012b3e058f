"""Per-frame encode engine on one device.

Twin of `video_encoder_tpu/pipeline/device_engine.py`: numpy `Frame`s in,
`FrameEncodeResult` out, one frame per call; format 1 only, full or
diamond search, rc none, adaptive, bitrate or vbv. The host drives the
GOP (`pipeline/encoder.py` `encode_gop`): it carries the frame qp and the
vbv fullness and passes each frame's recon back as the next reference,
so every frame uploads its planes and waits for its payload.

Search, MC and the transform run through `ops/dispatch.py`, so on the
card they are the port's kernels, as in the GOP engine
(`gop_engine.predict_p_traced`, `_code_frame`): the search (full) or the
even SAD map and `sad_at_mv` (diamond) and one `mc_predict` per P frame,
and `code_plane` per plane at the per-MB qps. The pack is the
reference's: the per-MB symbols (`entropy.mb_symbols`) packed densely
into one string of the worst-case capacity (`entropy.pack_bits`), so no
frame is ever encoded twice. The bytes equal the reference engine's and
the golden model's.

On CUDA a frame's encode is one CUDA graph per key (`DeviceEngine.key`),
the counterpart of the reference's jitted per-frame function: a key's
first call runs eagerly, its second captures, every later one replays
(`gop_engine.GraphCache`). In a GOP, frame 0 (I) and frame 1 (P) run
eagerly, frame 2 captures the P key and the later P frames replay. The
upload, the downloads and the rc carry stay on the host, outside the
graph.

rc="mb" raises: the reference's per-frame engine ignores it and codes
every MB at the frame qp, so its rc-mb stream is its rc-bitrate stream
and not the golden model's.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..codec import entropy, tables
from ..codec.config import EncoderConfig
from ..codec.frame import Frame, FrameEncodeResult
from ..ops import dispatch, motion
from ..ops.kernels import sad as ksad
from .gop_engine import (GraphCache, _code_frame, predict_i_traced,
                         predict_p_traced, resolve_device)

# what a captured frame encode bakes in (DeviceEngine.key)
FrameKey = collections.namedtuple(
    "FrameKey", "is_p search rc n_words qbias y_shape c_shape sea force")


def assemble_blocks(yb, cbb, crb):
    """Luma blocks [2 nby, 2 nbx, ...] and chroma blocks [nby, nbx, ...] ->
    [nby, nbx, 6, ...] in the MB's order Y00, Y01, Y10, Y11, Cb, Cr."""
    return torch.stack([yb[0::2, 0::2], yb[0::2, 1::2], yb[1::2, 0::2],
                        yb[1::2, 1::2], cbb, crb], 2)


def scatter_blocks(blocks6):
    """Inverse of assemble_blocks: (luma [2 nby, 2 nbx, ...], cb, cr)."""
    nby, nbx, _, *rest = blocks6.shape
    y = blocks6[:, :, :4].reshape(nby, nbx, 2, 2, *rest).transpose(1, 2)
    return (y.reshape(2 * nby, 2 * nbx, *rest), blocks6[:, :, 4],
            blocks6[:, :, 5])


def encode_frame_device(cur, ref, qp: torch.Tensor, *, is_p: bool,
                        search: str, rc: str, n_words: int, qbias: int = 8):
    """The per-frame encode on the planes' device: cur and ref are (y, cb,
    cr) int32 planes (ref unused and may be None on an I frame), qp the
    frame's base qp as a 0-dim int32 device tensor. Launches only, no
    host wait. Returns a dict of device tensors: words [n_words] int32,
    payload_bits, rec (three int32 planes), n_inter and mb_bits
    [nby, nbx] int32."""
    if search not in ("full", "diamond"):
        raise ValueError(f"search={search!r} is not a device-engine mode")
    if rc == "mb":
        raise ValueError(
            "rc='mb' is not a per-frame engine mode: the reference's "
            "per-frame engine codes every MB at the frame qp under it, so "
            "its stream is rc bitrate's; the GOP engine codes rc mb")
    cur_y = cur[0]
    icost = None
    if is_p or rc == "adaptive":
        _, icost = motion.intra_cost_and_dc(cur_y)
    if is_p:
        dy, dx, is_inter, *pred = predict_p_traced(cur_y, *ref, icost, search)
    else:
        dy, dx, is_inter, *pred = predict_i_traced(*cur)
    if rc == "adaptive":
        qp_mb = motion.adaptive_qp(qp, icost)
    else:
        qp_mb = qp.expand(dy.shape)
    levels, rec = _code_frame(cur, pred, qp_mb, 0, qbias)
    values, lengths = entropy.mb_symbols(assemble_blocks(*levels),
                                         qp_mb - qp, is_p, is_inter, dy, dx)
    words, bits = entropy.pack_bits(values, lengths, n_words)
    return dict(words=words, payload_bits=bits, rec=rec,
                n_inter=is_inter.sum(), mb_bits=entropy.mb_bit_counts(lengths))


class DeviceEngine:
    """Per-frame engine: encode(cfg, cur, ref, frame_type, base_qp) ->
    FrameEncodeResult, the recon on the host as numpy int32 planes.

    `device` is explicit and defaults to "cuda"; nothing moves to the CPU
    on its own. The engine keeps the device planes of the recon it
    returned last, and a `ref` that is that very Frame is not uploaded
    again. On CUDA each frame replays its key's graph from the key's
    second call on (the module docstring); `graphs` holds them."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._last: tuple[Frame, tuple] | None = None
        self.cache = GraphCache("DeviceEngine")
        self.graphs = self.cache.graphs     # FrameKey -> its GopGraph

    def _upload(self, frame: Frame):
        if self._last is not None and frame is self._last[0]:
            return self._last[1]
        return tuple(torch.from_numpy(p.astype(np.uint8)).to(self.device)
                     .to(torch.int32) for p in (frame.y, frame.cb, frame.cr))

    @staticmethod
    def key(cfg: EncoderConfig, is_p: bool, n_words: int, y_shape,
            c_shape) -> FrameKey:
        """The key of a frame's graph: the reference's static arguments
        (is_p, search, rc, n_words, qbias), the luma and chroma shapes,
        and the routes the wrappers read at every call (TVC_SEA,
        dispatch.force). The planes and the base qp are inputs."""
        return FrameKey(is_p, cfg.search, cfg.rc, n_words, cfg.quant_bias,
                        tuple(y_shape), tuple(c_shape), ksad._sea_enabled(),
                        dispatch._FORCE)

    def encode(self, cfg: EncoderConfig, cur: Frame, ref: Frame | None,
               frame_type: int, base_qp: int) -> FrameEncodeResult:
        if cfg.format_version != 1:
            raise ValueError("the per-frame engine codes format 1 only; the "
                             "GOP engine codes formats 1-4")
        is_p = frame_type == 1
        cur_d = self._upload(cur)
        ref_d = self._upload(cur if ref is None else ref) if is_p else ()
        n_mbs = (cur.y.shape[0] // tables.MB) * (cur.y.shape[1] // tables.MB)
        n_words = entropy.max_words(n_mbs)

        def body(*planes_qp):
            *planes, qp = planes_qp
            return encode_frame_device(
                tuple(planes[:3]), tuple(planes[3:]) or None, qp, is_p=is_p,
                search=cfg.search, rc=cfg.rc, n_words=n_words,
                qbias=cfg.quant_bias)

        out = self.cache.launch(
            self.key(cfg, is_p, n_words, cur_d[0].shape, cur_d[1].shape),
            body, (*cur_d, *ref_d), int(base_qp))
        bits, n_inter = torch.stack([out["payload_bits"].long(),
                                     out["n_inter"].long()]).tolist()
        payload = (out["words"][:(bits + 31) // 32].cpu().numpy()
                   .view(np.uint32).astype(">u4").tobytes())
        recon = Frame(*(r.to(torch.uint8).cpu().numpy().astype(np.int32)
                        for r in out["rec"]))
        self._last = (recon, out["rec"])
        return FrameEncodeResult(
            payload=payload, payload_bits=bits, recon=recon,
            mb_bits=out["mb_bits"].cpu().numpy(),
            n_intra=n_mbs - n_inter if is_p else n_mbs,
            n_inter=n_inter if is_p else 0)
