"""The format-4 reference (`reference/tvc1_fmt4.py`) equals the port's CPU
path byte for byte at small sizes, SSEs included: on the cell's own
content, on a true half-pel pan with textured chroma, under rc mb and
under diamond search; its stream header equals the port's; the C++
oracle, a third implementation, decodes its streams to the frames its
SSEs state. And the controls that must fail: the bfloat16 control through
the run's comparison, a reference without the half-pel refine, and a run
whose program leaves the refine out."""

import ctypes
import io
import os

import numpy as np
import pytest
import torch

from portbench import content, control, run
from portbench.reference import tvc1_fmt4 as ref
from portbench.tests.helpers import ROOT, TINY
from video_encoder_tpu_torch.codec.bitstream import write_stream_header
from video_encoder_tpu_torch.codec.config import config_from_dict
from video_encoder_tpu_torch.ops import dispatch
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

torch.set_num_threads(2)

CONFIG = "tvc1-1080-fmt4"
CELL = "fmt4-1080.g1"
SEEDS = [1, 2**31 + 3]


def _enc(**shape) -> dict:
    return dict(run.load_json(f"{ROOT}/portbench/configs/{CONFIG}.json")
                ["encoder"], **shape)


def _cell_gop(enc, seed, mix_name="pan2.g1"):
    """The first GOP of the cell's pool, made as a run makes it."""
    mix = run.load_json(f"{ROOT}/portbench/traffic/{mix_name}.json")
    return content.pool_gop(content.make_pool(mix, enc, seed, "cpu"), 0, 0)


def _halfpel_gop(enc, seed):
    """A true half-pel pan: a two-pass texture at twice the size, each
    frame its 2x2 means at an offset growing by (1, 3) double-size pixels
    a frame (a (+0.5, +1.5) px pan), a moving 64x64 random patch and noise
    ±2; the chroma a second texture's 4x4 means panning with the luma
    (chip_smoke.py synth_clip_halfpel). Planes [T, H, W] uint8."""
    t, h, w = enc["gop_n"], enc["height"], enc["width"]
    g = torch.Generator().manual_seed(seed)

    def texture():
        base = torch.randint(0, 256, (2 * h + 128, 2 * w + 128), generator=g)
        for _ in range(2):
            base = (base + base.roll(1, 0) + base.roll(1, 1) + base.roll(2, 0)
                    + base.roll(2, 1)) // 5
        return base

    big = texture()
    big = (big - big.min()) * 255 // max(int(big.max() - big.min()), 1)
    cbig = texture()
    ys, cbs, crs = [], [], []
    for k in range(t):
        win = big[k:k + 2 * h, 3 * k:3 * k + 2 * w]
        y = ((win[0::2, 0::2] + win[0::2, 1::2] + win[1::2, 0::2]
              + win[1::2, 1::2] + 2) // 4
             + torch.randint(-2, 3, (h, w), generator=g))
        px, py = (200 + 11 * k) % max(w - 64, 1), (300 + 7 * k) % max(h - 64, 1)
        y[py:py + 64, px:px + 64] = torch.randint(0, 256, (64, 64), generator=g)
        c = cbig[k:k + 2 * h, 3 * k:3 * k + 2 * w].reshape(
            h // 2, 4, w // 2, 4).sum((1, 3)) // 16
        ys.append(y.clamp(0, 255))
        cbs.append(96 + c // 4)
        crs.append(160 - c // 4)
    return tuple(torch.stack(p).to(torch.uint8) for p in (ys, cbs, crs))


def _port(enc, planes):
    """Packets' bytes, SSE [T, 3] and the host arrays of the port's
    GopEngine on the CPU."""
    eng = GopEngine(config_from_dict(enc), device="cpu")
    outs = eng.run(*planes, enc["base_qp"])
    if bool(outs["ovf"].any()):
        outs = eng.run(*planes, enc["base_qp"], xl=True)
    host = eng.download(outs)
    h, w = planes[0].shape[-2:]
    packets, _ = eng.gop_packets([run.Geometry(h, w)] * enc["gop_n"], 0,
                                 host, 0.0)
    return [p.to_bytes() for p in packets], host["sse"], host


CASES = {
    "cell": (dict(width=96, height=64, gop_n=4), _cell_gop),
    "cell_qp20_unpadded": (dict(width=80, height=50, gop_n=3, base_qp=20),
                           _cell_gop),
    "halfpel_pan": (dict(width=128, height=96, gop_n=4), _halfpel_gop),
    "rc_mb": (dict(width=96, height=64, gop_n=4, rc="mb", target_kbps=300),
              _cell_gop),
    "diamond": (dict(width=96, height=64, gop_n=4, search="diamond"),
                _cell_gop),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seed", SEEDS)
def test_reference_equals_the_port(case, seed):
    shape, make = CASES[case]
    enc = _enc(**shape)
    planes = make(enc, seed)
    want, want_sse, host = _port(enc, planes)
    got, sse = ref.encode_gop(enc, *planes)
    assert got == want
    assert np.array_equal(sse.numpy(), want_sse)
    if case == "halfpel_pan":     # the pan's vectors are half-pel
        assert host["n_hpel"][1:].sum() > host["n_inter"][1:].sum() // 2


@pytest.mark.parametrize("shape", [
    {}, dict(quant_matrix=False, chroma_qp_offset=-3),
    dict(search="diamond", rc="mb", target_kbps=12000, chroma_qp_offset=12),
    dict(gop_n=1, chroma_qp_offset=-12)])
def test_stream_header_equals_the_port(shape):
    enc = _enc(**shape)
    f = io.BytesIO()
    write_stream_header(f, config_from_dict(enc), 0)
    assert ref.stream_header(enc, 0) == f.getvalue()
    assert len(f.getvalue()) == 28


@pytest.mark.parametrize("change", [
    dict(format_version=1), dict(format_version=3), dict(intra_slice_mbrows=2),
    dict(rc="vbv"), dict(rc="adaptive"), dict(search="hier"),
    dict(chroma_qp_offset=13), dict(quant_bias=5), dict(gop_devices=2)])
def test_reference_refuses_what_it_does_not_state(change):
    with pytest.raises(ValueError):
        ref.check_config(_enc(**change))


def _oracle():
    """The C++ oracle's decoder (oracle/liboracle.so, built beside
    oracle.cpp by its Makefile), or a skip where it does not load."""
    path = os.path.join(ROOT, "oracle", "liboracle.so")
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        pytest.skip(f"the oracle's library does not load here: {e}")
    lib.tvc_decode_stream.restype = ctypes.c_int
    lib.tvc_decode_stream.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_uint8),
                                      ctypes.c_int64]
    return lib


@pytest.mark.parametrize("case", ["cell", "halfpel_pan", "rc_mb"])
def test_oracle_decodes_the_reference_stream(case):
    """The oracle decodes the reference's stream (a shape on the MB grid,
    so nothing is cropped) to frames whose SSEs against the source are the
    reference's."""
    lib = _oracle()
    shape, make = CASES[case]
    enc = _enc(**shape)
    planes = make(enc, 7)
    packets, sse = ref.encode_gop(enc, *planes)
    stream = ref.stream_header(enc, enc["gop_n"]) + b"".join(packets)
    t, h, w = planes[0].shape
    out = np.zeros(t * h * w * 3 // 2, np.uint8)
    rc = lib.tvc_decode_stream(stream, len(stream), out.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint8)), out.size)
    assert rc >= 0
    frames = out.reshape(t, -1)
    ends = np.cumsum([0, h * w, h * w // 4, h * w // 4])
    got = np.array([[((frames[k, ends[i]:ends[i + 1]].astype(np.int64)
                       - planes[i][k].numpy().reshape(-1)) ** 2).sum()
                     for i in range(3)] for k in range(t)])
    assert np.array_equal(got, sse.numpy())


def test_control_comes_out_incorrect_in_the_runs_comparison():
    """control.readings on the new cell at a small shape: the bfloat16
    control, judged as a run judges the program, is not correct."""
    r = control.readings(CELL, 2**31 + 5, device="cpu", overrides=TINY)
    assert r["correct"] is False
    assert r["check"]["gop_bytes_differ"]["value"] == r["gops"]
    assert r["check"]["frame_sse_differ"]["value"] > 0
    assert r["check"]["header_differs"]["value"] == 0


def test_reference_without_the_refine_differs_from_the_port(monkeypatch):
    """The doubled integer vectors make a legal format-4 stream (SPEC.md
    §14.5), but not the one the configuration states: on the cell's
    content, where the port picks half-pel vectors, its bytes differ."""
    enc = _enc(width=320, height=192, gop_n=4)
    planes = _cell_gop(enc, 11)
    want, _, host = _port(enc, planes)
    assert host["n_hpel"][1:].sum() > 0

    def doubled(cur, planes, dy, dx):
        pred = ref.fetch_hpel(planes, 2 * dy, 2 * dx, ref.MB, ref.R)
        sad = (ref.v1.blockify(cur.long(), ref.MB) - pred).abs().sum((2, 3))
        return 2 * dy, 2 * dx, sad

    assert ref.encode_gop(enc, *planes)[0] == want
    monkeypatch.setattr(ref, "hpel_refine", doubled)
    got, _ = ref.encode_gop(enc, *planes)
    assert got[0] == want[0] and got[1:] != want[1:]


def test_run_without_the_refine_fails(monkeypatch):
    """A run whose program skips the refine (the doubled integer vectors
    and their SADs) comes out not correct."""
    def doubled(cur_y, ref_y, dy, dx, planes=None, sad_fn=None):
        return 2 * dy, 2 * dx, dispatch.sad_at_mv(cur_y, ref_y, dy, dx)

    monkeypatch.setattr(dispatch, "hpel_refine", doubled)
    result, check, _ = run.run_cell(CELL, 2**31 + 17, 0.3, False, device="cpu",
                                    overrides={"encoder": dict(
                                        width=320, height=192, gop_n=4)})
    assert not result["correct"]
    assert check["gop_bytes_differ"]["value"] > 0
