"""The plain reference equals the port's CPU path byte for byte at small
sizes under both configurations' settings, SSEs included; its control
(bfloat16 transform products) does not."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench.tests.helpers import ROOT, tiny
from portbench import content, control, run
from portbench.reference import tvc1_fmt1 as ref
from video_encoder_tpu_torch.codec.config import config_from_dict
from video_encoder_tpu_torch.codec.bitstream import write_stream_header
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

torch.set_num_threads(2)

CASES = [("tvc1-1080-full", "pan2.g1", dict(width=96, height=64, gop_n=4)),
         ("tvc1-1080-full", "pan2.g1", dict(width=80, height=50, gop_n=3,
                                            base_qp=20)),
         ("tvc1-1080-diamond-rcmb", "pan4.g1",
          dict(width=96, height=64, gop_n=4, target_kbps=300)),
         ("tvc1-1080-diamond-rcmb", "pan4.g1",
          dict(width=112, height=48, gop_n=3, target_kbps=120))]


def _gop(config, mix_name, shape, seed):
    enc = dict(run.load_json(f"{ROOT}/portbench/configs/{config}.json")["encoder"],
               **shape)
    mix = run.load_json(f"{ROOT}/portbench/traffic/{mix_name}.json")
    planes = content.pool_gop(content.make_pool(mix, enc, seed, "cpu"), 0, 0)
    return enc, planes


def _port(enc, planes):
    """Packets' bytes and SSE [T, 3] of the port's GopEngine on the CPU."""
    eng = GopEngine(config_from_dict(enc), device="cpu")
    outs = eng.run(*planes, enc["base_qp"])
    if bool(outs["ovf"].any()):
        outs = eng.run(*planes, enc["base_qp"], xl=True)
    host = eng.download(outs)
    h, w = planes[0].shape[-2:]
    geom = [run.Geometry(h, w)] * enc["gop_n"]
    packets, _ = eng.gop_packets(geom, 0, host, 0.0)
    return [p.to_bytes() for p in packets], host["sse"]


@pytest.mark.parametrize("config,mix_name,shape", CASES)
@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_reference_equals_the_port(config, mix_name, shape, seed):
    enc, planes = _gop(config, mix_name, shape, seed)
    want, want_sse = _port(enc, planes)
    got, sse = ref.encode_gop(enc, *planes)
    assert got == want
    assert np.array_equal(sse.numpy(), want_sse)


@pytest.mark.parametrize("config,mix_name,shape", CASES[::2])
def test_control_fails_the_comparison(config, mix_name, shape):
    """The control (the reference with bfloat16 transform products) gives
    other bytes and other SSEs on every GOP tried."""
    for seed in (4, 5, 6):
        enc, planes = _gop(config, mix_name, shape, seed)
        want, want_sse = ref.encode_gop(enc, *planes)
        got, sse = ref.encode_gop(enc, *planes, transform=torch.bfloat16)
        assert got != want
        assert (sse != want_sse).any()


@pytest.mark.parametrize("workload", ["full1080.g1", "rcmb1080.g4"])
def test_control_comes_out_incorrect_in_the_runs_comparison(workload):
    """control.readings judges the control by run.compare and run.passes,
    as a run judges the program: `correct` comes out false."""
    r = control.readings(workload, 2**31 + 5, device="cpu",
                         overrides=tiny(workload))
    assert r["correct"] is False
    assert r["check"]["gop_bytes_differ"]["value"] == r["gops"]
    assert r["check"]["frame_sse_differ"]["value"] > 0
    assert r["check"]["header_differs"]["value"] == 0


@pytest.mark.parametrize("config", ["tvc1-1080-full", "tvc1-1080-diamond-rcmb"])
def test_stream_header_equals_the_port(config):
    import io

    enc = run.load_json(f"{ROOT}/portbench/configs/{config}.json")["encoder"]
    f = io.BytesIO()
    write_stream_header(f, config_from_dict(enc), 0)
    assert ref.stream_header(enc, 0) == f.getvalue()
    assert dataclasses.asdict(config_from_dict(enc)) == enc


def test_reference_refuses_what_it_does_not_state():
    enc = run.load_json(f"{ROOT}/portbench/configs/tvc1-1080-full.json")["encoder"]
    with pytest.raises(ValueError):
        ref.check_config(dict(enc, format_version=4))
    with pytest.raises(ValueError):
        ref.check_config(dict(enc, rc="vbv"))
