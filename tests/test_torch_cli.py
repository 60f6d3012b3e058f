"""Port CLI on the CPU: encode gives the reference encoder's bytes (formats
1 to 4, every rc mode), decode / info / psnr round-trip, the stream
header carries the format fields, and flags the port does not support
exit 2."""

import io
import json

import numpy as np
import pytest
import torch

from conftest import make_clip
from video_encoder_tpu.codec.config import EncoderConfig
from video_encoder_tpu.pipeline.encoder import encode_clip
from video_encoder_tpu_torch import cli

torch.set_num_threads(1)

W, H = 64, 48


@pytest.fixture
def clip_file(rng, tmp_path):
    clip = make_clip(rng, W, H, 5)
    path = tmp_path / "in.yuv"
    with open(path, "wb") as f:
        for y, cb, cr in clip:
            f.write(y.tobytes() + cb.tobytes() + cr.tobytes())
    return clip, str(path)


def test_encode_matches_reference_encoder(clip_file, tmp_path, capsys):
    clip, path = clip_file
    out = tmp_path / "out.tvc"
    rc = cli.main(["encode", "-i", path, "-W", str(W), "-H", str(H),
                   "-o", str(out), "--gop", "3", "--qp", "26",
                   "--device", "cpu"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == 5 and summary["device"] == "cpu"
    want = io.BytesIO()
    encode_clip(EncoderConfig(width=W, height=H, gop_n=3, base_qp=26), clip,
                want, 5)
    assert out.read_bytes() == want.getvalue()   # last GOP is short (2 frames)


def test_decode_info_psnr_roundtrip(clip_file, tmp_path, capsys):
    _, path = clip_file
    out, dec = tmp_path / "o.tvc", tmp_path / "d.yuv"
    assert cli.main(["encode", "-i", path, "-W", str(W), "-H", str(H),
                     "-o", str(out), "--gop", "5", "--device", "cpu"]) == 0
    enc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(["decode", "-i", str(out), "-o", str(dec)]) == 0
    assert json.loads(capsys.readouterr().out)["frames"] == 5
    assert cli.main(["info", "-i", str(out)]) == 0
    info = json.loads(capsys.readouterr().out)
    assert (info["width"], info["height"], info["frame_count"]) == (W, H, 5)
    assert cli.main(["psnr", "-a", path, "-b", str(dec), "-W", str(W),
                     "-H", str(H)]) == 0
    p = json.loads(capsys.readouterr().out)
    assert abs(p["psnr_y"] - enc["mean_psnr_y"]) < 1e-2
    assert p["psnr_y"] > 25


@pytest.mark.parametrize("extra", [
    ["--two-pass"], ["--tile=2"], ["--search", "hier"],
    ["--format", "5"], ["--multiprocess", "2"], ["--devices", "2"],
    ["--engine", "golden"], ["--gop-batch=2"], ["--no-such-flag"],
])
def test_unsupported_flags_exit_2(clip_file, tmp_path, extra, capsys):
    _, path = clip_file
    argv = ["encode", "-i", path, "-W", str(W), "-H", str(H),
            "-o", str(tmp_path / "x.tvc"), "--device", "cpu", *extra]
    try:
        rc = cli.main(argv)
    except SystemExit as e:   # argparse rejects unknown flags itself
        rc = e.code
    assert rc == 2
    assert "error" in capsys.readouterr().err


def test_cuda_device_without_cuda_fails(clip_file, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    _, path = clip_file
    rc = cli.main(["encode", "-i", path, "-W", str(W), "-H", str(H),
                   "-o", str(tmp_path / "x.tvc")])
    assert rc == 1 and "CUDA is not available" in capsys.readouterr().err


@pytest.mark.parametrize("rc,kbps", [("mb", 300), ("bitrate", 300)])
def test_diamond_rc_encode_matches_golden_and_decodes(clip_file, tmp_path,
                                                      capsys, rc, kbps):
    from video_encoder_tpu.pipeline.encoder import GoldenEngine

    clip, path = clip_file
    out, dec = tmp_path / "o.tvc", tmp_path / "d.yuv"
    assert cli.main(["encode", "-i", path, "-W", str(W), "-H", str(H),
                     "-o", str(out), "--gop", "5", "--qp", "26",
                     "--search", "diamond", "--rc", rc, "--kbps", str(kbps),
                     "--device", "cpu"]) == 0
    capsys.readouterr()
    want = io.BytesIO()
    cfg = EncoderConfig(width=W, height=H, gop_n=5, base_qp=26,
                        search="diamond", rc=rc, target_kbps=kbps)
    encode_clip(cfg, clip, want, 5, engine=GoldenEngine())
    assert out.read_bytes() == want.getvalue()
    assert cli.main(["decode", "-i", str(out), "-o", str(dec)]) == 0
    assert json.loads(capsys.readouterr().out)["frames"] == 5


def test_rc_mb_without_kbps_fails_as_the_config_does(clip_file, tmp_path,
                                                     capsys):
    _, path = clip_file
    rc = cli.main(["encode", "-i", path, "-W", str(W), "-H", str(H),
                   "-o", str(tmp_path / "x.tvc"), "--rc", "mb",
                   "--device", "cpu"])
    assert rc == 1
    assert "requires target_kbps > 0" in capsys.readouterr().err


_FLAG_CASES = {
    "v2-cqpo-vbv": (["--format", "2", "--chroma-qp-offset", "4", "--search",
                     "diamond", "--rc", "vbv", "--kbps", "300",
                     "--vbv-kbits", "40"],
                    dict(format_version=2, chroma_qp_offset=4,
                         search="diamond", rc="vbv", target_kbps=300,
                         vbv_kbits=40)),
    "v3-qmat-islice-adaptive": (["--format", "3", "--quant-matrix",
                                 "--intra-slice", "2", "--rc", "adaptive"],
                                dict(format_version=3, quant_matrix=True,
                                     intra_slice_mbrows=2, rc="adaptive")),
    "v4-qmat-cqpo-qbias": (["--format=4", "--quant-matrix",
                            "--chroma-qp-offset=2", "--quant-bias", "5"],
                           dict(format_version=4, quant_matrix=True,
                                chroma_qp_offset=2, quant_bias=5)),
    "v4-diamond-mb": (["--format", "4", "--search", "diamond", "--rc", "mb",
                       "--kbps", "300"],
                      dict(format_version=4, search="diamond", rc="mb",
                           target_kbps=300)),
}


@pytest.mark.parametrize("case", sorted(_FLAG_CASES))
def test_format_flags_match_golden_and_decode(clip_file, tmp_path, capsys,
                                              case):
    """The new encode flags end to end: the stream equals the golden
    encoder's, its header carries the format fields, and the port's decode
    (the C++ parser) equals the golden decode."""
    from video_encoder_tpu.pipeline.decoder import decode_clip
    from video_encoder_tpu.pipeline.encoder import GoldenEngine

    flags, kw = _FLAG_CASES[case]
    clip, path = clip_file
    out, dec = tmp_path / "o.tvc", tmp_path / "d.yuv"
    assert cli.main(["encode", "-i", path, "-W", str(W), "-H", str(H),
                     "-o", str(out), "--gop", "3", "--qp", "26",
                     "--device", "cpu", *flags]) == 0
    capsys.readouterr()
    cfg = EncoderConfig(width=W, height=H, gop_n=3, base_qp=26, **kw)
    want = io.BytesIO()
    encode_clip(cfg, clip, want, 5, engine=GoldenEngine())
    assert out.read_bytes() == want.getvalue()

    assert cli.main(["info", "-i", str(out)]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["version"] == cfg.format_version
    assert info["chroma_qp_offset"] == cfg.chroma_qp_offset
    assert info["intra_slice_mbrows"] == cfg.intra_slice_mbrows
    assert bool(info["flags"] & 2) == cfg.quant_matrix
    assert info["config_hash"] == cfg.config_hash()

    assert cli.main(["decode", "-i", str(out), "-o", str(dec)]) == 0
    assert json.loads(capsys.readouterr().out)["frames"] == 5
    want.seek(0)
    _, frames = decode_clip(want)
    gold = b"".join(y.tobytes() + cb.tobytes() + cr.tobytes()
                    for y, cb, cr in frames)
    assert dec.read_bytes() == gold


@pytest.mark.parametrize("flags,msg", [
    (["--chroma-qp-offset", "2"], "chroma_qp_offset requires format_version>=2"),
    (["--format", "2", "--quant-matrix"], "quant_matrix requires format_version>=3"),
    (["--format", "2", "--intra-slice", "1"], "intra_slice_mbrows requires"),
    (["--quant-bias", "9"], "quant_bias must be in"),
    (["--rc", "vbv"], "requires target_kbps > 0"),
    (["--format", "2", "--chroma-qp-offset", "13"], "chroma_qp_offset must be in"),
])
def test_flag_errors_are_the_configs(clip_file, tmp_path, capsys, flags, msg):
    _, path = clip_file
    rc = cli.main(["encode", "-i", path, "-W", str(W), "-H", str(H),
                   "-o", str(tmp_path / "x.tvc"), "--device", "cpu", *flags])
    assert rc == 1
    assert msg in capsys.readouterr().err


def test_native_library_builds_outside_the_oracle_tree():
    import pathlib

    from video_encoder_tpu_torch.codec import native

    assert native.available()
    lib = pathlib.Path(native._LIB_PATH)
    root = pathlib.Path(cli.__file__).resolve().parents[1]
    assert lib == root / "build" / "oracle" / "liboracle.so" and lib.exists()
