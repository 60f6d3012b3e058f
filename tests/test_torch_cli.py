"""Port CLI on the CPU: encode gives the reference encoder's bytes (formats
1 to 4, every rc mode), decode / info / psnr round-trip, the stream
header carries the format fields, flags the port does not support exit
2, `--gop-batch G` gives the unbatched file on a clip with a tail,
`--two-pass` gives the reference's two-pass file, and `--engine golden`
(with `--search hier`, `--rc mb`, format 4, two-pass and a resumed
`--checkpoint`) gives the reference CLI's golden file; `decode --engine
golden`, and the native decode's fallback to it, give the C++ decoder's
file."""

import io
import json
import re

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
    ["--two-pass"], ["--tile=2", "--search", "diamond"], ["--search", "hier"],
    ["--format", "5"], ["--multiprocess", "2", "--two-pass", "--kbps", "300"],
    ["--devices", "2", "--engine", "device"],
    ["--engine", "golden", "--gop-batch", "2"], ["--gop-batch=0"],
    ["--no-such-flag"],
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


def test_not_ported_flags_are_the_remaining_ones(capsys):
    """None remain: every encode flag of the reference CLI is one of the
    port's (the port adds --device), and `--search` and `--engine` take
    the reference's choices, on encode and decode."""
    from video_encoder_tpu import cli as reference_cli

    def help_text(main, cmd):
        with pytest.raises(SystemExit):
            main([cmd, "--help"])
        return capsys.readouterr().out

    def flags(main):
        return set(re.findall(r"^  (?:-\w(?: \S+)?, )?(--[a-z][a-z0-9-]*)",
                              help_text(main, "encode"), re.M))

    def choices(main, cmd):
        return dict(re.findall(r"^  (--search|--engine) \{([a-z,]+)\}",
                               help_text(main, cmd), re.M))

    ours, theirs = flags(cli.main), flags(reference_cli.main)
    assert {"--devices", "--multiprocess", "--failover", "--tile"} <= theirs
    assert theirs <= ours and ours - theirs == {"--device"}
    assert not hasattr(cli, "NOT_PORTED")
    got, want = choices(cli.main, "encode"), choices(reference_cli.main,
                                                     "encode")
    assert got == want and want["--search"] == "full,diamond,hier"
    assert "golden" in want["--engine"].split(",")
    assert choices(cli.main, "decode") == choices(reference_cli.main,
                                                  "decode")


@pytest.mark.parametrize("flags,kw", [
    ([], {}),
    (["--search", "diamond", "--rc", "bitrate", "--kbps", "300"],
     dict(search="diamond", rc="bitrate", target_kbps=300)),
    (["--rc", "adaptive", "--quant-bias", "5"],
     dict(rc="adaptive", quant_bias=5)),
    (["--two-pass", "--kbps", "300", "--rc", "mb"],
     dict(rc="mb", target_kbps=300)),
], ids=["full", "diamond-bitrate", "adaptive-qbias", "two-pass-mb"])
def test_engine_device_matches_the_reference_device_engine(
        clip_file, tmp_path, capsys, flags, kw):
    """`--engine device` gives the file the reference CLI's `--engine
    device` writes (its encode_clip, or under --two-pass its per-frame
    two-pass: both passes at rc none, so rc mb is taken there)."""
    from video_encoder_tpu.pipeline.device_engine import DeviceEngine
    from video_encoder_tpu.pipeline.encoder import encode_clip_twopass

    clip, path = clip_file
    out = tmp_path / "o.tvc"
    assert cli.main(["encode", "-i", path, "-W", str(W), "-H", str(H),
                     "-o", str(out), "--gop", "3", "--qp", "26",
                     "--engine", "device", "--device", "cpu", *flags]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == 5 and summary["engine"] == "device"
    cfg = EncoderConfig(width=W, height=H, gop_n=3, base_qp=26, **kw)
    want = io.BytesIO()
    if "--two-pass" in flags:
        encode_clip_twopass(cfg, lambda: iter(clip), want, 5,
                            engine=DeviceEngine())
    else:
        encode_clip(cfg, clip, want, 5, engine=DeviceEngine())
    assert out.read_bytes() == want.getvalue()


@pytest.fixture
def long_clip_file(rng, tmp_path):
    """17 frames: five full GOPs of 3 and a short one of 2."""
    clip = make_clip(rng, W, H, 17)
    path = tmp_path / "long.yuv"
    with open(path, "wb") as f:
        for y, cb, cr in clip:
            f.write(y.tobytes() + cb.tobytes() + cr.tobytes())
    return clip, str(path)


_BATCH_FLAGS = {
    "full": [],
    "diamond-mb": ["--search", "diamond", "--rc", "mb", "--kbps", "300"],
    "v4-qmat": ["--format", "4", "--quant-matrix", "--chroma-qp-offset", "2"],
}


@pytest.mark.parametrize("g", [2, 3])
@pytest.mark.parametrize("case", sorted(_BATCH_FLAGS))
def test_gop_batch_gives_the_unbatched_file(long_clip_file, tmp_path, capsys,
                                            case, g):
    """Five full GOPs and a short one: G = 2 batches 2 + 2, then one full
    GOP and the short one alone; G = 3 batches 3, then the two leftover
    full GOPs together, then the short one. Same bytes as no batching."""
    _, path = long_clip_file
    base = ["encode", "-i", path, "-W", str(W), "-H", str(H), "--gop", "3",
            "--qp", "26", "--device", "cpu", *_BATCH_FLAGS[case]]
    plain, batched = tmp_path / "plain.tvc", tmp_path / "batched.tvc"
    assert cli.main([*base, "-o", str(plain)]) == 0
    assert cli.main([*base, "-o", str(batched), "--gop-batch", str(g)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == 17
    assert batched.read_bytes() == plain.read_bytes()


def test_gop_batch_calls_the_batched_engine(long_clip_file, tmp_path,
                                            monkeypatch, capsys):
    """The reference's batching and tail rule, by the engine calls made."""
    from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

    calls = []
    start = GopEngine.start
    monkeypatch.setattr(GopEngine, "start", lambda self, gops, firsts:
                        calls.append(("one", firsts[0]) if len(gops) == 1
                                     else ("many", list(firsts)))
                        or start(self, gops, firsts))
    _, path = long_clip_file
    base = ["encode", "-i", path, "-W", str(W), "-H", str(H), "--gop", "3",
            "--device", "cpu", "-o", str(tmp_path / "o.tvc")]
    assert cli.main([*base, "--gop-batch", "2"]) == 0
    assert calls == [("many", [0, 3]), ("many", [6, 9]), ("one", 12), ("one", 15)]
    calls.clear()
    assert cli.main([*base, "--gop-batch", "3"]) == 0
    assert calls == [("many", [0, 3, 6]), ("many", [9, 12]), ("one", 15)]


@pytest.mark.parametrize("flags,kw", [
    (["--kbps", "150"], dict(rc="bitrate", target_kbps=150)),
    (["--kbps", "400", "--rc", "vbv", "--search", "diamond", "--format", "2"],
     dict(rc="vbv", target_kbps=400, search="diamond", format_version=2)),
], ids=["none-becomes-bitrate", "vbv-diamond-v2"])
def test_two_pass_matches_reference_twopass(tmp_path, capsys, flags, kw):
    """--two-pass --kbps N gives the file the reference's
    encode_clip_twopass writes with the reference GopEngine; the header is
    written under the original config, and the GOPs get different qps."""
    from video_encoder_tpu.ops import dispatch as jdispatch
    from video_encoder_tpu.pipeline import gop_engine as jgop
    from video_encoder_tpu.pipeline.encoder import encode_clip_twopass
    from video_encoder_tpu_torch.codec.bitstream import demux

    rng = np.random.default_rng(17)
    # an easy GOP, then noisy ones: the allocation has something to move
    clip = make_clip(rng, W, H, 3) + [
        (rng.integers(0, 256, (H, W), dtype=np.uint8),
         rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8),
         rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8))
        for _ in range(5)]
    path = tmp_path / "in.yuv"
    with open(path, "wb") as f:
        for y, cb, cr in clip:
            f.write(y.tobytes() + cb.tobytes() + cr.tobytes())
    out = tmp_path / "o.tvc"
    assert cli.main(["encode", "-i", str(path), "-W", str(W), "-H", str(H),
                     "-o", str(out), "--gop", "3", "--qp", "26", "--two-pass",
                     "--device", "cpu", *flags]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["frames"] == 8

    cfg = EncoderConfig(width=W, height=H, gop_n=3, base_qp=26, **kw)
    want = io.BytesIO()
    jdispatch.force("jnp")
    try:
        encode_clip_twopass(cfg, lambda: iter(clip), want, 8,
                            engine=jgop.GopEngine(cfg))
    finally:
        jdispatch.force(None)
    assert out.read_bytes() == want.getvalue()
    info, packets = demux(io.BytesIO(out.read_bytes()))
    assert info.config_hash == cfg.config_hash()
    qps = [p.base_qp for p in packets]
    assert qps[0] == qps[1] == qps[2] and qps[3] == qps[4] == qps[5]
    assert len(set(qps)) > 1


@pytest.mark.parametrize("flags,msg", [
    (["--two-pass"], "--two-pass requires --kbps"),
    (["--two-pass", "--kbps", "300", "--rc", "adaptive"],
     "--two-pass allocates qp at the GOP level"),
    (["--gop-batch", "0"], "--gop-batch must be >= 1"),
    (["--gop-batch=-2", "--two-pass", "--kbps", "300"],
     "--gop-batch must be >= 1"),
])
def test_two_pass_and_gop_batch_preconditions_exit_2(clip_file, tmp_path,
                                                     capsys, flags, msg):
    _, path = clip_file
    out = tmp_path / "x.tvc"
    rc = cli.main(["encode", "-i", path, "-W", str(W), "-H", str(H),
                   "-o", str(out), "--device", "cpu", *flags])
    assert rc == 2
    assert msg in capsys.readouterr().err
    assert not out.exists()          # checked before the file is truncated


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


@pytest.fixture
def v4_stream(rng, tmp_path):
    """A format-4 stream with the quant matrix, a chroma qp offset and
    intra slices, three GOPs of 3 and a short one (11 frames at 64x48),
    from the reference encoder, and the C++ decoder's file of it."""
    from video_encoder_tpu.pipeline.decoder import decode_clip_native

    cfg = EncoderConfig(width=W, height=H, gop_n=3, base_qp=26,
                        format_version=4, quant_matrix=True,
                        chroma_qp_offset=2, intra_slice_mbrows=1)
    buf = io.BytesIO()
    encode_clip(cfg, make_clip(rng, W, H, 11), buf, 11)
    path = tmp_path / "v4.tvc"
    path.write_bytes(buf.getvalue())
    buf.seek(0)
    _, frames = decode_clip_native(buf)
    want = b"".join(y.tobytes() + cb.tobytes() + cr.tobytes()
                    for y, cb, cr in frames)
    assert len(want) == 11 * W * H * 3 // 2
    return str(path), want


@pytest.mark.parametrize("flags", [
    ["--engine", "gop", "--device", "cpu"],
    ["--engine", "device", "--device", "cpu"],
    ["--engine", "native", "--workers", "1"],
    ["--workers", "2"],
    ["--workers", "4"],
    [],
], ids=lambda f: "-".join(a.strip("-") for a in f) or "default")
def test_decode_engines_give_the_native_file(v4_stream, tmp_path, capsys,
                                             flags):
    """Every decode engine and worker count writes the C++ decoder's file;
    `--workers 4` is taken, not refused by argparse."""
    path, want = v4_stream
    dec = tmp_path / "d.yuv"
    assert cli.main(["decode", "-i", path, "-o", str(dec), *flags]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["frames"] == 11
    assert summary["engine"] == (flags[1] if flags[:1] == ["--engine"]
                                 else "native")
    assert dec.read_bytes() == want


def test_decode_golden_engine_exits_2_naming_the_reference(v4_stream,
                                                           tmp_path, capsys):
    """`decode --engine golden` is the port's own golden decoder on the
    host: it no longer exits 2 pointing at the reference CLI, and writes
    the C++ decoder's file."""
    path, want = v4_stream
    dec = tmp_path / "d.yuv"
    assert cli.main(["decode", "-i", path, "-o", str(dec), "--engine",
                     "golden"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["engine"] == "golden" and summary["frames"] == 11
    assert dec.read_bytes() == want


@pytest.mark.parametrize("engine", ["gop", "device"])
def test_decode_device_engines_need_cuda(v4_stream, tmp_path, capsys,
                                         monkeypatch, engine):
    """--device defaults to cuda: without CUDA the device engines exit 1
    with the error and decode nothing, on the CPU or elsewhere."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, _ = v4_stream
    dec = tmp_path / "d.yuv"
    assert cli.main(["decode", "-i", path, "-o", str(dec), "--engine",
                     engine]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not dec.exists()


def test_decode_native_library_failure_exits_1(v4_stream, tmp_path, capsys,
                                               monkeypatch):
    """Where the C++ library cannot be built, the engines that parse with
    it (gop, device) exit 1 with the error and decode nothing; the native
    decode warns and decodes with the golden model, as the reference CLI
    does, to the same file."""
    from video_encoder_tpu_torch.codec import native

    def broken():
        raise RuntimeError("liboracle.so build failed: no compiler")

    monkeypatch.setattr(native, "_load", broken)
    path, want = v4_stream
    dec = tmp_path / "d.yuv"
    for engine in ("gop", "device"):
        assert cli.main(["decode", "-i", path, "-o", str(dec), "--engine",
                         engine, "--device", "cpu"]) == 1
        assert "liboracle.so build failed" in capsys.readouterr().err
        assert not dec.exists()
    assert cli.main(["decode", "-i", path, "-o", str(dec)]) == 0
    out = capsys.readouterr()
    assert "native lib unavailable, using golden" in out.err
    assert json.loads(out.out)["engine"] == "golden"
    assert dec.read_bytes() == want


@pytest.mark.parametrize("flags", [[], ["--workers", "1"], ["--workers", "3"]],
                         ids=["default", "workers-1", "workers-3"])
def test_decode_native_unavailable_warns_and_decodes_with_golden(
        v4_stream, tmp_path, capsys, monkeypatch, flags):
    """native.available() False: the reference's warning on stderr, the
    golden decoder, the C++ decoder's file; the library is not called."""
    from video_encoder_tpu_torch.codec import native
    from video_encoder_tpu_torch.pipeline import decoder

    monkeypatch.setattr(native, "available", lambda: False)
    for name in ("decode_clip_native", "decode_clip_parallel"):
        monkeypatch.setattr(decoder, name, None)
    path, want = v4_stream
    dec = tmp_path / "d.yuv"
    assert cli.main(["decode", "-i", path, "-o", str(dec), *flags]) == 0
    out = capsys.readouterr()
    assert out.err.splitlines() == [
        "warning: native lib unavailable, using golden"]
    assert json.loads(out.out)["engine"] == "golden"
    assert dec.read_bytes() == want


def _reference_cli_stream(path, out, argv):
    from video_encoder_tpu import cli as reference_cli

    assert reference_cli.main(["encode", "-i", path, "-W", str(W), "-H",
                               str(H), "-o", str(out), *argv]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("flags", [
    ["--search", "hier"],
    ["--search", "hier", "--format", "2", "--chroma-qp-offset", "3"],
    ["--rc", "mb", "--kbps", "300", "--search", "diamond"],
    ["--format", "4", "--quant-matrix", "--chroma-qp-offset", "2",
     "--intra-slice", "1", "--rc", "vbv", "--kbps", "300"],
    ["--two-pass", "--kbps", "300", "--search", "hier"],
], ids=["hier", "hier-v2", "rc-mb", "v4-qmat-vbv", "two-pass-hier"])
def test_golden_engine_matches_the_reference_cli(clip_file, tmp_path, capsys,
                                                 flags):
    """`encode --engine golden` writes the reference CLI's `--engine
    golden` file (its per-frame loop, or its per-frame two-pass), runs on
    the host whatever --device says, and names itself in the summary."""
    _, path = clip_file
    out = tmp_path / "o.tvc"
    argv = ["--gop", "3", "--qp", "26", "--engine", "golden", *flags]
    assert cli.main(["encode", "-i", path, "-W", str(W), "-H", str(H),
                     "-o", str(out), *argv]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["engine"] == "golden" and summary["device"] == "cpu"
    assert summary["frames"] == 5
    assert out.read_bytes() == _reference_cli_stream(
        path, tmp_path / "r.tvc", argv)


def test_golden_checkpoint_resume_matches_the_reference_cli(clip_file,
                                                            tmp_path, capsys):
    """An `--engine golden --checkpoint` encode killed after its first GOP
    and resumed by the CLI: the reference CLI's uninterrupted golden file,
    and the checkpoint gone."""
    import os

    from video_encoder_tpu_torch.codec.config import EncoderConfig as Config
    from video_encoder_tpu_torch.io import yuv
    from video_encoder_tpu_torch.pipeline.encoder import (
        GoldenGopAdapter, encode_clip_resumable)

    clip, path = clip_file
    out, ck = tmp_path / "o.tvc", tmp_path / "ck.json"
    argv = ["--gop", "2", "--qp", "26", "--engine", "golden", "--format",
            "3", "--search", "hier"]
    cfg = Config(width=W, height=H, gop_n=2, base_qp=26, format_version=3,
                 search="hier")

    def killed_at_frame_3():
        for i, planes in enumerate(yuv.open_clip(path, W, H)[3]):
            if i == 3:
                raise KeyboardInterrupt
            yield planes

    with pytest.raises(KeyboardInterrupt):
        encode_clip_resumable(cfg, killed_at_frame_3(), str(out), 5,
                              GoldenGopAdapter(cfg), str(ck))
    assert os.path.exists(ck)
    assert cli.main(["encode", "-i", path, "-W", str(W), "-H", str(H),
                     "-o", str(out), "--checkpoint", str(ck), *argv]) == 0
    assert json.loads(capsys.readouterr().out)["frames"] == 5
    assert not os.path.exists(ck)
    assert out.read_bytes() == _reference_cli_stream(
        path, tmp_path / "r.tvc", ["--checkpoint", str(tmp_path / "rck"),
                                   *argv])
