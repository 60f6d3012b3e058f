"""The port's aux paths on the CPU: checkpoint and resume
(`pipeline/encoder.py encode_clip_resumable`, `pipeline/checkpoint.py`,
`pipeline/bitstream_writer.py`) byte-identical to an uninterrupted
encode under the GOP engine and the per-frame engine, through the
library and the CLI; the checks that refuse a checkpoint that does not
fit the stream; and `utils/trace.py` (StageTimer, EventLog, a
torch.profiler trace written to a directory), with `--stage-timers`,
`--trace` and `-v --checkpoint` on the CLI."""

import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from video_encoder_tpu.codec.config import EncoderConfig as RefConfig
from video_encoder_tpu.pipeline.encoder import GoldenEngine
from video_encoder_tpu.pipeline.encoder import encode_clip as ref_encode_clip
from video_encoder_tpu_torch import cli
from video_encoder_tpu_torch.codec.bitstream import STREAM_HEADER_SIZE
from video_encoder_tpu_torch.codec.config import EncoderConfig
from video_encoder_tpu_torch.io import yuv
from video_encoder_tpu_torch.pipeline import checkpoint as ckpt
from video_encoder_tpu_torch.pipeline.device_engine import DeviceEngine
from video_encoder_tpu_torch.pipeline.encoder import (PerFrameGopAdapter,
                                                      encode_clip_resumable)
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine
from video_encoder_tpu_torch.utils.trace import EventLog, StageTimer, trace

torch.set_num_threads(1)

W, H, N = 96, 64, 5


@pytest.fixture()
def clip(tmp_path, rng):
    path = tmp_path / "in.yuv"
    with open(path, "wb") as f:
        base = rng.integers(0, 256, (H + 8, W + 8)).astype(np.int32)
        for k in range(N):
            y = np.clip(base[k:k + H, k:k + W] + rng.integers(-2, 3, (H, W)),
                        0, 255).astype(np.uint8)
            f.write(y.tobytes())
            f.write(np.full((H // 2, W // 2), 120, np.uint8).tobytes())
            f.write(np.full((H // 2, W // 2), 130, np.uint8).tobytes())
    return str(path)


def _cfg(**kw):
    return EncoderConfig(**dict(dict(width=W, height=H, gop_n=2, base_qp=26,
                                     search="full"), **kw))


def _argv(clip, out, *extra):
    return ["encode", "-i", clip, "-W", str(W), "-H", str(H), "-o", out,
            "--gop", "2", "--qp", "26", "--search", "full", "--device", "cpu",
            *extra]


def _encode(clip, out, *extra):
    assert cli.main(_argv(clip, out, *extra)) == 0
    with open(out, "rb") as f:
        return f.read()


def _golden_stream(clip, **kw):
    cfg = RefConfig(**dict(dict(width=W, height=H, gop_n=2, base_qp=26,
                                search="full"), **kw))
    _, _, _, frames = yuv.open_clip(clip, W, H)
    buf = io.BytesIO()
    ref_encode_clip(cfg, frames, buf, N, engine=GoldenEngine())
    return buf.getvalue()


def _engine(name, cfg):
    if name == "gop":
        return GopEngine(cfg, device="cpu")
    return PerFrameGopAdapter(cfg, DeviceEngine("cpu"))


def _interrupt(clip, out, ck, cfg, engine, at=3):
    """Encode through the library and stop while reading frame `at`: the
    GOPs before it are written and checkpointed."""
    _, _, _, frames = yuv.open_clip(clip, W, H)

    def interrupted():
        for i, f in enumerate(frames):
            if i == at:
                raise KeyboardInterrupt
            yield f

    with pytest.raises(KeyboardInterrupt):
        encode_clip_resumable(cfg, interrupted(), out, N, engine, ck)
    assert os.path.exists(ck)
    return ckpt.load(ck, cfg)


@pytest.mark.parametrize("engine", ["gop", "device"])
def test_checkpoint_resume_byte_identical(clip, tmp_path, capsys, engine):
    """Killed after its first GOP through the library, then resumed by the
    CLI's --checkpoint under the same engine: the uninterrupted stream
    (the golden model's), and the checkpoint file gone."""
    want = _golden_stream(clip)
    assert _encode(clip, str(tmp_path / "ref.tvc"), "--engine", engine) == want
    out, ck = str(tmp_path / "resumed.tvc"), str(tmp_path / "ck.json")
    cfg = _cfg()
    state = _interrupt(clip, out, ck, cfg, _engine(engine, cfg))
    assert state.next_frame == 2 and state.frames_done == 2
    assert os.path.getsize(out) == state.byte_offset
    got = _encode(clip, out, "--engine", engine, "--checkpoint", ck)
    assert got == want
    assert not os.path.exists(ck)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["frames"] == N and summary["engine"] == engine
    # a second run with the same flag encodes from scratch, same bytes
    assert _encode(clip, out, "--engine", engine, "--checkpoint", ck) == want


def test_resume_cuts_bytes_written_after_the_checkpoint(clip, tmp_path):
    """A kill between a GOP's write and its checkpoint leaves bytes past
    the checkpoint's offset; the resume cuts them off."""
    out, ck = str(tmp_path / "o.tvc"), str(tmp_path / "ck.json")
    cfg = _cfg()
    state = _interrupt(clip, out, ck, cfg, _engine("gop", cfg))
    with open(out, "ab") as f:
        f.write(b"\x5a" * 77)         # a half-written GOP
    assert os.path.getsize(out) == state.byte_offset + 77
    _, _, _, frames = yuv.open_clip(clip, W, H)
    summary = encode_clip_resumable(cfg, frames, out, N,
                                    _engine("device", cfg), ck)
    with open(out, "rb") as f:
        assert f.read() == _golden_stream(clip)
    assert summary.frames == N and not os.path.exists(ck)


def test_checkpoint_config_mismatch_rejected(clip, tmp_path, capsys):
    ck, out = str(tmp_path / "ck.json"), str(tmp_path / "o.tvc")
    other = _cfg(gop_n=3, base_qp=30)
    ckpt.save(ck, ckpt.EncodeState(other.config_hash(), 3, 100, 3, 1000, 1.0,
                                   30.0))
    assert cli.main(_argv(clip, out, "--checkpoint", ck)) == 1
    assert "config hash" in capsys.readouterr().err
    with pytest.raises(ValueError, match="does not match"):
        ckpt.load(ck, _cfg())


@pytest.mark.parametrize("where,msg", [
    ("header", "inside the"), ("past", "exceeds stream size")])
def test_checkpoint_offset_outside_the_stream_rejected(clip, tmp_path,
                                                       capsys, where, msg):
    out, ck = str(tmp_path / "o.tvc"), str(tmp_path / "ck.json")
    cfg = _cfg()
    state = _interrupt(clip, out, ck, cfg, _engine("gop", cfg))
    size = os.path.getsize(out)
    offset = STREAM_HEADER_SIZE - 1 if where == "header" else size + 4
    ckpt.save(ck, dataclasses.replace(state, byte_offset=offset))
    assert cli.main(_argv(clip, out, "--checkpoint", ck)) == 1
    assert msg in capsys.readouterr().err
    assert os.path.getsize(out) == size        # nothing truncated


def test_partial_stream_of_another_config_rejected(clip, tmp_path, capsys):
    out, ck = str(tmp_path / "o.tvc"), str(tmp_path / "ck.json")
    cfg = _cfg()
    _interrupt(clip, out, ck, cfg, _engine("gop", cfg))
    with open(out, "r+b") as f:       # the header's config hash
        f.seek(STREAM_HEADER_SIZE - 4)
        f.write(b"\0\0\0\0")
    assert cli.main(_argv(clip, out, "--checkpoint", ck)) == 1
    assert "different config" in capsys.readouterr().err


def test_verbose_checkpoint_emits_one_event_per_gop(clip, tmp_path, capsys):
    out, ck = str(tmp_path / "o.tvc"), str(tmp_path / "ck.json")
    assert cli.main(_argv(clip, out, "--checkpoint", ck, "-v",
                          "--stage-timers", "--engine", "device")) == 0
    cap = capsys.readouterr()
    events = [json.loads(ln) for ln in cap.err.splitlines()]
    assert [(e["event"], e["first"], e["frames"]) for e in events] == [
        ("gop", 0, 2), ("gop", 2, 2), ("gop", 4, 1)]
    stages = json.loads(cap.out.strip().splitlines()[-1])["stages"]
    assert sorted(stages) == ["encode_gop", "write+checkpoint"]
    assert all(s["count"] == 3 for s in stages.values())


@pytest.mark.parametrize("engine,names", [
    ("gop", ["drain+mux", "upload+dispatch"]), ("device", [])])
def test_stage_timers_in_summary(clip, tmp_path, capsys, engine, names):
    _encode(clip, str(tmp_path / "o.tvc"), "--stage-timers", "--engine",
            engine)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(out["stages"]) == names
    for s in out["stages"].values():
        assert s["count"] == 3 and s["total_s"] >= 0 and "mean_ms" in s


def test_trace_flag_writes_a_trace(clip, tmp_path, capsys):
    tdir = tmp_path / "tr"
    got = _encode(clip, str(tmp_path / "o.tvc"), "--trace", str(tdir),
                  "--engine", "device")
    assert got == _golden_stream(clip)
    files = list(tdir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_stage_timer_and_event_log():
    t = StageTimer()
    for _ in range(3):
        with t.stage("a"):
            pass
    with pytest.raises(KeyError):
        with t.stage("b"):
            raise KeyError("x")
    rep = t.report()
    assert list(rep) == ["a", "b"] and rep["a"]["count"] == 3
    assert rep["b"]["count"] == 1 and json.loads(t.to_json()) == rep
    sink = io.StringIO()
    log = EventLog(sink)
    log.emit("gop", first=0, frames=2)
    log.emit("done")
    lines = [json.loads(ln) for ln in sink.getvalue().splitlines()]
    assert [ln["event"] for ln in lines] == ["gop", "done"]
    assert lines[0]["first"] == 0 and lines[0]["ts"] >= 0


def test_trace_writes_a_file_and_raises_when_it_cannot(tmp_path, monkeypatch):
    with trace(None):
        pass
    with trace(str(tmp_path / "t")):
        torch.ones(4).add_(1)
    (path,) = (tmp_path / "t").glob("*.pt.trace.json")
    assert path.stat().st_size > 0
    # a profiler that writes nothing fails the block
    from torch.profiler import profile

    monkeypatch.setattr(profile, "export_chrome_trace", lambda self, p: None)
    with pytest.raises(RuntimeError, match="no trace"):
        with trace(str(tmp_path / "u")):
            torch.ones(4).add_(1)


@pytest.mark.parametrize("extra,msg", [
    (["--engine", "device", "--rc", "mb", "--kbps", "300"], "--rc mb"),
    (["--engine", "device", "--format", "2"], "format-1"),
    (["--engine", "device", "--gop-batch", "2"], "one frame at a time"),
    (["--engine", "device", "--tile", "2"], "one frame at a time"),
    (["--engine", "golden", "--gop-batch", "2"], "one frame at a time"),
    (["--checkpoint", "c.json", "--gop-batch", "2"], "--checkpoint"),
    (["--checkpoint", "c.json", "--tile", "2"], "--checkpoint"),
    (["--checkpoint", "c.json", "--two-pass", "--kbps", "300"],
     "--checkpoint"),
    (["--engine", "golden", "--tile", "2"], "one frame at a time"),
    (["--engine", "golden", "--devices", "2"], "need the gop engine"),
    (["--engine", "golden", "--multiprocess", "2"], "needs the gop engine"),
    (["--engine", "golden", "--failover"], "--failover wraps"),
    (["--engine", "device", "--search", "hier"], "golden/oracle-only"),
    (["--search", "hier", "--tile", "2"], "golden/oracle-only"),
], ids=["device-rc-mb", "device-format-2", "device-gop-batch", "device-tile",
        "golden", "ckpt-gop-batch", "ckpt-tile", "ckpt-two-pass",
        "golden-tile", "golden-devices", "golden-multiprocess",
        "golden-failover", "device-hier", "hier-tile"])
def test_refused_pairs_exit_2_saying_why(clip, tmp_path, capsys, extra, msg):
    out = tmp_path / "x.tvc"
    assert cli.main(_argv(clip, str(out), *extra)) == 2
    assert msg in capsys.readouterr().err
    assert not out.exists()          # checked before the file is truncated
