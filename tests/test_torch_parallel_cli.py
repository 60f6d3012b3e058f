"""The port CLI's encode over ranks on the CPU: `--devices N [--tile S]`,
`--multiprocess N` and `--failover`, each the file of the single-device
CLI, with its PSNR (the reference's DP summary reads 0.0: pinned here);
every refused pair exits 2 before the output is opened; a rank that fails
makes the coordinator raise, or under --failover re-encode on the
survivor. Ranks are gloo CPU processes started by the CLI itself."""

import json
import time

import pytest
import torch

from video_encoder_tpu_torch import cli
from video_encoder_tpu_torch.parallel import multiprocess as mp

W, H, GOP, N = 96, 64, 3, 14       # 4 full GOPs and a short one of 2


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    y, cb, cr = mp.synth_gops(1, N, H, W, seed=9)
    path = tmp_path_factory.mktemp("pcli") / "in.yuv"
    with open(path, "wb") as f:
        for t in range(N):
            f.write(y[0, t].tobytes() + cb[0, t].tobytes() + cr[0, t].tobytes())
    return str(path)


def _argv(clip, out, *extra):
    return ["encode", "-i", clip, "-W", str(W), "-H", str(H), "-o", str(out),
            "--gop", str(GOP), "--qp", "26", "--device", "cpu", *extra]


def _run(capsys, clip, out, *extra):
    rc = cli.main(_argv(clip, out, *extra))
    cap = capsys.readouterr()
    lines = cap.out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 else None), cap.err


@pytest.fixture(scope="module")
def plain(clip, tmp_path_factory):
    out = tmp_path_factory.mktemp("plain") / "p.tvc"
    assert cli.main(_argv(clip, out)) == 0
    return out.read_bytes()


@pytest.mark.parametrize("flags,env,ranks", [
    (["--devices", "4"], {}, 4),
    (["--devices", "4", "--tile", "2"], {}, 4),
    (["--multiprocess", "2"], {}, 2),
    (["--failover"], {"TVC_FAULT_GOPS": "3", "TVC_FAULT_TIMES": "2"}, None),
    (["--devices", "2", "--failover"], {"TVC_FAULT_GOPS": "3"}, 2),
    (["--tile", "2", "--failover"], {"TVC_FAULT_GOPS": "0"}, None),
], ids=["devices4", "devices4-tile2", "multiprocess2", "failover",
        "devices2-failover", "tile2-failover"])
def test_ranks_give_the_single_device_file(clip, plain, tmp_path, capsys,
                                           monkeypatch, flags, env, ranks):
    """The file and the PSNR of the plain encode. Rank runs name their
    backend and each rank's device; an injected fault re-dispatches on
    the survivor, whose device the stderr line names."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = tmp_path / "o.tvc"
    rc, summary, err = _run(capsys, clip, out, *flags)
    assert rc == 0, err
    assert out.read_bytes() == plain
    _, want, _ = _run(capsys, clip, tmp_path / "p.tvc")
    assert summary["frames"] == N and summary["mean_psnr_y"] == want["mean_psnr_y"]
    assert summary["mean_psnr_y"] > 20
    if ranks is not None:
        assert summary["backend"] == "gloo"
        assert len(summary["ranks"]) == ranks
        assert all(r["device"] == "cpu" for r in summary["ranks"])
    if env:
        lines = [json.loads(ln) for ln in err.splitlines()
                 if ln.startswith('{"failover"')]
        assert lines and all(ln["device"] == "cpu" for ln in lines)
        assert summary["faults_injected"] >= 1


def test_reference_dp_summary_reads_zero_psnr(clip, tmp_path, capsys):
    """On the 12 frames of four full GOPs, one batch of the reference's
    `--devices 4` (the fake CPU devices) and of the port's: the same file
    as the single-device encode, but the reference's DP branch drops sse,
    so its summary reads PSNR 0.0 (VERDICT.md weak #5); the port's reads
    the single-device PSNR."""
    import jax

    from video_encoder_tpu import cli as reference_cli

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (fake) devices")
    ref = tmp_path / "r.tvc"
    assert reference_cli.main(["encode", "-i", clip, "-W", str(W), "-H",
                               str(H), "-o", str(ref), "--gop", str(GOP),
                               "--qp", "26", "--frames", "12",
                               "--devices", "4"]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rc, ours, err = _run(capsys, clip, tmp_path / "o.tvc", "--frames", "12",
                         "--devices", "4")
    assert rc == 0, err
    _, plain, _ = _run(capsys, clip, tmp_path / "p.tvc", "--frames", "12")
    assert (ref.read_bytes() == (tmp_path / "p.tvc").read_bytes()
            == (tmp_path / "o.tvc").read_bytes())
    assert theirs["mean_psnr_y"] == 0.0
    assert ours["mean_psnr_y"] == plain["mean_psnr_y"] > 20
    assert len(ours["ranks"]) == 4 and ours["backend"] == "gloo"


@pytest.mark.parametrize("extra,msg", [
    (["--checkpoint", "c.json", "--failover"], "pick one"),
    (["--failover", "--gop-batch", "2"], "does not take --gop-batch"),
    (["--devices", "3", "--tile", "2"], "not divisible by --tile"),
    (["--devices", "2", "--two-pass", "--kbps", "300"], "--devices/--tile need"),
    (["--devices", "2", "--engine", "device"], "--devices/--tile need"),
    (["--devices", "2", "--multiprocess", "2"], "--devices/--tile need"),
    (["--multiprocess", "2", "--two-pass", "--kbps", "300"],
     "--multiprocess needs"),
    (["--multiprocess", "2", "--engine", "device"], "--multiprocess needs"),
    (["--failover", "--two-pass", "--kbps", "300"], "--failover wraps"),
    (["--failover", "--engine", "device"], "--failover wraps"),
    (["--failover", "--multiprocess", "2"], "--failover wraps"),
    (["--checkpoint", "c.json", "--devices", "2"], "--checkpoint is the"),
    (["--devices", "2", "--gop-batch", "2"], "spread them over ranks"),
    (["--devices=-1"], "N >= 1"),
    (["--devices", "2", "--tile", "2", "--search", "diamond"],
     "--search full"),
    (["--devices", "3", "--tile", "3"], "do not divide"),
])
def test_refused_pairs_exit_2(clip, tmp_path, capsys, extra, msg):
    out = tmp_path / "x.tvc"
    rc, _, err = _run(capsys, clip, out, *extra)
    assert rc == 2 and msg in err
    assert not out.exists()             # checked before the file is opened


def test_devices_on_cuda_without_cuda_fails(clip, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    argv = ["encode", "-i", clip, "-W", str(W), "-H", str(H), "-o",
            str(tmp_path / "x.tvc"), "--devices", "2"]     # --device cuda
    assert cli.main(argv) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_a_failed_rank_fails_the_run_or_fails_over(clip, plain, tmp_path,
                                                   capsys, monkeypatch):
    """Rank 1 raises before its first batch (TVC_FAULT_RANK): its tile
    peer waits in a collective, the coordinator sees the exit, stops the
    group and raises with the rank's stderr; under --failover it encodes
    every GOP not received on the survivor, to the plain file."""
    monkeypatch.setenv("TVC_FAULT_RANK", "1:0")
    t0 = time.perf_counter()
    rc, _, err = _run(capsys, clip, tmp_path / "x.tvc", "--devices", "2",
                      "--tile", "2")
    assert rc == 1
    assert "rank 1 exited with code 1" in err
    assert "injected fault on rank 1" in err
    assert time.perf_counter() - t0 < mp.DEFAULT_TIMEOUT_S / 4
    out = tmp_path / "o.tvc"
    rc, summary, err = _run(capsys, clip, out, "--devices", "2", "--tile",
                            "2", "--failover")
    assert rc == 0, err
    assert out.read_bytes() == plain
    lines = [json.loads(ln) for ln in err.splitlines()
             if ln.startswith('{"failover"')]
    assert [ln["firsts"] for ln in lines] == [[0, 3, 6, 9]]
    assert summary["ranks"] == [] and summary["mean_psnr_y"] > 20


def test_a_silent_group_times_out(clip):
    """No rank reports within the timeout (here shorter than a rank's
    start): the group is stopped and RankFailure says so."""
    job = dict(kind="transport", seed=1, shape=[16, 16], halos=[1],
               grid=[1, 2])
    t0 = time.perf_counter()
    with pytest.raises(mp.RankFailure, match="no rank reported"):
        with mp.RankGroup(2, [job], device="cpu", timeout_s=0.2) as group:
            for _ in group.events():
                pass
    assert all(p.poll() is not None for p in group.procs)
    assert time.perf_counter() - t0 < 60


def test_spawn_self_check():
    """The reference's `--spawn N` check (here over the launch's file
    rendezvous, port 0: a free tcp port can be taken by a parallel test's
    sockets before rank 0 binds it): each rank's GOPs of a synthetic batch
    equal the single-device engine's."""
    extra = ["--gops", "4", "--frames", "3", "--width", "64", "--height", "48"]
    rows = mp.spawn(2, 0, extra, device="cpu", timeout_s=240)
    assert [r["owned_gops"] for r in rows] == [[0, 1], [2, 3]]
    assert all(r["mismatched_gops"] == 0 and r["backend"] == "gloo"
               for r in rows)
