"""The harness end to end on the CPU at small shapes: every cell comes out
correct; with the timed path broken underneath, correct comes out false;
the last line has the result's shape; no run loads JAX or the JAX
package; a machine without a card gets no result."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.tests.helpers import ROOT, tiny
from video_encoder_tpu_torch.codec import entropy
from video_encoder_tpu_torch.pipeline import gop_engine

torch.set_num_threads(2)
CELLS = [c["name"] for c in run.load_json(f"{ROOT}/BENCHMARK.json")["workloads"]]
SEED = 2**31 + 17


def cpu_run(workload, seconds=0.3):
    return run.run_cell(workload, SEED, seconds, False, device="cpu",
                        overrides=tiny(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct(workload):
    result, check, info = cpu_run(workload)
    assert result["correct"], check
    assert result["failed"] == 0 and result["attempted"] >= 2
    assert all(c["value"] == 0 for c in check.values())
    assert info["loaded"] == []
    assert set(result["metrics"]) >= {"encode_fps", "setup_s"}


@pytest.mark.parametrize("workload", CELLS)
def test_state_left_unchanged_fails(workload, monkeypatch):
    """The reconstruction carry never advances: every P frame is predicted
    from the I frame's recon."""
    real = gop_engine.code_pack_traced
    kept = {}

    def frozen(cur, pred, dy, dx, is_inter, is_p, *args, **kw):
        out = real(cur, pred, dy, dx, is_inter, is_p, *args, **kw)
        if is_p:
            out["rec"] = kept["rec"]
        else:
            kept["rec"] = out["rec"]
        return out

    monkeypatch.setattr(gop_engine, "code_pack_traced", frozen)
    result, check, _ = cpu_run(workload)
    assert not result["correct"]
    assert check["gop_bytes_differ"]["value"] > 0


@pytest.mark.parametrize("workload", [c for c in CELLS if c.endswith(".g4")])
def test_half_of_the_batch_left_out_fails(workload, monkeypatch):
    """A lockstep batch encodes its first two GOPs and reports them for
    all four."""
    real = gop_engine.GopEngine.run_batch

    def half(self, y, cb, cr, base_qps, xl=False, hop=None):
        g = y.shape[1] // 2
        y, cb, cr = (torch.cat([p[:, :g], p[:, :g]], 1) for p in (y, cb, cr))
        return real(self, y, cb, cr, base_qps, xl=xl, hop=hop)

    monkeypatch.setattr(gop_engine.GopEngine, "run_batch", half)
    result, check, _ = cpu_run(workload)
    assert not result["correct"]
    assert check["gop_bytes_differ"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_answer_altered_where_produced_fails(workload, monkeypatch):
    """One bit of each frame's payload flipped in the pack that makes it."""
    real = entropy.pack_frame_planes

    def flipped(*args, **kw):
        words, bits, mb_bits, ovf = real(*args, **kw)
        words = words.clone()
        words[..., 0] ^= 1 << 20
        return words, bits, mb_bits, ovf

    monkeypatch.setattr(entropy, "pack_frame_planes", flipped)
    result, check, _ = cpu_run(workload)
    assert not result["correct"]
    assert check["gop_bytes_differ"]["value"] > 0


def test_last_line_has_the_result_shape():
    result, check, info = cpu_run("full1080.g1")
    device = dict(platform="gpu", kind="NVIDIA H100 80GB HBM3", count=1,
                  memory_peak_bytes=1)
    line = json.loads(run.result_line(dict(result, breakdown={
        "device_ops": [["k", 0.1]], "idle_gaps": [["finish.mux", 0.01]]}),
        check, device))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "check"]
    bench = run.load_json(f"{ROOT}/BENCHMARK.json")
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
    for c in line["check"].values():
        assert set(c) == {"value", "limit"}
    assert "breakdown" not in json.loads(run.result_line(result, check, device))


def test_trace_metrics_are_named_in_the_benchmark():
    bench = run.load_json(f"{ROOT}/BENCHMARK.json")
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert os.path.exists(f"{ROOT}/portbench/metrics/{m['name']}.py")
    for cell in CELLS:
        names = [m["name"] for m in run.cell_metrics(bench, cell, "per_layer")]
        assert len(names) >= 5
        e2e = [m["name"] for m in run.cell_metrics(bench, cell, "end_to_end")]
        assert "setup_s" in e2e and "encode_fps" in e2e


def test_no_run_loads_jax_or_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import run, control\n"
            "from portbench.tests.helpers import tiny\n"
            "run.run_cell('rcmb1080.g4', 3, 0.2, False, device='cpu',"
            " overrides=tiny('rcmb1080.g4'))\n"
            "print(run.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert run.FORBIDDEN == ("jax", "jaxlib", "flax", "video_encoder_tpu")


def test_sources_import_neither_jax_nor_the_port_in_the_reference():
    def tops(path):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                yield from (a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                yield node.module.split(".")[0]

    for dirpath, _, files in os.walk(f"{ROOT}/portbench"):
        for f in files:
            if f.endswith(".py"):
                names = set(tops(os.path.join(dirpath, f)))
                assert not names & set(run.FORBIDDEN), f
                if "reference" in dirpath:
                    assert "video_encoder_tpu_torch" not in names, f
                    assert "portbench" not in names, f


def test_no_card_no_result(tmp_path):
    """Here there is no card: a non-zero exit and nothing on stdout; the
    same in a directory with only BENCHMARK.json and the harness."""
    cmd = [sys.executable, "portbench/run.py", "--workload", "full1080.g1",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(f"{ROOT}/portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
def test_cell_on_the_card(card):
    """One short run of each cell on the card, correct."""
    for cell in CELLS:
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
             "5", "--seconds", "2", "--trace", "0"], capture_output=True,
            text=True, cwd=ROOT, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.splitlines()[-1])["correct"]
