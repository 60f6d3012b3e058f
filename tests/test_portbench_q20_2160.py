"""The 4K configuration at qp 20, GOP 8 (`tvc1-2160-gop8-q20`, the cell
`q20-2160.g1`) on the CPU at small shapes: 96x64 and 320x192 (240 MBs,
so the frame pack's last tile holds 16 MBs, as at 3840x2160). At qp 20
the pan2 texture's I frame spends more than the budgeted 1,024 bits a
MB, so every launch overflows and is encoded again at the worst case;
the run still comes out correct, and muxing the budgeted words instead
does not. The port's GOP engine equals the plain reference there, and
its count of each download, `engine.frame_budget_fill_ppm`, equals what
the downloaded bits give against the budget."""

import math

import numpy as np
import pytest
import torch

from portbench import content, run
from portbench.reference import tvc1_fmt1 as ref
from portbench.tests.helpers import ROOT
from video_encoder_tpu_torch.codec import entropy
from video_encoder_tpu_torch.codec.config import config_from_dict
from video_encoder_tpu_torch.codec.frame import Frame
from video_encoder_tpu_torch.pipeline import gop_engine
from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine
from video_encoder_tpu_torch.utils.trace import RECORDER

torch.set_num_threads(2)
CELL = "q20-2160.g1"
SHAPES = [(96, 64), (320, 192)]
SEED = 2**31 + 29


@pytest.fixture
def recorder():
    """RECORDER emptied, on, not annotating; left so."""
    RECORDER.reset()
    RECORDER.enabled, RECORDER.annotate = True, False
    yield RECORDER
    RECORDER.enabled, RECORDER.annotate = True, False


def cpu_run(w, h, seed=SEED):
    return run.run_cell(CELL, seed, 0.3, False, device="cpu",
                        overrides={"encoder": {"width": w, "height": h}})


def planes_of(w, h, seed, gop=0):
    """Pool GOP `gop` of the cell's content at w x h, GOP 8, qp 20."""
    _, _, config, mix = run.cell_spec(CELL)
    enc = dict(config["encoder"], width=w, height=h)
    pool = content.make_pool(dict(mix, pool_batches=gop + 1), enc, seed, "cpu")
    return enc, content.pool_gop(pool, gop, 0)


def test_the_configuration_is_the_sources_4k_point():
    _, cell, config, mix = run.cell_spec(CELL)
    enc = config["encoder"]
    assert (enc["width"], enc["height"], enc["gop_n"], enc["base_qp"]) == (
        3840, 2160, 8, 20)
    assert (enc["search"], enc["rc"], enc["format_version"]) == (
        "full", "none", 1)
    assert config["reference"] == "tvc1_fmt1"
    assert cell["chips"] == 1 and cell["traffic"] == "pan2.g1"
    assert mix["gop_batch"] == 1 and mix["trace_launches"] == 8
    bench = run.load_json(f"{ROOT}/BENCHMARK.json")
    (entry,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
    assert entry["reduced"] == config["reduced"] == ["tile_devices"]
    # the budget that every GOP overflows: 24 words a block, 1,024 bits a MB
    assert gop_engine.block_words_for_qp(20) == entropy.BLOCK_WORDS_DEFAULT
    assert 32 * entropy.capacity_words(240) == 240 * 1024 + 64


@pytest.mark.parametrize("w,h", SHAPES)
def test_cell_runs_correct_with_every_launch_rerun(w, h):
    result, check, info = cpu_run(w, h)
    assert result["correct"], check
    assert result["failed"] == 0 and result["attempted"] >= 2
    assert all(c["value"] == 0 for c in check.values())
    assert info["reruns"] == info["gops"] == result["attempted"]


@pytest.mark.parametrize("w,h", SHAPES)
def test_the_budgeted_words_muxed_fail(w, h, monkeypatch):
    """GopEngine.run ignores xl: the rerun gives the budgeted launch's
    overflowed words again, and those are muxed."""
    real = gop_engine.GopEngine.run

    def budget_only(self, y, cb, cr, base_qp, xl=False):
        return real(self, y, cb, cr, base_qp)

    monkeypatch.setattr(gop_engine.GopEngine, "run", budget_only)
    result, check, info = cpu_run(w, h)
    assert info["reruns"] == info["gops"]
    assert not result["correct"]
    assert check["gop_bytes_differ"]["value"] > 0


@pytest.mark.parametrize("w,h", SHAPES)
@pytest.mark.parametrize("seed", [3, 2**31 + 41])
def test_the_engine_equals_the_reference(w, h, seed, recorder):
    """One GOP through the engine's start and finish (the overflow wait
    and the worst-case rerun) against tvc1_fmt1, byte for byte."""
    enc, planes = planes_of(w, h, seed)
    frames = [Frame.from_planes(*(p[t].numpy() for p in planes))
              for t in range(enc["gop_n"])]
    eng = GopEngine(config_from_dict(enc), device="cpu")
    packets, stats = eng.finish(eng.start([frames], [0]))[0]
    want, sse = ref.encode_gop(enc, *planes)
    assert [p.to_bytes() for p in packets] == want
    assert recorder.counters["engine.overflow_reruns"] == 1
    n_y = planes[0][0].numel()
    for s, e in zip(stats, sse.tolist()):
        assert s.psnr_y == (10 * math.log10(255.0**2 * n_y / e[0]) if e[0]
                            else math.inf)


def counts(recorder, name):
    return [r[5] for r in recorder.records() if r[1] == name]


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("xl", [False, True])
def test_the_download_counts_its_frames_against_the_budget(g, xl, recorder):
    """A budgeted and a worst-case download, of one GOP and of a lockstep
    pair: the largest frame's bits as the downloaded bits give them, over
    the budget of the frame's 24 MBs whichever launch the words came
    from, in parts per million."""
    gops = [planes_of(96, 64, 2**31 + 7 + i)[1] for i in range(g)]
    enc = planes_of(96, 64, 1)[0]
    eng = GopEngine(config_from_dict(dict(enc, gop_n=8)), device="cpu")
    if g == 1:
        outs = eng.run(*gops[0], 20, xl=xl)
    else:
        y, cb, cr = (torch.stack([p[i] for p in gops], 1) for i in range(3))
        outs = eng.run_batch(y, cb, cr, [20, 20], xl=xl)
    host = eng.download(outs)
    assert host["bits"].shape == ((8,) if g == 1 else (8, g))
    budget = 32 * entropy.capacity_words(24)
    assert counts(recorder, "engine.frame_budget_fill_ppm") == [
        int(host["bits"].max()) * 10**6 // budget]
    # in the download's finish.copy span
    (copy,) = [r[0] for r in recorder.records() if r[1] == "finish.copy"]
    assert [r[4] for r in recorder.records()
            if r[1] == "engine.frame_budget_fill_ppm"] == [copy]
    # the I frame overflows the budget at qp 20; the worst case holds it
    assert bool(outs["ovf"].any()) != xl
    if xl:
        assert int(host["bits"].max()) > 24 * 1024
        assert np.all(host["bits"] <= 32 * entropy.max_words(24))


def _cut_words(outs):
    """The words as the plain copy gives them: cut to the longest payload,
    .cpu(), viewed as uint32."""
    maxw = (int(outs["bits"].max()) + 31) // 32
    return outs["words"][..., :maxw].cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("w,h", SHAPES)
def test_a_rerun_over_the_budget_makes_the_buffer_again(w, h, recorder,
                                                        monkeypatch):
    """The staging path on the CPU (a fake _pinned): the budgeted launch
    overflows on its I frame, so the worst-case rerun's words, cut to the
    longest payload, are more than the budgeted words. Its download makes
    the buffer again at their size, a second rerun's reuses it, and both
    equal the plain copy byte for byte."""
    made = []

    def pinned(n, dtype):
        made.append(n)
        return torch.empty(n, dtype=dtype)

    monkeypatch.setattr(gop_engine, "_STAGING_DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(gop_engine, "_pinned", pinned)
    enc, planes = planes_of(w, h, SEED)
    eng = GopEngine(config_from_dict(enc), device="cpu")
    budgeted = eng.run(*planes, 20)
    assert bool(budgeted["ovf"].any())
    eng.download(budgeted)
    for _ in range(2):
        outs = eng.run(*planes, 20, xl=True)
        plain = _cut_words(outs)
        assert eng.download(outs)["words"].tobytes() == plain.tobytes()
    assert made == [budgeted["words"].numel(), plain.size]
    assert plain.size > budgeted["words"].numel()
    assert counts(recorder, "finish.copy_staged") == [1, 1, 1]
    assert counts(recorder, "finish.staging_bytes") == [4 * n for n in made]


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the page-locked staging buffer "
                    "exists only on the card")
    return torch.device("cuda", 0)


def test_a_4k_rerun_lands_in_the_staging_buffer_on_card(recorder, cuda):
    """At 3840x2160, GOP 8, qp 20 on the cell's content: the budgeted
    launch overflows, the worst-case rerun's words (cut to the longest
    payload, about 34 MB) make the page-locked buffer again at their size,
    a second rerun's download (the key's capture) reuses it, and both
    equal the pageable copy byte for byte."""
    _, _, config, mix = run.cell_spec(CELL)
    enc = config["encoder"]
    pool = content.make_pool(dict(mix, pool_batches=1), enc, SEED, cuda)
    planes = content.pool_gop(pool, 0, 0)
    eng = GopEngine(config_from_dict(enc), device=cuda)
    budgeted = eng.run(*planes, 20)
    assert bool(budgeted["ovf"].any())
    eng.download(budgeted)
    for _ in range(2):
        outs = eng.run(*planes, 20, xl=True)
        host = eng.download(outs)
        plain = _cut_words(outs)
        assert host["words"].tobytes() == plain.tobytes()
    assert eng._staging.is_pinned()
    assert eng._staging.numel() == plain.size > budgeted["words"].numel()
    assert counts(recorder, "finish.copy_staged") == [1, 1, 1]
    assert counts(recorder, "finish.staging_bytes") == [
        4 * budgeted["words"].numel(), 4 * plain.size]
