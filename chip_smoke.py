"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code not 0):

1. Device: requires CUDA; prints the card's name and power limit.
2. Build: compiles every kernel under video_encoder_tpu_torch/csrc/ and
   prints each kernel's registers and spill bytes (nvcc -Xptxas -v): the
   search and the whole SAD map (tiled_kernel), the even map
   (even_map_kernel), sad_at_kernel, the decoders' recon_kernel and
   recon_rows_kernel, and the others.
3. Kernels: every kernel entry of the port, one per launch counter
   (the single-plane kernels of format 1, block_pack in the format-2
   syntax, code_plane with the quant matrix, the format-3/4 I-frame row
   scan of a whole plane in one launch, the chroma twin of sad_at_mv),
   against its plain PyTorch version on the card at the main paths'
   shapes (1088x1920 luma, 544x960 chroma, the odd 368x640 grid, the row
   scan with and without intra slices, the diamond descent (walk and
   final +-1 step in one launch) through dispatch.diamond_search on
   panned, corner-bound and random 1088x1920 planes, timed beside the
   plain descent and the route before its kernel (the plain walk with
   the final step on sad_at_mv), the half-pel refine's nine
   candidates on four parity planes, the span strings of real 1080p and
   320x192 frames and dense overflowing pieces), exact equality
   (tolerance 0: the codec is integer-only), with both times, the least
   time the card could take (bytes moved over its memory rate, or integer
   operations over its peak, whichever is larger) and, where one PyTorch
   call computes the same function, that call's time. Each timed entry
   also prints its device time per launch (the kernels' own duration
   under torch.profiler) and its host time per call (perf_counter over
   calls without a sync): under ~0.05 ms the call time is the host's.
   Then the G-batched kernels at G = 4
   on the same shapes ([4, 1088, 1920], [4, 544, 960], K = 4 and K = 9 on
   four planes, the row scan of four planes, the descent of four panned
   planes): each equal to its plain
   batched version and to G launches of the single-plane kernel, whose
   time stands beside its own. Then the pre-haloed kernels
   of the tile-sharded encode (full search, MC fetch luma and chroma, and
   sad_at_mv on four halo-extended parity planes): a 1088x1920 frame's
   four row shards (cur [4, 272, 1920] against ref_ext [4, 304, 1920];
   chroma [4, 136, 960] from [4, 152, 960]) and its 2 x 2 tiles
   ([4, 544, 960] against [4, 576, 992]) as one batch, each equal to its
   plain version and, the shards' results put together, to the unsharded
   kernel on the whole frame; the odd 368x640 grid as one unbatched shard
   in both geometries.
   Then the decoders' recon, two entries of the code_plane kernel:
   recon_plane (the inter recon of a plane, against a predictor or the
   flat 128 of an I frame at formats 1-2) and recon_plane_rows (the
   format-3/4 I-frame recon, one launch per plane, without intra slices
   and with slices of 2 and 17 rows), at 1088x1920, 544x960, 368x640 and
   184x320, flat and under the quant matrix, on sparse levels and on
   levels drawn from the int16 extremes at the largest step (the inverse's
   int32 sums wrap), each equal to its plain version and its byte plane
   to its recon; timed at qp 28 on 1088x1920 and 544x960 as the decoders
   run them (call, device and host times, plain, bound by bytes).
   Then the MC predictor, which makes a P step's three predictor planes
   in one launch (one reference plane, or four parity planes and
   half-pel vectors at format 4; intra MBs 128): single at 1088x1920 and
   368x640, G = 4, and a 1088x1920 frame's four row shards and 2 x 2
   tiles from pre-haloed stacks, formats 1 and 4, each equal to the plain
   composition (a fetch per plane, the parity select, the mask), to one
   torch.take of its flat indices and, sharded, to the unsharded kernel;
   at 1088x1920 with call, device and host times, plain, bound (only
   the inter MBs read), and that torch.take's call and device times (the
   two call times as medians of five runs each, taken in turns).
   Then the kernels no encode path runs by default: the whole SAD map
   (1089 candidates per MB) at 1088x1920 and 368x640, single and G = 4,
   each equal to its plain version, its packed-key first minimum equal to
   full_search's and its even sublattice to sad_map_even's; the SEA full
   search's three entries (single with its row counts, G = 4, four row
   shards) against three references of the 1080p pan's frame 1 (the clean
   source frame 0, the port's own qp-28 recon of it, noise), each equal to
   its plain version and the exhaustive kernel, with its mean rows per MB,
   its time (call, device and host) beside the exhaustive kernel's and a
   bound from this run's rows; chunk_merge on the pieces of a real 1080p
   frame at 24 words (65536 pieces, k = 1024) and on dense random pieces,
   with call, device and host times, its device ops per call and a bound
   that reads each piece's used words only (so do the span merges'); the
   hierarchical
   search at 1088x1920 against plain, with its two sad_at_mv launches.
   The pack's words are int32 holding uint32 bit patterns (block_pack's
   output, the merges' input and output, checked), so each pack row's
   bound counts 4 bytes a word. After the span merges, row 17: the frame
   pack's tail (dispatch.frame_assemble, two launches) on a real 1080p
   frame's block strings at 16 words in both syntaxes, alone and for G = 4
   frames in one call, and rc mb's lengths-only launch, each against its
   plain version; then the frame emit's whole pack (entropy.
   pack_frame_planes: block_pack and the tail) of that frame, alone and
   for G = 4: call, device and host times, device kernels per call, and
   the bytes it must move over the memory rate.
4. Paths: the port CLI encodes three 1920x1080 I420 clips of 30 frames
   (GOP 30, qp 28) in-process on the card: full search, rc none, format
   1; on a smoother texture, diamond search, rc mb and --kbps 12000
   (BASELINE config 3); and, on a clip with true half-pel motion, format
   4 with the quant matrix and chroma qp offset 2. Each runs under the
   engine's default emit and each stream must be byte-identical to the
   C++ oracle's; the oracle decodes it and PSNR-Y is checked. The share
   of inter MBs with a half-pel vector in the format-4 stream must be
   above 0. The config-3 and format-4 clips are then encoded in-process
   under the other emit and must give the same packets. Launch counts
   are zeroed before and read after each path; every kernel of a path
   must have launched, the predictor once per P step of a run (or of a
   lockstep or tiled step), and no single-plane fetch on any path; at
   formats 3 and 4 every I step one row-scan launch per plane and no
   [8, W] stripe through code_plane, on every route (single GOP, lockstep,
   tiled). Then the GOP engine's CUDA graphs (`phase_graphs`): on each
   1080p clip one engine encodes the 30-frame GOP three times (the eager
   loop, the capture and its replay, a replay), each equal to the CLI's
   stream with the launches of the eager loop; two GOPs in flight (the
   clip and the clip backwards, the second launched before the first is
   finished) each equal to its own eager encode; one replay traced, its
   search and code_plane kernels named in the trace. Then 640x360: GOP 1 (odd 23-row MB grid), format 2
   (chroma qp offset 4, diamond, rc vbv at 1500 kbps) and format 3 (quant
   matrix, intra slices of 2 MB rows, rc adaptive, GOP 4), 12 frames
   each, against the oracle. The oracle's encodes run side by side on the
   host's CPU before the port's.
   Then decode: every stream above (the three 1080p clips, the three
   640x360 ones and the format-4 clip at `--intra-slice 17`) decoded
   through the port CLI in-process with `--engine gop`, `--engine
   device`, `--engine native --workers 1`, `--workers 0` and `--workers
   3`, each file byte-identical to the oracle's decode of the stream; on
   the device engines mc_predict launches once per P frame, recon_plane
   three times per P frame and, at formats 1-2, per I frame,
   recon_plane_rows three times per I frame at formats 3-4, and nothing
   else (no single-plane fetch, no stripe); the C++ engines launch
   nothing. The device decoders replay one CUDA graph per key from a
   key's second call (DecodeKey: a GOP; DecodeFrameKey: a frame): each
   decode's graph calls are counted (eager, capture, replay) and must be
   what its GOP and frame counts give (the 640x360 GOP-1 stream's GOPs
   3-30 and the format-3 stream's GOP 3 are replays), printed with the
   capture seconds. Then the 1080p decode rates of the GOP engine, per
   stream through the GOP key's graph and through the eager loop in
   turns (graph, eager, eager, graph): device-resident (the GOP uploaded
   once, its frames rebuilt, one sync), with its host calls per GOP,
   device ops per frame and busy share (traced and over the untraced
   wall) from torch.profiler and the capture seconds; with the parse and
   the download, and those host stages on their own; and the CLI wall
   rates of the engines beside os.cpu_count() (printed, claimed
   nowhere).
   Then the golden model (`phase_golden`; `--engine golden`, the numpy
   executable spec, on the host's CPU): the port CLI encodes the 640x360
   GOP-1 clip (30 frames) and the format-2 clip, each equal to the
   oracle's stream; `--search hier` on the format-2 clip at format 1, GOP
   12, equal to one more oracle encode at hier; `--rc mb --kbps 3000` on
   it (diamond), equal to the GOP engine's stream of the same flags on
   the card; and `decode --engine golden` of the format-2, format-3 and
   GOP-1 streams, each equal to the oracle's decode. The seven golden
   jobs run side by side, each a child process (`chip_smoke.py
   --cli-child ARGS`) that must launch no kernel and leave CUDA
   uninitialised, with their host wall fps beside os.cpu_count(). The
   C++ library must load (`native.available()`), and no decode of the
   phase may print the native decode's fallback warning.
   Then the batched-GOP paths, `--gop 10 --gop-batch 3` on the same
   30-frame 1080p clips (one lockstep encode of three GOPs): config 3
   against the oracle's stream of that GOP length, and so is config 3's
   unbatched GOP-10 encode (the CLI launches GOP k + 1 before it drains
   GOP k; GOPs 2 and 3 are graph replays); full search and
   format 4 against the port's own unbatched stream, format 4 also
   in-process under the other emit; config 3 once more with a tail
   (`--gop 12 --gop-batch 2`: a batch of two and a short GOP of 6). Every
   `_g` kernel of a path must have launched (the batched predictor once
   per P step), no single-plane kernel in a run without a tail, and the folded block pack and span merges once
   per plane and frame step, not G times. Then the GOP-10 streams
   decoded (`phase_decode_graphs`): config 3 unbatched (the oracle's
   stream) and the full-search and format-4 streams of three GOPs of 10
   (which their `--gop-batch 3` streams equal) through the port CLI under
   `--engine gop` (GOP 3 a replay) and `--engine device` (the P key
   captured at frame 2, the I key at frame 10, every other frame from 3
   on a replay), each through the graphs and eagerly in
   turns, each file equal to the oracle's decode (config 3) or `--engine
   native`'s, with the same launches both ways and the graph calls and
   capture seconds printed. Then the per-frame engine
   (`--engine device`), each run through its CUDA graphs (frames 0 and 1
   eager, frame 2 the capture of the P key, the later P frames replays)
   and through the eager path (`eager_paths()`) in turns: the 1080p
   full-search clip (graph, eager, eager, graph), equal to the oracle's
   stream, and the config-3 texture at `--search diamond` with `--rc
   bitrate --kbps 12000` and with `--rc adaptive` (graph, eager), each
   equal to the GOP engine's stream of the same flags; each run launches
   the search (or the even map and the descent) and mc_predict once per P
   frame, code_plane three times per frame and nothing else, the same
   under the graph as eager; its CLI wall fps beside the GOP engine's,
   and one traced P frame, replayed and eager: device ops, busy share and
   host calls, and the P key's capture seconds.
   Then `--checkpoint`: the full-search clip at `--gop 10`, interrupted
   after its first GOP through the library and resumed by the CLI under
   `--engine gop` and `--engine device`, each equal to the uninterrupted
   stream, its checkpoint file gone and its summary carrying the
   checkpoint path's stages; then one `--trace DIR --stage-timers`
   encode of the clip's three GOPs (the first eager, the others graph
   replays), whose trace file names tiled_kernel and plane_kernel more
   often than the eager GOP launched them and whose summary carries the
   GOP path's stages. Then
   two-pass: 640x360,
   `--two-pass --kbps 3000`, equal to the port's own `--device cpu`
   stream, decoded by the oracle above the PSNR floor, its per-GOP qps
   printed. Then the tile-sharded paths, every shard on the one card:
   `--tile 4` on the full-search clip, `--gop 10 --gop-batch 3 --tile 2`,
   and the format-4 clip with `--intra-slice 17 --tile 2` (whose unsharded
   stream at `--intra-slice 17` is held against one more oracle encode),
   each equal to the port's unsharded stream; then the multi-GOP tiled
   encodes whose later batches replay the tile loop's graph: `--gop 10
   --tile 2` (GOPs 2-3 replays), equal to the unsharded GOP-10 stream,
   in turns with the eager path (same stream and launches), and `--gop 5
   --gop-batch 3 --tile 2` (two batches, the second a replay), equal to
   the port's unsharded GOP-5 stream. The pre-haloed search and
   predictor must have launched once per P step, and no unsharded
   search, predictor or fetch, nor a pre-haloed single-plane fetch. Then TVC_SEA=1 on the full-search clip (GOP 30; `--gop 10
   --gop-batch 3`; `--tile 4`), each byte-identical to the port's stream
   without it (the first also to the oracle's), each through its SEA entry
   once per P step and no exhaustive search. Then the encode over ranks
   (`phase_distributed`; parallel/, one process per rank, the kernel
   library built once by this process before any rank starts; ranks
   sharing the card run over gloo, a rank with a card of its own over
   NCCL): at `--gop 10` on the 1080p clips, `--devices 3` on the full
   and config-3 clips (DP: three GOPs over three ranks), `--devices 4
   --tile 2` (two GOPs in 2 x 2 ranks, the third on the coordinator),
   the format-4 clip with `--intra-slice 17 --devices 2 --tile 2` (the
   parity-then-pad exchange between processes), `--multiprocess 2`,
   `--failover` with TVC_FAULT_GOPS=10 alone (and TVC_FAULT_TIMES=2, so
   the survivor encodes GOP 10) and with `--devices 3` (the batch is
   encoded on the survivor), and `--devices 1` (NCCL at world size 1),
   each equal to the port's unbatched GOP-10 stream (config 3 to the
   oracle's GOP-10 stream), above the PSNR floor, with the backend, the
   ranks' devices, the wall fps, each rank's encode seconds and, on tile
   ranks, the transport's bytes and ms per P frame printed, and every
   kernel of the path launched by the ranks or the coordinator; where the
   host has two cards, `--devices 2 --tile 2` over NCCL (else it says the
   run waits for such a host). Then the tile program of one GOP at world
   size 1 through the transport (its frames equal the plain stream's) with
   the transport check, and RingEncoder over 4 ranks on four streams cut
   from the full clip (10, 10, 10 and 7 frames) at `--rc bitrate --kbps
   12000`, each equal to its single-device encode. Then the ring and the
   2-D tile grid on the one card through their CUDA graphs
   (`phase_ring_grid`): RingEncoder on one device (D = 4 columns, the
   hop a roll asked for by name, GraphKey hop "roll") on the same four
   streams at the same flags, encoded four times by one encoder (eager,
   the capture and its replay, a replay, then with no graph), each
   stream equal to its single-device GOP-engine encode with the same
   launches every time; and encode_gop_tiled2d on a 2 x 2 grid over the
   padded 1088x1920 planes at GOP 10 and worst-case capacities, the
   clip's three GOPs one call each (eager, capture, replay: Tile2dKey):
   rc none on the full-search clip, each GOP's frames glued by
   assemble_frame_2d equal to the port's unsharded GOP-10 stream, and rc
   mb at 12000 kbps with full search on the config-3 texture, equal to
   the GOP engine's stream of those flags; the same launches every call
   and the graph calls printed.
5. Speed: device-resident 1080p GOP-30 encode fps, without and with each
   GOP's finish, for {full, rc none; diamond, rc mb} x {frame, chunks}
   (the emits timed in turns) and for the format-4 cell under the default
   emit, each through the GOP's CUDA graph and through the eager loop
   (`GopEngine._run`) in turns, each with its device ops per frame, busy
   share, top device times, the search's device time per GOP and the
   host's submitting calls (kernel and graph launches, copies, fills) per
   GOP from torch.profiler, the graphs' capture seconds and the reserved
   memory; the format-4 I frame on its own (its code_plane launches,
   device ops, device ms and wall ms), and the CLI's wall fps. Then the
   three cells at G = 1, 2 and 4 GOPs in lockstep (G = 1 is the
   single-GOP path), graph and eager in turns within this one run:
   device-resident fps, device ops per frame, busy share and host calls
   (the G = 1 traces are the ones taken of that GOP just before), capture
   seconds and reserved memory; and per G and emit one eager batch from a
   settled allocator: the peak allocated memory
   (torch.cuda.reset_peak_memory_stats before it), the memory allocated
   before it, and its download bytes per GOP (all, and the words alone).
   Then the full-search cell with every
   frame in S = 1, 2 and 4 row shards, in turns, all under the tile
   path's emit, each through its graph and through the eager loop in
   turns: device-resident fps, host calls per GOP, device ops per frame,
   busy share (traced and over the untraced wall) and capture seconds.
   Then the ring on one card (D = 4 columns of the full-search clip,
   GOP 30, the engine's loop with the roll as RingEncoder runs it) and
   the 2 x 2 grid (GOP 30, budgeted capacities, the worst case on an
   overflow), each through its graph and through the eager loop in turns
   (ring, grid, grid, ring; graph and eager, then eager and graph):
   device-resident fps, host calls per GOP, device ops per frame, busy
   share (traced and over the untraced wall) and capture seconds;
   findings, no claim. Then the
   full-search cell with TVC_SEA 0 and 1 in turns, each through its own
   graph, with the search's device time of each. The reserved memory is
   printed after each phase.

    python3 chip_smoke.py --ab ROOT [ROOT ...]

times the search, MC, code_plane, block_pack, SEA and merge kernels of
several checkouts of the repository
(a parent unpacked with `git archive` under build/, and this one) in
turns, ROOT_1 .. ROOT_n then ROOT_n .. ROOT_1, each turn a child process
that imports the port from its ROOT (building its kernels into
ROOT/build) and this file's helpers: at 1088x1920 the exhaustive search
(single, G = 4, four row shards), the even SAD map (single, G = 4) and the
whole one, sad_at_mv (K = 4 over the whole window; the half-pel refine's
nine on four parity planes, single, G = 4 and on four pre-haloed row
shards), the diamond search (the even map and the descent, single and
G = 4), the single-plane fetches (luma and
chroma, G = 4, pre-haloed on four row shards), the MC of one P frame step
with its intra mask at formats 1 and 4 (single, G = 4, four row shards:
dispatch.mc_predict(_pre_haloed) where the checkout has it, with and
without making the chroma parity stacks, else composed as the engine
composed it: a fetch per plane or parity plane, the select, the masks)
beside one torch.take of its flat indices; code_plane at qp 28 on the
luma and chroma planes and on G = 4 luma planes, flat and under the
quant matrix; block_pack of the luma levels at 16 words in both
syntaxes; the SEA search (TVC_SEA=1) on phase 3's three references
(clean, recon, noise; single, G = 4, four row shards against the recon),
each beside the exhaustive search on the same planes in the same turn;
span_merge_mb and span_merge on the real 1080p frame's sources and on
dense pieces, and chunk_merge on the real frame's pieces at 24 words and
on dense ones, each with its device ops per call (kernels); the frame
emit's whole pack of the real frame, alone and for G = 4 frames; one G = 4
lockstep GOP of 30 1080p frames of the full cell under each emit: the
eager batch's peak allocated memory and download bytes per GOP, and the
batch's time through its graph and eager (each checkout takes its own
word dtype: its pack makes the pieces, dense pieces take the dtype of
its words, and a result's sum takes each element's low 32 bits); then one
traced 10-frame GOP of the full-search, config-3 and format-4 cells (device ops per frame, the GOP's device time, the motion
kernels' device time), and the format-4 I frame on its own (code_plane launches, device
ops, device ms, wall ms). Each timing has the call time
(time_ms), the device time (device_ms) and the host time (host_ms). Every
turn prints one JSON line, the last line is each ROOT's means beside the
card; it exits 1 if a result differs between ROOTs.

Run with no arguments, its last lines of standard output are the card's
name and power limit, the kernel table (one entry per launch counter,
each with the row of PERF.md's table it ports; all sixteen rows; the
single-plane fetches launch on no path, the predictor in their place; the
decoders' two recon entries as rows 11d and 11dr) and
{"ok": true, "device": {...}}. Builds go to build/ (gitignored).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
# Published peaks of one H100 SXM at its full power limit: device memory
# rate, and int32 operations outside the tensor cores. The SM has 64 int32
# lanes against 128 fp32 lanes, so the int32 rate is half the fp32 rate of
# 67 TFLOP/s; a multiply-add or an abs-diff-accumulate counts 2 operations.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
# int32 operations per MB of the even SAD map: 289 candidates x 256
# abs-diff-accumulates of 2 operations, four of them in one vabsdiff4 on
# words of four 8-bit samples (a kernel of one __sad per pixel pair does
# 4x this)
EVEN_MAP_OPS = 289 * 256 * 2 // 4
# the main paths' plane shapes: 1080p (padded to 1088 rows) and 640x360
# (padded to 368, an odd 23-row MB grid)
LUMA = [(1088, 1920), (368, 640)]
CHROMA = [(544, 960), (184, 320)]
PSNR_FLOOR = 30.0   # dB, luma, of every path's decoded stream
# the row of PERF.md's kernel table (the reference's TPU kernels, each
# function that reaches pl.pallas_call) that each launch counter ports
TABLE_ROW = {
    "full_search": "1", "full_search_haloed": "2", "full_search_sea": "3",
    "full_search_sea_g": "3", "full_search_sea_haloed": "3",
    "full_search_g": "4", "sad_map": "5", "sad_map_even": "5",
    "sad_map_g": "6", "sad_map_even_g": "6", "mc_fetch_luma": "7",
    "mc_fetch_chroma": "7", "sad_at_mv": "8", "sad_at_mv_chroma": "8c",
    "sad_at_mv_haloed": "8h", "mc_fetch_luma_g": "9m",
    "mc_fetch_chroma_g": "9m", "sad_at_mv_g": "9s", "sad_at_mv_chroma_g": "9s",
    "mc_fetch_haloed_luma": "10", "mc_fetch_haloed_chroma": "10",
    "code_plane": "11", "code_plane_qmat": "11q", "code_plane_g": "12",
    "code_plane_qmat_g": "12", "block_pack": "13", "block_pack_v2": "13v",
    "chunk_merge": "14", "span_merge": "15", "span_merge_mb": "16",
    "mc_predict": "7", "mc_predict_g": "9m", "mc_predict_haloed": "10",
    "code_plane_rows": "11r", "code_plane_rows_g": "12r",
    # the diamond descent: no Pallas counterpart (the reference's jnp loop)
    "diamond_descent": "8d", "diamond_descent_g": "8d",
    # the decoders' recon: entries of row 11's kernel, no Pallas counterpart
    "recon_plane": "11d", "recon_plane_rows": "11dr",
    # the frame pack's tail: no Pallas counterpart (the reference's jnp
    # headers and tree_concat)
    "frame_headers": "17", "frame_place": "17", "frame_mb_bits": "17"}
# the single-plane fetches: held and timed in phase 3, launched by no
# encode path (a P step's three predictors are one mc_predict launch)
SINGLE_FETCHES = ("mc_fetch_luma", "mc_fetch_chroma", "mc_fetch_luma_g",
                  "mc_fetch_chroma_g", "mc_fetch_haloed_luma",
                  "mc_fetch_haloed_chroma")
ORACLE_SRC = os.path.join(ROOT, "oracle", "oracle.cpp")
ORACLE_BIN = os.path.join(ROOT, "build", "oracle", "oracle")


def log(msg: str) -> None:
    print(msg, flush=True)


def mem() -> str:
    """The caching allocator's reserved and peak allocated device memory."""
    return (f"reserved {torch.cuda.memory_reserved() / 2**20:.0f} MiB, peak "
            f"allocated {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def texture(rng, h: int, w: int, passes: int = 2, scale: int = 1) -> np.ndarray:
    """Smoothed random texture [h + 128, w + 128] int32 in [0, 255]. With
    scale > 1 the random field is made at 1/scale of the size and repeated
    up, so the texture is band-limited as camera content is: most of its
    energy sits in the low frequencies the quant matrix keeps."""
    hs, ws = -(-(h + 128) // scale), -(-(w + 128) // scale)
    base = rng.integers(0, 256, (hs, ws)).astype(np.int32)
    if scale > 1:
        base = np.kron(base, np.ones((scale, scale), np.int32))[:h + 128, :w + 128]
    for _ in range(passes):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
                + np.roll(base, 2, 0) + np.roll(base, 2, 1)) // 5
    return base


def synth_clip(t: int, h: int, w: int, seed: int, passes: int = 2,
               scale: int = 1):
    """Panning texture, a moving random patch, mild noise; flat chroma.
    More smoothing passes (contrast stretched back to 0-255) give the
    larger-scale texture that a diamond descent can follow: on the
    two-pass texture it stalls in a local minimum for about a third of
    the MBs."""
    rng = np.random.default_rng(seed)
    base = texture(rng, h, w, passes, scale)
    if passes > 2:
        base = (base - base.min()) * 255 // max(int(np.ptp(base)), 1)
    ys, cbs, crs = [], [], []
    for k in range(t):
        y = base[2 * k: 2 * k + h, 3 * k: 3 * k + w] + rng.integers(-2, 3, (h, w))
        px, py = (200 + 11 * k) % max(w - 64, 1), (300 + 7 * k) % max(h - 64, 1)
        y[py: py + 64, px: px + 64] = rng.integers(0, 256, (64, 64))
        ys.append(np.clip(y, 0, 255).astype(np.uint8))
        cbs.append(np.full((h // 2, w // 2), 108 + k, np.uint8))
        crs.append(np.full((h // 2, w // 2), 148, np.uint8))
    return ys, cbs, crs


def synth_clip_halfpel(t: int, h: int, w: int, seed: int, passes: int = 2,
                       scale: int = 1):
    """A clip with true half-pel motion: the texture is made at twice the
    size and each frame is its 2x2 means at an offset that grows by (1, 3)
    double-resolution pixels per frame, a pan of (+0.5, +1.5) px. A moving
    random patch and mild noise as in synth_clip; chroma is textured and
    pans with the luma (4x4 means of a second texture)."""
    rng = np.random.default_rng(seed)
    big = texture(rng, 2 * h, 2 * w, passes, scale)
    big = (big - big.min()) * 255 // max(int(np.ptp(big)), 1)
    cbig = texture(rng, 2 * h, 2 * w, passes, scale)
    ys, cbs, crs = [], [], []
    for k in range(t):
        oy, ox = k, 3 * k
        win = big[oy: oy + 2 * h, ox: ox + 2 * w]
        y = (win[0::2, 0::2] + win[0::2, 1::2] + win[1::2, 0::2]
             + win[1::2, 1::2] + 2) // 4 + rng.integers(-2, 3, (h, w))
        px, py = (200 + 11 * k) % max(w - 64, 1), (300 + 7 * k) % max(h - 64, 1)
        y[py: py + 64, px: px + 64] = rng.integers(0, 256, (64, 64))
        c = cbig[oy: oy + 2 * h, ox: ox + 2 * w].reshape(
            h // 2, 4, w // 2, 4).sum((1, 3)) // 16
        ys.append(np.clip(y, 0, 255).astype(np.uint8))
        cbs.append((96 + c // 4).astype(np.uint8))
        crs.append((160 - c // 4).astype(np.uint8))
    return ys, cbs, crs


def bound(inputs, outputs, ops: float, extra_bytes: int = 0):
    """(bound_ms, bound_by): the least time the card could take for a
    function that reads each input tensor once, writes each output once,
    moves `extra_bytes` more and does `ops` int32 operations. The packed
    strings of block_pack and the span merges are int32 words: 4 bytes a
    word."""
    nbytes = extra_bytes + sum(t.numel() * t.element_size()
                               for t in (*inputs, *outputs))
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / INT32_OPS_PER_S
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def time_ms(fn, budget_s: float = 0.5) -> float:
    """Mean device time of fn() in ms over a run of calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    iters = int(min(50, max(3, budget_s / max(time.perf_counter() - t0, 1e-6))))
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def paired_ms(fa, fb, reps: int = 5):
    """(ms_a, ms_b): the medians of `reps` time_ms runs of fa and of fb,
    taken in turns. Below ~0.05 ms a call time is the host's, whose rate
    drifts within a run, so two such calls are compared over the same
    stretch of it."""
    a, b = [], []
    for _ in range(reps):
        a.append(time_ms(fa))
        b.append(time_ms(fb))
    return float(np.median(a)), float(np.median(b))


def device_ms(fn, n: int = 20, per_call=1, rounds: int = 10):
    """(ms, kernels): fn()'s device time per call, its kernels' own
    durations summed as device_ops reads them from torch.profiler, and
    the device kernels it launches per call, over n calls after a
    warm-up. Below ~0.05 ms time_ms reads the host's launch rate; this
    reads the device. A trace can miss some of a window's kernels (one
    in this script's first calls kept 2 of 20), so a window counts only
    when it holds every kernel of its n calls: n * per_call of them, or,
    where per_call is None (a composition whose count is not known
    here), a multiple of n that two windows agree on with no window
    holding more. After a window of thousands of kernels, the next ones
    lost their first kernel in every window on an H100, so each window
    starts with a kernel of its own (torch.cuda._sleep's spin_kernel),
    left out of the count. Raises if none of `rounds` windows does."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(rounds):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "spin_kernel" not in e.name]
        k = len(dev)
        counts.append(k)
        if (k == n * per_call if per_call is not None else
                k and k % n == 0 and k == max(counts) and counts.count(k) > 1):
            return sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n, k / n
    raise AssertionError(
        f"device_ms: no trace held every kernel of {n} calls (kernels per "
        f"window {counts}, wanted {n * per_call if per_call else 'two equal'})")


def host_ms(fn, n: int = 100) -> float:
    """fn()'s host time per call in ms: time.perf_counter over n calls
    with no sync between them (what the wrapper costs the host; the
    device may still be running when the clock stops)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / n


def max_abs_err(got, want) -> int:
    """Largest |got - want| over matching output tensors; raises unless
    they are equal (same dtype and shape, every element)."""
    err = 0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"dtype/shape {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        err = max(err, int((g.long() - w.long()).abs().max()) if g.numel() else 0)
    if err:
        raise AssertionError(f"kernel differs from its plain version: "
                             f"max |err| = {err}")
    return err


def both(fn, *args):
    """fn(*args) through the kernels, then with every wrapper forced to its
    plain version: (got, want)."""
    from video_encoder_tpu_torch.ops import dispatch

    dispatch.force(None)
    got = fn(*args)
    dispatch.force("plain")
    want = fn(*args)
    dispatch.force(None)
    torch.cuda.synchronize()
    return got, want


def timed(fn, *args):
    """(ms, plain_ms): time_ms of fn(*args) through the kernels and forced
    to the plain versions."""
    from video_encoder_tpu_torch.ops import dispatch

    dispatch.force(None)
    ms = time_ms(lambda: fn(*args))
    dispatch.force("plain")
    plain_ms = time_ms(lambda: fn(*args))
    dispatch.force(None)
    return ms, plain_ms


def tensors(x):
    """The tensors of a result or argument list, in order."""
    return [t for t in (x if isinstance(x, (tuple, list)) else [x])
            if isinstance(t, torch.Tensor)]


class KernelTable:
    """The kernels line: one row per launch counter, with the largest error
    against the plain version, the timing at the kernel's first launch
    shape on the main paths and, in the row's "also" list, at further
    shapes."""

    def __init__(self, card: str):
        self.card = card
        self.rows = {}

    def record(self, name, src, replaces, err, timing=None, also=None, **extra):
        """timing: (ms, plain_ms, (bound_ms, bound_by), library_ms); also:
        (shape name, timing), the library call left out. extra: further
        fields of the also entry where there is one, else of the row."""
        row = self.rows.setdefault(name, dict(
            name=name, row=TABLE_ROW[name], route="cuda",
            source=f"video_encoder_tpu_torch/csrc/{src}",
            replaces=replaces, launches=0, max_abs_err=0, ms=None,
            plain_ms=None, bound_ms=None, bound_by=None, library_ms=None))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if timing is not None:
            ms, plain_ms, (bound_ms, bound_by), library_ms = timing
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms)
        if also is None:
            row.update(extra)
        else:
            shape, (ms, plain_ms, (bound_ms, bound_by), _) = also
            row.setdefault("also", []).append(dict(
                shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, **extra))

    def shown(self, timing, dh=None):
        """The timing (and dev_host's fields) as the log line's tail,
        beside the card."""
        if timing is None:
            return ""
        ms, plain_ms, (bound_ms, bound_by), library_ms = timing
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        dev = "" if not dh else (
            f" (device {dh['device_ms']:.4f} ms in {dh['device_kernels']:g} "
            f"kernels, host {dh['host_ms']:.4f} ms)")
        return (f", {ms:.4f} ms{dev} vs plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms by {bound_by}, library call {lib} "
                f"[{self.card}]")


# a frame's shards as one batch: four row shards, or a 2 x 2 tile grid in
# row-major order, each with its halo-extended reference as the tile
# path's exchange makes it
def rows_of(p):                # [.., H, W] -> [4, .., H / 4, W]
    return torch.stack(p.chunk(4, -2)).contiguous()


def unrows(t):
    return torch.cat(list(t), -2)


def grid_of(p):                # [.., H, W] -> [4, .., H / 2, W / 2]
    return torch.stack([q for half in p.chunk(2, -2)
                        for q in half.chunk(2, -1)]).contiguous()


def ungrid(t):
    return torch.cat([torch.cat([t[0], t[1]], -1),
                      torch.cat([t[2], t[3]], -1)], -2)


def ext_rows(p, halo):         # [H, W] -> [4, H / 4 + 2 halo, W]
    from video_encoder_tpu_torch.parallel import tiles

    return tiles.exchange_halo(rows_of(p), halo).contiguous()


def ext_grid(p, halo):         # [H, W] -> [4, H / 2 + 2 halo, W / 2 + 2 halo]
    from video_encoder_tpu_torch.parallel import tiles

    return tiles.exchange_halo_2d(grid_of(p).unflatten(0, (2, 2)), halo
                                  ).flatten(0, 1).contiguous()


def halo_windows(stack, r, sr, sc):
    """The tiles of a reference stack [P, H, W] as the tile path has them,
    [Sr * Sc, P, h + 2r, w (+ 2r where Sc > 1)], row-major as rows_of and
    grid_of: windows of pad_ref of the whole stack (format 4: parity
    first, then the pad)."""
    from video_encoder_tpu_torch.ops import motion

    _, hh, ww = stack.shape
    h, w = hh // sr, ww // sc
    pad = motion.pad_ref(stack, r)
    cw, c0 = (w + 2 * r, 0) if sc > 1 else (w, r)
    return torch.stack([pad[:, i * h:i * h + h + 2 * r, c0 + j * w:c0 + j * w + cw]
                        for i in range(sr) for j in range(sc)]).contiguous()


def take_of(refs, dy, dx, inter):
    """(src, idx) with torch.take(src, idx) the MC predictor of a P step,
    the library yardstick of the predictor kernel: the three reference
    stacks [.., P, rh, rw] flattened into one source with a trailing 128,
    and the flat index of every predictor pixel (luma, then cb, then cr;
    128 for an intra MB), made outside the timed call. P = 4 stacks are
    parity planes and the vectors half-pels."""
    srcs, idxs, base = [], [], 0
    for k, (s, bs) in enumerate(zip(refs, (16, 8, 8))):
        *lead, p, rh, rw = s.shape
        vy, vx = (dy, dx) if k == 0 else (dy >> 1, dx >> 1)
        code = torch.zeros_like(vy)
        if p == 4:
            code = (vy & 1) * 2 + (vx & 1)
            vy, vx = vy >> 1, vx >> 1
        ph, pw = vy.shape[-2] * bs, vy.shape[-1] * bs
        oy, ox = (rh - ph) // 2, (rw - pw) // 2
        px = [t.repeat_interleave(bs, -2).repeat_interleave(bs, -1).long()
              for t in (vy, vx, code)]
        sy = (torch.arange(ph, device=s.device)[:, None] + px[0] + oy).clamp(0, rh - 1)
        sx = (torch.arange(pw, device=s.device)[None, :] + px[1] + ox).clamp(0, rw - 1)
        b = (torch.arange(lead[0], device=s.device).reshape(-1, 1, 1) if lead
             else 0)
        m = inter.repeat_interleave(bs, -2).repeat_interleave(bs, -1)
        idxs.append(torch.where(m, base + ((b * p + px[2]) * rh + sy) * rw + sx,
                                -1))
        srcs.append(s.reshape(-1))
        base += s.numel()
    src = torch.cat([*srcs, torch.full((1,), 128, dtype=torch.int32,
                                       device=srcs[0].device)])
    idx = torch.cat([i.reshape(-1) for i in idxs])
    return src, torch.where(idx < 0, base, idx)


def predict_bound(got, dy, dx, inter):
    """bound() of the MC predictor: each inter MB reads its 256 luma and
    2 x 64 chroma pixels of the selected plane once (an intra MB reads
    none), the vectors and modes are read once, the three planes written
    once."""
    nbytes = int(inter.sum()) * (256 + 2 * 64) * 4 + sum(
        t.numel() * t.element_size() for t in (dy, dx, inter, *got))
    return 1e3 * nbytes / HBM_BYTES_PER_S, "bytes"


def descent_walks(meven):
    """(steps, visited, dy, dx) of the diamond descent (SPEC.md §9) over
    the even map meven [..., 289], in numpy: the large steps each MB's
    walk takes to its first frozen step, the distinct map entries inside
    ±16 that the walks read (a start and each candidate once: what a
    kernel reading only the entries it needs takes from the map), and
    each walk's last vector, before the final ±1 step."""
    from video_encoder_tpu_torch.codec import spec
    from video_encoder_tpu_torch.ops import motion

    r, ne = motion.R, motion.NE
    rows = meven.reshape(-1, ne * ne).cpu().numpy().astype(np.int64)
    n = len(rows)
    mb = np.arange(n)
    seen = np.zeros(rows.shape, bool)
    dy, dx, steps = (np.zeros(n, np.int64) for _ in range(3))

    def at(y, x):
        return ((np.clip(y, -r, r) + r) >> 1) * ne + ((np.clip(x, -r, r) + r) >> 1)

    seen[mb, at(dy, dx)] = True
    cost = rows[mb, at(dy, dx)]
    live = cost >= spec.DIAMOND_EARLY_SAD
    for _ in range(spec.DIAMOND_MAX_STEPS):
        steps += live
        best, by, bx = cost.copy(), dy.copy(), dx.copy()
        for uy, ux in ((-2, 0), (0, -2), (0, 2), (2, 0)):
            ny, nx = dy + uy, dx + ux
            ok = live & (np.abs(ny) <= r) & (np.abs(nx) <= r)
            k = at(ny, nx)
            seen[mb[ok], k[ok]] = True
            win = np.where(ok, rows[mb, k], motion.BIG) < best
            best = np.where(win, rows[mb, k], best)
            by, bx = np.where(win, ny, by), np.where(win, nx, bx)
        moved = (by != dy) | (bx != dx)
        dy, dx, cost = by, bx, best
        live &= moved & (cost >= spec.DIAMOND_EARLY_SAD)
    return steps, int(seen.sum()), dy, dx


def descent_before_kernel(cur, ref, meven):
    """The descent as the port ran it before its kernel: the plain walk
    over the map (motion.diamond_descent's gathers) with the final step's
    four SADs in one sad_at_mv launch (row 8)."""
    from video_encoder_tpu_torch.ops import dispatch, motion

    def sad_even(dy, dx):
        k = (((dy + motion.R) >> 1) * motion.NE + ((dx + motion.R) >> 1)).long()
        if k.ndim < meven.ndim:
            return torch.gather(meven, -1, k[..., None])[..., 0]
        return torch.gather(meven, -1, k.movedim(-3, -1)).movedim(-1, -3)

    return motion.diamond_search_with(
        cur, sad_even, lambda dy, dx: dispatch.sad_at_mv(cur, ref, dy, dx))


def dev_host(fn, per_call=1):
    """device_ms and host_ms of fn() as a row's fields; per_call: the
    device kernels fn() launches, None where a wrapper may add a memset
    or a copy (device_ms then takes two windows that agree)."""
    ms, kernels = device_ms(fn, per_call=per_call)
    return dict(device_ms=ms, device_kernels=kernels, host_ms=host_ms(fn))


def ptxas_summary(log_text: str):
    """[(kernel, registers, spill store bytes, spill load bytes)] from
    nvcc -Xptxas -v output: each 'Compiling entry function' line is
    followed by its spill and register lines."""
    import re

    rows, name, spill = [], None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spill))
            name, spill = None, (0, 0)
    return rows


def phase_kernels(dev, card: str):
    """Each kernel against its plain version, exact; returns the table."""
    from video_encoder_tpu_torch.codec import entropy, tables
    from video_encoder_tpu_torch.ops import dispatch
    from video_encoder_tpu_torch.pipeline.gop_engine import block_words_for_qp

    rng = np.random.default_rng(7)

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    table = KernelTable(card)
    record, shown = table.record, table.shown
    luma, chroma = LUMA, CHROMA

    # full search: a pan that puts the best match at the (+16, -16) corner,
    # and a flat region where all 1089 candidates tie
    for h, w in luma:
        tex = texture(rng, h, w)
        cur = tex[64:64 + h, 64:64 + w].copy()
        ref = tex[48:48 + h, 80:80 + w] + rng.integers(-3, 4, (h, w))
        cur[:128, :256] = 100
        ref[:160, :288] = 100
        cur_t, ref_t = t32(cur), t32(np.clip(ref, 0, 255))
        got, want = both(dispatch.full_search, cur_t, ref_t)
        err = max_abs_err(got, want)
        corner = int(((got[0] == 16) & (got[1] == -16)).sum())
        timing, extra = None, {}
        if (h, w) == luma[0]:
            n_mbs = (h // 16) * (w // 16)
            timing = (*timed(dispatch.full_search, cur_t, ref_t),
                      bound([cur_t, ref_t], got, n_mbs * 1089 * 256 * 2), None)
            extra = dev_host(lambda: dispatch.full_search(cur_t, ref_t))
        record("full_search", "full_search.cu",
               "video_encoder_tpu/ops/pallas/sad.py:68", err, timing, **extra)
        log(f"kernel full_search {h}x{w}: equal, {corner} MBs at mv (16,-16)"
            + shown(timing, extra))

    # MC fetch: random mvs over the whole range, corners forced to the
    # edges. Its library call is one torch.take over flat indices made
    # outside the timed call.
    for (h, w), (ch, cw) in zip(luma, chroma):
        for name, (ph, pw), bs, fn in (
                ("mc_fetch_luma", (h, w), 16, dispatch.mc_fetch_luma_plane),
                ("mc_fetch_chroma", (ch, cw), 8, dispatch.mc_fetch_chroma_plane)):
            ref_t = t32(rng.integers(0, 256, (ph, pw)))
            nby, nbx = ph // bs, pw // bs
            dy = rng.integers(-bs, bs + 1, (nby, nbx))
            dx = rng.integers(-bs, bs + 1, (nby, nbx))
            for yy, xx, sy, sx in ((0, 0, -1, -1), (0, -1, -1, 1),
                                   (-1, 0, 1, -1), (-1, -1, 1, 1)):
                dy[yy, xx], dx[yy, xx] = sy * bs, sx * bs
            args = (ref_t, t32(dy), t32(dx))
            got, want = both(fn, *args)
            err = max_abs_err([got], [want])
            timing, extra = None, {}
            if (ph, pw) in (luma[0], chroma[0]):
                rows_i = (torch.arange(ph, device=dev)[:, None]
                          + args[1].repeat_interleave(bs, 0).repeat_interleave(bs, 1)
                          ).clamp(0, ph - 1)
                cols_i = (torch.arange(pw, device=dev)[None, :]
                          + args[2].repeat_interleave(bs, 0).repeat_interleave(bs, 1)
                          ).clamp(0, pw - 1)
                flat = (rows_i * pw + cols_i).long()
                max_abs_err([torch.take(ref_t, flat)], [want])
                timing = (*timed(fn, *args), bound(args, [got], 0),
                          time_ms(lambda: torch.take(ref_t, flat)))
                extra = dev_host(lambda: fn(*args))
            record(name, "mc_fetch.cu",
                   "video_encoder_tpu/ops/pallas/sad.py:724", err, timing,
                   **extra)
            log(f"kernel {name} {ph}x{pw}: equal" + shown(timing, extra))

    # code_plane: per-block qp mixing 1, 28 and 63; midpoint and deadzone
    # bias; flat steps and the v3 quant matrix; block_pack in both
    # syntaxes on the levels it produces (qp 1 overflows 16 words). Timed
    # at qp 28 on the 1080p luma plane and, as an also entry, on chroma.
    pack_levels = {}
    q28_step = int(tables.load(dev).QSTEP[28])
    for h, w in [luma[0], chroma[0], luma[1]]:
        tex = texture(rng, h, w)
        cur_t = t32(tex[:h, :w])
        pred_t = t32(np.clip(tex[3:3 + h, 5:5 + w] + rng.integers(-20, 21, (h, w)), 0, 255))
        qp = rng.choice([1, 28, 63], (h // 8, w // 8))
        q_blk = tables.load(dev).QSTEP[t32(qp).long()].contiguous()
        for qmat, name in ((False, "code_plane"), (True, "code_plane_qmat")):
            for qbias in (8, 5):
                got, want = both(dispatch.code_plane, cur_t, pred_t, q_blk,
                                 qbias, qmat)
                err = max_abs_err(got, want)
                timing, dh = None, {}
                if (h, w) in (luma[0], chroma[0]) and qbias == 8:
                    q28 = torch.full_like(q_blk, q28_step)
                    a28 = (cur_t, pred_t, q28, 8, qmat)
                    # per pixel: four 8-point passes of multiply-adds, the
                    # quantizer's multiply, divide and dequantize, roundings
                    timing = (*timed(dispatch.code_plane, *a28),
                              bound([cur_t, pred_t, q28], got, h * w * (4 * 16 + 10)),
                              None)
                    dh = dev_host(lambda: dispatch.code_plane(*a28))
                    if (h, w) == luma[0]:
                        pack_levels[qmat] = dispatch.code_plane(*a28)[0]
                if (h, w) == chroma[0] and timing:
                    record(name, "code_plane.cu",
                           "video_encoder_tpu/ops/pallas/codec.py:96", err,
                           also=(f"{h}x{w}", timing), **dh)
                else:
                    record(name, "code_plane.cu",
                           "video_encoder_tpu/ops/pallas/codec.py:96", err,
                           timing, **dh)
                log(f"kernel {name} {h}x{w} qbias {qbias}: equal"
                    + shown(timing, dh))
                for fmt, pname in ((1, "block_pack"), (2, "block_pack_v2")):
                    dc_pred = (entropy._dc_pred_left(got[0]).reshape(-1).contiguous()
                               if fmt >= 2 else None)
                    for n_words in (16, entropy.BLOCK_WORDS_MAX):
                        lv = got[0].reshape(-1, 64)
                        gp, wp = both(dispatch.block_pack, lv, n_words, dc_pred, fmt)
                        err = max_abs_err(gp, wp)
                        over = int((gp[1] > 32 * n_words).sum())
                        record(pname, "block_pack.cu",
                               "video_encoder_tpu/ops/pallas/entropy_pack.py:116", err)
                        log(f"kernel {pname} {lv.shape[0]} blocks, {n_words} "
                            f"words: equal, {over} blocks overflow")

    # the I-frame row scan of formats 3 and 4 (code_plane_rows): a whole
    # plane in one launch against the plain loop of [8, W] stripes; the
    # luma and chroma planes of 1080p and 640x360, flat and under the
    # quant matrix, without intra slices and with slices of 17 MB rows
    # (34 luma block rows, 17 chroma); timed at qp 28 without slices, as
    # the format-4 I frame codes its planes. It is an entry of the
    # code_plane kernel; the reference scans the stripes in jnp
    # (video_encoder_tpu/ops/transform.py:112), with no Pallas kernel
    for (h, w), reset in ((luma[0], 34), (chroma[0], 17), (luma[1], 34),
                          (chroma[1], 17)):
        base = texture(rng, h + 1, w)
        cur_t = t32((base[:h, :w] + base[1:h + 1, :w]) // 2)
        qp = rng.choice([1, 28, 63], (h // 8, w // 8))
        q_blk = tables.load(dev).QSTEP[t32(qp).long()].contiguous()
        q28 = torch.full_like(q_blk, q28_step)
        for qmat in (False, True):
            for rr in (0, reset):
                got, want = both(dispatch.intra_rows_code_plane, cur_t, q_blk,
                                 6, rr, qmat)
                err = max_abs_err(got, want)
                timing, dh = None, {}
                if (h, w) in (luma[0], chroma[0]) and rr == 0:
                    a28 = (cur_t, q28, 8, 0, qmat)
                    got = dispatch.intra_rows_code_plane(*a28)
                    timing = (*timed(dispatch.intra_rows_code_plane, *a28),
                              bound([cur_t, q28], got, h * w * (4 * 16 + 10)),
                              None)
                    dh = dev_host(lambda: dispatch.intra_rows_code_plane(*a28))
                shape = f"{h}x{w}" + (" qmat" if qmat else "")
                if timing and (h, w) == luma[0] and not qmat:
                    record("code_plane_rows", "code_plane.cu",
                           "video_encoder_tpu/ops/pallas/codec.py:96", err,
                           timing, **dh)
                elif timing:
                    record("code_plane_rows", "code_plane.cu",
                           "video_encoder_tpu/ops/pallas/codec.py:96", err,
                           also=(shape, timing), **dh)
                else:
                    record("code_plane_rows", "code_plane.cu",
                           "video_encoder_tpu/ops/pallas/codec.py:96", err)
                log(f"kernel code_plane_rows {shape} reset_rows {rr}: equal"
                    + shown(timing, dh))

    # dense random levels at the quantizer's extremes: every block
    # overflows; in the format-2 syntax a row of DCs alternating +-3925
    # codes dc - pred = +-7850, the longest code (27 bits)
    lv = rng.integers(-3925, 3926, (64, 64, 64))
    lv[1, :, 1:] = 0
    lv[1, 0::2, 0], lv[1, 1::2, 0] = 3925, -3925
    lv = t32(lv)
    bw = block_words_for_qp(28)
    for fmt, pname, levels in ((1, "block_pack", pack_levels[False]),
                               (2, "block_pack_v2", pack_levels[True])):
        dc_pred = (entropy._dc_pred_left(lv).reshape(-1).contiguous()
                   if fmt >= 2 else None)
        gp, wp = both(dispatch.block_pack, lv.reshape(-1, 64), 16, dc_pred, fmt)
        max_abs_err(gp, wp)
        if gp[0].dtype != torch.int32:
            raise AssertionError(f"{pname}: words are {gp[0].dtype}, not int32")
        bits = gp[1].reshape(64, 64)
        if not bool((bits[0] > 512).all() and (bits[2:] > 512).all()):
            raise AssertionError("dense blocks should overflow 16 words")
        if fmt >= 2 and int(bits[1, 1:].max()) != 1 + 27 + 1:
            raise AssertionError("se(+-7850) should take 27 bits")
        flat = levels.reshape(-1, 64)
        dc_pred = (entropy._dc_pred_left(levels).reshape(-1).contiguous()
                   if fmt >= 2 else None)
        got = dispatch.block_pack(flat, bw, dc_pred, fmt)
        # per block: 64 zero tests, then ~10 operations per nonzero level
        ops = flat.shape[0] * 64 + 10 * int((flat != 0).sum())
        timing = (*timed(dispatch.block_pack, flat, bw, dc_pred, fmt),
                  bound(tensors([flat, dc_pred]), got, ops), None)
        dh = dev_host(lambda: dispatch.block_pack(flat, bw, dc_pred, fmt))
        record(pname, "block_pack.cu",
               "video_encoder_tpu/ops/pallas/entropy_pack.py:116", 0, timing,
               **dh)
        log(f"kernel {pname} dense overflow: equal; 1080p luma qp 28, {bw} "
            f"words" + shown(timing, dh))

    # sad_map_even: the full-search pan (best even mv on the (+16, -16)
    # corner) and a flat region where all 289 candidates tie
    seen = [0, 0]
    for h, w in luma:
        tex = texture(rng, h, w)
        cur = tex[64:64 + h, 64:64 + w].copy()
        ref = tex[48:48 + h, 80:80 + w] + rng.integers(-3, 4, (h, w))
        cur[:128, :256] = 100
        ref[:160, :288] = 100
        cur_t, ref_t = t32(cur), t32(np.clip(ref, 0, 255))
        got, want = both(dispatch.sad_map_even, cur_t, ref_t)
        err = max_abs_err([got], [want])
        best = got.argmin(-1)
        corner = int((best == 16 * 17).sum())          # (dy, dx) = (16, -16)
        ties = int((got == got[..., :1]).all(-1).sum())
        timing = None
        if (h, w) == luma[0]:
            n_mbs = (h // 16) * (w // 16)
            timing = (*timed(dispatch.sad_map_even, cur_t, ref_t),
                      bound([cur_t, ref_t], [got], EVEN_MAP_OPS * n_mbs), None)
            dh = dev_host(lambda: dispatch.sad_map_even(cur_t, ref_t), None)
        record("sad_map_even", "full_search.cu",
               "video_encoder_tpu/ops/pallas/sad.py:594", err, timing,
               **(dh if timing else {}))
        log(f"kernel sad_map_even {h}x{w}: equal, {corner} MBs best at "
            f"(16,-16), {ties} MBs with all 289 tied"
            + shown(timing, dh if timing else None))
        seen = [seen[0] + corner, seen[1] + ties]
    if not all(seen):
        raise AssertionError("sad_map_even: edge or tie case not exercised")

    # sad_at_mv (16x16 luma MBs) and its chroma twin (8x8 blocks): K = 4
    # candidates over the whole range, corners forced
    for name, planes, bs, fn in (
            ("sad_at_mv", luma, 16, dispatch.sad_at_mv),
            ("sad_at_mv_chroma", chroma, 8, dispatch.sad_at_mv_chroma)):
        for h, w in planes:
            cur_t = t32(rng.integers(0, 256, (h, w)))
            ref_t = t32(rng.integers(0, 256, (h, w)))
            dy = rng.integers(-bs, bs + 1, (4, h // bs, w // bs))
            dx = rng.integers(-bs, bs + 1, (4, h // bs, w // bs))
            for k, (sy, sx) in enumerate(((-1, -1), (-1, 1), (1, -1), (1, 1))):
                dy[k, 0, 0], dx[k, 0, 0] = bs * sy, bs * sx
                dy[k, -1, -1], dx[k, -1, -1] = -bs * sy, -bs * sx
            args = (cur_t, ref_t, t32(dy), t32(dx))
            got, want = both(fn, *args)
            err = max_abs_err([got], [want])
            timing, dh = None, {}
            if (h, w) == planes[0]:
                timing = (*timed(fn, *args),
                          bound(args, [got], dy.size * bs * bs * 2), None)
                dh = dev_host(lambda: fn(*args), None)
            record(name, "sad_at.cu",
                   "video_encoder_tpu/ops/pallas/sad.py:852", err, timing, **dh)
            log(f"kernel {name} {h}x{w} K=4: equal" + shown(timing, dh))

    # the diamond descent: the walk and the final +-1 step of every MB in
    # one launch, through dispatch.diamond_search (the even map, then the
    # descent) against its plain route, exact: panned planes (walks of a
    # few steps), corner-bound ones (walks along the window's edge to its
    # corner, final steps meeting candidates outside +-16, the frame's
    # edges read through the clamp) and random ones. Timed on the panned
    # planes, the kernel alone over the map, beside the plain descent and
    # the route before the kernel; its bound: cur and the reference once,
    # the map entries the walks read, the outputs, and the final step's
    # four 256-pixel SADs of 2 operations a pixel
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from diamond_cases import planes as diamond_planes
    from video_encoder_tpu_torch.ops import motion
    from video_encoder_tpu_torch.ops.kernels import sad as ksad

    def descent_timing(cur_t, ref_t, got, visited):
        """The kernel's timing over the map of cur_t against ref_t, and
        dev_host's fields with the route before the kernel beside it."""
        args = (cur_t, ref_t, dispatch.sad_map_even(cur_t, ref_t))
        timing = (time_ms(lambda: ksad.diamond_descent(*args)),
                  time_ms(lambda: motion.diamond_descent(*args)),
                  bound(args[:2], got, got[0].numel() * 4 * 256 * 2,
                        4 * visited), None)
        dh = dev_host(lambda: ksad.diamond_descent(*args))
        ms, kernels = device_ms(lambda: descent_before_kernel(*args), n=4,
                                per_call=None)
        return timing, dh, dict(before_kernel_ms=time_ms(
            lambda: descent_before_kernel(*args)), before_kernel_device_ms=ms,
            before_kernel_device_kernels=kernels, map_entries_read=visited)

    h, w = luma[0]
    for kind in ("pan", "corner", "random"):
        cur_t, ref_t = (t32(p) for p in diamond_planes(rng, kind, (), h, w))
        got, want = both(dispatch.diamond_search, cur_t, ref_t)
        err = max_abs_err(got, want)
        steps, visited, wy, wx = descent_walks(dispatch.sad_map_even(cur_t, ref_t))
        gy, gx = (t.reshape(-1).cpu().numpy() for t in got[:2])
        if (np.abs(gy - wy) + np.abs(gx - wx)).max() > 1:
            raise AssertionError(f"diamond_descent {kind}: a vector lies more "
                                 f"than one step off its walk's end")
        corner = int(((np.abs(wy) == 16) & (np.abs(wx) == 16)).sum())
        if (kind == "corner" and not corner) or (kind == "pan" and steps.max() < 2):
            raise AssertionError(f"diamond_descent {kind}: case not exercised")
        timing, dh, extra = None, {}, {}
        if kind == "pan":
            timing, dh, extra = descent_timing(cur_t, ref_t, got, visited)
        record("diamond_descent", "diamond.cu",
               "video_encoder_tpu/ops/dispatch.py:100", err, timing, **dh,
               **extra)
        line = (f"kernel diamond_descent {h}x{w} {kind}: equal, walks of "
                f"{steps.mean():.2f} steps (most {steps.max()}), {corner} MBs "
                f"at the window's corner, {visited} map entries read")
        if extra:
            line += (f"; before the kernel (the plain walk, the final step on "
                     f"sad_at_mv) {extra['before_kernel_ms']:.4f} ms, device "
                     f"{extra['before_kernel_device_ms']:.4f} ms in "
                     f"{extra['before_kernel_device_kernels']:g} kernels")
        log(line + shown(timing, dh or None))

    # the half-pel refine's shape of sad_at_mv: nine candidates, each on
    # the parity plane of its vector, in one launch; vectors on the +-16
    # edge (candidates beyond +-32 half-pels are invalid). First the
    # wrapper itself on the refine's nine candidate planes, all
    # [9, nby, nbx] SADs held, then the whole refine.
    uv = [(u, v) for u in (-1, 0, 1) for v in (-1, 0, 1)]
    plane_of = [abs(u) * 2 + abs(v) for u, v in uv]
    for h, w in luma:
        tex = texture(rng, h, w)
        cur_t = t32(tex[64:64 + h, 64:64 + w])
        ref_t = t32(tex[63:63 + h, 66:66 + w])
        dy = rng.integers(-16, 17, (h // 16, w // 16))
        dx = rng.integers(-16, 17, (h // 16, w // 16))
        dy[0], dx[:, 0], dy[-1], dx[:, -1] = -16, -16, 16, 16
        planes4 = motion.hpel_stack(ref_t)
        iy9 = t32(np.stack([np.clip((2 * dy + u) >> 1, -16, 16) for u, _ in uv]))
        ix9 = t32(np.stack([np.clip((2 * dx + v) >> 1, -16, 16) for _, v in uv]))
        args9 = (cur_t, planes4, iy9, ix9, plane_of)
        got9, want9 = both(dispatch.sad_at_mv, *args9)
        err = max_abs_err([got9], [want9])
        also, dh = None, {}
        if (h, w) == luma[0]:
            also = (f"K=9 on 4 planes {h}x{w}", (
                *timed(dispatch.sad_at_mv, *args9),
                bound(args9[:4], [got9], iy9.numel() * 256 * 2), None))
            dh = dev_host(lambda: dispatch.sad_at_mv(*args9), None)
        record("sad_at_mv", "sad_at.cu",
               "video_encoder_tpu/ops/pallas/sad.py:852", err, also=also, **dh)
        log(f"kernel sad_at_mv {h}x{w} K=9 on 4 planes: all 9 SADs equal"
            + shown(also and also[1], dh))
        args = (cur_t, ref_t, t32(dy), t32(dx), planes4)
        got, want = both(dispatch.hpel_refine, *args)
        err = max_abs_err(got, want)
        odd = float(((got[0] & 1) | (got[1] & 1)).float().mean())
        line = (f"kernel sad_at_mv in hpel_refine {h}x{w} K=9 on 4 planes: "
                f"equal, {100 * odd:.1f} % of MBs pick a half-pel vector")
        extra = {}
        if (h, w) == luma[0]:
            ms, plain_ms = timed(dispatch.hpel_refine, *args)
            extra = dict(hpel_refine_ms=ms)
            line += (f"; the whole refine {ms:.4f} ms vs plain "
                     f"{plain_ms:.4f} ms [{card}]")
        record("sad_at_mv", "sad_at.cu",
               "video_encoder_tpu/ops/pallas/sad.py:852", err, **extra)
        log(line)

    # span merges: the pieces of real frames (1080p: two stages at 16
    # words; 320x192: one stage) and dense pieces that overflow the budget
    for name, (h, w), dense in (("1080p frame", luma[0], False),
                                ("320x192 frame", (192, 320), False),
                                ("dense pieces", (256, 128), True)):
        srcs, plan = span_sources(rng, dev, h, w, dense)
        got, want = both(dispatch.span_merge_mb, *srcs, plan.m1, plan.cw1,
                         plan.n1)
        err = max_abs_err(got, want)
        if srcs[1].dtype != torch.int32 or got[0].dtype != torch.int32:
            raise AssertionError(f"span_merge_mb {name}: words are "
                                 f"{srcs[1].dtype} in, {got[0].dtype} out")
        timing = None
        if name == "1080p frame":
            timing = (*timed(dispatch.span_merge_mb, *srcs, plan.m1, plan.cw1,
                             plan.n1),
                      merge_bound(srcs[4], mb_caps(srcs), got), None)
            dh = dev_host(lambda: dispatch.span_merge_mb(
                *srcs, plan.m1, plan.cw1, plan.n1), None)
        record("span_merge_mb", "span_merge.cu",
               "video_encoder_tpu/ops/pallas/pack.py:448", err, timing,
               **(dh if timing else {}))
        ovf = bool(got[2])
        log(f"kernel span_merge_mb {name}: {plan.n1} strings of {plan.m1} "
            f"pieces, {plan.cw1} words: equal, overflow {ovf}"
            + shown(timing, dh if timing else None))
        if ovf != dense:
            raise AssertionError(f"span_merge_mb {name}: overflow {ovf}")
        if plan.two_stage:
            args = (got[0], got[1], plan.g, plan.stop, plan.cwf)
            got2, want2 = both(dispatch.span_merge, *args)
            err = max_abs_err(got2, want2)
            timing = (*timed(dispatch.span_merge, *args),
                      merge_bound(got[1], torch.full_like(got[1], plan.cw1,
                                                          dtype=torch.long),
                                  got2), None)
            dh2 = dev_host(lambda: dispatch.span_merge(*args), None)
            record("span_merge", "span_merge.cu",
                   "video_encoder_tpu/ops/pallas/pack.py:296", err, timing,
                   **dh2)
            log(f"kernel span_merge {name}: {plan.n_strings} strings of "
                f"{plan.cwf} words: equal, overflow {bool(got2[2])}"
                + shown(timing, dh2))
    frame_tail_rows(rng, dev, record, shown)
    frame_pack_figures(rng, dev, card)

    # ---- the G-batched kernels at G = 4: each against its plain batched
    # version AND against G launches of the single-plane kernel; its bound
    # is G times the single kernel's (the same bound() on G times the
    # tensors and operations)
    g4 = 4

    def singles(fn, *args):
        """G launches of the single-plane kernel, one per GOP's slice."""
        return [fn(*(a[i] if isinstance(a, torch.Tensor) else a for a in args))
                for i in range(g4)]

    def per_g(fn, *args):
        outs = singles(fn, *args)
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(o) for o in zip(*outs))
        return torch.stack(outs)

    def held_g(name, src, replaces, shape_name, fn, args, ops, library=None,
               main=True, **extra):
        """One batched kernel at one shape: equal to plain and to G single
        launches; timed against both."""
        got, want = both(fn, *args)
        err = max_abs_err(tensors(got), tensors(want))
        max_abs_err(tensors(got), tensors(per_g(fn, *args)))
        torch.cuda.synchronize()
        ms, plain_ms = timed(fn, *args)
        singles_ms = time_ms(lambda: singles(fn, *args))
        timing = (ms, plain_ms, bound(tensors(args), tensors(got), ops),
                  None if library is None else time_ms(library))
        dh = dev_host(lambda: fn(*args))
        if main:
            record(name, src, replaces, err, timing, g=g4,
                   single_launches_ms=singles_ms, **dh, **extra)
        else:
            record(name, src, replaces, err, also=(shape_name, timing),
                   single_launches_ms=singles_ms, **dh)
        log(f"kernel {name} {shape_name}: equal to plain and to {g4} single "
            f"launches ({singles_ms:.4f} ms)" + shown(timing, dh))
        return got

    (h, w), (ch, cw) = luma[0], chroma[0]
    n_mbs = (h // 16) * (w // 16)
    cur = np.stack([texture(rng, h, w)[64:64 + h, 64:64 + w] for _ in range(g4)])
    ref = np.stack([np.roll(cur[i], (16 - 5 * i, 3 * i - 16), (0, 1))
                    for i in range(g4)]) + rng.integers(-3, 4, cur.shape)
    cur[1, :128, :256] = 100          # GOP 1: a region where all candidates tie
    ref[1, :160, :288] = 100
    cur_t, ref_t = t32(cur), t32(np.clip(ref, 0, 255))
    got = held_g("full_search_g", "full_search.cu",
                 "video_encoder_tpu/ops/pallas/sad.py:420", f"[{g4}, {h}, {w}]",
                 dispatch.full_search, (cur_t, ref_t), g4 * n_mbs * 1089 * 256 * 2)
    corner = int(((got[0][0] == 16) & (got[1][0] == -16)).sum())
    if not corner or torch.equal(got[0][0], got[0][2]):
        raise AssertionError("full_search_g: the GOPs' vectors do not differ "
                             "or GOP 0 misses its (16, -16) corner")
    held_g("sad_map_even_g", "full_search.cu",
           "video_encoder_tpu/ops/pallas/sad.py:632", f"[{g4}, {h}, {w}]",
           dispatch.sad_map_even, (cur_t, ref_t), EVEN_MAP_OPS * g4 * n_mbs)

    for name, (ph, pw), bs, fn in (
            ("mc_fetch_luma_g", (h, w), 16, dispatch.mc_fetch_luma_plane),
            ("mc_fetch_chroma_g", (ch, cw), 8, dispatch.mc_fetch_chroma_plane)):
        plane = t32(rng.integers(0, 256, (g4, ph, pw)))
        dy = rng.integers(-bs, bs + 1, (g4, ph // bs, pw // bs))
        dx = rng.integers(-bs, bs + 1, (g4, ph // bs, pw // bs))
        dy[:, 0, 0], dx[:, 0, 0], dy[:, -1, -1], dx[:, -1, -1] = -bs, -bs, bs, bs
        args = (plane, t32(dy), t32(dx))
        px = [a.repeat_interleave(bs, 1).repeat_interleave(bs, 2) for a in args[1:]]
        flat = ((torch.arange(g4, device=dev)[:, None, None] * ph
                 + (torch.arange(ph, device=dev)[None, :, None] + px[0]).clamp(0, ph - 1))
                * pw + (torch.arange(pw, device=dev)[None, None, :] + px[1]).clamp(0, pw - 1))
        got = held_g(name, "mc_fetch.cu", "video_encoder_tpu/ops/pallas/sad.py:825",
                     f"[{g4}, {ph}, {pw}]", fn, args, 0,
                     library=lambda: torch.take(plane, flat))
        max_abs_err([torch.take(plane, flat)], [got])

    for name, (ph, pw), bs, fn in (
            ("sad_at_mv_g", (h, w), 16, dispatch.sad_at_mv),
            ("sad_at_mv_chroma_g", (ch, cw), 8, dispatch.sad_at_mv_chroma)):
        a_t = t32(rng.integers(0, 256, (g4, ph, pw)))
        b_t = t32(rng.integers(0, 256, (g4, ph, pw)))
        dy = rng.integers(-bs, bs + 1, (g4, 4, ph // bs, pw // bs))
        dx = rng.integers(-bs, bs + 1, (g4, 4, ph // bs, pw // bs))
        dy[..., 0, 0], dx[..., 0, 0], dy[..., -1, -1], dx[..., -1, -1] = -bs, -bs, bs, bs
        held_g(name, "sad_at.cu", "video_encoder_tpu/ops/pallas/sad.py:861",
               f"[{g4}, {ph}, {pw}] K=4", fn, (a_t, b_t, t32(dy), t32(dx)),
               dy.size * bs * bs * 2)
    planes4 = motion.hpel_stack(ref_t)                     # [G, 4, H, W]
    dy9 = rng.integers(-16, 17, (g4, 9, h // 16, w // 16))
    dx9 = rng.integers(-16, 17, (g4, 9, h // 16, w // 16))
    dy9[..., 0, :], dx9[..., :, 0], dy9[..., -1, :], dx9[..., :, -1] = -16, -16, 16, 16
    held_g("sad_at_mv_g", "sad_at.cu", "video_encoder_tpu/ops/pallas/sad.py:861",
           f"[{g4}, {h}, {w}] K=9 on 4 planes", dispatch.sad_at_mv,
           (cur_t, planes4, t32(dy9), t32(dx9), plane_of), dy9.size * 256 * 2,
           main=False)

    # the descent of four GOPs in one launch: panned, corner-bound, random
    # and panned planes, then four panned ones (each GOP its own texture),
    # each equal to the plain route and to four single launches; timed on
    # the four panned GOPs
    for kinds in (("pan", "corner", "random", "pan"), ("pan",) * g4):
        pl = [diamond_planes(rng, k, (), h, w) for k in kinds]
        dcur, dref = (t32(np.stack([p[i] for p in pl])) for i in (0, 1))
        dgot, want = both(dispatch.diamond_search, dcur, dref)
        err = max_abs_err(dgot, want)
        max_abs_err(dgot, per_g(dispatch.diamond_search, dcur, dref))
        line = (f"kernel diamond_descent_g [{g4}, {h}, {w}] {'/'.join(kinds)}: "
                f"equal to plain and to {g4} single launches")
        timing, dh, extra = None, {}, {}
        if len(set(kinds)) == 1:
            meven = dispatch.sad_map_even(dcur, dref)
            _, visited, _, _ = descent_walks(meven)
            timing, dh, extra = descent_timing(dcur, dref, dgot, visited)
            extra.update(g=g4, single_launches_ms=time_ms(
                lambda: singles(ksad.diamond_descent, dcur, dref, meven)))
            line += (f" ({extra['single_launches_ms']:.4f} ms); before the "
                     f"kernel device {extra['before_kernel_device_ms']:.4f} ms "
                     f"in {extra['before_kernel_device_kernels']:g} kernels")
        record("diamond_descent_g", "diamond.cu",
               "video_encoder_tpu/ops/dispatch.py:100", err, timing, **dh,
               **extra)
        log(line + shown(timing, dh or None))

    q28 = int(tables.load(dev).QSTEP[28])
    # every plane shape a lockstep path codes: luma and chroma
    for shape_name, (ph, pw), main in (
            (f"[{g4}, {h}, {w}]", (h, w), True),
            (f"[{g4}, {ch}, {cw}]", (ch, cw), False)):
        tex = np.stack([texture(rng, ph, pw)[:ph, :pw] for _ in range(g4)])
        pred = np.clip(np.roll(tex, 3, 2) + rng.integers(-20, 21, tex.shape), 0, 255)
        qp = rng.choice([1, 28, 63], (g4, ph // 8, pw // 8))
        q_mixed = tables.load(dev).QSTEP[t32(qp).long()].contiguous()
        q_flat = torch.full_like(q_mixed, q28)
        for qmat, name in ((False, "code_plane_g"), (True, "code_plane_qmat_g")):
            for qbias in (8, 5):     # mixed steps per GOP and block: held only
                a = (t32(tex), t32(pred), q_mixed, qbias, qmat)
                gq, wq = both(dispatch.code_plane, *a)
                max_abs_err(gq, wq)
                max_abs_err(gq, per_g(dispatch.code_plane, *a))
            held_g(name, "code_plane.cu",
                   "video_encoder_tpu/ops/pallas/codec.py:230", shape_name,
                   dispatch.code_plane, (t32(tex), t32(pred), q_flat, 8, qmat),
                   g4 * ph * pw * (4 * 16 + 10), main=main)
        # the row scan of G planes in lockstep (the lockstep and tile
        # paths' I step), mixed steps with and without slices, then timed
        # at qp 28
        cur_rows = t32(tex)
        for qmat in (False, True):
            for rr in (0, 34 if ph == h else 17):
                a = (cur_rows, q_mixed, 6, rr, qmat)
                gq, wq = both(dispatch.intra_rows_code_plane, *a)
                max_abs_err(gq, wq)
                max_abs_err(gq, per_g(dispatch.intra_rows_code_plane, *a))
            held_g("code_plane_rows_g", "code_plane.cu",
                   "video_encoder_tpu/ops/pallas/codec.py:230",
                   shape_name + (" qmat" if qmat else ""),
                   dispatch.intra_rows_code_plane, (cur_rows, q_flat, 8, 0, qmat),
                   g4 * ph * pw * (4 * 16 + 10), main=main and not qmat)

    # ---- the pre-haloed kernels of the tile-sharded encode: one frame's
    # four row shards (and its 2 x 2 tiles) as one batch, each kernel equal
    # to its plain version AND, the shards' results put together, to the
    # unsharded kernel on the whole frame; then an odd 23-row grid as one
    # unbatched shard with a row halo, and with both halos
    from video_encoder_tpu_torch.parallel import tiles

    geometries = (("rows", rows_of, unrows, ext_rows),
                  ("grid", grid_of, ungrid, ext_grid))

    def shape_of(*ts):
        return " / ".join(str(list(t.shape)) for t in ts)

    def held_haloed(name, src, replaces, geo, fn, args, whole, join, ops,
                    library=None):
        """One pre-haloed kernel at one geometry: equal to plain and, put
        together, to the unsharded kernel's result on the whole frame."""
        got, want = both(fn, *args)
        err = max_abs_err(tensors(got), tensors(want))
        max_abs_err([join(g) for g in tensors(got)], tensors(whole))
        timing = (*timed(fn, *args), bound(tensors(args), tensors(got), ops),
                  None if library is None else time_ms(library))
        dh = dev_host(lambda: fn(*args))
        shape = f"{geo} {shape_of(*tensors(args)[:2])}"
        if geo == "rows":
            record(name, src, replaces, err, timing, shards=4, **dh)
        else:
            record(name, src, replaces, err, also=(shape, timing), **dh)
        log(f"kernel {name} {shape}: equal to plain and to the unsharded "
            f"kernel on the whole frame" + shown(timing, dh))
        return got

    def take_indices(ref_ext, dy, dx, bs):
        """Flat indices of the pre-haloed fetch, for one torch.take."""
        b, rh, rw = ref_ext.shape
        ph, pw = dy.shape[-2] * bs, dx.shape[-1] * bs
        oy, ox = (rh - ph) // 2, (rw - pw) // 2
        px = [a.repeat_interleave(bs, -2).repeat_interleave(bs, -1)
              for a in (dy, dx)]
        sy = (torch.arange(ph, device=dev)[:, None] + px[0] + oy).clamp(0, rh - 1)
        sx = (torch.arange(pw, device=dev)[None, :] + px[1] + ox).clamp(0, rw - 1)
        return ((torch.arange(b, device=dev)[:, None, None] * rh + sy) * rw + sx)

    cur1, ref1 = cur_t[1], ref_t[1]   # the plane with the all-tied region
    whole = dispatch.full_search(cur1, ref1)
    for geo, split, join, ext in geometries:
        got = held_haloed(
            "full_search_haloed", "full_search.cu",
            "video_encoder_tpu/ops/pallas/sad.py:536", geo,
            dispatch.full_search_pre_haloed, (split(cur1), ext(ref1, 16)),
            whole, join, n_mbs * 1089 * 256 * 2)
    if (int(whole[0][0, 0]), int(whole[1][0, 0])) != (-16, -16):
        raise AssertionError("full_search_haloed: the tied MB should take "
                             "the first candidate")

    for name, (ph, pw), bs, fn in (
            ("mc_fetch_haloed_luma", (h, w), 16, dispatch.mc_fetch_luma_plane),
            ("mc_fetch_haloed_chroma", (ch, cw), 8, dispatch.mc_fetch_chroma_plane)):
        plane = t32(rng.integers(0, 256, (ph, pw)))
        dy = rng.integers(-bs, bs + 1, (ph // bs, pw // bs))
        dx = rng.integers(-bs, bs + 1, (ph // bs, pw // bs))
        for yy, xx, sy, sx in ((0, 0, -1, -1), (0, -1, -1, 1),
                               (-1, 0, 1, -1), (-1, -1, 1, 1)):
            dy[yy, xx], dx[yy, xx] = sy * bs, sx * bs
        dy, dx = t32(dy), t32(dx)
        whole = fn(plane, dy, dx)
        for geo, split, join, ext in geometries:
            args = (ext(plane, bs), split(dy), split(dx), bs, bs)
            flat = take_indices(*args[:3], bs)
            got = held_haloed(
                name, "mc_fetch.cu", "video_encoder_tpu/ops/pallas/sad.py:1038",
                geo, dispatch.mc_fetch_pre_haloed, args, whole, join, 0,
                library=lambda: torch.take(args[0], flat))
            max_abs_err([torch.take(args[0], flat)], [got])

    # format 4 on tiles: the refine's nine candidates on four halo-extended
    # parity planes (parity first, then the halo), one launch; then the
    # whole refine on the shards against the whole frame's
    planes4 = motion.hpel_stack(ref1)                      # [4, H, W]
    dy0, dx0, _ = dispatch.full_search(cur1, ref1)
    iy9 = torch.stack([((2 * dy0 + u) >> 1).clamp(-16, 16) for u, _ in uv])
    ix9 = torch.stack([((2 * dx0 + v) >> 1).clamp(-16, 16) for _, v in uv])
    whole = dispatch.sad_at_mv(cur1, planes4, iy9, ix9, plane_of)
    whole_refine = dispatch.hpel_refine(cur1, ref1, dy0, dx0, planes4)
    for geo, split, join, ext in geometries:
        planes_ext = torch.stack([ext(q, 16) for q in planes4], 1).contiguous()
        if geo == "rows":      # the exchange of the encode gives the same planes
            sh = rows_of(ref1)
            for mode_ in ("halo", "allgather"):
                max_abs_err(
                    [torch.stack((tiles.exchange_halo(sh, 16),
                                  *tiles._parity_ext(sh, 16, mode_)), 1)],
                    [planes_ext])
        args = (split(cur1), planes_ext, split(iy9), split(ix9), plane_of)
        held_haloed(
            "sad_at_mv_haloed", "sad_at.cu",
            "video_encoder_tpu/parallel/tiles.py:179", geo,
            dispatch.sad_at_mv_pre_haloed, args, whole, join,
            iy9.numel() * 256 * 2)
        got = dispatch.hpel_refine(split(cur1), None, split(dy0), split(dx0),
                                   planes_ext,
                                   sad_fn=dispatch.sad_at_mv_pre_haloed)
        max_abs_err([join(g) for g in got], whole_refine)
        log(f"kernel sad_at_mv_haloed in hpel_refine {geo}: the shards' "
            f"vectors equal the whole frame's")

    # the odd grid (368 x 640, 23 MB rows) as one unbatched shard
    oh, ow = luma[1]
    tex = texture(rng, oh, ow)
    cur_o = t32(tex[64:64 + oh, 64:64 + ow])
    ref_o = t32(np.clip(tex[59:59 + oh, 71:71 + ow]
                        + rng.integers(-3, 4, (oh, ow)), 0, 255))
    whole = dispatch.full_search(cur_o, ref_o)
    fetched = dispatch.mc_fetch_luma_plane(ref_o, whole[0], whole[1])
    for geo, ref_ext in (
            ("rows", tiles.exchange_halo(ref_o[None], 16)[0].contiguous()),
            ("grid", tiles.exchange_halo_2d(ref_o[None, None], 16)[0, 0].contiguous())):
        got, want = both(dispatch.full_search_pre_haloed, cur_o, ref_ext)
        err = max_abs_err(got, want)
        max_abs_err(got, whole)
        record("full_search_haloed", "full_search.cu",
               "video_encoder_tpu/ops/pallas/sad.py:536", err)
        got, want = both(dispatch.mc_fetch_pre_haloed, ref_ext, whole[0],
                         whole[1], 16, 16)
        err = max_abs_err([got], [want])
        max_abs_err([got], [fetched])
        record("mc_fetch_haloed_luma", "mc_fetch.cu",
               "video_encoder_tpu/ops/pallas/sad.py:1038", err)
        log(f"kernels full_search_haloed, mc_fetch_haloed_luma {geo} "
            f"{shape_of(cur_o, ref_ext)} (one shard, no batch): equal to "
            f"plain and to the unsharded kernels")

    recon_kernels(dev, rng, table)
    predictor_kernels(dev, rng, table)
    last_kernels(dev, rng, table)
    return table.rows


def recon_kernels(dev, rng, table: KernelTable):
    """The decoders' recon, two entries of the code_plane kernel with no
    Pallas counterpart (the reference rebuilds in jnp: recon_plane in
    video_encoder_tpu/pipeline/decoder.py:180, transform.py:158), each
    against its plain version at the 1080p and 640x360 plane shapes:
    sparse levels at qp 1, 12, 28 and 63 mixed per block, and levels drawn
    from the int16 extremes at the largest step, where the inverse's int32
    sums wrap; a predictor and the flat 128 of an I frame; flat steps and
    the quant matrix; the row recon without intra slices and with slices
    of 2 and 17 rows; the byte plane each writes. Timed at qp 28 as the
    decoders run them: the byte plane written, the inter recon against a
    predictor."""
    from video_encoder_tpu_torch.codec import tables
    from video_encoder_tpu_torch.ops import dispatch

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    record, shown = table.record, table.shown
    luma, chroma = LUMA, CHROMA
    q28_step = int(tables.load(dev).QSTEP[28])
    for h, w in [luma[0], chroma[0], luma[1], chroma[1]]:
        pred_t = t32(texture(rng, h, w)[:h, :w])
        q28 = torch.full((h // 8, w // 8), q28_step, dtype=torch.int32,
                         device=dev)
        for extreme in (False, True):
            lv, q_blk = recon_case(rng, dev, h, w, extreme)
            out8 = torch.empty((h, w), dtype=torch.uint8, device=dev)
            for qmat in (False, True):
                for pred in (pred_t, None):
                    got, want = both(dispatch.recon_plane, lv, pred, q_blk,
                                     qmat)
                    got8 = dispatch.recon_plane(lv, pred, q_blk, qmat, out8)
                    err = max_abs_err([got, got8, out8.int()],
                                      [want, want, want])
                    timing, dh = None, {}
                    if (h, w) in (luma[0], chroma[0]) and not extreme \
                            and pred is not None:
                        a28 = (lv, pred, q28, qmat, out8)
                        # per pixel: two 8-point passes of multiply-adds,
                        # the dequantize, two roundings, the add and clip
                        timing = (*timed(dispatch.recon_plane, *a28),
                                  bound([lv, pred, q28], [want, out8],
                                        h * w * (2 * 16 + 8)), None)
                        dh = dev_host(lambda: dispatch.recon_plane(*a28))
                    shape = (f"{h}x{w}" + (" qmat" if qmat else "")
                             + (" flat" if pred is None else ""))
                    if timing and (h, w) == luma[0] and not qmat:
                        record("recon_plane", "code_plane.cu",
                               "video_encoder_tpu/pipeline/decoder.py:180",
                               err, timing, **dh)
                    elif timing:
                        record("recon_plane", "code_plane.cu",
                               "video_encoder_tpu/pipeline/decoder.py:180",
                               err, also=(shape, timing), **dh)
                    else:
                        record("recon_plane", "code_plane.cu",
                               "video_encoder_tpu/pipeline/decoder.py:180",
                               err)
                    log(f"kernel recon_plane {shape}"
                        f"{' int16 extremes' if extreme else ''}: equal"
                        + shown(timing, dh))
                for rr in (0, 2, 17):
                    got, want = both(dispatch.intra_rows_recon_plane, lv,
                                     q_blk, rr, qmat)
                    got8 = dispatch.intra_rows_recon_plane(lv, q_blk, rr,
                                                           qmat, out8)
                    err = max_abs_err([got, got8, out8.int()],
                                      [want, want, want])
                    timing, dh = None, {}
                    if (h, w) in (luma[0], chroma[0]) and not extreme \
                            and rr == 0:
                        a28 = (lv, q28, 0, qmat, out8)
                        timing = (
                            *timed(dispatch.intra_rows_recon_plane, *a28),
                            bound([lv, q28], [want, out8],
                                  h * w * (2 * 16 + 8)), None)
                        dh = dev_host(
                            lambda: dispatch.intra_rows_recon_plane(*a28))
                    shape = f"{h}x{w}" + (" qmat" if qmat else "")
                    if timing and (h, w) == luma[0] and not qmat:
                        record("recon_plane_rows", "code_plane.cu",
                               "video_encoder_tpu/ops/transform.py:158", err,
                               timing, **dh)
                    elif timing:
                        record("recon_plane_rows", "code_plane.cu",
                               "video_encoder_tpu/ops/transform.py:158", err,
                               also=(shape, timing), **dh)
                    else:
                        record("recon_plane_rows", "code_plane.cu",
                               "video_encoder_tpu/ops/transform.py:158", err)
                    log(f"kernel recon_plane_rows {shape} reset_rows {rr}"
                        f"{' int16 extremes' if extreme else ''}: equal"
                        + shown(timing, dh))


def predictor_kernels(dev, rng, table: KernelTable):
    """The MC predictor, the three planes of a P step in one launch, at
    formats 1 and 4 (one reference plane, or four parity planes and
    half-pel vectors) with an intra MB here and there: single (1088x1920
    and the odd 368x640 grid), G = 4, and a 1088x1920 frame's four row
    shards and 2 x 2 tiles from pre-haloed stacks. Each is held against
    the plain composition (a fetch per plane or parity plane, the select,
    the mask), against one torch.take of its flat indices and, sharded,
    against the unsharded kernel; at 1088x1920 it is timed (call, device
    and host times, plain, bound by bytes: predict_bound), beside that
    torch.take."""
    from video_encoder_tpu_torch.ops import dispatch, motion

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def case(lead, h, w, fmt):
        r = 16 if fmt < 4 else 32
        nby, nbx = h // 16, w // 16
        planes = [t32(rng.integers(0, 256, (*lead, ph, pw)))
                  for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
        dy, dx = (rng.integers(-r, r + 1, (*lead, nby, nbx)) for _ in range(2))
        dy[..., 0, :], dx[..., :, 0], dy[..., -1, :], dx[..., :, -1] = -r, -r, r, r
        inter = torch.from_numpy(rng.random((*lead, nby, nbx)) < 0.8).to(dev)
        refs = tuple(motion.hpel_stack(p) if fmt >= 4 else p.unsqueeze(-3)
                     for p in planes)
        return refs, t32(dy), t32(dx), inter

    def held(name, replaces, shape, main, fn, args):
        got, want = both(fn, *args)
        err = max_abs_err(got, want)
        src, idx = take_of(*args)
        max_abs_err([torch.take(src, idx)],
                    [torch.cat([p.reshape(-1) for p in got])])
        if not main[0]:
            table.record(name, "mc_fetch.cu", replaces, err)
            log(f"kernel {name} {shape}: equal to plain and to torch.take")
            return got
        ms, take_ms = paired_ms(lambda: fn(*args), lambda: torch.take(src, idx))
        timing = (ms, timed(fn, *args)[1], predict_bound(got, *args[1:]),
                  take_ms)
        extra = dict(dev_host(lambda: fn(*args)), library_device_ms=device_ms(
            lambda: torch.take(src, idx), per_call=None)[0])
        if main[1]:
            table.record(name, "mc_fetch.cu", replaces, err, timing, format=1,
                         **extra)
        else:
            table.record(name, "mc_fetch.cu", replaces, err,
                         also=(shape, timing), library_ms=timing[3], **extra)
        log(f"kernel {name} {shape}: equal to plain and to torch.take"
            + table.shown(timing, extra) + f", torch.take's device time "
            f"{extra['library_device_ms']:.4f} ms")
        return got

    (h, w), g4 = LUMA[0], 4
    for lead, (ph, pw) in (((), LUMA[0]), ((), LUMA[1]), ((g4,), LUMA[0])):
        name = "mc_predict_g" if lead else "mc_predict"
        replaces = ("video_encoder_tpu/ops/pallas/sad.py:825" if lead
                    else "video_encoder_tpu/ops/pallas/sad.py:724")
        for fmt in (1, 4):
            args = case(lead, ph, pw, fmt)
            shape = f"format {fmt} {list(args[0][0].shape)}"
            got = held(name, replaces, shape, ((ph, pw) == LUMA[0], fmt == 1),
                       dispatch.mc_predict, args)
            if lead:
                for i in range(g4):
                    one = dispatch.mc_predict(tuple(r[i] for r in args[0]),
                                              *(a[i] for a in args[1:]))
                    max_abs_err(one, [p[i] for p in got])

    for geo, (sr, sc), split, join in (("rows", (4, 1), rows_of, unrows),
                                       ("grid", (2, 2), grid_of, ungrid)):
        for fmt in (1, 4):
            refs, dy, dx, inter = case((), h, w, fmt)
            exts = tuple(halo_windows(s, r, sr, sc)
                         for s, r in zip(refs, (16, 8, 8)))
            args = (exts, *(split(a) for a in (dy, dx, inter)))
            shape = f"format {fmt} {geo} {list(exts[0].shape)}"
            got = held("mc_predict_haloed", "video_encoder_tpu/ops/pallas/sad.py:1038",
                       shape, (True, geo == "rows" and fmt == 1),
                       dispatch.mc_predict_pre_haloed, args)
            max_abs_err([join(p) for p in got],
                        dispatch.mc_predict(refs, dy, dx, inter))


@contextlib.contextmanager
def sea(on: bool):
    """TVC_SEA set to 1 (the full search wrappers launch the SEA entries)
    or 0 for the duration, then restored."""
    old = os.environ.get("TVC_SEA")
    os.environ["TVC_SEA"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("TVC_SEA", None)
        else:
            os.environ["TVC_SEA"] = old


def sea_ops(rows) -> int:
    """int32 operations that the search's result needs, given the dy rows
    each MB evaluated (rows, one count per MB). Per MB, the least of the
    exhaustive search (1089 x 256 abs-diff-accumulates) and the SEA
    search: the block's 16 column sums (256 adds), the window's 16-row
    column sums as a sliding sum (16 adds for each of its 48 columns at the
    first row offset, an add and a subtract at each of the other 32), the
    1089 bounds of 16 abs-diff-accumulates each, and 33 x 256
    abs-diff-accumulates for every row evaluated exactly. An
    abs-diff-accumulate counts 2; on words of four 8-bit samples, as the
    kernel evaluates its rows (and as EVEN_MAP_OPS counts the even map),
    one vabsdiff4 makes four, so the rows and the exhaustive work count a
    quarter of that."""
    sums = 256 + 48 * 16 + 32 * 48 * 2
    exhaustive = 1089 * 256 * 2 // 4
    sea = sums + 1089 * 16 * 2 + rows.long() * 33 * 256 * 2 // 4
    return int(sea.clamp(max=exhaustive).sum())


def frame_levels(rng, dev, h, w):
    """Quantized levels of a textured frame's three planes at qp 28 (Y
    [h/8, w/8, 64], Cb and Cr at half size), from the code_plane kernel."""
    from video_encoder_tpu_torch.codec import tables
    from video_encoder_tpu_torch.ops import dispatch

    q28 = int(tables.load(dev).QSTEP[28])
    levels = []
    for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        tex = texture(rng, ph, pw)
        cur = torch.from_numpy(tex[:ph, :pw].astype(np.int32)).to(dev)
        pred = np.clip(tex[:ph, :pw] + rng.integers(-3, 4, (ph, pw)), 0, 255)
        pred = torch.from_numpy(pred.astype(np.int32)).to(dev)
        q = torch.full((ph // 8, pw // 8), q28, dtype=torch.int32, device=dev)
        levels.append(dispatch.code_plane(cur, pred, q, 8)[0])
    return levels


def recon_case(rng, dev, h, w, extreme=False):
    """Zigzag levels int16 [h/8, w/8, 64] and steps [h/8, w/8] int32 for
    the decoders' recon: sparse small levels at qp 1, 12, 28 and 63 mixed
    per block or, with extreme, levels drawn from the int16 extremes at the
    largest step."""
    from video_encoder_tpu_torch.codec import tables

    shape = (h // 8, w // 8, 64)
    if extreme:
        lv = rng.choice([-32768, -32767, 32767, 0, 1], shape)
        qp = np.full(shape[:-1], 63)
    else:
        lv = np.where(rng.random(shape) < 0.8, 0,
                      rng.integers(-60, 61, shape))
        qp = rng.choice([1, 12, 28, 63], shape[:-1])
    q_blk = tables.load(dev).QSTEP[
        torch.from_numpy(qp).to(dev).long()].contiguous()
    return torch.from_numpy(lv.astype(np.int16)).to(dev), q_blk


def sea_references(dev, rng):
    """The 1080p pan's first two frames [2 x (1088, 1920)] and the SEA
    search's three references for frame 1: the clean source frame 0, the
    port's own qp-28 recon of it (the I frame: flat-128 prediction, what
    the engine searches) and noise."""
    from video_encoder_tpu_torch.codec import tables
    from video_encoder_tpu_torch.ops import dispatch

    h, w = LUMA[0]
    src = [torch.from_numpy(y.astype(np.int32)).to(dev)
           for y in synth_clip(2, h, w, seed=11)[0]]
    q28 = torch.full((h // 8, w // 8), int(tables.load(dev).QSTEP[28]),
                     dtype=torch.int32, device=dev)
    recon = dispatch.code_plane(src[0], torch.full_like(src[0], 128), q28, 8)[1]
    noise = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.int32)).to(dev)
    return src, {"recon": recon.contiguous(), "clean": src[0], "noise": noise}


def as_words(a, like):
    """Values below 2^32 (numpy) as a device tensor of the word dtype of
    `like`: int32 holding the uint32 bit patterns (a checkout from before
    the 32-bit words: int64)."""
    a = np.asarray(a).astype(np.uint32)
    a = a.view(np.int32) if like.dtype == torch.int32 else a.astype(np.int64)
    return torch.from_numpy(a).to(like.device)


def chunk_pieces(rng, dev, bw: int = 24):
    """chunk_merge's operands at the reference micro-bench's shape: a 1080p
    frame's 8160 x 8 pieces of bw words (header, four luma blocks, Cb, Cr
    and an empty piece per MB, from code_plane at qp 28 and random
    vectors), padded with empty pieces to a multiple of 1024: (words
    [65536, bw] in the pack's word dtype, bits [65536] int32, k)."""
    from video_encoder_tpu_torch.codec import entropy, pack

    h, w = LUMA[0]
    nby, nbx = h // 16, w // 16
    n_mbs = nby * nbx

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    levels = frame_levels(rng, dev, h, w)
    qpd = t32(rng.integers(-2, 3, (nby, nbx)))
    inter = torch.from_numpy(rng.random((nby, nbx)) < 0.7).to(dev)
    mvy, mvx = (t32(rng.integers(-16, 17, (nby, nbx))) for _ in range(2))
    pw_, pb_, _ = entropy._frame_pieces(*levels, qpd, True, inter, mvy, mvx, bw)
    n = -(-8 * n_mbs // 1024) * 1024
    words = torch.zeros((n, bw), dtype=pw_.dtype, device=dev)
    bits = torch.zeros((n,), dtype=torch.int32, device=dev)
    words.view(-1, 8, bw)[:n_mbs, :7] = pw_
    bits.view(-1, 8)[:n_mbs, :7] = pb_
    return words, bits, pack.pick_chunk_k(n, bw)


def merge_bound(bits, caps, outputs):
    """bound() of a merge on this run's data: each piece's used words,
    min(ceil(bits / 32), its width caps), read once as 32-bit words (the
    merge reads no more: every producer leaves zeros past its bit count),
    its bit count read once, the outputs (int32 words) written once; two
    shifts and two ors per used word."""
    used = int(torch.minimum((bits.long() + 31) // 32, caps).sum())
    nbytes = 4 * (used + bits.numel()) + sum(
        t.numel() * t.element_size() for t in outputs)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * 4 * used / INT32_OPS_PER_S
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def frame_tail_rows(rng, dev, record, shown, g: int = 4):
    """Row 17, the frame pack's tail: block_pack's outputs of a real 1080p
    frame's levels at 16 words and its MB arrays to the frame's words,
    through dispatch.frame_assemble (the header launch and the placement)
    against its plain version (the header symbols and their pack,
    frame_concat), exact, in both syntaxes, one frame and G in one call;
    and rc mb's lengths-only launch (dispatch.mb_bit_totals). The bound:
    the pieces' used words, the blocks' bit counts and the MB arrays read
    once, the frames' words, totals and MB totals written once."""
    from video_encoder_tpu_torch.codec import entropy
    from video_encoder_tpu_torch.ops import dispatch

    h, w = LUMA[0]
    nby, nbx = h // 16, w // 16
    levels = frame_levels(rng, dev, h, w)
    hdr = (torch.from_numpy(rng.integers(-2, 3, (nby, nbx)).astype(np.int32)).to(dev),
           torch.from_numpy(rng.random((nby, nbx)) < 0.7).to(dev),
           *(torch.from_numpy(rng.integers(-16, 17, (nby, nbx)).astype(
               np.int32)).to(dev) for _ in range(2)))
    cap = entropy.capacity_words(nby * nbx)
    for fmt in (1, 2):
        for lead in (1, g):
            def rep(t):
                return t if lead == 1 else t.expand(lead, *t.shape).contiguous()
            blocks = entropy._plane_blocks(*(rep(t) for t in levels), 16, fmt)
            hd = tuple(rep(t) for t in hdr)
            args = (blocks, hd, True, cap, fmt)
            got, want = both(dispatch.frame_assemble, *args)
            err = max_abs_err(got, want)
            used = sum(int(torch.clamp((b.long() + 31) // 32, max=16).sum())
                       for _, b in blocks)
            reads = 4 * used + sum(b.numel() * 4 for _, b in blocks) + sum(
                t.numel() * t.element_size() for t in hd)
            timing = (*timed(dispatch.frame_assemble, *args),
                      bound([], got[:3], 0, reads), None)
            dh = dev_host(lambda: dispatch.frame_assemble(*args), per_call=2)
            shape = f"{'' if lead == 1 else f'{lead} x '}{h}x{w} format {fmt}"
            first = dict(timing=timing) if (lead, fmt) == (1, 1) else dict(
                also=(shape, timing))
            for name in ("frame_headers", "frame_place"):
                record(name, "frame_pack.cu",
                       "video_encoder_tpu/codec/entropy.py:851", err, **first,
                       **dh)
            log(f"kernels frame_headers, frame_place {shape}: equal, "
                f"{int(got[1].reshape(-1)[0])} bits a frame, {used} used "
                f"block words" + shown(timing, dh))
            if lead == 1:
                bits = tuple(b for _, b in blocks)
                est, want_est = both(dispatch.mb_bit_totals, bits, hd, True, fmt)
                err = max_abs_err([est], [want_est])
                max_abs_err([est], [got[2]])
                timing = (*timed(dispatch.mb_bit_totals, bits, hd, True, fmt),
                          bound([*bits, *hd], [est], 0), None)
                dh = dev_host(lambda: dispatch.mb_bit_totals(bits, hd, True, fmt))
                first = dict(timing=timing) if fmt == 1 else dict(
                    also=(shape, timing))
                record("frame_mb_bits", "frame_pack.cu",
                       "video_encoder_tpu/codec/entropy.py:206", err, **first,
                       **dh)
                log(f"kernel frame_mb_bits {shape}: equal to the plain MB "
                    f"totals and to the placement's" + shown(timing, dh))


def frame_pack_figures(rng, dev, card, g: int = 4) -> dict:
    """The frame emit's whole pack (entropy.pack_frame_planes: block_pack
    of the three planes, then the tail) of a real 1080p frame's levels at
    16 words into its budgeted capacity, alone and for G frames in one
    call: call time, device time (its kernels' durations) and device
    kernels per call, host time, and the bytes it must move (the levels
    and MB arrays read once, the frame's words written once) over the
    card's memory rate. An entry point every checkout has, for --ab."""
    from video_encoder_tpu_torch.codec import entropy

    h, w = LUMA[0]
    nby, nbx = h // 16, w // 16
    levels = frame_levels(rng, dev, h, w)
    qpd = torch.from_numpy(rng.integers(-2, 3, (nby, nbx)).astype(np.int32)).to(dev)
    inter = torch.from_numpy(rng.random((nby, nbx)) < 0.7).to(dev)
    mvy, mvx = (torch.from_numpy(rng.integers(-16, 17, (nby, nbx)).astype(
        np.int32)).to(dev) for _ in range(2))
    cap = entropy.capacity_words(nby * nbx)
    out = {}
    for lead in (1, g):
        def rep(t):
            return t if lead == 1 else t.expand(lead, *t.shape).contiguous()
        args = (*(rep(t) for t in levels), rep(qpd), True, rep(inter),
                rep(mvy), rep(mvx), 16, cap)

        def fn(args=args):
            return entropy.pack_frame_planes(*args)
        words, total, _, _ = fn()
        nbytes = sum(t.numel() * t.element_size() for t in args
                     if isinstance(t, torch.Tensor)) + (
            words.numel() * words.element_size())
        dev_ms, kernels = device_ms(fn, per_call=None)
        f = dict(ms=time_ms(fn), device_ms=dev_ms, kernels=kernels,
                 host_ms=host_ms(fn), bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                 words_dtype=str(words.dtype).replace("torch.", ""),
                 sum=_checksum([words, total]))
        out["single" if lead == 1 else f"g{lead}"] = f
        log(f"frame pack {'' if lead == 1 else f'{lead} x '}{h}x{w} -> "
            f"{list(words.shape)} {f['words_dtype']} "
            f"({int(total.reshape(-1)[0])} bits a frame): {f['ms']:.4f} ms, "
            f"device {dev_ms:.4f} ms in {kernels:g} kernels, host "
            f"{f['host_ms']:.4f} ms, bytes bound {f['bound_ms']:.4f} ms "
            f"[{card}]")
    return out


def mb_caps(srcs):
    """The width of each piece of span_merge_mb's per-MB sources (header
    hww, blocks w, the empty eighth piece 0), in piece order."""
    hw, yw = srcs[0], srcs[1]
    n_mbs, _, w = yw.shape
    one = torch.tensor([hw.shape[-1]] + [w] * 6 + [0], device=yw.device)
    return one.repeat(n_mbs)


def last_kernels(dev, rng, table: KernelTable):
    """The kernels that no encode path runs by default: the whole SAD map
    (stride 1) and its batched twin, the SEA full search's three entries
    (TVC_SEA=1) on three references, chunk_merge, and the hierarchical
    search's refine through sad_at_mv."""
    from video_encoder_tpu_torch.ops import dispatch, motion
    from video_encoder_tpu_torch.ops.kernels import build

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    record, shown, card = table.record, table.shown, table.card
    g4 = 4

    # ---- sad_map: all 1089 SADs per MB, single and G = 4, at both grids.
    # Held three ways: against its plain version, its packed-key first
    # minimum against full_search, its even sublattice against sad_map_even
    for h, w in LUMA:
        nby, nbx = h // 16, w // 16
        n_mbs = nby * nbx
        tex = texture(rng, h, w)
        cur = np.stack([np.roll(tex[64:64 + h, 64:64 + w], (3 * i, -4 * i), (0, 1))
                        for i in range(g4)])
        ref = np.stack([tex[48:48 + h, 80:80 + w]] * g4) + rng.integers(-3, 4, cur.shape)
        cur[:, :128, :256] = 100
        ref[:, :160, :288] = 100
        cur_t, ref_t = t32(cur), t32(np.clip(ref, 0, 255))
        got, want = both(dispatch.sad_map, cur_t[0], ref_t[0])
        err = max_abs_err([got], [want])
        key = (got.long() * 2048 + torch.arange(1089, device=dev)).amin(-1)
        fs = dispatch.full_search(cur_t[0], ref_t[0])
        max_abs_err([((key & 2047) // 33 - 16).int(), ((key & 2047) % 33 - 16).int(),
                     (key >> 11).int()], fs)
        even = got.reshape(nby, nbx, 33, 33)[..., ::2, ::2].reshape(nby, nbx, 289)
        max_abs_err([even], [dispatch.sad_map_even(cur_t[0], ref_t[0])])
        ties = int((got == got[..., :1]).all(-1).sum())
        timing, dh = None, {}
        if (h, w) == LUMA[0]:
            timing = (*timed(dispatch.sad_map, cur_t[0], ref_t[0]),
                      bound([cur_t[0], ref_t[0]], [got], n_mbs * 1089 * 256 * 2),
                      None)
            dh = dev_host(lambda: dispatch.sad_map(cur_t[0], ref_t[0]), None)
        record("sad_map", "full_search.cu", "video_encoder_tpu/ops/pallas/sad.py:594",
               err, timing, **dh)
        log(f"kernel sad_map {h}x{w}: equal to plain; its first minimum is "
            f"full_search's, its even sublattice sad_map_even's; {ties} MBs "
            f"with all 1089 tied" + shown(timing, dh))

        got, want = both(dispatch.sad_map, cur_t, ref_t)
        err = max_abs_err([got], [want])
        max_abs_err([got], [torch.stack([dispatch.sad_map(cur_t[i], ref_t[i])
                                          for i in range(g4)])])
        timing, singles_ms, dh = None, None, {}
        if (h, w) == LUMA[0]:
            timing = (*timed(dispatch.sad_map, cur_t, ref_t),
                      bound([cur_t, ref_t], [got], g4 * n_mbs * 1089 * 256 * 2),
                      None)
            singles_ms = time_ms(lambda: [dispatch.sad_map(cur_t[i], ref_t[i])
                                          for i in range(g4)])
            dh = dict(dev_host(lambda: dispatch.sad_map(cur_t, ref_t), None),
                      g=g4, single_launches_ms=singles_ms)
        record("sad_map_g", "full_search.cu", "video_encoder_tpu/ops/pallas/sad.py:632",
               err, timing, **dh)
        log(f"kernel sad_map_g [{g4}, {h}, {w}]: equal to plain and to {g4} "
            f"single launches" + (f" ({singles_ms:.4f} ms)" if singles_ms else "")
            + shown(timing, dh))

    # ---- the SEA search (TVC_SEA=1) against three references of the
    # 1080p pan's frame 1: the clean source frame 0, the port's own qp-28
    # recon of it (the I frame: flat-128 prediction, what the engine
    # searches) and noise. Each entry against its plain version and the
    # exhaustive kernel; its rows per MB and its time beside full_search's,
    # both in this call. The bound counts this run's rows.
    h, w = LUMA[0]
    src, refs = sea_references(dev, rng)
    cur_t = src[1]
    for name, ref_t in refs.items():
        with sea(True):
            got = dispatch.full_search_sea_stats(cur_t, ref_t)
            plain = motion.full_search_sea(cur_t, ref_t)
            torch.cuda.synchronize()
            err = max_abs_err(got, plain)
            sea_ms = time_ms(lambda: dispatch.full_search(cur_t, ref_t))
            dh = dev_host(lambda: dispatch.full_search(cur_t, ref_t), None)
        max_abs_err(got[:3], dispatch.full_search(cur_t, ref_t))
        fs_ms = time_ms(lambda: dispatch.full_search(cur_t, ref_t))
        plain_ms = time_ms(lambda: motion.full_search_sea(cur_t, ref_t))
        mean_rows = float(got[3].float().mean())
        timing = (sea_ms, plain_ms,
                  bound([cur_t, ref_t], got[:3], sea_ops(got[3])), None)
        if name == "recon":
            record("full_search_sea", "full_search.cu",
                   "video_encoder_tpu/ops/pallas/sad.py:68", err, timing,
                   rows_per_mb=mean_rows, full_search_ms=fs_ms, reference=name,
                   **dh)
        else:
            record("full_search_sea", "full_search.cu",
                   "video_encoder_tpu/ops/pallas/sad.py:68", err,
                   also=(f"{name} reference", timing), rows_per_mb=mean_rows,
                   full_search_ms=fs_ms, **dh)
        log(f"kernel full_search_sea {h}x{w}, {name} reference: equal to plain "
            f"(vectors and rows) and to full_search; {mean_rows:.3f} of 33 rows "
            f"per MB, full_search {fs_ms:.4f} ms in this call"
            + shown(timing, dh))
    # the odd grid, clean and noise: the stats entry against plain
    oh, ow = LUMA[1]
    for name in ("clean", "noise"):
        a = (cur_t[:oh, :ow].contiguous(), refs[name][:oh, :ow].contiguous())
        got, want = both(dispatch.full_search_sea_stats, *a)
        record("full_search_sea", "full_search.cu",
               "video_encoder_tpu/ops/pallas/sad.py:68", max_abs_err(got, want))
        log(f"kernel full_search_sea {oh}x{ow}, {name} reference: equal to plain, "
            f"{float(got[3].float().mean()):.3f} rows per MB")

    # G = 4: frame 1 against the recon, the clean frame, noise and the recon
    # again, one launch, against plain, four single SEA launches and the
    # exhaustive batched kernel
    order = ("recon", "clean", "noise", "recon")
    cur4 = torch.stack([cur_t] * g4)
    ref4 = torch.stack([refs[n] for n in order])
    with sea(True):
        got = dispatch.full_search(cur4, ref4)
        torch.cuda.synchronize()
        singles = [dispatch.full_search(cur_t, refs[n]) for n in order]
        sea_ms = time_ms(lambda: dispatch.full_search(cur4, ref4))
        singles_ms = time_ms(lambda: [dispatch.full_search(cur4[i], ref4[i])
                                      for i in range(g4)])
        dh = dev_host(lambda: dispatch.full_search(cur4, ref4), None)
    plain = motion.full_search_sea(cur4, ref4)
    err = max_abs_err(got, plain[:3])
    max_abs_err(got, [torch.stack(o) for o in zip(*singles)])
    max_abs_err(got, dispatch.full_search(cur4, ref4))
    fs_ms = time_ms(lambda: dispatch.full_search(cur4, ref4))
    timing = (sea_ms, time_ms(lambda: motion.full_search_sea(cur4, ref4)),
              bound([cur4, ref4], got, sea_ops(plain[3])), None)
    record("full_search_sea_g", "full_search.cu",
           "video_encoder_tpu/ops/pallas/sad.py:420", err, timing, g=g4,
           single_launches_ms=singles_ms, full_search_g_ms=fs_ms,
           rows_per_mb=float(plain[3].float().mean()), references=list(order),
           **dh)
    log(f"kernel full_search_sea_g [{g4}, {h}, {w}] ({', '.join(order)}): equal "
        f"to plain, to {g4} single SEA launches ({singles_ms:.4f} ms) and to "
        f"full_search_g ({fs_ms:.4f} ms in this call)" + shown(timing, dh))

    # the tile path: the frame's four row shards against the recon
    sh_cur, sh_ref = rows_of(cur_t), ext_rows(refs["recon"], 16)
    with sea(True):
        got = dispatch.full_search_pre_haloed(sh_cur, sh_ref)
        torch.cuda.synchronize()
        sea_ms = time_ms(lambda: dispatch.full_search_pre_haloed(sh_cur, sh_ref))
        dh = dev_host(lambda: dispatch.full_search_pre_haloed(sh_cur, sh_ref),
                      None)
    plain = motion.full_search_sea_pre_haloed(sh_cur, sh_ref)
    err = max_abs_err(got, plain[:3])
    max_abs_err([unrows(g) for g in got], dispatch.full_search(cur_t, refs["recon"]))
    max_abs_err(got, dispatch.full_search_pre_haloed(sh_cur, sh_ref))
    fs_ms = time_ms(lambda: dispatch.full_search_pre_haloed(sh_cur, sh_ref))
    timing = (sea_ms, time_ms(lambda: motion.full_search_sea_pre_haloed(sh_cur, sh_ref)),
              bound([sh_cur, sh_ref], got, sea_ops(plain[3])), None)
    record("full_search_sea_haloed", "full_search.cu",
           "video_encoder_tpu/ops/pallas/sad.py:536", err, timing, shards=4,
           full_search_haloed_ms=fs_ms, rows_per_mb=float(plain[3].float().mean()),
           **dh)
    log(f"kernel full_search_sea_haloed {list(sh_cur.shape)} / {list(sh_ref.shape)}"
        f", recon reference: equal to plain, to the whole frame's search and to "
        f"full_search_haloed ({fs_ms:.4f} ms in this call)" + shown(timing, dh))

    # ---- chunk_merge at the reference micro-bench's shape (chunk_pieces:
    # a 1080p frame's 65536 pieces of 24 words, k = 1024); then dense
    # random pieces (every piece full) at the same shape
    words, bits, kc = chunk_pieces(rng, dev)
    n, bw = words.shape
    full = as_words(rng.integers(0, 2**32, (n, bw), dtype=np.uint64), words)
    for name, a in (("1080p frame", (words, bits, kc)),
                    ("dense pieces", (full, torch.full_like(bits, 32 * bw), kc))):
        got, want = both(dispatch.chunk_merge, *a)
        err = max_abs_err(got, want)
        if not torch.equal(got[1].long(), a[1].view(-1, kc // 2).sum(-1)):
            raise AssertionError(f"chunk_merge {name}: bit counts")
        timing = (*timed(dispatch.chunk_merge, *a),
                  merge_bound(a[1], torch.full_like(a[1], bw, dtype=torch.long),
                              got), None)
        dh = dev_host(lambda: dispatch.chunk_merge(*a), None)
        if name == "1080p frame":
            record("chunk_merge", "span_merge.cu",
                   "video_encoder_tpu/ops/pallas/pack.py:102", err, timing,
                   **dh)
        else:
            record("chunk_merge", "span_merge.cu",
                   "video_encoder_tpu/ops/pallas/pack.py:102", err,
                   also=(name, timing), **dh)
        log(f"kernel chunk_merge {name}: {n} pieces of {bw} words, k {kc} -> "
            f"{got[0].shape[0]} strings of {got[0].shape[1]} words, "
            f"{int(got[1].sum())} bits: equal" + shown(timing, dh))

    # ---- the hierarchical search: the plain coarse search, then each of
    # the two refine steps' 25 candidates in one sad_at_mv launch
    n0 = build.LAUNCHES["sad_at_mv"]
    got, want = both(dispatch.hier_search, cur_t, src[0])
    launches = build.LAUNCHES["sad_at_mv"] - n0
    err = max_abs_err(got, want)
    if launches != 2:
        raise AssertionError(f"hier_search: {launches} sad_at_mv launches, not 2")
    ms, plain_ms = timed(dispatch.hier_search, cur_t, src[0])
    record("sad_at_mv", "sad_at.cu", "video_encoder_tpu/ops/pallas/sad.py:852",
           err, hier_search_ms=ms, hier_search_plain_ms=plain_ms)
    found = float(((got[0] == 2) & (got[1] == 3)).float().mean())
    log(f"hier_search {h}x{w} (clean reference): equal to plain, {launches} "
        f"sad_at_mv launches (K = 25), {100 * found:.1f} % of MBs at the pan's "
        f"(2, 3); {ms:.4f} ms vs plain {plain_ms:.4f} ms [{card}]")
    if found < 0.5:
        raise AssertionError("hier_search: the pan was not found")


def span_sources(rng, dev, h, w, dense):
    """Per-MB piece sources of one frame for the span merges: a real
    frame's (code_plane at qp 28, block_pack at 16 words, random
    vectors), or pieces of 300 bits that fit their 512-bit blocks but
    overflow the budgeted span width (tests/test_merge_budget_overflow.py)."""
    from video_encoder_tpu_torch.codec import entropy, pack

    nby, nbx = h // 16, w // 16
    if dense:
        def lv(bh, bw_):    # ~36 nonzero ±1..2 levels: 250-350 bits a block
            a = np.zeros((bh, bw_, 64), np.int32)
            m = rng.random(a.shape) < 0.55
            a[m] = rng.integers(1, 3, m.sum()) * rng.choice([-1, 1], m.sum())
            return torch.from_numpy(a).to(dev)
        levels = (lv(2 * nby, 2 * nbx), lv(nby, nbx), lv(nby, nbx))
    else:
        levels = frame_levels(rng, dev, h, w)

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    qpd = t32(rng.integers(-2, 3, (nby, nbx)))
    inter = torch.from_numpy(rng.random((nby, nbx)) < 0.7).to(dev)
    dy, dx = (t32(rng.integers(-16, 17, (nby, nbx))) for _ in range(2))
    (hw, yw, cbw, crw), bits7, _ = entropy._mb_sources(
        *levels, qpd, True, inter, dy, dx, 16)
    piece_bits = torch.nn.functional.pad(bits7, (0, 1)).reshape(-1).contiguous()
    srcs = (hw.contiguous(), yw.contiguous(), cbw.contiguous(),
            crw.contiguous(), piece_bits)
    return srcs, pack.span_plan(nby * nbx, 16)


def build_oracle() -> None:
    """The C++ oracle, built into build/oracle/ (never into oracle/)."""
    os.makedirs(os.path.dirname(ORACLE_BIN), exist_ok=True)
    subprocess.run(["g++", "-O2", "-std=c++17", "-pthread", "-o", ORACLE_BIN,
                    ORACLE_SRC], check=True)


def write_clip(path, ys, cbs, crs):
    with open(path, "wb") as f:
        for y, cb, cr in zip(ys, cbs, crs):
            f.write(y.tobytes() + cb.tobytes() + cr.tobytes())


def mode(tag, **kw):
    """An encode configuration: the CLI's flags and the clip recipe
    (clip "pan": synth_clip with `passes`; "halfpel": synth_clip_halfpel)."""
    return dict(dict(tag=tag, search="full", rc="none", kbps=0, vbv_kbits=0,
                     fmt=1, cqpo=0, qbias=8, qmat=False, islice=0, clip="pan",
                     passes=2, scale=1), **kw)


FULL = mode("full")
# BASELINE config 3 on the four-pass texture, which spends about twice
# 12000 kbps at qp 28 without rate control, so the frame carry and the
# per-MB offsets both work
CONFIG3 = mode("config3", search="diamond", rc="mb", kbps=12000, passes=4)
# this slice's path at full width: half-pel vectors, the quant matrix and a
# chroma qp offset, on a clip whose motion is a true half-pel pan. The
# quant matrix coarsens the high frequencies, so the clips of the
# quant-matrix paths are band-limited (scale): on the noise-like texture
# of the paths above it costs 5 dB and the stream decodes below the floor
V4 = mode("v4", fmt=4, qmat=True, cqpo=2, clip="halfpel", scale=16)
# the format-4 path once more with intra slices of 17 MB rows: two row
# shards of 34 MB rows each restart the I frame's row scan where a slice does
V4_ISLICE = dict(V4, tag="v4i17", islice=17)
V2_SMALL = mode("v2", fmt=2, cqpo=4, search="diamond", rc="vbv", kbps=1500,
                passes=4, scale=4)
V3_SMALL = mode("v3", fmt=3, qmat=True, islice=2, rc="adaptive", scale=16)
# two-pass on the format-2 clip: rc none becomes bitrate, the target moves
# every GOP's qp off the base qp (1500 kbps would take it to a qp that
# decodes under the PSNR floor)
TWOPASS_SMALL = mode("twopass", fmt=2, cqpo=4, search="diamond", kbps=3000,
                     passes=4, scale=4)
# the golden model's own modes on the format-2 clip at format 1: the
# hierarchical search (no device engine takes it), and rc mb, held against
# the GOP engine on the card
HIER_SMALL = mode("hier", search="hier", passes=4, scale=4)
MB_SMALL = mode("mb", search="diamond", rc="mb", kbps=3000, passes=4, scale=4)


FOLDED = ("block_pack", "block_pack_v2", "span_merge_mb", "span_merge",
          "frame_headers", "frame_place", "frame_mb_bits")


def expected_kernels(m, emit, intra_only=False, batched=False):
    """The launch counters a path must move; batched: those of a lockstep
    encode of G GOPs (the `_g` kernels, and the folded pack and merges)."""
    ks = ["code_plane_qmat" if m["qmat"] else "code_plane"]
    if not intra_only:
        ks += ["mc_predict"]
        ks += (["full_search"] if m["search"] == "full"
               else ["sad_map_even", "diamond_descent"])
        if m["fmt"] >= 4:
            ks.append("sad_at_mv")
    if batched:
        ks = [k + "_g" for k in ks]
    ks += ["block_pack_v2" if m["fmt"] >= 2 else "block_pack", "frame_headers"]
    ks += ["span_merge_mb", "span_merge"] if emit == "chunks" else ["frame_place"]
    if m["rc"] == "mb" and not intra_only:
        ks.append("frame_mb_bits")
    return ks


def check_launches(what, launches, expected):
    """Every expected kernel launched, and no single-plane fetch."""
    missing = [k for k in expected if launches[k] == 0]
    if missing:
        raise AssertionError(f"{what}: kernels not launched: {missing}")
    fetched = [k for k in SINGLE_FETCHES if launches[k]]
    if fetched:
        raise AssertionError(f"{what}: single-plane fetches launched: {fetched}")


def check_per_p_step(what, launches, name, p_steps):
    """The predictor launched once per P step of each run (a GOP or batch
    that overflows is encoded again, so whole multiples)."""
    n = launches[name]
    if p_steps and (n == 0 or n % p_steps):
        raise AssertionError(f"{what}: {name} launched {n} times for "
                             f"{p_steps} P steps a run")


def check_row_scan(what, launches, m, gop, batched=False):
    """Formats 3 and 4: each I step codes its three planes with one
    row-scan launch each (code_plane_rows, or _g over G GOPs or G x S
    shards), and no [8, W] stripe goes through code_plane, which codes the
    three planes of each P step: per run of a GOP (or of a lockstep batch,
    and again for a GOP encoded anew after an overflow, or for rc mb's
    first pass) one I step and gop - 1 P steps, so code_plane launches
    gop - 1 times as often as the row scan. Every GOP of the path is gop
    frames long."""
    if m["fmt"] < 3:
        return
    sfx = "_g" if batched else ""
    rows = launches["code_plane_rows" + sfx]
    other = launches["code_plane_rows" + ("" if batched else "_g")]
    flat = launches[("code_plane_qmat" if m["qmat"] else "code_plane") + sfx]
    if not rows or rows % 3 or flat != rows * (gop - 1) or other:
        raise AssertionError(
            f"{what}: code_plane_rows{sfx} launched {rows} times, code_plane "
            f"{flat} (want {gop - 1} per row-scan launch: no stripe), the "
            f"other row-scan entry {other}")


def config_of(m, w, h, gop):
    from video_encoder_tpu_torch.codec.config import EncoderConfig

    return EncoderConfig(
        width=w, height=h, gop_n=gop, base_qp=28, search=m["search"],
        rc=m["rc"], target_kbps=m["kbps"], vbv_kbits=m["vbv_kbits"],
        format_version=m["fmt"], chroma_qp_offset=m["cqpo"],
        quant_bias=m["qbias"], quant_matrix=m["qmat"],
        intra_slice_mbrows=m["islice"])


def start_job(tmp, m, w, h, n, gop, like=None):
    """Make and write the clip of one path and start the oracle's encode
    of it (one CPU process; the jobs' oracles run side by side). `like`
    is an earlier job of the same mode and size whose clip and raw file
    this one encodes again at another GOP length."""
    tag = f"{w}x{h}_gop{gop}_{m['tag']}"
    if like is not None:
        clip, raw = like["clip"], like["raw"]
    else:
        synth = synth_clip_halfpel if m["clip"] == "halfpel" else synth_clip
        clip = synth(n, h, w, seed=11, passes=m["passes"], scale=m["scale"])
        raw = os.path.join(tmp, f"in_{tag}.yuv")
        write_clip(raw, *clip)
    job = dict(mode=m, w=w, h=h, n=n, gop=gop, tag=tag, clip=clip, raw=raw,
               ours=os.path.join(tmp, f"port_{tag}.tvc"),
               theirs=os.path.join(tmp, f"oracle_{tag}.tvc"),
               dec=os.path.join(tmp, f"dec_{tag}.yuv"), t0=time.perf_counter())
    # oracle encode in out W H gop qp search rc kbps frames fmt cqpo qbias
    #   vbv_kbits qmat islice
    job["oracle"] = subprocess.Popen(
        [ORACLE_BIN, "encode", job["raw"], job["theirs"], str(w), str(h),
         str(gop), "28", m["search"], m["rc"], str(m["kbps"]), str(n),
         str(m["fmt"]), str(m["cqpo"]), str(m["qbias"]), str(m["vbv_kbits"]),
         str(int(m["qmat"])), str(m["islice"])],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    return job


def wait_oracles(jobs):
    for job in jobs:
        _, err = job["oracle"].communicate()
        if job["oracle"].returncode != 0:
            raise RuntimeError(f"oracle encode of {job['tag']} failed: "
                               f"{err.decode()[-300:]}")
        job["oracle_s"] = time.perf_counter() - job["t0"]


def halfpel_share(stream: bytes, fmt: int) -> float:
    """Share of the stream's inter MBs whose vector has an odd (half-pel)
    component, from the C++ parser."""
    from video_encoder_tpu_torch.codec import bitstream, native

    info, packets = bitstream.demux(io.BytesIO(stream))
    nby, nbx = -(-info.height // 16), -(-info.width // 16)
    inter = odd = 0
    for pkt in packets:
        if pkt.frame_type == 0:
            continue
        _, dy, dx, is_inter, _ = native.parse_frame(
            pkt.payload, pkt.payload_bits, True, pkt.base_qp, nby, nbx, fmt)
        inter += int(is_inter.sum())
        odd += int((((dy & 1) | (dx & 1)) != 0)[is_inter].sum())
    return odd / max(inter, 1)


def encode_argv(job, out_path, extra=(), device=None):
    """The port CLI's encode arguments for a job's raw file with its mode's
    flags plus `extra`."""
    m, w, h, gop = (job[k] for k in ("mode", "w", "h", "gop"))
    return ["encode", "-i", job["raw"], "-W", str(w), "-H", str(h),
            "-o", out_path, "--gop", str(gop), "--qp", "28",
            "--search", m["search"], "--format", str(m["fmt"]),
            "--rc", m["rc"], "--kbps", str(m["kbps"]),
            "--vbv-kbits", str(m["vbv_kbits"]),
            "--chroma-qp-offset", str(m["cqpo"]),
            "--quant-bias", str(m["qbias"]), "--intra-slice", str(m["islice"]),
            "--device", device or DEVICE, *extra
            ] + (["--quant-matrix"] if m["qmat"] else [])


def run_cli(job, out_path, extra=(), device=None):
    """One in-process CLI encode of a job's raw file with its mode's flags
    plus `extra`; the launch counts are zeroed just before and read just
    after. Returns (launches, CLI summary, stream bytes)."""
    from video_encoder_tpu_torch import cli
    from video_encoder_tpu_torch.ops.kernels import build

    argv = encode_argv(job, out_path, extra, device)
    build.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    launches = dict(build.LAUNCHES)
    if rc != 0:
        raise RuntimeError(f"port encode {' '.join(extra)} exited {rc}")
    with open(out_path, "rb") as f:
        stream = f.read()
    return launches, json.loads(out.getvalue().strip().splitlines()[-1]), stream


def same_stream(tag, a, b, other):
    if a != b:
        i = next((k for k in range(min(len(a), len(b))) if a[k] != b[k]),
                 min(len(a), len(b)))
        raise AssertionError(f"{tag}: port stream ({len(a)} B) differs from "
                             f"{other} ({len(b)} B) at byte {i}")


def decoded_psnr_y(job, stream_path):
    """PSNR-Y of the oracle's decode of a stream against the job's clip;
    raises under the floor."""
    w, h, n = job["w"], job["h"], job["n"]
    subprocess.run([ORACLE_BIN, "decode", stream_path, job["dec"]],
                   check=True, capture_output=True)
    dy = np.fromfile(job["dec"], np.uint8).reshape(n, h * w * 3 // 2)[:, :h * w]
    src = np.stack(job["clip"][0]).reshape(n, h * w).astype(np.float64)
    mse = float(((dy.astype(np.float64) - src) ** 2).mean())
    psnr_y = 10 * np.log10(255.0 ** 2 / mse)
    if not (np.isfinite(psnr_y) and psnr_y > PSNR_FLOOR):
        raise AssertionError(f"{job['tag']}: decoded PSNR-Y {psnr_y:.3f} dB")
    return psnr_y


def phase_slice(job, card):
    """Port CLI encode on the card vs the C++ oracle, byte for byte.
    Returns (launches of this path, CLI summary, stream)."""
    from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

    m, n, gop, tag = (job[k] for k in ("mode", "n", "gop", "tag"))
    launches, summary, a = run_cli(job, job["ours"])
    check_launches(f"{tag} CLI encode", launches,
                   expected_kernels(m, GopEngine.emit, gop == 1))
    check_per_p_step(f"{tag} CLI encode", launches, "mc_predict",
                     n - -(-n // gop))
    check_row_scan(f"{tag} CLI encode", launches, m, gop)
    with open(job["theirs"], "rb") as f2:
        same_stream(tag, a, f2.read(), "the oracle's")
    psnr_y = decoded_psnr_y(job, job["theirs"])
    log(f"slice {tag}, {n} frames, format {m['fmt']}, emit {GopEngine.emit}: "
        f"port stream == oracle stream ({len(a)} bytes), oracle decode PSNR-Y "
        f"{psnr_y:.4f} dB, launches {launches}")
    log(f"  port CLI wall {summary['wall_s']} s = {summary['wall_fps']} fps "
        f"[{card}]; oracle CPU encode {job['oracle_s']:.2f} s beside the "
        f"other oracles")
    if m["fmt"] >= 4:
        share = halfpel_share(a, m["fmt"])
        log(f"  {100 * share:.2f} % of the inter MBs carry a half-pel vector")
        if share <= 0:
            raise AssertionError(f"{tag}: no half-pel vector was chosen")
    return launches, summary, a


def phase_other_emit(job, stream, card):
    """A path's clip in-process under the emit the CLI did not use: the
    same packets as the CLI's stream."""
    from video_encoder_tpu_torch.codec.bitstream import OrderedMux
    from video_encoder_tpu_torch.codec.frame import Frame
    from video_encoder_tpu_torch.ops.kernels import build
    from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

    m = job["mode"]
    emit = "chunks" if GopEngine.emit == "frame" else "frame"
    cfg = config_of(m, job["w"], job["h"], job["gop"])
    frames = [Frame.from_planes(*p) for p in zip(*job["clip"])]
    eng = GopEngine(cfg, device=DEVICE, emit=emit)
    build.reset_launches()
    packets, stats = eng.encode_gop(frames, 0)
    launches = dict(build.LAUNCHES)
    check_launches(f"{m['tag']} in-process, emit {emit}", launches,
                   expected_kernels(m, emit))
    check_row_scan(f"{m['tag']} in-process, emit {emit}", launches, m,
                   job["gop"])
    buf = io.BytesIO()
    mux = OrderedMux(buf, cfg, len(frames))
    for pkt in packets:
        mux.push(pkt)
    mux.close()
    if buf.getvalue() != stream:
        raise AssertionError(f"{m['tag']} under emit {emit} differs from the "
                             "CLI's stream")
    qps = [st.base_qp for st in stats]
    log(f"other emit: {m['tag']} in-process, emit {emit}: same stream "
        f"({len(stream)} bytes), frame qps {qps}, launches {launches}")
    if m["rc"] != "none" and len(set(qps)) < 2:
        raise AssertionError(f"{m['tag']}: the rate control never moved qp")
    return launches


def graph_key_name(key) -> str:
    """A GopGraph's key as the speed lines print it: the luma shape and
    the block and frame word budgets (the rest is the cell's config)."""
    return ("x".join(map(str, key.y_shape))
            + f"/bw{key.block_words}/cap{key.cap_words}")


def phase_graphs(jobs, streams, card):
    """The GOP engine's graphs (GopGraph) on the three 1080p clips: one
    engine per clip encodes the clip's 30-frame GOP three times, the
    eager loop (a key's first call), the capture and its replay, then a
    replay; each time the CLI's stream (the oracle's) with the same
    launch counts. Then two GOPs in flight (the clip and the clip run
    backwards, the second launched before the first is finished), each
    equal to its own eager encode, and one replay traced: its kernels
    appear under their own names. Returns the launch counts of each
    run."""
    from video_encoder_tpu_torch.codec.bitstream import demux
    from video_encoder_tpu_torch.codec.frame import Frame
    from video_encoder_tpu_torch.ops.kernels import build
    from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

    paths = []
    for name in ("full", "config3", "v4"):
        job = jobs[name]
        m, n = job["mode"], job["n"]
        cfg = config_of(m, job["w"], job["h"], job["gop"])
        frames = [Frame.from_planes(*p) for p in zip(*job["clip"])]
        want = [p.to_bytes() for p in demux(io.BytesIO(streams[name]))[1]]
        eng = GopEngine(cfg, device=DEVICE)
        runs = []
        for call in ("eager", "capture", "replay"):
            build.reset_launches()
            got = [p.to_bytes() for p in eng.encode_gop(frames, 0)[0]]
            runs.append(dict(build.LAUNCHES))
            if got != want:
                raise AssertionError(f"{job['tag']} graph {call}: packets "
                                     "differ from the CLI's stream")
            check_launches(f"{job['tag']} graph {call}", runs[-1],
                           expected_kernels(m, GopEngine.emit))
        if runs[1] != runs[0] or runs[2] != runs[0]:
            raise AssertionError(f"{job['tag']}: launches per GOP eager "
                                 f"{nonzero(runs[0])}, under the graph "
                                 f"{nonzero(runs[1])}, {nonzero(runs[2])}")
        paths += runs
        graphs = {graph_key_name(k): round(g.capture_s, 3)
                  for k, g in eng.graphs.items() if g is not None}
        if not graphs:
            raise AssertionError(f"{job['tag']}: no graph was captured")
        # two GOPs in flight: the second launched before the first drains
        back = frames[::-1]
        want_back = [p.to_bytes() for p in
                     GopEngine(cfg, device=DEVICE).encode_gop(back, 0)[0]]
        build.reset_launches()
        first = eng.start([frames], [0])
        second = eng.start([back], [0])
        if ([p.to_bytes() for p in eng.finish(first)[0][0]] != want
                or [p.to_bytes() for p in eng.finish(second)[0][0]]
                != want_back):
            raise AssertionError(f"{job['tag']}: two GOPs in flight did not "
                                 "keep their own outputs")
        paths.append(dict(build.LAUNCHES))
        # one replay traced: the graph's kernels under their own names
        y, cb, cr = first.y, first.cb, first.cr
        build.reset_launches()
        ops, busy, top = device_ops(lambda: eng.run(y, cb, cr, 28), n,
                                    CODE_KERNELS + SAD_KERNELS)
        replay = dict(build.LAUNCHES)
        paths.append(replay)
        named = {k: sum(c for nm, c, _ in top[1:] if k in nm)
                 for k in (*SAD_KERNELS, *CODE_KERNELS)}
        named = {k: c for k, c in named.items() if c}
        if (not any(k in named for k in SAD_KERNELS)
                or not any(k in named for k in CODE_KERNELS)):
            raise AssertionError(f"{job['tag']}: a replay's trace names no "
                                 f"search or code_plane kernel: {top}")
        log(f"graphs {job['tag']}: eager, capture+replay and replay each == "
            f"the CLI's stream ({len(streams[name])} bytes) with the same "
            f"launches ({nonzero(runs[0])}); two GOPs in flight each == its "
            f"own eager encode; captures (s) {graphs}; one replay traced: "
            f"{ops if ops is None else round(ops, 1)} device ops/frame, busy "
            f"{busy if busy is None else round(100 * busy, 1)} %, kernels by "
            f"name (trace) {named} against launches {nonzero(replay)}; "
            f"{mem()} [{card}]")
    return paths


# the decode engines of phase 4, as the CLI's flags: the device engines,
# then the C++ decoder serial and GOP-parallel
DECODES = {"gop": ["--engine", "gop"], "device": ["--engine", "device"],
           "native1": ["--engine", "native", "--workers", "1"],
           "native0": ["--workers", "0"], "native3": ["--workers", "3"]}


# what the CLI's native decode prints where the C++ library cannot be
# loaded and it decodes with the golden model instead
NATIVE_FALLBACK = "warning: native lib unavailable, using golden"


def run_decode(job, out_path, flags):
    """One in-process CLI decode of a job's port stream; the launch counts
    are zeroed just before and read just after. Raises if the CLI fell
    back to the golden model. Returns (launches, CLI summary)."""
    from video_encoder_tpu_torch import cli
    from video_encoder_tpu_torch.ops.kernels import build

    device = ["--device", DEVICE] if "--engine" in flags[:1] and \
        flags[1] in ("gop", "device") else []
    build.reset_launches()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["decode", "-i", job["ours"], "-o", out_path, *flags,
                       *device])
    launches = dict(build.LAUNCHES)
    sys.stderr.write(err.getvalue())
    if rc != 0:
        raise RuntimeError(f"port decode {' '.join(flags)} of {job['tag']} "
                           f"exited {rc}")
    if NATIVE_FALLBACK in err.getvalue():
        raise AssertionError(f"port decode {' '.join(flags)} of {job['tag']} "
                             "fell back to the golden model")
    return launches, json.loads(out.getvalue().strip().splitlines()[-1])


def decode_launches(m, n, gop, device: bool):
    """The launch counts of a decode of n frames at GOP gop: on the device
    engines mc_predict once per P frame, recon_plane three times per P
    frame and, at formats 1-2, per I frame, recon_plane_rows three times
    per I frame at formats 3-4, nothing else (no single-plane fetch, no
    stripe); the C++ decoder launches nothing."""
    n_i = -(-n // gop)
    n_p = n - n_i
    if not device:
        return {}
    want = {"mc_predict": n_p,
            "recon_plane": 3 * n_p + (3 * n_i if m["fmt"] < 3 else 0),
            "recon_plane_rows": 3 * n_i if m["fmt"] >= 3 else 0}
    return {k: v for k, v in want.items() if v}


def decode_graph_calls(n, gop, engine):
    """The GraphCache calls of a decode of n frames at GOP gop through
    the CLI (a fresh engine), as graph_calls() counts them. The GOP
    decoder: one key for the full GOPs (the first eager, the second the
    capture, the rest replays) and one for a tail (eager). The per-frame
    decoder: one key for the I frames and one for the P frames (a P frame
    with a reference), each eager, captured, then replayed. The C++
    decoders make none."""
    if engine not in ("gop", "device"):
        return {}
    if engine == "gop":
        name, keys = "DecodeKey", [n // gop] + ([1] if n % gop else [])
    else:
        n_i = -(-n // gop)
        name, keys = "DecodeFrameKey", [n_i, n - n_i]
    want = {}
    for what, k in (("eager", sum(c > 0 for c in keys)),
                    ("capture", sum(c > 1 for c in keys)),
                    ("replay", sum(max(c - 2, 0) for c in keys))):
        if k:
            want[f"{name}/{what}"] = k
    return want


def check_decode_graphs(what, calls, want):
    got = {k: v for k, v in calls.items() if k != "capture_s"}
    if got != want:
        raise AssertionError(f"{what}: graph calls {got}, want {want}")


def phase_decode(tmp, jobs, card):
    """Every stream of the single-GOP paths decoded by the port CLI under
    each engine of DECODES, in-process, each file byte-identical to the C++
    oracle's decode of the same stream (job["dec"], written by
    decoded_psnr_y), each device decode through the kernels of the
    decode path and nothing else, and through the decoders' graphs where
    a key recurs (decode_graph_calls: the 640x360 GOP-1 stream's GOPs 3-30
    and the format-3 stream's GOP 3 replay, and the per-frame decoder's
    frames from the third of a key on). Returns (launches of each decode, CLI
    summaries by (job, engine), launches per decoded frame of the device
    engines by counter)."""
    paths, summaries = [], {}
    dev_launches, dev_frames = {}, 0
    for name, job in jobs.items():
        m, n, gop = job["mode"], job["n"], job["gop"]
        with open(job["dec"], "rb") as f:
            want = f.read()
        for engine, flags in DECODES.items():
            out_path = os.path.join(tmp, f"port_dec_{job['tag']}_{engine}.yuv")
            with graph_calls() as calls:
                launches, summary = run_decode(job, out_path, flags)
            with open(out_path, "rb") as f:
                got = f.read()
            os.remove(out_path)
            if got != want:
                raise AssertionError(
                    f"decode {engine} of {job['tag']}: {len(got)} bytes differ "
                    f"from the oracle's decode ({len(want)} bytes)")
            moved = {k: v for k, v in launches.items() if v}
            expect = decode_launches(m, n, gop, engine in ("gop", "device"))
            if moved != expect:
                raise AssertionError(f"decode {engine} of {job['tag']}: "
                                     f"launches {moved}, want {expect}")
            check_decode_graphs(f"decode {engine} of {job['tag']}", calls,
                                decode_graph_calls(n, gop, engine))
            paths.append(launches)
            summaries[(name, engine)] = summary
            if expect:
                dev_frames += n
                for k, v in moved.items():
                    dev_launches[k] = dev_launches.get(k, 0) + v
            log(f"decode {job['tag']} {' '.join(flags)}: == oracle "
                f"decode ({len(want)} bytes, {summary['frames']} frames), "
                f"launches {moved}, graph calls {calls}, CLI wall "
                f"{summary['fps']} fps [{card}]")
    per_frame = {k: v / max(dev_frames, 1) for k, v in dev_launches.items()}
    log(f"decode: launches per decoded frame of the device engines, "
        f"{dev_frames} frames: {per_frame}")
    return paths, summaries, per_frame


def phase_decode_graphs(tmp, plains, batched_oracle, card):
    """The 1080p GOP-10 streams of the batched paths (30 frames, three
    GOPs) decoded by the port CLI under `--engine gop` (GOP 1 eager, GOP 2
    the capture, GOP 3 a replay) and `--engine device` (frames 0 and 1
    eager, the P key captured at frame 2 and the I key at frame 10, every
    later frame a replay), each through its graphs and under
    eager_paths() in turns (graph, eager): config 3 unbatched (the
    oracle's stream) against the oracle's decode, full search and format
    4 (the port's unbatched streams, which the `--gop-batch 3` streams
    equal) against `--engine native`'s decode. Each file byte-identical
    to its referee, the launches the same eager and replayed, the graph
    calls as decode_graph_calls says; the counts and capture seconds are
    printed. Returns the launch counts of each decode."""
    paths = []
    with open(batched_oracle["theirs"], "rb") as f:
        streams = [(batched_oracle, f.read(), batched_oracle["dec"])]
    streams += [(job, stream, None) for job, stream in plains.values()]
    for job, stream, dec in streams:
        m, n, gop, tag = job["mode"], job["n"], job["gop"], job["tag"]
        job = dict(job, ours=os.path.join(tmp, f"decode_{tag}.tvc"))
        with open(job["ours"], "wb") as f:
            f.write(stream)
        referee = "the oracle's decode"
        if dec is None:
            referee = "the native decode"
            dec = os.path.join(tmp, f"native_dec_{tag}.yuv")
            paths.append(run_decode(job, dec, DECODES["native1"])[0])
        with open(dec, "rb") as f:
            want = f.read()
        for engine in ("gop", "device"):
            moved = {}
            for loop in ("graph", "eager"):
                out_path = os.path.join(tmp, f"graph_dec_{tag}_{engine}.yuv")
                with graph_calls() as calls, (
                        eager_paths() if loop == "eager"
                        else contextlib.nullcontext()):
                    launches, summary = run_decode(job, out_path,
                                                   DECODES[engine])
                with open(out_path, "rb") as f:
                    got = f.read()
                os.remove(out_path)
                if got != want:
                    raise AssertionError(
                        f"decode {engine} ({loop}) of {tag}: {len(got)} "
                        f"bytes differ from {referee} ({len(want)} bytes)")
                moved[loop] = nonzero(launches)
                expect = decode_launches(m, n, gop, True)
                if moved[loop] != expect:
                    raise AssertionError(
                        f"decode {engine} ({loop}) of {tag}: launches "
                        f"{moved[loop]}, want {expect}")
                graphs = decode_graph_calls(n, gop, engine)
                if loop == "eager":         # every call eager
                    graphs = ({"DecodeKey/eager": -(-n // gop)}
                              if engine == "gop"
                              else {"DecodeFrameKey/eager": n})
                check_decode_graphs(f"decode {engine} ({loop}) of {tag}",
                                    calls, graphs)
                paths.append(launches)
                log(f"decode {tag} --engine {engine} ({loop}): == {referee} "
                    f"({len(want)} bytes, {summary['frames']} frames), "
                    f"launches {moved[loop]}, graph calls {calls}, CLI wall "
                    f"{summary['fps']} fps [{card}]")
            if moved["graph"] != moved["eager"]:
                raise AssertionError(f"decode {engine} of {tag}: launches "
                                     f"{moved['graph']} through the graphs, "
                                     f"{moved['eager']} eager")
    return paths


def cli_child(argv) -> int:
    """`chip_smoke.py --cli-child ARGS`: the port CLI's main(ARGS) in this
    process, its output as it prints it, then one line `CHILD {json}` with
    the launch counts that moved and whether this process initialised
    CUDA. phase_golden runs its host jobs this way, side by side."""
    from video_encoder_tpu_torch import cli
    from video_encoder_tpu_torch.ops.kernels import build

    build.reset_launches()
    rc = cli.main(argv)
    print("CHILD " + json.dumps(dict(
        launches={k: v for k, v in build.LAUNCHES.items() if v},
        cuda_initialized=torch.cuda.is_initialized())), flush=True)
    return rc


def phase_golden(tmp, jobs, hier_oracle, card):
    """The golden model through the port CLI (`--engine golden`), on the
    host's CPU: the GOP-1 and format-2 640x360 clips, each equal to the
    oracle's stream of the same flags; `--search hier` on the format-2
    clip at format 1, GOP 12, equal to the oracle's hier stream; `--rc mb
    --kbps 3000` on it, equal to the GOP engine's stream of the same flags
    on the card; `decode --engine golden` of the format-2, format-3 and
    GOP-1 streams, each equal to the oracle's decode. The golden jobs run
    side by side, one child process each (`--cli-child`), and must launch
    no kernel and leave CUDA uninitialised; the GOP engine's encode runs
    here meanwhile. Returns the launches of that GOP-engine encode."""
    from video_encoder_tpu_torch.codec import native
    from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

    if not native.available():
        raise AssertionError("golden: the C++ library did not load")
    v2 = jobs["v2"]
    mb_job = dict(v2, mode=MB_SMALL,
                  tag=f"{v2['w']}x{v2['h']}_gop{v2['gop']}_mb")
    encodes = {"gop1": jobs["intra"], "v2": jobs["v2"], "hier": hier_oracle,
               "mb": mb_job}
    children = {}
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    for name, job in encodes.items():
        out = os.path.join(tmp, f"golden_{job['tag']}.tvc")
        argv = encode_argv(job, out, ["--engine", "golden"])
        children[name] = (out, argv)
    for name in ("v2", "v3", "intra"):
        out = os.path.join(tmp, f"golden_dec_{jobs[name]['tag']}.yuv")
        children["dec_" + name] = (out, ["decode", "-i", jobs[name]["ours"],
                                         "-o", out, "--engine", "golden"])
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--cli-child",
         *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, (_, argv) in children.items()}
    # meanwhile the GOP engine encodes the rc-mb job on the card
    launches, gop_summary, gop_mb = run_cli(
        mb_job, os.path.join(tmp, "gop_mb.tvc"))
    check_launches("golden phase: GOP engine rc mb", launches,
                   expected_kernels(MB_SMALL, GopEngine.emit))
    results = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"golden {name} exited {proc.returncode}: "
                               f"{stderr[-1500:]}")
        lines = stdout.strip().splitlines()
        child = json.loads(lines[-1].split(" ", 1)[1])
        if child["launches"] or child["cuda_initialized"]:
            raise AssertionError(f"golden {name} touched the card: {child}")
        if NATIVE_FALLBACK in stderr:
            raise AssertionError(f"golden {name}: the native fallback ran")
        results[name] = json.loads(lines[-2])
    wall = time.perf_counter() - t0
    want = {"gop1": jobs["intra"]["theirs"], "v2": jobs["v2"]["theirs"],
            "hier": hier_oracle["theirs"]}
    for name, job in encodes.items():
        with open(children[name][0], "rb") as f:
            got = f.read()
        if name == "mb":
            same_stream("golden rc mb", got, gop_mb,
                        "the GOP engine's stream on the card")
            other = f"the GOP engine's on the card ({gop_summary['wall_fps']} fps)"
        else:
            with open(want[name], "rb") as f:
                same_stream(f"golden {name}", got, f.read(), "the oracle's")
            other = "the oracle's"
        r = results[name]
        log(f"golden encode {job['tag']} ({r['frames']} frames, search "
            f"{job['mode']['search']}, rc {job['mode']['rc']}, format "
            f"{job['mode']['fmt']}): == {other} ({len(got)} bytes); host "
            f"wall {r['wall_s']} s = {r['wall_fps']} fps on the CPU "
            f"({os.cpu_count()} host cores, {len(procs)} jobs side by side) "
            f"[{card}]")
    for name in ("v2", "v3", "intra"):
        out = children["dec_" + name][0]
        with open(out, "rb") as f, open(jobs[name]["dec"], "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"golden decode of {jobs[name]['tag']} "
                                     "differs from the oracle's decode")
        r = results["dec_" + name]
        log(f"golden decode {jobs[name]['tag']} ({r['frames']} frames): == "
            f"oracle decode; host wall {r['wall_s']} s = {r['fps']} fps on "
            f"the CPU ({os.cpu_count()} host cores) [{card}]")
    log(f"golden: {len(procs)} host jobs, no kernel launched, CUDA never "
        f"initialised in them, native.available() True; phase wall "
        f"{wall:.1f} s [{card}]")
    return launches


def phase_speed_decode(cells, summaries, card):
    """1080p decode rates of the port's device path, per stream: the GOP
    engine with the GOP uploaded once (run, sync once), through the GOP
    key's graph and through the eager loop (eager_paths()) in turns
    (graph, eager, eager, graph; three GOPs a turn), each with its host
    calls per GOP (the CUDA calls that submit work), device ops per frame
    and busy share (traced, and the traced device time over the untraced
    wall) from torch.profiler, and the key's capture seconds; then with
    its parse and download (decode_gop_start and _finish), graph and
    eager; the host stages of a GOP on their own (parse, upload,
    download), and the CLI wall rates of phase 4 beside
    os.cpu_count()."""
    from video_encoder_tpu_torch.codec import bitstream
    from video_encoder_tpu_torch.pipeline import decoder

    results = {}
    for name, job in cells:
        m = job["mode"]
        with open(job["ours"], "rb") as f:
            info, packets = bitstream.demux(io.BytesIO(f.read()))
        packets = list(packets)
        if len(packets) != info.gop_n:
            raise AssertionError(f"{name}: one GOP expected")
        eng = decoder.GopDecodeEngine(info.version, info.chroma_qp_offset,
                                      info.quant_matrix,
                                      info.intra_slice_mbrows, device=DEVICE)
        n = len(packets)
        iters = 3
        # the GOP's host stages on their own, each the mean of iters runs:
        # the threaded parse, the upload, the download of the decoded bytes
        # (the runs between them are the key's eager call, its capture and
        # a replay)
        stage_ms = dict(parse=0.0, upload=0.0, download=0.0)
        with graph_calls() as calls:
            for _ in range(iters):
                t0 = time.perf_counter()
                host = eng.parse(info.width, info.height, packets)
                t1 = time.perf_counter()
                dev_gop = eng.upload(host)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                out = eng.run(dev_gop)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                out.cpu()
                t4 = time.perf_counter()
                for k, dt in (("parse", t1 - t0), ("upload", t2 - t1),
                              ("download", t4 - t3)):
                    stage_ms[k] += 1e3 * dt / iters
        check_decode_graphs(f"decode speed {job['tag']}", calls, {
            "DecodeKey/eager": 1, "DecodeKey/capture": 1,
            "DecodeKey/replay": 1})
        upload_mb = sum(t.numel() * t.element_size()
                        for t in dev_gop.values()
                        if isinstance(t, torch.Tensor)) / 1e6

        def loop_of(loop):
            return (eager_paths() if loop == "eager"
                    else contextlib.nullcontext())

        def resident(loop):
            with loop_of(loop):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    eng.run(dev_gop)
                torch.cuda.synchronize()
                return iters * n / (time.perf_counter() - t0)

        def with_parse(loop):
            with loop_of(loop):
                t0 = time.perf_counter()
                for _ in range(iters):
                    eng.decode_gop_finish(eng.decode_gop_start(
                        info.width, info.height, packets))
                return iters * n / (time.perf_counter() - t0)

        rates = {"graph": [], "eager": []}
        full = {"graph": [], "eager": []}
        for loop in ("graph", "eager", "eager", "graph"):
            rates[loop].append(resident(loop))
            full[loop].append(with_parse(loop))
        fig = {}
        for loop in ("graph", "eager"):
            def once(loop=loop):
                with loop_of(loop):
                    eng.run(dev_gop)

            f = loop_figures(once, n, ("recon", "mc_predict"))
            f.update(resident=sum(rates[loop]) / len(rates[loop]),
                     with_parse=sum(full[loop]) / len(full[loop]))
            f["busy_of_wall"] = busy_of_wall(f, n)
            fig[loop] = f
        cli_fps = {e: summaries[(name, e)]["fps"]
                   for e in ("gop", "device", "native1", "native0")}
        g, e = fig["graph"], fig["eager"]
        results[m["tag"]] = dict(
            resident=g["resident"], with_parse=g["with_parse"],
            host_calls_per_gop=g["calls"], ops_per_frame=g["ops"],
            busy=g["busy"], busy_of_wall=g["busy_of_wall"],
            eager_resident=e["resident"], eager_with_parse=e["with_parse"],
            eager_host_calls_per_gop=e["calls"], eager_ops_per_frame=e["ops"],
            eager_busy=e["busy"], eager_busy_of_wall=e["busy_of_wall"],
            capture_s=calls["capture_s"], cli=cli_fps, stage_ms=stage_ms,
            upload_mb=upload_mb)
        for loop, f in fig.items():
            log(f"speed: decode {job['tag']} GOP engine {loop}: "
                f"device-resident {f['resident']:.3f} fps (turns "
                f"{[round(r, 3) for r in rates[loop]]}), with parse and "
                f"download {f['with_parse']:.3f} fps; one GOP traced: "
                f"{fmt_figures(f)} [{card}]")
            log(f"  device ms per GOP by name (launches, ms): {f['top']}")
        log(f"  decode {job['tag']}: capture s {calls['capture_s']}; host "
            f"stages per GOP (ms) {stage_ms} ({upload_mb:.1f} MB uploaded); "
            f"CLI wall fps {cli_fps} on {os.cpu_count()} host cores [{card}]")
    return results


def check_batched_launches(what, launches, m, emit, steps, tail=False):
    """A lockstep run's counters: every `_g` kernel of the path launched;
    without a tail no single-plane kernel did; the folded block pack ran
    once per plane and frame step (twice under rc mb, whose first pass
    packs for its bit counts) and each span merge once per frame step."""
    check_launches(what, launches, expected_kernels(m, emit, batched=True))
    check_per_p_step(what, launches, "mc_predict_g", steps - 1)
    check_row_scan(what, launches, m, steps, batched=True)
    if tail:
        check_launches(what + " (tail)", launches, expected_kernels(m, emit))
        return
    single = [k for k, v in launches.items()
              if v and not k.endswith("_g") and k not in FOLDED]
    if single:
        raise AssertionError(f"{what}: single-plane kernels ran: {single}")
    packs = launches["block_pack"] + launches["block_pack_v2"]
    want = 3 * steps * (2 if m["rc"] == "mb" else 1)
    merges = steps if emit == "chunks" else 0
    if packs != want or launches["span_merge_mb"] != merges:
        raise AssertionError(
            f"{what}: block_pack launched {packs} times (one per plane and "
            f"frame step is {want}), span_merge_mb "
            f"{launches['span_merge_mb']} times (want {merges})")


def phase_batched(tmp, jobs, batched_oracle, card):
    """The batched-GOP paths through the port CLI at 1920x1080: three GOPs
    of 10 frames in one lockstep encode (`--gop 10 --gop-batch 3`).
    Returns the launch counts of each path."""
    from video_encoder_tpu_torch.codec.bitstream import OrderedMux
    from video_encoder_tpu_torch.codec.frame import Frame
    from video_encoder_tpu_torch.ops.kernels import build
    from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

    emit = GopEngine.emit
    paths, plains = [], {}

    def batched(job, g, tail=False):
        steps = job["gop"]
        out = os.path.join(tmp, f"batched_{job['tag']}.tvc")
        launches, summary, stream = run_cli(job, out, ["--gop-batch", str(g)])
        check_batched_launches(f"{job['tag']} --gop-batch {g}", launches,
                               job["mode"], emit, steps, tail)
        paths.append(launches)
        return launches, summary, stream, out

    # config 3 against the oracle's stream of the same GOP length
    job = batched_oracle
    launches, summary, stream, out = batched(job, 3)
    with open(job["theirs"], "rb") as f:
        same_stream(job["tag"] + " batched", stream, f.read(), "the oracle's")
    psnr_y = decoded_psnr_y(job, out)
    log(f"batched {job['tag']} --gop-batch 3: port stream == oracle stream "
        f"({len(stream)} bytes), oracle decode PSNR-Y {psnr_y:.4f} dB, CLI wall "
        f"{summary['wall_fps']} fps [{card}], launches {launches}")
    # ... and unbatched: three GOPs of 10, GOP k + 1 launched before GOP k
    # is drained, GOPs 2 and 3 through the graph
    launches, summary, stream = run_cli(
        job, os.path.join(tmp, f"plain_{job['tag']}.tvc"))
    check_launches(f"{job['tag']} CLI encode", launches,
                   expected_kernels(job["mode"], emit))
    with open(job["theirs"], "rb") as f:
        same_stream(job["tag"] + " unbatched", stream, f.read(), "the oracle's")
    paths.append(launches)
    log(f"unbatched {job['tag']} (double-buffered, GOPs 2-3 graph replays): "
        f"port stream == oracle stream ({len(stream)} bytes), CLI wall "
        f"{summary['wall_fps']} fps [{card}], launches {launches}")

    # full search and format 4 against the port's own unbatched streams
    for name in ("full", "v4"):
        job = dict(jobs[name], gop=10, tag=jobs[name]["tag"].replace(
            "gop30", "gop10"))
        _, plain_summary, plain = run_cli(
            job, os.path.join(tmp, f"plain_{job['tag']}.tvc"))
        plains[name] = (job, plain)
        launches, summary, stream, _ = batched(job, 3)
        same_stream(job["tag"] + " batched", stream, plain,
                    "the port's unbatched stream")
        log(f"batched {job['tag']} --gop-batch 3: == the unbatched stream "
            f"({len(stream)} bytes), CLI wall {summary['wall_fps']} fps against "
            f"{plain_summary['wall_fps']} fps unbatched [{card}], launches "
            f"{launches}")
    # ... and format 4 under the other emit, in-process
    other = "chunks" if emit == "frame" else "frame"
    cfg = config_of(job["mode"], job["w"], job["h"], 10)
    frames = [Frame.from_planes(*p) for p in zip(*job["clip"])]
    eng = GopEngine(cfg, device=DEVICE, emit=other)
    build.reset_launches()
    results = eng.finish(eng.start(
        [frames[0:10], frames[10:20], frames[20:30]], [0, 10, 20]))
    launches = dict(build.LAUNCHES)
    check_batched_launches(f"{job['tag']} in-process, emit {other}", launches,
                           job["mode"], other, 10)
    paths.append(launches)
    buf = io.BytesIO()
    mux = OrderedMux(buf, cfg, len(frames))
    for packets, _ in results:
        for pkt in packets:
            mux.push(pkt)
    mux.close()
    same_stream(f"{job['tag']} batched, emit {other}", buf.getvalue(), stream,
                "the CLI's batched stream")
    log(f"batched {job['tag']} in-process, emit {other}: same stream, "
        f"launches {launches}")

    # a tail: 30 frames at GOP 12 are a batch of two GOPs and a short one
    job = dict(jobs["config3"], gop=12, tag=jobs["config3"]["tag"].replace(
        "gop30", "gop12"))
    _, _, plain = run_cli(job, os.path.join(tmp, f"plain_{job['tag']}.tvc"))
    launches, summary, stream, _ = batched(job, 2, tail=True)
    same_stream(job["tag"] + " batched with a tail", stream, plain,
                "the port's unbatched stream")
    log(f"batched {job['tag']} --gop-batch 2 (two GOPs in lockstep, then a "
        f"short GOP of 6): == the unbatched stream ({len(stream)} bytes), "
        f"launches {launches}")
    return paths, plains


def check_per_frame_launches(what, launches, m, n, gop):
    """The per-frame engine's counters for n frames at GOP length gop:
    the search (or the even map and the descent) and mc_predict once per P
    frame, code_plane three times per frame, and nothing else (no
    block_pack, span merge or single-plane fetch)."""
    p_frames = n - -(-n // gop)
    want = {"mc_predict": p_frames, "code_plane": 3 * n}
    for k in (["full_search"] if m["search"] == "full"
              else ["sad_map_even", "diamond_descent"]):
        want[k] = p_frames
    got = nonzero(launches)
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")


def nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def phase_per_frame(tmp, jobs, summaries, card):
    """The per-frame engine (`encode --engine device`) at 1920x1080, each
    run through its graphs (frames 0 and 1 eager, frame 2 the capture of
    the P key, the later P frames replays) and through the eager path
    (eager_paths()), in turns: the full-search clip (graph, eager, eager,
    graph) against the oracle's stream, and the config-3 texture at
    diamond search under rc bitrate (12000 kbps) and rc adaptive (graph,
    eager), each against the GOP engine's stream of the same flags; the
    launches of each graph run equal to its eager run's. Then one 1080p P
    frame traced through its replay and eagerly: device ops and host
    calls. Returns the launch counts of each path and the figures."""
    from video_encoder_tpu_torch.codec.frame import Frame
    from video_encoder_tpu_torch.pipeline.device_engine import DeviceEngine

    paths = []

    def device_runs(job, m, want, other, loops):
        """The job's `--engine device` encode once per loop in loops, each
        equal to `want`; (launches, {loop: [wall fps]}, graph calls)."""
        walls, launches, graph_calls_of = {}, {}, None
        for i, loop in enumerate(loops):
            out = os.path.join(tmp, f"device_{job['tag']}_{i}.tvc")
            with graph_calls() as calls, (eager_paths() if loop == "eager"
                                          else contextlib.nullcontext()):
                got, summary, stream = run_cli(job, out, ["--engine", "device"])
            what = f"{job['tag']} --engine device ({loop})"
            check_per_frame_launches(what, got, m, job["n"], job["gop"])
            same_stream(what, stream, want, other)
            if launches.setdefault(loop, got) != got:
                raise AssertionError(f"{what}: launches differ between runs")
            if loop == "graph" and not calls.get("FrameKey/replay"):
                raise AssertionError(f"{what}: no frame replayed ({calls})")
            if loop == "eager" and set(calls) != {"FrameKey/eager"}:
                raise AssertionError(f"{what}: a graph was used ({calls})")
            paths.append(got)
            walls.setdefault(loop, []).append(summary["wall_fps"])
            if loop == "graph":
                graph_calls_of = calls
            log(f"per-frame {job['tag']} --engine device --search "
                f"{m['search']} --rc {m['rc']} ({loop}): == {other} "
                f"({len(stream)} bytes), CLI wall {summary['wall_fps']} fps "
                f"[{card}], graph calls {calls}, launches {nonzero(got)}")
        if launches["graph"] != launches["eager"]:
            raise AssertionError(f"{job['tag']}: launches under the graph "
                                 f"{nonzero(launches['graph'])}, eager "
                                 f"{nonzero(launches['eager'])}")
        return walls, graph_calls_of

    fps = {}
    job = jobs["full"]
    with open(job["theirs"], "rb") as f:
        oracle = f.read()
    walls, calls = device_runs(job, job["mode"], oracle, "the oracle's stream",
                               ("graph", "eager", "eager", "graph"))
    fps["full"] = dict(graph=walls["graph"], eager=walls["eager"],
                       gop_engine=summaries["full"]["wall_fps"],
                       graph_calls=calls)
    for rc in ("bitrate", "adaptive"):
        mm = dict(jobs["config3"]["mode"], rc=rc, tag=f"config3_{rc}")
        job = dict(jobs["config3"], mode=mm,
                   tag=jobs["config3"]["tag"].replace("config3", mm["tag"]))
        _, gop_summary, want = run_cli(
            job, os.path.join(tmp, f"gop_{job['tag']}.tvc"))
        walls, calls = device_runs(job, mm, want, "the GOP engine's stream",
                                   ("graph", "eager"))
        fps[mm["tag"]] = dict(graph=walls["graph"], eager=walls["eager"],
                              gop_engine=gop_summary["wall_fps"],
                              graph_calls=calls)

    # one traced P frame (its reference the recon the engine kept): a
    # replay of the P key, and the eager path
    job = jobs["full"]
    cfg = config_of(job["mode"], job["w"], job["h"], job["gop"])
    f0, f1 = (Frame.from_planes(*(c[t] for c in job["clip"])) for t in (0, 1))
    traced, engines = {}, {}
    for loop in ("graph", "eager"):
        with (eager_paths() if loop == "eager" else contextlib.nullcontext()):
            eng = engines[loop] = DeviceEngine(DEVICE)
            i_frame = eng.encode(cfg, f0, None, 0, 28)
            for _ in range(2):       # the P key's eager call, its capture
                eng.encode(cfg, f1, i_frame.recon, 1, 28)

            def p_frame():
                eng.encode(cfg, f1, i_frame.recon, 1, 28)

            f = loop_figures(p_frame, 1, CODE_KERNELS + SAD_KERNELS)
        traced[loop] = dict(ops=f["ops"], busy=f["busy"], calls=f["calls"],
                            calls_by_name=f["calls_by_name"],
                            device_ms=f["top"][0][2] if f["top"] else None)
        log(f"per-frame engine, one 1080p P frame traced ({loop}): "
            f"{fmt_figures(f)}; device ms by name (launches, ms) {f['top']} "
            f"[{card}]")
    captures = [round(v.capture_s, 3) for v in engines["graph"].graphs.values()
                if v is not None]
    if engines["eager"].graphs or len(captures) != 1:
        raise AssertionError(f"per-frame graphs: {captures} under the graph, "
                             f"{engines['eager'].graphs} eager")
    log(f"per-frame engine, the P key's capture: {captures} s [{card}]")
    return paths, dict(cli_wall_fps=fps, p_frame=traced, capture_s=captures,
                       ops_per_p_frame=traced["graph"]["ops"],
                       p_frame_device_ms=traced["graph"]["device_ms"])


def phase_aux(tmp, plains, card):
    """`--checkpoint`, `--trace` and `--stage-timers` at 1920x1080 on the
    full-search clip at GOP 10: an encode interrupted after its first GOP
    through the library, resumed by the CLI under each engine, equal to
    the uninterrupted stream with its checkpoint gone; then one traced
    encode of the clip's three GOPs (the first through the eager loop, the
    others through its graph) whose trace names the search and code_plane
    kernels more often than the eager GOP launched them and whose summary
    carries its stages. Returns the launch counts."""
    import glob

    from video_encoder_tpu_torch.pipeline import checkpoint as ckpt
    from video_encoder_tpu_torch.pipeline.device_engine import DeviceEngine
    from video_encoder_tpu_torch.pipeline.encoder import (
        PerFrameGopAdapter, encode_clip_resumable)
    from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

    job, plain = plains["full"]
    m, n, gop = job["mode"], job["n"], job["gop"]
    cfg = config_of(m, job["w"], job["h"], gop)
    paths = []
    for engine in ("gop", "device"):
        out = os.path.join(tmp, f"ckpt_{engine}.tvc")
        ck = os.path.join(tmp, f"ckpt_{engine}.json")
        eng = (GopEngine(cfg, device=DEVICE) if engine == "gop"
               else PerFrameGopAdapter(cfg, DeviceEngine(DEVICE)))

        def interrupted():
            for t, planes in enumerate(zip(*job["clip"])):
                if t == gop:
                    raise KeyboardInterrupt
                yield planes

        try:
            encode_clip_resumable(cfg, interrupted(), out, n, eng, ck)
        except KeyboardInterrupt:
            pass
        else:
            raise AssertionError("the interrupted encode ran to its end")
        state = ckpt.load(ck, cfg)
        if state is None or state.next_frame != gop:
            raise AssertionError(f"checkpoint after the first GOP: {state}")
        launches, summary, stream = run_cli(
            job, out, ["--engine", engine, "--checkpoint", ck,
                       "--stage-timers"])
        if engine == "gop":
            check_launches("--checkpoint --engine gop", launches,
                           expected_kernels(m, GopEngine.emit))
            check_per_p_step("--checkpoint --engine gop", launches,
                             "mc_predict", gop - 1)
        else:
            check_per_frame_launches("--checkpoint --engine device", launches,
                                     m, n - gop, gop)
        same_stream(f"{job['tag']} resumed --engine {engine}", stream, plain,
                    "the uninterrupted stream")
        if os.path.exists(ck):
            raise AssertionError(f"--engine {engine}: {ck} left behind")
        if sorted(summary["stages"]) != ["encode_gop", "write+checkpoint"]:
            raise AssertionError(f"checkpoint stages {summary['stages']}")
        paths.append(launches)
        log(f"checkpoint {job['tag']} --engine {engine}: interrupted after "
            f"GOP 1 (offset {state.byte_offset} bytes), resumed by the CLI: "
            f"== the uninterrupted stream ({len(stream)} bytes), checkpoint "
            f"cleared, frames {summary['frames']}, stages {summary['stages']}, "
            f"launches {nonzero(launches)} [{card}]")

    # the whole clip: GOP 1 runs the eager loop, GOPs 2 and 3 the graph
    tdir = os.path.join(tmp, "trace")
    launches, summary, stream = run_cli(
        job, os.path.join(tmp, "traced.tvc"), ["--trace", tdir,
                                                "--stage-timers"])
    check_launches("--trace", launches, expected_kernels(m, GopEngine.emit))
    paths.append(launches)
    if stream != plain:
        raise AssertionError("--trace: the traced stream differs")
    files = glob.glob(os.path.join(tdir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"--trace wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = {k: sum(k in e.get("name", "") for e in events
                      if e.get("cat") == "kernel")
               for k in ("tiled_kernel", "plane_kernel")}
    # more than the eager GOP's launches: the graph's kernels are named too
    for k, name in (("tiled_kernel", "full_search"),
                    ("plane_kernel", "code_plane")):
        if kernels[k] <= launches[name] // (n // gop):
            raise AssertionError(
                f"--trace: {kernels[k]} {k} events for {launches[name]} "
                f"launches in {n // gop} GOPs, of which the first is eager")
    if sorted(summary["stages"]) != ["drain+mux", "upload+dispatch"]:
        raise AssertionError(f"--stage-timers stages {summary['stages']}")
    log(f"trace {job['tag']} --trace --stage-timers, {n} frames in "
        f"{n // gop} GOPs (the first eager, the others replays of one "
        f"graph): {os.path.getsize(files[0])} bytes of trace, {len(names)} "
        f"event names; kernel events {kernels} against launches "
        f"full_search {launches['full_search']}, code_plane "
        f"{launches['code_plane']}; stages {summary['stages']} [{card}]")
    return paths


SEARCH_AND_FETCH = ("full_search", "sad_map_even", "sad_at_mv", "mc_predict",
                    "mc_fetch_luma", "mc_fetch_chroma")


def check_tiled_launches(what, launches, m, emit, p_steps):
    """A tile-sharded run's counters (no tail): the pre-haloed search and
    the pre-haloed predictor once per P step, the refine once per P step
    under format 4, no pre-haloed single-plane fetch; no unsharded
    search, SAD, predictor or fetch, single-plane or batched; the shards'
    planes coded by the batched code_plane."""
    want = dict(full_search_haloed=p_steps, mc_predict_haloed=p_steps,
                mc_fetch_haloed_luma=0, mc_fetch_haloed_chroma=0,
                sad_at_mv_haloed=p_steps if m["fmt"] >= 4 else 0)
    got = {k: launches[k] for k in want}
    unsharded = [k for base in SEARCH_AND_FETCH for k in (base, base + "_g")
                 if launches[k]]
    if got != want or unsharded:
        raise AssertionError(f"{what}: pre-haloed launches {got}, want {want}; "
                             f"unsharded kernels that ran: {unsharded}")
    ks = ["code_plane_qmat_g" if m["qmat"] else "code_plane_g",
          "block_pack_v2" if m["fmt"] >= 2 else "block_pack", "frame_headers"]
    check_launches(what, launches, ks + (
        ["span_merge_mb", "span_merge"] if emit == "chunks" else ["frame_place"]))
    check_row_scan(what, launches, m, p_steps + 1, batched=True)


def phase_tiled(tmp, jobs, streams, plains, card):
    """The tile-sharded paths through the port CLI at 1920x1080, every
    shard on the one card: `--tile 4` (GOP 30, full search), `--gop 10
    --gop-batch 3 --tile 2` and the format-4 clip with `--intra-slice 17
    --tile 2`, each equal to the port's unsharded stream of the same
    configuration, with a PSNR from the shards' summed sse above the
    floor. Then the multi-GOP tiled encodes whose later batches replay
    the tile loop's graph: `--gop 10 --tile 2` (GOPs 2-3 replays), equal
    to the unsharded GOP-10 stream, in turns with the same under
    eager_paths() (graph, eager, eager, graph), same stream and launches;
    and `--gop 5 --gop-batch 3 --tile 2` (two
    batches of three GOPs, the second a replay; at GOP 10 the 30 frames
    are one batch, a key's first call), equal to the port's unsharded
    GOP-5 stream. Returns the launch counts of each path."""
    from video_encoder_tpu_torch.parallel.gop_parallel import ShardedGopEncoder

    paths = []

    def tiled(job, extra, plain, p_steps, held, eager=False):
        flags = " ".join(extra) + (" (eager)" if eager else "")
        out = os.path.join(tmp, f"tiled_{job['tag']}_{len(paths)}.tvc")
        with graph_calls() as calls, (eager_paths() if eager
                                      else contextlib.nullcontext()):
            launches, summary, stream = run_cli(job, out, extra)
        same_stream(f"{job['tag']} {flags}", stream, plain,
                    "the port's unsharded stream")
        check_tiled_launches(f"{job['tag']} {flags}", launches, job["mode"],
                             ShardedGopEncoder.emit, p_steps)
        psnr = summary["mean_psnr_y"]
        if not (np.isfinite(psnr) and psnr > PSNR_FLOOR):
            raise AssertionError(f"{job['tag']} {flags}: mean PSNR-Y {psnr}")
        paths.append(launches)
        log(f"tiled {job['tag']} {flags}: == the port's unsharded stream "
            f"({len(stream)} bytes, {held}), CLI wall {summary['wall_fps']} fps, "
            f"mean PSNR-Y {summary['mean_psnr_y']} dB, graph calls {calls} "
            f"[{card}], launches {launches}")
        return launches, calls

    for job, extra, plain, p_steps, held in (
            (jobs["full"], ["--tile", "4"], streams["full"], 29,
             "held against the oracle's"),
            (plains["full"][0], ["--gop-batch", "3", "--tile", "2"],
             plains["full"][1], 9, "of --gop 10"),
            (jobs["v4i17"], ["--tile", "2"], streams["v4i17"], 29,
             "held against the oracle's")):
        tiled(job, extra, plain, p_steps, held)

    # multi-GOP: the later GOPs or batches replay the tile loop's graph;
    # graph and eager in turns (each CLI run captures anew)
    job10, plain10 = plains["full"]
    runs = {}
    for eager in (False, True, True, False):
        runs[eager] = tiled(job10, ["--tile", "2"], plain10, 27,
                            "of --gop 10", eager)
    if runs[True][0] != runs[False][0]:
        raise AssertionError(f"--gop 10 --tile 2: launches under the graph "
                             f"{nonzero(runs[False][0])}, eager "
                             f"{nonzero(runs[True][0])}")
    job5 = dict(job10, gop=5, tag=job10["tag"].replace("gop10", "gop5"))
    _, _, plain5 = run_cli(job5, os.path.join(tmp, f"port_{job5['tag']}.tvc"))
    batched = tiled(job5, ["--gop-batch", "3", "--tile", "2"], plain5, 8,
                    "of --gop 5")
    for what, (_, calls) in (("--gop 10 --tile 2", runs[False]),
                             ("--gop 5 --gop-batch 3 --tile 2", batched)):
        if not (calls.get("TileKey/capture", 0) + calls.get("TileKey/replay", 0)):
            raise AssertionError(f"{what}: no tile batch replayed a graph "
                                 f"({calls})")
    if set(runs[True][1]) != {"TileKey/eager"}:
        raise AssertionError(f"eager --tile 2 used a graph: {runs[True][1]}")
    return paths


EXHAUSTIVE = ("full_search", "full_search_g", "full_search_haloed")


def phase_sea(tmp, jobs, streams, plains, card):
    """TVC_SEA=1 on the full-search clip through the port CLI: the single
    GOP path (whose stream must also equal the oracle's), `--gop 10
    --gop-batch 3` and `--tile 4`, each byte-identical to the port's
    stream without it, through its SEA entry and no exhaustive search.
    Returns the launch counts of each path."""
    paths = []
    full, gop10 = jobs["full"], plains["full"][0]
    with sea(True):
        for job, extra, plain, entry, steps in (
                (full, [], streams["full"], "full_search_sea", 29),
                (gop10, ["--gop-batch", "3"], plains["full"][1],
                 "full_search_sea_g", 9),
                (full, ["--tile", "4"], streams["full"],
                 "full_search_sea_haloed", 29)):
            flags = " ".join(["TVC_SEA=1", *extra])
            out = os.path.join(tmp, f"sea_{job['tag']}_{len(paths)}.tvc")
            launches, summary, stream = run_cli(job, out, extra)
            same_stream(f"{job['tag']} {flags}", stream, plain,
                        "the port's stream without TVC_SEA")
            if not extra:
                with open(job["theirs"], "rb") as f:
                    same_stream(f"{job['tag']} {flags}", stream, f.read(),
                                "the oracle's")
            ran = {k: launches[k] for k in EXHAUSTIVE if launches[k]}
            if launches[entry] != steps or ran:
                raise AssertionError(f"{job['tag']} {flags}: {entry} launched "
                                     f"{launches[entry]} times (want {steps}), "
                                     f"exhaustive searches {ran}")
            paths.append(launches)
            held = "" if extra else ", == the oracle's"
            log(f"sea {job['tag']} {flags}: == the port's stream without it "
                f"({len(stream)} bytes{held}), {entry} {launches[entry]} "
                f"launches, no exhaustive search; CLI wall "
                f"{summary['wall_fps']} fps [{card}]")
    return paths


def phase_twopass(tmp, job, card):
    """Two-pass at 640x360 through the port CLI on the card: the stream of
    the port's own CPU run, decodable above the PSNR floor."""
    from video_encoder_tpu_torch.codec import bitstream

    extra = ["--two-pass"]
    launches, summary, stream = run_cli(
        job, os.path.join(tmp, "twopass_card.tvc"), extra)
    check_launches("two-pass CLI encode", launches,
                   expected_kernels(job["mode"], "frame"))
    _, _, cpu = run_cli(job, os.path.join(tmp, "twopass_cpu.tvc"), extra,
                        device="cpu")
    same_stream("two-pass", stream, cpu, "the port's --device cpu stream")
    psnr_y = decoded_psnr_y(job, os.path.join(tmp, "twopass_card.tvc"))
    packets = list(bitstream.demux(io.BytesIO(stream))[1])
    qps = [packets[i].base_qp for i in range(0, len(packets), job["gop"])]
    for i, pkt in enumerate(packets):
        if pkt.base_qp != qps[i // job["gop"]]:
            raise AssertionError(f"two-pass: frame {i} left its GOP's qp")
    log(f"two-pass {job['tag']} --kbps {job['mode']['kbps']}: card stream == "
        f"CPU stream ({len(stream)} bytes, {8 * len(stream) * 30 / job['n'] / 1e3:.0f} "
        f"kbps at 30 fps), per-GOP qps {qps} from base qp 28, oracle decode "
        f"PSNR-Y {psnr_y:.4f} dB, CLI wall {summary['wall_fps']} fps [{card}], "
        f"launches {launches}")
    return launches


def rank_launches(launches, summary):
    """A run's launch counts: this process's (the coordinator's tail and
    survivor) plus every rank's, from the summary's rank rows."""
    total = dict(launches)
    for row in summary.get("ranks") or []:
        for k, v in row["launches"].items():
            total[k] += v
    return total


def print_ranks(what, summary, tiled, card):
    """A rank run's backend, ranks, devices, wall rate, each rank's encode
    seconds and, on tile ranks, the transport per P frame."""
    rows = summary.get("ranks") or []
    log(f"  {what}: backend {summary.get('backend')}, {len(rows)} ranks on "
        f"{sorted({r['device'] for r in rows})}, CLI wall "
        f"{summary['wall_fps']} fps [{card}]")
    for r in rows:
        line = (f"    rank {r['rank']} ({r['device']}, {r['backend']}): GOPs "
                f"{r['gops']}, encode {r['encode_s']:.3f} s")
        if tiled and r["p_frames"]:
            line += (f", transport {r['transport_bytes'] / r['p_frames']:.0f} "
                     f"bytes and {1e3 * r['transport_s'] / r['p_frames']:.3f} "
                     f"ms per P frame ({r['transport_calls']} calls)")
        log(f"{line} [{card}]")


def phase_distributed(tmp, jobs, plains, batched_oracle, card):
    """The encode over ranks (parallel/; one process per rank, every rank
    on the one card over gloo, or over NCCL where each has its own):
    `--devices 3` on the full-search and config-3 clips at GOP 10, `--devices
    4 --tile 2` (a batch of two GOPs in 2 x 2 ranks and the tail GOP on the
    coordinator), the format-4 clip with `--intra-slice 17 --devices 2
    --tile 2`, `--multiprocess 2`, `--failover` with TVC_FAULT_GOPS=10 alone
    and with `--devices 3`, and `--devices 1` (NCCL at world size 1), each
    equal to the port's GOP-10 stream (config 3 to the oracle's); the tile
    program at world size 1 and the transport check through the library;
    RingEncoder over 4 ranks on four streams cut from the full clip at
    `--rc bitrate --kbps 12000`, one shorter, each equal to its
    single-device encode. Returns the launch counts of each path (the
    coordinator's and the ranks')."""
    import dataclasses

    from video_encoder_tpu_torch.codec import bitstream, entropy
    from video_encoder_tpu_torch.codec.frame import Frame
    from video_encoder_tpu_torch.codec.mux import bit_concat
    from video_encoder_tpu_torch.ops.kernels import build
    from video_encoder_tpu_torch.parallel import multiprocess as mp
    from video_encoder_tpu_torch.parallel.mesh import backend_for
    from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

    paths = []
    full10, full_plain = plains["full"]
    v4 = dict(jobs["v4i17"], gop=10,
              tag=jobs["v4i17"]["tag"].replace("gop30", "gop10"))
    _, _, v4_plain = run_cli(v4, os.path.join(tmp, f"plain_{v4['tag']}.tvc"))
    with open(batched_oracle["theirs"], "rb") as f:
        c3_oracle = f.read()
    cards = torch.cuda.device_count()
    # (job, flags, stream to equal, environment, ranks started): 30 frames
    # at GOP 10 are three GOPs; a batch whose injected fault fires is
    # never dispatched (the third --failover run starts no rank)
    runs = [
        (full10, ["--devices", "3"], full_plain, {}, 3),
        (batched_oracle, ["--devices", "3"], c3_oracle, {}, 3),
        (full10, ["--devices", "4", "--tile", "2"], full_plain, {}, 4),
        (v4, ["--devices", "2", "--tile", "2"], v4_plain, {}, 2),
        (full10, ["--multiprocess", "2"], full_plain, {}, 2),
        (full10, ["--failover"], full_plain,
         {"TVC_FAULT_GOPS": "10", "TVC_FAULT_TIMES": "2"}, None),
        (full10, ["--failover", "--devices", "3"], full_plain,
         {"TVC_FAULT_GOPS": "10"}, 0),
        (full10, ["--devices", "1"], full_plain, {}, 1)]
    if cards >= 2:
        runs.append((full10, ["--devices", "2", "--tile", "2"], full_plain,
                     {}, 2))
    for job, extra, want, env, ranks in runs:
        flags = " ".join([f"{k}={v}" for k, v in env.items()] + extra)
        os.environ.update(env)
        try:
            launches, summary, stream = run_cli(
                job, os.path.join(tmp, f"ranks_{len(paths)}.tvc"), extra)
        finally:
            for k in env:
                del os.environ[k]
        held = ("the oracle's GOP-10 stream" if want is c3_oracle
                else "the port's GOP-10 stream")
        same_stream(f"{job['tag']} {flags}", stream, want, held)
        psnr = summary["mean_psnr_y"]
        if not (np.isfinite(psnr) and psnr > PSNR_FLOOR):
            raise AssertionError(f"{job['tag']} {flags}: mean PSNR-Y {psnr}")
        rows = summary.get("ranks")
        if ranks is not None and (len(rows) != ranks or any(
                r["backend"] != backend_for(ranks, DEVICE) for r in rows)):
            raise AssertionError(f"{flags}: ranks {rows}, want {ranks} over "
                                 f"{backend_for(ranks, DEVICE)}")
        total = rank_launches(launches, summary)
        m = job["mode"]
        tiled = "--tile" in extra
        check_launches(f"{job['tag']} {flags}", total, (
            ["full_search_haloed", "mc_predict_haloed", "code_plane_g"
             if not m["qmat"] else "code_plane_qmat_g"] if tiled
            else expected_kernels(m, "chunks" if ranks is not None
                                  else GopEngine.emit)))
        paths.append(total)
        log(f"ranks {job['tag']} {flags}: == {held} ({len(stream)} bytes), "
            f"mean PSNR-Y {psnr} dB, faults injected "
            f"{summary.get('faults_injected', 0)}")
        print_ranks(flags, summary, tiled, card)
    if cards < 2:
        log(f"NCCL over several ranks waits for a host with several cards: "
            f"this one has {cards} [{card}]")

    # the tile program at world size 1 (S = 1 through the transport) and
    # the transport check, on NCCL: the first GOP against the plain stream
    w, h = full10["w"], full10["h"]
    cfg = config_of(full10["mode"], w, h, 10)
    n_mbs = -(-h // 16) * (w // 16)
    base = dict(cfg=dataclasses.asdict(cfg), clip=full10["raw"], width=w,
                height=h)
    build.reset_launches()
    results, rows = mp.run_jobs(
        [dict(base, kind="tiles", first=0, ref_mode="halo", emit="chunks",
              block_words=entropy.BLOCK_WORDS_MAX,
              cap_words=entropy.max_words(n_mbs)),
         dict(kind="transport", seed=3, shape=[-(-h // 64) * 16, w],
              halos=[1, 16], grid=[1, 1])], 1, device=DEVICE, timeout_s=600)
    out = results[0][0][0]
    packets = list(bitstream.demux(io.BytesIO(full_plain))[1])[:10]
    for t, pkt in enumerate(packets):
        got = bit_concat([(out["words"][t, 0, c], int(out["cbits"][t, 0, c]))
                          for c in range(out["cbits"].shape[-1])
                          if out["cbits"][t, 0, c]])
        if got != (pkt.payload, pkt.payload_bits):
            raise AssertionError(f"tile program at world size 1: frame {t} "
                                 f"differs from the plain stream")
    errs = {k: e for k, (_, e) in results[1][0][0].items()}
    if any(errs.values()) or rows[0][0]["backend"] != backend_for(1, DEVICE):
        raise AssertionError(f"world size 1: transport errors {errs}, rows "
                             f"{rows[0]}")
    paths.append({k: v + rows[0][0]["launches"].get(k, 0)
                  for k, v in build.LAUNCHES.items()})
    log(f"ranks: the tile program at world size 1 over "
        f"{rows[0][0]['backend']} == the plain GOP's 10 frames; the "
        f"transport bodies over the group == the tensor-axis bodies "
        f"(a quarter frame's rows, halos 1 and 16) [{card}]")

    # the ring: four streams of the full clip over 4 ranks, one shorter
    rcfg = dataclasses.replace(cfg, rc="bitrate", target_kbps=12000)
    streams = [(0, 10), (10, 10), (20, 10), (3, 7)]
    firsts = [0, 100, 200, 300]
    build.reset_launches()
    t0 = time.perf_counter()
    results, rows = mp.run_jobs(
        [dict(base, cfg=dataclasses.asdict(rcfg), kind="ring",
              streams=[list(s) for s in streams], first_indices=firsts)],
        4, device=DEVICE, timeout_s=600)
    wall = time.perf_counter() - t0
    got = results[0][0][0]
    frames = [Frame.from_planes(*p) for p in zip(*full10["clip"])]
    eng = GopEngine(rcfg, device=DEVICE)
    for s, ((a, n), first) in enumerate(zip(streams, firsts)):
        want = [p.to_bytes() for p in eng.encode_gop(frames[a:a + n], first)[0]]
        if [p.to_bytes() for p in got[s]] != want:
            raise AssertionError(f"ring stream {s} differs from its "
                                 f"single-device encode")
    total = {k: v + sum(r[0]["launches"].get(k, 0) for r in rows)
             for k, v in build.LAUNCHES.items()}
    check_launches("ring over 4 ranks", total,
                   ["full_search_g", "mc_predict_g", "code_plane_g",
                    "block_pack", "frame_headers", "frame_place"])
    paths.append(total)
    log(f"ring over 4 ranks ({rows[0][0]['backend']}), streams {streams} at "
        f"--rc bitrate --kbps 12000: each == its single-device encode; "
        f"{sum(len(g) for g in got)} frames in {wall:.2f} s wall with the "
        f"ranks' start [{card}]")
    for r in rows:
        log(f"    rank {r[0]['rank']} ({r[0]['device']}): encode "
            f"{r[0]['encode_s']:.3f} s, transport {r[0]['transport_bytes']} "
            f"bytes and {1e3 * r[0]['transport_s']:.3f} ms in "
            f"{r[0]['transport_calls']} calls (the ring hops of each of "
            f"{r[0]['p_frames'] + 1} steps, the overflow flag's "
            f"all_reduce) [{card}]")
    return paths


def calls_since(before, calls) -> dict:
    """The graph calls counted by graph_calls() since the snapshot
    `before` (a dict copy of its counts), without the capture seconds."""
    return {k: v - before.get(k, 0) for k, v in calls.items()
            if k != "capture_s" and v != before.get(k, 0)}


def phase_ring_grid(jobs, plains, card):
    """The temporal ring and the 2-D tile grid on the one card, each
    through its CUDA graphs (the counterparts of the reference's jitted
    encode_ring_jit and encode_gop_tiled2d) and eagerly. RingEncoder on
    one device, D = 4 columns, on the four streams phase_distributed cuts
    from the full-search clip (10, 10, 10 and 7 frames) at `--rc bitrate
    --kbps 12000`, encoded four times by one encoder: eager (a key's first
    call), the capture and its replay, a replay, then with no graph
    (eager_paths()); each stream equal to its single-device GOP-engine
    encode, with the same launches every time. encode_gop_tiled2d on a
    2 x 2 grid over the padded 1088x1920 planes at GOP 10 and the
    worst-case capacities (BLOCK_WORDS_MAX, entropy.max_words of a tile's
    MB columns), the clip's three GOPs one call each (eager, the capture
    and its replay, a replay): rc none on the full-search clip, each GOP's
    glued frames (assemble_frame_2d) equal to the port's unsharded GOP-10
    stream; rc mb at 12000 kbps, full search, on the config-3 texture,
    each equal to the GOP engine's stream of those flags (the grid's
    mb_rc_offsets_tile2d on the card); with the same launches every call.
    Returns the launch counts of each run."""
    import dataclasses

    from video_encoder_tpu_torch.codec import entropy
    from video_encoder_tpu_torch.codec.bitstream import demux
    from video_encoder_tpu_torch.codec.frame import Frame
    from video_encoder_tpu_torch.ops.kernels import build
    from video_encoder_tpu_torch.parallel import tiles
    from video_encoder_tpu_torch.parallel.mesh import (make_ring_mesh,
                                                       make_tile_mesh_2d)
    from video_encoder_tpu_torch.parallel.ring import RingEncoder
    from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

    paths = []
    full10, full_plain = plains["full"]
    w, h = full10["w"], full10["h"]
    cfg = config_of(full10["mode"], w, h, 10)

    def same_launches(what, runs, kernels):
        check_launches(what, runs[0], kernels)
        if any(r != runs[0] for r in runs[1:]):
            raise AssertionError(f"{what}: launches per call differ: "
                                 f"{[nonzero(r) for r in runs]}")
        paths.extend(runs)

    # the ring: four streams of the full clip on one card, D = 4 columns
    rcfg = dataclasses.replace(cfg, rc="bitrate", target_kbps=12000)
    frames = [Frame.from_planes(*p) for p in zip(*full10["clip"])]
    streams = [frames[a:a + n] for a, n in ((0, 10), (10, 10), (20, 10),
                                            (3, 7))]
    firsts = [0, 100, 200, 300]
    eng = GopEngine(rcfg, device=DEVICE)
    want = [[p.to_bytes() for p in eng.encode_gop(s, f)[0]]
            for s, f in zip(streams, firsts)]
    ring = RingEncoder(rcfg, make_ring_mesh(4, DEVICE))
    runs, turns = [], {}
    with graph_calls() as calls:
        for turn in ("eager", "capture", "replay", "graphs off"):
            before = dict(calls)
            build.reset_launches()
            t0 = time.perf_counter()
            with (eager_paths() if turn == "graphs off"
                  else contextlib.nullcontext()):
                got = ring.encode_streams(streams, firsts)
            wall = time.perf_counter() - t0
            runs.append(dict(build.LAUNCHES))
            turns[turn] = dict(calls_since(before, calls),
                               wall_s=round(wall, 3))
            if [[p.to_bytes() for p in g] for g in got] != want:
                raise AssertionError(f"ring on one card, {turn}: a stream "
                                     f"differs from its single-device encode")
    keys = {k.hop for k in ring.engine.graphs}
    if (keys != {"roll"} or not turns["capture"].get("GraphKey/capture")
            or not turns["replay"].get("GraphKey/replay")
            or set(turns["graphs off"]) != {"GraphKey/eager", "wall_s"}):
        raise AssertionError(f"ring on one card: graph calls {turns}, hops "
                             f"{keys}")
    same_launches("ring on one card", runs,
                  ["full_search_g", "mc_predict_g", "code_plane_g",
                   "block_pack", "frame_headers", "frame_place"])
    log(f"ring on one card (D = 4, hop 'roll'), streams (10, 10, 10, 7) of "
        f"the full clip at --rc bitrate --kbps 12000: each == its "
        f"single-device encode in every call, launches {nonzero(runs[0])} "
        f"each call; graph calls and host wall per call {turns}, captures "
        f"(s) {calls.get('capture_s')}; {mem()} [{card}]")

    # the 2-D grid: the three GOPs of 10 of a clip, one call each
    mesh = make_tile_mesh_2d(2, 2, DEVICE)
    caps = dict(block_words=entropy.BLOCK_WORDS_MAX,
                row_words=entropy.max_words(-(-w // 16) // 2))
    planes_of = {}
    for name in ("full", "config3"):
        ys, cbs, crs = jobs[name]["clip"]
        planes_of[name] = (up(ys, 16), up(cbs, 8), up(crs, 8))
    c3full = mode("config3_full", rc="mb", kbps=12000, passes=4)
    c3cfg = config_of(c3full, w, h, 10)
    c3frames = [Frame.from_planes(*p) for p in zip(*jobs["config3"]["clip"])]
    c3eng = GopEngine(c3cfg, device=DEVICE)
    plain = [(p.payload, p.payload_bits)
             for p in demux(io.BytesIO(full_plain))[1]]
    for name, gcfg, want in (
            ("full", cfg, plain),
            ("config3", c3cfg,
             [(p.payload, p.payload_bits) for k in range(3)
              for p in c3eng.encode_gop(c3frames[10 * k:10 * k + 10],
                                        10 * k)[0]])):
        runs = []
        with graph_calls() as calls:
            for k in range(3):
                y, cb, cr = (p[10 * k:10 * k + 10] for p in planes_of[name])
                build.reset_launches()
                outs = tiles.encode_gop_tiled2d(
                    y, cb, cr, 28, mesh=mesh, rc=gcfg.rc,
                    target_bits=gcfg.target_bits_per_frame(),
                    vbv_bits=gcfg.vbv_bits(), **caps)
                words = outs["words"].cpu().numpy()
                row_bits = outs["row_bits"].cpu().numpy()
                runs.append(dict(build.LAUNCHES))
                if bool(outs["ovf"].any()):
                    raise AssertionError(f"2-D grid {name} GOP {k}: overflow "
                                         "at the worst-case capacities")
                got = [tiles.assemble_frame_2d(words, row_bits, t)
                       for t in range(10)]
                if got != want[10 * k:10 * k + 10]:
                    raise AssertionError(
                        f"2-D grid {name} rc {gcfg.rc} GOP {k}: frames differ "
                        f"from the unsharded stream")
        graph = dict(calls)
        if (graph.get("Tile2dKey/eager") != 1
                or graph.get("Tile2dKey/capture") != 1
                or graph.get("Tile2dKey/replay") != 1):
            raise AssertionError(f"2-D grid {name}: graph calls {graph}")
        same_launches(f"2-D grid {name}", runs,
                      ["full_search_haloed", "mc_predict_haloed",
                       "code_plane_g", "block_pack", "frame_headers",
                       "frame_place"])
        held = ("the unsharded GOP-10 stream" if name == "full"
                else "the GOP engine's stream of those flags")
        log(f"2-D grid 2 x 2 {w}x{h} GOP 10 {name} rc {gcfg.rc}: three GOPs "
            f"(eager, capture, replay) each == {held}, launches "
            f"{nonzero(runs[0])} each call; graph calls {graph} [{card}]")
    return paths


def gop_memory(eng, inputs, qps) -> dict:
    """One GOP (or G in lockstep) through the engine's eager loop from a
    settled allocator: the memory allocated before it (the inputs and
    whatever else is live), the peak allocated during it
    (torch.cuda.reset_peak_memory_stats first), the GOP's own share of
    the peak (peak less before), and the bytes of its download
    (GopEngine.download: the words cut to the longest payload or span
    string, and the small per-frame arrays), per GOP and of the words
    alone."""
    g = 1 if isinstance(qps, int) else len(qps)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    outs = eager_run(eng, *inputs, qps)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    host = eng.download(outs)
    words_sum = _checksum([outs["words"], outs["bits"]])
    del outs
    return dict(sum=words_sum, before_mib=before / 2**20, peak_mib=peak / 2**20,
                gop_peak_mib=(peak - before) / 2**20,
                download_bytes_per_gop=sum(a.nbytes for a in host.values()
                                           if a is not None) / g,
                words_bytes_per_gop=host["words"].nbytes / g,
                words_dtype=str(host["words"].dtype))


def up(planes, mult):
    """[T, H, W] uint8 planes on the device, edge-padded to multiples of
    `mult` as Frame.from_planes pads them."""
    a = np.stack([np.pad(p, ((0, -p.shape[0] % mult), (0, -p.shape[1] % mult)),
                         mode="edge") for p in planes])
    return torch.from_numpy(a).to(DEVICE)


def phase_speed_batched(cells, single, card, gs=(1, 2, 4)):
    """Device-resident 1080p GOP-30 fps of G GOPs in lockstep for G in gs
    (G = 1 is the single-GOP path), each through its graph and through
    the eager loop, in turns: G in (1, 2, 4, 4, 2, 1), and per G (graph,
    eager) or (eager, graph), so the G and the loops share a host; each
    with its device ops per frame, busy share and host calls from one
    traced batch (G = 1: the traces phase_speed took of the same GOP, in
    `single`), the graphs' capture seconds and the reserved memory. The G
    GOPs are the cell's one 30-frame clip G times: the work per GOP is the
    cell's own."""
    from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

    results = {}
    for m, (ys, cbs, crs) in cells:
        h, w = ys[0].shape
        n = len(ys)
        eng = GopEngine(config_of(m, w, h, n), device=DEVICE)
        emits = {eng.emit: eng, **{e: GopEngine(config_of(m, w, h, n),
                                                device=DEVICE, emit=e)
                                   for e in ("frame", "chunks") if e != eng.emit}}
        one = (up(ys, 16), up(cbs, 8), up(crs, 8))
        inputs = {1: one}
        for g in gs:
            if g > 1:        # [T, G, H, W]
                inputs[g] = tuple(p[:, None].expand(-1, g, -1, -1).contiguous()
                                  for p in one)

        def launch(g, loop, xl=False):
            if loop == "eager":
                return eager_run(eng, *inputs[g], 28 if g == 1 else [28] * g,
                                 xl)
            if g == 1:
                return eng.run(*inputs[1], 28, xl=xl)
            return eng.run_batch(*inputs[g], [28] * g, xl=xl)

        # the engine reruns a batch that overflows its budgets
        reruns = {g: bool(launch(g, "graph")["ovf"].any()) for g in gs}

        def batch(g, loop):
            launch(g, loop)
            if reruns[g]:
                launch(g, loop, xl=True)

        times = {(g, loop): 0.0 for g in gs for loop in ("graph", "eager")}
        iters = 1
        for i, g in enumerate((*gs, *gs[::-1])):
            for loop in (("graph", "eager") if i % 2 == 0
                         else ("eager", "graph")):
                batch(g, loop)       # the graph's capture, at its first turn
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    batch(g, loop)
                torch.cuda.synchronize()
                times[g, loop] += time.perf_counter() - t0
        for g in gs:
            fig = {}
            for loop in ("graph", "eager"):
                torch.cuda.reset_peak_memory_stats()
                f = loop_figures(lambda: batch(g, loop), g * n,
                                 trace=single[m["tag"]][loop] if g == 1
                                 else None)
                f.update(resident=2 * iters * g * n / times[g, loop],
                         peak_mib=torch.cuda.max_memory_allocated() / 2**20)
                f["busy_of_wall"] = busy_of_wall(f, g * n)
                fig[loop] = f
            captures = {graph_key_name(k): round(v.capture_s, 3)
                        for k, v in eng.graphs.items()
                        if v is not None and len(k.y_shape) == (3 if g == 1 else 4)
                        and (g == 1 or k.y_shape[1] == g)}
            memory = {e: gop_memory(em, inputs[g], 28 if g == 1 else [28] * g)
                      for e, em in emits.items()}
            results[f"{m['tag']}/G{g}"] = dict(
                memory=memory, peak_mib=fig["graph"]["peak_mib"],
                eager_peak_mib=fig["eager"]["peak_mib"],
                resident=fig["graph"]["resident"],
                ops_per_frame=fig["graph"]["ops"], busy=fig["graph"]["busy"],
                host_calls_per_batch=fig["graph"]["calls"],
                eager_resident=fig["eager"]["resident"],
                eager_ops_per_frame=fig["eager"]["ops"],
                eager_busy=fig["eager"]["busy"],
                busy_of_wall=fig["graph"]["busy_of_wall"],
                eager_busy_of_wall=fig["eager"]["busy_of_wall"],
                eager_host_calls_per_batch=fig["eager"]["calls"],
                capture_s=captures,
                reserved_mib=torch.cuda.memory_reserved() / 2**20)
            for loop, f in fig.items():
                log(f"speed: lockstep {w}x{h} GOP {n} {m['tag']} G={g} emit "
                    f"{eng.emit} {loop}: {f['resident']:.3f} fps "
                    f"device-resident ({1e3 / f['resident']:.3f} ms/frame, "
                    f"{2 * iters} batches, rerun {reruns[g]}, peak "
                    f"{f['peak_mib']:.0f} MiB); one batch traced: "
                    f"{fmt_figures(f)} [{card}]")
                log(f"  device ms per batch by name (launches, ms): "
                    f"{f['top'][:7]}")
            log(f"  graphs at G={g}: capture s {captures}; {mem()} [{card}]")
            for e, f in memory.items():
                log(f"memory: lockstep {w}x{h} GOP {n} {m['tag']} G={g} emit {e}"
                    f" eager: peak allocated {f['peak_mib']:.1f} MiB, "
                    f"{f['before_mib']:.1f} before the batch, "
                    f"{f['gop_peak_mib']:.1f} its own; download "
                    f"{f['download_bytes_per_gop']:.0f} bytes per GOP, words "
                    f"{f['words_bytes_per_gop']:.0f} ({f['words_dtype']}) "
                    f"[{card}]")
    return results


def phase_speed_tiled(m, clip, card, shards=(1, 2, 4)):
    """Device-resident 1080p GOP-30 fps of one cell with every frame in S
    row shards on the one card, for S in shards, each through its graph
    and through the eager loop, in turns: S in (1, 2, 4, 4, 2, 1), and per
    S (graph, eager) or (eager, graph); each with its host calls per GOP,
    device ops per frame, busy share (traced, and the traced device time
    over the untraced wall) and capture seconds. Every S packs under the
    tile path's emit, so only the sharding differs: S = 1 is the
    single-device engine's lockstep loop on a batch of one GOP
    (`run_batch`), S > 1 the sharded encoder's (`ShardedGopEncoder.run`);
    the eager turns run the same entry points under eager_paths()."""
    from video_encoder_tpu_torch.parallel.gop_parallel import ShardedGopEncoder
    from video_encoder_tpu_torch.parallel.mesh import make_codec_mesh
    from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

    ys, cbs, crs = clip
    h, w = ys[0].shape
    n = len(ys)
    cfg = config_of(m, w, h, n)
    emit = ShardedGopEncoder.emit
    y, cb, cr = up(ys, 16), up(cbs, 8), up(crs, 8)
    batch1 = (y[:, None], cb[:, None], cr[:, None])        # [T, 1, H, W]
    launchers, caches = {}, {}
    for s in shards:
        if s == 1:
            eng = GopEngine(cfg, device=DEVICE, emit=emit)
            caches[s] = eng.cache
            launchers[s] = lambda xl=False, eng=eng: eng.run_batch(
                *batch1, [28], xl=xl)
        else:
            senc = ShardedGopEncoder(cfg, make_codec_mesh(1, s, DEVICE))
            caches[s] = senc.cache
            launchers[s] = lambda xl=False, senc=senc: senc.run(
                *batch1, 28, xl=xl)

    def launch(s, loop, xl=False):
        if loop == "graph":
            return launchers[s](xl)
        with eager_paths():
            return launchers[s](xl)

    # the encoders rerun a GOP that overflows its budgets (a key's first
    # call: the eager warm-up)
    reruns = {s: bool(launch(s, "graph")["ovf"].any()) for s in shards}

    def gop(s, loop):
        launch(s, loop)
        if reruns[s]:
            launch(s, loop, xl=True)

    times = {(s, loop): 0.0 for s in shards for loop in ("graph", "eager")}
    for i, s in enumerate((*shards, *shards[::-1])):
        for loop in (("graph", "eager") if i % 2 == 0
                     else ("eager", "graph")):
            gop(s, loop)          # the graph's capture, at its first turn
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gop(s, loop)
            torch.cuda.synchronize()
            times[s, loop] += time.perf_counter() - t0
    results = {}
    for s in shards:
        fig = {}
        for loop in ("graph", "eager"):
            f = loop_figures(lambda: gop(s, loop), n)
            f.update(resident=2 * n / times[s, loop])
            f["busy_of_wall"] = busy_of_wall(f, n)
            fig[loop] = f
        captures = {graph_key_name(k): round(v.capture_s, 3)
                    for k, v in caches[s].graphs.items() if v is not None}
        if not captures:
            raise AssertionError(f"tiled S={s}: no graph was captured")
        results[f"{m['tag']}/S{s}"] = dict(
            resident=fig["graph"]["resident"],
            ops_per_frame=fig["graph"]["ops"], busy=fig["graph"]["busy"],
            busy_of_wall=fig["graph"]["busy_of_wall"],
            host_calls_per_gop=fig["graph"]["calls"],
            eager_resident=fig["eager"]["resident"],
            eager_ops_per_frame=fig["eager"]["ops"],
            eager_busy=fig["eager"]["busy"],
            eager_busy_of_wall=fig["eager"]["busy_of_wall"],
            eager_host_calls_per_gop=fig["eager"]["calls"],
            capture_s=captures)
        for loop, f in fig.items():
            log(f"speed: tiled {w}x{h} GOP {n} {m['tag']} S={s} emit {emit} "
                f"{loop}: {f['resident']:.3f} fps device-resident "
                f"({1e3 / f['resident']:.3f} ms/frame, 2 GOPs, rerun "
                f"{reruns[s]}); one GOP traced: {fmt_figures(f)} [{card}]")
            log(f"  device ms per GOP by name (launches, ms): {f['top'][:7]}")
        log(f"  graphs at S={s}: capture s {captures}; {mem()} [{card}]")
    return results


def phase_speed_ring_grid(m, clip, card):
    """Device-resident 1080p GOP-30 fps of the ring on one card (D = 4
    columns, each the cell's 30-frame clip: the engine's lockstep loop
    with the roll, `GopEngine.run_batch(hop="roll")` as RingEncoder runs
    it, without its upload and download) and of the 2 x 2 grid
    (`encode_gop_tiled2d`, the budgeted capacities: block_words_for_qp(28)
    and entropy.capacity_words of a tile's MB row), each through its graph
    and through the eager loop (eager_paths()), in turns: ring, grid,
    grid, ring, each (graph, eager) then (eager, graph); a GOP that
    overflows its budgets runs again at the worst case, as the encoders
    do. Each with its host calls per GOP, device ops per frame, busy share
    (traced, and the traced device time over the untraced wall) and
    capture seconds. Prints findings, claims nothing."""
    from video_encoder_tpu_torch.codec import entropy
    from video_encoder_tpu_torch.parallel import tiles
    from video_encoder_tpu_torch.parallel.mesh import (make_ring_mesh,
                                                       make_tile_mesh_2d)
    from video_encoder_tpu_torch.parallel.ring import RingEncoder
    from video_encoder_tpu_torch.pipeline.gop_engine import block_words_for_qp

    ys, cbs, crs = clip
    h, w = ys[0].shape
    n = len(ys)
    cfg = config_of(m, w, h, n)
    y, cb, cr = up(ys, 16), up(cbs, 8), up(crs, 8)
    d = 4
    columns = tuple(p[:, None].expand(-1, d, -1, -1).contiguous()
                    for p in (y, cb, cr))                  # [T, D, H, W]
    eng = RingEncoder(cfg, make_ring_mesh(d, DEVICE)).engine
    mesh = make_tile_mesh_2d(2, 2, DEVICE)
    row_mbs = y.shape[-1] // 16 // 2

    def grid(xl):
        caps = (dict(block_words=entropy.BLOCK_WORDS_MAX,
                     row_words=entropy.max_words(row_mbs)) if xl else
                dict(block_words=block_words_for_qp(28),
                     row_words=entropy.capacity_words(row_mbs)))
        return tiles.encode_gop_tiled2d(
            y, cb, cr, 28, mesh=mesh, rc=cfg.rc,
            target_bits=cfg.target_bits_per_frame(), vbv_bits=cfg.vbv_bits(),
            **caps)

    launchers = {"ring": lambda xl: eng.run_batch(*columns, [28] * d, xl=xl,
                                                  hop="roll"),
                 "grid": grid}
    frames = {"ring": d * n, "grid": n}
    caches = {"ring": eng.graphs, "grid": tiles.tile2d_cache(DEVICE).graphs}

    def launch(path, loop, xl=False):
        with (eager_paths() if loop == "eager" else contextlib.nullcontext()):
            return launchers[path](xl)

    # a key's first call: the eager warm-up; it also finds the reruns
    reruns = {p: bool(launch(p, "graph")["ovf"].any()) for p in launchers}

    def gop(path, loop):
        launch(path, loop)
        if reruns[path]:
            launch(path, loop, xl=True)

    times = {(p, loop): 0.0 for p in launchers for loop in ("graph", "eager")}
    for i, path in enumerate(("ring", "grid", "grid", "ring")):
        for loop in (("graph", "eager") if i < 2 else ("eager", "graph")):
            gop(path, loop)        # the graph's capture, at its first turn
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gop(path, loop)
            torch.cuda.synchronize()
            times[path, loop] += time.perf_counter() - t0
    results = {}
    for path in launchers:
        fig = {}
        for loop in ("graph", "eager"):
            f = loop_figures(lambda: gop(path, loop), frames[path])
            f.update(resident=2 * frames[path] / times[path, loop])
            f["busy_of_wall"] = busy_of_wall(f, frames[path])
            fig[loop] = f
        captures = [round(g.capture_s, 3) for k, g in caches[path].items()
                    if g is not None and k.y_shape[0] == n]   # GOP 30's
        if not captures:
            raise AssertionError(f"{path}: no graph was captured")
        results[f"{m['tag']}/{path}"] = dict(
            resident=fig["graph"]["resident"],
            ops_per_frame=fig["graph"]["ops"], busy=fig["graph"]["busy"],
            busy_of_wall=fig["graph"]["busy_of_wall"],
            host_calls_per_gop=fig["graph"]["calls"],
            eager_resident=fig["eager"]["resident"],
            eager_ops_per_frame=fig["eager"]["ops"],
            eager_busy=fig["eager"]["busy"],
            eager_busy_of_wall=fig["eager"]["busy_of_wall"],
            eager_host_calls_per_gop=fig["eager"]["calls"],
            rerun=reruns[path], capture_s=captures)
        what = (f"ring D = {d} (hop 'roll', {d} x {n} frames a call)"
                if path == "ring" else f"2-D grid 2 x 2 ({n} frames a call)")
        for loop, f in fig.items():
            log(f"speed: {what} {w}x{h} GOP {n} {m['tag']} {loop}: "
                f"{f['resident']:.3f} fps device-resident "
                f"({1e3 / f['resident']:.3f} ms/frame, 2 calls, rerun "
                f"{reruns[path]}); one call traced: {fmt_figures(f)} [{card}]")
            log(f"  device ms per call by name (launches, ms): {f['top'][:7]}")
        log(f"  graphs of the {path}: capture s {captures}; {mem()} [{card}]")
    return results


def phase_speed_sea(m, clip, card):
    """The full-search cell device-resident with TVC_SEA 0 and 1 in turns
    (0, 1, 1, 0), one GOP a turn, each through its own graph (TVC_SEA is
    part of the key; both are captured before the turns), and the
    search's device time per GOP of each from a trace: a finding, not a
    claim."""
    from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

    ys, cbs, crs = clip
    h, w = ys[0].shape
    n = len(ys)
    eng = GopEngine(config_of(m, w, h, n), device=DEVICE)
    y, cb, cr = up(ys, 16), up(cbs, 8), up(crs, 8)
    rerun = bool(eng.run(y, cb, cr, 28)["ovf"].any())

    def gop():
        eng.run(y, cb, cr, 28)
        if rerun:
            eng.run(y, cb, cr, 28, xl=True)

    for on in (False, True):   # each route's key: its eager call, its capture
        with sea(on):
            gop()
            gop()
    times = {False: 0.0, True: 0.0}
    for on in (False, True, True, False):
        with sea(on):
            gop()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gop()
            torch.cuda.synchronize()
            times[on] += time.perf_counter() - t0
    results = {}
    for on in (False, True):
        with sea(on):
            ops, busy, top = device_ops(gop, n, SAD_KERNELS)
        search = [(name, cnt, ms) for name, cnt, ms in top
                  if any(k in name for k in SAD_KERNELS)]
        fps = 2 * n / times[on]
        results[f"TVC_SEA={int(on)}"] = dict(resident=fps, search=search)
        log(f"speed: {w}x{h} GOP {n} {m['tag']} TVC_SEA={int(on)}: {fps:.3f} "
            f"fps device-resident (2 GOPs, rerun {rerun}); one GOP traced: "
            f"{ops if ops is None else round(ops, 1)} device ops/frame, busy "
            f"{busy if busy is None else round(100 * busy, 1)} %, search "
            f"(launches, ms per GOP) {search} [{card}]")
    return results


def raw_events(prof):
    """A finished torch.profiler run's events as the profiler's own
    records (name(), device_type(), start_ns(), end_ns(), duration_ns()):
    read 50x faster than prof.events(), which links every host op into a
    tree (seconds for the tens of thousands of calls of an eager GOP)."""
    return prof.profiler.kineto_results.events()


def device_ops(run_once, n_frames, watch=()):
    """Device kernels (and memsets/copies) per frame, the device busy share
    and the largest device-time totals by name, of one GOP under
    torch.profiler; the first of those is ("all kernels", count, ms): the
    GOP's whole device time, which the search's share is read against.
    Kernels whose name holds a string of `watch` follow the largest,
    wherever they rank."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_once()
        torch.cuda.synchronize()
    dev = [e for e in raw_events(prof)
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None, None, []
    by_name = {}
    for e in dev:
        n, us = by_name.get(e.name(), (0, 0.0))
        by_name[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    top = ranked[:8] + [kv for kv in ranked[8:]
                        if any(w in kv[0] for w in watch)]
    busy = sum(us for _, us in by_name.values())
    span = (max(e.end_ns() for e in dev)
            - min(e.start_ns() for e in dev)) / 1e3
    return len(dev) / n_frames, busy / max(span, 1), [
        ("all kernels", len(dev), round(busy / 1e3, 3))] + [
        (name[:60], n, round(us / 1e3, 3)) for name, (n, us) in top]


# the kernels of code_plane (whole planes, the row scan) and block_pack,
# shown in every per-GOP trace wherever they rank
CODE_KERNELS = ("plane_kernel", "rows_kernel", "code_plane_kernel",
                "block_pack_kernel")
# the motion search's kernels, by the names in a trace, in this checkout
# and in an older one that --ab may time: the exhaustive search and the
# whole map (tiled_kernel; tiled_search_kernel, map_kernel<1>), the even
# map (even_map_kernel; map_kernel<2>), the SEA search, sad_at_mv, the
# diamond descent
SAD_KERNELS = ("search_kernel", "map_kernel", "tiled_kernel", "sea_kernel",
               "sad_at_kernel", "descent_kernel")


def i_frame_figures(eng, y, cb, cr):
    """The format-3/4 I frame on its own (one frame of the clip through
    the engine): the launches of each code_plane entry, its device ops,
    device time and busy share from torch.profiler, and its wall ms (mean
    of five, sync after each)."""
    from video_encoder_tpu_torch.ops.kernels import build

    def i_frame():
        return eng.run(y[:1], cb[:1], cr[:1], 28)

    out = i_frame()
    torch.cuda.synchronize()
    build.reset_launches()
    i_frame()
    launches = {k: v for k, v in build.LAUNCHES.items()
                if v and k.startswith("code_plane")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        i_frame()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 5
    ops, busy, top = device_ops(i_frame, 1, CODE_KERNELS)
    return dict(wall_ms=wall, device_ops=ops, device_ms=top[0][2] if top else None,
                busy=busy if busy is None else round(100 * busy, 1),
                launches=launches, top=top,
                sum=_checksum([out["words"], out["bits"]]))


def eager_run(eng, y, cb, cr, qps, xl=False):
    """The engine's eager loop (`GopEngine._run`) on its own, at the
    budgets run() and run_batch() pick: a base qp (int) or G of them."""
    n_mbs = (y.shape[-2] // 16) * (y.shape[-1] // 16)
    bw, cap = eng._capacities(n_mbs, int(min(np.atleast_1d(qps))), xl)
    qp = torch.tensor(qps, dtype=torch.int32, device=y.device)
    return eng._run(y, cb, cr, qp, bw, cap)


@contextlib.contextmanager
def eager_paths():
    """Every engine's eager path while the block runs: no device type runs
    graphs (gop_engine._GRAPH_DEVICE_TYPES, read at every call), so each
    GraphCache call runs its body eagerly and records no key. The eager
    turn of a graph-against-eager pair, through the same entry points."""
    from video_encoder_tpu_torch.pipeline import gop_engine

    saved = gop_engine._GRAPH_DEVICE_TYPES
    gop_engine._GRAPH_DEVICE_TYPES = ()
    try:
        yield
    finally:
        gop_engine._GRAPH_DEVICE_TYPES = saved


@contextlib.contextmanager
def graph_calls():
    """Counts of the GraphCache calls made while the block runs, by the
    key's type (GraphKey: the GOP engine, and the ring on one card with
    hop "roll"; TileKey: the tile loop; Tile2dKey: the 2-D grid;
    FrameKey: the per-frame engine; DecodeKey: the GOP decoder;
    DecodeFrameKey: the per-frame decoder) and by what the call did:
    "eager" (a key's first call, a graph-less device, or no key),
    "capture" (the capture and its replay) or "replay"; under
    "capture_s" the seconds of each capture."""
    from video_encoder_tpu_torch.pipeline import gop_engine

    counts = {}
    real = gop_engine.GraphCache.launch

    def launch(cache, key, body, inputs, qps=None):
        graph = cache.graphs.get(key, "new")
        what = ("eager" if key is None or graph == "new" or inputs[0].device.type
                not in gop_engine._GRAPH_DEVICE_TYPES
                else "capture" if graph is None else "replay")
        name = f"{type(key).__name__}/{what}"
        counts[name] = counts.get(name, 0) + 1
        out = real(cache, key, body, inputs, qps)
        if what == "capture":
            counts.setdefault("capture_s", []).append(
                round(cache.graphs[key].capture_s, 3))
        return out

    gop_engine.GraphCache.launch = launch
    try:
        yield counts
    finally:
        gop_engine.GraphCache.launch = real


# the host's calls that submit device work (kernel and graph launches,
# copies, fills), by the names torch.profiler gives the CUDA API's calls
SUBMITS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
           "cuGraphLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")


def host_calls(run_once):
    """(count, {name: count}) of the calls of SUBMITS the host made in one
    run_once(), from torch.profiler; (None, {}) where the trace recorded
    none of them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_once()
        torch.cuda.synchronize()
    by_name = {}
    for e in raw_events(prof):
        if (e.device_type() == torch.autograd.DeviceType.CPU
                and e.name().startswith(SUBMITS)):
            by_name[e.name()] = by_name.get(e.name(), 0) + 1
    return (sum(by_name.values()) or None), by_name


def loop_figures(run_once, n_frames, watch=(), trace=None):
    """One GOP (or batch) of run_once under torch.profiler twice: device
    ops per frame, busy share and top device times (device_ops, or the
    `trace` of it already taken), and the host's submitting calls
    (host_calls)."""
    ops, busy, top = trace or device_ops(run_once, n_frames, watch)
    calls, by_name = host_calls(run_once)
    return dict(ops=ops, busy=busy, top=top, calls=calls,
                calls_by_name=dict(sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:6]))


def busy_of_wall(f, n_frames):
    """The traced run's device time (its kernels' durations summed) over
    the untraced wall time of the same run at the measured rate: the busy
    share without the profiler's own cost per kernel, which a trace of a
    graph replay, thousands of short kernels back to back, adds to the
    span the traced busy share divides by."""
    if not f["top"]:
        return None
    return f["top"][0][2] / (1e3 * n_frames / f["resident"])


def fmt_figures(f) -> str:
    bw = f.get("busy_of_wall")
    return (f"{f['ops'] if f['ops'] is None else round(f['ops'], 1)} device "
            f"ops/frame, busy "
            f"{f['busy'] if f['busy'] is None else round(100 * f['busy'], 1)} "
            f"% traced, {bw if bw is None else round(100 * bw, 1)} % of the "
            f"untraced wall, {f['calls']} host calls {f['calls_by_name']}")


def phase_speed(cells, card):
    """Device-resident 1080p GOP-30 fps (upload once, loop, sync once), and
    the same with each GOP's finish (sync, download, payload glue,
    packets), for each (mode, clip, emits) cell, through the GOP's graph
    (`GopEngine.run`, a replay from a key's second call) and through the
    eager loop (`GopEngine._run`) in turns: per emit (graph, eager) then
    (eager, graph), the emits in turns (frame, chunks, chunks, frame) on
    one card, one emit twice; each figure is the mean of its two turns.
    For each: device ops per frame, busy share and top device times, and
    the host's submitting calls per GOP, from torch.profiler; the graph
    keys' capture seconds and the reserved memory. For format >= 3 the I
    frame (the vertical-intra row scan) is also timed on its own. Returns
    the figures and, per cell, the traces of its GOP under the default
    emit, graph and eager."""
    from video_encoder_tpu_torch.codec.frame import Frame
    from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine, Launch

    results, traces = {}, {}
    for m, (ys, cbs, crs), emits in cells:
        h, w = ys[0].shape
        n = len(ys)
        frames = [Frame.from_planes(*p) for p in zip(ys, cbs, crs)]
        y, cb, cr = up(ys, 16), up(cbs, 8), up(crs, 8)
        cfg = config_of(m, w, h, n)
        engines, reruns, times = {}, {}, {}
        for emit in emits:
            eng = engines[emit] = GopEngine(cfg, device=DEVICE, emit=emit)
            # the engine reruns a GOP that overflows its budgets
            reruns[emit] = bool(eng.run(y, cb, cr, 28)["ovf"].any())
            for loop in ("graph", "eager"):
                times[emit, loop] = [0.0, 0.0]

        def run(emit, loop, xl=False):
            eng = engines[emit]
            if loop == "eager":
                return eager_run(eng, y, cb, cr, 28, xl)
            return eng.run(y, cb, cr, 28, xl=xl)

        def gop(emit, loop):
            run(emit, loop)
            if reruns[emit]:
                run(emit, loop, xl=True)

        def finished_gop(emit, loop):
            eng = engines[emit]
            eng.finish(Launch([frames], [0], y, cb, cr, 28, run(emit, loop),
                              time.perf_counter(), eng.run, eng.download))

        iters = 2
        turns = (emits + emits[::-1]) if len(emits) == 2 else emits * 2
        for i, emit in enumerate(turns):
            for loop in (("graph", "eager") if i % 2 == 0
                         else ("eager", "graph")):
                gop(emit, loop)      # the graph's capture, at its first turn
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    gop(emit, loop)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for _ in range(iters):
                    finished_gop(emit, loop)
                t2 = time.perf_counter()
                times[emit, loop][0] += t1 - t0
                times[emit, loop][1] += t2 - t1
        for emit in emits:
            eng = engines[emit]
            frames_timed = 2 * iters * n
            fig = {}
            for loop in ("graph", "eager"):
                torch.cuda.reset_peak_memory_stats()
                fig[loop] = loop_figures(lambda: gop(emit, loop), n,
                                         CODE_KERNELS + SAD_KERNELS)
                fig[loop].update(
                    resident=frames_timed / times[emit, loop][0],
                    with_finish=frames_timed / times[emit, loop][1],
                    peak_mib=torch.cuda.max_memory_allocated() / 2**20)
                fig[loop]["busy_of_wall"] = busy_of_wall(fig[loop], n)
            g, e = fig["graph"], fig["eager"]
            top = g["top"]
            captures = {graph_key_name(k): round(v.capture_s, 3)
                        for k, v in eng.graphs.items() if v is not None}
            key = f"{m['tag']}/{m['search']}/{m['rc']}/{emit}"
            search = [t for t in top if any(k in t[0] for k in SAD_KERNELS)]
            results[key] = dict(
                resident=g["resident"], with_finish=g["with_finish"],
                ops_per_frame=g["ops"], busy=g["busy"],
                host_calls_per_gop=g["calls"], search=search,
                device_ms=top[0][2] if top else None,
                eager_resident=e["resident"],
                eager_with_finish=e["with_finish"],
                eager_ops_per_frame=e["ops"], eager_busy=e["busy"],
                eager_host_calls_per_gop=e["calls"],
                eager_device_ms=e["top"][0][2] if e["top"] else None,
                busy_of_wall=g["busy_of_wall"],
                eager_busy_of_wall=e["busy_of_wall"],
                capture_s=captures,
                reserved_mib=torch.cuda.memory_reserved() / 2**20)
            if emit == GopEngine.emit:
                traces[m["tag"]] = {loop: (f["ops"], f["busy"], f["top"])
                                    for loop, f in fig.items()}
            for loop, f in fig.items():
                log(f"speed: device-resident {w}x{h} GOP {n} {key} {loop} "
                    f"{f['resident']:.3f} fps ({1e3 / f['resident']:.3f} "
                    f"ms/frame, {2 * iters} GOPs, rerun {reruns[emit]}, peak "
                    f"{f['peak_mib']:.0f} MiB), with finish "
                    f"{f['with_finish']:.3f} fps; one GOP traced: "
                    f"{fmt_figures(f)}, search (launches, ms per GOP) "
                    f"{[t for t in f['top'] if any(k in t[0] for k in SAD_KERNELS)]}"
                    f" of {f['top'][0][2] if f['top'] else None} ms of device "
                    f"time [{card}]")
                log(f"  device ms per GOP by name (launches, ms): {f['top']}")
            log(f"  graphs of {key}: capture s {captures}; {mem()} [{card}]")
        if m["fmt"] >= 3:
            i_frame = i_frame_figures(engines[emits[0]], y, cb, cr)
            results[f"{m['tag']}/i_frame"] = i_frame
            log(f"speed: {m['tag']} I frame alone (the row scan, one launch "
                f"per plane; the pack; a graph replay) {i_frame['wall_ms']:.3f}"
                f" ms, {i_frame['device_ops']} device ops, "
                f"{i_frame['device_ms']} ms of device time, device busy "
                f"{i_frame['busy']} %, code_plane launches "
                f"{i_frame['launches']} [{card}]")
            log(f"  device ms by name (launches, ms): {i_frame['top']}")
    return results, traces


# ---- --ab: the search and MC kernels of several checkouts, in turns -------

AB_CELL = (1080, 1920, 10)  # height, width, frames (one GOP) of the A/B cells


def _checksum(x) -> int:
    """A sum over the tensors of a result, each element taken as its low
    32 bits: equal for the same words held in int32 (negative where bit
    31 is set) and in int64 (a checkout from before the 32-bit words)."""
    ts = x if isinstance(x, (tuple, list)) else [x]
    return int(sum(int(((t.long() & 0xFFFFFFFF) * (i + 1)).sum())
                   for i, t in enumerate(ts) if isinstance(t, torch.Tensor)))


def ab_child(root: str) -> dict:
    """One turn of --ab: the package of checkout `root`, this file's
    helpers; see the module docstring."""
    sys.path.insert(0, os.path.abspath(root))
    from video_encoder_tpu_torch.ops import dispatch, motion
    from video_encoder_tpu_torch.ops.kernels import build
    from video_encoder_tpu_torch.parallel import tiles
    from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

    dev = torch.device(DEVICE)
    build.lib()
    rng = np.random.default_rng(17)
    out = {}

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def measure(name, fn, n=20):
        res = fn()
        torch.cuda.synchronize()
        dev_ms, kernels = device_ms(fn, n=n, per_call=None)
        out[name] = dict(ms=time_ms(fn), device_ms=dev_ms, kernels=kernels,
                         host_ms=host_ms(fn), sum=_checksum(res))

    (h, w), g = LUMA[0], 4
    ch, cw = h // 2, w // 2
    # the search: a pan with mild noise
    tex = texture(rng, h, w)
    cur = t32(tex[64:64 + h, 64:64 + w])
    ref = t32(np.clip(tex[59:59 + h, 71:71 + w] + rng.integers(-3, 4, (h, w)),
                      0, 255))
    curg = torch.stack([torch.roll(cur, (3 * i, -5 * i), (0, 1))
                        for i in range(g)]).contiguous()
    refg = ref.expand(g, h, w).contiguous()
    measure("full_search", lambda: dispatch.full_search(cur, ref))
    measure("full_search_g", lambda: dispatch.full_search(curg, refg))
    cur_rows, ref_rows = rows_of(cur), ext_rows(ref, 16)
    measure("full_search_haloed",
            lambda: dispatch.full_search_pre_haloed(cur_rows, ref_rows))

    def mvs(lead, nby, nbx, r):
        return (t32(rng.integers(-r, r + 1, (*lead, nby, nbx))),
                t32(rng.integers(-r, r + 1, (*lead, nby, nbx))))

    # the SAD maps: the even lattice (single, G = 4), the whole map
    measure("sad_map_even", lambda: dispatch.sad_map_even(cur, ref))
    measure("sad_map_even_g", lambda: dispatch.sad_map_even(curg, refg))
    measure("sad_map", lambda: dispatch.sad_map(cur, ref))
    # sad_at_mv: K = 4 over the whole window (phase 3's case); the
    # half-pel refine's nine on four parity planes, single, G = 4 and on
    # four pre-haloed row shards
    nby, nbx = h // 16, w // 16
    dy4, dx4 = mvs((4,), nby, nbx, 16)
    measure("sad_at_k4", lambda: dispatch.sad_at_mv(cur, ref, dy4, dx4))
    uv = [(u, v) for u in (-1, 0, 1) for v in (-1, 0, 1)]
    plane_of = [abs(u) * 2 + abs(v) for u, v in uv]
    for name, lead in (("sad_at_k9", ()), ("sad_at_k9_g4", (g,))):
        c9 = cur if not lead else curg
        p9 = motion.hpel_stack(ref if not lead else refg)
        d0y, d0x = mvs(lead, nby, nbx, 16)
        iy = torch.stack([((2 * d0y + u) >> 1).clamp(-16, 16) for u, _ in uv],
                         -3).int().contiguous()
        ix = torch.stack([((2 * d0x + v) >> 1).clamp(-16, 16) for _, v in uv],
                         -3).int().contiguous()
        measure(name, lambda a=(c9, p9, iy, ix, plane_of): dispatch.sad_at_mv(*a))
        if not lead:
            a = (rows_of(cur), torch.stack([ext_rows(q, 16) for q in p9],
                                           1).contiguous(),
                 rows_of(iy), rows_of(ix), plane_of)
            measure("sad_at_haloed",
                    lambda a=a: dispatch.sad_at_mv_pre_haloed(*a))

    # single-plane fetches
    for name, lead, (ph, pw), bs in (
            ("fetch_luma", (), (h, w), 16), ("fetch_chroma", (), (ch, cw), 8),
            ("fetch_luma_g", (g,), (h, w), 16),
            ("fetch_chroma_g", (g,), (ch, cw), 8)):
        plane = t32(rng.integers(0, 256, (*lead, ph, pw)))
        dy, dx = mvs(lead, ph // bs, pw // bs, bs)
        fn = (dispatch.mc_fetch_luma_plane if bs == 16
              else dispatch.mc_fetch_chroma_plane)
        measure(name, lambda fn=fn, a=(plane, dy, dx): fn(*a))
    for name, (ph, pw), bs in (("fetch_haloed_luma", (h, w), 16),
                               ("fetch_haloed_chroma", (ch, cw), 8)):
        plane = t32(rng.integers(0, 256, (ph, pw)))
        dy, dx = mvs((), ph // bs, pw // bs, bs)
        a = (ext_rows(plane, bs), rows_of(dy), rows_of(dx), bs, bs)
        measure(name, lambda a=a: dispatch.mc_fetch_pre_haloed(*a))

    # the MC of one P frame step
    new = hasattr(dispatch, "mc_predict")
    for geo, lead in (("", ()), ("_g4", (g,)), ("_rows", None)):
        ry, rcb, rcr = (t32(rng.integers(0, 256, (*(lead or ()), ph, pw)))
                        for ph, pw in ((h, w), (ch, cw), (ch, cw)))
        for fmt in (1, 4):
            r = 16 if fmt == 1 else 32
            dy, dx = mvs(lead or (), h // 16, w // 16, r)
            inter = torch.from_numpy(
                rng.random((*(lead or ()), h // 16, w // 16)) < 0.8).to(dev)
            if lead is None:       # four row shards with their halos
                dy, dx, inter = (rows_of(t) for t in (dy, dx, inter))
                shards = [rows_of(p) for p in (ry, rcb, rcr)]
                if fmt == 1:
                    planes = [(ext_rows(p, hl),)
                              for p, hl in zip((ry, rcb, rcr), (16, 8, 8))]
                else:
                    planes = [(tiles.exchange_halo(s, hl).contiguous(),
                               *tiles._parity_ext(s, hl, "halo"))
                              for s, hl in zip(shards, (16, 8, 8))]
            elif fmt == 1:
                planes = [(p,) for p in (ry, rcb, rcr)]
            else:
                planes = [(p, *motion.hpel_planes(p)) for p in (ry, rcb, rcr)]
            stack_y = torch.stack(planes[0], -3)
            if fmt == 1:                  # one plane each: a view, no copy
                def refs(planes=planes):
                    return tuple(p[0].unsqueeze(-3) for p in planes)
            elif lead is None:            # parity planes made by the exchange
                def refs(planes=planes, stack_y=stack_y):
                    return (stack_y, *(torch.stack(p, -3) for p in planes[1:]))
            else:                         # chroma parity planes made here
                def refs(stack_y=stack_y, rcb=rcb, rcr=rcr):
                    return (stack_y, motion.hpel_stack(rcb), motion.hpel_stack(rcr))
            if new:
                fn = (dispatch.mc_predict if lead is not None
                      else dispatch.mc_predict_pre_haloed)
                ready = refs()
                measure(f"mc_predict_f{fmt}{geo}",
                        lambda fn=fn, a=(ready, dy, dx, inter): fn(*a))

                def step(fn=fn, refs=refs, dy=dy, dx=dx, inter=inter):
                    return fn(refs(), dy, dx, inter)
            else:
                step = _engine_mc(dispatch, tiles, planes, dy, dx, inter,
                                  fmt, lead is None)
            measure(f"mc_step_f{fmt}{geo}", step)
            # the yardstick: one torch.take of the flat indices of all three
            src, idx = take_of(tuple(torch.stack(p, -3) for p in planes),
                               dy, dx, inter)
            if not torch.equal(torch.take(src, idx),
                               torch.cat([p.reshape(-1) for p in step()])):
                raise AssertionError(f"torch.take differs from the MC step "
                                     f"at format {fmt}{geo}")
            measure(f"take_f{fmt}{geo}", lambda src=src, idx=idx: torch.take(src, idx))

    # code_plane at qp 28: the 1080p luma and chroma planes, G = 4 luma,
    # flat and under the quant matrix; block_pack of the luma plane's
    # levels at 16 words in both syntaxes
    from video_encoder_tpu_torch.codec import entropy, tables
    q28 = int(tables.load(dev).QSTEP[28])
    luma_levels = None
    for name, shape in (("code_plane_luma", (h, w)),
                        ("code_plane_chroma", (ch, cw)),
                        ("code_plane_g4", (g, h, w))):
        base = t32(texture(rng, *shape[-2:])[:shape[-2], :shape[-1]])
        cur_c = base.expand(shape).contiguous()
        pred_c = torch.roll(cur_c, (2, -3), (-2, -1)).contiguous()
        q = torch.full((*shape[:-2], shape[-2] // 8, shape[-1] // 8), q28,
                       dtype=torch.int32, device=dev)
        for qmat in (False, True):
            measure(name + ("_qmat" if qmat else ""),
                    lambda a=(cur_c, pred_c, q, 8, qmat): dispatch.code_plane(*a))
        if name == "code_plane_luma":
            luma_levels = dispatch.code_plane(cur_c, pred_c, q, 8)[0]
    flat = luma_levels.reshape(-1, 64)
    dcp = entropy._dc_pred_left(luma_levels).reshape(-1).contiguous()
    measure("block_pack_f1", lambda: dispatch.block_pack(flat, 16))
    measure("block_pack_f2", lambda: dispatch.block_pack(flat, 16, dcp, 2))

    # the SEA search (TVC_SEA=1) on phase 3's three references of the
    # 1080p pan's frame 1, each beside the exhaustive search on the same
    # planes: single, G = 4 (recon, clean, noise, recon) and the frame's
    # four pre-haloed row shards against the recon
    src, refs = sea_references(dev, rng)
    cur1 = src[1]
    cases = [(name, dispatch.full_search, (cur1, ref_t))
             for name, ref_t in refs.items()]
    cases.append(("g4", dispatch.full_search, (
        torch.stack([cur1] * g),
        torch.stack([refs[n] for n in ("recon", "clean", "noise", "recon")]))))
    cases.append(("rows", dispatch.full_search_pre_haloed,
                  (rows_of(cur1), ext_rows(refs["recon"], 16))))
    for name, fn, a in cases:
        for on in (False, True):
            with sea(on):
                measure(f"{'sea' if on else 'fs'}_{name}",
                        lambda fn=fn, a=a: fn(*a))
    # the merges on the real 1080p frame's sources (stage 1, then stage 2
    # on its strings; chunk_merge on its pieces at 24 words) and on dense
    # pieces; device ops per call in each entry's kernels
    for tag, (mh, mw), dense in (("", (h, w), False), ("_dense", (256, 128), True)):
        srcs, plan = span_sources(rng, dev, mh, mw, dense)
        a1 = (*srcs, plan.m1, plan.cw1, plan.n1)
        measure("span_merge_mb" + tag, lambda a1=a1: dispatch.span_merge_mb(*a1))
        if plan.two_stage:
            s1 = dispatch.span_merge_mb(*a1)
            a2 = (s1[0], s1[1], plan.g, plan.stop, plan.cwf)
            measure("span_merge" + tag, lambda a2=a2: dispatch.span_merge(*a2))
    words, bits, kc = chunk_pieces(rng, dev)
    full = as_words(rng.integers(0, 2**32, tuple(words.shape), dtype=np.uint64),
                    words)
    full_bits = torch.full_like(bits, 32 * words.shape[1])
    measure("chunk_merge", lambda: dispatch.chunk_merge(words, bits, kc))
    measure("chunk_merge_dense", lambda: dispatch.chunk_merge(full, full_bits, kc))
    # the frame emit's whole pack of the real frame (block_pack and the tail)
    for k, f in frame_pack_figures(rng, dev, "").items():
        out[f"frame_pack_{k}"] = f

    # one G = 4 lockstep GOP of 30 1080p frames (the full cell) under each
    # emit: the eager loop's peak allocated memory and download bytes
    # (gop_memory), and the batch's time through its graph and eager
    ph, pw = AB_CELL[:2]
    clip = synth_clip(30, ph, pw, 11, FULL["passes"], FULL["scale"])
    inputs = tuple(up(p, mult)[:, None].expand(-1, g, -1, -1).contiguous()
                   for p, mult in zip(clip, (16, 8, 8)))
    for emit in ("frame", "chunks"):
        eng = GopEngine(config_of(FULL, pw, ph, 30), device=dev, emit=emit)
        f = gop_memory(eng, inputs, [28] * g)
        for loop, fn in (("graph", lambda: eng.run_batch(*inputs, [28] * g)),
                         ("eager", lambda: eager_run(eng, *inputs, [28] * g))):
            for _ in range(3):      # eager, capture, replay
                fn()
            torch.cuda.synchronize()
            f[f"{loop}_ms"] = time_ms(fn, budget_s=2.0)
        f["ms"] = f["graph_ms"]
        out[f"lockstep_g{g}_{emit}"] = f
        del eng

    # the cells: device ops per frame and the search's device time per GOP
    ph, pw, n = AB_CELL
    for m in (FULL, CONFIG3, V4):
        clip = (synth_clip_halfpel if m["clip"] == "halfpel" else synth_clip)(
            n, ph, pw, 11, m["passes"], m["scale"])
        eng = GopEngine(config_of(m, pw, ph, n), device=dev)
        y, cb, cr = up(clip[0], 16), up(clip[1], 8), up(clip[2], 8)
        o = eng.run(y, cb, cr, 28)
        ops, busy, top = device_ops(lambda: eng.run(y, cb, cr, 28), n,
                                    CODE_KERNELS + SAD_KERNELS)
        out[f"cell_{m['tag']}"] = dict(
            ops_per_frame=ops, busy=busy, top=top,
            search=[t for t in top if any(s in t[0] for s in SAD_KERNELS)],
            sum=_checksum([o["words"], o["bits"]]))
        if m["fmt"] >= 3:
            # the I frame: wall ms (ms), device time, device ops (kernels)
            f = i_frame_figures(eng, y, cb, cr)
            out[f"i_frame_{m['tag']}"] = dict(
                ms=f["wall_ms"], device_ms=f["device_ms"],
                kernels=f["device_ops"], launches=f["launches"], top=f["top"],
                sum=f["sum"])
    # the diamond search on the pan: the even map and the descent (one
    # kernel, or the plain walk and sad_at_mv where the checkout has no
    # descent kernel); last, and traced over 4 calls, as a plain route's
    # 700 kernels a call make large traces
    measure("diamond_search", lambda: dispatch.diamond_search(cur, ref), 4)
    measure("diamond_search_g", lambda: dispatch.diamond_search(curg, refg), 4)
    out["launches"] = {k: v for k, v in build.LAUNCHES.items() if v}
    return out


def _engine_mc(dispatch, tiles, planes, dy, dx, inter, fmt, haloed):
    """The MC of a P frame step as the engine composed it before it had
    one predictor launch (a checkout from before the predictor): a fetch
    per plane, under format 4 one per parity plane and a per-block
    select, then the masks."""
    def step():
        m_y = inter.repeat_interleave(16, -2).repeat_interleave(16, -1)
        m_c = inter.repeat_interleave(8, -2).repeat_interleave(8, -1)
        cdy, cdx = dy >> 1, dx >> 1
        if haloed and fmt >= 4:
            f = (tiles._hpel_mc_haloed(planes[0], dy, dx, 16, 16),
                 tiles._hpel_mc_haloed(planes[1], cdy, cdx, 8, 8),
                 tiles._hpel_mc_haloed(planes[2], cdy, cdx, 8, 8))
        elif haloed:
            f = (dispatch.mc_fetch_pre_haloed(planes[0][0], dy, dx, 16, 16),
                 dispatch.mc_fetch_pre_haloed(planes[1][0], cdy, cdx, 8, 8),
                 dispatch.mc_fetch_pre_haloed(planes[2][0], cdy, cdx, 8, 8))
        elif fmt >= 4:
            f = (dispatch.mc_fetch_luma_plane_hpel(planes[0][0], dy, dx,
                                                   planes[0]),
                 dispatch.mc_fetch_chroma_plane_hpel(planes[1][0], cdy, cdx),
                 dispatch.mc_fetch_chroma_plane_hpel(planes[2][0], cdy, cdx))
        else:
            f = (dispatch.mc_fetch_luma_plane(planes[0][0], dy, dx),
                 dispatch.mc_fetch_chroma_plane(planes[1][0], cdy, cdx),
                 dispatch.mc_fetch_chroma_plane(planes[2][0], cdy, cdx))
        return (torch.where(m_y, f[0], 128), torch.where(m_c, f[1], 128),
                torch.where(m_c, f[2], 128))
    return step


def ab_main(roots) -> int:
    """--ab: ab_child of each root in a child process, in the turns
    roots, then roots reversed; prints each turn's JSON line, then a
    summary (each root's mean per timing) beside the card; 1 if a result
    differs between roots."""
    card = card_line()
    results = {r: [] for r in roots}
    t0 = time.perf_counter()
    for root in roots + roots[::-1]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--ab-child", root], capture_output=True, text=True)
        sys.stderr.write(r.stderr[-4000:])
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("AB ")]
        if r.returncode != 0 or not line:
            print(r.stdout[-4000:])
            raise SystemExit(f"chip_smoke --ab: the turn of {root} failed "
                             f"({r.returncode})")
        results[root].append(json.loads(line[-1][3:]))
        print(line[-1], flush=True)
    summary, sums = {}, {}
    for root, runs in results.items():
        keys = [k for k, v in runs[0].items() if isinstance(v, dict) and "ms" in v]
        summary[root] = {k: {f: sum(r[k][f] for r in runs) / len(runs)
                             for f in ("ms", "device_ms", "host_ms", "kernels",
                                       "graph_ms", "eager_ms", "peak_mib",
                                       "gop_peak_mib", "download_bytes_per_gop",
                                       "words_bytes_per_gop")
                             if f in runs[0][k]}
                         for k in keys}
        summary[root].update({k: runs[0][k] for k in runs[0] if k.startswith("cell_")})
        for k in keys:         # launch counts are the same in every turn
            if "launches" in runs[0][k]:
                summary[root][k]["launches"] = runs[0][k]["launches"]
        for r in runs:
            for k, v in r.items():
                if isinstance(v, dict) and "sum" in v:
                    sums.setdefault(k, set()).add(v["sum"])
    differ = sorted(k for k, v in sums.items() if len(v) > 1)
    print(json.dumps(dict(card=card, seconds=time.perf_counter() - t0,
                          results_differ=differ, summary=summary)))
    return 1 if differ else 0


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--cli-child"]:
        return cli_child(args[1:])
    if args[:1] == ["--ab-child"]:
        print("AB " + json.dumps(dict(root=args[1], **ab_child(args[1]))),
              flush=True)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs one GPU",
              file=sys.stderr)
        return 1
    if args[:1] == ["--ab"]:
        return ab_main(args[1:] or [ROOT])
    from video_encoder_tpu_torch.ops.kernels import build
    from video_encoder_tpu_torch.pipeline.gop_engine import GopEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE, 0)
    card = card_line()
    t_start = time.perf_counter()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    build.lib()
    log(f"build: kernels in {time.perf_counter() - t0:.2f} s (nvcc "
        f"{build.build_seconds:.2f} s)")
    for name, regs, spill_st, spill_ld in ptxas_summary(build.build_log):
        log(f"  ptxas: {name}: {regs} registers, {spill_st} bytes spill "
            f"stores, {spill_ld} bytes spill loads")

    rows = phase_kernels(dev, card)
    log(f"kernels done at {time.perf_counter() - t_start:.1f} s; "
            f"{mem()}")

    build_oracle()
    path_launches = []
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {name: start_job(tmp, *args) for name, args in (
            ("full", (FULL, 1920, 1080, 30, 30)),
            ("config3", (CONFIG3, 1920, 1080, 30, 30)),
            ("v4", (V4, 1920, 1080, 30, 30)),
            ("intra", (FULL, 640, 360, 30, 1)),
            ("v2", (V2_SMALL, 640, 360, 12, 12)),
            ("v3", (V3_SMALL, 640, 360, 12, 4)))}
        # the batched path's referee: config 3 again at GOP 10
        batched_oracle = start_job(tmp, CONFIG3, 1920, 1080, 30, 10,
                                   like=jobs["config3"])
        # the tile path's referee under format 4: intra slices of 17 MB rows
        jobs["v4i17"] = start_job(tmp, V4_ISLICE, 1920, 1080, 30, 30,
                                  like=jobs["v4"])
        # the golden phase's hier referee, on the format-2 clip
        hier_oracle = start_job(tmp, HIER_SMALL, 640, 360, 12, 12,
                                like=jobs["v2"])
        wait_oracles([*jobs.values(), batched_oracle, hier_oracle])
        log(f"oracle encodes done at {time.perf_counter() - t_start:.1f} s; "
            f"{mem()}")
        summaries, streams = {}, {}
        for name, job in jobs.items():
            launches, summaries[name], streams[name] = phase_slice(job, card)
            path_launches.append(launches)
        for name in ("config3", "v4"):
            path_launches.append(
                phase_other_emit(jobs[name], streams[name], card))
        path_launches += phase_graphs(jobs, streams, card)
        log(f"single-GOP paths done at {time.perf_counter() - t_start:.1f} s"
            f"; {mem()}")
        decode_paths, decode_summaries, decode_per_frame = phase_decode(
            tmp, jobs, card)
        path_launches += decode_paths
        log(f"decode paths done at {time.perf_counter() - t_start:.1f} s; "
            f"{mem()}")
        path_launches.append(phase_golden(tmp, jobs, hier_oracle, card))
        log(f"golden paths done at {time.perf_counter() - t_start:.1f} s; "
            f"{mem()}")
        decode_fps = phase_speed_decode(
            [(k, jobs[k]) for k in ("full", "config3", "v4")],
            decode_summaries, card)
        log(f"decode speed done at {time.perf_counter() - t_start:.1f} s; "
            f"{mem()}")
        batched_paths, plains = phase_batched(tmp, jobs, batched_oracle, card)
        path_launches += batched_paths
        path_launches += phase_decode_graphs(tmp, plains, batched_oracle,
                                             card)
        log(f"GOP-10 decode graphs done at "
            f"{time.perf_counter() - t_start:.1f} s; {mem()}")
        t_aux = time.perf_counter()
        per_frame_paths, per_frame = phase_per_frame(tmp, jobs, summaries,
                                                     card)
        path_launches += per_frame_paths
        path_launches += phase_aux(tmp, plains, card)
        log(f"per-frame and aux paths done at {time.perf_counter() - t_start:.1f}"
            f" s ({time.perf_counter() - t_aux:.1f} s); {mem()}")
        path_launches += phase_tiled(tmp, jobs, streams, plains, card)
        log(f"tiled paths done at {time.perf_counter() - t_start:.1f} s; "
            f"{mem()}")
        path_launches += phase_sea(tmp, jobs, streams, plains, card)
        log(f"TVC_SEA=1 paths done at {time.perf_counter() - t_start:.1f} s; "
            f"{mem()}")
        twopass_job = dict(jobs["v2"], gop=4, mode=TWOPASS_SMALL,
                           tag="640x360_gop4_twopass")
        path_launches.append(phase_twopass(tmp, twopass_job, card))
        t_ranks = time.perf_counter()
        path_launches += phase_distributed(tmp, jobs, plains, batched_oracle,
                                           card)
        log(f"rank paths done at {time.perf_counter() - t_start:.1f} s "
            f"({time.perf_counter() - t_ranks:.1f} s); {mem()}")
        t_ring = time.perf_counter()
        path_launches += phase_ring_grid(jobs, plains, card)
        log(f"ring and 2-D grid paths done at "
            f"{time.perf_counter() - t_start:.1f} s "
            f"({time.perf_counter() - t_ring:.1f} s); {mem()}")
    log(f"paths done at {time.perf_counter() - t_start:.1f} s")
    for name, row in rows.items():
        row["launches"] = sum(p[name] for p in path_launches)
    for name in ("recon_plane", "recon_plane_rows"):
        rows[name]["launches_per_decoded_frame"] = decode_per_frame[name]
    # the chroma twin of sad_at_mv, the whole SAD map and chunk_merge have
    # no caller on any encode path (nor in the reference), and neither have
    # their batched forms; the single-plane fetches no longer have one (the
    # predictor serves a P step): they are held against their plain
    # versions above only
    for name in ("sad_at_mv_chroma", "sad_at_mv_chroma_g", "sad_map",
                 "sad_map_g", "chunk_merge", *SINGLE_FETCHES):
        rows[name]["on_path"] = False
    check_launches("the main paths", {k: r["launches"] for k, r in rows.items()},
                   [k for k, r in rows.items() if r.get("on_path", True)])
    table = {r["row"].rstrip("cqvhmsrd") for r in rows.values()}
    if table != {str(i) for i in range(1, 18)} or set(rows) != set(TABLE_ROW):
        raise AssertionError(f"kernel table rows {sorted(table)}, counters "
                             f"{sorted(set(TABLE_ROW) ^ set(rows))} unheld")
    fps, traces = phase_speed([(FULL, jobs["full"]["clip"], ["frame", "chunks"]),
                       (CONFIG3, jobs["config3"]["clip"], ["frame", "chunks"]),
                       (V4, jobs["v4"]["clip"], [GopEngine.emit])], card)
    log(f"single-GOP speed done at {time.perf_counter() - t_start:.1f} s; "
            f"{mem()}")
    lockstep = phase_speed_batched(
        [(m, jobs[k]["clip"]) for m, k in ((FULL, "full"), (CONFIG3, "config3"),
                                           (V4, "v4"))], traces, card)
    log(f"lockstep speed done at {time.perf_counter() - t_start:.1f} s; "
            f"{mem()}")
    tiled = phase_speed_tiled(FULL, jobs["full"]["clip"], card)
    log(f"result: 1080p GOP-30 tiled, graph and eager {json.dumps(tiled)} "
        f"[{card}]")
    t_ring = time.perf_counter()
    ring_grid = phase_speed_ring_grid(FULL, jobs["full"]["clip"], card)
    log(f"result: 1080p GOP-30 ring (D = 4) and 2-D grid (2 x 2), graph and "
        f"eager {json.dumps(ring_grid)} [{card}]; "
        f"{time.perf_counter() - t_ring:.1f} s")
    sea_fps = phase_speed_sea(FULL, jobs["full"]["clip"], card)
    log(f"result: 1080p GOP-30 full search with and without TVC_SEA "
        f"{json.dumps(sea_fps)} [{card}]")
    log(f"result: 1080p GOP-30 lockstep {json.dumps(lockstep)} [{card}]")
    log(f"result: 1080p 30-frame per-frame engine (CLI wall fps through "
        f"its graphs and eager, the GOP engine's beside it; one P frame's "
        f"device ops, ms and host calls, replayed and eager) "
        f"{json.dumps(per_frame)} [{card}]")
    log(f"result: 1080p GOP-30 decode fps {json.dumps(decode_fps)} on "
        f"{os.cpu_count()} host cores [{card}]")
    log(f"result: 1080p GOP-30 device-resident fps {json.dumps(fps)}; CLI wall "
        + ", ".join(f"{k} {summaries[k]['wall_fps']} fps"
                    for k in ("full", "config3", "v4"))
        + f" [{card}]; whole run {time.perf_counter() - t_start:.1f} s")

    print(card)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
