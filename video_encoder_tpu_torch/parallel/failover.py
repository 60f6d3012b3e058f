"""Failure detection and elastic recovery: GOPs are the recovery unit.

Twin of `video_encoder_tpu/parallel/failover.py`. GOPs are closed under
prediction, so a failed GOP (or a failed batch of a rank group) can be
encoded again on any surviving engine, and the ordered mux is indifferent
to who produced a packet. The fault injector exercises the re-dispatch
path without losing a card.

The survivor is a second `GopEngine`: on the next card where the host has
one, otherwise on the same card; never the CPU unless the run asked for
the CPU (`survivor_device`). The reference's survivor is its golden model
(`GoldenGopAdapter`), which the port has too, but a survivor on the host
would carry a card's work on the CPU and hide a kernel that fails to
launch; a second `GopEngine` writes the same bytes. A sticky CUDA error (an illegal address, a
device-side assert) can leave the card unusable for the rest of the
process, so a survivor on the same card may not survive it; the next card
does.
"""

from __future__ import annotations

import json
import logging
import sys

import torch

from ..codec.bitstream import FramePacket
from ..codec.frame import Frame

log = logging.getLogger("video_encoder_tpu_torch.failover")


class GopFailure(RuntimeError):
    """Raised when a GOP's encode result is lost or invalid."""


# What counts as a recoverable engine failure: CUDA errors and a rank that
# exits are RuntimeErrors (as injected GopFailures are); OSError covers
# transport drops. Programming errors (TypeError, ValueError,
# AssertionError) still propagate: retrying those would loop forever on a
# deterministic bug.
RECOVERABLE = (RuntimeError, OSError)


class FaultInjector:
    """Test hook: fails the Nth encode attempt of the listed GOP indices."""

    def __init__(self, fail_gops: set[int], times: int = 1):
        self._remaining = {g: times for g in fail_gops}
        self.injected = 0

    def check(self, gop_index: int) -> None:
        if self._remaining.get(gop_index, 0) > 0:
            self._remaining[gop_index] -= 1
            self.injected += 1
            raise GopFailure(f"injected fault on gop {gop_index}")


def survivor_device(device) -> torch.device:
    """The next card after `device` where the host has more than one, else
    `device` itself (the CPU only if `device` is the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return torch.device("cuda", (index + 1) % torch.cuda.device_count())


def redispatched(firsts: list[int], err: Exception, survivor) -> None:
    """The reference's stderr line for work moved to the survivor, naming
    the survivor's device."""
    print(json.dumps({"failover": "device batch failed, re-dispatching on "
                      "survivor", "firsts": list(firsts), "err": str(err),
                      "device": str(getattr(survivor, "device", "?"))}),
          file=sys.stderr, flush=True)


def encode_gops_with_recovery(
    primary,
    gops: list[list[Frame]],
    first_indices: list[int],
    fallback=None,
    max_retries: int = 2,
    fault: FaultInjector | None = None,
    stats: list | None = None,
) -> list[FramePacket]:
    """Encode GOPs with per-GOP retry and engine failover.

    primary/fallback expose encode_gop(frames, first_index) ->
    (packets, stats). A GOP that fails `max_retries` times on the primary
    is re-dispatched to the fallback engine (the survivor; redispatched
    prints the line); packets
    arrive whenever they arrive and the OrderedMux reorders them. `stats`,
    if given, collects each GOP's frame stats (the reference drops them).
    """
    packets: list[FramePacket] = []
    for gop, first in zip(gops, first_indices):
        attempt = 0
        while True:
            engine = primary if attempt < max_retries or fallback is None else fallback
            try:
                if fault is not None:
                    fault.check(first)
                pk, st = engine.encode_gop(gop, first)
                packets.extend(pk)
                if stats is not None:
                    stats.extend(st)
                break
            except RECOVERABLE as e:
                attempt += 1
                log.warning("gop %d failed (attempt %d): %s", first, attempt, e)
                # a bounded budget: the fallback gets its own max_retries
                # window, then the failure propagates
                budget = max_retries if fallback is None else 2 * max_retries
                if attempt > budget:
                    raise
                if attempt == max_retries and fallback is not None:
                    redispatched([first], e, fallback)
    return packets
