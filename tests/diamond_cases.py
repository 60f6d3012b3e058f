"""Even SAD maps that walk the diamond descent through its corner cases,
for the descent kernel's CPU model (test_torch_kernel_models.py) and its
card tests (test_torch_kernels.py). The descent reads the map as given, so
a crafted map sets each MB's walk exactly; the final ±1 step still takes
its four SADs from the planes. Also the plane pairs both files search
(`planes`). No JAX here: the card host imports it.

Each MB of the grid takes one case, in turn:

- start511 / start512: the cost at (0, 0) is 511 (frozen before the
  first step) or 512 (it walks), a neighbour costing 100;
- mid511 / mid512: the walk's first move lands on a cost of 511 (frozen
  there) or 512 (it walks on to a cost of 100);
- tie4: all four neighbours tie below the current cost (up, the first,
  wins); tie_current: a neighbour ties with the current cost (no move);
  tie_right_down: right and down tie (right wins);
- no_freeze: costs of 1000 and more fall towards a corner of the window,
  so the walk moves in each of its 16 steps, along the window's edge to
  the corner, and the final step there meets candidates outside ±16;
- flat: every entry equal (no move); random: every entry random.
"""

import numpy as np

CASES = ("start511", "start512", "mid511", "mid512", "tie4", "tie_current",
         "tie_right_down", "no_freeze", "flat", "random")
NE = 17


def _at(cost, dy, dx, v):
    cost[(dy + 16) // 2, (dx + 16) // 2] = v


def _case_map(rng, case):
    """One MB's 17 x 17 even map (row (dy + 16) / 2, column (dx + 16) / 2)
    for `case`: a background of 3000-60000 with the case's entries."""
    cost = rng.integers(3000, 60000, (NE, NE))
    if case in ("start511", "start512"):
        _at(cost, 0, 0, int(case[-3:]))
        _at(cost, 2, 0, 100)
    elif case in ("mid511", "mid512"):
        _at(cost, 0, 0, 900)
        _at(cost, 0, 2, int(case[-3:]))
        _at(cost, 0, 4, 100)
    elif case == "tie4":
        _at(cost, 0, 0, 900)
        for dy, dx in ((-2, 0), (0, -2), (0, 2), (2, 0)):
            _at(cost, dy, dx, 700)
    elif case == "tie_current":
        _at(cost, 0, 0, 900)
        _at(cost, 0, 2, 900)
    elif case == "tie_right_down":
        _at(cost, 0, 0, 900)
        _at(cost, 0, 2, 700)
        _at(cost, 2, 0, 700)
    elif case == "no_freeze":
        sy, sx = rng.choice([-1, 1], 2)
        d = np.arange(-16, 17, 2)
        cost = 1000 + 50 * ((16 - sy * d)[:, None] + (16 - sx * d)[None, :])
    elif case == "flat":
        cost[:] = 3000
    else:
        cost = rng.integers(0, 65281, (NE, NE))
    return cost


def crafted_maps(rng, lead, nby, nbx):
    """(maps [*lead, nby, nbx, 289] int32, cases [*lead, nby, nbx] of the
    case names): MB m of the flattened grid takes CASES[m % 10]."""
    n = int(np.prod(lead, dtype=np.int64)) * nby * nbx
    names = np.array([CASES[m % len(CASES)] for m in range(n)])
    maps = np.stack([_case_map(rng, c).reshape(-1) for c in names])
    return (maps.reshape(*lead, nby, nbx, NE * NE).astype(np.int32),
            names.reshape(*lead, nby, nbx))


def planes(rng, kind, lead, h, w):
    """(cur, ref) [*lead, h, w] of 0-255: random noise; a smooth texture
    panned by (2, -4) with noise ±2; long-wave sinusoids moved by
    (16, -16), down which most walks run all 16 steps to the window's
    corner (and the MBs on the frame's edges read past it through the
    clamp); flat planes, where every candidate ties."""
    if kind == "random":
        return (rng.integers(0, 256, (*lead, h, w)),
                rng.integers(0, 256, (*lead, h, w)))
    if kind == "flat":
        return np.full((*lead, h, w), 90), np.full((*lead, h, w), 90)
    if kind == "corner":
        yy, xx = np.mgrid[0:h + 64, 0:w + 64]
        phase = rng.uniform(0, 2 * np.pi, (*lead, 1, 1))
        base = np.round(128 + 60 * np.sin(2 * np.pi * yy / 97 + phase)
                        + 60 * np.cos(2 * np.pi * xx / 89)).astype(np.int64)
        return base[..., 32:32 + h, 32:32 + w], base[..., 16:16 + h, 48:48 + w]
    base = rng.integers(0, 256, (*lead, h + 64, w + 64)).astype(np.int64)
    for _ in range(4):
        base = (base + np.roll(base, 1, -2) + np.roll(base, 1, -1)
                + np.roll(base, 2, -2) + np.roll(base, 2, -1)) // 5
    base = (base - base.min()) * 255 // max(int(base.max() - base.min()), 1)
    ref = base[..., 30:30 + h, 36:36 + w]
    return (base[..., 32:32 + h, 32:32 + w],
            np.clip(ref + rng.integers(-2, 3, ref.shape), 0, 255))


def near_planes(rng, lead, h, w):
    """(cur, ref) [*lead, h, w] int64 of 0-255: a smooth texture of low
    contrast (100-107) and the same plus noise of ±2, with a flat corner,
    so the final step's SADs (a few hundred at any vector) compete with
    the crafted costs."""
    base = rng.integers(0, 256, (*lead, h, w)).astype(np.int64)
    for _ in range(3):
        base = (base + np.roll(base, 1, -2) + np.roll(base, 1, -1)) // 3
    base = 100 + base // 32
    ref = base + rng.integers(-2, 3, base.shape)
    base[..., :32, :32] = 77
    ref[..., :48, :48] = 77
    return base, ref
