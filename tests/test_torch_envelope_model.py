"""The integer arithmetic of CUDA kernel K5 (csrc/edt_envelope.cu), modelled
in numpy and held against the envelope's spec on the CPU.

`envelope_line` below is, per line, exactly what a thread of the kernel
runs: the linear-time lower envelope over the line's sites with a
multiply-compare pop test (`num >= start * den` in place of a floor
division), one non-negative division per pushed entry, entries whose start
lies beyond the line dropped, the stack kept as records whose slots are
the sites' positions (with a link to the entry below) or the stack's depths
(the kernel chooses per warp by how dense its lines are; here every other
line runs in each layout), and a single walk from the last position down
that moves at most one entry per position. Python integers carry the
values, and every intermediate is asserted to fit int32.

Each fixture is held against `edt_envelope.envelope_plain` (the port's
spec), distances and payloads, and, where its values stay below 2^24,
against the JAX package's `envelope_pass` (its `_envelope_xla` route on the
CPU). That route computes candidates in float32, which is exact only below
2^24, so the fixtures whose g lies near MISS - 1 = 2^27 - 1 are held against
the integer spec and a brute-force int64 minimum instead.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu.ops import edt_envelope as jenv
from gpu_voxels_tpu_torch.constants import PBA_UNINITIALISED_PACKED
from gpu_voxels_tpu_torch.ops import edt_envelope as tenv

MISS = tenv.MISS
I32_MAX = 2**31 - 1
A, C = 3, 8  # 24 lines per fixture
KINDS = ("ties", "dense0", "decreasing", "increasing", "empty", "single", "random")
F32_EXACT = ("ties", "dense0", "empty", "single", "random")  # every candidate below 2^24
LENGTHS = (1, 2, 31, 32, 33, 250, 1024)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The spec is n small torch ops per grid; beside other busy test
    processes their thread barriers cost more than they save."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def i32(*values: int) -> None:
    for v in values:
        assert -I32_MAX - 1 <= v <= I32_MAX, f"{v} leaves int32"


def envelope_line(g: np.ndarray, pay: np.ndarray, stats: dict, dense: bool):
    """(distances, payloads) of one line, as a thread of K5 computes them.
    The stack is an array of records (start | link << 16, g). In the dense
    layout an entry's slot is its site's position and link names the entry
    below (its site + 1, 0: none); in the sparse layout the slot is the
    entry's depth and link its site. The kernel chooses per warp; both must
    give the same result and never write over a live entry."""
    n = len(g)
    rec = {}  # slot -> (start | link << 16, g of the site)
    top = None  # (site, start, g, slot, slot below or -1), the registers' copy
    live = []  # the slots of the entries on the stack

    def entry_at(slot):
        word, gv = rec[slot]
        if dense:
            return slot, word & 0xFFFF, gv, slot, (word >> 16) - 1
        return word >> 16, word & 0xFFFF, gv, slot, slot - 1

    for j in range(n):
        gj = int(g[j])
        if gj >= MISS:
            continue
        num, den = 0, 1
        while top is not None:
            tv, tz, tg, _, below = top
            num = (j - tv) * (j + tv) + gj - tg
            den = 2 * (j - tv)
            i32(num, den, tz * den, (j - tv) * (j + tv))
            stats["num"] = max(stats["num"], abs(num))
            if num >= tz * den:  # floor(num / den) >= tz: the top keeps [tz, floor(num / den)]
                break
            top = entry_at(below) if below >= 0 else None
            live.pop()
        if top is not None:
            assert num >= 0 and den > 0  # the kernel divides unsigned
            start = num // den + 1
        else:
            start = 0
        i32(start)
        if start < n:
            assert top is None or start > top[1], "starts grow strictly along the stack"
            top_slot = top[3] if top is not None else -1
            slot = j if dense else top_slot + 1
            assert 0 <= slot < n and slot not in live, "a new entry takes a free slot of the array"
            word = start | ((top_slot + 1 if dense else j) << 16)
            i32(word)
            rec[slot] = (word, gj)
            top = (j, start, gj, slot, top_slot)
            assert entry_at(slot) == top, "the record packs and unpacks"
            live.append(slot)
            stats["depth"] = max(stats["depth"], len(live))
    out_d = np.empty(n, np.int64)
    out_p = np.empty(n, np.int64)
    v, z, gv, _, below = top if top is not None else (-1, 0, MISS, -1, -1)
    for x in range(n - 1, -1, -1):  # from the last position down
        if x < z:  # one step per position is enough
            v, z, gv, _, below = entry_at(below)
            assert x >= z
        d = (x - v) * (x - v) + gv
        i32(d)
        hit = d < MISS
        out_d[x] = d if hit else MISS
        out_p[x] = int(pay[v]) if hit else PBA_UNINITIALISED_PACKED
    assert z == 0 and below == -1 or top is None, "the walk ends on the bottom entry"
    return out_d, out_p


def fixture(kind: str, n: int):
    """int32 g [A, n, C] (MISS = no site) and int32 payloads."""
    rng = np.random.default_rng(1000 * n + KINDS.index(kind))
    shape = (A, n, C)
    pos = np.arange(n).reshape(1, n, 1)
    if kind == "ties":  # sites at offset 0 on two of three positions
        g = np.where(pos % 3 == 0, MISS, 0) + np.zeros(shape, np.int64)
    elif kind == "dense0":  # every position a site: the stack reaches depth n
        g = np.zeros(shape, np.int64)
    elif kind in ("decreasing", "increasing"):
        # from MISS - 1 towards 0 in steps of random size; the last column
        # alternates 0 and MISS - 1, the largest |num|
        steps = rng.integers(0, 2 * (MISS // max(n, 1)), shape)
        g = np.clip(MISS - 1 - np.cumsum(steps, axis=1) + steps, 0, MISS - 1)
        g[:, :, -1] = np.where(pos[:, :, 0] % 2 == 0, 0, MISS - 1)
        g[:, :, -2] = MISS - 1 - pos[:, :, 0]  # a slope of 1 at the top of the range
        if kind == "increasing":
            g = g[:, ::-1, :]
    elif kind == "empty":
        g = np.full(shape, MISS, np.int64)
    elif kind == "single":
        g = np.full(shape, MISS, np.int64)
        g[:, n // 3, :] = rng.integers(0, 50, (A, C))
    else:
        g = rng.integers(0, 12, shape)  # small values: many equidistant ties
        g[rng.random(shape) < 0.6] = MISS
        g[:, :, 3] = MISS  # a column with no site at all
    pay = rng.integers(0, 2**30, shape)
    return np.ascontiguousarray(g).astype(np.int32), pay.astype(np.int32)


@functools.lru_cache(maxsize=None)
def reference(n: int) -> dict:
    """The JAX package's envelope_pass over the float32-exact fixtures of
    one line length, stacked along axis 0 (one compilation per length)."""
    grids = [fixture(kind, n) for kind in F32_EXACT]
    g = np.concatenate([x for x, _ in grids])
    pay = np.concatenate([p for _, p in grids]).view(np.uint32)
    d, p = jenv.envelope_pass(jnp.asarray(g), jnp.asarray(pay))
    d, p = np.asarray(d), np.asarray(p).view(np.int32)
    return {kind: (d[i * A : (i + 1) * A], p[i * A : (i + 1) * A]) for i, kind in enumerate(F32_EXACT)}


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_arithmetic_matches_spec_and_reference(kind, n):
    g, pay = fixture(kind, n)
    stats = {"num": 0, "depth": 0}
    got_d = np.empty((A, n, C), np.int64)
    got_p = np.empty((A, n, C), np.int64)
    for a in range(A):
        for c in range(C):
            dense = (a * C + c) % 2 == 0  # every other line in each layout
            got_d[a, :, c], got_p[a, :, c] = envelope_line(g[a, :, c], pay[a, :, c], stats, dense)

    spec_d, spec_p = tenv.envelope_plain(torch.tensor(g), torch.tensor(pay), 1)
    np.testing.assert_array_equal(got_d, spec_d.numpy())
    np.testing.assert_array_equal(got_p, spec_p.numpy())
    if kind in F32_EXACT:
        ref_d, ref_p = reference(n)[kind]
        np.testing.assert_array_equal(got_d, ref_d)
        np.testing.assert_array_equal(got_p, ref_p)

    if n <= 250:  # the same minimum by brute force in int64 ([A, C, n, n] candidates)
        q = np.arange(n)
        gl = np.moveaxis(g, 1, -1).astype(np.int64)[..., None, :]
        best = np.where(gl >= MISS, 2**40, (q[:, None] - q[None, :]) ** 2 + gl).min(-1)
        np.testing.assert_array_equal(np.moveaxis(got_d, 1, -1), np.where(best < MISS, best, MISS))

    if kind == "dense0":
        assert stats["depth"] == n, "every position starts its own segment"
    if kind == "empty":
        assert (got_d == MISS).all() and (got_p == PBA_UNINITIALISED_PACKED).all()
    if kind in ("decreasing", "increasing") and n > 1:
        assert stats["num"] >= MISS - 1 - n, "the fixture reaches the largest |num|"
