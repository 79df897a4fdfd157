"""Multi-robot swept-volume trajectory deconfliction (the swept_fitter core).

Counterpart of gpu_voxels_tpu/robot/fitter.py: pure Python over the map
methods. The searches branch on collision counts, so each `int(...)` below
reads one count from the device: those host reads are the algorithm. The
boolean criterion is `collide_with` (on maps without an occupancy summary:
CUDA kernel K7), the windowed one `collide_with_bitcheck` (kernel K4).

Reference: examples/swept_fitter/Fitter.{h,cpp} - `Fitter::fitInternal`
searches trajectory ORDERINGS over N robots (Fitter.cpp:71-116): a solution
assigns every robot one trajectory per time slot, and the slot-mates of all
earlier robots must not collide (`Fitter::collides`, where trajectory-pair
collision is `areColliding` between the two swept-volume maps,
Trajectory::collidesWith).

On top of the reference's boolean answer, the time-in-bits swept encoding
(SV bits 4..253, one per trajectory step) supports the finer question the
reference cannot ask: per-slot START-DELAY WINDOWS. `deconflict_slot`
assigns each slot-mate a relative start delay so that no pair occupies the
same voxel within +-margin trajectory steps (collide_with_bitcheck windows
over maps offset by shiftLeftSweptVolumeIDs, BitVector.h:361-402 - relative
offsets are capped at the reference's 56-bit shift limit), and
`fit_schedule` combines both searches into full conflict-free schedules.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

MAX_SV_SHIFT = 56  # performLeftShift cap (BitVector.h:361-402)


def iter_orderings(robots: Sequence, slot_predicate=None) -> Iterator[list]:
    """Lazily yield feasible trajectory orderings (Fitter.cpp:71-116).

    Generator form of `fit_orderings`: consumers that only need the first
    few solutions stop the factorial search early, like the reference's
    ``Fitter::fitInternal`` early exit. Yielded solutions are independent
    copies.
    """
    n_traj = len(robots[0][1])

    def collides(solution, r, index):
        _, maps = robots[r]
        _, m = maps[solution[r][index]]
        if slot_predicate is not None:
            prefix = [
                robots[r2][1][solution[r2][index]][1] for r2 in range(r)
            ] + [m]
            return not slot_predicate(prefix)
        for r2 in range(r - 1, -1, -1):
            _, m2 = robots[r2][1][solution[r2][index]]
            if int(m.collide_with(m2)) > 0:  # areColliding (GVL.cpp)
                return True
        return False

    def rec(solution, robot, index, todo):
        if index >= n_traj:
            if robot == len(robots) - 1:
                yield [list(s) for s in solution]
                return
            yield from rec(solution, robot + 1, 0, todo)
            return
        for _ in range(len(todo[robot])):
            traj = todo[robot].pop(0)
            solution[robot].append(traj)
            if not collides(solution, robot, index):
                yield from rec(solution, robot, index + 1, todo)
            todo[robot].append(traj)
            solution[robot].pop()

    yield from rec(
        [[] for _ in robots], 0, 0, [list(range(n_traj)) for _ in robots]
    )


def fit_orderings(
    robots: Sequence, all_solutions: bool = True, slot_predicate=None
) -> List[list]:
    """Fitter::fitInternal (Fitter.cpp:71-116): search trajectory orderings.

    ``robots`` is ``[(name, [(traj_name, swept_map), ...]), ...]``; every
    robot must carry the same number of trajectories (slots). Returns the
    list of solutions, each ``[per-robot list of trajectory indices]`` -
    ``solution[r][s]`` is the trajectory robot ``r`` runs in slot ``s``.
    With ``all_solutions=False`` the search stops at the first solution
    (the reference's early exit).

    By default slot-mates of earlier robots must not collide (boolean
    areColliding - the reference criterion). ``slot_predicate``, when given,
    replaces it: called with the slot's maps for robots ``0..r`` (the newly
    placed robot last) and returns True iff that partial slot is feasible -
    e.g. a delay-deconfliction predicate (`fit_schedule` with
    ``windows_in_search=True``). The predicate must be monotone (an
    infeasible prefix cannot become feasible by adding robots), which
    greedy `deconflict_slot` prefixes satisfy: a robot's delay never changes
    when later robots are appended.
    """
    it = iter_orderings(robots, slot_predicate=slot_predicate)
    if all_solutions:
        return list(it)
    first = next(it, None)
    return [] if first is None else [first]


def _pair_window_conflicts(m_a, m_b, rel: int, margin: int) -> int:
    """Time-windowed conflicts between two swept maps whose starts are
    offset by ``rel`` trajectory steps: compare a's step-t bits against b's
    step-(t+rel) bits within +-margin (the example's delay refinement -
    shift one map by the relative offset, then a margin bitcheck)."""
    if rel < 0:
        m_a, m_b, rel = m_b, m_a, -rel
    shifted = m_b if rel == 0 else m_b.shift_left_swept_volume_ids(rel)
    return int(m_a.collide_with_bitcheck(shifted, margin=margin))


def deconflict_slot(
    maps: Sequence,
    margin: int = 0,
    max_shift: int = MAX_SV_SHIFT,
    stride: int = 1,
) -> Optional[List[int]]:
    """Per-slot start-delay assignment over K slot-mate swept maps.

    Greedily picks the smallest relative delays ``d_i`` (``d_0 = 0``, each
    ``0 <= d_i <= max_shift``) such that every pair of slot-mates is free of
    time-windowed conflicts: no voxel shared within +-margin steps of each
    other's (delay-offset) timeline. Because each ``d_i`` is minimal given
    ``d_0..d_{i-1}``, a slot of pairwise-compatible trajectories (e.g. all
    boolean-non-colliding) keeps every delay at 0.

    Returns the K delays, or None if no assignment exists within
    ``max_shift`` (the reference shift cap). Relative pair offsets never
    exceed ``max_shift`` because all delays sit in [0, max_shift].
    """
    if max_shift > MAX_SV_SHIFT:
        raise ValueError(f"max_shift > {MAX_SV_SHIFT} exceeds the "
                         "performLeftShift cap (BitVector.h:361)")
    delays = [0]
    for i in range(1, len(maps)):
        found = None
        for d in range(0, max_shift + 1, stride):
            if all(
                _pair_window_conflicts(maps[j], maps[i], d - delays[j], margin) == 0
                for j in range(i)
            ):
                found = d
                break
        if found is None:
            return None
        delays.append(found)
    return delays


def fit_schedule(
    robots: Sequence,
    margin: int = 0,
    max_shift: int = MAX_SV_SHIFT,
    stride: int = 1,
    all_solutions: bool = False,
    windows_in_search: bool = False,
) -> List[Tuple[list, List[Optional[List[int]]]]]:
    """Full multi-robot schedules: ordering search + per-slot delay windows.

    For each ordering `fit_orderings` finds, assigns per-slot start delays
    via `deconflict_slot`. Returns ``[(solution, slot_delays)]`` where
    ``slot_delays[s][r]`` is robot r's start delay in slot s (None for a
    slot that cannot be deconflicted within the shift cap). With
    ``all_solutions=False`` the ordering search runs lazily and stops at
    the first ordering whose EVERY slot deconflicts (falling back to the
    FIRST ordering, annotated as-is, when none fully deconflicts).

    ``windows_in_search=True`` makes delay-deconflictability the slot
    criterion INSIDE the ordering recursion: orderings the reference's
    boolean fitter rejects (slot-mates sharing workspace) are kept whenever
    start delays can separate them in time - strictly more schedules than
    the boolean search, never fewer.
    """
    pred = None
    if windows_in_search:
        def pred(prefix_maps):
            return deconflict_slot(prefix_maps, margin, max_shift, stride) is not None

    results = []
    for sol in iter_orderings(robots, slot_predicate=pred):
        n_slots = len(sol[0])
        slot_delays = []
        for s in range(n_slots):
            slot_maps = [robots[r][1][sol[r][s]][1] for r in range(len(robots))]
            slot_delays.append(
                deconflict_slot(slot_maps, margin, max_shift, stride)
            )
        results.append((sol, slot_delays))
        if not all_solutions and all(d is not None for d in slot_delays):
            return [results[-1]]
    if not all_solutions and results:
        return results[:1]
    return results
