"""VisProvider: per-map visualization publisher (vis_interface equivalent).

The CUDA reference publishes device pointers over CUDA IPC + boost shm to a
separate viewer process (VisProvider.h:49-73). Here, as in the JAX package
(gpu_voxels_tpu/vis/provider.py), it is a host-readback publisher:
visualize() snapshots the map into a directory (PLY + HTML + the live
viewer's layer) only when the content changed, so a file-watching viewer
(or a browser on the HTML) plays the reference viewer's role. Every read of
the map is O(extracted) (vis/extract.py). A publish is two steps: the
snapshot (the reads, in the caller's process) and write_snapshot (the
files, from host arrays alone), which AsyncVisPublisher runs in a writer
process of its own.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

import numpy as np

from . import export
from .extract import extract_cubes, extract_distance_slice, extract_multilevel_cubes
from .serve import default_dir, publish_cube_arrays, publish_distance_arrays


class VisProvider:
    def __init__(self, name: str, out_dir: Optional[str] = None,
                 max_cubes: Optional[int] = None):
        self.name = name
        self.out_dir = Path(out_dir) if out_dir else default_dir()
        self._last_fingerprint = None
        # dense-map viewer budget: bounds BOTH the device->host fetch (the
        # compaction capacity) and the written cube count; None = exact full
        # extraction. Live sense loops set a budget so each publish fetch is
        # O(budget) regardless of scene size.
        self.max_cubes = max_cubes
        # what writes a snapshot's files: write_snapshot in this process,
        # or an AsyncVisPublisher's writer process
        self.writer = write_snapshot

    # multi-level extraction budget: truncates (coarsest-first) past this
    # many cubes — a 32768^3 paged world stays interactive
    MAX_CUBES = 1_000_000

    def visualize(self, m, force_repaint: bool = True, threshold: float = 0.5) -> bool:
        """Publish the map snapshot; skips unchanged content unless forced.
        The files are written by `self.writer`: in the caller's process,
        unless an AsyncVisPublisher made this provider its own."""
        job = self.snapshot(m, force_repaint, threshold)
        if job is None:
            return False
        self.writer(job)
        return True

    def snapshot(self, m, force_repaint: bool = True, threshold: float = 0.5) -> Optional[dict]:
        """The map's snapshot as the writers take it, or None when the
        content is unchanged and the repaint not forced.

        Hierarchical / paged maps publish MULTI-LEVEL cubes (one per uniform
        octree node, the reference's VisNTree extractCubes path,
        NTree.hpp:2637) so octree-scale worlds render with O(allocated)
        cubes; distance maps additionally publish a distance-gradient slice
        layer (the reference viewer's DistanceVoxel coloring).

        Every read of the map happens here: extraction runs FIRST
        (device-compacted — the readback is O(extracted), see
        ops/compact.py), the change-detection fingerprint hashes the
        extracted arrays, and no path ever fetches a full map buffer. The
        snapshot holds host arrays and scalars only (`write_snapshot`)."""
        from ..maps.distance_map import DistanceVoxelMap
        from ..maps.hierarchical import _PyramidQueries
        from ..maps.paged import PagedHierarchicalMap
        from ..parallel.paged_world import ShardedPagedWorld
        from ..parallel.shard_value import _ShardedValue

        if isinstance(m, _ShardedValue):
            m = m.gather()  # a slab-sharded value is drawn from its one-device copy
        # extract once, feed all three writers
        if isinstance(m, (PagedHierarchicalMap, _PyramidQueries, ShardedPagedWorld)):
            corners, sizes, types = extract_multilevel_cubes(
                m, max_cubes=self.MAX_CUBES
            )
            side = float(m.side_length)
            centers = (corners.astype(np.float64) + sizes[:, None] / 2.0) * side
            cubes = (centers, types, sizes.astype(np.float64) * side)
        else:
            cubes = extract_cubes(m, threshold, max_cubes=self.max_cubes)
        fp = hash(
            (threshold,)
            + tuple(np.asarray(part).tobytes() for part in cubes if part is not None)
        )
        if not force_repaint and fp == self._last_fingerprint:
            return None
        self._last_fingerprint = fp
        distance = None
        if isinstance(m, DistanceVoxelMap):
            distance = extract_distance_slice(m, axis="z")
        return {"out_dir": str(self.out_dir), "name": self.name, "side": float(m.side_length),
                "cubes": cubes, "distance": distance, "ts": time.strftime("%H:%M:%S")}


def write_snapshot(job: dict) -> None:
    """A snapshot's files: `<name>.ply`, `<name>.html`, the live viewer's
    `<name>.cubes.json` (and `<name>.distance.cubes.json` for a distance
    map) and the manifest, stamped with the snapshot's time. Host arrays
    only, no map and no torch: the same function runs in the caller's
    process (VisProvider.visualize) and in a publisher's writer process,
    so the two write the same bytes."""
    out_dir, name, side, cubes = Path(job["out_dir"]), job["name"], job["side"], job["cubes"]
    out_dir.mkdir(parents=True, exist_ok=True)
    export.write_ply_cubes(out_dir / f"{name}.ply", cubes)
    export.write_html_layers(out_dir / f"{name}.html", [(name, side, cubes)])
    publish_cube_arrays(out_dir, name, side, cubes, job["ts"])
    if job["distance"] is not None:
        publish_distance_arrays(out_dir, f"{name}.distance", side, *job["distance"], job["ts"])


def _writer_main(fd: int) -> None:
    """The writer process: write each snapshot it is sent over the
    connection on `fd`, answer None or the exception; end at None or when
    the parent's end of the connection closes."""
    from multiprocessing.connection import Connection

    conn = Connection(fd)
    while True:
        try:
            job = conn.recv()
        except (EOFError, OSError):
            return
        if job is None:
            return
        try:
            write_snapshot(job)
            conn.send(None)
        except Exception as exc:  # handed to the parent, which raises it
            try:
                conn.send(exc)
            except Exception:  # an exception that does not pickle
                conn.send(RuntimeError(f"{type(exc).__name__}: {exc}"))


class _WriterProcess:
    """A child process that writes snapshots (`write_snapshot`): a fresh
    interpreter (spawned, never forked: it inherits no CUDA state and never
    touches the card) that imports this package and nothing of the
    caller's script, so a script without a `__main__` guard can publish
    too. The two talk over one connection (pickled jobs, None or an
    exception back). `write` blocks its caller (the publisher's worker
    thread) until the child has written the files, without holding the
    interpreter. If the parent dies, the connection closes and the child
    ends."""

    def __init__(self, name: str):
        import multiprocessing
        import os
        import subprocess
        import sys

        self.name = name
        self._conn, child_conn = multiprocessing.Pipe()
        fd = child_conn.fileno()
        root = str(Path(__file__).resolve().parents[2])  # the directory holding the package
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
        code = "import sys\nfrom gpu_voxels_tpu_torch.vis.provider import _writer_main\n_writer_main(int(sys.argv[1]))"
        self.process = subprocess.Popen([sys.executable, "-c", code, str(fd)], pass_fds=(fd,), env=env,
                                        stdin=subprocess.DEVNULL)
        child_conn.close()

    def alive(self) -> bool:
        return self.process.poll() is None

    def write(self, job: dict) -> None:
        try:
            self._conn.send(job)
            err = self._conn.recv()
        except (EOFError, OSError):
            raise RuntimeError(f"the writer process of {self.name!r} ended "
                               f"(exit code {self.process.poll()})") from None
        if err is not None:
            raise err

    def close(self, timeout_s: float) -> None:
        import subprocess

        try:
            self._conn.send(None)
        except OSError:  # the child is gone already
            pass
        try:
            self.process.wait(timeout_s)
        except subprocess.TimeoutExpired:
            self.process.kill()
            self.process.wait()
        self._conn.close()


class AsyncVisPublisher:
    """Producer-cheap visualization for live loops.

    The reference's visualizeMap costs the producer almost nothing — an IPC
    handle + a changed flag in shared memory — while the viewer PROCESS pulls
    at its own rate (VisProvider.h:49-73, Visualizer.cu). Here:
    `publish(map)` drops a map snapshot into a one-slot latest-wins mailbox
    (O(1): the port's map updates make new tensors, so the snapshot is a
    reference, no copy, no readback). A worker thread takes the latest map
    and does what needs the card: the O(extracted) extraction and the change
    fingerprint (VisProvider.snapshot). Its provider's writer is a writer
    PROCESS, which formats and writes the files (write_snapshot) from the
    host arrays while the thread waits without holding the interpreter: the
    writers' per-cube Python never competes with the loop's launches. The
    worker's reads wait for the device, so a caller that runs with torch's
    sync debug mode set to raise must lift it while the worker paints. A
    30 Hz sense loop publishes every frame; the viewer sees the freshest
    state the publish path can keep up with, exactly like the CUDA viewer.
    `stop()` ends the thread and the writer process.
    """

    def __init__(self, name: str, out_dir: Optional[str] = None,
                 max_cubes: Optional[int] = None):
        import threading

        self.provider = VisProvider(name, out_dir, max_cubes=max_cubes)
        self._writer = _WriterProcess(name)
        self.provider.writer = self._writer.write
        self._slot = None
        self._cond = threading.Condition()
        self._stop = False
        self._published = 0  # frames handed to publish()
        self._busy = False  # worker currently inside a paint
        self._painted = 0  # snapshots actually written by the worker
        self._error: Optional[BaseException] = None
        self._error_reported = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def publish(self, m) -> None:
        """Hand the latest map snapshot to the worker (never blocks on IO).

        If the worker died on an exception, the first publish() after the
        failure warns eagerly (a live loop would otherwise fill the mailbox
        forever with visualization silently dead); the exception itself is
        still re-raised by flush()/stop()."""
        with self._cond:
            if self._error is not None and not self._error_reported:
                self._error_reported = True
                import warnings

                warnings.warn(
                    f"AsyncVisPublisher({self.provider.name!r}) worker died: "
                    f"{self._error!r}; visualization is stopped "
                    f"(flush()/stop() re-raises)",
                    RuntimeWarning,
                    stacklevel=2,
                )
            self._slot = m
            self._published += 1
            self._cond.notify()

    def _worker(self) -> None:
        while True:
            with self._cond:
                self._busy = False
                self._cond.notify_all()
                while self._slot is None and not self._stop:
                    self._cond.wait()
                if self._stop and self._slot is None:
                    return
                m, self._slot = self._slot, None
                self._busy = True
            try:
                self.provider.visualize(m, force_repaint=False)
                with self._cond:
                    self._painted += 1
                    self._cond.notify_all()
            except BaseException as exc:  # surfaced by flush()/stop()
                with self._cond:
                    self._error = exc
                    self._busy = False
                    self._cond.notify_all()
                return

    @property
    def frames_painted(self) -> int:
        with self._cond:
            return self._painted

    def flush(self, timeout_s: float = 30.0) -> bool:
        """Wait until the worker has drained the mailbox (or error/timeout)."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            # drained = mailbox empty AND the worker is not mid-paint (file
            # writes of the last snapshot must be complete when flush returns)
            while (self._slot is not None or self._busy) and self._error is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(left)
            if self._error is not None:
                raise self._error
        return True

    def stop(self, timeout_s: float = 30.0) -> None:
        """End the worker thread and the writer process (after the snapshot
        in hand); re-raise the worker's failure, if any."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout_s)
        self._writer.close(timeout_s)
        if self._error is not None:
            raise self._error
