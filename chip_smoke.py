#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gpu_voxels_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc); without them it exits
non-zero and prints no result. Phases, each an assert or an exception:

0. the card: name and power limit (nvidia-smi);
1. build: nvcc compiles gpu_voxels_tpu_torch/csrc/*.cu (utils/kernels.py);
2. each CUDA kernel against its plain torch version, on the card, at full
   size, exact equality: K1/K2 (prob x prob count / count-and-mark) on two
   random int8 512^3 maps over thresholds x offsets, incl. misaligned views;
   K3 (exact projective carve) at 256^3 on a 640x480 frame under 3 poses,
   on a grid whose rows are ragged (dx = 250), and on 32-deep z-slabs of
   the 256^3 grid (z_index_offset 0, 32, 224; the eight slabs stacked equal
   the whole grid's mask);
   K4 (swept-volume types collide) on 256^3 bit maps over margins
   {0, 1, 4, 8, 24} x mark, dense-random and sparse (with the bit-0-only
   hazard voxel) fixtures and a length that is not a multiple of the block;
   and gated by both maps' occupancy summaries (the live-voxel rule of
   k4_live_mask holding every hit) on tests/test_collide_pallas.py's
   hazard fixtures at densities 0, 0.002 and 0.2 at 256^3 and at a ragged
   length (margins 0, 3, 4, 8), a conservative summary, all-dead maps,
   summaries one byte off a 16-byte boundary and a list's match mask,
   with a mark and count only, one launch a call;
   K5 (the EDT's min-plus envelope) at 256^3 along Y and X on random, empty,
   single-site, 50 %-dense, ragged (250x200x130), tie and dense g = 0
   fixtures, lines of 1,024 and of 1 position, on distances and payloads,
   and at least 16 resident warps per SM in both passes; K6's pool kernel
   against the plain min-pool, bit pattern for bit pattern (NaN equal to
   NaN), and its carve (pool, then carve) bit for bit against the plain
   pooled carve and inside K3's mask, at 256^3 under the 3 poses at
   P in {2, 4, 7, 8} (P = 7 divides neither 640 nor 480), on a ragged
   grid (dx = 250), a frame cropped to 479x638,
   a frame with NaN, -inf and +inf pixels and an invalid patch, and an
   axis-aligned pose whose voxel centres project exactly onto pooled-cell
   edges and the image's edges; K7 (bit x bit plane-fold count)
   on dense-random and sparse 256^3 plane stacks (with a voxel whose only
   set bit is eBVM_FREE on either side, which must not count, and voxels
   set only in plane 7's bit 31, which must) over the offsets, a length
   that is not a multiple of 4, the all-zero map, and one pair at 512^3
   (8.6 GB of planes);
3. ten paths through the public entry points, on the card, with torch's
   sync debug mode set to raise (the paths never wait for the device; path
   10's programs read it on purpose), each driven with every launch count
   set to 0 just before it and read just after; each kernel of a path must
   have launched in it:
   - the sense -> insert -> collide path (K1, K2, K3, K6): the facade linkage
     scene (count == 8000), Kinect fusion (5 frames of 640x480 into 256^3),
     a transformed sphere robot collided with the fused and a box
     environment, the 512^3 insert -> collide cycle with a marking
     collide, and live sensing: two Providers (carve_pool 1 and 8) fed 3
     frames from a StreamingDepthSource with an async collide against a
     robot provider, the DDA insert_sensor_data of one Kinect frame's
     307,200 rays into 256^3 and a CountingVoxelMap of its endpoints (the
     DDA and the counting map also equal to the same calls on CPU copies
     of the same points, at the full point count);
   - the robot -> swept volume -> types-collide path (K4): a UR10 through
     the facade, the BASELINE #3 64-step UR10 swept volume into a 256^3
     bit map, and its types collides and bit checks against an environment
     whose obstacles carry the SV bits of a few steps;
   - the camera -> distance field path (K5, K6): BASELINE #4 through the
     facade (a 512^3 DistanceVoxelMap, 20,000 random obstacles, the exact
     EDT, proximity queries, byte distances), and five Kinect frames fused
     into 256^3 with the pooled carve (carve_pool = 8), merged into a
     DistanceVoxelMap, its EDT (jump_flood's card route), the UR10's
     clearance and a clearance bit map;
   - the trajectory-scheduling path (K7, K4), the scene of
     examples/swept_fitter.py at its documented scale (256^3 at 0.015 m,
     two UR10s, 0.04 m link clouds, 100 intermediate poses): two .traj
     files written to a temp directory, load_trajectories, four swept
     maps, then on the raw-plane form of the maps (occ=None) and on the
     summary-carrying form: the centre collide, fit_orderings (exactly 2
     solutions), deconflict_slot (a positive second delay), fit_schedule
     with windows in the search; and BASELINE #3 in the bench's own form,
     the 64-step UR10 swept map's planes against the environment's through
     count_bit_bit. The searches branch on counts, so they run with the
     sync debug mode at its default; the inserts and single collides stay
     under "error". Raw-plane, summary and plain-route answers must agree;
   - the voxel-list path (K3, K4): the Kinect frames fused again into 256^3
     (K3) as the dense environment; the 64-step UR10 sweep into a 256^3
     bit list in one per-point-meaning insert (equal to the dense swept
     map voxel for voxel), the robot path's obstacles as a list, one
     Kinect frame's 307,200 points into a bit, a counting (then
     remove_underpopulated(5)) and a prob list; list x list collides, the
     types collide, bit checks at margins {0, 1, 4, 24} (K4) and at 25 and
     sv_offset 3 (plain), per-meaning counts, list x dense against the fused
     map and the swept map with and without its summary, the type mask,
     coarse levels 0-3, merge (offset, new meaning) and subtract, a morton
     list at 2048^3 (linear ids refuse it) of the frame's voxels moved past
     coordinate 1,024, collided across id modes, and a disk round trip of
     every list kind and each dense map kind. Every answer and file must
     equal the same calls on CPU copies at the full point count;
   - the planning path (no kernel): examples/ompl_planner_app.py's scene
     through the facade at the reference planner's size (150 x 150 x 100 at
     0.02 m), a UR10 among two pillars, a table and the floor, three rounds
     of RRTConnect (max 3,000 iterations) and the path simplifier, each
     solution's states into a bit-voxel-list solution map in one insert.
     The solves read one count per motion check, with the sync debug mode
     at its default. A round must solve; every interpolated state of a
     simplified path must count 0 on the card and, over its points that
     keep 1e-3 voxel from a cell boundary, on a CPU copy; 4,096 random
     states must count the same on the card and the CPU over those points
     (raw differences, at points FK's ulps can move across a boundary, are
     counted and printed);
   - the octree path (K3, K6): BASELINE #5 (bench.py:396-424) through the
     facade, 200,000 uniform obstacles in a 1024^3 HierarchicalBitMap at
     1.0 m and a HierarchicalValidityChecker over a 400-point robot
     translated to 315 states in one batch, whose counts must equal a numpy
     set oracle, and the same env as a PagedHierarchicalMap, whose counts
     must equal the dense ones; past the dense wall, the facade's 4096^3
     octrees (the paged tier, deterministic and probabilistic) take a Kinect
     frame by insert_depth_image (ray carving, max_steps 128) and its voxels
     again past coordinate 1,024 (voxel_offset), are probed at min_level 0,
     1, 3 and 6, collided with a morton list past 1,024 and with a dense
     hierarchy, and written and read back in both file formats: the whole
     state, every answer and the file digests equal the same calls on CPU
     copies of the inputs; both dense tiers fuse the frame at 512^3 under
     three poses with carve_pool 1 (K3) and 8 (K6): the prob tier equals a
     dense ProbVoxelMap's fusion on the same grid and its status, both
     equal the plain route bit for bit, check_tree holds after every
     insert; and the octree collides (octree x dense map, octree x octree,
     list x octree with an offset). The allocating paged inserts, the
     checker's counts, check_tree and the files read the device on purpose;
   - the facade path (K1, K3, K6, K7): tests/test_collision_matrix.py's 8x8
     type x type matrix through the facade at 256^3 with 300,000 points a
     map (60,000 shared): every supported ordered pair equal to a numpy set
     oracle, every unsupported pair a TypeError, and the bit pair without
     summaries (K7); save_map -> load_map of every map type the facade makes
     at 256^3 and of both paged octrees at 4096^3 (a second facade), each
     file equal to io.write_map of a CPU copy, each loaded map re-saved
     equal; add_robot of examples/models/pan_tilt.urdf swept through five
     joint configurations at 4 mm voxels (every FK point >= 1e-3 voxel from
     a cell boundary) and collided with a box, equal to the same calls on
     the CPU; insert_point_cloud_from_file of a Kinect frame's 307,200
     endpoints (.xyz, binary .pcd) equal to direct inserts; two
     Provider(live_vis=True) over the 5 frames at carve_pool 1 (K3) and 8
     (K6), their maps equal to the plain route and their last layers to a
     CPU copy's; visualize of the fused 256^3 map, a 512^3
     HierarchicalBitMap fused from a frame and the 4096^3 paged map, each
     layer file equal to a CPU copy's publish, the host reads and the bytes
     read back counted (O(extracted): at most 64 bytes a published cube);
     compacted_nonzero reads the device twice and print_voxel_map_data once.
     The files, the paged allocations and the publishes read the device on
     purpose;
   - the multi-device path (K1, K3, K4, K5, K7): 8 logical z-slabs on the
     card (the default mesh: slabs round-robin over the visible cards),
     world 2 x z 4 for the cycle: the 512^3 cycle of path 1's clouds (two
     scenes), the 256^3 sensor cycle of a Kinect frame against the fused
     environment (K3 per slab with its z_index_offset), the 256^3 bit cycle
     (K7), BASELINE #4's exact EDT at 512^3 (K5 per slab and pass: the
     packed grid equal to path 3's) and the 256^3 JFA on path 3's camera
     map (both repairs run to their fixpoint), BASELINE #5's 126,000 probes into the dense pyramid, the paged
     snapshot and as a voxel list, path 1's 512^3 prob maps and the robot
     path's 256^3 bit maps as slab-sharded values (collides at four
     offsets, K1; an insert through the value; the types collide at window
     5, K4, the marked map still sharded), a 4096^3 ShardedPagedWorld over
     4 slabs taking a Kinect frame whose rays cross a slab floor, and the
     facade's mesh= (a 4096^3 prob octree as a world, a 256^3 prob map as
     a sharded value) with save_map -> load_map, every dense-map method's
     slab form (j-o), and every hierarchy method's (p-t): path 7's frame
     into sharded 512^3 hierarchies of both tiers under three poses at
     carve_pool 1 (K3 a slab) and 8 (K6's pool a frame, its carve a slab),
     their launches counted around (p) alone and required exactly, and
     check_tree after every insert; BASELINE #5's build on a sharded 1024^3
     pyramid with and without the free box and its 315-state checker batch
     (equal to the numpy set oracle); octree x octree at levels 0 and 3
     (sharded x sharded, x plain both ways) and the 4096^3 paged map x a
     sharded 256^3 hierarchy; path 1's rays into sharded 256^3 hierarchies
     (the DDA); the UR10 configuration, collide_with_resolution,
     extract_occupied_coords, memory_usage and the file on the fused bit
     pyramid, and the facade's mesh octree saved and loaded: every answer
     equal to the single-device call on the card, the files to the single
     maps'. The JFA's repair flags, the checker, check_tree, the
     extractions, the paged allocations and the files read the device on
     purpose;
   - the examples path (K1, K3, K4, K5, K6): the 19 programs of
     gpu_voxels_tpu_torch/examples/ through their main() at their own sizes
     (robot_vs_environment's live loop at 256^3 with 640x480 frames from a
     60 Hz source, swept_fitter at 256^3, ompl_planner_app's three rounds,
     sharded_world_demo over every visible card), each program's launches
     counted alone and the host waits the sync debug mode reports (it
     warns: the programs read the card on purpose) counted. The 13 programs
     whose scene does not depend on the device and that place no point by
     FK or a rotation return exactly what their CPU copies return;
     full_pipeline_demo, distance_kinect_demo and the three FK programs
     (swept_volume_vs_environment, urdf_loader, tf_interface_demo) run
     again through the plain route on the card, and their returns and inner
     values, kept by wrapping their helpers (full_pipeline_demo's pooled-
     carve map, swept map, types collide, hierarchical probes and distance
     map with its clearance; distance_kinect_demo's map and distance map of
     every frame; the FK programs' collides and maps), equal it bit for
     bit; robot_vs_environment's frame_step over its 8-frame recording,
     with the sync debug mode raising, equals the plain route (maps and
     counts); swept_fitter's orderings and start delay equal the plain
     route's searches over the same swept maps; every solution of the
     planner is clear of a numpy set oracle of the scene's boxes, and its
     solution list holds the oracle's count of distinct voxels;
   every count, meanings vector, map, distance and payload grid must equal
   the same scene run through the plain route, and the 512^3 EDT must equal
   a brute-force minimum over the obstacles at 4,096 sampled voxels;
4. times with CUDA events (printed, never asserted): each kernel beside its
   plain version (K4 at the main path's data, the UR10 sweep against its
   environment gated by their summaries, with a mark and count only,
   beside its gated bound, and on dense random maps; the
   fitter's bit check gated and on raw planes; K5 per pass at 512^3 and 256^3, with the share of
   positions that hold a site; K6 at P = 8 as its pool, its carve alone on a
   prebuilt table and the two in turn; the pool, a few microseconds of
   device work under its wrapper's host time, by torch.profiler's device
   time), the 512^3 cycle rate, the 256^3 fusion rate, the 64-step swept
   insert + types collide per trajectory, the 512^3 EDT, the 256^3
   camera -> distance field frame, K7 at 256^3 (both load widths) and
   512^3, the fitter's ordering search and one deconflict_slot, one DDA
   insert_sensor_data frame, and the list and planning paths: a Kinect
   frame into a bit list, the 64-step swept list insert, list x list, the
   bit check (K4 on the list payload with the match mask beside the whole
   call and the single-launch floor), list x dense,
   a disk round trip of the swept list, batch_colliding_voxels of 256
   states, one check_motion and one solve with its host reads; and the
   octree path: BASELINE #5's batch on the dense and the paged tier, the
   1024^3 builds, a 512^3 fusion frame into each dense tier at both carves,
   and the 4096^3 paged Kinect insert in steady state and allocating; and
   the facade path: the 8x8 matrix's pairs (total and slowest), extract_cubes
   of the fused 256^3 map and of a 512^3 bit map, one publish per tier,
   save_map / load_map per tier and a URDF add_robot + insert + collide
   (host clock where the work is on the host); and each path-9 call
   sharded beside its single-device call (the hierarchies' fusions at
   512^3, the 1024^3 builds, BASELINE #5's batch, octree x octree, the DDA
   frames, the UR10 insert, the extraction and the file too); and each
   example program's wall
   time (host clock) and host waits, the live loop's processed frames and
   sustained rate at its defaults and under the accelerator contract of
   tests_tpu/test_examples_tpu.py:38-56 (90 frames, the async publish:
   asserted, >= 80 frames at >= 30 Hz with both providers painting).

Output: progress lines, the card's `name, power.limit` line, one JSON line
{"kernels": [...]} (each kernel with its launches on the paths, its largest
error against the plain version, its time, the plain version's time, the
least time the card could take for the same work and what bounds it), and
as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import contextlib
import hashlib
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gpu_voxels_tpu_torch import bitops, converters, interop
from gpu_voxels_tpu_torch.api import GpuVoxels
from gpu_voxels_tpu_torch.constants import SV_START, BitVoxelMeaning, MapType, float_to_probability
from gpu_voxels_tpu_torch.geometry import files, generation, transforms
from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud
from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap
from gpu_voxels_tpu_torch.maps.hierarchical import (HierarchicalBitMap, HierarchicalProbMap, _PyramidQueries,
                                                    _status_from_occupancy, decode_status_flags)
from gpu_voxels_tpu_torch.maps.paged import PagedHierarchicalMap
from gpu_voxels_tpu_torch.maps.voxellist import (VoxelList, bit_vector_morton_voxel_list, bit_vector_voxel_list,
                                                 counting_voxel_list, prob_voxel_list)
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap
from gpu_voxels_tpu_torch.ops import collide_cuda, edt, edt_cuda, edt_envelope, raycast, raycast_cuda
from gpu_voxels_tpu_torch.ops.compact import compacted_nonzero
from gpu_voxels_tpu_torch.parallel import (ShardedPagedWorld, assert_sharded, build_sharded_bit_cycle, build_sharded_cycle,
                                           build_sharded_hier_probe, build_sharded_list_collide,
                                           build_sharded_paged_probe, build_sharded_sensor_cycle, make_grid_mesh,
                                           shard_map_value)
from gpu_voxels_tpu_torch.parallel.sharded_edt import build_sharded_edt
from gpu_voxels_tpu_torch.parallel.sharded_edt_exact import build_sharded_parallel_banding
from gpu_voxels_tpu_torch.planning import (GvlValidityChecker, HierarchicalValidityChecker, JointSpace, MotionValidator,
                                           PathSimplifier, RRTConnect)
from gpu_voxels_tpu_torch.providers import Provider
from gpu_voxels_tpu_torch.robot.dh import DHParameters
from gpu_voxels_tpu_torch.robot.fitter import deconflict_slot, fit_orderings, fit_schedule
from gpu_voxels_tpu_torch.robot.presets import ur_robot
from gpu_voxels_tpu_torch.robot.swept_volume import insert_swept_volume_batched
from gpu_voxels_tpu_torch.robot.trajectory import load_trajectories
from gpu_voxels_tpu_torch.sensors import Sensor, StreamingDepthSource, SyntheticDepthSource
from gpu_voxels_tpu_torch.utils import io, kernels, to_device
from gpu_voxels_tpu_torch.vis import export as vis_export
from gpu_voxels_tpu_torch.vis import extract as vis_extract
from gpu_voxels_tpu_torch.vis.provider import VisProvider

INTR = (525.0, 525.0, 320.0, 240.0)  # Kinect 640x480 (BASELINE config #2)
FUSION_DIMS, FUSION_SIDE = (256, 256, 256), 0.02
CYCLE_DIMS = (512, 512, 512)
THRESHOLDS = (-120, 0, 100)
OFFSETS = ((0, 0, 0), (-1, 0, -1), (3, -2, 1))
# BASELINE config #3 (bench.py:320-338): a UR10 at (2.56, 2.56, 0.5) over a
# 64-step trajectory into a 256^3 BitVectorVoxelMap at 0.02 m
SV_DIMS, SV_SIDE, SV_BASE = (256, 256, 256), 0.02, (2.56, 2.56, 0.5)
SV_TRAJ = np.linspace([0.3, -0.5, 0.5, 0, 0, 0], [-1.2, -0.2, 1.0, 0.4, 0.3, 0], 64).astype(np.float32)
OBSTACLE_STEPS = (12, 31, 50)  # env obstacles carry these steps' SV bits
K4_MARGINS = (0, 1, 4, 8, 24)
K4_RAGGED_N = 100_003  # no multiple of the 512-voxel chunk nor of 16
K3_SLAB, K3_OFFSETS = 32, (0, 32, 224)  # K3 on z-slabs: the multi-device carve (path 9)
# BASELINE config #4 (bench.py:364-394): 20,000 random obstacle voxels in a
# 512^3 DistanceVoxelMap at 1.0 m, the exact EDT and proximity queries
EDT_DIMS, EDT_OBSTACLES = (512, 512, 512), 20000
BRUTE_SAMPLES = 4096
K5_RAGGED = (250, 200, 130)  # (dx, dy, dz): no dim a multiple of 8 or 32
# the trajectory-scheduling scene (examples/swept_fitter.py:36-79, :127): two
# UR10s facing each other across a shared band of workspace, per robot two
# motions, one through the band and one on its home side
FIT_DIMS, FIT_SIDE, FIT_STEPS, FIT_WINDOW, FIT_SPACING = (256, 256, 256), 0.015, 100, 2, 0.04
FIT_BASES = {"UR10_A": (1.30, 1.30, 0.30), "UR10_B": (1.30, 2.50, 0.30)}
TRAJ_FILES = {
    "UR10_A": ("ur_a.traj", """Trajectory_Num: 2
Joint_Num: 6
Name: A_reach_center
shoulder_pan_joint   0.6   -1.1
shoulder_lift_joint  -0.55 -0.45
elbow_joint          1.15  1.05
wrist_1_joint        0.0   0.0
wrist_2_joint        0.0   0.0
wrist_3_joint        0.0   0.0
Joint_Num: 6
Name: A_home_side
shoulder_pan_joint   1.2   2.2
shoulder_lift_joint  -0.9  -0.7
elbow_joint          1.2   1.0
wrist_1_joint        0.0   0.0
wrist_2_joint        0.0   0.0
wrist_3_joint        0.0   0.0
"""),
    "UR10_B": ("ur_b.traj", """Trajectory_Num: 2
Joint_Num: 6
Name: B_reach_center
shoulder_pan_joint   -0.6  1.1
shoulder_lift_joint  -0.55 -0.45
elbow_joint          1.15  1.05
wrist_1_joint        0.0   0.0
wrist_2_joint        0.0   0.0
wrist_3_joint        0.0   0.0
Joint_Num: 6
Name: B_home_side
shoulder_pan_joint   -1.2  -2.2
shoulder_lift_joint  -0.9  -0.7
elbow_joint          1.2   1.0
wrist_1_joint        0.0   0.0
wrist_2_joint        0.0   0.0
wrist_3_joint        0.0   0.0
"""),
}
POOL = 8  # the reference's fast camera configuration (gpu_voxels_tpu/ops/raycast.py:202-208)
K6_POOLS = (2, 4, 7, POOL)
# an axis-aligned camera at the centre of a grid's z = 0 face, 0.25 m voxels,
# whose voxel centres project exactly onto pixel edges: with c = dx / 2,
# wx = (x - c) * 0.25 and sz = z * 0.25 hold exactly, so u = 320 + 840 *
# (x - c) / z (v likewise) is an integer wherever z divides 840 * (x - c):
# onto pooled-cell edges (u, v in P * Z) and onto the image's edges (for
# z = 21, u = 0 at x = c - 8 and u = 640 at x = c + 8; for z = 7, v = 0 at
# y = c - 2 and v = 480 at y = c + 2)
EDGE_INTR, EDGE_SIDE = (840.0, 840.0, 320.0, 240.0), 0.25
# path 5: K4's margins as a list bit check, and a morton list at 2048^3 (past
# 2^32 voxels) holding the Kinect frame's voxels moved beyond coordinate 1,024
LIST_MARGINS = (0, 1, 4, 24)
MORTON_DIMS, MORTON_SHIFT = (2048, 2048, 2048), 1030
# path 6: examples/ompl_planner_app.py at the reference planner's size
# (gvl_ompl_planner_helper.cpp:53): 150 x 150 x 100 at 0.02 m, the UR10 based
# at (1.5, 1.5, 0.5) among two pillars, a table plate and the floor
PLAN_DIMS, PLAN_SIDE, PLAN_BASE = (150, 150, 100), 0.02, (1.5, 1.5, 0.5)
PLAN_BOXES = (((1.0, 1.0, 0.0), (1.2, 1.2, 1.2)), ((1.8, 1.8, 0.0), (2.0, 2.0, 1.2)),
              ((1.1, 1.1, 1.2), (1.9, 1.9, 1.3)), ((0.0, 0.0, 0.0), (3.0, 3.0, 0.01)))
PLAN_START = np.array([-1.3, -0.2, 0.0, 0.0, 0.0, 0.0], np.float32)
PLAN_GOAL = np.array([1.3, -0.5, 0.0, 0.0, 0.0, 0.0], np.float32)
PLAN_SEED, PLAN_ROUNDS, PLAN_RESOLUTION, PLAN_RANDOM_STATES = 7, 3, 0.08, 4096
# path 7: BASELINE config #5 (bench.py:396-424): 200,000 uniform obstacles in
# a 1024^3 octree at 1.0 m, a 400-point robot translated to 315 states
C5_DIMS, C5_OBSTACLES, C5_ROBOT_POINTS, C5_STATES, C5_SEED = (1024, 1024, 1024), 200000, 400, 315, 5
PAGED_DIMS = (4096, 4096, 4096)  # past the dense wall: the facade takes the paged tier
PAGED_LEVELS = (0, 1, 3, 6)
HIER_DIMS, HIER_SIDE = (512, 512, 512), 0.01  # the carve poses' 5.12 m cube at 512^3
# path 8: tests/test_collision_matrix.py's types and support rule at 256^3, a
# Kinect frame's worth of points a map; the pan/tilt URDF (its mesh is
# tilt_link.binvox, 252 points) at 4 mm voxels, under joint values whose FK
# points keep >= 1e-3 voxel from every cell boundary (F4)
MATRIX_DIMS, MATRIX_POINTS, MATRIX_SHARED, MATRIX_SEED = (256, 256, 256), 300_000, 60_000, 3
MATRIX_TYPES = [
    ("prob", MapType.MT_PROBAB_VOXELMAP),
    ("bit", MapType.MT_BITVECTOR_VOXELMAP),
    ("bitlist", MapType.MT_BITVECTOR_VOXELLIST),
    ("mortonlist", MapType.MT_BITVECTOR_MORTON_VOXELLIST),
    ("problist", MapType.MT_PROBAB_VOXELLIST),
    ("countlist", MapType.MT_COUNTING_VOXELLIST),
    ("hierbit", MapType.MT_BITVECTOR_OCTREE),
    ("hierprob", MapType.MT_PROBAB_OCTREE),
]
MATRIX_DENSE = {"prob", "bit"}
URDF_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "models", "pan_tilt.urdf")
URDF_DIMS, URDF_SIDE, URDF_POINTS = (256, 256, 256), 0.004, 252
URDF_CONFIGS = ((0.562, 0.87), (0.68, 0.281), (0.131, 0.05), (0.913, 0.593), (0.143, 0.075))
URDF_BOX = ((0.45, 0.1, 0.4), (0.62, 0.5, 0.6))
# H100 SXM data sheet: HBM rate and the f32 rate
# outside the tensor cores, which the integer and f32 ops here are held to
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

KERNELS = [
    # (wrapper name, module, source, TPU kernel it replaces)
    ("count_prob_prob", collide_cuda, "gpu_voxels_tpu_torch/csrc/collide_prob.cu",
     "gpu_voxels_tpu/ops/collide_pallas.py:52"),
    ("count_and_mark_prob", collide_cuda, "gpu_voxels_tpu_torch/csrc/collide_prob.cu",
     "gpu_voxels_tpu/ops/collide_pallas.py:394"),
    ("projective_free_space_exact", raycast_cuda, "gpu_voxels_tpu_torch/csrc/carve_exact.cu",
     "gpu_voxels_tpu/ops/raycast_pallas.py:189"),
    ("collide_types_bit_bit", collide_cuda, "gpu_voxels_tpu_torch/csrc/collide_types.cu",
     "gpu_voxels_tpu/ops/collide_pallas.py:189"),
    ("envelope_pass", edt_cuda, "gpu_voxels_tpu_torch/csrc/edt_envelope.cu",
     "gpu_voxels_tpu/ops/edt_envelope.py:130"),
    ("projective_free_space_pooled", raycast_cuda, "gpu_voxels_tpu_torch/csrc/carve_pooled.cu",
     "gpu_voxels_tpu/ops/raycast_pallas.py:435"),
    # K6's table: XLA in the reference (min_pool_depth, built before the
    # Pallas call at raycast_pallas.py:552), a kernel of its own here
    ("min_pool_depth", raycast_cuda, "gpu_voxels_tpu_torch/csrc/carve_pooled.cu",
     "gpu_voxels_tpu/ops/raycast_pallas.py:79"),
    ("count_bit_bit", collide_cuda, "gpu_voxels_tpu_torch/csrc/collide_bits.cu",
     "gpu_voxels_tpu/ops/collide_pallas.py:92"),
]


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 0 ------------------------------------------------------------------
def card() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    smi = res.stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # coordinates feed floor(): full f32 matmuls only (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda", 0), smi


# -- phase 2 ------------------------------------------------------------------
def bench_frame(seed: int = 0) -> np.ndarray:
    """640x480 depth with step edges, an invalid patch and noise (bench.py:288-293)."""
    rng = np.random.default_rng(seed)
    depth = np.full((480, 640), 4.0, np.float32)
    depth[100:300, 200:450] = 2.5
    depth[350:460, 50:250] = 1.8
    depth += rng.normal(0, 0.003, depth.shape).astype(np.float32)
    depth[20:60, 560:620] = 0.0  # invalid patch
    return depth


def carve_poses() -> dict:
    bench = np.eye(4, dtype=np.float32)
    bench[:3, 3] = [2.56, 2.56, 0.1]
    return {
        "bench": bench,
        "tilted": transforms.from_rpy_np([0.3, -0.2, 0.1], [2.0, 2.8, 0.3]),
        # at the grid's centre: half the grid lies behind the camera
        "inside": transforms.from_rpy_np([0.05, 0.1, 0.0], [2.56, 2.56, 2.56]),
    }


def check_kernels(dev: torch.device) -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    g = torch.Generator(device=dev).manual_seed(1234)
    n = CYCLE_DIMS[0] * CYCLE_DIMS[1] * CYCLE_DIMS[2]
    a = torch.randint(-128, 128, (n,), dtype=torch.int8, device=dev, generator=g)
    b = torch.randint(-128, 128, (n,), dtype=torch.int8, device=dev, generator=g)
    err = {name: 0 for name, *_ in KERNELS}
    cases = [(a, b, t, off, CYCLE_DIMS) for t in THRESHOLDS for off in OFFSETS]
    # views whose byte addresses share a misalignment: the vector path's head and tail
    cases.append((a[7:n - 5], b[7:n - 5], 0, (0, 0, 0), None))
    for x, y, t, off, dims in cases:
        got = collide_cuda.count_prob_prob(x, y, t, 0, dims, off)
        ref = collide_cuda.count_prob_prob_plain(x, y, t, 0, dims, off)
        err["count_prob_prob"] = max(err["count_prob_prob"], abs(int(got) - int(ref)))
        cnt, marked = collide_cuda.count_and_mark_prob(x, y, t, 0, dims, off)
        ref_c, ref_m = collide_cuda.count_and_mark_prob_plain(x, y, t, 0, dims, off)
        map_err = int((marked.to(torch.int16) - ref_m.to(torch.int16)).abs().max())
        err["count_and_mark_prob"] = max(err["count_and_mark_prob"], abs(int(cnt) - int(ref_c)), map_err)
        assert int(got) == int(ref) and int(cnt) == int(ref_c) and torch.equal(marked, ref_m), (t, off)
        log(f"  K1/K2 t1={t:4d} offset={off} view={dims is None}: count {int(got)} == plain, marked map equal")
    del a, b, marked, ref_m

    depth = torch.as_tensor(bench_frame(), device=dev)
    poses = carve_poses()
    # dx = 250: rows that end inside a thread's 8 voxels and start off an 8-byte boundary
    ragged = (K5_RAGGED[0], *FUSION_DIMS[1:])
    for name, dims in [(name, FUSION_DIMS) for name in poses] + [("inside", ragged)]:
        p = torch.as_tensor(poses[name], device=dev)
        got = raycast_cuda.projective_free_space_exact(depth, p, *INTR, FUSION_SIDE, dims)
        ref = raycast_cuda.projective_free_space_plain(depth, p, *INTR, FUSION_SIDE, dims)
        diff = int((got != ref).sum())
        err["projective_free_space_exact"] = max(err["projective_free_space_exact"], int(diff > 0))
        assert diff == 0 and int(got.sum()) > 0, (name, dims, diff)
        log(f"  K3 pose={name} dims={dims}: {int(got.sum())} free voxels, mask equal to plain bit for bit")
    check_k3_offsets(dev, depth, poses, err)
    del depth, got, ref

    n = SV_DIMS[0] * SV_DIMS[1] * SV_DIMS[2]
    dense = dense_bits(dev, n, g), dense_bits(dev, n, g)
    k4_cases = [("dense", dense, m) for m in K4_MARGINS]
    k4_cases += [("sparse", sparse_bits(dev, n, g), m) for m in (0, 4, 8)]
    # a length that is not a multiple of the 256-thread block
    ragged = tuple(x[:, : n - 37].contiguous() for x in dense)
    k4_cases += [("ragged", ragged, m) for m in (0, 5)]
    for name, (a, b), margin in k4_cases:
        for mark in (True, False):
            cnt, meanings, new = collide_cuda.collide_types_bit_bit(a, b, margin, mark)
            ref_c, ref_m, ref_new = collide_cuda.collide_types_bit_bit_plain(a, b, margin, mark)
            same = torch.equal(meanings, ref_m) and torch.equal(new, ref_new)
            err["collide_types_bit_bit"] = max(err["collide_types_bit_bit"], abs(int(cnt) - int(ref_c)), int(not same))
            assert int(cnt) == int(ref_c) and same, (name, margin, mark)
            assert mark == (new.data_ptr() != a.data_ptr()), "the marked map must be new, the unmarked one a"
        log(f"  K4 {name} N={a.shape[1]} margin={margin:2d}: count {int(cnt)} == plain, meanings and "
            f"marked map equal (with a mark and count only)")
    check_k4_gated(dev, g, dense, err)
    del dense, k4_cases, ragged, a, b, new, ref_new
    check_k5(dev, g, err)
    check_k6(dev, err)
    check_k7(dev, g, err)
    torch.cuda.synchronize()
    return err


def check_k3_offsets(dev: torch.device, depth: torch.Tensor, poses: dict, err: dict) -> None:
    """K3 on 32-deep z-slabs of the 256^3 grid (the multi-device carve):
    at z_index_offset 0, 32 and 224 bit-identical to the plain form, and the
    eight slabs stacked equal to the whole grid's mask, under the 3 poses."""
    depth_slab = K3_SLAB
    slab = (FUSION_DIMS[0], FUSION_DIMS[1], depth_slab)
    for name, pose in poses.items():
        p = torch.as_tensor(pose, device=dev)
        whole = raycast_cuda.projective_free_space_exact(depth, p, *INTR, FUSION_SIDE, FUSION_DIMS)
        for z0 in K3_OFFSETS:
            got = raycast_cuda.projective_free_space_exact(depth, p, *INTR, FUSION_SIDE, slab, z_index_offset=z0)
            ref = raycast_cuda.projective_free_space_plain(depth, p, *INTR, FUSION_SIDE, slab, z_index_offset=z0)
            diff = int((got != ref).sum())
            err["projective_free_space_exact"] = max(err["projective_free_space_exact"], int(diff > 0))
            assert diff == 0, (name, z0, diff)
        stacked = torch.cat([raycast_cuda.projective_free_space_exact(depth, p, *INTR, FUSION_SIDE, slab,
                                                                      z_index_offset=z0)
                             for z0 in range(0, FUSION_DIMS[2], depth_slab)])
        assert torch.equal(stacked, whole), name
        log(f"  K3 pose={name} on {depth_slab}-deep slabs: offsets {K3_OFFSETS} equal to plain bit for bit, "
            f"{FUSION_DIMS[2] // depth_slab} slabs stacked == the whole grid's mask ({int(whole.sum())} free)")


def check_k7(dev: torch.device, g: torch.Generator, err: dict) -> None:
    n = SV_DIMS[0] * SV_DIMS[1] * SV_DIMS[2]

    def check(name, a, b, dims, off):
        got = collide_cuda.count_bit_bit(a, b, dims, off)
        ref = collide_cuda.count_bit_bit_plain(a, b, dims, off)
        err["count_bit_bit"] = max(err["count_bit_bit"], abs(int(got) - int(ref)))
        assert int(got) == int(ref), (name, off, int(got), int(ref))
        log(f"  K7 {name} N={a.shape[1]} offset={off}: count {int(got)} == plain")
        return int(got)

    dense = dense_bits(dev, n, g), dense_bits(dev, n, g)
    sparse = sparse_bits(dev, n, g)
    # voxel 5 of the sparse pair holds only eBVM_FREE in a; voxel 7 only
    # eBVM_FREE on both sides; voxels 11 and 12 only bit 31 of plane 7
    for m in sparse:
        m[:, 7] = 0
        m[0, 7] = 1
        m[:, 11:13] = 0
        m[7, 11:13] = -(2**31)
    for off in OFFSETS:
        assert check("dense", *dense, SV_DIMS, off) > 0
        check("sparse", *sparse, SV_DIMS, off)
    occ = [bitops.occupied(m) for m in sparse]
    assert not bool(occ[0][5]) and not bool(occ[0][7] | occ[1][7]) and bool(occ[0][11] & occ[1][12])
    lone = [torch.zeros_like(sparse[0]) for _ in range(2)]
    for m in lone:
        m[0, 7] = 1
        m[7, 11:13] = -(2**31)
    assert check("eBVM_FREE-only and bit-255-only voxels", *lone, SV_DIMS, (0, 0, 0)) == 2
    del lone, occ
    # a length that is no multiple of 4: the planes' starts differ mod 16
    ragged = tuple(x[:, : n - 37].contiguous() for x in dense)
    check("ragged", *ragged, None, (0, 0, 0))
    zero = torch.zeros_like(dense[0])
    assert check("all-zero", dense[0], zero, SV_DIMS, (0, 0, 0)) == 0
    assert check("all-zero", zero, zero, SV_DIMS, OFFSETS[1]) == 0
    del dense, sparse, ragged, zero
    n = CYCLE_DIMS[0] * CYCLE_DIMS[1] * CYCLE_DIMS[2]
    big = dense_bits(dev, n, g), dense_bits(dev, n, g)  # 8.6 GB of planes
    for off in (OFFSETS[0], OFFSETS[2]):
        assert check("dense 512^3", *big, CYCLE_DIMS, off) > 0
    del big
    torch.cuda.empty_cache()


def random_obstacles(dev: torch.device, dims, count: int, g: torch.Generator) -> torch.Tensor:
    """Packed int32[N] with `count` random obstacle voxels (duplicates merge)."""
    n = dims[0] * dims[1] * dims[2]
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[torch.randint(0, n, (count,), device=dev, generator=g)] = True
    return edt.init_from_obstacle_mask(mask, dims)


def k5_fixtures(dev: torch.device, g: torch.Generator):
    """(name, g, payload, axis) inputs of the EDT's passes at 256^3: the Y
    pass on PBA phase 1's output, the X pass on the plain Y pass's output,
    synthetic tie and dense g = 0 grids for both, and lines of 1,024 and
    of 1 position."""
    dims = FUSION_DIMS
    dx, dy, dz = dims
    n = dx * dy * dz
    centre = (dz // 2 * dy + dy // 2) * dx + dx // 2
    grids = {
        "random": (random_obstacles(dev, dims, EDT_OBSTACLES // 8, g), dims),  # BASELINE #4's density
        "empty": (edt.init_from_obstacle_mask(torch.zeros(n, dtype=torch.bool, device=dev), dims), dims),
        "single": (edt.init_from_obstacle_mask(torch.arange(n, device=dev) == centre, dims), dims),
        "dense50": (edt.init_from_obstacle_mask(torch.rand(n, device=dev, generator=g) < 0.5, dims), dims),
        "ragged": (random_obstacles(dev, K5_RAGGED, 1500, g), K5_RAGGED),
    }
    for name, (packed, gdims) in grids.items():
        g1, pay1 = edt_envelope.flood_z(packed, gdims)
        yield name, g1, pay1, 1
        d2, pay2 = edt_cuda.envelope_pass_plain(g1, pay1, 1)
        yield name, d2, pay2, 2
    # equidistant ties: sites at offset 0 on every 4th row and column, small
    # random offsets elsewhere
    shape = (dims[2], dims[1], dims[0])
    small = torch.randint(0, 6, shape, dtype=torch.int32, device=dev, generator=g)
    tie = torch.where(torch.rand(shape, device=dev, generator=g) < 0.8, edt_envelope.MISS, small)
    tie[:, ::4, :] = 0
    tie[:, :, ::4] = 0
    pay = torch.randint(0, 2**30, shape, dtype=torch.int32, device=dev, generator=g)
    for axis in (1, 2):
        yield "ties", tie, pay, axis
        # every position a site at offset 0: each starts its own segment, the stack reaches depth n
        yield "dense g=0", torch.zeros_like(tie), pay, axis
    # the longest line the packed sites allow, and the shortest
    for name, shape, axis in (("n=1024", (4, 1024, 64), 1), ("n=1024", (4, 64, 1024), 2),
                              ("n=1", (8, 1, dims[0]), 1), ("n=1", (8, dims[1], 1), 2)):
        small = torch.randint(0, 40, shape, dtype=torch.int32, device=dev, generator=g)
        sparse = torch.where(torch.rand(shape, device=dev, generator=g) < 0.9, edt_envelope.MISS, small)
        yield name, sparse, torch.randint(0, 2**30, shape, dtype=torch.int32, device=dev, generator=g), axis


def check_k5(dev: torch.device, g: torch.Generator, err: dict) -> None:
    # what the card holds of each pass's kernel at the main path's line lengths
    for n in (EDT_DIMS[0], FUSION_DIMS[0]):
        for name, c in (("Y", n), ("X", 1)):
            occ = edt_cuda.envelope_occupancy(n, c)
            assert occ["warps_per_sm"] >= 16, (n, name, occ)
            log(f"  K5 {name} pass, n={n}: {occ['warps_per_sm']} warps per SM ({occ['registers']} registers, "
                f"{occ['shared_bytes']} B shared per block of {occ['threads']} threads, {occ['local_bytes']} B local "
                f"per thread)")
    for name, g2, pay, axis in k5_fixtures(dev, g):
        d, p = edt_cuda.envelope_pass(g2, pay, axis)
        ref_d, ref_p = edt_cuda.envelope_pass_plain(g2, pay, axis)
        d_err = int((d.to(torch.int64) - ref_d.to(torch.int64)).abs().max())
        p_diff = int((p != ref_p).sum())
        err["envelope_pass"] = max(err["envelope_pass"], d_err, int(p_diff > 0))
        assert d_err == 0 and p_diff == 0, (name, axis, d_err, p_diff)
        found = int((d < edt_envelope.MISS).sum())
        log(f"  K5 {name} {tuple(g2.shape)} axis={axis}: distances and payloads equal to plain "
            f"({found} of {d.numel()} voxels reach a site)")


def k6_frames() -> dict:
    """K6's depth frames: the bench frame, one cropped to 479x638 (neither
    side a multiple of 2, 4, 7 or 8), and one with NaN, -inf and +inf pixels
    beside its invalid patch (a pooled cell with a NaN pixel is NaN and
    carves nothing; a cell of +inf pixels carves up to the frame)."""
    bench = bench_frame()
    special = bench_frame(seed=3)
    rng = np.random.default_rng(3)
    for value, share in ((np.nan, 0.002), (-np.inf, 0.002), (np.inf, 0.01)):
        special[rng.random(special.shape) < share] = value
    special[400:416, 560:576] = np.inf  # four whole cells at P = 8
    special[200:203, 100:140] = np.nan  # a NaN band across cells
    return {"bench": bench, "cropped": np.ascontiguousarray(bench[:479, :638]), "special": special}


def edge_pose(dims) -> np.ndarray:
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [(dims[0] // 2 + 0.5) * EDGE_SIDE, (dims[1] // 2 + 0.5) * EDGE_SIDE, EDGE_SIDE / 2]
    return pose


def check_k6(dev: torch.device, err: dict) -> None:
    frames = {name: torch.as_tensor(f, device=dev) for name, f in k6_frames().items()}
    for name, depth in frames.items():
        for pool in (1,) + K6_POOLS:
            got = raycast_cuda.min_pool_depth(depth, pool)
            ref = raycast_cuda.min_pool_depth_plain(depth, pool)
            same = got.shape == ref.shape and torch.equal(got.view(torch.int32), ref.view(torch.int32))
            err["min_pool_depth"] = max(err["min_pool_depth"], int(not same))
            assert same, (name, pool)
        log(f"  K6 pool {name} {tuple(depth.shape)} P in {(1,) + K6_POOLS}: pooled tables equal to plain bit "
            f"pattern for bit pattern ({int(torch.isnan(ref).sum())} NaN cells at P = {pool})")
    poses = {name: torch.as_tensor(p, device=dev) for name, p in carve_poses().items()}
    # (label, frame, pose, intrinsics, side, dims)
    cases = [(f"pose={name}", "bench", name, INTR, FUSION_SIDE, FUSION_DIMS) for name in poses]
    cases += [("pose=inside dx=250", "bench", "inside", INTR, FUSION_SIDE, (K5_RAGGED[0], *FUSION_DIMS[1:])),
              ("pose=tilted frame 479x638", "cropped", "tilted", INTR, FUSION_SIDE, FUSION_DIMS),
              ("pose=bench NaN/inf frame", "special", "bench", INTR, FUSION_SIDE, FUSION_DIMS)]
    poses["edge"] = torch.as_tensor(edge_pose(FUSION_DIMS), device=dev)
    frames["edge"] = frames["bench"] * 8.0  # 32, 20 and 14.4 m planes: the 64 m grid carves
    cases.append(("edge-aligned pose", "edge", "edge", EDGE_INTR, EDGE_SIDE, FUSION_DIMS))
    for label, frame, pose, intr, side, dims in cases:
        args = (frames[frame], poses[pose], *intr, side, dims)
        exact = raycast_cuda.projective_free_space_exact(*args)
        for pool in K6_POOLS:
            got = raycast_cuda.projective_free_space_pooled(*args, pool=pool)
            ref = raycast_cuda.projective_free_space_pooled_plain(*args, pool=pool)
            diff = int((got != ref).sum())
            err["projective_free_space_pooled"] = max(err["projective_free_space_pooled"], int(diff > 0))
            outside = int((got & ~exact).sum())
            assert diff == 0 and outside == 0 and int(got.sum()) > 0, (label, pool, diff, outside)
            log(f"  K6 {label} dims={dims} P={pool}: {int(got.sum())} free voxels (exact carve "
                f"{int(exact.sum())}), mask equal to plain bit for bit and inside K3's")
    # the edge-aligned pose really meets the edges it is there for
    on_edge = edge_projections(dev)
    assert all(v > 0 for v in on_edge.values()), on_edge
    log(f"  K6 edge-aligned pose: voxel centres in view projecting exactly onto {on_edge}")
    check_k6_offsets(dev, frames["bench"], poses, err)


def check_k6_offsets(dev: torch.device, depth: torch.Tensor, poses: dict, err: dict) -> None:
    """K6 on 32-deep z-slabs of the 256^3 grid (the sharded pooled carve,
    one table a frame): at z_index_offset 0, 32 and 224 bit-identical to the
    plain form, the eight slabs stacked equal to the whole grid's mask, and
    offset 0 equal to the call without one, under path 1's 3 poses at every
    P."""
    slab = (FUSION_DIMS[0], FUSION_DIMS[1], K3_SLAB)
    for name in carve_poses():
        p = poses[name]
        for pool in K6_POOLS:
            whole = raycast_cuda.projective_free_space_pooled(depth, p, *INTR, FUSION_SIDE, FUSION_DIMS, pool=pool)
            table = raycast_cuda.min_pool_depth(depth, pool)
            args = (table, pool, depth.shape, p, *INTR, FUSION_SIDE, slab)
            for z0 in K3_OFFSETS:
                got = raycast_cuda.carve_against_pooled(*args, z_index_offset=z0)
                ref = raycast_cuda.carve_against_pooled_plain(*args, z_index_offset=z0)
                wrapped = raycast_cuda.projective_free_space_pooled(depth, p, *INTR, FUSION_SIDE, slab, pool=pool,
                                                                    z_index_offset=z0)
                diff = int((got != ref).sum()) + int((wrapped != ref).sum())
                err["projective_free_space_pooled"] = max(err["projective_free_space_pooled"], int(diff > 0))
                assert diff == 0, (name, pool, z0, diff)
            assert torch.equal(raycast_cuda.carve_against_pooled(*args), raycast_cuda.carve_against_pooled(
                *args, z_index_offset=0)), (name, pool)
            stacked = torch.cat([raycast_cuda.carve_against_pooled(*args, z_index_offset=z0)
                                 for z0 in range(0, FUSION_DIMS[2], K3_SLAB)])
            assert torch.equal(stacked, whole), (name, pool)
        log(f"  K6 pose={name} on {K3_SLAB}-deep slabs, P in {K6_POOLS}: offsets {K3_OFFSETS} equal to plain bit "
            f"for bit, offset 0 == no offset, {FUSION_DIMS[2] // K3_SLAB} slabs stacked == the whole grid's mask "
            f"({int(whole.sum())} free at P = {pool})")


def edge_projections(dev: torch.device) -> dict:
    """How many in-front voxel centres of the edge-aligned pose project exactly
    onto a pooled-cell corner at each P (u and v both in P * Z, inside the
    image) and onto each edge of the image (u = 640 and v = 480 lie just
    outside it)."""
    dx, dy, dz = FUSION_DIMS
    h, w = bench_frame().shape
    fx, fy = (int(f) for f in EDGE_INTR[:2])
    _, u, v, _ = raycast._project(dev, torch.as_tensor(edge_pose(FUSION_DIMS), device=dev), *EDGE_INTR, EDGE_SIDE,
                                  FUSION_DIMS, h, w)
    u, v = u.reshape(-1), v.reshape(-1)
    x = torch.arange(dx, device=dev).view(1, 1, dx) - dx // 2
    y = torch.arange(dy, device=dev).view(1, dy, 1) - dy // 2
    z = torch.arange(dz, device=dev).view(dz, 1, 1)
    # u and v integers in exact arithmetic, in front of the camera
    on_pixel = ((z > 0) & (fx * x % z.clamp(min=1) == 0) & (fy * y % z.clamp(min=1) == 0)).reshape(-1)
    inside = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    counts = {f"cell corners P={p}": int((on_pixel & inside & (u % p == 0) & (v % p == 0)).sum()) for p in K6_POOLS}
    for name, hit in (("u = 0", u == 0), (f"u = {w}", u == w), ("v = 0", v == 0), (f"v = {h}", v == h)):
        counts[name] = int((on_pixel & hit).sum())
    return counts


def hazard_bits(dev: torch.device, n: int, seed: int = 11) -> dict:
    """tests/test_collide_pallas.py:91-127's fixtures at length n: {density:
    (a, b)}, single random bits at densities 0, 0.002 and 0.2, and voxel 5
    holding only eBVM_FREE in a (summary 0) where b holds SV bit 6."""
    rng = np.random.default_rng(seed)
    out = {}
    for density in (0.0, 0.002, 0.2):
        maps = []
        k = max(1, int(n * density))
        idx = [rng.choice(n, k, replace=False) for _ in range(2)]
        for i in idx:
            w = np.zeros((8, n), np.uint32)
            w[rng.integers(0, 8, k), i] = np.uint32(1) << rng.integers(0, 32, k).astype(np.uint32)
            maps.append(w)
        maps[0][0, 5] = 1
        maps[1][0, 5] = 1 << 6
        out[density] = tuple(torch.from_numpy(w.view(np.int32)).to(dev) for w in maps)
    return out


def occupancy(planes: torch.Tensor) -> torch.Tensor:
    """The maintained summary of raw planes: uint8 !noneButEmpty."""
    return bitops.occupied(planes).to(torch.uint8)


def k4_gated_cases(dev: torch.device, g: torch.Generator, dense) -> list:
    """(name, a, b, margin, occ_a, occ_b, b_valid): K4's gated and list
    forms on the hazard fixtures at 256^3 and at a ragged length, a
    conservative summary (ones), an all-dead map, summaries that start off
    a 16-byte boundary, the dense fixture and a list's match mask."""
    n = SV_DIMS[0] * SV_DIMS[1] * SV_DIMS[2]
    cases = []
    for length in (n, K4_RAGGED_N):
        for density, (a, b) in hazard_bits(dev, length).items():
            for m in (0, 3, 4, 8):
                cases.append((f"hazard {density} N={length}", a, b, m, occupancy(a), occupancy(b), None))
    a, b = dense
    ones = torch.ones(n, dtype=torch.uint8, device=dev)
    cases.append(("dense, conservative summaries", a, b, 5, ones, ones, None))
    cases.append(("dense", a, b, 5, occupancy(a), occupancy(b), None))
    dead = torch.zeros_like(a)
    cases.append(("all-dead a", dead, b, 8, occupancy(dead), occupancy(b), None))
    cases.append(("all-dead b", a, dead, 8, occupancy(a), occupancy(dead), None))
    # summaries of a[:, 1:]: views one byte into their storage
    sa, sb = a[:, 1:].contiguous(), b[:, 1:].contiguous()
    cases.append(("misaligned summaries", sa, sb, 4, occupancy(a)[1:], occupancy(b)[1:], None))
    valid = torch.rand(n, device=dev, generator=g) < 0.3
    cases.append(("list mask", a, b, 5, None, None, valid))
    cases.append(("list mask, gated", a, b, 4, occupancy(a), occupancy(b), valid))
    return cases


def check_k4_gated(dev: torch.device, g: torch.Generator, dense, err: dict) -> None:
    """K4 gated by summaries and with a list's mask against its plain
    version (which reads every voxel), with a mark and count only, one
    launch a call."""
    for name, a, b, margin, occ_a, occ_b, valid in k4_gated_cases(dev, g, dense):
        ref_c, ref_m, ref_new = collide_cuda.collide_types_bit_bit_plain(a, b, margin, True, b_valid=valid)
        live = torch.ones(a.shape[1], dtype=torch.bool, device=dev) if occ_a is None else \
            collide_cuda.k4_live_mask(a, occ_a, occ_b, margin)
        hit, _ = bitops.bit_margin_collision_check_packed(a, b, margin)
        if valid is not None:
            live, hit = live & valid, hit & valid
        assert not bool((hit & ~live).any()), (name, margin, "a hit outside the live mask")
        before = collide_cuda.launches["collide_types_bit_bit"]
        got = [collide_cuda.collide_types_bit_bit(a, b, margin, mark, occ_a, occ_b, b_valid=valid)
               for mark in (True, False)]
        assert collide_cuda.launches["collide_types_bit_bit"] == before + 2
        for (cnt, meanings, new), mark in zip(got, (True, False)):
            same = torch.equal(meanings, ref_m) and torch.equal(new, ref_new if mark else a)
            err["collide_types_bit_bit"] = max(err["collide_types_bit_bit"], abs(int(cnt) - int(ref_c)), int(not same))
            assert int(cnt) == int(ref_c) and same, (name, margin, mark)
        log(f"  K4 gated, {name}, margin={margin}: count {int(ref_c)} == plain, meanings and marked map equal "
            f"(with a mark and count only); {int(live.sum())} live voxels of {a.shape[1]}")


def dense_bits(dev: torch.device, n: int, g: torch.Generator) -> torch.Tensor:
    """Dense-random words, bit 31 included, with whole voxels zeroed with p = 0.7
    (tests/test_collide_pallas.py:45-55)."""
    w = torch.randint(-(2**31), 2**31 - 1, (8, n), dtype=torch.int32, device=dev, generator=g)
    return w * (torch.rand(n, device=dev, generator=g) < 0.3)


def sparse_bits(dev: torch.device, n: int, g: torch.Generator):
    """A few single bits per map, plus the bit-0-only hazard voxel: a holds
    only eBVM_FREE (occupancy 0) where b holds SV bit 6, which a window of
    margin >= 4 reaches (collide_pallas.py:338-346)."""
    maps = []
    for _ in range(2):
        k = n // 500
        idx = torch.randint(0, n, (k,), device=dev, generator=g)
        plane = torch.randint(0, 8, (k,), device=dev, generator=g)
        bit = torch.randint(0, 32, (k,), device=dev, generator=g)
        w = torch.zeros((8, n), dtype=torch.int32, device=dev)
        w[plane, idx] = torch.where(bit == 31, -(2**31), 1 << bit.to(torch.int64)).to(torch.int32)
        maps.append(w)
    a, b = maps
    a[:, 5] = 0
    b[:, 5] = 0
    a[0, 5] = 1
    b[0, 5] = 1 << 6
    return a, b


# -- phase 3 ------------------------------------------------------------------
@contextlib.contextmanager
def plain_route():
    """Route the map methods through the plain torch versions (the reference
    run of the main path on the same card)."""
    plain = {
        (collide_cuda, "count_prob_prob"): collide_cuda.count_prob_prob_plain,
        (collide_cuda, "count_and_mark_prob"): collide_cuda.count_and_mark_prob_plain,
        (raycast_cuda, "projective_free_space_exact"): raycast_cuda.projective_free_space_plain,
        (collide_cuda, "collide_types_bit_bit"): collide_cuda.collide_types_bit_bit_plain,
        (edt_cuda, "envelope_pass"): edt_cuda.envelope_pass_plain,
        (raycast_cuda, "projective_free_space_pooled"): raycast_cuda.projective_free_space_pooled_plain,
        (raycast_cuda, "min_pool_depth"): raycast_cuda.min_pool_depth_plain,
        (collide_cuda, "count_bit_bit"): collide_cuda.count_bit_bit_plain,
    }
    assert {(m, n) for n, m, *_ in KERNELS} == set(plain)
    saved = {key: getattr(*key) for key in plain}
    for (module, name), fn in plain.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)


def kinect_sensor() -> Sensor:
    return Sensor(position=np.asarray([2.56, 2.56, 0.1], np.float32), data_width=640, data_height=480,
                  fx=INTR[0], fy=INTR[1], cx=INTR[2], cy=INTR[3])


def main_path(dev: torch.device) -> dict:
    """The slice's main path through the public entry points."""
    out = {}
    # (a) the facade linkage scene (BASELINE config #1)
    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(128, 128, 128, 0.01, device=dev)
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "bA")
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "bB")
    gvl.insert_box_into_map((0.4, 0.4, 0.4), (0.8, 0.8, 0.8), "bA", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    gvl.insert_box_into_map((0.2, 0.2, 0.2), (0.6, 0.6, 0.6), "bB", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    out["linkage"] = gvl.get_map("bA").collide_with(gvl.get_map("bB"), 0.1)

    # (b) Kinect fusion: 5 synthetic 640x480 frames into 256^3 (config #2)
    sensor = kinect_sensor()
    src = SyntheticDepthSource(sensor, seed=0)
    env = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev)
    out["frames"] = [src.get_frame() for _ in range(5)]
    for frame in out["frames"]:
        env = env.insert_depth_image(frame, sensor)
    out["env"] = env

    # (c) a sphere robot moved by an RPY pose, against the fused and a box environment
    sphere = to_device(generation.create_sphere_of_points((0.0, 0.0, 0.0), 0.35, FUSION_SIDE), torch.float32, dev)
    pose = transforms.from_rpy([0.1, -0.2, 0.4], [2.56, 2.56, 4.45], device=dev)
    robot_pts = transforms.transform_points(pose, sphere)
    robot_bit = BitVectorVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(robot_pts)
    robot_prob = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(robot_pts)
    box = generation.create_box_of_points((2.3, 2.3, 4.2), (2.8, 2.8, 4.6), FUSION_SIDE)
    box_env = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(box)
    out["robot"] = robot_pts
    out["robot_counts"] = [
        robot_bit.collide_with(env, 0.55),  # bit x prob (occupancy summary)
        env.collide_with(robot_prob, 0.55),  # prob x prob: K1
        box_env.collide_with(robot_prob, 0.55),  # K1
        box_env.collide_with(robot_bit, 0.55),  # prob x bit
    ]

    # (d) the 512^3 insert -> collide cycle with two 307,200-point clouds
    pts = to_device(generation.create_equidistant_points_in_box(307200, (511, 511, 511), 1.0), torch.float32, dev)
    m1 = ProbVoxelMap.create(CYCLE_DIMS, 1.0, device=dev).insert_point_cloud(pts)
    m2 = ProbVoxelMap.create(CYCLE_DIMS, 1.0, device=dev).insert_point_cloud(pts + 1.0)
    m3 = ProbVoxelMap.create(CYCLE_DIMS, 1.0, device=dev).insert_point_cloud(pts + 2.0)
    out["cycle_pts"] = pts
    out["cycle"] = m1.collide_with(m2, 0.5)
    out["cycle_overlap"] = m1.collide_with(m3, 0.5, (2, 0, 0))
    out["mark"] = m1.collide_with_marking(m3, 0.5)
    del m1, m2, m3

    # (d2) live sensing through Providers: the exact and the pooled carve fed
    # 3 frames each from a cadenced source (frames in order: a callable
    # source hands out the next one whenever one is due), and the robot's
    # count against each map as a device scalar
    robot_provider = Provider("robot")
    robot_provider.init(robot_bit)
    out["live"] = []
    for pool in (1, POOL):
        env_provider = Provider(f"env_pool{pool}", carve_pool=pool)
        env_provider.init(ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev))
        robot_provider.set_collide_with(env_provider, coll_threshold=0.55)
        frames = iter(out["frames"][:3])
        stream = StreamingDepthSource(lambda: next(frames), hz=500.0)
        for _ in range(3):
            assert env_provider.wait_for_new_data(stream, sensor, timeout_s=5.0)
        out["live"].append((env_provider.map, robot_provider.collide_async()))

    # (d3) the per-ray DDA: one frame's 307,200 endpoints with raycasting,
    # and a density counter of the same endpoints with its threshold mask
    rays = sensor.process_depth_image(out["frames"][0], device=dev)
    out["rays"] = rays
    out["dda"] = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).insert_sensor_data(
        rays, sensor_origin=sensor.position)
    counting = CountingVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(rays)
    out["counting"] = counting
    out["dense_cells"] = counting.occupied_mask(3)
    return out


class PlacedArm:
    """The UR10 with its base at a world position (default: the BASELINE #3
    base, bench.py:328-334): FK for a batch of 6-joint configurations,
    tool0's value pinned to 0, shifted to the base."""

    def __init__(self, chain, dev: torch.device, base=SV_BASE):
        self.chain = chain
        self.base = to_device(base, torch.float32, dev)

    def transformed_clouds_for(self, cfg: torch.Tensor):
        full = torch.cat([cfg, torch.zeros_like(cfg[..., :1])], dim=-1)
        clouds = self.chain.transformed_clouds_for(full)
        return replace(clouds, points=clouds.points + self.base)


def sweep_scene(dev: torch.device, chain) -> dict:
    """BASELINE #3's 64-step UR10 swept volume in a fresh 256^3 bit map
    (`sweep`), and an environment whose obstacles carry the SV bits of a
    few steps where the wrist is then (`env`): K4's main-path data."""
    placed = PlacedArm(chain, dev)
    cfgs = to_device(SV_TRAJ, torch.float32, dev)
    sweep = insert_swept_volume_batched(BitVectorVoxelMap.create(SV_DIMS, SV_SIDE, device=dev), placed, cfgs)
    steps = placed.transformed_clouds_for(cfgs).points  # [64, P, 3]: the sweep's own FK
    wrist = chain.clouds.offsets[-3]  # the wrist_3 and tool0 clouds
    env = BitVectorVoxelMap.create(SV_DIMS, SV_SIDE, device=dev)
    for k in OBSTACLE_STEPS:
        env = env.insert_point_cloud(steps[k, wrist::5], SV_START + k)
    return {"placed": placed, "cfgs": cfgs, "sweep": sweep, "env": env}


def robot_path(dev: torch.device, fused_env: ProbVoxelMap) -> dict:
    """The robot -> swept volume -> types-collide path through the public
    entry points (BASELINE config #3)."""
    out = {}
    chain = ur_robot("ur10", SV_SIDE, device=dev)
    out["chain"] = chain
    # (e) the facade: the UR10 behind a fixed DH base link (theta pi/4,
    # a = |(2.56, 2.56)|, d = 0.5: its first frame at the bench's base)
    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(*SV_DIMS, SV_SIDE, device=dev)
    gvl.add_map(MapType.MT_BITVECTOR_VOXELMAP, "arm")
    base = DHParameters(d=SV_BASE[2], theta=math.pi / 4, a=math.hypot(SV_BASE[0], SV_BASE[1]), alpha=0.0)
    gvl.add_robot_dh("ur10", ["base"] + chain.link_names, [base] + [chain.dh[n] for n in chain.link_names],
                     chain.clouds, lower_limits=chain.get_lower_joint_limits(),
                     upper_limits=chain.get_upper_joint_limits())
    gvl.set_robot_configuration("ur10", dict(zip(chain.link_names, SV_TRAJ[32].tolist())))
    gvl.insert_robot_into_map("ur10", "arm", BitVoxelMeaning.eBVM_OCCUPIED)
    out["facade_inserted"] = gvl.get_map("arm")
    gvl.insert_robot_into_map("ur10", "arm", BitVoxelMeaning.eBVM_COLLISION)
    out["facade_marked"] = gvl.get_map("arm")
    gvl.clear_map("arm", BitVoxelMeaning.eBVM_COLLISION)
    out["facade_cleared"] = gvl.get_map("arm")

    # (f) the 64-step UR10 swept volume into a fresh 256^3 bit map, and an
    # environment whose obstacles sit where the wrist is at a few steps
    out.update(sweep_scene(dev, chain))
    sweep, env = out["sweep"], out["env"]

    # (g) the collides: K4 with marking, K4 count only, bit x prob (plain),
    # after a time shift, and the collision flags cleared again
    out["types"] = [sweep.collide_with_types(env, 1.0, w) for w in (0, 2, 5)]
    out["bitcheck"] = [sweep.collide_with_bitcheck(env, m) for m in (0, 8)]
    out["types_prob"] = sweep.collide_with_types(fused_env, 0.55)
    out["types_shifted"] = sweep.shift_left_swept_volume_ids(1).collide_with_types(env, 1.0, 2)
    out["cleared"] = out["types"][0][2].clear_collision_flags()
    return out


@contextlib.contextmanager
def host_reads():
    """The fitter's searches branch on counts: within this block the sync
    debug mode is at its default, and back to what it was afterwards."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("default")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def raw_planes(m: BitVectorVoxelMap) -> BitVectorVoxelMap:
    """The map without its occupancy summary: the raw-plane form."""
    return BitVectorVoxelMap(m.data, m.dims, m.side_length)


def fitter_answers(robots) -> dict:
    """What examples/swept_fitter.py asks of one set of swept maps: the
    device counts first, then (host reads allowed) the searches."""
    a_center, b_center = robots[0][1][0][1], robots[1][1][0][1]
    assert (robots[0][1][0][0], robots[1][1][0][0]) == ("A_reach_center", "B_reach_center")
    out = {"center": a_center.collide_with(b_center),
           "conflicts0": a_center.collide_with_bitcheck(b_center, margin=FIT_WINDOW)}
    with host_reads():
        out["solutions"] = fit_orderings(robots, all_solutions=True)
        out["delays"] = deconflict_slot([a_center, b_center], margin=FIT_WINDOW, stride=4)
        out["schedule"] = fit_schedule(robots, margin=FIT_WINDOW, stride=4, windows_in_search=True)
    return out


def fitter_path(dev: torch.device, sweep: BitVectorVoxelMap, env: BitVectorVoxelMap) -> dict:
    """The trajectory-scheduling path through the public entry points:
    .traj files -> swept volumes -> raw-plane collides -> schedule fitter."""
    out = {}
    chain = ur_robot("ur10", FIT_SPACING, device=dev)
    robots = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, (fname, text) in TRAJ_FILES.items():
            path = os.path.join(tmp, fname)
            with open(path, "w") as f:
                f.write(text)
            arm = PlacedArm(chain, dev, FIT_BASES[name])
            robots.append((name, [
                (t.name, insert_swept_volume_batched(BitVectorVoxelMap.create(FIT_DIMS, FIT_SIDE, device=dev), arm,
                                                     t.interpolate(FIT_STEPS)))
                for t in load_trajectories(path)]))
    out["robots"] = robots
    out["robots_raw"] = [(name, [(t, raw_planes(m)) for t, m in maps]) for name, maps in robots]
    out["summary"] = fitter_answers(robots)  # count_occ_occ
    out["raw"] = fitter_answers(out["robots_raw"])  # K7
    # BASELINE #3 as the bench runs it (bench.py:340-352): the swept map's
    # planes against the environment's planes, and the same through the maps
    out["b3_planes"] = collide_cuda.count_bit_bit(sweep.data, env.data)
    out["b3_raw"] = raw_planes(sweep).collide_with(raw_planes(env))
    out["b3_mixed"] = sweep.collide_with(raw_planes(env), offset=(1, 0, -1))
    out["b3_summary"] = sweep.collide_with(env), sweep.collide_with(env, offset=(1, 0, -1))
    return out


def fitter_numbers(ans: dict) -> tuple:
    return int(ans["center"]), int(ans["conflicts0"]), ans["solutions"], ans["delays"], ans["schedule"]


def check_fitter_path(fit: dict, plain: dict) -> None:
    for name, maps in fit["robots"]:
        for traj, m in maps:
            assert int(m.occ.sum()) > 0 and not bool(m.data[4:].any()), "101 steps set SV bits 4..104 (planes 0-3)"
    for (_, maps), (_, pmaps) in zip(fit["robots"], plain["robots"]):
        for (_, m), (_, pm) in zip(maps, pmaps):
            assert same_map(m, pm)
    assert all(m.occ is None for _, maps in fit["robots_raw"] for _, m in maps)
    center, conflicts0, solutions, delays, schedule = fitter_numbers(fit["raw"])
    assert center > 0 and conflicts0 > 0, (center, conflicts0)
    assert len(solutions) == 2, solutions  # the two centre / home interleavings
    assert delays is not None and delays[0] == 0 and delays[1] > 0, delays
    assert len(schedule) == 1 and all(d is not None for d in schedule[0][1]), schedule
    for other in (fit["summary"], plain["raw"], plain["summary"]):
        assert fitter_numbers(other) == (center, conflicts0, solutions, delays, schedule)
    log(f"  (j) two UR10s, {FIT_STEPS + 1} poses per trajectory at {FIT_DIMS[0]}^3: centre reaches collide in "
        f"{center} voxels ({conflicts0} within +-{FIT_WINDOW} steps); orderings {solutions}; start delays {delays}; "
        f"schedule {schedule}; raw planes == summaries == plain route")
    b3 = [int(fit[k]) for k in ("b3_planes", "b3_raw")] + [int(fit["b3_summary"][0])]
    assert b3[0] == b3[1] == b3[2] > 0, b3
    assert int(fit["b3_mixed"]) == int(fit["b3_summary"][1])
    for key in ("b3_planes", "b3_raw", "b3_mixed"):
        assert int(fit[key]) == int(plain[key]), key
    log(f"  (k) BASELINE #3 planes x planes: count {b3[0]} == maps without summaries == summaries == plain route; "
        f"offset (1, 0, -1): {int(fit['b3_mixed'])}")


def edt_obstacles() -> np.ndarray:
    """BASELINE #4's 20,000 random obstacle voxels (int64 [M, 3] x, y, z),
    from a numpy seed; duplicates merge on insert."""
    n = EDT_DIMS[0] * EDT_DIMS[1] * EDT_DIMS[2]
    idx = np.random.default_rng(4).integers(0, n, EDT_OBSTACLES)
    dx, dy, _ = EDT_DIMS
    return np.stack([idx % dx, (idx // dx) % dy, idx // (dx * dy)], axis=1)


def edt_queries() -> np.ndarray:
    """BASELINE #4's 4,096 proximity query points, from a numpy seed."""
    return np.random.default_rng(5).uniform(0.0, 512.0, (4096, 3)).astype(np.float32)


def distance_path(dev: torch.device, frames, placed: "PlacedArm", cfgs: torch.Tensor) -> dict:
    """The camera -> distance field path through the public entry points."""
    out = {}
    # (h) BASELINE #4 through the facade: 512^3 at 1.0 m, 20,000 obstacles,
    # the exact EDT, then proximity queries and byte distances
    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(*EDT_DIMS, 1.0, device=dev)
    gvl.add_map(MapType.MT_DISTANCE_VOXELMAP, "edt")
    gvl.insert_point_cloud_into_map((edt_obstacles() + 0.5).astype(np.float32), "edt")
    dm = gvl.update_map("edt", lambda m: m.parallel_banding())
    out["edt"] = dm
    out["edt_min"] = dm.min_distance_to(edt_queries())
    out["edt_bytes"] = dm.extract_distances()
    dx, dy, dz = EDT_DIMS
    out["edt_at"] = [dm.get_squared_obstacle_distance(*v) for v in ((0, 0, 0), (dx // 2, dy // 2, dz // 2),
                                                                     (dx - 1, 3, dz // 7))]

    # (i) Kinect frames fused with the pooled carve (K6), merged into a
    # distance map, its EDT (jump_flood's card route: K5), the UR10's
    # clearance at step 32 and the 0.1 m clearance bit map
    sensor = kinect_sensor()
    env = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev)
    for frame in frames:
        env = env.insert_depth_image(frame, sensor, carve_pool=POOL)
    out["pooled_env"] = env
    merged = DistanceVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).merge_occupied(env)
    out["merged"] = merged
    field = merged.jump_flood()
    out["field"] = field
    out["arm_clearance"] = field.min_distance_to(placed.transformed_clouds_for(cfgs[32:33]).points[0])
    out["clearance_bits"] = converters.distance_map_to_bit_map(field, clearance=0.1)
    return out


def brute_check(dm: DistanceVoxelMap, dev: torch.device) -> int:
    """The EDT's squared distances at BRUTE_SAMPLES sampled voxels against
    the brute minimum over all obstacles, on the card in chunks: an
    oracle independent of the port's own plain version. Returns the
    number of sampled voxels that differ."""
    n = dm.voxelmap_size
    dx, dy, _ = dm.dims
    samp = torch.randint(0, n, (BRUTE_SAMPLES,), device=dev, generator=torch.Generator(device=dev).manual_seed(7))
    got = edt.squared_distance_at(dm.data, samp, dm.dims)
    pos = torch.stack([samp % dx, (samp // dx) % dy, samp // (dx * dy)], dim=1)
    obs = torch.as_tensor(edt_obstacles(), device=dev)
    brute = torch.cat([((p[:, None, :] - obs[None]) ** 2).sum(-1).amin(1) for p in pos.split(256)])
    return int((brute != got.to(torch.int64)).sum())


def check_distance_path(dist: dict, plain: dict, dev: torch.device) -> None:
    dm = dist["edt"]
    d2 = dm.squared_distances()
    n_obs = int((d2 == 0).sum())
    assert n_obs > 0 and not bool((d2 >= 2**31 - 1).any()), "every voxel of a map with obstacles reaches one"
    bad = brute_check(dm, dev)
    assert bad == 0, f"{bad} of {BRUTE_SAMPLES} sampled voxels differ from the brute minimum"
    log(f"  (h) BASELINE #4 512^3 EDT: {n_obs} obstacle voxels, max squared distance {int(d2.max())}; "
        f"{BRUTE_SAMPLES} sampled voxels equal the brute minimum over {EDT_OBSTACLES} obstacles")
    for key in ("edt", "pooled_env", "merged", "field"):
        assert torch.equal(dist[key].data, plain[key].data), f"{key} differs from the plain route"
    for key in ("edt_min", "edt_bytes", "arm_clearance"):
        assert torch.equal(dist[key], plain[key]), key
    assert [int(v) for v in dist["edt_at"]] == [int(v) for v in plain["edt_at"]]
    assert same_map(dist["clearance_bits"], plain["clearance_bits"])
    log(f"  (h) min distance of 4096 query points {float(dist['edt_min']):.4f} m; squared distances at 3 voxels "
        f"{[int(v) for v in dist['edt_at']]}; payload grid, queries and bytes == plain route")
    env, field = dist["pooled_env"].data, dist["field"]
    n_occ = int((env >= 0).sum())
    assert n_occ > 0 and int((field.squared_distances() == 0).sum()) == n_occ
    clearance = float(dist["arm_clearance"])
    assert 0.0 < clearance < 1e3, clearance
    log(f"  (i) 5 frames pooled-carved (P={POOL}) into 256^3: {n_occ} obstacles; UR10 at step 32 clears them "
        f"by {clearance:.4f} m; {int(dist['clearance_bits'].occ.sum())} voxels within 0.1 m; fused map, "
        f"distance map, EDT, clearance and bit map == plain route")


def drive(path, kernel_names, *args) -> tuple[dict, dict]:
    """Run one path with every launch count at 0 and the sync debug mode
    raising (counts stay device tensors: the path must never make the host
    wait for the device); return its outputs and every kernel's launches in
    it. Each kernel of `kernel_names` must have launched."""
    for name, module, *_ in KERNELS:
        module.launches[name] = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = path(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = {name: module.launches[name] for name, module, *_ in KERNELS}
    log(f"  launches on the path: { {name: count for name, count in launches.items() if count} }")
    for name in kernel_names:
        assert launches[name] > 0, f"kernel {name} was not launched on its path"
    return out, launches


def add_launches(total: dict, path: dict) -> None:
    for name, count in path.items():
        total[name] = total.get(name, 0) + count


def same_map(x, y) -> bool:
    return torch.equal(x.data, y.data) and torch.equal(x.occ, y.occ)


def same_types(x, y) -> bool:
    """Two (count, meanings, marked map) results are equal."""
    return int(x[0]) == int(y[0]) and torch.equal(x[1], y[1]) and same_map(x[2], y[2])


def drive_main_path(dev: torch.device) -> tuple[dict, dict, dict, dict, dict, dict, dict, dict, dict, dict, dict]:
    log("  sense -> insert -> collide (K1, K2, K3, K6 through the pooled Provider)")
    out, launches = drive(main_path, {"count_prob_prob", "count_and_mark_prob", "projective_free_space_exact",
                                      "projective_free_space_pooled", "min_pool_depth"}, dev)

    assert int(out["linkage"]) == 8000, int(out["linkage"])
    log(f"  (a) facade linkage scene: count {int(out['linkage'])} == 8000")
    data = out["env"].data
    assert data.dtype == torch.int8 and data.shape == (FUSION_DIMS[0] * FUSION_DIMS[1] * FUSION_DIMS[2],)
    occupied, free = int((data > 0).sum()), int(((data < 0) & (data > -128)).sum())
    assert occupied > 0 and free > 0
    log(f"  (b) fusion 5 x 640x480 -> 256^3: {occupied} occupied, {free} free voxels")
    counts = [int(c) for c in out["robot_counts"]]
    assert min(counts) > 0, counts
    cnt, marked = out["mark"]
    assert int(out["cycle"]) == 0  # two interleaved checkerboards never share a voxel
    assert int(out["cycle_overlap"]) > 0 and int(cnt) > 0
    check_live_sensing(out, dev)

    log("  robot -> swept volume -> types collide (K4)")
    robot, robot_launches = drive(robot_path, {"collide_types_bit_bit"}, dev, out["env"])
    add_launches(launches, robot_launches)
    check_robot_path(robot)

    log("  camera -> distance field (K5, K6)")
    dist_args = (dev, out["frames"], robot["placed"], robot["cfgs"])
    dist, dist_launches = drive(distance_path, {"envelope_pass", "projective_free_space_pooled", "min_pool_depth"},
                                *dist_args)
    add_launches(launches, dist_launches)
    with plain_route():
        plain_dist = distance_path(*dist_args)
    check_distance_path(dist, plain_dist, dev)
    del plain_dist

    log("  .traj files -> swept volumes -> raw-plane collides -> schedule fitter (K7, K4)")
    fit_args = (dev, robot["sweep"], robot["env"])
    fit, fit_launches = drive(fitter_path, {"count_bit_bit", "collide_types_bit_bit"}, *fit_args)
    add_launches(launches, fit_launches)
    with plain_route():
        plain_fit = fitter_path(*fit_args)
    check_fitter_path(fit, plain_fit)
    del plain_fit

    # the same scenes through the plain route on the card
    with plain_route():
        plain = main_path(dev)
        plain_robot = robot_path(dev, plain["env"])
    assert torch.equal(plain["env"].data, data), "fused map differs from the plain route"
    plain_counts = [int(c) for c in plain["robot_counts"]]
    assert counts == plain_counts, (counts, plain_counts)
    log(f"  (c) robot collides {counts} == plain route, > 0")
    assert int(plain["cycle"]) == 0 and int(plain["cycle_overlap"]) == int(out["cycle_overlap"])
    p_cnt, p_marked = plain["mark"]
    assert int(p_cnt) == int(cnt) and torch.equal(p_marked.data, marked.data)
    log(f"  (d) 512^3 cycle: checkerboards collide 0, shifted overlap {int(out['cycle_overlap'])}, "
        f"marking count {int(cnt)} == plain, marked map equal")
    for (env_map, count), (p_map, p_count) in zip(out["live"], plain["live"]):
        assert torch.equal(env_map.data, p_map.data) and int(count) == int(p_count)
    assert torch.equal(out["dda"].data, plain["dda"].data) and torch.equal(out["counting"].data, plain["counting"].data)
    log("  (d2, d3) provider maps, async counts, the DDA map and the counting map == plain route")
    for key in ("facade_inserted", "facade_cleared", "sweep", "env", "cleared"):
        assert same_map(robot[key], plain_robot[key]), key
    for key in ("types", "bitcheck"):
        for i, (x, y) in enumerate(zip(robot[key], plain_robot[key])):
            assert same_types(x, y) if key == "types" else int(x) == int(y), (key, i)
    for key in ("types_prob", "types_shifted"):
        assert same_types(robot[key], plain_robot[key]), key
    log("  (e-g) every robot-path map, count, meanings vector and marked map == plain route")

    log("  voxel lists (K3, K4)")
    lp, list_launches = drive(list_path, {"projective_free_space_exact", "collide_types_bit_bit"}, dev,
                              out["frames"], robot, out["counting"], dist["field"])
    add_launches(launches, list_launches)
    check_list_path(lp, out["env"])
    check_list_path_on_cpu(lp)

    log("  planning on dense maps (no kernel)")
    plan, plan_launches = drive(planning_path, set(), dev)
    add_launches(launches, plan_launches)
    check_planning_path(plan, dev)

    log("  octrees: BASELINE #5, the paged tiers, dense-tier fusion (K3, K6)")
    oc, oc_launches = drive(octree_path, {"projective_free_space_exact", "projective_free_space_pooled",
                                          "min_pool_depth"}, dev)
    add_launches(launches, oc_launches)
    check_octree_path(oc, dev)

    log("  the facade: the 8x8 collision matrix, files, URDF, visualization (K1, K3, K6, K7)")
    fp, fp_launches = drive(facade_path, {"count_prob_prob", "projective_free_space_exact",
                                          "projective_free_space_pooled", "min_pool_depth", "count_bit_bit"},
                            dev, out["frames"])
    add_launches(launches, fp_launches)
    fp["frames"] = out["frames"]
    log(f"  path 8 launched K1 {fp_launches['count_prob_prob']} and K7 {fp_launches['count_bit_bit']} times")
    check_facade_path(fp, dev)

    log("  multi-device: z-slab meshes on the card, sharded cycles, EDTs, probes, values and their slab forms, "
        "world, facade (K1, K2, K3, K4, K5, K6, K7)")
    md, md_launches = drive(multidevice_path, {"count_prob_prob", "count_and_mark_prob",
                                               "projective_free_space_exact", "projective_free_space_pooled",
                                               "min_pool_depth", "collide_types_bit_bit", "envelope_pass",
                                               "count_bit_bit"},
                            dev, out, robot, dist, oc)
    add_launches(launches, md_launches)
    check_multidevice_path(md, dev, out, robot, dist, oc)

    log("  the example programs: all 19 at their own sizes, each against its CPU copy, an oracle or the plain route "
        "(K1, K3, K4, K5, K6)")
    ex, ex_launches = drive_examples(dev)
    add_launches(launches, ex_launches)
    log(f"  launches on the path: { {name: count for name, count in ex_launches.items() if count} }")
    check_examples_path(ex, dev)
    return out, robot, dist, fit, lp, plan, oc, fp, md, ex, launches


def check_live_sensing(out: dict, dev: torch.device) -> None:
    """The providers against direct inserts of the same frames, and the DDA
    and the counting map against the same calls on CPU copies of the same
    rays (all 307,200 of them)."""
    sensor = kinect_sensor()
    for pool, (env_map, count) in zip((1, POOL), out["live"]):
        direct = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev)
        for frame in out["frames"][:3]:
            direct = direct.insert_depth_image(frame, sensor, carve_pool=pool)
        assert torch.equal(env_map.data, direct.data), pool
        assert isinstance(count, torch.Tensor) and count.device == env_map.device and int(count) >= 0
        log(f"  (d2) provider carve_pool={pool}: 3 streamed frames == 3 direct inserts; async robot count {int(count)}")
    rays = out["rays"]
    dda = out["dda"].data
    carved, hits = int(((dda > -128) & (dda < 0)).sum()), int((dda > 0).sum())
    assert carved > hits > 0, (carved, hits)
    t0 = time.perf_counter()
    cpu_rays = rays.cpu()
    cpu_dda = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device="cpu").insert_sensor_data(
        cpu_rays, sensor_origin=sensor.position)
    cpu_counting = CountingVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device="cpu").insert_point_cloud(cpu_rays)
    assert torch.equal(dda.cpu(), cpu_dda.data), "the DDA on the card differs from the same call on the CPU"
    assert torch.equal(out["counting"].data.cpu(), cpu_counting.data)
    assert torch.equal(out["dense_cells"].cpu(), cpu_counting.occupied_mask(3))
    dense = int(out["dense_cells"].sum())
    assert 0 < dense < int(out["counting"].occupied_mask().sum())
    log(f"  (d3) DDA insert_sensor_data of {rays.shape[0]} rays into 256^3: {hits} occupied, {carved} carved voxels; "
        f"counting map: {dense} voxels with >= 3 points; both == the same calls on the CPU at the full point count "
        f"({time.perf_counter() - t0:.1f} s on the host)")


def check_robot_path(robot: dict) -> None:
    inserted, marked, cleared = robot["facade_inserted"], robot["facade_marked"], robot["facade_cleared"]
    n_arm = int(inserted.occ.sum())
    assert n_arm > 0 and bool(marked.get_bit_mask(BitVoxelMeaning.eBVM_COLLISION).any())
    assert same_map(cleared, inserted), "clear_map(eBVM_COLLISION) must undo the eBVM_COLLISION insert"
    log(f"  (e) facade UR10 at step 32: {n_arm} voxels; eBVM_COLLISION inserted and cleared again")
    sweep, env = robot["sweep"], robot["env"]
    n_sweep = int(sweep.occ.sum())
    assert n_sweep > n_arm and not bool(sweep.data[3:].any()), "64 steps set SV bits 4..67 (planes 0-2)"
    log(f"  (f) 64-step UR10 swept volume at 256^3: {n_sweep} voxels; environment {int(env.occ.sum())} voxels")
    for w, (cnt, meanings, marked) in zip((0, 2, 5), robot["types"]):
        assert int(cnt) > 0, w
        named = [SV_START + k for k in OBSTACLE_STEPS]
        assert all(bool(bitops.get_bit(meanings, m)) for m in named), (w, named)
        assert int(marked.get_bit_mask(BitVoxelMeaning.eBVM_COLLISION).sum()) == int(cnt)
        log(f"  (g) types collide window {w}: count {int(cnt)}, meanings name SV bits {named}")
    assert all(int(c) > 0 for c in robot["bitcheck"])
    assert int(robot["types_shifted"][0]) > 0
    assert same_map(robot["cleared"], sweep), "clear_collision_flags must undo the marking"
    log(f"  (g) bit checks margin 0/8: {[int(c) for c in robot['bitcheck']]}; vs fused prob map: "
        f"{int(robot['types_prob'][0])}; shifted by 1 step, window 2: {int(robot['types_shifted'][0])}")


# -- paths 5 and 6 ------------------------------------------------------------
def sweep_meanings(sweep_pts: torch.Tensor) -> torch.Tensor:
    """SV_START + step for every point of a [steps, P, 3] sweep."""
    steps, p = sweep_pts.shape[:2]
    return (SV_START + torch.arange(steps, device=sweep_pts.device)).repeat_interleave(p)


def list_answers(dev: torch.device, inputs: dict, tmp: str) -> dict:
    """Everything path 5 asks of the voxel lists, on `dev`: the same calls
    run on the card and on CPU copies of the inputs."""
    sweep_pts, rays, env = inputs["sweep_pts"], inputs["rays"], inputs["fused"]
    sweep_dense = inputs["sweep_dense"]
    out = {}
    # (l) the 64-step UR10 sweep into one list in one per-point-meaning
    # insert; the obstacles of the robot path as a list; one Kinect frame's
    # hits into a bit, a counting and a prob list
    sv = bit_vector_voxel_list(SV_DIMS, SV_SIDE, device=dev).insert_point_cloud_with_meanings(
        sweep_pts.reshape(-1, 3), sweep_meanings(sweep_pts))
    wrist = inputs["wrist"]
    obstacles = bit_vector_voxel_list(SV_DIMS, SV_SIDE, device=dev)
    for k in OBSTACLE_STEPS:
        obstacles = obstacles.insert_point_cloud(sweep_pts[k, wrist::5], SV_START + k)
    kinect = bit_vector_voxel_list(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(rays)
    counting = counting_voxel_list(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(rays)
    out["lists"] = {"sweep": sv, "obstacles": obstacles, "kinect": kinect, "counting": counting,
                    "dense_cells": counting.remove_underpopulated(5),
                    "prob": prob_voxel_list(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(rays)}
    # (m) the collides: list x list, types, bit checks (K4 at sv_offset 0
    # and margins up to 24, the plain full-domain form past them), per
    # meaning, list x dense (the fused map, the swept map with and without
    # its summary), the type mask and the coarse levels
    out["collide"] = [sv.collide_with(obstacles), kinect.collide_with(out["lists"]["dense_cells"]),
                      sv.collide_with(kinect)]
    out["types"] = sv.collide_with_types(obstacles)
    out["bitcheck"] = [sv.collide_with_bitcheck(obstacles, m) for m in LIST_MARGINS]
    out["bitcheck_plain"] = [sv.collide_with_bitcheck(obstacles, 25), sv.collide_with_bitcheck(obstacles, 2, 3)]
    out["per_meaning"] = sv.collide_counting_per_meaning(obstacles)
    out["dense"] = [kinect.collide_with_dense(env, 0.55), kinect.collide_with(env), sv.collide_with_dense(env, 0.55),
                    sv.collide_with_dense(sweep_dense), sv.collide_with_dense(raw_planes(sweep_dense)),
                    kinect.collide_with_dense(sweep_dense, offset=(0, 0, -3))]
    first_half = np.zeros(8, np.uint32)
    first_half[0] = np.uint32(0xFFFFFFF0)  # SV bits 4..31: steps 0..27
    out["type_mask"] = [sv.collide_with_type_mask(env, first_half, 0.55),
                        sv.collide_with_type_mask(sweep_dense, first_half),
                        sv.collide_with_type_mask(raw_planes(sweep_dense), first_half)]
    out["resolution"] = [(sv.collide_with_resolution(obstacles, resolution_level=lvl),
                          kinect.collide_with_resolution(env, 0.55, lvl)) for lvl in range(4)]
    # (n) merge with an offset and a new meaning, then subtract
    merged = kinect.merge(obstacles, offset=(1, 0, -1), new_meaning=BitVoxelMeaning.eBVM_COLLISION)
    out["lists"]["merged"] = merged
    out["lists"]["subtracted"] = merged.subtract(kinect)
    # (o) a morton list at 2048^3 (> 2^32 voxels: linear ids refuse it) of
    # the frame's voxels moved beyond coordinate 1,024, across id modes
    try:
        bit_vector_voxel_list(MORTON_DIMS, FUSION_SIDE, device=dev)
        raise AssertionError("a linear list must refuse more than 2^32 voxels")
    except ValueError:
        pass
    with host_reads():
        fit = kinect.shrink_to_fit()  # reads the count
    far = bit_vector_morton_voxel_list(MORTON_DIMS, FUSION_SIDE, device=dev).insert_coordinates(
        fit.entry_coords() + MORTON_SHIFT, BitVoxelMeaning.eBVM_OCCUPIED)
    out["lists"]["morton"] = far
    out["cross"] = [kinect.collide_with(far, offset=(MORTON_SHIFT,) * 3),
                    far.collide_with(kinect, offset=(-MORTON_SHIFT,) * 3), kinect.collide_with(far)]
    # (p) every list kind and each dense map kind to disk and back
    with host_reads():
        out["disk"] = disk_round_trips(dev, tmp, out["lists"], inputs)
    return out


def disk_round_trips(dev: torch.device, tmp: str, lists: dict, inputs: dict) -> dict:
    """write_to_disk then read_from_disk of each list kind and each dense map
    kind; returns each file's digest and whether it read back equal."""
    out = {}
    maps = {"sweep": lists["sweep"], "counting": lists["counting"], "prob": lists["prob"],
            "morton": lists["morton"], "fused": inputs["fused"], "sweep_dense": inputs["sweep_dense"],
            "counting_dense": inputs["counting_dense"], "distance": inputs["field"]}
    for name, m in maps.items():
        path = os.path.join(tmp, f"{name}.{dev.type}.bin")
        assert m.write_to_disk(path)
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        back = m.read_from_disk(path)
        os.remove(path)
        if isinstance(m, VoxelList):
            n = int(m.count)
            same = (int(back.count) == n and torch.equal(back.keys, m.keys[:n])
                    and torch.equal(back.payload, m.payload[..., :n]))
        else:
            same = torch.equal(back.data, m.data) and (
                not isinstance(m, BitVectorVoxelMap) or torch.equal(back.occ, m.occ))
        out[name] = (digest, same, back.device == m.device)
    return out


def list_path(dev: torch.device, frames, robot: dict, counting_dense, field) -> dict:
    """Path 5, voxel lists: the Kinect frames fused into 256^3 (K3) as the
    dense environment, then list_answers on the card (K4 in the bit checks)."""
    sensor = kinect_sensor()
    env = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev)
    for frame in frames:
        env = env.insert_depth_image(frame, sensor)
    inputs = {"sweep_pts": robot["placed"].transformed_clouds_for(robot["cfgs"]).points,
              "rays": sensor.process_depth_image(frames[0], device=dev), "fused": env,
              "sweep_dense": robot["sweep"], "wrist": robot["chain"].clouds.offsets[-3],
              "counting_dense": counting_dense, "field": field}
    with tempfile.TemporaryDirectory() as tmp:
        answers = list_answers(dev, inputs, tmp)
    return {"inputs": inputs, "answers": answers}


def cpu_copy(x):
    """The same value with its tensors on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, (VoxelList, _PyramidQueries)):
        return x.to("cpu")
    if isinstance(x, PagedHierarchicalMap):
        return interop.paged_map_from_numpy(interop.to_numpy(x), device="cpu")
    if isinstance(x, (ProbVoxelMap, BitVectorVoxelMap, CountingVoxelMap, DistanceVoxelMap)):
        occ = getattr(x, "occ", None)
        return replace(x, data=x.data.cpu(), **({} if occ is None else {"occ": occ.cpu()}))
    if isinstance(x, dict):
        return {k: cpu_copy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(cpu_copy(v) for v in x)
    return x


def same_answer(a, b) -> bool:
    """Card answer == CPU answer: lists field for field, tensors exactly."""
    if isinstance(a, VoxelList):
        return (a.capacity == b.capacity and torch.equal(a.keys.cpu(), b.keys) and torch.equal(a.payload.cpu(), b.payload)
                and int(a.count) == int(b.count))
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_answer(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_answer(x, y) for x, y in zip(a, b))
    return a == b


def check_list_path(lp: dict, fused_env: ProbVoxelMap) -> None:
    ans, inputs = lp["answers"], lp["inputs"]
    assert torch.equal(inputs["fused"].data, fused_env.data), "the list path's fused map differs from path 1's"
    lists = ans["lists"]
    sv, obstacles, kinect = lists["sweep"], lists["obstacles"], lists["kinect"]
    sweep_dense = inputs["sweep_dense"]
    # the list sweep holds exactly the dense sweep's voxels and bit vectors
    occupied = torch.nonzero(sweep_dense.occ).reshape(-1)
    n_sv = int(sv.count)
    assert n_sv == occupied.numel() > 0 and torch.equal(sv.keys[:n_sv], occupied)
    assert torch.equal(sv.payload[:, :n_sv], sweep_dense.data[:, occupied])
    log(f"  (l) 64-step UR10 sweep as one list insert: {n_sv} entries == the dense swept map's voxels and bit "
        f"vectors; Kinect frame: {int(kinect.count)} bit-list voxels, {int(lists['counting'].count)} counting, "
        f"{int(lists['dense_cells'].count)} with >= 5 points, {int(lists['prob'].count)} prob")
    count, meanings = ans["types"]
    named = [SV_START + k for k in OBSTACLE_STEPS]
    assert int(count) > 0 and all(bool(bitops.get_bit(meanings, m)) for m in named)
    checks = [int(c) for c in ans["bitcheck"]]
    assert checks[0] > 0 and checks == sorted(checks), checks
    per = ans["per_meaning"]
    assert all(int(per[m]) > 0 for m in named) and int(per.sum()) >= checks[0]
    dense = [int(c) for c in ans["dense"]]
    assert dense[0] > 0 and dense[3] == dense[4] == n_sv, dense
    mask = [int(c) for c in ans["type_mask"]]
    assert 0 < mask[1] == mask[2] < n_sv, mask
    pairs = [int(c) for c in ans["collide"]]
    assert pairs[0] > 0 and pairs[1] == int(lists["dense_cells"].count) > 0, pairs
    res = [(int(a), int(b)) for a, b in ans["resolution"]]
    assert res[0][0] == pairs[0] and all(a > 0 and b > 0 for a, b in res), res
    cross = [int(c) for c in ans["cross"]]
    assert cross[0] == cross[1] == int(kinect.count) and cross[2] == 0, cross
    merged, sub = lists["merged"], lists["subtracted"]
    assert int(sub.count) > 0 and int(merged.count) == int(kinect.count) + int(sub.count)
    for name, (_, same, on_dev) in ans["disk"].items():
        assert same and on_dev, name
    log(f"  (m) list x list {pairs}; types {int(count)} naming SV bits {named}; bit checks at margins "
        f"{LIST_MARGINS}: {checks} (K4), at 25 and at sv_offset 3: {[int(c) for c in ans['bitcheck_plain']]}; "
        f"list x dense {dense}; type mask {mask}; levels 0-3 {res}")
    log(f"  (n, o) merge (offset, new meaning) {int(merged.count)}, subtract {int(sub.count)}; morton list at "
        f"{MORTON_DIMS[0]}^3 across id modes {cross}; disk round trips of {sorted(ans['disk'])} read back equal")


def check_list_path_on_cpu(lp: dict) -> None:
    """The same calls on CPU copies of the same inputs, at the full point
    count: every answer and every file digest equal."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cpu = list_answers(torch.device("cpu"), cpu_copy(lp["inputs"]), tmp)
    card = lp["answers"]
    assert card.keys() == cpu.keys()
    for key in card:
        assert same_answer(card[key], cpu[key]), key
    log(f"  (l-p) every list, count, meanings vector, per-meaning count and file == the same calls on CPU copies "
        f"({time.perf_counter() - t0:.1f} s on the host)")


class PaddedArm:
    """examples/ompl_planner_app.py's 6-joint UR10 (tool0 fixed) based at
    PLAN_BASE, for the planner and for the facade's robot calls."""

    def __init__(self, chain):
        self.chain = chain
        self.base = to_device(PLAN_BASE, torch.float32, chain.clouds.device)

    def transformed_clouds_for(self, cfg):
        full = torch.cat([cfg, torch.zeros_like(cfg[..., :1])], dim=-1)
        c = self.chain.transformed_clouds_for(full)
        return replace(c, points=c.points + self.base)

    def set_configuration(self, joint_values):
        self.chain.set_configuration(joint_values)

    def get_configuration(self):
        return self.chain.get_configuration()

    def get_transformed_clouds(self):
        c = self.chain.get_transformed_clouds()
        return replace(c, points=c.points + self.base)


def move_obstacle(gvl: GpuVoxels) -> None:
    """moveObstacle (gvl_ompl_planner_helper.cpp:76-90): two pillars, a table
    plate and the floor (the animated box is commented out there)."""
    gvl.clear_map("myEnvironmentMap")
    for lo, hi in PLAN_BOXES:
        gvl.insert_box_into_map(lo, hi, "myEnvironmentMap", BitVoxelMeaning.eBVM_OCCUPIED, 2)


def planning_scene(dev: torch.device):
    """examples/ompl_planner_app.py's facade (gvl_ompl_planner_helper.cpp:54-61:
    robot, environment and query prob maps and a bit-voxel-list solution map),
    the UR10 and the scene; returns (facade, robot, checker, validator)."""
    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(*PLAN_DIMS, PLAN_SIDE, device=dev)
    for mt, name in ((MapType.MT_PROBAB_VOXELMAP, "myRobotMap"), (MapType.MT_PROBAB_VOXELMAP, "myEnvironmentMap"),
                     (MapType.MT_BITVECTOR_VOXELLIST, "mySolutionMap"), (MapType.MT_PROBAB_VOXELMAP, "myQueryMap")):
        gvl.add_map(mt, name)
    robot = PaddedArm(ur_robot("ur10", spacing=PLAN_SIDE, device=dev))
    gvl.add_robot_object("myUrdfRobot", robot)
    move_obstacle(gvl)
    checker = GvlValidityChecker(gvl.get_map("myEnvironmentMap"), robot, 0.7)
    return gvl, robot, checker, MotionValidator(checker, resolution=PLAN_RESOLUTION)


def planning_path(dev: torch.device) -> dict:
    """Path 6: examples/ompl_planner_app.py through the port's facade at the
    reference planner's size (150 x 150 x 100 at 0.02 m)."""
    gvl, robot, checker, validator = planning_scene(dev)
    space = plan_space()
    gvl.clear_map("myQueryMap")  # insertStartAndGoal (gvl_ompl_planner_helper.cpp:139-160)
    for cfg, meaning in ((PLAN_START, SV_START), (PLAN_GOAL, SV_START + 1)):
        gvl.set_robot_configuration("myUrdfRobot", dict(zip(robot.chain.link_names[:6], cfg.tolist())))
        gvl.insert_robot_into_map("myUrdfRobot", "myQueryMap", meaning)
    simplifier = PathSimplifier(validator, seed=PLAN_SEED)
    rounds = []
    for n in range(PLAN_ROUNDS):
        move_obstacle(gvl)
        checker.env = gvl.get_map("myEnvironmentMap")
        with host_reads():  # the planner branches on one count per motion check
            result = RRTConnect(space, validator, step=1.0, seed=PLAN_SEED + n).solve(PLAN_START, PLAN_GOAL,
                                                                                       max_iters=3000)
            path = simplifier.simplify(result.path) if result.solved else None
        rnd = {"result": result, "path": path}
        if path is not None:
            # visualizeSolution (gvl_ompl_planner_helper.cpp:102-137): FK of
            # every interpolated state, one per-point-meaning list insert
            states = path.interpolate(validator.resolution)
            pts = robot.transformed_clouds_for(to_device(states, torch.float32, dev)).points
            meanings = (SV_START + torch.arange(len(states), device=dev) % 249).repeat_interleave(pts.shape[1])
            gvl.clear_map("mySolutionMap")
            rnd["solution"] = gvl.update_map("mySolutionMap",
                                             lambda m: m.insert_point_cloud_with_meanings(pts.reshape(-1, 3), meanings))
            rnd["states"] = states
        rounds.append(rnd)
    return {"gvl": gvl, "robot": robot, "checker": checker, "validator": validator, "rounds": rounds,
            "query": gvl.get_map("myQueryMap")}


class MaskedArm:
    """The arm with the FK points of `keep` ([T, P] bool for a batch of T
    states) kept and every other point moved far outside the map."""

    def __init__(self, arm, keep: torch.Tensor):
        self.arm, self.keep = arm, keep

    def transformed_clouds_for(self, cfg):
        c = self.arm.transformed_clouds_for(cfg)
        return replace(c, points=torch.where(self.keep[..., None], c.points, -1e6))


def boundary_safe(robot, states: torch.Tensor) -> torch.Tensor:
    """[T, P] bool: the FK points at least 1e-3 voxel from every cell
    boundary, where FK's ulps between the card and the CPU cannot move them
    into another voxel."""
    f = robot.transformed_clouds_for(states).points.to(torch.float64) / PLAN_SIDE
    return ((f - torch.round(f)).abs() >= 1e-3).all(dim=-1)


def card_and_cpu_counts(checker, cpu_checker, states: np.ndarray, chunk: int) -> tuple:
    """Per state: the card's and the CPU copy's colliding voxels, raw and
    over the boundary-safe points only (the same points on both sides:
    the mask is the card's, copied)."""
    raw, cpu_raw, safe, cpu_safe, near = [], [], [], [], []
    for i in range(0, len(states), chunk):
        s = states[i:i + chunk]
        keep = boundary_safe(checker.robot, to_device(s, torch.float32, checker.device))
        near.append((~keep.all(dim=1)).cpu().numpy())
        raw.append(checker.batch_colliding_voxels(s))
        cpu_raw.append(cpu_checker.batch_colliding_voxels(s))
        for ck, out, mask in ((checker, safe, keep), (cpu_checker, cpu_safe, keep.cpu())):
            masked = GvlValidityChecker(ck.env, MaskedArm(ck.robot, mask), 0.7)
            out.append(masked.batch_colliding_voxels(s))
    return tuple(np.concatenate(v) for v in (raw, cpu_raw, safe, cpu_safe, near))


def check_planning_path(plan: dict, dev: torch.device) -> None:
    """Path 6's answers: a solve, collision-free simplified paths on the card
    and on a CPU copy of the map, a non-empty solution list, and the card's
    per-state counts == the CPU's on 4,096 random states. FK differs by ulps
    between the card and the CPU and every state of the 3,800-point UR10 has
    points within 1e-3 voxel of a cell boundary, so the counts are compared
    raw (differences counted and printed) and over the boundary-safe points
    (asserted equal)."""
    checker = plan["checker"]
    cpu_checker = GvlValidityChecker(cpu_copy(checker.env), PaddedArm(ur_robot("ur10", spacing=PLAN_SIDE,
                                                                               device="cpu")), 0.7)
    assert any(r["path"] is not None for r in plan["rounds"]), "no round of the planner solved"
    with host_reads():
        for n, rnd in enumerate(plan["rounds"]):
            res = rnd["result"]
            log(f"  (q) round {n}: {'solved' if res.solved else 'no solution'} in {res.iterations} iterations, "
                f"{res.motion_checks} motion checks, {res.states_checked} states checked, {res.host_reads} host reads, "
                f"{res.plan_seconds * 1e3:.1f} ms" + (f"; path {len(res.path)} -> {len(rnd['path'])} vertices, "
                                                      f"{len(rnd['states'])} interpolated states" if res.solved else ""))
            if rnd["path"] is None:
                continue
            raw, cpu_raw, safe, cpu_safe, near = card_and_cpu_counts(checker, cpu_checker, rnd["states"], 1024)
            assert int(raw.max()) == 0 and int(cpu_safe.max()) == 0 and int(rnd["solution"].count) > 0
            log(f"  (r) round {n}: all {len(raw)} interpolated states collide in 0 voxels on the card, and over their "
                f"boundary-safe points on the CPU copy ({int(near.sum())} states hold a point < 1e-3 voxel from a "
                f"boundary; raw CPU counts non-zero in {int((cpu_raw > 0).sum())}); solution list "
                f"{int(rnd['solution'].count)} voxels")
        space = plan_space()
        states = np.random.default_rng(PLAN_SEED).uniform(space.lower, space.upper, (PLAN_RANDOM_STATES, 6))
        raw, cpu_raw, safe, cpu_safe, near = card_and_cpu_counts(checker, cpu_checker, states.astype(np.float32), 256)
    assert np.array_equal(safe, cpu_safe), np.flatnonzero(safe != cpu_safe)[:10]
    assert not ((raw != cpu_raw) & ~near).any()
    log(f"  (s) batch_colliding_voxels of {PLAN_RANDOM_STATES} random states: {int((raw > 0).sum())} collide on the "
        f"card; {int(near.sum())} hold an FK point < 1e-3 voxel from a cell boundary, raw card and CPU counts differ "
        f"in {int((raw != cpu_raw).sum())}; over the boundary-safe points card == CPU in every state")


def plan_space() -> JointSpace:
    """[-pi, pi] per joint, joint 2 capped at 0 (gvl_ompl_planner.cpp:58-63)."""
    upper = np.full(6, np.pi, np.float32)
    upper[1] = 0.0
    return JointSpace(np.full(6, -np.pi, np.float32), upper)


def list_timings(dev: torch.device, smi: str, lp: dict, plan: dict) -> None:
    """Phase 4's times of paths 5 and 6 (printed, never asserted)."""
    inputs, lists = lp["inputs"], lp["answers"]["lists"]
    rays, sweep_pts, env = inputs["rays"], inputs["sweep_pts"], inputs["fused"]
    flat, meanings = sweep_pts.reshape(-1, 3), sweep_meanings(sweep_pts)
    sv, obstacles, kinect = lists["sweep"], lists["obstacles"], lists["kinect"]
    frame_ms = time_ms(lambda: bit_vector_voxel_list(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(rays), 10)
    sweep_ms = time_ms(lambda: bit_vector_voxel_list(SV_DIMS, SV_SIDE, device=dev).insert_point_cloud_with_meanings(
        flat, meanings), 10)
    log(f"  Kinect frame ({rays.shape[0]} points) into a bit list with dedup: {frame_ms:.4f} ms; 64-step swept "
        f"list insert ({flat.shape[0]} points, {int(sv.count)} voxels): {sweep_ms:.4f} ms  [{smi}]")
    pair_ms = time_ms(lambda: kinect.collide_with(sv), 20)
    before = collide_cuda.launches["collide_types_bit_bit"]
    check_ms = time_ms(lambda: sv.collide_with_bitcheck(obstacles, 5), 20, warmup=0)
    k4_calls = collide_cuda.launches["collide_types_bit_bit"] - before
    mask, partner = sv.find_matching(obstacles)
    k4_ms, k4_plain = in_turns(
        lambda: collide_cuda.collide_types_bit_bit(sv.payload, partner, 5, False, b_valid=mask),
        lambda: collide_cuda.collide_types_bit_bit_plain(sv.payload, partner, 5, False, b_valid=mask), 20)
    k4_dev = device_ms(lambda: collide_cuda.collide_types_bit_bit(sv.payload, partner, 5, False, b_valid=mask), 20)
    c = sv.capacity
    k4_b = k4_bound(sv.payload, partner, 5, False, b_valid=mask)
    # the single-launch floor: the same kernel on one voxel
    one = sv.payload[:, :1].contiguous(), partner[:, :1].contiguous(), mask[:1].contiguous()
    floor_dev = device_ms(lambda: collide_cuda.collide_types_bit_bit(one[0], one[1], 5, False, b_valid=one[2]), 20)
    dense_ms = time_ms(lambda: kinect.collide_with_dense(env, 0.55), 20)
    log(f"  list x list collide ({kinect.capacity} x {sv.capacity} entries): {pair_ms:.4f} ms; collide_with_bitcheck "
        f"margin 5: {check_ms:.4f} ms ({k4_calls} K4 launches in 20 calls); K4 alone on the list payload (C = {c}, "
        f"{int(mask.sum())} matched, the mask as b_valid): {k4_ms:.4f} ms by events over back-to-back calls, "
        f"{k4_dev:.4f} ms device time, plain torch {k4_plain:.4f} ms, bound {k4_b[0]:.4f} ms ({k4_b[1]}); "
        f"the single-launch floor (K4 on one voxel) {floor_dev:.4f} ms device time; list x dense "
        f"(Kinect list x fused 256^3 map): {dense_ms:.4f} ms  [{smi}]")
    with tempfile.TemporaryDirectory() as tmp, host_reads():
        path = os.path.join(tmp, "sweep.bin")
        t0 = time.perf_counter()
        for _ in range(5):
            sv.write_to_disk(path)
            sv.read_from_disk(path)
        torch.cuda.synchronize()
        disk_ms = (time.perf_counter() - t0) / 5 * 1e3
    log(f"  write_to_disk + read_from_disk of the swept list ({int(sv.count)} entries): {disk_ms:.4f} ms (host clock)  "
        f"[{smi}]")
    checker, validator = plan["checker"], plan["validator"]
    space = plan_space()
    states = to_device(np.random.default_rng(1).uniform(space.lower, space.upper, (256, 6)), torch.float32, dev)
    batch_ms = time_ms(lambda: checker.colliding_voxels_device(states), 10)
    with host_reads():
        motion_ms = time_ms(lambda: validator.check_motion(PLAN_START, PLAN_GOAL), 10)
        reads0 = checker.host_reads
        t0 = time.perf_counter()
        result = RRTConnect(space, validator, step=1.0, seed=PLAN_SEED).solve(PLAN_START, PLAN_GOAL,
                                                                                     max_iters=3000)
        solve_ms = (time.perf_counter() - t0) * 1e3
    log(f"  batch_colliding_voxels of 256 states: {batch_ms:.4f} ms = {256e3 / batch_ms:.0f} states/s; one check_motion "
        f"(start -> goal, {len(validator.segment_states(PLAN_START, PLAN_GOAL))} states): {motion_ms:.4f} ms; one solve: "
        f"{solve_ms:.4f} ms (host clock), {'solved' if result.solved else 'unsolved'} in {result.iterations} "
        f"iterations, {result.motion_checks} motion checks, {checker.host_reads - reads0} host reads  [{smi}]")

# -- path 7 -------------------------------------------------------------------
class PosedSensor:
    """A Kinect whose pose is given as a matrix (the carve poses)."""

    fx, fy, cx, cy = INTR
    invalid_value = 0.0

    def __init__(self, pose: np.ndarray):
        self._pose = np.asarray(pose, np.float32)

    def pose(self) -> np.ndarray:
        return self._pose


class Translated:
    """BASELINE #5's robot: a 400-point cloud translated by its 3-d
    configuration (a [T, 3] batch of states at once)."""

    def __init__(self, cloud: np.ndarray, dev: torch.device):
        self.cloud = MetaPointCloud.from_clouds([cloud], names=("body",), device=dev)

    def transformed_clouds_for(self, cfg):
        cfg = to_device(cfg, torch.float32, self.cloud.points.device)
        return replace(self.cloud, points=self.cloud.points + cfg[..., None, :])


def config5_scene():
    """bench.py:396-424 from a seeded generator: 200,000 uniform obstacles in
    1024^3 at 1.0 m, a 400-point robot, 315 states."""
    rng = np.random.default_rng(C5_SEED)
    d = C5_DIMS[0]
    env = rng.uniform(0, d, (C5_OBSTACLES, 3)).astype(np.float32)
    robot = rng.uniform(-2, 2, (C5_ROBOT_POINTS, 3)).astype(np.float32)
    states = rng.uniform(100.0 * d / 1024, 900.0 * d / 1024, (C5_STATES, 3)).astype(np.float32)
    return env, robot, states


def config5_oracle(env: np.ndarray, robot: np.ndarray, states: np.ndarray) -> np.ndarray:
    """Per state, the distinct robot voxels that hold an obstacle: numpy sets
    of int64 linear keys (at 1.0 m the voxel of a point is its floor; the
    f32 sums are the card's)."""
    d = C5_DIMS[0]

    def keys(c):
        return (c[..., 2] * d + c[..., 1]) * d + c[..., 0]

    obstacles = np.unique(keys(np.floor(env).astype(np.int64)))
    cells = np.floor(robot[None, :, :] + states[:, None, :]).astype(np.int64)
    inside = ((cells >= 0) & (cells < d)).all(axis=-1)
    out = np.zeros(len(states), np.int64)
    for i in range(len(states)):
        k = np.unique(keys(cells[i][inside[i]]))
        out[i] = int(np.isin(k, obstacles, assume_unique=True).sum())
    return out


def same_state(a: dict, b: dict) -> bool:
    for key, value in a.items():
        other = b[key]
        if isinstance(value, np.ndarray):
            if not np.array_equal(value, other):
                return False
        elif isinstance(value, list):
            if len(value) != len(other) or not all(np.array_equal(x, y) for x, y in zip(value, other)):
                return False
        elif value != other:
            return False
    return True


def paged_answers(dev: torch.device, inputs: dict, tmp: str) -> dict:
    """Path 7's paged part, past the dense wall, on `dev`: both tiers at
    4096^3 through the facade, one Kinect frame ray-carved in (max_steps 128),
    the frame's voxels again past coordinate 1,024 (voxel_offset), probes at
    min_level 0, 1, 3 and 6, collides with a morton list past 1,024 and with a
    dense hierarchy, and both file formats written and read back. The
    allocating inserts and the files read the device on purpose."""
    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(*PAGED_DIMS, FUSION_SIDE, device=dev)
    frame, rays, probes = inputs["frame"], inputs["rays"], inputs["probes"]
    morton, hier = inputs["morton"], inputs["hier"]
    out = {}
    for name, mt in (("det", MapType.MT_BITVECTOR_OCTREE), ("prob", MapType.MT_PROBAB_OCTREE)):
        m = gvl.add_map(mt, name)
        assert isinstance(m, PagedHierarchicalMap), type(m)
        with host_reads():
            m.insert_depth_image(frame, kinect_sensor(), max_steps=128)
            m.insert_point_cloud(rays, voxel_offset=(-MORTON_SHIFT,) * 3)
            tree_ok = m.check_tree()
        ans = {"tree_ok": tree_ok,
               "probe": [m.probe_status(probes, lvl) for lvl in PAGED_LEVELS],
               "morton": [m.collide_with(morton), m.collide_with(morton, offset=(-MORTON_SHIFT,) * 3),
                          morton.collide_with(m, offset=(-MORTON_SHIFT,) * 3)],
               "hier": m.collide_with(hier),
               "unknown": m.collide_with_counting_unknown(morton, min_level=3)}
        if m.probabilistic:
            ans["occupancy"] = m.probe_occupancy(probes)
        with host_reads():
            ans["state"] = interop.to_numpy(m)  # the whole state
            ans["occupied"] = m.extract_occupied_coords()
            files = {}
            for fmt in ("binary", "ascii"):
                path = os.path.join(tmp, f"{name}.{fmt}.{dev.type}")
                if fmt == "binary":
                    assert m.write_to_disk(path)
                else:
                    io.write_paged_map(m, path, ascii=True)
                with open(path, "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
                back = m.read_from_disk(path)
                n = m.n_tiles()
                same = (back.n_tiles() == n and torch.equal(back.pool[:n], m.pool[:n])
                        and torch.equal(back.slot_block[:n], m.slot_block[:n])
                        and torch.equal(back.probe_status(probes), m.probe_status(probes)))
                files[fmt] = (digest, same, back.device == m.device)
                os.remove(path)
            ans["files"] = files
        out[name] = ans
    GpuVoxels._instance = None
    return out


def paged_inputs(dev: torch.device, frame: np.ndarray) -> dict:
    """The paged part's inputs: the frame's rays, a morton list at 4096^3 of
    its voxels moved past coordinate 1,024, a dense hierarchy of the frame
    (K3), probe coordinates near and past the frame."""
    sensor = kinect_sensor()
    rays = sensor.process_depth_image(frame, device=dev)
    kinect = bit_vector_voxel_list(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(rays)
    with host_reads():
        fit = kinect.shrink_to_fit()  # reads the count
    morton = bit_vector_morton_voxel_list(PAGED_DIMS, FUSION_SIDE, device=dev).insert_coordinates(
        fit.entry_coords() + MORTON_SHIFT, BitVoxelMeaning.eBVM_OCCUPIED)
    hier = HierarchicalBitMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).insert_depth_image(frame, sensor)
    rng = np.random.default_rng(5)
    probes = np.concatenate([rng.integers(0, 260, (20000, 3)), rng.integers(1000, 1300, (5000, 3)),
                             rng.integers(0, PAGED_DIMS[0], (5000, 3))]).astype(np.int32)
    return {"frame": frame, "rays": rays, "morton": morton, "hier": hier, "probes": to_device(probes, torch.int32, dev)}


def fused_pair(frame, pose, pool: int, dev: torch.device):
    """One frame under one pose into both dense tiers at 512^3 and into a
    dense ProbVoxelMap on the same grid (K3 at pool 1, K6 past it)."""
    sensor = PosedSensor(pose)
    prob = HierarchicalProbMap.create(HIER_DIMS, HIER_SIDE, device=dev).insert_depth_image(frame, sensor, pool)
    bit = HierarchicalBitMap.create(HIER_DIMS, HIER_SIDE, device=dev).insert_depth_image(frame, sensor, pool)
    dense = ProbVoxelMap.create(HIER_DIMS, HIER_SIDE, device=dev).insert_depth_image(frame, sensor, pool)
    return prob, bit, dense


def fusion_answers(dev: torch.device, frame: np.ndarray) -> dict:
    """(c) and (d): both dense tiers fused at 512^3 under three poses at
    carve_pool 1 (K3) and 8 (K6), check_tree after every insert; the octree
    collides: octree x dense map, octree x octree, list x octree."""
    out = {"fused": {}, "tree_ok": []}
    for pool in (1, POOL):
        for label, pose in carve_poses().items():
            prob, bit, dense = fused_pair(frame, pose, pool, dev)
            with host_reads():
                out["tree_ok"].append(prob.check_tree() and bit.check_tree())
            out["fused"][(pool, label)] = (prob, bit, dense)
    prob, bit, dense = out["fused"][(1, "bench")]
    out["collide"] = [prob.collide_with(bit), bit.collide_with(prob, min_level=3), bit.collide_with(dense),
                      prob.collide_with_counting_unknown(dense, min_level=2)]
    return out


def octree_path(dev: torch.device) -> dict:
    """Path 7: BASELINE config #5 on the dense pyramid through the facade and
    on the paged tier, the paged tiers past the dense wall, depth fusion into
    both dense tiers (K3, K6) and the octree collides."""
    out = {}
    env, robot, states = config5_scene()
    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(*C5_DIMS, 1.0, device=dev)
    dense = gvl.add_map(MapType.MT_BITVECTOR_OCTREE, "env")
    assert isinstance(dense, HierarchicalBitMap), type(dense)
    gvl.insert_point_cloud_into_map(env, "env")
    dense = gvl.get_map("env")
    arm = Translated(robot, dev)
    with host_reads():  # the checker reads its counts; the paged build allocates
        out["c5_dense"] = HierarchicalValidityChecker(dense, arm).batch_colliding_voxels(states)
        paged = PagedHierarchicalMap(C5_DIMS, 1.0, device=dev).insert_point_cloud(env)
        paged_checker = HierarchicalValidityChecker(paged, arm)
        out["c5_paged"] = paged_checker.batch_colliding_voxels(states)
        out["c5_tree_ok"] = dense.check_tree() and paged.check_tree()
    out["c5"] = {"dense": dense, "paged": paged, "arm": arm, "states": states, "env": env, "robot": robot,
                 "checker_reads": paged_checker.host_reads}
    GpuVoxels._instance = None
    frame = bench_frame()
    out["paged_inputs"] = paged_inputs(dev, frame)
    with tempfile.TemporaryDirectory() as tmp:
        out["paged"] = paged_answers(dev, out["paged_inputs"], tmp)
    out["fusion"] = fusion_answers(dev, frame)
    kinect = bit_vector_voxel_list(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(
        out["paged_inputs"]["rays"])
    hier = out["paged_inputs"]["hier"]
    out["list_octree"] = [kinect.collide_with(hier, offset=(1, 0, -1)), hier.collide_with(kinect, offset=(1, 0, -1)),
                          kinect.collide_with(hier)]
    return out


def check_octree_path(oc: dict, dev: torch.device) -> None:
    """Path 7's answers: config #5 against the set oracle and dense == paged;
    the paged part against the same calls on CPU copies of its inputs, files
    byte-equal; the fusions against the dense map and the plain route."""
    c5 = oc["c5"]
    oracle = config5_oracle(c5["env"], c5["robot"], c5["states"])
    dense_counts, paged_counts = oc["c5_dense"], oc["c5_paged"]
    assert np.array_equal(dense_counts, oracle), np.flatnonzero(dense_counts != oracle)[:10]
    assert np.array_equal(paged_counts, dense_counts) and oc["c5_tree_ok"]
    assert int((oracle > 0).sum()) > 0
    log(f"  (t) BASELINE #5: {len(oracle)} states x {C5_ROBOT_POINTS} points against {C5_OBSTACLES} obstacles at "
        f"{C5_DIMS[0]}^3: {int((oracle > 0).sum())} states collide, {int(oracle.sum())} voxel hits; dense pyramid "
        f"== paged tier == the numpy set oracle; memory_usage dense {c5['dense'].memory_usage()} B, paged "
        f"{c5['paged'].memory_usage()} B ({c5['paged'].n_tiles()} tiles)")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cpu = paged_answers(torch.device("cpu"), cpu_copy(oc["paged_inputs"]), tmp)
    card = oc["paged"]
    for name in ("det", "prob"):
        a, b = card[name], cpu[name]
        assert a["tree_ok"] and b["tree_ok"], name
        assert same_state(a["state"], b["state"]) and np.array_equal(a["occupied"], b["occupied"]), name
        for key in ("probe", "morton", "hier", "unknown") + (("occupancy",) if name == "prob" else ()):
            assert same_answer(a[key], b[key]), (name, key)
        for fmt in ("binary", "ascii"):
            (d1, s1, o1), (d2, s2, o2) = a["files"][fmt], b["files"][fmt]
            assert d1 == d2 and s1 and s2 and o1 and o2, (name, fmt)
    morton = oc["paged_inputs"]["morton"]
    n_frame = int(morton.count)
    det = card["det"]
    # the oracle: the list's voxels (shifted back) in the occupied set the map extracts
    occupied = {tuple(c) for c in det["occupied"].tolist()}
    listed = morton.coords_from_ids(morton.keys[:n_frame]).cpu().numpy().astype(np.int64)
    want = [sum(tuple(c) in occupied for c in (listed + shift).tolist()) for shift in (0, -MORTON_SHIFT)]
    got = [int(c) for c in det["morton"]]
    assert got == [want[0], want[1], want[1]] and want[0] > 0, (got, want)
    assert int(det["hier"]) > 0
    log(f"  (u) paged tiers at {PAGED_DIMS[0]}^3 through the facade: a Kinect frame ray-carved (max_steps 128) and "
        f"its voxels again past 1,024: {card['det']['state']['n_slots']} / {card['prob']['state']['n_slots']} tiles "
        f"(det / prob); morton list ({n_frame} entries) collides {got} == the occupied-set oracle; x the dense "
        f"hierarchy {int(det['hier'])}; probes at min_level {PAGED_LEVELS}, files (binary, ascii) and the whole "
        f"state == the same calls on CPU copies ({time.perf_counter() - t0:.1f} s on the host)")

    fusion = oc["fusion"]
    assert all(fusion["tree_ok"])
    for (pool, label), (prob, bit, dense) in fusion["fused"].items():
        assert torch.equal(prob.occupancy.reshape(-1), dense.data), (pool, label)
        status = _status_from_occupancy(dense.data).reshape(prob.pyramid[0].shape)
        assert torch.equal(prob.pyramid[0], status), (pool, label)
    with plain_route():
        plain = fusion_answers(dev, oc["paged_inputs"]["frame"])
    for key, (prob, bit, _) in fusion["fused"].items():
        p_prob, p_bit, _ = plain["fused"][key]
        for a, b in zip(prob.pyramid + bit.pyramid, p_prob.pyramid + p_bit.pyramid, strict=True):
            assert torch.equal(a, b), key
        assert torch.equal(prob.occupancy, p_prob.occupancy), key
    counts = [tuple(int(v) for v in c) if isinstance(c, tuple) else int(c) for c in fusion["collide"]]
    p_counts = [tuple(int(v) for v in c) if isinstance(c, tuple) else int(c) for c in plain["collide"]]
    assert counts == p_counts and counts[0] > 0, (counts, p_counts)
    lo = [int(c) for c in oc["list_octree"]]
    assert lo[0] == lo[1] and lo[2] > 0, lo
    free = int(decode_status_flags(fusion["fused"][(POOL, "bench")][1].pyramid[0])[2].sum())
    log(f"  (v) {HIER_DIMS[0]}^3 fusion into both dense tiers under {len(carve_poses())} poses at carve_pool 1 (K3) "
        f"and {POOL} (K6): the prob tier == the dense ProbVoxelMap's occupancy and its status, both tiers == plain "
        f"route, check_tree after every insert; pooled bit tier {free} free voxels")
    log(f"  (w) octree collides: prob x bit {counts[0]}, at level 3 {counts[1]}, bit x dense map {counts[2]}, "
        f"counting unknown {counts[3]} (== plain route); list x octree with an offset {lo[0]} == octree x list, "
        f"without {lo[2]}")


def octree_timings(dev: torch.device, smi: str, oc: dict) -> None:
    """Phase 4's times of path 7 (printed, never asserted)."""
    c5 = oc["c5"]
    states = to_device(c5["states"], torch.float32, dev)
    for name in ("dense", "paged"):
        checker = HierarchicalValidityChecker(c5[name], c5["arm"])
        ms = time_ms(lambda: checker.colliding_voxels_device(states), 20)
        with host_reads():
            read_ms = time_ms(lambda: checker.batch_colliding_voxels(states), 20)
        log(f"  BASELINE #5 batch ({len(states)} states x {C5_ROBOT_POINTS} points, {name} tier at {C5_DIMS[0]}^3): "
            f"{ms:.4f} ms on the device = {len(states) * 1e3 / ms:.0f} states/s; with the host read {read_ms:.4f} ms "
            f"= {len(states) * 1e3 / read_ms:.0f} states/s  [{smi}]")
    env = to_device(c5["env"], torch.float32, dev)
    fresh = HierarchicalBitMap.create(C5_DIMS, 1.0, device=dev)
    build_ms = time_ms(lambda: fresh.insert_point_cloud(env), 5, warmup=1)
    with host_reads():
        paged_ms = time_ms(lambda: PagedHierarchicalMap(C5_DIMS, 1.0, device=dev).insert_point_cloud(env), 3, warmup=1)
    log(f"  {C5_DIMS[0]}^3 build from {C5_OBSTACLES} points: dense pyramid {build_ms:.4f} ms, paged tier "
        f"{paged_ms:.4f} ms (host allocation included)  [{smi}]")
    frame = torch.as_tensor(bench_frame(), device=dev)
    sensor = PosedSensor(carve_poses()["bench"])
    for cls in (HierarchicalBitMap, HierarchicalProbMap):
        m = cls.create(HIER_DIMS, HIER_SIDE, device=dev)
        for pool in (1, POOL):
            ms = time_ms(lambda: m.insert_depth_image(frame, sensor, pool), 10)
            log(f"  {HIER_DIMS[0]}^3 fusion frame into a {cls.__name__} (carve_pool {pool}): {ms:.4f} ms  [{smi}]")
    dense_ms = time_ms(lambda: ProbVoxelMap.create(HIER_DIMS, HIER_SIDE, device=dev).insert_depth_image(frame, sensor),
                       10)
    log(f"  the same frame into a dense {HIER_DIMS[0]}^3 ProbVoxelMap (carve_pool 1): {dense_ms:.4f} ms  [{smi}]")
    kinect = kinect_sensor()
    with host_reads():
        for prob in (False, True):
            steady = PagedHierarchicalMap(PAGED_DIMS, FUSION_SIDE, probabilistic=prob, device=dev)
            steady.insert_depth_image(frame, kinect)
            steady_ms = time_ms(lambda: steady.insert_depth_image(frame, kinect), 5, warmup=1)
            alloc_ms = time_ms(lambda: PagedHierarchicalMap(PAGED_DIMS, FUSION_SIDE, probabilistic=prob, device=dev)
                               .insert_depth_image(frame, kinect), 5, warmup=1)
            log(f"  {PAGED_DIMS[0]}^3 paged Kinect frame ({'prob' if prob else 'det'}, {frame.numel()} rays x 128 steps): "
                f"steady state {steady_ms:.4f} ms, allocating {alloc_ms:.4f} ms ({steady.n_tiles()} tiles)  [{smi}]")


# -- path 8 -------------------------------------------------------------------
def matrix_scene() -> tuple[np.ndarray, np.ndarray]:
    """tests/test_collision_matrix.py's scene at MATRIX_DIMS: two uniform
    clouds of MATRIX_POINTS points that share a slab of MATRIX_SHARED."""
    rng = np.random.default_rng(MATRIX_SEED)
    hi = MATRIX_DIMS[0] - 2.0
    a = rng.uniform(2.0, hi, (MATRIX_POINTS, 3)).astype(np.float32)
    b = rng.uniform(2.0, hi, (MATRIX_POINTS, 3)).astype(np.float32)
    b[:MATRIX_SHARED] = a[:MATRIX_SHARED]
    return a, b


def matrix_oracle(a: np.ndarray, b: np.ndarray) -> int:
    """|occupied(A) n occupied(B)| on floor-voxelized coordinates (numpy)."""
    dx, dy, _ = MATRIX_DIMS

    def cells(p):
        v = np.floor(p).astype(np.int64)
        return np.unique((v[:, 2] * dy + v[:, 1]) * dx + v[:, 0])

    return int(np.intersect1d(cells(a), cells(b), assume_unique=True).size)


def matrix_supported(a: str, b: str) -> bool:
    """Dense maps collide with dense maps only (BitVoxelMap.h:37-38,
    ProbVoxelMap.h:36-37); lists and octrees with every tier."""
    return b in MATRIX_DENSE if a in MATRIX_DENSE else True


def count_of(r) -> torch.Tensor:
    return r[0] if isinstance(r, tuple) else r


def digest(path) -> str:
    with open(path, "rb") as f:
        return hashlib.file_digest(f, "sha256").hexdigest()


@contextlib.contextmanager
def counted_reads():
    """Count the device -> host reads made inside the block (tensor.cpu()
    and int() of a tensor; on the card every one reads the device) and
    their bytes."""
    tally = {"reads": 0, "bytes": 0}
    cpu, to_int = torch.Tensor.cpu, torch.Tensor.__int__

    def counting_cpu(self, *args, **kwargs):
        tally["reads"] += 1
        tally["bytes"] += self.numel() * self.element_size()
        return cpu(self, *args, **kwargs)

    def counting_int(self):
        tally["reads"] += 1
        tally["bytes"] += self.element_size()
        return to_int(self)

    torch.Tensor.cpu, torch.Tensor.__int__ = counting_cpu, counting_int
    try:
        yield tally
    finally:
        torch.Tensor.cpu, torch.Tensor.__int__ = cpu, to_int


def facade_matrix(dev: torch.device) -> dict:
    """(x) the 8x8 type x type collision matrix through the facade at
    MATRIX_DIMS: every supported ordered pair's count (device tensors), the
    TypeError of every unsupported pair, and one pair of bit maps without
    their summaries (K7)."""
    a, b = matrix_scene()
    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(*MATRIX_DIMS, 1.0, device=dev)
    pts_a, pts_b = to_device(a, torch.float32, dev), to_device(b, torch.float32, dev)
    for name, mt in MATRIX_TYPES:
        for side, pts in (("A_", pts_a), ("B_", pts_b)):
            gvl.add_map(mt, side + name)
            gvl.insert_point_cloud_into_map(pts, side + name)
    counts, refused = {}, []
    for an, _ in MATRIX_TYPES:
        for bn, _ in MATRIX_TYPES:
            x, y = gvl.get_map("A_" + an), gvl.get_map("B_" + bn)
            if matrix_supported(an, bn):
                counts[(an, bn)] = count_of(x.collide_with(y))
                continue
            try:
                x.collide_with(y)
            except TypeError:
                refused.append((an, bn))
            else:
                raise AssertionError(f"{an} x {bn} must raise TypeError")
    raw = (raw_planes(gvl.get_map("A_bit")), raw_planes(gvl.get_map("B_bit")))
    counts[("bit_raw", "bit_raw")] = raw[0].collide_with(raw[1])
    return {"gvl": gvl, "counts": counts, "refused": refused, "raw": raw, "a": a, "b": b, "pts_a": pts_a}


def facade_files(dev: torch.device, gvl: GpuVoxels, pts: torch.Tensor, rays: torch.Tensor, tmp: str) -> dict:
    """(y) save_map -> load_map through the facade for every map type it
    makes at MATRIX_DIMS (the matrix's A maps and a distance map) and, through
    a second facade at PAGED_DIMS, both paged octrees holding a Kinect
    frame's endpoints: each file's digest, the loaded map re-saved."""
    gvl.add_map(MapType.MT_DISTANCE_VOXELMAP, "A_dist")
    gvl.insert_point_cloud_into_map(pts, "A_dist")
    names = [("A_" + n, mt) for n, mt in MATRIX_TYPES] + [("A_dist", MapType.MT_DISTANCE_VOXELMAP)]
    paged = GpuVoxels()
    paged.initialize(*PAGED_DIMS, FUSION_SIDE, device=dev)
    out = {"maps": {}, "digests": {}, "reloaded": {}}
    with host_reads():  # the files read the device; the paged inserts allocate
        for prob, mt in ((False, MapType.MT_BITVECTOR_OCTREE), (True, MapType.MT_PROBAB_OCTREE)):
            name = f"paged_{'prob' if prob else 'det'}"
            paged.add_map(mt, name)
            paged.insert_point_cloud_into_map(rays, name)
            assert isinstance(paged.get_map(name), PagedHierarchicalMap)
            names.append((name, mt))
        for name, mt in names:
            g = paged if name.startswith("paged") else gvl
            path = os.path.join(tmp, f"{name}.bin")
            g.save_map(name, path)
            g.load_map(name + "_loaded", path)
            g.save_map(name + "_loaded", path + ".again")
            out["maps"][name] = g.get_map(name)
            out["digests"][name] = digest(path)
            out["reloaded"][name] = (digest(path + ".again"), g.get_map(name + "_loaded"))
            os.remove(path)
            os.remove(path + ".again")
    out["paged"] = paged
    return out


def urdf_answers(dev: torch.device) -> dict:
    """(z) add_robot of the pan/tilt URDF, swept through URDF_CONFIGS into a
    bit map (one swept-volume meaning a configuration), collided with a box
    inserted by insert_box_into_map; the FK points of every configuration."""
    gvl = GpuVoxels()
    gvl.initialize(*URDF_DIMS, URDF_SIDE, device=dev)
    gvl.add_robot("pan_tilt", URDF_FILE)
    gvl.add_map(MapType.MT_BITVECTOR_VOXELMAP, "sweep")
    gvl.add_map(MapType.MT_BITVECTOR_VOXELMAP, "box")
    gvl.insert_box_into_map(*URDF_BOX, "box", BitVoxelMeaning.eBVM_OCCUPIED, 2)
    fk = []
    for k, cfg in enumerate(URDF_CONFIGS):
        gvl.set_robot_configuration("pan_tilt", dict(zip(("pan_joint", "tilt_joint"), cfg)))
        gvl.insert_robot_into_map("pan_tilt", "sweep", SV_START + k)
        fk.append(gvl.get_robot("pan_tilt").get_transformed_clouds().points)
    sweep, box = gvl.get_map("sweep"), gvl.get_map("box")
    return {"sweep": sweep, "box": box, "fk": fk, "count": sweep.collide_with(box),
            "points": gvl.get_robot("pan_tilt").clouds.accumulated_size}


def file_answers(dev: torch.device, rays: torch.Tensor, tmp: str) -> dict:
    """(aa) insert_point_cloud_from_file of a Kinect frame's 307,200
    endpoints as an .xyz and a binary .pcd file, beside direct inserts of
    the points the files hold."""
    with host_reads():
        pts = rays.cpu().numpy()
    xyz, pcd = os.path.join(tmp, "frame.xyz"), os.path.join(tmp, "frame.pcd")
    files.write_xyz(xyz, pts)
    with open(pcd, "wb") as f:
        f.write((f"FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\nWIDTH {len(pts)}\nHEIGHT 1\n"
                 f"POINTS {len(pts)}\nDATA binary\n").encode() + pts.astype("<f4").tobytes())
    gvl = GpuVoxels()
    gvl.initialize(*FUSION_DIMS, FUSION_SIDE, device=dev)
    out = {"points": len(pts)}
    for name, path in (("xyz", xyz), ("pcd", pcd)):
        gvl.add_map(MapType.MT_PROBAB_VOXELMAP, name)
        gvl.insert_point_cloud_from_file(name, path)
        direct = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(files.load_point_cloud(path))
        out[name] = (gvl.get_map(name), direct)
    out["pcd_exact"] = np.array_equal(files.load_point_cloud(pcd), pts)
    return out


def live_vis(dev: torch.device, frames) -> dict:
    """(bb) Provider(live_vis=True) fed the 5 Kinect frames at carve_pool 1
    (K3) and POOL (K6), publishing every frame through its worker thread."""
    sensor = kinect_sensor()
    out = {}
    with host_reads():  # the publisher's worker reads the device while the frames go on
        for pool in (1, POOL):
            prov = Provider(f"live_pool{pool}", carve_pool=pool, live_vis=True)
            prov.init(ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev))
            for frame in frames:
                prov.new_sensor_data(frame, sensor)
                assert prov.visualize()
            painted = prov.finish_visualization()
            prov._vis_async.stop()
            out[pool] = (prov.map, painted)
    return out


def publish(name: str, m, out_dir) -> dict:
    """One VisProvider publish, its host reads counted; the layer's bytes."""
    return counted_publish(lambda: VisProvider(name, out_dir).visualize(m), Path(out_dir) / f"{name}.cubes.json")


def counted_publish(paint, layer: Path) -> dict:
    with host_reads(), counted_reads() as tally:
        t0 = time.perf_counter()
        assert paint()
        tally["ms"] = (time.perf_counter() - t0) * 1e3
    tally["layer"] = layer.read_bytes()
    return tally


def facade_path(dev: torch.device, frames) -> dict:
    """Path 8: the facade's IO and visualization at production sizes (ROADMAP
    item 12) and the 8x8 collision matrix at MATRIX_DIMS (K1, K3, K6, K7)."""
    tmp = tempfile.mkdtemp()
    card_dir = Path(tmp) / "card"
    os.environ["GPU_VOXELS_VIS_DIR"] = str(card_dir)  # every publisher made from here on writes there
    out = {"tmp": tmp, "matrix": facade_matrix(dev)}
    rays = kinect_sensor().process_depth_image(frames[0], device=dev)
    out["rays"] = rays
    out["files"] = facade_files(dev, out["matrix"]["gvl"], out["matrix"]["pts_a"], rays, tmp)
    out["urdf"] = urdf_answers(dev)
    out["from_file"] = file_answers(dev, rays, tmp)
    out["live"] = live_vis(dev, frames)
    # visualize_map of three maps through facades: the fused 256^3 map, a
    # 512^3 HierarchicalBitMap fused from a frame (K3) and the 4096^3 paged map
    fused = GpuVoxels()
    fused.initialize(*FUSION_DIMS, FUSION_SIDE, device=dev)
    fused.add_map(MapType.MT_PROBAB_VOXELMAP, "fused")
    fused.set_map("fused", out["live"][1][0])
    hier = GpuVoxels()
    hier.initialize(*HIER_DIMS, HIER_SIDE, device=dev)
    hier.add_map(MapType.MT_BITVECTOR_OCTREE, "hier512")
    hier.update_map("hier512", lambda m: m.insert_depth_image(bench_frame(), PosedSensor(carve_poses()["bench"])))
    views = {"fused": fused, "hier512": hier, "paged_det": out["files"]["paged"]}
    out["vis_maps"] = {name: g.get_map(name) for name, g in views.items()}
    out["published"] = {name: counted_publish(lambda: g.visualize_map(name), card_dir / f"{name}.cubes.json")
                        for name, g in views.items()}
    del os.environ["GPU_VOXELS_VIS_DIR"]
    fused = out["vis_maps"]["fused"]
    with host_reads(), counted_reads() as compaction:
        compaction["idx"] = compacted_nonzero(fused.occupied_mask(0.5))
    with host_reads(), counted_reads() as dump:
        dump["text"] = fused.print_voxel_map_data(max_entries=4)
    out["reads"] = {"compaction": compaction, "dump": dump}
    return out


def check_facade_path(fp: dict, dev: torch.device) -> None:
    """Path 8's answers: the matrix against the set oracle, the files
    against CPU copies' files, the URDF scene and the file inserts against
    the same calls on the CPU, the live publishers' maps against the plain
    route and their layers, and the three publishes, against CPU copies'."""
    m = fp["matrix"]
    want = matrix_oracle(m["a"], m["b"])
    got = {pair: int(c) for pair, c in m["counts"].items()}
    bad = {pair: c for pair, c in got.items() if c != want}
    assert not bad and want > 0, (want, bad)
    assert sorted(m["refused"]) == sorted((a, b) for a, _ in MATRIX_TYPES for b, _ in MATRIX_TYPES
                                          if not matrix_supported(a, b))
    log(f"  (x) 8x8 collision matrix at {MATRIX_DIMS[0]}^3, {MATRIX_POINTS} points a map ({MATRIX_SHARED} shared): "
        f"{len(got) - 1} supported pairs and the summary-less bit pair count {want} == the numpy set oracle, "
        f"{len(m['refused'])} unsupported pairs raise TypeError")
    log("  per pair: " + ", ".join(f"{a}x{b} {c}" for (a, b), c in sorted(got.items())))

    fl = fp["files"]
    with host_reads():
        for name, cur in fl["maps"].items():
            path = os.path.join(fp["tmp"], f"{name}.cpu.bin")
            io.write_map(cpu_copy(cur), path)
            cpu_digest = digest(path)
            os.remove(path)
            again, loaded = fl["reloaded"][name]
            assert fl["digests"][name] == cpu_digest == again, name
            assert type(loaded) is type(cur) and loaded.device.type == dev.type, name
            if isinstance(cur, (ProbVoxelMap, BitVectorVoxelMap, DistanceVoxelMap)):
                assert torch.equal(loaded.data, cur.data), name
    log(f"  (y) save_map -> load_map through the facade of {len(fl['maps'])} maps (prob, bit, distance, five lists, "
        f"both octrees at {MATRIX_DIMS[0]}^3, both paged octrees at {PAGED_DIMS[0]}^3 with "
        f"{fl['maps']['paged_det'].n_tiles()} tiles): every file == io.write_map of a CPU copy (sha256), every loaded "
        f"map re-saved == the file")

    u = fp["urdf"]
    for pts in u["fk"]:
        v = pts.cpu().numpy() / URDF_SIDE
        assert float(np.abs(v - np.round(v)).min()) >= 1e-3  # F4: FK ulps cannot cross a cell boundary
    cpu = urdf_answers(torch.device("cpu"))
    assert u["points"] == cpu["points"] == URDF_POINTS
    assert torch.equal(u["sweep"].data.cpu(), cpu["sweep"].data) and torch.equal(u["box"].data.cpu(), cpu["box"].data)
    assert int(u["count"]) == int(cpu["count"]) > 0
    log(f"  (z) add_robot(pan_tilt.urdf): {u['points']} mesh points swept through {len(URDF_CONFIGS)} configurations "
        f"at {URDF_DIMS[0]}^3 ({URDF_SIDE} m), every FK point >= 1e-3 voxel from a cell boundary; x the box: "
        f"{int(u['count'])} voxels; sweep, box and count == the same calls on the CPU")

    ff = fp["from_file"]
    for name in ("xyz", "pcd"):
        card, direct = ff[name]
        assert torch.equal(card.data, direct.data) and int((card.data > 0).sum()) > 0, name
    assert ff["pcd_exact"]
    log(f"  (aa) insert_point_cloud_from_file of {ff['points']} points (.xyz and binary .pcd) == direct inserts of the "
        f"files' points (the .pcd holds the frame's points exactly)")

    with plain_route():
        sensor = kinect_sensor()
        for pool, (card, painted) in fp["live"].items():
            plain = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev)
            for frame in fp["frames"]:
                plain = plain.insert_depth_image(frame, sensor, carve_pool=pool)
            assert torch.equal(card.data, plain.data) and painted >= 1, pool
    with host_reads():
        for pool, (card, _) in fp["live"].items():
            name = f"live_pool{pool}"
            cpu_layer = publish(name, cpu_copy(card), Path(fp["tmp"]) / "cpu")["layer"]
            assert (Path(fp["tmp"]) / "card" / f"{name}.cubes.json").read_bytes() == cpu_layer, name
    log(f"  (bb) Provider(live_vis=True) over {len(fp['frames'])} frames at carve_pool 1 (K3) and {POOL} (K6): maps == "
        f"plain route, {[p for _, p in fp['live'].values()]} snapshots painted, last layer == a CPU copy's publish")

    for name, m in fp["vis_maps"].items():
        card = fp["published"][name]
        with host_reads():
            want = publish(name, cpu_copy(m), Path(fp["tmp"]) / "cpu")["layer"]
        assert card["layer"] == want, name
        cubes = len(json.loads(want)["centers"])
        n_voxels = math.prod(m.dims)
        # O(extracted): a few bytes per published cube (compacted indices,
        # gathered statuses, the tiles of open blocks), never O(voxels)
        assert card["bytes"] <= 64 * cubes + 4096, (name, card["bytes"], cubes)
        log(f"  (cc) visualize {name} ({type(m).__name__} {m.dims[0]}^3): layer == a CPU copy's publish "
            f"({cubes} cubes, {len(card['layer'])} bytes); {card['reads']} host reads, {card['bytes']} bytes read "
            f"back = {card['bytes'] / max(cubes, 1):.2f} bytes a cube, {card['bytes'] / n_voxels:.6f} bytes a voxel; "
            f"{card['ms']:.1f} ms on the host")
    reads = fp["reads"]
    fused = cpu_copy(fp["vis_maps"]["fused"])
    assert np.array_equal(reads["compaction"]["idx"], np.flatnonzero(fused.occupied_mask(0.5).numpy()))
    assert reads["dump"]["text"] == fused.print_voxel_map_data(max_entries=4)
    assert reads["compaction"]["reads"] == 2 and reads["dump"]["reads"] == 1, reads
    log(f"  (dd) host reads: compacted_nonzero {reads['compaction']['reads']} ({reads['compaction']['bytes']} bytes), "
        f"print_voxel_map_data {reads['dump']['reads']} ({reads['dump']['bytes']} bytes); both == the CPU copy's")
    shutil.rmtree(fp["tmp"])


def facade_timings(dev: torch.device, smi: str, fp: dict) -> None:
    """Phase 4's times of path 8 (printed, never asserted): the matrix's
    pairs (CUDA events), extract_cubes, one publish per tier, save_map /
    load_map per tier and a URDF add_robot + insert + collide (host clock)."""
    gvl = fp["matrix"]["gvl"]
    pair_ms = {}
    for an, _ in MATRIX_TYPES:
        for bn, _ in MATRIX_TYPES:
            if matrix_supported(an, bn):
                x, y = gvl.get_map("A_" + an), gvl.get_map("B_" + bn)
                pair_ms[(an, bn)] = time_ms(lambda: x.collide_with(y), 3, warmup=1)
    raw = fp["matrix"]["raw"]
    pair_ms[("bit_raw", "bit_raw")] = time_ms(lambda: raw[0].collide_with(raw[1]), 3, warmup=1)
    slowest = max(pair_ms, key=pair_ms.get)
    log(f"  8x8 matrix at {MATRIX_DIMS[0]}^3: {len(pair_ms)} pairs in {sum(pair_ms.values()):.4f} ms, the slowest "
        f"{slowest[0]} x {slowest[1]} {pair_ms[slowest]:.4f} ms  [{smi}]")
    log("  per pair (ms): " + ", ".join(f"{a}x{b} {ms:.3f}" for (a, b), ms in sorted(pair_ms.items())))
    big = BitVectorVoxelMap.create(CYCLE_DIMS, 1.0, device=dev)
    pts = to_device(generation.create_equidistant_points_in_box(307200, (511, 511, 511), 1.0), torch.float32, dev)
    for k in range(4):
        big = big.insert_point_cloud(pts[k::4], SV_START + 40 * k)
    with host_reads():
        for name, m in (("the fused 256^3 prob map", fp["vis_maps"]["fused"]), ("a 512^3 bit map", big)):
            t0 = time.perf_counter()
            n = len(vis_extract.extract_cubes(m)[0])
            log(f"  extract_cubes of {name}: {(time.perf_counter() - t0) * 1e3:.4f} ms (host clock), {n} cubes  [{smi}]")
        for name, m in fp["vis_maps"].items():
            tally = publish(name, m, Path(tempfile.gettempdir()) / "gv_path8_times")
            log(f"  one visualize_map publish of {name}: {tally['ms']:.4f} ms (host clock)  [{smi}]")
        shutil.rmtree(Path(tempfile.gettempdir()) / "gv_path8_times")
        with tempfile.TemporaryDirectory() as tmp:
            for name, cur in fp["files"]["maps"].items():
                g = fp["files"]["paged"] if name.startswith("paged") else gvl
                path = os.path.join(tmp, "m.bin")
                t0 = time.perf_counter()
                g.save_map(name, path)
                t1 = time.perf_counter()
                g.load_map(name + "_timed", path)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                log(f"  {name} ({type(cur).__name__}, {os.path.getsize(path)} bytes): save_map {(t1 - t0) * 1e3:.4f} ms, "
                    f"load_map {(t2 - t1) * 1e3:.4f} ms (host clock)  [{smi}]")
                g.del_map(name + "_timed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ans = urdf_answers(dev)
        int(ans["count"])
        log(f"  URDF add_robot + {len(URDF_CONFIGS)} inserts + box + collide at {URDF_DIMS[0]}^3: "
            f"{(time.perf_counter() - t0) * 1e3:.4f} ms (host clock)  [{smi}]")


# -- path 9 -------------------------------------------------------------------
MD_SLABS = 8  # path 9's z mesh; the cycle's is world 2 x z 4
MD_WORLD_SLABS = 4  # the 4096^3 ShardedPagedWorld's slabs (1024 voxels deep)
# its camera sits 1,000 voxels (20 m) up, looking +z: the hits land 1.8-4 m
# (90-200 voxels) further, past slab 1's floor at 1,024 voxels, and the
# 128-step rays cross it
MD_CAMERA_VOXELS = 1000
# path 1's offsets and (-2, -2, -2), which lines m1 up with m3 = m1 + 2 voxels
# across every slab boundary
MD_OFFSETS = OFFSETS + ((-2, -2, -2),)
MD_JFA_STEPS = (8, 4, 2, 1, 1)  # the sharded JFA's fine rounds (the reference's sharded default)
# the single-device repair's cap on path 9: one it must not reach, so that it
# runs to its fixpoint as the sharded repair (no cap) does
MD_JFA_MAX_ROUNDS = 4096

# path 10: the 19 programs of gpu_voxels_tpu_torch/examples/ at their own sizes
# on the card (the reference's accelerator scene where it picks by platform),
# beside CPU copies at tests/test_examples.py's sizes
EX_FIT = {"dims": (256, 256, 256), "side": 0.015}  # swept_fitter's defaults, its documented scale
EX_PLAN_ROUNDS = 3  # ompl_planner_app's default
# the live loop's 30 Hz contract on the accelerator (tests_tpu/test_examples_tpu.py:38-56):
# 90 frames from a 60 Hz source with the async publish, >= 80 processed at >= 30 Hz
EX_CONTRACT = {"frames": 90, "live_vis": True}
# the kernels each program must launch on the card (their maps' own routes:
# bit x prob and bit x bit collides of maps with occupancy summaries read the
# summaries, the lists, octrees, planners and the paged world run plain torch)
EX_KERNELS = {
    "batch_worlds_demo": set(),
    "collisions": {"count_prob_prob", "collide_types_bit_bit"},
    "counting_voxel_list": set(),
    "distance_kinect_demo": {"projective_free_space_exact", "envelope_pass"},
    "distance_voxel_test": {"envelope_pass"},
    "full_pipeline_demo": {"projective_free_space_pooled", "min_pool_depth", "envelope_pass", "collide_types_bit_bit"},
    "heightmap_demo": set(),
    "maps_demo": set(),
    "octree_bench": set(),
    "ompl_planner_app": set(),
    "ompl_planning_demo": set(),
    "primitive_array_test": set(),
    "robot_vs_environment": {"projective_free_space_exact"},
    "sharded_world_demo": set(),
    "shift_vs_transform": {"count_prob_prob"},
    "swept_fitter": {"collide_types_bit_bit"},
    "swept_volume_vs_environment": {"collide_types_bit_bit"},
    "tf_interface_demo": set(),
    "urdf_loader": set(),
}
# the programs whose scene or depth depends on the device: the rest but
# EX_FK return on the card exactly what their CPU copies return
EX_SIZED_BY_DEVICE = ("ompl_planner_app", "robot_vs_environment", "swept_fitter")
# the programs whose inner values are held against a plain_route() run of the
# same program on the card (kernel against plain, same inputs); the FK and
# rotation programs only there, since FK on the card may put a point in
# another cell than on the CPU (H4)
EX_FK = ("swept_volume_vs_environment", "tf_interface_demo", "urdf_loader")
EX_HELD_PLAIN = ("distance_kinect_demo", "full_pipeline_demo") + EX_FK
EX_REPLAY_BASES = ((2.56, 2.56, 2.56), (1.7, 2.3, 2.605))  # the loop's base; in the box face (z 2.6 m)
EX_KERNELS_REPLAY = {"projective_free_space_exact"}

def md_meshes(dev: torch.device) -> tuple:
    """Path 9's meshes: z 8, and world 2 x z 4 for the cycle. On the card the
    default (every visible card, slabs round-robin: all on cuda:0 here)."""
    if dev.type == "cuda":
        return make_grid_mesh(MD_SLABS), make_grid_mesh(MD_SLABS, world=2)
    return make_grid_mesh(MD_SLABS, devices=[dev]), make_grid_mesh(MD_SLABS, world=2, devices=[dev])


def md_world_sensor() -> PosedSensor:
    pose = carve_poses()["bench"].copy()
    pose[2, 3] = MD_CAMERA_VOXELS * FUSION_SIDE
    return PosedSensor(pose)


def md_cycle_clouds(pts: torch.Tensor) -> tuple:
    """The cycle's two scenes: path 1's pair (pts, pts + 1: count 0) and pts
    against pts moved 2 voxels along x (an overlap)."""
    shift = to_device(np.asarray([2.0, 0.0, 0.0], np.float32), torch.float32, pts.device)
    return torch.stack([pts, pts]), torch.stack([pts + 1.0, pts + shift])


def md_probe_coords(c5: dict, dev: torch.device) -> torch.Tensor:
    """BASELINE #5's 315 states x 400 robot points as int32 voxel coords
    (126,000: 15,750 a slab)."""
    cells = c5["robot"][None, :, :] + c5["states"][:, None, :]
    return to_device(np.floor(cells).reshape(-1, 3).astype(np.int32), torch.int32, dev)


def multidevice_path(dev: torch.device, out: dict, robot: dict, dist: dict, oc: dict) -> dict:
    """Path 9: the multi-device builders, sharded map values, the sharded
    paged world and the facade's mesh, every slab on the card (8 logical
    slabs on one card). The JFA's repair flags, the paged allocations and
    the files read the device on purpose."""
    md = {}
    mesh, cycle_mesh = md_meshes(dev)
    md["mesh"] = mesh
    pts = out["cycle_pts"]
    # (a) the 512^3 cycle, two scenes over world 2 x z 4 (K1 per slab)
    md["cycle"] = build_sharded_cycle(cycle_mesh, CYCLE_DIMS, 1.0, 0.5)(*md_cycle_clouds(pts))
    # (b) the sensor cycle: a Kinect frame carved per slab (K3 with the
    # slab's z_index_offset) against the fused 256^3 environment (K1)
    depth = to_device(out["frames"][0], torch.float32, dev)
    pose = to_device(kinect_sensor().pose(), torch.float32, dev)
    md["sensor"] = build_sharded_sensor_cycle(mesh, FUSION_DIMS, FUSION_SIDE, *INTR, 0.55)(depth, pose, out["env"].data)
    # (c) the bit cycle at 256^3: the frame's rays against themselves moved a voxel (K7)
    rays = out["rays"]
    md["bit"] = build_sharded_bit_cycle(mesh, FUSION_DIMS, FUSION_SIDE)(rays, rays + FUSION_SIDE)
    # (d) BASELINE #4's exact EDT at 512^3 over 8 slabs (K5 per slab and pass)
    packed = DistanceVoxelMap.create(EDT_DIMS, 1.0, device=dev).insert_point_cloud(
        (edt_obstacles() + 0.5).astype(np.float32)).data
    md["edt_in"] = packed
    md["edt"] = build_sharded_parallel_banding(mesh, EDT_DIMS)(packed)
    # (e) the JFA at 256^3 on path 3's merged camera map, its repair run to
    # its fixpoint (one host read a round); timed here, as it takes seconds
    with host_reads():
        md["jfa"], md["jfa_ms"] = timed_once(
            lambda: build_sharded_edt(mesh, FUSION_DIMS, fine_steps=MD_JFA_STEPS)(dist["merged"].data))
    # (f) BASELINE #5's probes at 1024^3: the dense pyramid (level 0 split),
    # the paged snapshot (queries split) and the env as a voxel list
    c5 = oc["c5"]
    coords = md_probe_coords(c5, dev)
    md["coords"] = coords
    dense, paged = c5["dense"], c5["paged"]
    md["hier"] = build_sharded_hier_probe(mesh, dense.levels, dense.padded_dims)(
        dense.pyramid[0], tuple(dense.pyramid[1:]), coords)
    md["paged"] = build_sharded_paged_probe(mesh)(paged.snapshot(), coords)
    env_list = bit_vector_voxel_list(C5_DIMS, 1.0, device=dev).insert_point_cloud(c5["env"])
    robot_list = bit_vector_voxel_list(C5_DIMS, 1.0, device=dev).insert_coordinates(coords)
    md["lists"] = env_list, robot_list
    md["list"] = build_sharded_list_collide(mesh)(env_list, robot_list)
    # (g) path 1's 512^3 prob maps and the robot path's 256^3 bit maps as
    # slab-sharded values: collides at path 1's offsets (K1), an insert
    # through the sharded value, the types collide at window 5 (K4)
    m1 = ProbVoxelMap.create(CYCLE_DIMS, 1.0, device=dev).insert_point_cloud(pts)
    m3 = ProbVoxelMap.create(CYCLE_DIMS, 1.0, device=dev).insert_point_cloud(pts + 2.0)
    s1, s3 = shard_map_value(m1, mesh), shard_map_value(m3, mesh)
    md["prob_maps"] = m1, m3
    md["prob"] = [s1.collide_with(s3, 0.5, off) for off in MD_OFFSETS]
    md["prob_inserted"] = s1.insert_point_cloud(pts + 1.0)
    md["prob"].append(md["prob_inserted"].collide_with(m3, 0.5))
    sweep, env = shard_map_value(robot["sweep"], mesh), shard_map_value(robot["env"], mesh)
    md["sharded_bits"] = sweep, env
    md["types"] = sweep.collide_with_types(env, 1.0, 5)
    # (h) a 4096^3 ShardedPagedWorld over 4 slabs and the single paged map,
    # one Kinect frame each, its rays crossing slab 1's floor
    frame = oc["paged_inputs"]["frame"]
    sensor = md_world_sensor()
    with host_reads():
        world = ShardedPagedWorld(PAGED_DIMS, FUSION_SIDE, devices=[dev] * MD_WORLD_SLABS)
        world.insert_depth_image(frame, sensor, max_steps=128)
        single = PagedHierarchicalMap(PAGED_DIMS, FUSION_SIDE, device=dev).insert_depth_image(frame, sensor,
                                                                                              max_steps=128)
        md["world_tiles"] = [m.n_tiles() for m in world.shards], single.n_tiles()
        md["world_ok"] = world.check_tree()
        # probes: path 7's, and the world's occupied voxels moved a voxel along x
        occupied = single.extract_occupied_coords() + np.asarray([1, 0, 0], np.int32)
    probes = torch.cat([oc["paged_inputs"]["probes"], to_device(occupied, torch.int32, dev)])
    moved = bit_vector_morton_voxel_list(PAGED_DIMS, FUSION_SIDE, device=dev).insert_coordinates(
        to_device(occupied, torch.int32, dev))
    md["world"] = world, single
    md["world_answers"] = [(world.probe_status(probes), single.probe_status(probes)),
                           (world.collide_with_coords(probes), single.collide_with_coords(probes)),
                           (world.collide_with(moved, offset=(-1, 0, 0)), single.collide_with(moved, offset=(-1, 0, 0)))]
    # (i) the facade's mesh: a paged octree as a world, a dense map as a
    # sharded value taking the UR10 self-collision aware, each saved and
    # loaded back
    md["arm"] = ur10_configuration(robot)
    md["facade"] = facade_mesh_answers(dev, mesh, frame, sensor, rays, oc["paged_inputs"]["probes"], md["arm"])
    # (j-o) every dense-tier method's slab form on the main path's data
    md["forms"] = dense_slab_forms(dev, mesh, out, md)
    # (p-t) every hierarchy method's slab form; (p)'s launches counted alone
    md["pyramids"] = pyramid_slab_forms(dev, mesh, out, md, oc)
    return md


class PosedClouds:
    """A robot for the facade's add_robot_object: one configuration's link
    clouds."""

    def __init__(self, clouds: MetaPointCloud):
        self.clouds = clouds

    def get_transformed_clouds(self) -> MetaPointCloud:
        return self.clouds


def ur10_configuration(robot: dict) -> MetaPointCloud:
    """The UR10 of BASELINE #3 at step 32 of its trajectory: its link clouds
    (one MetaPointCloud, 0.02 m) placed at the bench's base."""
    clouds = robot["placed"].transformed_clouds_for(robot["cfgs"][32:33])
    return replace(clouds, points=clouds.points[0])


def dense_slab_forms(dev: torch.device, mesh, out: dict, md: dict) -> dict:
    """Path 9's slab forms of sharded dense maps (8 slabs on the card), each
    on the main path's data: (j) path 1's Kinect frame at carve_pool 1 (K3
    per slab) and 8 (K6 per slab, one pooled table); (k) the DDA frame, its
    rays walked once for all slabs; (l) the marking collide of path 1's
    512^3 maps at path 9's offsets (K2 per run of slabs); (m) the UR10's
    configuration into a 256^3 bit map with the self-collision check; (n)
    BASELINE #4 through a sharded 512^3 DistanceVoxelMap: insert,
    jump_flood (the card's route: K5 per slab and pass), min_distance_to,
    extract_distances; (o) path 3's camera -> distance field frame: 5
    frames pooled-carved (K6), merge_occupied, jump_flood."""
    sf = {}
    sensor = kinect_sensor()
    empty = shard_map_value(ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev), mesh)
    sf["depth"] = [empty.insert_depth_image(out["frames"][0], sensor, carve_pool=pool) for pool in (1, POOL)]
    sf["dda"] = empty.insert_sensor_data(out["rays"], sensor_origin=sensor.position)
    m1, m3 = md["prob_maps"]
    s1, s3 = shard_map_value(m1, mesh), shard_map_value(m3, mesh)
    sf["marking"] = [s1.collide_with_marking(s3, 0.5, off) for off in MD_OFFSETS]
    bits = shard_map_value(BitVectorVoxelMap.create(SV_DIMS, SV_SIDE, device=dev), mesh)
    sf["robot"] = bits.insert_robot_configuration(md["arm"], True)
    field = shard_map_value(DistanceVoxelMap.create(EDT_DIMS, 1.0, device=dev), mesh).insert_point_cloud(
        (edt_obstacles() + 0.5).astype(np.float32)).jump_flood()
    sf["edt"], sf["edt_min"], sf["edt_bytes"] = field, field.min_distance_to(edt_queries()), field.extract_distances()
    env = empty
    for frame in out["frames"]:
        env = env.insert_depth_image(frame, sensor, carve_pool=POOL)
    merged = shard_map_value(DistanceVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev), mesh).merge_occupied(env)
    sf["pooled_env"], sf["merged"], sf["field"] = env, merged, merged.jump_flood()
    return sf


def facade_mesh_answers(dev: torch.device, mesh, frame, sensor, rays, probes, arm: MetaPointCloud) -> dict:
    """add_map(mesh=...) for a 4096^3 prob octree (a ShardedPagedWorld over
    the mesh's first 4 slabs) and a 256^3 prob map (a sharded value), a frame
    or the rays and the UR10 (self-collision aware) into each, save_map ->
    load_map of both."""
    ans = {}
    world_mesh = make_grid_mesh(MD_WORLD_SLABS, devices=list(mesh.devices.reshape(-1)))
    with tempfile.TemporaryDirectory() as tmp, host_reads():
        GpuVoxels._instance = None
        gvl = GpuVoxels.get_instance()
        gvl.initialize(*PAGED_DIMS, FUSION_SIDE, device=dev)
        w = gvl.add_map(MapType.MT_PROBAB_OCTREE, "world", mesh=world_mesh)
        w.insert_depth_image(frame, sensor, max_steps=128)
        w.assert_distributed()
        path = os.path.join(tmp, "world.bin")
        gvl.save_map("world", path)
        ans["world_digest"] = digest(path)
        gvl.load_map("world", path)
        back = gvl.get_map("world")
        ans["world"] = (type(w).__name__, type(back).__name__, w.n_tiles(), back.n_tiles(),
                        torch.equal(w.probe_occupancy(probes), back.probe_occupancy(probes)))
        single = PagedHierarchicalMap(PAGED_DIMS, FUSION_SIDE, probabilistic=True, device=dev).insert_depth_image(
            frame, sensor, max_steps=128)
        io.write_map(single, os.path.join(tmp, "single.bin"))
        ans["world_single_digest"] = digest(os.path.join(tmp, "single.bin"))
        GpuVoxels._instance = None
        gvl = GpuVoxels.get_instance()
        gvl.initialize(*FUSION_DIMS, FUSION_SIDE, device=dev)
        gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "env", mesh=mesh)
        gvl.insert_point_cloud_into_map(rays, "env")
        gvl.add_robot_object("ur10", PosedClouds(arm))
        ans["clash"] = gvl.insert_robot_into_map_self_collision_aware("ur10", "env")
        assert_sharded(gvl.get_map("env"), mesh)
        path = os.path.join(tmp, "env.bin")
        gvl.save_map("env", path)
        ans["env_digest"] = digest(path)
        gvl.load_map("env", path)
        assert_sharded(gvl.get_map("env"), mesh)  # re-pinned
        plain = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(rays)
        plain, ans["single_clash"] = plain.insert_meta_point_cloud_with_self_collision_check(arm)
        io.write_map(plain, os.path.join(tmp, "plain.bin"))
        ans["env_single_digest"] = digest(os.path.join(tmp, "plain.bin"))
        ans["env"] = torch.equal(gvl.get_map("env").gather().data, plain.data)
        GpuVoxels._instance = None
    return ans


def counted(fn, *args):
    """(fn(*args), each kernel's launches in that call alone): the counts
    set to 0 just before it and read just after, then the counts from before
    added back, so that the path's totals stay whole."""
    before = {name: module.launches[name] for name, module, *_ in KERNELS}
    for name, module, *_ in KERNELS:
        module.launches[name] = 0
    result = fn(*args)
    got = {name: module.launches[name] for name, module, *_ in KERNELS}
    for name, module, *_ in KERNELS:
        module.launches[name] += before[name]
    return result, got


def sharded_fusions(dev: torch.device, mesh, frame: np.ndarray) -> dict:
    """(p) path 7's frame into a sharded 512^3 HierarchicalBitMap and
    HierarchicalProbMap under the three carve poses at carve_pool 1 (K3 once
    a slab) and 8 (K6's pool once a frame, its carve once a slab),
    check_tree after every insert."""
    empty = [shard_map_value(cls.create(HIER_DIMS, HIER_SIDE, device=dev), mesh)
             for cls in (HierarchicalProbMap, HierarchicalBitMap)]
    fused, tree_ok = {}, []
    for pool in (1, POOL):
        for label, pose in carve_poses().items():
            sensor = PosedSensor(pose)
            prob, bit = (m.insert_depth_image(frame, sensor, pool) for m in empty)
            with host_reads():
                tree_ok.append(prob.check_tree() and bit.check_tree())
            fused[(pool, label)] = (prob, bit)
    return {"fused": fused, "tree_ok": tree_ok}


def pyramid_slab_forms(dev: torch.device, mesh, out: dict, md: dict, oc: dict) -> dict:
    """Path 9's slab forms of sharded hierarchies (8 slabs on the card):
    (p) the 512^3 fusions, their launches counted alone; (q) BASELINE #5's
    1024^3 build, with and without the free box, and the 315-state checker
    batch over the sharded pyramid; (r) octree x octree at min_level 0 and 3
    (sharded x sharded, x plain both ways) and the 4096^3 paged map x the
    sharded 256^3 hierarchy of path 7; (s) path 1's 307,200 rays into a
    sharded 256^3 hierarchy of each tier (the DDA); (t) the UR10
    configuration with the self-collision check, collide_with_resolution at
    levels 0-3 against the fused frame's rays as a list, extract_occupied_coords,
    memory_usage, write_to_disk and read_from_disk on the fused 512^3 bit
    pyramid, and the facade's mesh octree (256^3) taking a frame, saved and
    loaded. The checker, check_tree, the extraction, the paged allocations
    and the files read the device on purpose."""
    pf = {}
    frame = oc["paged_inputs"]["frame"]
    pf["fusion"], pf["fusion_launches"] = counted(sharded_fusions, dev, mesh, frame)
    c5 = oc["c5"]
    env = to_device(c5["env"], torch.float32, dev)
    empty = shard_map_value(HierarchicalBitMap.create(C5_DIMS, 1.0, device=dev), mesh)
    pf["c5"] = [empty.build(env), empty.build(env, free_bounding_box=True)]
    with host_reads():
        pf["c5_counts"] = [HierarchicalValidityChecker(m, c5["arm"]).batch_colliding_voxels(c5["states"])
                           for m in pf["c5"]]
    prob, bit = pf["fusion"]["fused"][(1, "bench")]
    s_prob, s_bit = oc["fusion"]["fused"][(1, "bench")][:2]
    pf["octree"] = {level: [prob.collide_with(bit, level), prob.collide_with(s_bit, level),
                            s_prob.collide_with(bit, level)] for level in (0, 3)}
    hier = shard_map_value(oc["paged_inputs"]["hier"], mesh)
    with host_reads():  # the paged insert allocates
        paged = PagedHierarchicalMap(PAGED_DIMS, FUSION_SIDE, device=dev).insert_depth_image(
            frame, kinect_sensor(), max_steps=128)
    pf["paged"] = paged
    pf["paged_hier"] = [paged.collide_with(hier), hier.collide_with(paged)]
    origin = kinect_sensor().position
    pf["dda"] = [shard_map_value(cls.create(FUSION_DIMS, FUSION_SIDE, device=dev), mesh)
                 .insert_point_cloud_with_free_space(out["rays"], origin) for cls in (HierarchicalBitMap,
                                                                                     HierarchicalProbMap)]
    pf["robot"] = bit.insert_robot_configuration(md["arm"], True)
    # the fused frame's rays as a list in the pyramid's own voxel frame
    kinect = bit_vector_voxel_list(HIER_DIMS, HIER_SIDE, device=dev).insert_point_cloud(oc["paged_inputs"]["rays"])
    pf["kinect"] = kinect
    pf["resolution"] = [bit.collide_with_resolution(kinect, 1.0, level) for level in range(4)]
    with tempfile.TemporaryDirectory() as tmp, host_reads():
        pf["occupied"] = bit.extract_occupied_coords()
        pf["memory"] = bit.memory_usage()
        path = os.path.join(tmp, "bit.bin")
        assert bit.write_to_disk(path)
        pf["digest"] = digest(path)
        pf["back"] = bit.read_from_disk(path)
        GpuVoxels._instance = None
        gvl = GpuVoxels.get_instance()
        gvl.initialize(*FUSION_DIMS, FUSION_SIDE, device=dev)
        gvl.add_map(MapType.MT_PROBAB_OCTREE, "octree", mesh=mesh)
        gvl.update_map("octree", lambda m: m.insert_depth_image(frame, kinect_sensor()))
        path = os.path.join(tmp, "octree.bin")
        gvl.save_map("octree", path)
        pf["octree_digest"] = digest(path)
        gvl.load_map("octree", path)
        pf["octree_loaded"] = gvl.get_map("octree")
        GpuVoxels._instance = None
    return pf


def check_multidevice_path(md: dict, dev: torch.device, out: dict, robot: dict, dist: dict, oc: dict) -> None:
    """Every sharded answer of path 9 against the single-device call on the
    same card."""
    mesh = md["mesh"]
    assert mesh.z_devices() == [dev] * MD_SLABS, mesh
    pts = out["cycle_pts"]
    pa, pb = md_cycle_clouds(pts)
    single = [ProbVoxelMap.create(CYCLE_DIMS, 1.0, device=dev).insert_point_cloud(pa[w]).collide_with(
        ProbVoxelMap.create(CYCLE_DIMS, 1.0, device=dev).insert_point_cloud(pb[w]), 0.5) for w in (0, 1)]
    got = md["cycle"].tolist()
    assert got == [int(c) for c in single] and got[0] == int(out["cycle"]) == 0 and got[1] > 0, (got, single)
    log(f"  (a) 512^3 cycle over world 2 x z 4: counts {got} == single-device (scene 0 == path 1's count)")

    depth = torch.as_tensor(out["frames"][0], device=dev)
    pose = to_device(kinect_sensor().pose(), torch.float32, dev)
    unknown = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev)
    sensed = raycast.insert_depth_image(unknown.data, depth, pose, *INTR, FUSION_SIDE, FUSION_DIMS)
    t = float_to_probability(0.55)
    want = int(collide_cuda.count_prob_prob(sensed, out["env"].data, t, t))
    assert int(md["sensor"]) == want > 0, (int(md["sensor"]), want)
    log(f"  (b) sensor cycle at 256^3 over 8 slabs: count {want} == single-device")

    rays = out["rays"]
    b1 = BitVectorVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(rays)
    b2 = BitVectorVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(rays + FUSION_SIDE)
    want = int(b1.collide_with(b2))
    assert int(md["bit"]) == want > 0, (int(md["bit"]), want)
    log(f"  (c) bit cycle at 256^3 over 8 slabs: count {want} == single-device")

    whole = dist["edt"].data
    assert all(torch.equal(s, p) for s, p in zip(md["edt"], torch.chunk(whole, MD_SLABS))), "sharded exact EDT"
    assert torch.equal(edt_envelope.parallel_banding(md["edt_in"], EDT_DIMS), whole)
    log(f"  (d) exact EDT at 512^3 over 8 slabs: the packed grid == path 3's, bit for bit")

    merged = dist["merged"].data
    d_sh = edt.squared_distance_grid(torch.cat(md["jfa"]), FUSION_DIMS)
    with host_reads():
        # the single-device repair with the same fine steps, run to its
        # fixpoint as the sharded one is: a cap it does not reach
        (single, rounds), md["jfa_single_ms"] = timed_once(lambda: edt.jump_flood_multires_with_stats(
            merged, FUSION_DIMS, fine_steps=MD_JFA_STEPS, max_iters=MD_JFA_MAX_ROUNDS))
        d_single = edt.squared_distance_grid(single, FUSION_DIMS)
        differ = int((d_sh != d_single).sum())
        exact = edt.squared_distance_grid(edt_envelope.parallel_banding(merged, FUSION_DIMS), FUSION_DIMS)
        off_exact = int((d_sh != exact).sum())
        below_exact = int((d_sh < exact).sum())
    assert rounds < MD_JFA_MAX_ROUNDS, f"the single-device repair did not converge in {rounds} rounds"
    assert differ == 0, f"sharded JFA d2 differs from the single-device fixpoint at {differ} voxels"
    assert below_exact == 0, f"the JFA is below the exact EDT at {below_exact} voxels"
    log(f"  (e) JFA at 256^3 over 8 slabs: squared distances == jump_flood_multires_with_stats run to its fixpoint "
        f"({rounds} repair rounds, past the 64-round default cap: {rounds > 64}); {off_exact} voxels above the "
        f"exact EDT, none below")

    c5, coords = oc["c5"], md["coords"]
    want_hier = int(c5["dense"].probe(coords)[0].sum())
    assert int(md["hier"]) == want_hier > 0, (int(md["hier"]), want_hier)
    e_occ, e_unk = c5["paged"].collide_with_counting_unknown_coords(coords)
    occ, unk = md["paged"]
    assert (int(occ), int(unk)) == (int(e_occ), int(e_unk)) and int(occ) == want_hier, (int(occ), int(e_occ))
    env_list, robot_list = md["lists"]
    want_list = int(env_list.collide_with(robot_list))
    assert int(md["list"]) == want_list > 0, (int(md["list"]), want_list)
    log(f"  (f) BASELINE #5 at 1024^3, {coords.shape[0]} probes over 8 slabs: hier {want_hier}, paged "
        f"({int(occ)}, {int(unk)}), list {want_list} == single-device")

    m1, m3 = md["prob_maps"]
    want = [int(m1.collide_with(m3, 0.5, off)) for off in MD_OFFSETS]
    want.append(int(m1.insert_point_cloud(pts + 1.0).collide_with(m3, 0.5)))
    got = [int(c) for c in md["prob"]]
    assert got == want and max(got) > 0, (got, want)
    assert_sharded(md["prob_inserted"], mesh)
    assert torch.equal(md["prob_inserted"].gather().data, m1.insert_point_cloud(pts + 1.0).data)
    cnt, meanings, marked = md["types"]
    w_cnt, w_meanings, w_marked = robot["sweep"].collide_with_types(robot["env"], 1.0, 5)
    assert int(cnt) == int(w_cnt) > 0 and torch.equal(meanings, w_meanings)
    assert_sharded(marked, mesh)
    assert same_map(marked.gather(), w_marked)
    log(f"  (g) sharded values: 512^3 prob collides {got} (K1) and the 256^3 types collide (K4) count "
        f"{int(cnt)}, meanings, marked map (still sharded) == single-device")

    (world, single), (slab_tiles, single_tiles) = md["world"], md["world_tiles"]
    assert sum(slab_tiles) == single_tiles and sum(1 for n in slab_tiles if n) >= 2 and md["world_ok"], slab_tiles
    for got, want in md["world_answers"]:
        assert torch.equal(got, want) if got.ndim else int(got) == int(want) > 0, (got, want)
    log(f"  (h) {PAGED_DIMS[0]}^3 ShardedPagedWorld over {MD_WORLD_SLABS} slabs: tiles {slab_tiles} (sum "
        f"{single_tiles} == single), probes, the coords collide {int(md['world_answers'][1][0])} and the morton "
        f"list collide {int(md['world_answers'][2][0])} == single")

    fa = md["facade"]
    assert fa["world"][:2] == ("ShardedPagedWorld", "ShardedPagedWorld") and fa["world"][2] == fa["world"][3] > 0
    assert fa["world"][4] and fa["world_digest"] == fa["world_single_digest"], fa["world"]
    assert fa["env"] and fa["env_digest"] == fa["env_single_digest"]
    assert bool(fa["clash"]) == bool(fa["single_clash"])
    log(f"  (i) the facade's mesh: a {PAGED_DIMS[0]}^3 prob octree as a ShardedPagedWorld and a 256^3 prob map "
        f"as a sharded value taking the UR10 self-collision aware (clash {bool(fa['clash'])} == single), "
        f"save_map -> load_map: files == the single-device maps', reloaded equal")
    check_dense_slab_forms(md, dev, out, dist)
    check_pyramid_slab_forms(md, dev, out, oc)


def gathered(m, mesh) -> torch.Tensor:
    """A sharded dense map's data, after asserting it is still sharded."""
    assert_sharded(m, mesh)
    return m.gather().data


def check_dense_slab_forms(md: dict, dev: torch.device, out: dict, dist: dict) -> None:
    """Path 9's slab forms against the single-device calls on the card."""
    mesh, sf = md["mesh"], md["forms"]
    sensor = kinect_sensor()
    for pool, got in zip((1, POOL), sf["depth"]):
        want = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).insert_depth_image(
            out["frames"][0], sensor, carve_pool=pool)
        assert torch.equal(gathered(got, mesh), want.data), pool
    assert torch.equal(gathered(sf["dda"], mesh), out["dda"].data)
    log(f"  (j, k) a Kinect frame into a sharded 256^3 prob map at carve_pool 1 (K3) and {POOL} (K6), and the DDA "
        f"frame ({out['rays'].shape[0]} rays, one walk): maps == single-device")
    m1, m3 = md["prob_maps"]
    counts = []
    for off, (cnt, marked) in zip(MD_OFFSETS, sf["marking"]):
        w_cnt, w_marked = m1.collide_with_marking(m3, 0.5, off)
        assert int(cnt) == int(w_cnt) and torch.equal(gathered(marked, mesh), w_marked.data), off
        counts.append(int(cnt))
    assert max(counts) > 0, counts
    log(f"  (l) 512^3 marking collides at {MD_OFFSETS} (K2 per run of slabs): counts {counts}, marked maps (still "
        f"sharded) == single-device")
    got_map, ok = sf["robot"]
    w_map, w_ok = BitVectorVoxelMap.create(SV_DIMS, SV_SIDE, device=dev).insert_robot_configuration(md["arm"], True)
    assert_sharded(got_map, mesh)
    assert same_map(got_map.gather(), w_map) and bool(ok) == bool(w_ok) and int(w_map.occ.sum()) > 0
    log(f"  (m) the UR10 configuration into a sharded 256^3 bit map, self-collision checked (ok {bool(ok)}): "
        f"map == single-device")
    field = DistanceVoxelMap.create(EDT_DIMS, 1.0, device=dev).insert_point_cloud(
        (edt_obstacles() + 0.5).astype(np.float32)).jump_flood()
    if dev.type == "cuda":  # jump_flood's card route is the exact EDT: path 3's map
        assert torch.equal(field.data, dist["edt"].data)
    assert torch.equal(gathered(sf["edt"], mesh), field.data)
    assert torch.equal(sf["edt_min"], field.min_distance_to(edt_queries()))
    assert torch.equal(sf["edt_bytes"], field.extract_distances())
    log(f"  (n) BASELINE #4 through a sharded 512^3 DistanceVoxelMap (insert, jump_flood: K5 per slab): packed grid "
        f"(== path 3's exact EDT), min distance {float(sf['edt_min']):.4f} m and byte distances == single-device")
    for key in ("pooled_env", "merged", "field"):
        assert torch.equal(gathered(sf[key], mesh), dist[key].data), key
    log(f"  (o) path 3's camera -> distance field on sharded maps (5 frames at P = {POOL}, merge_occupied, "
        f"jump_flood): fused map, obstacles and field == single-device")


def same_pyramid(got, want, mesh) -> bool:
    """A sharded pyramid (still sharded) against a single-device one: every
    level and the prob tier's occupancy byte for byte."""
    assert_sharded(got, mesh)
    g = got.gather()
    ok = len(g.pyramid) == len(want.pyramid) and all(torch.equal(a, b) for a, b in zip(g.pyramid, want.pyramid))
    return ok and (not isinstance(want, HierarchicalProbMap) or torch.equal(g.occupancy, want.occupancy))


# (p)'s launches: 3 poses x 2 tiers at each carve_pool, 8 slabs a fusion
PYRAMID_FUSION_LAUNCHES = {"projective_free_space_exact": 48, "projective_free_space_pooled": 48, "min_pool_depth": 6}


def check_pyramid_slab_forms(md: dict, dev: torch.device, out: dict, oc: dict) -> None:
    """Path 9's hierarchy slab forms against the single-device calls on the
    card (and BASELINE #5 against the numpy set oracle)."""
    mesh, pf = md["mesh"], md["pyramids"]
    fusion, launches = pf["fusion"], pf["fusion_launches"]
    assert all(fusion["tree_ok"]) and len(fusion["tree_ok"]) == 6
    for key, (prob, bit) in fusion["fused"].items():
        s_prob, s_bit, _ = oc["fusion"]["fused"][key]
        assert same_pyramid(prob, s_prob, mesh) and same_pyramid(bit, s_bit, mesh), key
    ran = {name: count for name, count in launches.items() if count}
    assert ran == PYRAMID_FUSION_LAUNCHES, ran
    log(f"  (p) path 7's frame into sharded {HIER_DIMS[0]}^3 hierarchies of both tiers under "
        f"{len(carve_poses())} poses at carve_pool 1 and {POOL}: every level and the occupancy == the single-device "
        f"fusions, check_tree after every insert; launches counted around (p) alone {ran}")
    c5 = oc["c5"]
    oracle = config5_oracle(c5["env"], c5["robot"], c5["states"])
    built, boxed = pf["c5"]
    assert same_pyramid(built, c5["dense"], mesh)
    want_boxed = HierarchicalBitMap.create(C5_DIMS, 1.0, device=dev).build(to_device(c5["env"], torch.float32, dev),
                                                                            free_bounding_box=True)
    assert same_pyramid(boxed, want_boxed, mesh)
    del want_boxed
    for counts in pf["c5_counts"]:
        assert np.array_equal(counts, oracle) and np.array_equal(counts, oc["c5_dense"])
    log(f"  (q) BASELINE #5 on a sharded {C5_DIMS[0]}^3 pyramid: build(env) and build(env, free_bounding_box=True) "
        f"== the single-device builds; the {len(oracle)}-state checker batch over each == the numpy set oracle "
        f"({int((oracle > 0).sum())} states collide) == path 7's dense counts")
    s_prob, s_bit = oc["fusion"]["fused"][(1, "bench")][:2]
    counts = {}
    for level, got in pf["octree"].items():
        want = int(s_prob.collide_with(s_bit, level))
        counts[level] = [int(c) for c in got]
        assert counts[level] == [want] * 3 and want > 0, (level, counts[level], want)
    hier = oc["paged_inputs"]["hier"]
    want = int(pf["paged"].collide_with(hier))
    got = [int(c) for c in pf["paged_hier"]]
    assert got == [want, want] and want > 0, (got, want)
    log(f"  (r) octree x octree at {HIER_DIMS[0]}^3, sharded x sharded, x plain both ways: level 0 "
        f"{counts[0][0]}, level 3 {counts[3][0]}; the {PAGED_DIMS[0]}^3 paged map x the sharded "
        f"{FUSION_DIMS[0]}^3 hierarchy, both ways: {want} == single-device")
    origin = kinect_sensor().position
    for cls, got in zip((HierarchicalBitMap, HierarchicalProbMap), pf["dda"]):
        want = cls.create(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud_with_free_space(out["rays"], origin)
        assert same_pyramid(got, want, mesh), cls.__name__
    log(f"  (s) {out['rays'].shape[0]} rays into sharded {FUSION_DIMS[0]}^3 hierarchies of both tiers "
        f"(insert_point_cloud_with_free_space, the rays walked once): == single-device")
    got_map, ok = pf["robot"]
    w_map, w_ok = s_bit.insert_robot_configuration(md["arm"], True)
    assert same_pyramid(got_map, w_map, mesh) and bool(ok) == bool(w_ok)
    kinect = pf["kinect"]
    res = [int(c) for c in pf["resolution"]]
    want = [int(s_bit.collide_with_resolution(kinect, 1.0, level)) for level in range(4)]
    assert res == want and min(res) > 0, (res, want)
    with tempfile.TemporaryDirectory() as tmp, host_reads():
        assert np.array_equal(pf["occupied"], s_bit.extract_occupied_coords()) and len(pf["occupied"]) > 0
        assert pf["memory"] == s_bit.memory_usage()
        path = os.path.join(tmp, "single.bin")
        io.write_map(s_bit, path)
        assert pf["digest"] == digest(path)
        single_octree = HierarchicalProbMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).insert_depth_image(
            oc["paged_inputs"]["frame"], kinect_sensor())
        io.write_map(single_octree, path)
        assert pf["octree_digest"] == digest(path)
    assert same_pyramid(pf["back"], s_bit, mesh) and same_pyramid(pf["octree_loaded"], single_octree, mesh)
    log(f"  (t) the fused {HIER_DIMS[0]}^3 bit pyramid: the UR10 configuration self-collision checked (ok "
        f"{bool(ok)}), collide_with_resolution at levels 0-3 against the frame's rays as a list {res}, "
        f"{len(pf['occupied'])} occupied coords, memory_usage {pf['memory']} B, the file (written slab by slab) "
        f"and its read-back == single-device; the facade's mesh octree at {FUSION_DIMS[0]}^3: a frame, "
        f"save_map -> load_map == the single-device map's file and map")


def multidevice_timings(dev: torch.device, smi: str, md: dict, out: dict, robot: dict, dist: dict, oc: dict) -> None:
    """Phase 4's times of path 9 (printed, never asserted): each sharded call
    beside its single-device call on the same card (CUDA events; the host
    clock where the host allocates)."""
    mesh, cycle_mesh = md_meshes(dev)
    pts = out["cycle_pts"]
    pa, pb = md_cycle_clouds(pts)
    rows = []

    def cycle_single():
        return [ProbVoxelMap.create(CYCLE_DIMS, 1.0, device=dev).insert_point_cloud(pa[w]).collide_with(
            ProbVoxelMap.create(CYCLE_DIMS, 1.0, device=dev).insert_point_cloud(pb[w]), 0.5) for w in (0, 1)]

    fn = build_sharded_cycle(cycle_mesh, CYCLE_DIMS, 1.0, 0.5)
    rows.append(("512^3 cycle, 2 scenes (world 2 x z 4)", time_ms(lambda: fn(pa, pb), 5), time_ms(cycle_single, 5)))
    depth = torch.as_tensor(out["frames"][0], device=dev)
    pose = to_device(kinect_sensor().pose(), torch.float32, dev)
    env = out["env"].data
    fn = build_sharded_sensor_cycle(mesh, FUSION_DIMS, FUSION_SIDE, *INTR, 0.55)
    unknown = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).data
    t = float_to_probability(0.55)
    rows.append(("256^3 sensor cycle", time_ms(lambda: fn(depth, pose, env), 10), time_ms(
        lambda: collide_cuda.count_prob_prob(raycast.insert_depth_image(unknown, depth, pose, *INTR, FUSION_SIDE,
                                                                        FUSION_DIMS), env, t, t), 10)))
    rays = out["rays"]
    fn = build_sharded_bit_cycle(mesh, FUSION_DIMS, FUSION_SIDE)
    rows.append(("256^3 bit cycle (K7 per slab; single: occupancy summaries)", time_ms(
        lambda: fn(rays, rays + FUSION_SIDE), 10), time_ms(
        lambda: BitVectorVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(rays).collide_with(
            BitVectorVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(rays + FUSION_SIDE)),
        10)))
    fn = build_sharded_parallel_banding(mesh, EDT_DIMS)
    packed = md["edt_in"]
    rows.append(("512^3 exact EDT", time_ms(lambda: fn(packed), 3, warmup=1),
                 time_ms(lambda: edt_envelope.parallel_banding(packed, EDT_DIMS), 3, warmup=1)))
    # path 9's own calls, one each: each repair runs to its fixpoint and takes seconds
    rows.append(("256^3 JFA to the repair's fixpoint (one host read a round)", md["jfa_ms"], md["jfa_single_ms"]))
    c5, coords = oc["c5"], md["coords"]
    dense, paged = c5["dense"], c5["paged"]
    fn = build_sharded_hier_probe(mesh, dense.levels, dense.padded_dims)
    rows.append((f"1024^3 hier probe, {coords.shape[0]} coords", time_ms(
        lambda: fn(dense.pyramid[0], tuple(dense.pyramid[1:]), coords), 10), time_ms(
        lambda: dense.probe(coords)[0].sum(), 10)))
    fn = build_sharded_paged_probe(mesh)
    snap = paged.snapshot()
    rows.append((f"1024^3 paged probe, {coords.shape[0]} coords", time_ms(lambda: fn(snap, coords), 10),
                 time_ms(lambda: paged.collide_with_counting_unknown_coords(coords), 10)))
    fn = build_sharded_list_collide(mesh)
    la, lb = md["lists"]
    rows.append((f"list x list, {la.capacity} x {lb.capacity} entries", time_ms(lambda: fn(la, lb), 10),
                 time_ms(lambda: la.collide_with(lb), 10)))
    m1, m3 = md["prob_maps"]
    s1, s3 = shard_map_value(m1, mesh), shard_map_value(m3, mesh)
    rows.append(("512^3 sharded prob collide, offset (3, -2, 1) (K1)", time_ms(
        lambda: s1.collide_with(s3, 0.5, (3, -2, 1)), 10), time_ms(lambda: m1.collide_with(m3, 0.5, (3, -2, 1)), 10)))
    sweep, env_bits = md["sharded_bits"]
    rows.append(("256^3 sharded types collide, window 5 (K4)", time_ms(
        lambda: sweep.collide_with_types(env_bits, 1.0, 5), 10), time_ms(
        lambda: robot["sweep"].collide_with_types(robot["env"], 1.0, 5), 10)))
    frame = oc["paged_inputs"]["frame"]
    sensor = md_world_sensor()
    with host_reads():
        for label, make in ((f"{PAGED_DIMS[0]}^3 paged frame, allocating ({MD_WORLD_SLABS} slabs)",
                             lambda: ShardedPagedWorld(PAGED_DIMS, FUSION_SIDE, devices=[dev] * MD_WORLD_SLABS)),
                            ("", lambda: PagedHierarchicalMap(PAGED_DIMS, FUSION_SIDE, device=dev))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            make().insert_depth_image(frame, sensor, max_steps=128)
            torch.cuda.synchronize()
            rows.append((label, (time.perf_counter() - t0) * 1e3, None))
    (label, w_ms, _), (_, s_ms, _) = rows.pop(-2), rows.pop(-1)
    rows.append((label + " (host clock)", w_ms, s_ms))
    rows += dense_form_timings(dev, mesh, md, out, robot)
    rows += pyramid_form_timings(dev, mesh, md, out, oc)
    for label, sharded_ms, single_ms in rows:
        log(f"  path 9 {label}: sharded {sharded_ms:.4f} ms, single-device {single_ms:.4f} ms  [{smi}]")


def launch_count(fn) -> int:
    """The device operations (kernels, memsets, copies) of one call of fn,
    by torch.profiler."""
    return sum(e.count for e in device_rows(fn, 1))


def dense_form_timings(dev: torch.device, mesh, md: dict, out: dict, robot: dict) -> list:
    """(label, sharded ms, single-device ms) of path 9's dense slab forms,
    each sharded call beside its single-device call on the same card."""
    rows = []
    sensor = kinect_sensor()
    frame = torch.as_tensor(out["frames"][0], device=dev)
    fresh = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev)
    sfresh = shard_map_value(fresh, mesh)
    for pool in (1, POOL):
        rows.append((f"256^3 Kinect frame insert_depth_image, carve_pool {pool}",
                     time_ms(lambda: sfresh.insert_depth_image(frame, sensor, carve_pool=pool), 10),
                     time_ms(lambda: fresh.insert_depth_image(frame, sensor, carve_pool=pool), 10)))
    rays = out["rays"]
    dda = (lambda: sfresh.insert_sensor_data(rays, sensor_origin=sensor.position),
           lambda: fresh.insert_sensor_data(rays, sensor_origin=sensor.position))
    ops = [launch_count(fn) for fn in dda]
    rows.append((f"256^3 DDA frame ({rays.shape[0]} rays, 256 steps; device operations: sharded {ops[0]}, "
                 f"single {ops[1]})", time_ms(dda[0], 3, warmup=1), time_ms(dda[1], 3, warmup=1)))
    m1, m3 = md["prob_maps"]
    s1, s3 = shard_map_value(m1, mesh), shard_map_value(m3, mesh)
    rows.append(("512^3 collide_with_marking, offset (3, -2, 1) (K2 per run of slabs)",
                 time_ms(lambda: s1.collide_with_marking(s3, 0.5, (3, -2, 1)), 10),
                 time_ms(lambda: m1.collide_with_marking(m3, 0.5, (3, -2, 1)), 10)))
    bits = BitVectorVoxelMap.create(SV_DIMS, SV_SIDE, device=dev)
    sbits = shard_map_value(bits, mesh)
    rows.append(("UR10 insert_robot_configuration with the self-collision check, 256^3 bit map",
                 time_ms(lambda: sbits.insert_robot_configuration(md["arm"], True), 10),
                 time_ms(lambda: bits.insert_robot_configuration(md["arm"], True), 10)))
    obstacles, queries = (edt_obstacles() + 0.5).astype(np.float32), edt_queries()

    def edt_frame(m):
        field = m.insert_point_cloud(obstacles).jump_flood()
        return field.min_distance_to(queries), field.extract_distances()

    dm = DistanceVoxelMap.create(EDT_DIMS, 1.0, device=dev)
    sdm = shard_map_value(dm, mesh)
    rows.append(("BASELINE #4 512^3 distance map: insert, jump_flood, min_distance_to, extract_distances",
                 time_ms(lambda: edt_frame(sdm), 3, warmup=1), time_ms(lambda: edt_frame(dm), 3, warmup=1)))
    dist_map = DistanceVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev)
    sdist = shard_map_value(dist_map, mesh)

    def camera_frame(env, dmap):
        return dmap.merge_occupied(env.insert_depth_image(frame, sensor, carve_pool=POOL)).jump_flood()

    rows.append((f"256^3 camera -> distance field frame (P = {POOL}, merge_occupied, jump_flood)",
                 time_ms(lambda: camera_frame(sfresh, sdist), 10), time_ms(lambda: camera_frame(fresh, dist_map), 10)))
    return rows



def pyramid_form_timings(dev: torch.device, mesh, md: dict, out: dict, oc: dict) -> list:
    """(label, sharded ms, single-device ms) of path 9's hierarchy slab
    forms, each sharded call beside its single-device call on the same card
    (the host clock where the call reads the device)."""
    rows = []
    frame = torch.as_tensor(oc["paged_inputs"]["frame"], device=dev)
    sensor = PosedSensor(carve_poses()["bench"])
    for cls in (HierarchicalBitMap, HierarchicalProbMap):
        fresh = cls.create(HIER_DIMS, HIER_SIDE, device=dev)
        sfresh = shard_map_value(fresh, mesh)
        for pool in (1, POOL):
            rows.append((f"{HIER_DIMS[0]}^3 frame into a {cls.__name__}, carve_pool {pool}",
                         time_ms(lambda: sfresh.insert_depth_image(frame, sensor, pool), 10),
                         time_ms(lambda: fresh.insert_depth_image(frame, sensor, pool), 10)))
    c5 = oc["c5"]
    env = to_device(c5["env"], torch.float32, dev)
    fresh = HierarchicalBitMap.create(C5_DIMS, 1.0, device=dev)
    sfresh = shard_map_value(fresh, mesh)
    for box in (False, True):
        rows.append((f"{C5_DIMS[0]}^3 build from {C5_OBSTACLES} points, free_bounding_box {box}",
                     time_ms(lambda: sfresh.build(env, box), 3, warmup=1), time_ms(lambda: fresh.build(env, box), 3,
                                                                                   warmup=1)))
    states = to_device(c5["states"], torch.float32, dev)
    checkers = [HierarchicalValidityChecker(m, c5["arm"]) for m in (md["pyramids"]["c5"][0], c5["dense"])]
    rows.append((f"BASELINE #5 batch ({len(states)} states, device counts)",
                 *(time_ms(lambda: c.colliding_voxels_device(states), 20) for c in checkers)))
    prob, bit = md["pyramids"]["fusion"]["fused"][(1, "bench")]
    s_prob, s_bit = oc["fusion"]["fused"][(1, "bench")][:2]
    rows.append((f"{HIER_DIMS[0]}^3 octree x octree, level 0", time_ms(lambda: prob.collide_with(bit), 10),
                 time_ms(lambda: s_prob.collide_with(s_bit), 10)))
    origin = kinect_sensor().position
    rays = out["rays"]
    for cls in (HierarchicalBitMap, HierarchicalProbMap):
        fresh = cls.create(FUSION_DIMS, FUSION_SIDE, device=dev)
        sfresh = shard_map_value(fresh, mesh)
        rows.append((f"{FUSION_DIMS[0]}^3 {cls.__name__} DDA frame ({rays.shape[0]} rays)",
                     time_ms(lambda: sfresh.insert_point_cloud_with_free_space(rays, origin), 3, warmup=1),
                     time_ms(lambda: fresh.insert_point_cloud_with_free_space(rays, origin), 3, warmup=1)))
    arm = md["arm"]
    rows.append((f"UR10 insert_robot_configuration with the self-collision check, {HIER_DIMS[0]}^3 bit pyramid",
                 time_ms(lambda: bit.insert_robot_configuration(arm, True), 10),
                 time_ms(lambda: s_bit.insert_robot_configuration(arm, True), 10)))
    with tempfile.TemporaryDirectory() as tmp, host_reads():
        rows.append((f"extract_occupied_coords of the {HIER_DIMS[0]}^3 bit pyramid (host reads)",
                     time_ms(bit.extract_occupied_coords, 5, warmup=1),
                     time_ms(s_bit.extract_occupied_coords, 5, warmup=1)))
        rows.append((f"write_to_disk of the {HIER_DIMS[0]}^3 bit pyramid (host reads)",
                     time_ms(lambda: bit.write_to_disk(os.path.join(tmp, "a.bin")), 3, warmup=1),
                     time_ms(lambda: s_bit.write_to_disk(os.path.join(tmp, "b.bin")), 3, warmup=1)))
    return rows


def example(name: str):
    return importlib.import_module(f"gpu_voxels_tpu_torch.examples.{name}")


def run_example(name: str, dev: torch.device, count_syncs: bool = True, **kwargs) -> tuple:
    """One program's main(device=dev) on a fresh facade singleton: (its
    return value, its wall time in s, every kernel's launches in it, the
    host waits for the card that torch's sync debug mode reported in it).
    The programs read the card on purpose (their prints and returns), so
    the mode warns and the warnings are counted; without count_syncs (a
    program whose worker thread reads too) the mode stays at its default."""
    for kname, module, *_ in KERNELS:
        module.launches[kname] = 0
    GpuVoxels._instance = None
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cuda and count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            out = example(name).main(device=dev, **kwargs)
            if cuda:
                torch.cuda.synchronize()
        finally:
            wall = time.perf_counter() - t0
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught) if cuda and count_syncs else None
    return out, wall, {kname: module.launches[kname] for kname, module, *_ in KERNELS}, syncs


@contextlib.contextmanager
def vis_dir():
    """The publishers write into a temporary directory inside the block."""
    before = os.environ.get("GPU_VOXELS_VIS_DIR")
    path = tempfile.mkdtemp()
    os.environ["GPU_VOXELS_VIS_DIR"] = path
    try:
        yield path
    finally:
        if before is None:
            os.environ.pop("GPU_VOXELS_VIS_DIR", None)
        else:
            os.environ["GPU_VOXELS_VIS_DIR"] = before
        shutil.rmtree(path, ignore_errors=True)


@contextlib.contextmanager
def wrapped(module, attr: str, keep):
    """module.attr replaced by keep(real, *args, **kwargs) inside the block:
    the examples' own helpers hand their inner values to the checks."""
    real, own = getattr(module, attr), attr in vars(module)
    setattr(module, attr, lambda *args, **kwargs: keep(real, *args, **kwargs))
    try:
        yield
    finally:
        if own:
            setattr(module, attr, real)
        else:  # an inherited method
            delattr(module, attr)


def keeping(name: str, kept: list) -> contextlib.ExitStack:
    """The wrappers that keep a program's inner values in `kept`, in the
    order the program makes them: full_pipeline_demo's hierarchical probe,
    types collide, distance map with its clearance and the maps it draws;
    distance_kinect_demo's map and distance map of every frame; the FK
    programs' types collide, collides and drawn map. An empty stack for the
    other programs."""
    stack = contextlib.ExitStack()

    def keep_result(real, *args, **kwargs):
        kept.append(real(*args, **kwargs))
        return kept[-1]

    def keep_self(real, obj, *args, **kwargs):
        kept.append(obj)
        return keep_result(real, obj, *args, **kwargs)

    def keep_arg(real, obj, other, *args, **kwargs):
        kept.append(other)
        return real(obj, other, *args, **kwargs)

    wraps = {
        "full_pipeline_demo": ((vis_export, "write_html", lambda real, path, maps, *a, **k:
                                kept.append(dict(maps)) or real(path, maps, *a, **k)),
                               (HierarchicalValidityChecker, "colliding_voxels_device", keep_result),
                               (BitVectorVoxelMap, "collide_with_types", keep_result),
                               (DistanceVoxelMap, "min_distance_to", keep_self)),
        "distance_kinect_demo": ((DistanceVoxelMap, "merge_occupied", keep_arg),
                                 (DistanceVoxelMap, "min_distance_to", keep_self)),
        "swept_volume_vs_environment": ((BitVectorVoxelMap, "collide_with_types", keep_result),),
        "urdf_loader": ((BitVectorVoxelMap, "collide_with", keep_self),),
        "tf_interface_demo": ((GpuVoxels, "visualize_map", lambda real, gvl, map_name, *a, **k:
                               kept.append(gvl.get_map(map_name)) or real(gvl, map_name, *a, **k)),),
    }
    for module, attr, keep in wraps.get(name, ()):
        stack.enter_context(wrapped(module, attr, keep))
    return stack


def same_values(x, y) -> bool:
    """Two kept values are equal bit for bit: tensors, maps (their data and
    occupancy tensors), and lists, tuples and dicts of them."""
    if isinstance(x, torch.Tensor):
        return isinstance(y, torch.Tensor) and torch.equal(x, y)
    if isinstance(x, (list, tuple)):
        return len(x) == len(y) and all(same_values(a, b) for a, b in zip(x, y))
    if isinstance(x, dict):
        return x.keys() == y.keys() and all(same_values(x[k], y[k]) for k in x)
    if hasattr(x, "data") and isinstance(x.data, torch.Tensor):
        return type(x) is type(y) and same_values(x.data, y.data) and same_values(getattr(x, "occ", None),
                                                                                  getattr(y, "occ", None))
    return x == y


def replay_frames(dev: torch.device, base) -> tuple:
    """robot_vs_environment's recording (8 frames) through frame_step, one
    after the other, with the loop's joint values: (env, rob, counts)."""
    ex = example("robot_vs_environment")
    dims, side, sensor, _, _ = ex.scene(dev)
    frames = ex.make_frames(sensor, device=dev)
    robot = ex.make_robot(0.45 * dims[0] * side, device=dev)
    base = to_device(np.asarray(base, np.float32), torch.float32, dev)
    joints = to_device(np.array([[i * 0.1, i * 0.05] for i in range(len(frames))], np.float32), torch.float32, dev)
    env, counts = ProbVoxelMap.create(dims, side, device=dev), []
    for i, depth in enumerate(frames):
        env, rob, cnt = ex.frame_step(env, depth, joints[i], sensor, robot, base, dims, side)
        counts.append(cnt)
    return env, rob, torch.stack(counts)


def box_keys(side: float, dims) -> np.ndarray:
    """The planner scene's box voxels (the facade's inserts: points every
    half voxel), as sorted linear keys: a numpy set oracle."""
    keys = []
    for lo, hi in PLAN_BOXES:
        cells = np.floor(generation.create_box_of_points(lo, hi, side / 2) * np.float32(1.0 / side)).astype(np.int64)
        keys.append(cell_keys(cells, dims))
    return np.unique(np.concatenate(keys))


def cell_keys(cells: np.ndarray, dims) -> np.ndarray:
    inside = ((cells >= 0) & (cells < np.asarray(dims))).all(axis=1)
    c = cells[inside]
    return (c[:, 2] * dims[1] + c[:, 1]) * dims[0] + c[:, 0]


def examples_path(dev: torch.device) -> dict:
    """Path 10: every program of gpu_voxels_tpu_torch/examples/ on the card
    through its main(), its launches counted alone; the inner values the
    checks need are kept by wrapping the programs' own helpers."""
    ex = {"runs": {}, "launches": {}, "kept": {}}
    with vis_dir():
        for name in sorted(EX_KERNELS):
            kwargs, kept = {}, []
            if name == "swept_fitter":
                kwargs = dict(EX_FIT, verbose=False)
                ctx = wrapped(example(name), "fit", lambda real, robots, *a, **k: kept.append(
                    (robots, real(robots, *a, **k))) or kept[-1][1])
            elif name == "ompl_planner_app":
                kwargs = {"rounds": EX_PLAN_ROUNDS}

                def keep_solution(real, gvl, robot, states):
                    n = real(gvl, robot, states)
                    kept.append({"env": gvl.get_map("myEnvironmentMap"), "robot": robot, "states": states,
                                 "solution": int(gvl.get_map("mySolutionMap").count)})
                    return n

                ctx = wrapped(example(name), "visualize_solution", keep_solution)
            else:
                ctx = keeping(name, kept)
            with ctx:
                out, wall, launches, syncs = run_example(name, dev, **kwargs)
            ex["runs"][name] = {"out": out, "wall": wall, "syncs": syncs}
            ex["launches"][name] = launches
            ex["kept"][name] = kept
        for kname, module, *_ in KERNELS:
            module.launches[kname] = 0
        torch.cuda.set_sync_debug_mode("error")  # the frame itself never waits for the device
        try:
            ex["replay"] = [replay_frames(dev, base) for base in EX_REPLAY_BASES]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ex["launches"]["frame_step replay"] = {kname: module.launches[kname] for kname, module, *_ in KERNELS}
    return ex


def drive_examples(dev: torch.device) -> tuple[dict, dict]:
    """Path 10 with its launches: each program's counted alone (its kernels
    must launch), the replay's by drive()'s rule; the path's total."""
    ex = examples_path(dev)
    total = {name: 0 for name, *_ in KERNELS}
    for name, launches in ex["launches"].items():
        add_launches(total, launches)
        missing = EX_KERNELS.get(name, EX_KERNELS_REPLAY) - {k for k, n in launches.items() if n}
        assert not missing, f"{name} launched none of {missing}"
    for kname, module, *_ in KERNELS:
        module.launches[kname] = 0
    with plain_route():
        ex["replay_plain"] = [replay_frames(dev, base) for base in EX_REPLAY_BASES]
        ex["plain"] = {}
        for name in EX_HELD_PLAIN:
            kept = []
            with keeping(name, kept):
                ex["plain"][name] = (run_example(name, dev)[0], kept)
    return ex, total


def check_examples_path(ex: dict, dev: torch.device) -> None:
    cpu = torch.device("cpu")
    runs = ex["runs"]
    for name in sorted(set(EX_KERNELS) - set(EX_SIZED_BY_DEVICE) - set(EX_FK)):
        out = runs[name]["out"]
        cpu_out, runs[name]["cpu_wall"], _, _ = run_example(name, cpu)
        assert out == cpu_out, (name, out, cpu_out)
        log(f"  (ex) {name}: card {out!r} == CPU copy")
    for name in EX_HELD_PLAIN:
        out, kept = runs[name]["out"], ex["kept"][name]
        plain, plain_kept = ex["plain"][name]
        assert out == plain and len(kept) > 0 and same_values(kept, plain_kept), name
        log(f"  (ex) {name}: card {out!r} and its {len(kept)} inner values (maps, counts, distances) == the plain "
            f"route on the card, bit for bit")

    # the live loop at its card scene, and its frame replayed
    out = runs["robot_vs_environment"]["out"]
    assert out["processed"] >= 1 and len(out["counts"]) == out["processed"], out
    dims, _, sensor, n_frames, _ = example("robot_vs_environment").scene(dev)
    for (env, rob, counts), (p_env, p_rob, p_counts) in zip(ex["replay"], ex["replay_plain"]):
        assert torch.equal(env.data, p_env.data) and same_map(rob, p_rob) and torch.equal(counts, p_counts)
    counts = [c.tolist() for _, _, c in ex["replay"]]
    assert dev.type != "cuda" or min(counts[1]) > 0, counts  # in the box face the arm collides every frame
    log(f"  (ex) robot_vs_environment: {out['processed']} of {n_frames} frames of {sensor.data_width}x"
        f"{sensor.data_height} into {dims[0]}^3 processed; frame_step over the 8-frame recording (sync debug mode "
        f"'error') == plain route, maps and counts {counts}")

    # swept_fitter at 256^3: the searches again on the same maps, plain route
    n_solutions, delay = runs["swept_fitter"]["out"]
    (robots, solutions), = ex["kept"]["swept_fitter"]
    centres = [dict(maps)[t] for (_, maps), t in zip(robots, ("A_reach_center", "B_reach_center"))]
    with plain_route():
        p_solutions = fit_orderings(robots, all_solutions=True)
        p_delays = deconflict_slot(centres, margin=2, stride=4)
    assert n_solutions == len(solutions) == 2 and delay > 0 and p_solutions == solutions and p_delays == [0, delay]
    log(f"  (ex) swept_fitter at {EX_FIT['dims'][0]}^3: orderings {solutions}, start delay {delay} == plain route")

    # ompl_planner_app, three rounds: every solution against a numpy set oracle
    successes = runs["ompl_planner_app"]["out"]
    kept = ex["kept"]["ompl_planner_app"]
    assert successes == len(kept) >= 1, (successes, len(kept))
    dims, side = PLAN_DIMS, PLAN_SIDE
    boxes = box_keys(side, dims)
    for k in kept:
        assert np.array_equal(np.flatnonzero(k["env"].occupied_mask(0.7).cpu().numpy()), boxes)
        pts = k["robot"].transformed_clouds_for(to_device(k["states"], torch.float32, dev)).points.cpu().numpy()
        keys = [cell_keys(np.floor(p * np.float32(1.0 / side)).astype(np.int64), dims) for p in pts]
        assert not any(np.isin(kk, boxes).any() for kk in keys)
        assert k["solution"] == len(np.unique(np.concatenate(keys)))
    log(f"  (ex) ompl_planner_app: {successes} of {EX_PLAN_ROUNDS} rounds solved; every interpolated state "
        f"({[len(k['states']) for k in kept]}) clear of the boxes' voxels and the solution lists "
        f"({[k['solution'] for k in kept]} voxels) == a numpy set oracle")



def examples_timings(dev: torch.device, smi: str, ex: dict) -> None:
    """Path 10's wall times (host clock, one run each, the card's beside the
    CPU copy's where there is one) and the live loop's rates: at its
    defaults (60 frames from a 60 Hz source) from phase 3, and under the
    accelerator contract of tests_tpu/test_examples_tpu.py:38-56 (90 frames,
    the async publish) here, which is asserted: >= 80 frames processed at
    >= 30 Hz, each provider painting in the loop."""
    for name, run in sorted(ex["runs"].items()):
        cpu = f", CPU copy {run['cpu_wall'] * 1e3:.1f} ms" if "cpu_wall" in run else ""
        log(f"  path 10 {name}: {run['wall'] * 1e3:.1f} ms on the card{cpu} (host clock); {run['syncs']} host waits "
            f"for the card reported by the sync debug mode  [{smi}]")
    out = ex["runs"]["robot_vs_environment"]["out"]
    n_frames = example("robot_vs_environment").scene(dev)[3]
    log(f"  path 10 robot_vs_environment at its defaults: {out['processed']} of {n_frames} frames processed, "
        f"{out['sustained_hz']:.2f} Hz sustained  [{smi}]")
    with vis_dir():
        out = run_example("robot_vs_environment", dev, count_syncs=False, **EX_CONTRACT)[0]
    log(f"  path 10 robot_vs_environment, the 30 Hz contract (90 frames, 60 Hz source, live_vis): "
        f"{out['processed']} processed, {out['sustained_hz']:.2f} Hz sustained, snapshots painted in the loop "
        f"(env, robot) {out['painted']}  [{smi}]")
    assert out["processed"] >= 80 and out["sustained_hz"] >= 30.0, f"the live loop's 30 Hz contract is missed: {out}"
    assert len(out["counts"]) == out["processed"] and min(out["painted"]) >= 1, out


# -- phase 4 ------------------------------------------------------------------
def timed_once(fn):
    """(fn(), its time in ms by CUDA events): one call, no warm-up, for the
    calls that take seconds and whose result a check reads."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return result, start.elapsed_time(end)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_rows(fn, iters: int) -> list:
    """torch.profiler's device rows (kernels, memsets, copies) over `iters`
    calls of fn, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_ms(fn, iters: int) -> float:
    """The device's busy time per call of fn. Where the host takes longer to
    issue a call than the device takes to run it, CUDA events over
    back-to-back calls time the host; this does not."""
    return sum(e.self_device_time_total for e in device_rows(fn, iters)) / 1e3 / iters


def in_turns(kernel, plain, iters: int) -> tuple[float, float]:
    """plain, kernel, kernel, plain: the means of each pair."""
    p1 = time_ms(plain, iters)
    k1 = time_ms(kernel, iters)
    k2 = time_ms(kernel, iters)
    p2 = time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k4_bound(a, b, margin: int, mark: bool, occ_a=None, occ_b=None, b_valid=None) -> tuple[float, str]:
    """K4's least time on these inputs: the gates read once (1 B a voxel
    each); a's and b's 32 B for every live voxel (k4_live_mask and the
    mask), and a's plane-0 word for the voxels whose liveness waits on a's
    eBVM_FREE bit; with a mark a is read and the new map written whole (32
    B each a voxel), b's words for the live voxels only. The window's ops
    count for the live voxels."""
    n = a.shape[1]
    live = torch.ones(n, dtype=torch.bool, device=a.device)
    gates, free_only = 0, 0
    if occ_a is not None:
        live = collide_cuda.k4_live_mask(a, occ_a, occ_b, margin)
        gates += 2
        if margin >= 4:
            free_only = int(((occ_b != 0) & (occ_a == 0)).sum())
    if b_valid is not None:
        live = live & b_valid
        gates += 1
    n_live = int(live.sum())
    planes = 64 * n + 32 * n_live if mark else 64 * n_live + 4 * free_only
    return bound(gates * n + planes + 40, n_live * (32 * window_rounds(margin) + 35))


def k4_timings(smi: str, robot: dict) -> tuple[tuple[float, float], tuple[float, str]]:
    """K4 at the main path's data: the UR10 sweep against its environment at
    256^3, window 5, gated by both summaries: with a mark (beside the copy
    of a alone, its floor), count only, and the same calls without the
    summaries. Returns the marking call's (kernel, plain) times and its
    bound."""
    a, b, oa, ob = robot["sweep"].data, robot["env"].data, robot["sweep"].occ, robot["env"].occ
    live = int(collide_cuda.k4_live_mask(a, oa, ob, 5).sum())
    mark = in_turns(lambda: collide_cuda.collide_types_bit_bit(a, b, 5, True, oa, ob),
                    lambda: collide_cuda.collide_types_bit_bit_plain(a, b, 5, True), 10)
    copy_alone = time_ms(lambda: a.clone(), 10)
    count = in_turns(lambda: collide_cuda.collide_types_bit_bit(a, b, 5, False, oa, ob),
                     lambda: collide_cuda.collide_types_bit_bit_plain(a, b, 5, False), 20)
    count_dev = device_ms(lambda: collide_cuda.collide_types_bit_bit(a, b, 5, False, oa, ob), 20)
    ungated = (time_ms(lambda: collide_cuda.collide_types_bit_bit(a, b, 5, True), 10),
               time_ms(lambda: collide_cuda.collide_types_bit_bit(a, b, 5, False), 20))
    mark_bound, count_bound = k4_bound(a, b, 5, True, oa, ob), k4_bound(a, b, 5, False, oa, ob)
    log(f"  collide_types_bit_bit at the UR10 sweep x environment ({SV_DIMS[0]}^3, window 5, {live} live voxels of "
        f"{a.shape[1]}, gated by the summaries): mark kernel {mark[0]:.4f} ms (the copy, then the gated pass; the "
        f"copy alone {copy_alone:.4f} ms), plain torch {mark[1]:.4f} ms, gated bound {mark_bound[0]:.4f} ms "
        f"({mark_bound[1]}); count only kernel {count[0]:.4f} ms (device time {count_dev:.4f} ms), plain torch "
        f"{count[1]:.4f} ms, gated bound {count_bound[0]:.4f} ms ({count_bound[1]}); without the summaries: mark "
        f"{ungated[0]:.4f} ms, count only {ungated[1]:.4f} ms  [{smi}]")
    return mark, mark_bound


def window_rounds(margin: int) -> int:
    """Doubling rounds of K4's window (csrc/collide_types.cu)."""
    rounds, covered = 0, 1
    while covered < margin + 1:
        covered += min(covered, margin + 1 - covered)
        rounds += 1
    return rounds


def search_length(d: torch.Tensor, axis: int) -> float:
    """The mean rows per voxel that a search outward from each voxel,
    stopping once r^2 exceeds its best, reads for a pass whose output is
    `d` (r = 0..R on both sides of its row, R = the integer root of its
    result, or the rows left when it finds no site): the work of K5's first
    form, which the linear envelope replaced."""
    n = d.shape[axis]
    shape = [1, 1, 1]
    shape[axis] = n
    y = torch.arange(n, device=d.device).view(shape)
    rmax = torch.maximum(y, n - 1 - y)
    root = torch.floor(torch.sqrt(d.to(torch.float64))).to(torch.int64)
    r = torch.where(d >= edt_envelope.MISS, rmax, torch.minimum(root, rmax))
    return float((torch.minimum(y, r) + torch.minimum(n - 1 - y, r) + 1).to(torch.float64).mean())


def time_k5(smi: str, packed: torch.Tensor, dims, plain: bool) -> tuple[float, float]:
    """K5 per pass (Y, then X on the Y pass's output) on a map's phase-1
    grids, and the plain version once per pass; the means per pass."""
    g1, pay1 = edt_envelope.flood_z(packed, dims)
    d2, p2 = edt_cuda.envelope_pass(g1, pay1, 1)
    # the linear envelope's work per line grows with its sites
    sites_y = float((g1 < edt_envelope.MISS).to(torch.float64).mean())
    sites_x = float((d2 < edt_envelope.MISS).to(torch.float64).mean())
    ms_y = time_ms(lambda: edt_cuda.envelope_pass(g1, pay1, 1), 10)
    ms_x = time_ms(lambda: edt_cuda.envelope_pass(d2, p2, 2), 10)
    d3, _ = edt_cuda.envelope_pass(d2, p2, 2)
    plain_y = time_ms(lambda: edt_cuda.envelope_pass_plain(g1, pay1, 1), 1, warmup=1) if plain else float("nan")
    plain_x = time_ms(lambda: edt_cuda.envelope_pass_plain(d2, p2, 2), 1, warmup=1) if plain else float("nan")
    n = g1.numel()
    log(f"  envelope_pass at {dims[0]}^3: Y pass {ms_y:.4f} ms, X pass {ms_x:.4f} ms; plain torch Y {plain_y:.4f} ms, "
        f"X {plain_x:.4f} ms; bound {bound(16 * n, 0)[0]:.4f} ms per pass (bytes); sites per position Y "
        f"{sites_y:.4f}, X {sites_x:.4f}; an outward search would read Y {search_length(d2, 1):.2f}, "
        f"X {search_length(d3, 2):.2f} rows per voxel  [{smi}]")
    return (ms_y + ms_x) / 2, (plain_y + plain_x) / 2


def timings(dev: torch.device, smi: str, out: dict, robot: dict, dist: dict, fit: dict) -> tuple[dict, dict]:
    g = torch.Generator(device=dev).manual_seed(99)
    n = CYCLE_DIMS[0] * CYCLE_DIMS[1] * CYCLE_DIMS[2]
    a = torch.randint(-128, 128, (n,), dtype=torch.int8, device=dev, generator=g)
    b = torch.randint(-128, 128, (n,), dtype=torch.int8, device=dev, generator=g)
    t, bounds = {}, {}
    t["count_prob_prob"] = in_turns(
        lambda: collide_cuda.count_prob_prob(a, b, -120, 0),
        lambda: collide_cuda.count_prob_prob_plain(a, b, -120, 0), 50)
    # reads a and b once; per voxel 2 compares, an AND and an add
    bounds["count_prob_prob"] = bound(2 * n + 8, 4 * n)
    t["count_and_mark_prob"] = in_turns(
        lambda: collide_cuda.count_and_mark_prob(a, b, -120, 0),
        lambda: collide_cuda.count_and_mark_prob_plain(a, b, -120, 0), 30)
    # also writes the marked map; one select more per voxel
    bounds["count_and_mark_prob"] = bound(3 * n + 8, 5 * n)
    del a, b
    depth = torch.as_tensor(bench_frame(), device=dev)
    pose = torch.as_tensor(carve_poses()["bench"], device=dev)
    t["projective_free_space_exact"] = in_turns(
        lambda: raycast_cuda.projective_free_space_exact(depth, pose, *INTR, FUSION_SIDE, FUSION_DIMS),
        lambda: raycast_cuda.projective_free_space_plain(depth, pose, *INTR, FUSION_SIDE, FUSION_DIMS), 30)
    nf = FUSION_DIMS[0] * FUSION_DIMS[1] * FUSION_DIMS[2]
    # writes the mask, reads the frame and the pose; per voxel 33 f32 ops
    # (centre, rotation, projection with two IEEE divisions, counted as one
    # op each, two floors, the depth test)
    bounds["projective_free_space_exact"] = bound(nf + depth.numel() * 4 + 64, 33 * nf)

    ns = SV_DIMS[0] * SV_DIMS[1] * SV_DIMS[2]
    # K4 at the main path's data (the UR10 sweep against its environment,
    # gated by both summaries; the JSON line's row), then on dense random maps
    t["collide_types_bit_bit"], bounds["collide_types_bit_bit"] = k4_timings(smi, robot)
    # the fitter's bit checks: the two centre sweeps at 256^3 (0.015 m), with
    # their summaries (gated) and as raw planes (ungated)
    pair = [fit["robots"][r][1][0][1] for r in (0, 1)]
    raw = [fit["robots_raw"][r][1][0][1] for r in (0, 1)]
    fit_k4 = (time_ms(lambda: pair[0].collide_with_bitcheck(pair[1], FIT_WINDOW), 20),
              time_ms(lambda: raw[0].collide_with_bitcheck(raw[1], FIT_WINDOW), 20))
    fit_bound = k4_bound(pair[0].data, pair[1].data, FIT_WINDOW, False, pair[0].occ, pair[1].occ)
    log(f"  the fitter's bit check (the two centre sweeps, margin {FIT_WINDOW}): {fit_k4[0]:.4f} ms gated by the "
        f"summaries, gated bound {fit_bound[0]:.4f} ms ({fit_bound[1]}); {fit_k4[1]:.4f} ms on raw planes  [{smi}]")
    ga, gb = dense_bits(dev, ns, g), dense_bits(dev, ns, g)
    k4_dense = in_turns(
        lambda: collide_cuda.collide_types_bit_bit(ga, gb, 5, True),
        lambda: collide_cuda.collide_types_bit_bit_plain(ga, gb, 5, True), 10)
    # ungated: reads 64 B and writes 32 B per voxel; per voxel 16 shifts and
    # ORs per window round and direction, plus 35 for the mask, the window's
    # halves, the record, the hit, the count and the meanings
    k4_ops = ns * (32 * window_rounds(5) + 35)
    k4_dense_bound = bound(96 * ns + 40, k4_ops)
    k4_nomark = in_turns(
        lambda: collide_cuda.collide_types_bit_bit(ga, gb, 5, False),
        lambda: collide_cuda.collide_types_bit_bit_plain(ga, gb, 5, False), 10)
    # K7 reads 64 B per voxel pair; per pair 2 masks, 14 ORs, 2 compares, an
    # AND and an add
    t["count_bit_bit"] = in_turns(
        lambda: collide_cuda.count_bit_bit(ga, gb),
        lambda: collide_cuda.count_bit_bit_plain(ga, gb), 20)
    bounds["count_bit_bit"] = bound(64 * ns + 8, 20 * ns)
    # an offset of one voxel: the slices' addresses differ mod 16 (4-byte loads)
    k7_scalar = in_turns(
        lambda: collide_cuda.count_bit_bit(ga, gb, SV_DIMS, (1, 0, 0)),
        lambda: collide_cuda.count_bit_bit_plain(ga, gb, SV_DIMS, (1, 0, 0)), 20)
    del ga, gb
    for name, (k, p) in t.items():
        log(f"  {name}: kernel {k:.4f} ms, plain torch {p:.4f} ms, bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]})  [{smi}]")
    nomark_bound = bound(64 * ns + 40, k4_ops)[0]
    log(f"  collide_types_bit_bit on dense random 256^3 maps (no summaries), window 5: mark kernel "
        f"{k4_dense[0]:.4f} ms, plain torch {k4_dense[1]:.4f} ms, bound {k4_dense_bound[0]:.4f} ms "
        f"({k4_dense_bound[1]}); count only kernel {k4_nomark[0]:.4f} ms, plain torch {k4_nomark[1]:.4f} ms, "
        f"bound {nomark_bound:.4f} ms (bytes)  [{smi}]")
    log(f"  count_bit_bit at 256^3, offset (1, 0, 0) (4-byte loads): kernel {k7_scalar[0]:.4f} ms, plain torch "
        f"{k7_scalar[1]:.4f} ms, bound {bounds['count_bit_bit'][0]:.4f} ms (bytes)  [{smi}]")
    ga, gb = dense_bits(dev, n, g), dense_bits(dev, n, g)  # 512^3: 8.6 GB of planes
    k7_big = in_turns(lambda: collide_cuda.count_bit_bit(ga, gb), lambda: collide_cuda.count_bit_bit_plain(ga, gb), 5)
    log(f"  count_bit_bit at 512^3: kernel {k7_big[0]:.4f} ms, plain torch {k7_big[1]:.4f} ms, "
        f"bound {bound(64 * n + 8, 20 * n)[0]:.4f} ms (bytes)  [{smi}]")
    del ga, gb
    torch.cuda.empty_cache()

    pts = out["cycle_pts"]

    def cycle():
        m1 = ProbVoxelMap.create(CYCLE_DIMS, 1.0, device=dev).insert_point_cloud(pts)
        m2 = ProbVoxelMap.create(CYCLE_DIMS, 1.0, device=dev).insert_point_cloud(pts + 1.0)
        return m1.collide_with(m2, 0.5)

    cycle_ms = time_ms(cycle, 20)
    log(f"  512^3 insert->insert->collide cycle (2 x 307,200 points): {cycle_ms:.4f} ms = "
        f"{1000.0 / cycle_ms:.2f} Hz  [{smi}]")
    sensor = kinect_sensor()
    frame = torch.as_tensor(out["frames"][0], device=dev)  # pre-staged on the card
    fresh = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev)
    fuse_ms = time_ms(lambda: fresh.insert_depth_image(frame, sensor), 20)
    log(f"  256^3 fusion of one 640x480 frame (exact carve): {fuse_ms:.4f} ms = "
        f"{1000.0 / fuse_ms:.2f} Hz  [{smi}]")

    placed, cfgs, env = robot["placed"], robot["cfgs"], robot["env"]

    def trajectory():
        sweep = insert_swept_volume_batched(BitVectorVoxelMap.create(SV_DIMS, SV_SIDE, device=dev), placed, cfgs)
        return sweep.collide_with_types(env, 1.0, 5)

    sv_ms = time_ms(trajectory, 10)
    log(f"  UR10 64-step swept volume at 256^3 (FK, insert, types collide window 5): {sv_ms:.4f} ms "
        f"per trajectory  [{smi}]")

    # K5: per pass at 512^3 (BASELINE #4's obstacles; the JSON line's shape)
    # and at 256^3 (the fused camera map); reads g and the payload, writes
    # both: 16 B per voxel and pass. A linear-time envelope exists, so no
    # operation count sets a higher floor.
    obstacles = DistanceVoxelMap.create(EDT_DIMS, 1.0, device=dev).insert_point_cloud(
        (edt_obstacles() + 0.5).astype(np.float32))
    t["envelope_pass"] = time_k5(smi, obstacles.data, EDT_DIMS, plain=True)
    bounds["envelope_pass"] = bound(16 * obstacles.voxelmap_size, 0)
    time_k5(smi, dist["merged"].data, FUSION_DIMS, plain=True)
    # K6 at P = 8: the pool reads the frame once and writes the table, with
    # 3 ops per pixel (the invalid test, its select, the min); the carve is
    # K3's projection (33 f32 ops per voxel) against the table and writes the
    # mask; the wrapper is the two in turn (its table is internal)
    carve_args = (pose, *INTR, FUSION_SIDE, FUSION_DIMS)
    pool, pool_plain = (lambda: raycast_cuda.min_pool_depth(depth, POOL),
                        lambda: raycast_cuda.min_pool_depth_plain(depth, POOL))
    # the pool's few microseconds are less than the wrapper's host time:
    # its kernel time is the profiler's device time, the events time the host
    pool_events = in_turns(pool, pool_plain, 50)
    t["min_pool_depth"] = device_ms(pool, 50), device_ms(pool_plain, 50)
    table = raycast_cuda.min_pool_depth(depth, POOL)
    bounds["min_pool_depth"] = bound(depth.numel() * 4 + table.numel() * 4, 3 * depth.numel())
    carve_alone = in_turns(
        lambda: raycast_cuda.carve_against_pooled(table, POOL, depth.shape, *carve_args),
        lambda: raycast_cuda.carve_against_pooled_plain(table, POOL, depth.shape, *carve_args), 30)
    carve_bound = bound(nf + table.numel() * 4 + 64, 33 * nf)
    t["projective_free_space_pooled"] = in_turns(
        lambda: raycast_cuda.projective_free_space_pooled(depth, *carve_args, pool=POOL),
        lambda: raycast_cuda.projective_free_space_pooled_plain(depth, *carve_args, pool=POOL), 30)
    bounds["projective_free_space_pooled"] = bound(nf + depth.numel() * 4 + 64, 33 * nf + 3 * depth.numel())
    for name in ("envelope_pass", "min_pool_depth", "projective_free_space_pooled"):
        k, p = t[name]
        log(f"  {name}: kernel {k:.4f} ms, plain torch {p:.4f} ms, bound {bounds[name][0]:.4f} ms "
            f"({bounds[name][1]})  [{smi}]")
    log(f"  min_pool_depth by CUDA events over back-to-back calls (the host's time per call): kernel "
        f"{pool_events[0]:.4f} ms, plain torch {pool_events[1]:.4f} ms  [{smi}]")
    log(f"  K6 carve alone on a prebuilt P={POOL} table: kernel {carve_alone[0]:.4f} ms, plain torch "
        f"{carve_alone[1]:.4f} ms, bound {carve_bound[0]:.4f} ms ({carve_bound[1]})  [{smi}]")

    edt_ms = time_ms(lambda: obstacles.parallel_banding(), 5)
    log(f"  BASELINE #4 exact EDT at 512^3 (20,000 obstacles): {edt_ms:.4f} ms  [{smi}]")
    fresh = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev)

    def camera_frame():
        env = fresh.insert_depth_image(frame, sensor, carve_pool=POOL)
        return DistanceVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).merge_occupied(env).jump_flood()

    cam_ms = time_ms(camera_frame, 10)
    log(f"  256^3 camera -> distance field frame (pooled carve P={POOL}, merge_occupied, jump_flood): "
        f"{cam_ms:.4f} ms = {1000.0 / cam_ms:.2f} Hz  [{smi}]")

    # the trajectory-scheduling path: the searches read counts on the host
    search_raw = time_ms(lambda: fit_orderings(fit["robots_raw"], all_solutions=True), 10)
    search_sum = time_ms(lambda: fit_orderings(fit["robots"], all_solutions=True), 10)
    centers = [fit["robots_raw"][r][1][0][1] for r in (0, 1)]
    slot_ms = time_ms(lambda: deconflict_slot(centers, margin=FIT_WINDOW, stride=4), 5)
    log(f"  fit_orderings over 2 UR10s x 2 trajectories at {FIT_DIMS[0]}^3: {search_raw:.4f} ms per search on raw "
        f"planes (K7), {search_sum:.4f} ms on occupancy summaries; deconflict_slot (margin {FIT_WINDOW}, stride 4, "
        f"delays {fit['raw']['delays']}): {slot_ms:.4f} ms  [{smi}]")
    fresh = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev)
    rays = out["rays"]
    dda_ms = time_ms(lambda: fresh.insert_sensor_data(rays, sensor_origin=sensor.position), 5, warmup=1)
    log(f"  256^3 DDA insert_sensor_data of one frame ({rays.shape[0]} rays, 256 steps): {dda_ms:.4f} ms = "
        f"{1000.0 / dda_ms:.2f} Hz  [{smi}]")
    return t, bounds


def main() -> int:
    dev, smi = card()
    log("phase 1: build")
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.library()
    log(f"  built {path.name} in {time.perf_counter() - t0:.2f} s")
    log("phase 2: kernels against their plain versions (exact)")
    err = check_kernels(dev)
    log("phase 3: the paths through the entry points")
    out, robot, dist, fit, lp, plan, oc, fp, md, ex, launches = drive_main_path(dev)
    log("phase 4: times (CUDA events)")
    t, bounds = timings(dev, smi, out, robot, dist, fit)
    list_timings(dev, smi, lp, plan)
    octree_timings(dev, smi, oc)
    facade_timings(dev, smi, fp)
    multidevice_timings(dev, smi, md, out, robot, dist, oc)
    examples_timings(dev, smi, ex)
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": t[name][0], "plain_ms": t[name][1], "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         # no single PyTorch call computes any of these functions: K1/K2 are
         # a compare-and-count, K3 and K6 projective carves, K4 a windowed bit
         # collide, K5 a min-plus envelope, K7 a fold-and-count (>= 10 calls),
         # K6's pool a select then a min over a padded frame
         "library_ms": None}
        for name, _module, source, replaces in KERNELS
    ]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
