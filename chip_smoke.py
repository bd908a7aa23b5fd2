#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cheetah_tpu_torch``) on one NVIDIA card.

Run from the root of the repository with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels from ``cheetah_tpu_torch/csrc`` with nvcc (one
process per source, all at once, reporting ptxas's registers per kernel),
holds each kernel against its plain PyTorch version on the card (and the
tile plan's counting sort against ``torch.sort``), the deposits on every
route their wrappers pick and on a crowded beam, times the gathers at the
order sets the paths use and the deposits at C = 1 and 3, drives the paths
of the port through the
public entry points (the ARES EA env step and the 1M-particle space-charge
segment, forward and with their gradients, the latter on the 32^3 grid of
the untiled kernels and the 128^3 grid of the x-tiled ones), checks them
against the port's own float64 run on the CPU and a float64 finite
difference on the card, and times kernels and paths with CUDA events.
Then the diagnostics paths, which run no hand-written kernel: the env step
with a ``ParameterBeam``, ``Segment.track_moments``, the AREABSCR1 screen
read through ``track_with_readings`` (histogram, cloud-in-cell, KDE at
binning 8 and on its window at binning 1, 100k particles on 2448 x 2040
pixels) and the gradient of the screen's centroid, each against a float64
run of the port, with the CIC kernels' launch counts (all 0). Then the
nonlinear slice, which runs no hand-written kernel either: BASELINE config
3 (cavity, drift-kick-drift dipole, second-order sextupole) at 100k
particles and its gradients with respect to k2, the dipole angle and the
cavity's voltage and phase, against the same chain in float64 on the card
and a float64 central difference; and ``torch.func`` (``jvp``, ``grad``,
``vmap``) through the 32^3 space-charge kick, on the kernels and never on
their plain versions. Last the seventh slice, no hand-written kernel
either: the full ARES stage-3 lattice (``lattices.ares_stage3``, 195
elements) at 100k particles in linear, second-order and drift-kick-drift
mode and with a ``ParameterBeam``, timed eagerly and by CUDA graph with
its launches and idle share, checked with seeded magnets against the
port's float64 CPU run, with the gradient of sigma_x by a quadrupole's k1;
and the remaining elements (Solenoid, Undulator, CombinedCorrector, RBend
in three methods, the transverse deflecting cavity, a merged
CustomTransferMap, a Superimposed BPM) against the same float64 run.
Then the eighth slice: a space-charge line built by the structure
operations (``lattices.cold_beam_line``: a drift split into 20 pieces, 10
kicks between them, the neighbouring pieces merged), on 32^3 (untiled
kernels) and 128^3 (x-tiled kernels), 1M particles: the cold beam's
doubling, the gradient by ``track`` and by ``track_checkpointed`` with
the launches forward, backward and in the recompute, peak memory at 2 and
10 kicks both ways, and eager and graph times.
Then the multi-device slice, on a ``torch.distributed`` process group of
one rank over NCCL: ``BatchedLatticeEnv`` at BASELINE config 5's width
(4096 instances of the five ARES EA tunables, 10k particles) against
``segment.track`` with the same settings and the port's float64 CPU run,
its ``grad_step`` and ``moments_only`` step; and the space-charge
gradient with both kicks over a particle axis, whose all-reduces launch,
on 32^3 and 128^3, against the unsharded run with the collectives' bytes
audited; last two processes over gloo on the one card (NCCL refuses two
ranks on one device), each with half the instances and half the
particles, against the one-process run.
Last the tenth slice: the ARES linac imported from its NX Tables export
(``Segment.from_nx_tables``, 226 elements) with seeded magnets, and the
Elegant FODO and cavity lattices and the Bmad tutorial lattice, at 1M
float32 particles against the port's float64 CPU run, the import through
LatticeJSON and back, with eager and graph time, launches and idle share;
the 1M beam through openPMD and back onto the card (a file where h5py is
installed, the openPMD records in memory where it is not) and then
through the 32^3 space-charge segment; the env step exported with
``torch.export`` (the particle axis symbolic), saved, loaded and run at 10k
and 100k particles; the plots' data of the imported linac and of the 1M
beam (drawn under Agg where matplotlib is installed); and
``utils.profiling`` against this script's timer.
Last the eleventh slice, the kernels as ``torch.library`` operators: the
space-charge segment exported with ``torch.export`` from the 1M beam (the
particle axis symbolic) on 32^3 and 128^3, saved, loaded and called at 1M
and 100k particles, its graph holding the operators and none of the plain
versions, its launches those of eager tracking and its kicks those of
eager tracking within the kick tolerance, with export, loaded, eager and
graph times; the segment exported on the CPU and moved to the card; and
the host's time per operator call against its CUDA implementation's.
The twelfth slice makes every deposit repeat bit for bit: the
``determinism`` phase (after the kernel checks) runs every deposit route
three times on identical inputs and holds the bits equal, and every
screen reading twice; the space-charge line's gradient must not move
between runs, ``track_checkpointed`` must equal ``track``, the sharded
kick the unsharded one and the loaded program eager tracking, all bit for
bit.
The fourteenth slice compiles the paths as the JAX package jits them:
the ``compiled`` phase (last) puts the env step, its k1 gradient, config
1's ``track_moments``, the 32^3 space-charge segment, its gradient on
32^3 and 128^3, and config 5's ``BatchedLatticeEnv.step`` and
``grad_step`` under ``torch.compile(fullgraph=True, dynamic=False)`` with
Inductor and with ``mode="reduce-overhead"`` (CUDA graphs), each held
against eager, not traced again on new parameter values, its graphs free
of the plain versions' operators, the CIC kernels launched as eagerly
(the wrappers' counts, for CUDA graphs those of the calls that record
them; torch.profiler's kernel names), the space-charge gradients bit for
bit over five runs, with eager, compiled and CUDA-graph ms, launches and
idle share. Compile processes compile and check every path cold while
the earlier phases run, and at the end time each, one path after another
on a quiet card; they also build the exported env step and space-charge
segments with AOTInductor, which ``deploy`` (at 10k and 100k particles)
and ``deploy_space_charge`` load and hold against eager and the card's
float64 run.
Every phase prints one JSON line. The last line is
``{"ok": true, "device": {...}}``; any failed check raises, so the script
exits non-zero and prints no such line. It imports neither JAX nor the JAX
package, and it refuses to run without a card.

Precision: ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set to False, so float32 matrix
products run in full float32.
"""

from __future__ import annotations

import collections
import itertools
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

#: Peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s and float32
#: operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

NUM_PARTICLES = 1_000_000
ALL_ORDERS = tuple(itertools.product((0, 1), repeat=3))
SEED = 0
#: The order sets the paths ask the gather for (the forward kick; the
#: raised set of both backward passes), with their component counts.
VALUE = ((0, 0, 0),)
RAISED = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
PATH_ORDER_SETS = [("value_c3", ((0, 0, 0),), 3), ("raised_c3", RAISED, 3),
                   ("raised_c1", RAISED, 1)]

# Tolerances of the kernels against their plain versions on the card, as a
# fraction of max|output|. The gather sums 8 corner terms per output in the
# same order as its plain version; only FMA contraction differs, a few ulps.
# The deposit adds ~N * 8 / cells (~250 at 32^3) terms per cell in fixed
# point (csrc/cic_common.cuh), the plain version with index_add_ in float:
# sqrt(250) * eps * max|term| stays well below 1e-5 of max|output|, and
# K * eps * max|term| (the worst case) near it. Where a window holds int32
# (the value order set in float32) each term rounds by at most 2^-17 of the
# largest row (16384 particles a copy or chunk); random roundings over K
# terms stay below 1e-4 of max|output| even where signed rows cancel in a
# cell. Elsewhere a term rounds by at most S 2^-61, S = N M (N particles, M
# the largest |row| of its instance and component), far below float32's
# rounding.
GATHER_TOLERANCE = 1e-5
DEPOSIT_TOLERANCE = 1e-4
# The determinism phase: every deposit route DETERMINISM_RUNS times on
# identical inputs, the outputs' bits equal. The grids of the kernel checks
# and of _deposit_route's routes: 16^3 (privatised int64 windows beside
# 32^3's int32 in float32), 32^3, 64^3 (int64 grids in global memory) and
# the tiled checks' grids, each in float32 and float64, B 1 and 4, the
# value and raised order sets, C 1 and 3, on the tiled checks' Gaussian
# beam (with particles off the grid and non-finite) and the crowded beam.
# A float64 deposit of the value order set is also held to its bound
# against the plain version: each of a cell's K terms rounds by at most
# S 2^-61 (S = N M, N particles and M the largest |row| of its instance and
# component: an int64 grid's scale is within a factor 4 of 2^62 / S, a
# window's finer), twice where a window is rescaled to its grid, and both
# sums round in float64 by at most K 2^-53 times the cell's sum of |terms|
# A: 2 K S 2^-61 + 2 K 2^-53 A, with K and A the largest over the cells.
DETERMINISM_RUNS = 3
DETERMINISM_SHAPES = [(16, 16, 16), (32, 32, 32), (64, 64, 64)]
# The card (float32) against the port on the CPU (float64): sigma_x of the
# env step to rtol 1e-4 (a 13-matrix product and a raw-moment variance over
# 10k particles in float32, ~1e-6 expected); the space-charge kicks to an RMS
# error of 1e-4 of the RMS kick in px and py (float32 deposit rounding and
# grid edges that move with float32 beam sizes, ~2e-6 on the CPU at 200k
# particles) and 1e-3 in p, where the float32 SI round trip adds
# eps * gamma0 / (beta0 gamma0) = 6e-8 per particle (~1.5e-5 on the CPU).
ENV_STEP_RTOL = 1e-4
KICK_RMS_TOLERANCE = {"px": 1e-4, "py": 1e-4, "p": 1e-3}
# Gradients. d sum(px^2) / d(drift length) sums a signed term per particle
# with heavy cancellation, so float32 keeps fewer digits of it than of the
# kicks, and fewer on a finer grid, with fewer particles per cell: on one
# H100 this script measured the float32 gradient 2.6e-6 to 1.4e-5 (32^3)
# and 2.3e-4 to 2.8e-4 (128^3) off the float64 CPU gradient. The card's
# float64 gradient differs from the CPU's in summation order only (atomics,
# FFT), amplified by the same cancellation (2e-13 measured). The float64
# central difference on the card (step 1e-6 of the 0.1 m drift) differs
# from the a.e. derivative where particles cross cell edges inside the
# step, by O(step / cell) relative (2e-5 measured at 128^3).
SC_GRAD_F32_RTOL = {(32, 32, 32): 1e-3, (128, 128, 128): 1e-2}
SC_GRAD_F64_RTOL = 1e-8
SC_GRAD_FD_STEP = 1e-6
SC_GRAD_FD_RTOL = 1e-4
# The env step's k1 gradient on the card (float32) against the CPU
# (float64), relative to the largest gradient entry: a 13-matrix product
# and a raw-moment variance in float32, as for sigma_x (1.8e-6 measured).
ENV_GRAD_TOLERANCE = 1e-4
# The ParameterBeam env step and track_moments on the card (float32) against
# the port's float64 CPU run: a 13-matrix product and a 7x7 congruence in
# float32 (~1e-6 expected); track_moments reads the centred covariance of
# the particles, track(...).sigma_x their raw-moment variance, both over
# 10k particles in float32.
PARAMETER_BEAM_RTOL = 1e-4
MOMENTS_RTOL = 1e-4
# Screen images on the card (float32) against a float64 run of the port.
# Histograms compare by mass (rel 1e-5: a float32 sum of 100k weights) and
# by their L1 difference over the mass: a particle within float32 rounding
# (~1e-10 m) of a 3.3 um pixel edge may fall in the neighbouring pixel,
# ~1e-4 of the particles, each moving 2 / N of the L1 norm. Cloud-in-cell
# and KDE images are smooth in the positions: their largest pixel
# difference within 1e-4 of their largest pixel.
IMAGE_MASS_RTOL = 1e-5
HISTOGRAM_L1_TOLERANCE = 1e-3
IMAGE_MAX_TOLERANCE = 1e-4
# The screen centroid (scripts/bench_all.py centroid_loss) on the card
# (float32) against the port's float64 CPU run. Its gradient with respect to
# AREAMQZM1's k1 is zero up to rounding: the beam enters the quadrupole
# centred and the cloud-in-cell centroid is the particles' mean x, which
# only the downstream corrector AREAMCHM1 moves. So that gradient is held
# to an absolute 1e-6 of sigma_x at the screen per unit k1, and the
# gradient with respect to the corrector's angle (~0.45 m) is held to rel
# 1e-4 and to an f64 central difference on the card (rel 1e-6; the
# centroid is linear in the angle).
CENTROID_RTOL = 1e-4
CENTROID_K1_GRAD_ATOL_PER_SIGMA = 1e-6
CENTROID_ANGLE_GRAD_RTOL = 1e-4
CENTROID_FD_RTOL = 1e-6
# BASELINE config 3 (the nonlinear chain) on the card in float32 against
# the same chain in float64 on the card, 100k particles. The JAX package's
# own float32 run of the chain on the CPU reaches 8.3e-3 of tau's standard
# deviation, and the port's 6.2e-3 (both against float64): x, px, y, py and
# tau are held to 3e-2 of their float64 standard deviation. delta's error
# is the Bmad round trip pz = (p - p0c) / p0c (a few float32 ulps of 1,
# against a sigma_p of 1.8e-6), so p is held to 1e-6 absolute; the outgoing
# energy to rtol 1e-6.
CHAIN_STD_SHARE = 3e-2
CHAIN_P_ATOL = 1e-6
CHAIN_ENERGY_RTOL = 1e-6
# The gradients of sigma_x: float32 against float64 on the card, and the
# card's float64 gradient against an float64 central difference (step
# chosen so that truncation and rounding both stay below 1e-7 of the
# gradient on the CPU). The sextupole moves x by ~k2 L x^2 ~ 1e-7 m, the
# size of float32's error of x after the dkd dipole (7e-8 m on the CPU), so
# the float32 gradient with respect to k2 keeps about two digits (1.6% off on
# the CPU): 5e-2; the others 1e-4 (2e-6 on the CPU).
CHAIN_GRAD_CASES = {
    # name: (element index, attribute, value, central-difference step)
    "k2": (5, "k2", 60.0, 1.0),
    "angle": (3, "angle", 0.15, 1e-6),
    "voltage": (1, "voltage", 2e7, 1e2),
    "phase": (1, "phase", 30.0, 1e-4),
}
CHAIN_GRAD_F32_RTOL = {"k2": 5e-2, "angle": 1e-4, "voltage": 1e-4, "phase": 1e-4}
CHAIN_GRAD_FD_RTOL = 1e-6
# torch.func through the 32^3 kick in float64 on the card: the jvp and the
# gradient contracted with the same direction are the same derivative
# computed two ways, and vmap over two beams the same kicks as two calls;
# they differ by the order of atomic sums (rtol 1e-9).
FUNC_RTOL = 1e-9
# The ARES stage-3 lattice (lattices.ares_stage3, 195 elements) at 100k
# particles on the card in float32, against the port's float64 run on the
# CPU. Its vendored magnets are at zero strength, so the accuracy runs set
# them from a numpy Generator (SEED): quadrupole k1 uniform in +-5 1/m^2,
# solenoid k in +-1 1/m, corrector angles in +-1e-4 rad. At these strengths
# the lattice is not stable: the beam grows to ~0.1-0.2 m rms, and in
# drift-kick-drift mode the f64 run sends one tail particle out of the
# Bmad-X maps' domain (|px| > 1 + pz, non-finite in both packages). That
# mode checks that the card loses exactly the same particles and holds the
# others to the limits. sigma_x and sigma_y: linear and ParameterBeam
# within rtol 1e-4 (7 fused maps of up to 40 elements each and a
# raw-moment variance in float32; 1.2e-6 and 1.8e-6 on the CPU), second
# order within 1e-3 (111 folded T-tensors, each a 7x7x7 sandwich in
# float32; 1.0e-5 on the CPU). Drift-kick-drift as the nonlinear chain
# (x, px, y, py, tau within 3e-2 of their float64 standard deviation, p
# within 1e-6 absolute; 3.8e-3 and 1.6e-7 on the CPU). The gradient of
# sigma_x by AREAMQZM1's k1 (linear): float32 within 1e-3 of the float64
# CPU run (5.9e-6 on the CPU), and the card's float64 gradient within 1e-6
# of a float64 central difference (step 1e-5 of a k1 of 1.37 1/m^2; 9e-10
# on the CPU).
STAGE3_K1_RANGE = 5.0
STAGE3_SOLENOID_RANGE = 1.0
STAGE3_ANGLE_RANGE = 1e-4
STAGE3_SIGMA_RTOL = {"linear": 1e-4, "second_order": 1e-3, "parameter_beam": 1e-4}
STAGE3_GRAD_F32_RTOL = 1e-3
STAGE3_FD_STEP = 1e-5
STAGE3_FD_RTOL = 1e-6
# The new elements at 100k particles on the card in float32 against the
# port's float64 CPU run, each coordinate's largest error over its float64
# standard deviation. One linear or second-order map rounds each particle a
# few float32 ulps of its largest coordinate, ~1e-6 of the standard
# deviation for a Gaussian's 5-sigma tails: 1e-4. The drift-kick-drift maps
# (RBend, the transverse deflecting cavity) as the nonlinear chain. The
# BPM's reading (the centroid) within 1e-4 of the beam's size.
NEW_ELEMENT_STD_SHARE = 1e-4
BPM_READING_TOLERANCE = 1e-4
# The eighth slice's space-charge line (``lattices.cold_beam_line``): the
# cold uniform beam doubles in sigma_x, sigma_y and sigma_tau over the line
# within the JAX package's tolerance (``tests/test_space_charge.py:88-96``)
# on 32^3; on 128^3 the beam fills about one particle a cell and the ratio
# is printed, not checked. Every deposit adds in fixed point, so the line
# gives the same bits on every run: track's gradient spreads by exactly 0
# over 5 runs, and track_checkpointed, which runs the same operations on
# the same values again, equals track bit for bit in float32 and float64.
# (The cold beam's sum(px^2) by the first drift's length is a cancelling
# sum over particles of ~1e-15 momenta: while the tiled deposit added with
# float atomics, track's own float32 gradient on 128^3 spread by 1.7e-3 to
# 3.0e-3 between runs, PERF.md.)
SC_LINE_KICKS = 10
SC_LINE_DOUBLING_RTOL = 2e-2
# The multi-device slice. BASELINE config 5's env: 4096 instances of the
# five ARES EA tunables, settings from numpy (k1 in +-20, angles in
# +-1e-3 rad). env.step against segment.track with the same settings
# assigned runs the same operations on the same card: rtol 1e-6. Against
# the port's float64 CPU run, sigma_x and sigma_y of each instance to rtol
# 1e-4 (section 2 of PERF.md) times 1 + (mu / sigma)^2, the amplification
# of the float32 sums by the raw-moment variance E[x^2] - mu^2 (ROADMAP
# Queue 3) once the correctors move the beam off axis: on the CPU in
# float32, 1.1e-3 at (mu / sigma)^2 = 760 and 1.2e-5 on axis. The k1
# gradients, column by column against the column's largest, to 1e-4; the
# angle gradients are zero by construction (a centroid shift leaves sigma
# unchanged): in float64 below 1e-9 of the reward over a 1e-3 rad step, in
# float32 within the reward's own bound over that step.
ENV_TUNABLES = (("AREAMQZM1", "k1"), ("AREAMQZM2", "k1"), ("AREAMQZM3", "k1"),
                ("AREAMCVM1", "angle"), ("AREAMCHM1", "angle"))
ENV_INSTANCES = 4096
ENV_ANGLE_RANGE = 1e-3
ENV_LEARNING_RATE = 1e4
ENV_SAME_RTOL = 1e-6
ENV_ANGLE_ZERO_F64 = 1e-9
# Two ranks over gloo on the one card: each rank's rows of the env against
# the one-process 4096-instance run. cuBLAS adds a batch of 2048 in another
# order than one of 4096, so the rows are not bit-equal (measured on one
# H100: rewards up to 5e-4 apart, 1.2e-6 times 1 + (mu / sigma)^2), and the
# raw-moment variance amplifies that order's float32 rounding as in the
# float64 comparison above: two orders of a 10k-term float32 sum differ by
# up to sqrt(10k) * eps relative, times 1 + (mu / sigma)^2 of the
# instance. The k1 gradients the same, against their column's largest; the
# angle gradients (zero by construction) within the reward's bound. The
# env's grad step moves at most 4096 bytes across ranks (one mean reward,
# not the particles).
TWO_RANK_ENV_RTOL = 100 * torch.finfo(torch.float32).eps
AUDIT_READOUT_BYTES = 4096
TWO_RANK_TIMEOUT_S = 300
# The tenth slice. imported_ares: the ARES linac imported from its NX
# Tables export (226 elements, 44.22 m), its 15 quadrupoles' k1 and 33
# corrector angles set from a numpy Generator (SEED) in stage 3's ranges
# (k1 in +-5 1/m^2, angles in +-1e-4 rad), which keep the beam finite; 1M
# float32 particles against the port's float64 CPU run of the same import.
# The moments are those of the card's float32 particles summed in float64:
# a float32 readout's raw-moment variance loses (mu / sigma)^2 eps off axis
# (ROADMAP Queue 3), and the Elegant cavity lattice's matrix moves the beam
# 0.1 m off axis at a sigma_y of 6.5e-5 m (a float32 readout of sigma_y is
# off by 34% there on the CPU). mu_x and mu_y within 1e-4 of sigma, sigma_x
# and sigma_y within rtol 1e-4 (stage 3's linear bound; at most 2.5e-6 and
# 2.3e-6 on the CPU at 100k), 1e-3 where a sextupole tracks second order
# (the FODO cell, the Bmad tutorial; stage 3's second-order bound). The ARES
# import through LatticeJSON and back tracks to the same particles, bit for
# bit.
IMPORTED_K1_RANGE = 5.0
IMPORTED_ANGLE_RANGE = 1e-4
IMPORTED_RTOL = {"linear": 1e-4, "second_order": 1e-3}
IMPORTED_FILES = {
    "fodo": ("fodo.lte", "second_order"),
    "cavity": ("cavity.lte", "linear"),
    "bmad_tutorial": ("bmad_tutorial_lattice.bmad", "second_order"),
}
# beam_io: the 1M float32 card beam through openPMD. The records keep x, px,
# y, py and tau to a few float32 ulps of each coordinate's largest value (4
# eps); delta costs the SI round trip: the per-particle energy is written
# as sqrt(p^2 + m^2) and read back less the reference energy, so delta is
# good to eps E / p0c per rounding (4 of them allowed; 2 held for 2000
# particles on the CPU). In float64 every coordinate within 1e-12 of its
# largest value. The read-back beam's kicks through the 32^3 segment within
# KICK_RMS_TOLERANCE of the original beam's.
BEAM_IO_ULPS = 4
BEAM_IO_F64_RTOL = 1e-12
# deploy: the env step exported by torch.export with the particle axis
# symbolic, saved, loaded and run at 10k and 100k particles: the loaded
# program runs the operations of eager tracking on the same card, rtol
# 1e-6. The plots of the linac as imported (its magnets at zero) from a
# float64 card run against the float64 CPU run, within 1e-6 of each line's
# largest value: the Twiss beta divides by an emittance that cancels up to
# 8.4e7-fold at the linac's end (<x^2><px^2> over the emittance squared),
# and a 1e-15 relative change of the particles moves beta_x by 3.2e-8 of
# its largest value on the CPU. (With the seeded magnets the cancellation
# reaches 9.3e12 and the same change moves beta_y by 4.5e-4: no precision
# holds that; in float32 a CPU beta_x is off by 9e9.) The 1M float32 beam's
# histograms equal those of its copy on the CPU, bit for bit: the same
# float32 particles binned by the same numpy. (Against a float64 copy the
# edges round otherwise and particles on them change bins: 6.7e-4 of the
# largest 2D bin on one H100.) profiling.benchmark of the env step within a
# factor 2 of time_ms.
DEPLOY_RTOL = 1e-6
PLOT_F64_RTOL = 1e-6
BENCHMARK_FACTOR = 2.0


START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line for ``phase``, with the seconds since the script began."""
    print(json.dumps({"phase": phase, **fields, "t_s": time.perf_counter() - START}), flush=True)


def check(condition: bool, message: str) -> None:
    if not condition:
        raise AssertionError(message)


def time_ms(fn, runs: int = 20, warmup: int = 3, per_event: int = 1) -> float:
    """Median time of one call of ``fn`` on the card, with CUDA events around
    ``per_event`` back-to-back calls, over ``runs`` such windows. A kernel is
    timed with ``per_event`` > 1, so that the host's time to enqueue one call
    hides behind the previous call instead of counting as device time; a
    whole path is timed call by call, as its user calls it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_event):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_event)
    return statistics.median(times)


def graph_ms(fn, calls: int = 10, runs: int = 20) -> float:
    """Device time of one call of ``fn``: ``calls`` back-to-back calls
    captured in a CUDA graph, replayed ``runs`` times between CUDA events
    (median). Unlike :func:`time_ms`, the host's time to enqueue a call does
    not count, so a kernel faster than its wrapper's Python is timed as the
    card runs it; a library call is timed the same way."""
    fn()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, runs=runs, warmup=2) / calls
    del graph
    return ms


def bound(bytes_moved: float, operations: float) -> tuple[float, str]:
    """Least time on the card (ms) and what sets it."""
    byte_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    op_ms = operations / F32_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def relative_error(actual: torch.Tensor, expected: torch.Tensor) -> tuple[float, float]:
    """(max |actual - expected|, that divided by max |expected|)."""
    absolute = (actual.double() - expected.double()).abs().max().item()
    return absolute, absolute / expected.double().abs().max().item()


#: Device-time families of the port's kernels in a profile, by a piece of
#: the kernel's name.
KERNEL_FAMILIES = {
    "gather": ("gather_multi_kernel", "gather_staged_kernel", "gather_tiled_kernel",
               "gather_tiled_staged_kernel", "unsort_kernel"),
    "deposit": ("deposit_multi_kernel", "deposit_private_kernel", "deposit_reduce_kernel",
                "deposit_tiled_kernel", "row_max_kernel", "fixed_to_output_kernel"),
    "plan": ("plan_count_kernel", "plan_scan_kernel", "plan_scatter_kernel"),
}


def _kernel_name(key: str) -> str:
    """A profiled kernel's function name, without namespace or arguments."""
    return key.split("(")[1].split(")::")[-1] if key.startswith("void (") else key.split("(")[0]


def profile_path(label: str, fn, ms: float) -> dict:
    """Device time by kernel over one call of ``fn`` (``torch.profiler``), and
    the device's idle share against ``ms``, the call's CUDA-event time.
    Returns the profile line's fields (the CIC kernels' device time and
    launches by family under ``cic_kernels``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        fn()
        torch.cuda.synchronize()
    # Device-side events only: a CPU op's entry repeats the device time of
    # the kernels it launched.
    kernels = [
        e
        for e in trace.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    families = {
        family: {
            "ms": sum(e.self_device_time_total for e in members) / 1e3,
            "count": sum(e.count for e in members),
            "by_kernel": {_kernel_name(e.key): e.count for e in members},
        }
        for family, pieces in KERNEL_FAMILIES.items()
        for members in [[e for e in kernels if any(piece in e.key for piece in pieces)]]
    }
    fields = {
        "path": label,
        "event_ms": ms,
        "device_busy_ms": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / ms),
        "kernel_launches": sum(e.count for e in kernels),
        "cic_kernels": families,
        "top": [
            {"kernel": e.key[:90], "ms": e.self_device_time_total / 1e3, "count": e.count}
            for e in top
        ],
    }
    emit("profile", **fields)
    return fields


# The kernel wrappers, each with its own launch count: the untiled pair,
# and the tiled pair with its plan.
def _wrappers(cic_kernels, cic_tiled) -> dict:
    return {
        "deposit_multi_3d": cic_kernels.deposit_multi_3d,
        "gather_multi_3d": cic_kernels.gather_multi_3d,
        "deposit_multi_tiled_3d": cic_tiled.deposit_multi_tiled_3d,
        "gather_multi_tiled_3d": cic_tiled.gather_multi_tiled_3d,
        "plan_tiles": cic_tiled.plan_tiles,
    }


TILED_WRAPPERS = ("deposit_multi_tiled_3d", "gather_multi_tiled_3d", "plan_tiles")


#: The CIC launch counters' readings at the last :func:`_reset_launches`.
_LAUNCH_BASE: dict = {}


def _reset_launches(wrappers: dict) -> None:
    """Count the wrappers' launches (``utils.profiling``'s counters) from now."""
    from cheetah_tpu_torch.utils import profiling

    counted = profiling.counters()
    _LAUNCH_BASE.update({name: counted.get(name, 0) for name in wrappers})


def _launches(wrappers: dict) -> dict:
    """The wrappers' launches since :func:`_reset_launches`."""
    from cheetah_tpu_torch.utils import profiling

    torch.cuda.synchronize()
    counted = profiling.counters()
    return {name: counted.get(name, 0) - _LAUNCH_BASE.get(name, 0) for name in wrappers}


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_environment() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(
        "environment",
        python=sys.version.split()[0],
        torch=torch.__version__,
        cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        nvidia_smi=smi,
        allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
    )
    return smi


def _ptxas_usage(output: str) -> dict:
    """Registers and spill stores of each kernel, from ``ptxas -v`` output,
    by demangled name without its argument list."""
    usage, mangled = {}, []
    current = None
    for line in output.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1]
            mangled.append(current)
            usage[current] = {"registers": None, "spill_stores": None}
        elif current and "bytes spill stores" in line:
            usage[current]["spill_stores"] = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif current and "Used" in line and "registers" in line:
            usage[current]["registers"] = int(line.split("Used")[1].split("registers")[0])
    try:
        names = subprocess.run(
            ["c++filt"], input="\n".join(mangled), capture_output=True, text=True, timeout=60,
            check=True,
        ).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = mangled
    if len(names) != len(mangled):
        names = mangled
    short = {}
    for raw, name in zip(mangled, names):
        name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
        short[name.split("(", 1)[0]] = [usage[raw]["registers"], usage[raw]["spill_stores"]]
    return short


def phase_build(libraries) -> None:
    from cheetah_tpu_torch.ops import nvcc

    start = time.perf_counter()
    outputs = nvcc.build_all(libraries, verbose=True)
    seconds = time.perf_counter() - start
    # [registers, spill stores] of every kernel instantiation; gather
    # instantiations are <T, index type, order kind (0 generic, 1 value,
    # 2 raised), orders, components (0: at run time)>.
    usage = {source: _ptxas_usage(output) for source, output in outputs.items()}
    emit(
        "build", seconds=seconds,
        libraries=[str(library.path()) for library in libraries],
        ptxas_registers_spills=usage,
    )
    check(all(usage.values()), "ptxas reported no kernels")


def _uniform_positions(generator, batch, shape, dtype):
    """Bin-space positions spilling past every edge, with parked (-2),
    far-out and non-finite particles mixed in."""
    n = torch.tensor(shape, dtype=dtype, device="cuda")
    normalized = (
        torch.rand((batch, NUM_PARTICLES, 3), generator=generator, dtype=dtype, device="cuda")
        * (n + 2.0)
        - 1.5
    )
    normalized[:, ::97] = -2.0
    normalized[:, 1::1009, 0] = float("nan")
    normalized[:, 2::1009, 1] = float("inf")
    normalized[:, 3::1009, 2] = -1e30
    return normalized


def _beam_positions(generator, shape, offset, dtype):
    """Bin-space positions of a Gaussian beam on a grid of +-3 sigma, as the
    space-charge kick gives them (``offset`` -0.5 for the deposit's cell
    centres, 0 for the gather's nodes)."""
    n = torch.tensor(shape, dtype=dtype, device="cuda")
    gauss = torch.randn((1, NUM_PARTICLES, 3), generator=generator, dtype=dtype, device="cuda")
    return n / 2 + offset + gauss * n / 6


def _crowded_positions(generator, batch, shape, dtype, count=NUM_PARTICLES):
    """Bin-space positions of every particle inside the 2 x 2 x 2 cells at
    the grid's centre: each cell gets ~N / 8 particles' atomics, the worst
    case for a privatised deposit's shared-memory atomics."""
    n = torch.tensor(shape, dtype=dtype, device="cuda")
    jitter = torch.rand((batch, count, 3), generator=generator, dtype=dtype, device="cuda")
    return torch.floor(n / 2) - 1 + 2 * jitter


def _deposit_route(cic_kernels, cic_tiled, shape, dtype, batch, components,
                   orders=((0, 0, 0),)) -> str:
    """Which kernel a deposit of this call launches, as the wrappers choose
    it: the privatised untiled kernel with its copies and its windows'
    fixed point (int32 or int64), the untiled kernel into int64 grids in
    global memory, or the x-tiled kernel with its chunk length, with int32
    or int64 windows or without windows."""
    from cheetah_tpu_torch.ops import cic_common

    accumulator = cic_common.accumulator_bytes(dtype, orders)
    fixed = f"int{8 * accumulator}"
    limits = cic_common.device_limits(cic_kernels.LIBRARY, torch.device("cuda"))
    if cic_kernels.uses_tiled(shape):
        window = (cic_tiled.rows_per_tile(shape) + 1) * shape[1] * shape[2]
        g = cic_tiled.tiled_deposit_geometry(batch, components, NUM_PARTICLES, window,
                                             accumulator, limits)
        windows = f"{fixed} windows" if g.shared else "no windows"
        return f"tiled group={g.group} per_run={g.per_run} {windows}"
    g = cic_kernels.untiled_deposit_geometry(batch, components, NUM_PARTICLES,
                                             shape[0] * shape[1] * shape[2], accumulator, limits)
    if g is None:
        return "untiled global int64"
    return f"untiled private {fixed} group={g.group} copies={g.copies}"


def _crowded_deposit_errors(cic_kernels, cic_tiled, generator) -> list:
    """The deposits on crowded inputs (:func:`_crowded_positions`), on each
    privatised route, at the value order (C = 1 and 3) and all 8 orders:
    the worst relative error against the plain version per case."""
    cases = [((32, 32, 32), torch.float32), ((32, 32, 32), torch.float64),
             ((64, 64, 64), torch.float32), ((128, 128, 128), torch.float32),
             ((128, 128, 128), torch.float64)]
    results = []
    for shape, dtype in cases:
        normalized = _crowded_positions(generator, 1, shape, dtype)
        for orders, components in ((cic_kernels.VALUE, 1), (cic_kernels.VALUE, 3),
                                   (ALL_ORDERS, 1)):
            rows = torch.randn((1, len(orders), components, NUM_PARTICLES), generator=generator,
                               dtype=dtype, device="cuda")
            got = cic_kernels.deposit_multi_3d(normalized, rows, shape, orders)
            if cic_kernels.uses_tiled(shape):
                want = cic_tiled.deposit_multi_tiled_3d_reference(normalized, rows, shape, orders)
            else:
                want = cic_kernels.deposit_multi_3d_reference(normalized, rows, shape, orders)
            error = relative_error(got, want)[1]
            results.append({
                "grid": list(shape), "dtype": str(dtype).removeprefix("torch."),
                "orders": len(orders), "components": components, "rel_err": error,
                "route": _deposit_route(cic_kernels, cic_tiled, shape, dtype, 1, components,
                                        orders),
            })
            check(error <= DEPOSIT_TOLERANCE, f"crowded deposit {results[-1]}: error {error}")
        del normalized, rows, got, want
    return results


def _unaligned(tensor: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``tensor`` whose data starts one element past an
    aligned address. A bulk copy needs 16-byte alignment, so the gathers
    read such a grid through L1 and L2 even where a staged gather would
    serve it: the way to check and time their other route."""
    buffer = torch.empty(tensor.numel() + 1, dtype=tensor.dtype, device=tensor.device)
    view = buffer[1:].view(tensor.shape)
    view.copy_(tensor)
    return view


def _path_sets_error(gather, plain, grids, normalized) -> float:
    """Worst relative error of a gather against its plain version over the
    path's order sets (components 3 and 1 of ``grids``), on the route the
    gather picks for the grid and on the L1/L2 route (:func:`_unaligned`)."""
    worst = 0.0
    for _, orders, components in PATH_ORDER_SETS:
        values = grids[:, :components].contiguous()
        want = plain(values, normalized, orders)
        for given in (values, _unaligned(values)):
            got = gather(given, normalized, orders)
            worst = max(worst, *(relative_error(g, w)[1] for g, w in zip(got, want)))
    return worst


def _large_batch_error(cic_kernels) -> float:
    """The untiled gather on more instances than a grid's y dimension takes
    (65535): it runs on the L1/L2 kernel's 1-D grid. Worst relative error
    against the plain version over the path's order sets and all 8."""
    generator = torch.Generator(device="cuda").manual_seed(SEED + 4)
    batch, shape = 70_000, (4, 4, 4)
    n = torch.tensor(shape, dtype=torch.float32, device="cuda")
    normalized = torch.rand((batch, 8, 3), generator=generator, device="cuda") * (n + 2) - 1.5
    grids = torch.randn((batch, 3, *shape), generator=generator, device="cuda")
    worst = _path_sets_error(
        cic_kernels.gather_multi_3d, cic_kernels.gather_multi_3d_reference, grids, normalized
    )
    got = cic_kernels.gather_multi_3d(grids, normalized, ALL_ORDERS)
    want = cic_kernels.gather_multi_3d_reference(grids, normalized, ALL_ORDERS)
    return max(worst, *(relative_error(g, w)[1] for g, w in zip(got, want)))


def phase_kernels(cic_kernels) -> dict:
    """Each kernel against its plain version on the card, at all 8 orders
    for B in {1, 4} and grids 32^3 and 64^3, then timed at the main path's
    shape. Returns the numbers for the ``kernels`` line."""
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"deposit": 0.0, "gather": 0.0}
    for batch, side, dtype in [
        (1, 32, torch.float32), (4, 32, torch.float32),
        (1, 64, torch.float32), (4, 64, torch.float32),
        (1, 32, torch.float64), (4, 32, torch.float64), (1, 64, torch.float64),
    ]:
        shape = (side, side, side)
        normalized = _uniform_positions(generator, batch, shape, dtype)
        rows = torch.randn(
            (batch, len(ALL_ORDERS), 1, NUM_PARTICLES), generator=generator,
            dtype=dtype, device="cuda",
        )
        got = cic_kernels.deposit_multi_3d(normalized, rows, shape, ALL_ORDERS)
        want = cic_kernels.deposit_multi_3d_reference(normalized, rows, shape, ALL_ORDERS)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "deposit produced non-finite values")
        _, deposit_error = relative_error(got, want)
        ms_deposit = time_ms(
            lambda: cic_kernels.deposit_multi_3d(normalized, rows, shape, ALL_ORDERS),
            per_event=10,
        )

        grids = torch.randn(
            (batch, 3, *shape), generator=generator, dtype=dtype, device="cuda"
        )
        got = cic_kernels.gather_multi_3d(grids, normalized, ALL_ORDERS)
        want = cic_kernels.gather_multi_3d_reference(grids, normalized, ALL_ORDERS)
        torch.cuda.synchronize()
        gather_error = max(relative_error(g, w)[1] for g, w in zip(got, want))
        check(all(bool(torch.isfinite(g).all()) for g in got), "gather produced non-finite values")
        path_sets_error = _path_sets_error(
            cic_kernels.gather_multi_3d, cic_kernels.gather_multi_3d_reference, grids, normalized
        )
        check(path_sets_error <= GATHER_TOLERANCE, f"gather error {path_sets_error} (path sets)")
        ms_gather = time_ms(
            lambda: cic_kernels.gather_multi_3d(grids, normalized, ALL_ORDERS), per_event=10
        )
        # Bytes each kernel must move: positions, rows or grids read once,
        # outputs written once.
        size = normalized.element_size()
        cells = side**3
        orders = len(ALL_ORDERS)
        deposit_bytes = size * batch * (NUM_PARTICLES * (3 + orders) + cells)
        gather_bytes = size * batch * (3 * cells + NUM_PARTICLES * (3 + 3 * orders))
        emit(
            "kernel_check",
            batch=batch, grid=list(shape), particles=NUM_PARTICLES, orders=orders,
            dtype=str(dtype).removeprefix("torch."),
            deposit_rel_err=deposit_error, deposit_ms=ms_deposit,
            deposit_route=_deposit_route(cic_kernels, cic_kernels.cic_tiled, shape, dtype, batch,
                                         1, ALL_ORDERS),
            deposit_bound_ms=bound(deposit_bytes, batch * NUM_PARTICLES * 8 * 5 * orders)[0],
            gather_components=3, gather_rel_err=gather_error, gather_ms=ms_gather,
            gather_path_sets_rel_err=path_sets_error,
            gather_bound_ms=bound(gather_bytes, batch * NUM_PARTICLES * 3 * 8 * 4 * orders)[0],
        )
        check(deposit_error <= DEPOSIT_TOLERANCE, f"deposit error {deposit_error}")
        check(gather_error <= GATHER_TOLERANCE, f"gather error {gather_error}")
        worst["deposit"] = max(worst["deposit"], deposit_error)
        worst["gather"] = max(worst["gather"], gather_error)
        del normalized, rows, grids, got, want

    large_batch_error = _large_batch_error(cic_kernels)
    emit("gather_large_batch", batch=70_000, grid=[4, 4, 4], particles=8,
         rel_err=large_batch_error)
    check(large_batch_error <= GATHER_TOLERANCE, f"gather error {large_batch_error} at B 70000")

    # The main path's shape: one instance, 32^3, 1M particles, the value
    # order; the deposit carries the charge (C=1), the gather the three
    # force components (C=3).
    shape = (32, 32, 32)
    f32 = torch.float32
    cells = shape[0] * shape[1] * shape[2]
    positions = _beam_positions(generator, shape, -0.5, f32)
    charges = torch.rand((1, 1, 1, NUM_PARTICLES), generator=generator, dtype=f32, device="cuda")
    got = cic_kernels.deposit_multi_3d(positions, charges, shape, cic_kernels.VALUE)
    want = cic_kernels.deposit_multi_3d_reference(positions, charges, shape, cic_kernels.VALUE)
    deposit_abs, deposit_rel = relative_error(got, want)
    check(deposit_rel <= DEPOSIT_TOLERANCE, f"deposit error {deposit_rel} at the main shape")
    deposit_ms = graph_ms(
        lambda: cic_kernels.deposit_multi_3d(positions, charges, shape, cic_kernels.VALUE)
    )
    deposit_eager_ms = time_ms(
        lambda: cic_kernels.deposit_multi_3d(positions, charges, shape, cic_kernels.VALUE),
        per_event=10,
    )
    deposit_plain_ms = time_ms(
        lambda: cic_kernels.deposit_multi_3d_reference(positions, charges, shape, cic_kernels.VALUE),
        per_event=10,
    )
    deposit_bound = bound(
        NUM_PARTICLES * (3 + 1) * 4 + cells * 4, NUM_PARTICLES * 8 * 5
    )
    deposit_c3 = _deposit_c3(cic_kernels.deposit_multi_3d, cic_kernels.deposit_multi_3d_reference,
                             generator, positions, shape)
    deposit_c3["route"] = _deposit_route(cic_kernels, cic_kernels.cic_tiled, shape, f32, 1, 3)
    global_route = _global_route(cic_kernels, generator)

    nodes = _beam_positions(generator, shape, 0.0, f32)
    grids = torch.randn((1, 3, *shape), generator=generator, dtype=f32, device="cuda")
    (got,) = cic_kernels.gather_multi_3d(grids, nodes, cic_kernels.VALUE)
    (want,) = cic_kernels.gather_multi_3d_reference(grids, nodes, cic_kernels.VALUE)
    gather_abs, gather_rel = relative_error(got, want)
    check(gather_rel <= GATHER_TOLERANCE, f"gather error {gather_rel} at the main shape")
    gather_ms = graph_ms(lambda: cic_kernels.gather_multi_3d(grids, nodes, cic_kernels.VALUE))
    gather_eager_ms = time_ms(
        lambda: cic_kernels.gather_multi_3d(grids, nodes, cic_kernels.VALUE), per_event=10
    )
    gather_plain_ms = time_ms(
        lambda: cic_kernels.gather_multi_3d_reference(grids, nodes, cic_kernels.VALUE),
        per_event=10,
    )
    gather_bound = bound(
        cells * 3 * 4 + NUM_PARTICLES * 3 * 4 + NUM_PARTICLES * 3 * 4,
        NUM_PARTICLES * 3 * 8 * 4,
    )

    # Yardstick, timed only: grid_sample (trilinear, zero padding) computes
    # the order-0 gather in one call. Its input is (B, C, D, H, W) = (1, 3,
    # nx, ny, nt) and its grid's last axis is (t, y, x) scaled to [-1, 1].
    scale = torch.tensor([shape[2] - 1, shape[1] - 1, shape[0] - 1], dtype=f32, device="cuda")
    sample_grid = (nodes.flip(-1) / scale * 2 - 1).view(1, 1, 1, NUM_PARTICLES, 3)

    def library_gather():
        return torch.nn.functional.grid_sample(
            grids, sample_grid, mode="bilinear", padding_mode="zeros", align_corners=True
        )

    library = library_gather().view(1, 3, NUM_PARTICLES)
    _, library_rel = relative_error(library, want)
    gather_library_ms = graph_ms(library_gather)
    gather_library_eager_ms = time_ms(library_gather, per_event=10)

    emit(
        "kernel_main_shape",
        grid=list(shape), particles=NUM_PARTICLES,
        deposit={"ms": deposit_ms, "eager_ms": deposit_eager_ms, "plain_ms": deposit_plain_ms,
                 "bound_ms": deposit_bound[0], "max_abs_err": deposit_abs, "rel_err": deposit_rel,
                 "route": _deposit_route(cic_kernels, cic_kernels.cic_tiled, shape, f32, 1, 1)},
        deposit_c3=deposit_c3, deposit_global_route=global_route,
        gather={"ms": gather_ms, "eager_ms": gather_eager_ms, "plain_ms": gather_plain_ms,
                "bound_ms": gather_bound[0], "library_ms": gather_library_ms,
                "library_eager_ms": gather_library_eager_ms, "grid_sample_rel_diff": library_rel,
                "max_abs_err": gather_abs, "rel_err": gather_rel},
        worst_rel_err_all_orders=worst,
    )
    return {
        "deposit": dict(
            ms=deposit_ms, eager_ms=deposit_eager_ms, plain_ms=deposit_plain_ms,
            bound_ms=deposit_bound[0], bound_by=deposit_bound[1], library_ms=None,
            max_abs_err=deposit_abs, c3_ms=deposit_c3["ms"], c3_bound_ms=deposit_c3["bound_ms"],
            global_route=global_route,
        ),
        "gather": dict(
            ms=gather_ms, eager_ms=gather_eager_ms, plain_ms=gather_plain_ms,
            bound_ms=gather_bound[0], bound_by=gather_bound[1], library_ms=gather_library_ms,
            max_abs_err=gather_abs,
        ),
    }


def _global_route(cic_kernels, generator) -> dict:
    """The untiled deposit's route into int64 grids in global memory
    (``deposit_multi_kernel``) at the value order on 1M particles of a
    Gaussian beam: 64^3 in float32 (C = 1, the kick of phase_space_charge,
    and C = 3) and 32^3 in float64 (C = 1, the float64 checks of the
    gradients), each against its plain version, timed, with its bound:
    positions and rows read once, the grids written once."""
    results = {}
    for side, dtype, components in ((64, torch.float32, 1), (64, torch.float32, 3),
                                    (32, torch.float64, 1)):
        shape = (side, side, side)
        size = torch.empty((), dtype=dtype).element_size()
        positions = _beam_positions(generator, shape, -0.5, dtype)
        rows = torch.rand((1, 1, components, NUM_PARTICLES), generator=generator, dtype=dtype,
                          device="cuda")

        def deposit():
            return cic_kernels.deposit_multi_3d(positions, rows, shape, VALUE)

        absolute, rel = relative_error(
            deposit(), cic_kernels.deposit_multi_3d_reference(positions, rows, shape, VALUE)
        )
        label = f"{side}^3_{str(dtype).removeprefix('torch.')}_c{components}"
        check(rel <= DEPOSIT_TOLERANCE, f"{label}: deposit error {rel}")
        results[label] = {
            "route": _deposit_route(cic_kernels, cic_kernels.cic_tiled, shape, dtype, 1,
                                    components),
            "ms": graph_ms(deposit), "eager_ms": time_ms(deposit, per_event=10),
            "plain_ms": time_ms(
                lambda: cic_kernels.deposit_multi_3d_reference(positions, rows, shape, VALUE),
                per_event=10,
            ),
            "bound_ms": bound(NUM_PARTICLES * (3 + components) * size
                              + components * side**3 * size,
                              NUM_PARTICLES * 8 * 5 * components)[0],
            "max_abs_err": absolute, "rel_err": rel,
        }
    return results


def _deposit_c3(deposit, plain, generator, positions, shape, **plan) -> dict:
    """The deposit at the backward shape (the value order, C = 3: the
    transpose of the force gather) on the main path's positions, against
    its plain version, timed, with its bound: positions and rows read once,
    the three grids written once."""
    cells = shape[0] * shape[1] * shape[2]
    value = ((0, 0, 0),)
    forces = torch.randn((1, 1, 3, NUM_PARTICLES), generator=generator, dtype=positions.dtype,
                         device="cuda")
    got = deposit(positions, forces, shape, value, **plan)
    absolute, rel = relative_error(got, plain(positions, forces, shape, value))
    check(rel <= DEPOSIT_TOLERANCE, f"{shape}: deposit error {rel} at C=3")
    return {
        "ms": graph_ms(lambda: deposit(positions, forces, shape, value, **plan)),
        "eager_ms": time_ms(lambda: deposit(positions, forces, shape, value, **plan),
                            per_event=10),
        "plain_ms": time_ms(lambda: plain(positions, forces, shape, value), per_event=10),
        "bound_ms": bound(NUM_PARTICLES * (3 + 3) * 4 + 3 * cells * 4,
                          NUM_PARTICLES * 8 * 5 * 3)[0],
        "max_abs_err": absolute, "rel_err": rel,
    }


def _bench_beam(ctt, num_particles, device, generator):
    """The Twiss beam of the JAX package's benchmarks (``bench.py``)."""
    return ctt.ParticleBeam.from_twiss(
        num_particles=num_particles, beta_x=5.0, alpha_x=-1.0, emittance_x=2e-9,
        beta_y=3.0, alpha_y=0.5, emittance_y=2e-9, energy=1.54e8, total_charge=1e-10,
        generator=generator, dtype=torch.float32, device=device,
    )


def phase_env_step(ctt, wrappers) -> None:
    from cheetah_tpu_torch.lattices import ares_ea_subcell

    num_instances, num_particles = 4096, 10_000
    segment = ares_ea_subcell(torch.float32)
    segment.AREAMQZM1.k1 = torch.linspace(-20, 20, num_instances, device="cuda")
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    beam = _bench_beam(ctt, num_particles, "cuda", generator)
    num_elements = len(segment.elements)

    _reset_launches(wrappers)
    sigma_x = segment.track(beam).sigma_x
    launches = _launches(wrappers)
    check(not any(launches.values()), f"the env step launched {launches}")
    check(tuple(sigma_x.shape) == (num_instances,), f"sigma_x shape {tuple(sigma_x.shape)}")
    check(bool(torch.isfinite(sigma_x).all()), "non-finite sigma_x")

    picks = torch.linspace(0, num_instances - 1, 8).round().long()
    reference = ares_ea_subcell(torch.float64, device="cpu")
    reference.AREAMQZM1.k1 = segment.AREAMQZM1.k1[picks.cuda()].cpu().double()
    expected = reference.track(beam.to("cpu", torch.float64)).sigma_x
    actual = sigma_x[picks.cuda()].cpu().double()
    error = ((actual - expected).abs() / expected).max().item()
    check(error <= ENV_STEP_RTOL, f"env step sigma_x off by {error} relative")

    ms = time_ms(lambda: segment.track(beam).sigma_x, runs=20)
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile_path("env_step", lambda: segment.track(beam).sigma_x, ms)
    emit(
        "env_step",
        instances=num_instances, particles=num_particles, elements=num_elements,
        ms=ms, transports_per_s=num_instances * num_particles * num_elements / (ms * 1e-3),
        sigma_x_rel_err_vs_cpu_f64=error, kernel_launches=launches,
        peak_memory_gib=peak,
    )


def _sc_segment(ctt, dtype, device, grid_shape=(32, 32, 32)):
    """The space-charge segment of the JAX package's benchmark
    (``scripts/bench_all.py:415-424``): Drift-Kick-Drift-Kick-Drift, on a
    32^3 grid unless ``grid_shape`` says otherwise."""
    kw = {"dtype": dtype, "device": device}
    return ctt.Segment(
        [
            ctt.Drift(0.1, **kw),
            ctt.SpaceChargeKick(0.2, grid_shape=grid_shape, **kw),
            ctt.Drift(0.1, **kw),
            ctt.SpaceChargeKick(0.2, grid_shape=grid_shape, **kw),
            ctt.Drift(0.1, **kw),
        ]
    )


def _check_kicks(label, beam_in, out_card, out_cpu) -> dict:
    return _check_kick_particles(label, beam_in.to("cpu", torch.float64).particles,
                                 out_card.particles, out_cpu.particles)


def _kick_errors(before, actual, expected) -> dict:
    """The RMS of the difference of the kicks (px, py, p: ``actual`` and
    ``expected`` less ``before``, float64 on the CPU) over the RMS of the
    expected kick."""
    errors = {}
    for index, name in ((1, "px"), (3, "py"), (5, "p")):
        kick_expected = expected[..., index].cpu().double() - before[..., index]
        kick_actual = actual[..., index].cpu().double() - before[..., index]
        rms = torch.sqrt(torch.mean(kick_expected**2)).item()
        errors[name] = torch.sqrt(torch.mean((kick_actual - kick_expected) ** 2)).item() / rms
    return errors


def _check_kick_particles(label, before, actual, expected) -> dict:
    """:func:`_kick_errors`, each within ``KICK_RMS_TOLERANCE``."""
    errors = _kick_errors(before, actual, expected)
    for name, error in errors.items():
        check(error <= KICK_RMS_TOLERANCE[name], f"{label}: {name} kick off by {error} RMS")
    return errors


def phase_space_charge(ctt, wrappers) -> dict:
    """The 32^3 segment's forward on the card: only the untiled pair
    launches, once per kick each, and the kicks match the port's float64
    CPU run; then one 64^3 kick. Returns the segment's launches."""
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    beam = _bench_beam(ctt, NUM_PARTICLES, "cuda", generator)
    segment = _sc_segment(ctt, torch.float32, "cuda")

    _reset_launches(wrappers)
    out = segment.track(beam)
    launches = _launches(wrappers)
    expected = {name: 0 for name in wrappers} | {"deposit_multi_3d": 2, "gather_multi_3d": 2}
    check(launches == expected, f"space-charge segment launched {launches}, not {expected}")
    check(bool(torch.isfinite(out.particles).all()), "non-finite particles after the kicks")

    start = time.perf_counter()
    out_cpu = _sc_segment(ctt, torch.float64, "cpu").track(beam.to("cpu", torch.float64))
    cpu_seconds = time.perf_counter() - start
    errors = _check_kicks("segment", beam, out, out_cpu)
    ms = time_ms(lambda: segment.track(beam), runs=10)
    profile_path("space_charge_segment", lambda: segment.track(beam), ms)
    emit(
        "space_charge_segment",
        particles=NUM_PARTICLES, grid=[32, 32, 32], kicks=2, ms=ms,
        launches=launches,
        kick_rms_rel_err_vs_cpu_f64=errors, cpu_f64_seconds=cpu_seconds,
    )

    kick = ctt.SpaceChargeKick(0.5, grid_shape=(64, 64, 64), dtype=torch.float32)
    _reset_launches(wrappers)
    out = kick.track(beam)
    kick_launches = _launches(wrappers)
    check(
        kick_launches == expected | {"deposit_multi_3d": 1, "gather_multi_3d": 1},
        f"the 64^3 kick launched {kick_launches}, not each untiled kernel once",
    )
    check(bool(torch.isfinite(out.particles).all()), "non-finite particles after the 64^3 kick")
    kick_cpu = ctt.SpaceChargeKick(0.5, grid_shape=(64, 64, 64), dtype=torch.float64, device="cpu")
    errors = _check_kicks("64^3 kick", beam, out, kick_cpu.track(beam.to("cpu", torch.float64)))
    emit(
        "space_charge_kick_64",
        particles=NUM_PARTICLES, grid=[64, 64, 64], ms=time_ms(lambda: kick.track(beam), runs=10),
        kick_rms_rel_err_vs_cpu_f64=errors,
    )
    return launches


TILED_SHAPES = [(128, 128, 128), (128, 128, 64), (160, 40, 16)]


def _tiled_check_positions(generator, batch, shape, dtype):
    """Bin-space positions of a narrow Gaussian beam, so that the edge tiles
    hold few or no particles and the centre tiles are crowded, with a share
    spilling past every edge and parked (-2), NaN, +-inf and -1e30
    particles."""
    n = torch.tensor(shape, dtype=dtype, device="cuda")
    size = (batch, NUM_PARTICLES, 3)
    normalized = n / 2 + torch.randn(size, generator=generator, dtype=dtype, device="cuda") * n / 10
    spill = torch.rand(size, generator=generator, dtype=dtype, device="cuda") * (n + 2.0) - 1.5
    normalized[:, ::13] = spill[:, ::13]
    normalized[:, ::97] = -2.0
    normalized[:, 1::1009, 0] = float("nan")
    normalized[:, 2::1009, 1] = float("inf")
    normalized[:, 3::1009, 2] = -1e30
    normalized[:, 4::1009, 0] = float("inf")
    normalized[:, 5::1009, 0] = -float("inf")
    return normalized


def _bits(tensor: torch.Tensor) -> torch.Tensor:
    """The tensor's bits as integers, so that NaN compares equal to itself."""
    kinds = {torch.float32: torch.int32, torch.float64: torch.int64}
    return tensor.view(kinds[tensor.dtype]) if tensor.dtype in kinds else tensor


def _check_plan(cic_tiled, normalized, shape) -> bool:
    """The card's counting-sort plan against ``tile_plan`` (``torch.sort``)
    on the card: every field equal, bit for bit."""
    card = cic_tiled.plan_tiles(normalized, shape)
    plain = cic_tiled.tile_plan(normalized, shape)
    torch.cuda.synchronize()
    for field in ("offsets", "perm", "rank", "sorted_tile", "sorted_positions"):
        check(
            torch.equal(_bits(getattr(card, field)), _bits(getattr(plain, field))),
            f"{shape}: the card's plan differs from tile_plan in {field}",
        )
    check((card.rows_per_tile, card.num_tiles) == (plain.rows_per_tile, plain.num_tiles),
          f"{shape}: plan tiling differs")
    return True


def phase_kernels_tiled(cic_kernels, cic_tiled) -> dict:
    """The x-tiled kernels against their plain versions and against the
    untiled kernels on the card, at all 8 orders, B in {1, 4}, float32 and
    float64, on grids past the untiled bound; then timed at the 128^3
    path's shape. Returns the numbers for the ``kernels`` line."""
    generator = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst = {"deposit": 0.0, "gather": 0.0, "deposit_vs_untiled": 0.0, "gather_vs_untiled": 0.0}
    # Plus the grid with the largest window row: ny = 1, nt = 512, in f64.
    for batch, shape, dtype in [
        *itertools.product((1, 4), TILED_SHAPES, (torch.float32, torch.float64)),
        (1, (1024, 1, 512), torch.float64),
        # A window past a block's shared memory (2 MB): no windows at all.
        (1, (8, 256, 512), torch.float64),
    ]:
        check(cic_kernels.uses_tiled(shape), f"{shape} is not dispatched to the tiled kernels")
        normalized = _tiled_check_positions(generator, batch, shape, dtype)
        plan_equal = _check_plan(cic_tiled, normalized, shape)
        rows = torch.randn(
            (batch, len(ALL_ORDERS), 1, NUM_PARTICLES), generator=generator,
            dtype=dtype, device="cuda",
        )
        got = cic_tiled.deposit_multi_tiled_3d(normalized, rows, shape, ALL_ORDERS)
        want = cic_tiled.deposit_multi_tiled_3d_reference(normalized, rows, shape, ALL_ORDERS)
        untiled = cic_kernels._deposit_untiled(normalized, rows, shape, ALL_ORDERS)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "tiled deposit produced non-finite values")
        deposit_error = relative_error(got, want)[1]
        deposit_untiled = relative_error(got, untiled)[1]
        del got, want, untiled

        grids = torch.randn((batch, 3, *shape), generator=generator, dtype=dtype, device="cuda")
        got = cic_tiled.gather_multi_tiled_3d(grids, normalized, ALL_ORDERS)
        want = cic_tiled.gather_multi_tiled_3d_reference(grids, normalized, ALL_ORDERS)
        untiled = cic_kernels._gather_untiled(grids, normalized, ALL_ORDERS)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(g).all()) for g in got),
              "tiled gather produced non-finite values")
        gather_error = max(relative_error(g, w)[1] for g, w in zip(got, want))
        gather_untiled = max(relative_error(g, u)[1] for g, u in zip(got, untiled))
        gather_error = max(gather_error, _path_sets_error(
            cic_tiled.gather_multi_tiled_3d, cic_tiled.gather_multi_tiled_3d_reference, grids,
            normalized,
        ))
        emit(
            "kernel_tiled_check",
            batch=batch, grid=list(shape), particles=NUM_PARTICLES, orders=len(ALL_ORDERS),
            dtype=str(dtype).removeprefix("torch."),
            rows_per_tile=cic_tiled.rows_per_tile(shape), plan_equals_tile_plan=plan_equal,
            deposit_route=_deposit_route(cic_kernels, cic_tiled, shape, dtype, batch, 1,
                                         ALL_ORDERS),
            deposit_rel_err=deposit_error, deposit_rel_diff_untiled=deposit_untiled,
            gather_components=3, gather_rel_err=gather_error,
            gather_rel_diff_untiled=gather_untiled,
        )
        check(deposit_error <= DEPOSIT_TOLERANCE, f"tiled deposit error {deposit_error}")
        check(deposit_untiled <= DEPOSIT_TOLERANCE, f"tiled vs untiled deposit {deposit_untiled}")
        check(gather_error <= GATHER_TOLERANCE, f"tiled gather error {gather_error}")
        check(gather_untiled <= GATHER_TOLERANCE, f"tiled vs untiled gather {gather_untiled}")
        for key, value in (("deposit", deposit_error), ("gather", gather_error),
                           ("deposit_vs_untiled", deposit_untiled),
                           ("gather_vs_untiled", gather_untiled)):
            worst[key] = max(worst[key], value)
        del normalized, rows, grids, got, want, untiled

    # The plan's other layouts: past 65536 counts the scan launch runs
    # (256^3, 1M particles), past 3040 tiles each block is one warp counting
    # in global memory ((20000, 128, 4), 100k particles).
    for shape, count in (((256, 256, 256), NUM_PARTICLES), ((20000, 128, 4), 100_000)):
        normalized = _tiled_check_positions(generator, 2, shape, torch.float32)[:, :count]
        emit("plan_check", grid=list(shape), batch=2, particles=count,
             tiles=cic_tiled.tile_plan(normalized, shape).num_tiles,
             plan_equals_tile_plan=_check_plan(cic_tiled, normalized.contiguous(), shape))
        del normalized

    # The 128^3 path's shape: one instance, 1M particles of a Gaussian beam
    # on a grid of +-3 sigma, the value order; the deposit carries the
    # charge (C=1), the gather the three force components (C=3).
    shape = (128, 128, 128)
    f32 = torch.float32
    cells = shape[0] * shape[1] * shape[2]
    value = cic_kernels.VALUE
    positions = _beam_positions(generator, shape, -0.5, f32)
    charges = torch.rand((1, 1, 1, NUM_PARTICLES), generator=generator, dtype=f32, device="cuda")
    got = cic_tiled.deposit_multi_tiled_3d(positions, charges, shape, value)
    want = cic_tiled.deposit_multi_tiled_3d_reference(positions, charges, shape, value)
    deposit_abs, deposit_rel = relative_error(got, want)
    check(deposit_rel <= DEPOSIT_TOLERANCE, f"tiled deposit error {deposit_rel} at the main shape")
    deposit = {
        "ms": graph_ms(lambda: cic_tiled.deposit_multi_tiled_3d(positions, charges, shape, value)),
        "eager_ms": time_ms(
            lambda: cic_tiled.deposit_multi_tiled_3d(positions, charges, shape, value),
            per_event=10,
        ),
        "plain_ms": time_ms(
            lambda: cic_tiled.deposit_multi_tiled_3d_reference(positions, charges, shape, value),
            per_event=10,
        ),
        "untiled_ms": graph_ms(
            lambda: cic_kernels._deposit_untiled(positions, charges, shape, value)
        ),
        "plan_ms": graph_ms(lambda: cic_tiled.plan_tiles(positions, shape)),
        "max_abs_err": deposit_abs, "rel_err": deposit_rel,
        "route": _deposit_route(cic_kernels, cic_tiled, shape, f32, 1, 1),
    }
    positions_plan = cic_tiled.plan_tiles(positions, shape)
    deposit["kernel_ms"] = graph_ms(
        lambda: cic_tiled.deposit_multi_tiled_3d(positions, charges, shape, value,
                                                 plan=positions_plan)
    )
    # Inputs read once (positions, charges), the grid written once.
    deposit_bound = bound(NUM_PARTICLES * (3 + 1) * 4 + cells * 4, NUM_PARTICLES * 8 * 5)
    deposit_c3 = _deposit_c3(cic_tiled.deposit_multi_tiled_3d,
                             cic_tiled.deposit_multi_tiled_3d_reference, generator, positions,
                             shape)
    deposit_c3["kernel_ms"] = _deposit_c3(
        cic_tiled.deposit_multi_tiled_3d, cic_tiled.deposit_multi_tiled_3d_reference, generator,
        positions, shape, plan=positions_plan,
    )["ms"]
    deposit_c3["untiled_ms"] = _deposit_c3(
        cic_kernels._deposit_untiled, cic_tiled.deposit_multi_tiled_3d_reference, generator,
        positions, shape,
    )["ms"]
    deposit_c3["route"] = _deposit_route(cic_kernels, cic_tiled, shape, f32, 1, 3)

    nodes = _beam_positions(generator, shape, 0.0, f32)
    grids = torch.randn((1, 3, *shape), generator=generator, dtype=f32, device="cuda")
    (got,) = cic_tiled.gather_multi_tiled_3d(grids, nodes, value)
    (want,) = cic_tiled.gather_multi_tiled_3d_reference(grids, nodes, value)
    gather_abs, gather_rel = relative_error(got, want)
    check(gather_rel <= GATHER_TOLERANCE, f"tiled gather error {gather_rel} at the main shape")
    scale = torch.tensor([shape[2] - 1, shape[1] - 1, shape[0] - 1], dtype=f32, device="cuda")
    sample_grid = (nodes.flip(-1) / scale * 2 - 1).view(1, 1, 1, NUM_PARTICLES, 3)

    def library_gather():
        return torch.nn.functional.grid_sample(
            grids, sample_grid, mode="bilinear", padding_mode="zeros", align_corners=True
        )

    _check_plan(cic_tiled, nodes, shape)
    plan = cic_tiled.plan_tiles(nodes, shape)
    keys = torch.nan_to_num(
        torch.floor(torch.floor(nodes[..., 0]) / plan.rows_per_tile).clamp(0, plan.num_tiles - 1)
    ).to(torch.int32)
    gather = {
        "ms": graph_ms(lambda: cic_tiled.gather_multi_tiled_3d(grids, nodes, value)),
        "eager_ms": time_ms(
            lambda: cic_tiled.gather_multi_tiled_3d(grids, nodes, value), per_event=10
        ),
        "kernel_ms": graph_ms(
            lambda: cic_tiled.gather_multi_tiled_3d(grids, nodes, value, plan=plan)
        ),
        "plain_ms": time_ms(
            lambda: cic_tiled.gather_multi_tiled_3d_reference(grids, nodes, value), per_event=10
        ),
        "untiled_ms": graph_ms(lambda: cic_kernels._gather_untiled(grids, nodes, value)),
        "library_ms": graph_ms(library_gather),
        "library_eager_ms": time_ms(library_gather, per_event=10),
        "grid_sample_rel_diff": relative_error(library_gather().view(1, 3, NUM_PARTICLES), want)[1],
        "plan_ms": graph_ms(lambda: cic_tiled.plan_tiles(nodes, shape)),
        "plan_eager_ms": time_ms(lambda: cic_tiled.plan_tiles(nodes, shape), per_event=10),
        "plan_plain_ms": time_ms(lambda: cic_tiled.tile_plan(nodes, shape), per_event=10),
        # The stable sort of the keys alone, which the earlier plan ran.
        "plan_torch_sort_ms": graph_ms(lambda: torch.sort(keys, dim=1, stable=True)),
        "max_abs_err": gather_abs, "rel_err": gather_rel,
    }
    # The plan must read the positions and write the permutation (8 B),
    # the tiles (4 B) and the sorted positions once a particle.
    plan_bound = bound(NUM_PARTICLES * (3 * 4 + 8 + 4 + 3 * 4), NUM_PARTICLES * 4)
    plan_abs = (plan.sorted_positions - cic_tiled.tile_plan(nodes, shape).sorted_positions).abs()
    # Where the wrappers' time goes, the plans' sorts against the kernels:
    # one profile over one call of each.
    profile_path(
        "tiled_wrappers_main_shape",
        lambda: (cic_tiled.deposit_multi_tiled_3d(positions, charges, shape, value),
                 cic_tiled.gather_multi_tiled_3d(grids, nodes, value)),
        deposit["ms"] + gather["ms"],
    )
    # Grids and positions read once, the three outputs written once.
    gather_bound = bound(
        cells * 3 * 4 + NUM_PARTICLES * 3 * 4 + NUM_PARTICLES * 3 * 4, NUM_PARTICLES * 3 * 8 * 4
    )
    emit(
        "kernel_tiled_main_shape",
        grid=list(shape), particles=NUM_PARTICLES, rows_per_tile=cic_tiled.rows_per_tile(shape),
        deposit={**deposit, "bound_ms": deposit_bound[0]},
        deposit_c3=deposit_c3,
        gather={**gather, "bound_ms": gather_bound[0]},
        plan={"ms": gather["plan_ms"], "plain_ms": gather["plan_plain_ms"],
              "torch_sort_ms": gather["plan_torch_sort_ms"], "bound_ms": plan_bound[0]},
        worst_rel_err_all_orders=worst,
    )
    return {
        "plan": dict(
            ms=gather["plan_ms"], eager_ms=gather["plan_eager_ms"],
            plain_ms=gather["plan_plain_ms"], bound_ms=plan_bound[0],
            bound_by=plan_bound[1], library_ms=None,
            max_abs_err=float(plan_abs.nan_to_num(0.0).max()),
        ),
        "deposit": dict(
            ms=deposit["ms"], eager_ms=deposit["eager_ms"], plain_ms=deposit["plain_ms"],
            bound_ms=deposit_bound[0], bound_by=deposit_bound[1], library_ms=None,
            max_abs_err=deposit_abs, kernel_ms=deposit["kernel_ms"],
            c3_ms=deposit_c3["ms"], c3_kernel_ms=deposit_c3["kernel_ms"],
            c3_bound_ms=deposit_c3["bound_ms"],
        ),
        "gather": dict(
            ms=gather["ms"], eager_ms=gather["eager_ms"], plain_ms=gather["plain_ms"],
            bound_ms=gather_bound[0], bound_by=gather_bound[1],
            library_ms=gather["library_ms"], max_abs_err=gather_abs,
        ),
    }


def deposit_repeats(cic_kernels, runs: int = DETERMINISM_RUNS):
    """Every deposit route ``runs`` times on identical inputs (the grids of
    DETERMINISM_SHAPES and TILED_SHAPES, float32 and float64, the tiled
    checks' Gaussian beam for B = 1 and 4 and the crowded beam, the value
    and raised order sets, C = 1 and 3), through ``deposit_multi_3d`` as a
    path calls it. Yields each case's description with ``bits_equal``
    (every run's output bit for bit the first's), its inputs and its first
    output."""
    generator = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for shape in [*DETERMINISM_SHAPES, *TILED_SHAPES]:
        for dtype in (torch.float32, torch.float64):
            beams = (("gaussian", _tiled_check_positions(generator, 1, shape, dtype)),
                     ("gaussian", _tiled_check_positions(generator, 4, shape, dtype)),
                     ("crowded", _crowded_positions(generator, 1, shape, dtype)))
            for beam, normalized in beams:
                for orders, components in itertools.product((VALUE, RAISED), (1, 3)):
                    rows = torch.randn((normalized.shape[0], len(orders), components,
                                        NUM_PARTICLES), generator=generator, dtype=dtype,
                                       device="cuda")
                    outs = [cic_kernels.deposit_multi_3d(normalized, rows, shape, orders)
                            for _ in range(runs)]
                    first = _bits(outs[0])
                    case = {"grid": list(shape), "dtype": str(dtype).removeprefix("torch."),
                            "beam": beam, "batch": normalized.shape[0],
                            "orders": "value" if orders == VALUE else "raised",
                            "components": components,
                            "bits_equal": all(torch.equal(_bits(out), first) for out in outs)}
                    yield case, normalized, rows, orders, outs[0]
                    del outs, first, rows
            del beams, normalized


def _float64_bound(cic_common, normalized, rows, shape) -> float:
    """The float64 value-order deposit's bound against its plain version
    (DETERMINISM_SHAPES' note): 2 K S 2^-61 + 2 K 2^-53 A."""
    counts = torch.zeros(normalized.shape[0] * math.prod(shape), dtype=torch.int64,
                         device="cuda")
    base = torch.arange(normalized.shape[0], device="cuda")[:, None] * math.prod(shape)
    for cell, valid, _ in cic_common._corner_terms(normalized, shape, VALUE):
        counts += torch.bincount((base + cell)[valid], minlength=counts.numel())
    terms = int(counts.max())
    bound = rows.shape[-1] * rows.abs().max().item()
    cell_sum = cic_common.deposit_cells(normalized, rows.abs(), shape, VALUE,
                                        math.prod(shape)).max().item()
    return 2 * terms * bound * 2.0**-61 + 2 * terms * 2.0**-53 * cell_sum


def _screen_repeats(ctt) -> list:
    """Each screen reading of phase_screen_readings taken twice on the same
    beam: whether the two images are equal bit for bit."""
    beam = _bench_beam(ctt, 100_000, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
    results = []
    for method, binning in SCREEN_CASES:
        segment = _screen_segment(torch.float32, "cuda", method, binning)
        first, second = _read_screen(segment, beam), _read_screen(segment, beam)
        results.append({"method": method, "binning": binning,
                        "bits_equal": torch.equal(_bits(first), _bits(second))})
    return results


def _nonfinite_row_cases(cic_kernels, cic_tiled) -> list:
    """Deposits whose rows hold NaN, +inf and -inf, on a particle off the
    grid and on particles in the beam's core, on each route (the exact
    windows give way to their in-order float path, the int64 grids mark
    poison bits): the cells that are NaN and infinite equal the plain
    version's, the finite ones within DEPOSIT_TOLERANCE, and two runs equal
    bit for bit."""
    generator = torch.Generator(device="cuda").manual_seed(SEED + 7)
    results = []
    for shape, dtype in (((32, 32, 32), torch.float32), ((16, 16, 16), torch.float64),
                         ((64, 64, 64), torch.float32), ((128, 128, 128), torch.float32),
                         ((128, 128, 128), torch.float64)):
        normalized = _beam_positions(generator, shape, -0.5, dtype)
        rows = torch.rand((1, 1, 1, NUM_PARTICLES), generator=generator, dtype=dtype,
                          device="cuda")
        rows[0, 0, 0, :4] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                                          float("inf")], dtype=dtype)
        normalized[0, 3] = -5.0  # the last +inf row's particle lies off the grid
        first, second = (cic_kernels.deposit_multi_3d(normalized, rows, shape, VALUE)
                         for _ in range(2))
        want = cic_kernels.deposit_multi_3d_reference(normalized, rows, shape, VALUE)
        finite = torch.isfinite(want)
        case = {
            "grid": list(shape), "dtype": str(dtype).removeprefix("torch."),
            "route": _deposit_route(cic_kernels, cic_tiled, shape, dtype, 1, 1),
            "bits_equal": torch.equal(_bits(first), _bits(second)),
            "non_finite_equal": torch.equal(torch.isnan(first), torch.isnan(want))
            and torch.equal(torch.isposinf(first), torch.isposinf(want))
            and torch.equal(torch.isneginf(first), torch.isneginf(want)),
            "non_finite_cells": int((~finite).sum()),
            "rel_err": relative_error(first[finite], want[finite])[1],
        }
        results.append(case)
    return results


def phase_determinism(ctt, cic_kernels, cic_tiled) -> None:
    """Every deposit route, DETERMINISM_RUNS times on identical inputs
    (:func:`deposit_repeats`), each output bit for bit the first; each
    against its plain version within DEPOSIT_TOLERANCE, and in float64 at
    the value order set within its stated bound (:func:`_float64_bound`).
    Then every screen reading twice, bit for bit, and the deposits of
    non-finite rows (:func:`_nonfinite_row_cases`). One line per grid and
    dtype, then the checks, so that a tree whose deposits do not repeat
    shows every case before it fails."""
    from cheetah_tpu_torch.ops import cic_common

    start = time.perf_counter()
    cases, lines = [], {}
    for case, normalized, rows, orders, out in deposit_repeats(cic_kernels):
        shape, dtype = tuple(case["grid"]), out.dtype
        want = cic_kernels.deposit_multi_3d_reference(normalized, rows, shape, orders)
        absolute, case["rel_err"] = relative_error(out, want)
        if dtype == torch.float64 and orders == VALUE:
            case["f64_bound"] = _float64_bound(cic_common, normalized, rows, shape)
            case["f64_abs_err"] = absolute
        case["route"] = _deposit_route(cic_kernels, cic_tiled, shape, dtype, case["batch"],
                                       case["components"], orders)
        cases.append(case)
        lines.setdefault((shape, case["dtype"]), []).append(case)
        del want
    for (shape, dtype), grid_cases in lines.items():
        emit("determinism", grid=list(shape), dtype=dtype, runs=DETERMINISM_RUNS,
             particles=NUM_PARTICLES, cases=[{k: v for k, v in case.items()
                                               if k not in ("grid", "dtype")}
                                              for case in grid_cases])
    screens = _screen_repeats(ctt)
    nonfinite = _nonfinite_row_cases(cic_kernels, cic_tiled)
    repeated = sum(case["bits_equal"] for case in cases)
    emit("determinism_summary", deposit_cases=len(cases), repeated_bit_for_bit=repeated,
         routes=sorted({case["route"] for case in cases}), screens=screens,
         non_finite_rows=nonfinite, seconds=time.perf_counter() - start)
    check(repeated == len(cases),
          f"{len(cases) - repeated} of {len(cases)} deposit cases differ between runs")
    check(all(screen["bits_equal"] for screen in screens), f"screens differ: {screens}")
    for case in nonfinite:
        check(case["bits_equal"] and case["non_finite_equal"] and case["non_finite_cells"] > 0
              and case["rel_err"] <= DEPOSIT_TOLERANCE, f"deposit of non-finite rows {case}")
    for case in cases:
        check(case["rel_err"] <= DEPOSIT_TOLERANCE, f"deposit {case}: off its plain version")
        check(case.get("f64_abs_err", 0.0) <= case.get("f64_bound", 0.0),
              f"deposit {case}: past its float64 bound")


def phase_gather_order_sets(cic_kernels, cic_tiled) -> dict:
    """The gathers at the order sets and component counts of the paths, on
    the 32^3 and 64^3 grids (untiled kernels) and the 128^3 grid (tiled
    kernels, with and without its plan), 1M particles of a Gaussian beam in
    float32: against their plain versions, timed, with their bounds; and
    the staged kernels against the L1/L2 ones (:func:`_unaligned`). Returns
    the numbers by grid and set."""
    generator = torch.Generator(device="cuda").manual_seed(SEED + 3)
    f32 = torch.float32
    results = {}
    for side in (32, 64, 128):
        shape = (side, side, side)
        cells = side**3
        tiled = cic_kernels.uses_tiled(shape)
        nodes = _beam_positions(generator, shape, 0.0, f32)
        grids = torch.randn((1, 3, *shape), generator=generator, dtype=f32, device="cuda")
        plan = cic_tiled.plan_tiles(nodes, shape) if tiled else None
        for label, orders, components in PATH_ORDER_SETS:
            values = grids[:, :components].contiguous()
            if tiled:
                got = cic_tiled.gather_multi_tiled_3d(values, nodes, orders)
                want = cic_tiled.gather_multi_tiled_3d_reference(values, nodes, orders)
            else:
                got = cic_kernels.gather_multi_3d(values, nodes, orders)
                want = cic_kernels.gather_multi_3d_reference(values, nodes, orders)
            errors = [relative_error(g, w) for g, w in zip(got, want)]
            rel = max(e[1] for e in errors)
            check(rel <= GATHER_TOLERANCE, f"{shape} {label}: gather error {rel}")
            wrapper = cic_tiled.gather_multi_tiled_3d if tiled else cic_kernels.gather_multi_3d
            plain = (cic_tiled.gather_multi_tiled_3d_reference if tiled
                     else cic_kernels.gather_multi_3d_reference)
            entry = {
                "ms": graph_ms(lambda: wrapper(values, nodes, orders)),
                "eager_ms": time_ms(lambda: wrapper(values, nodes, orders), per_event=10),
                "plain_ms": time_ms(lambda: plain(values, nodes, orders), per_event=10),
                "max_abs_err": max(e[0] for e in errors), "rel_err": rel,
            }
            # The grid as the path gives it (staged in shared memory where
            # the grid or the tile's window fits) and unaligned (read through
            # L1 and L2), in turns; kernels alone, with the plan made before.
            unaligned = _unaligned(values)
            for key in ("as_given", "l1_l2", "l1_l2", "as_given"):
                given = values if key == "as_given" else unaligned
                got = wrapper(given, nodes, orders, **({"plan": plan} if tiled else {}))
                rel = max(relative_error(g, w)[1] for g, w in zip(got, want))
                check(rel <= GATHER_TOLERANCE, f"{shape} {label} {key}: gather error {rel}")
                ms = graph_ms(
                    lambda: wrapper(given, nodes, orders, **({"plan": plan} if tiled else {}))
                )
                entry[f"{key}_kernel_ms"] = min(ms, entry.get(f"{key}_kernel_ms", ms))
            if tiled:
                entry["kernel_ms"] = graph_ms(
                    lambda: cic_tiled.gather_multi_tiled_3d(values, nodes, orders, plan=plan)
                )
            # Grid and positions read once, the O * C outputs written once.
            size, count = 4, len(orders)
            entry["bound_ms"] = bound(
                size * (components * cells + NUM_PARTICLES * (3 + count * components)),
                NUM_PARTICLES * components * 8 * 4 * count,
            )[0]
            results[f"{side}_{label}"] = entry
            del got, want
        emit("gather_order_sets", grid=list(shape), particles=NUM_PARTICLES, dtype="float32",
             kernel="gather_multi_tiled_3d" if tiled else "gather_multi_3d",
             sets={label: results[f"{side}_{label}"] for label, _, _ in PATH_ORDER_SETS})
    return results


def phase_autograd_kernels(cic_kernels, wrappers) -> None:
    """gradcheck and gradgradcheck of the autograd closure in float64 on
    the card, on an untiled and a tiled grid (the backward of a backward
    stays on the kernels). Atomic sums may differ in the last bits between
    two backward passes, so ``nondet_tol`` allows 1e-12."""
    generator = torch.Generator(device="cuda").manual_seed(SEED + 2)
    orders = ((0, 0, 0), (1, 0, 0), (0, 1, 1))
    results = []
    for shape in ((8, 7, 6), (1025, 4, 2)):
        n = torch.tensor(shape, dtype=torch.float64, device="cuda")
        positions = torch.rand(
            (1, 24, 3), generator=generator, dtype=torch.float64, device="cuda"
        ) * (n - 0.6) - 0.8
        # Off the integers, where the weights have kinks.
        near = (positions - positions.round()).abs() < 0.05
        normalized = (positions + 0.1 * near).requires_grad_()
        grids = torch.randn(
            (1, 2, *shape), generator=generator, dtype=torch.float64, device="cuda"
        ).requires_grad_()
        rows = torch.randn(
            (1, len(orders), 2, 24), generator=generator, dtype=torch.float64, device="cuda"
        ).requires_grad_()
        options = {"fast_mode": True, "atol": 1e-7, "rtol": 1e-6, "nondet_tol": 1e-12}

        def gather(g, p):
            return cic_kernels.differentiable_gather(g, p, orders)

        def deposit(p, r):
            return cic_kernels.differentiable_deposit(p, r, shape, orders)

        _reset_launches(wrappers)
        check(torch.autograd.gradcheck(gather, (grids, normalized), **options), "gradcheck gather")
        check(torch.autograd.gradgradcheck(gather, (grids, normalized), **options),
              "gradgradcheck gather")
        check(torch.autograd.gradcheck(deposit, (normalized, rows), **options), "gradcheck deposit")
        check(torch.autograd.gradgradcheck(deposit, (normalized, rows), **options),
              "gradgradcheck deposit")
        launches = _launches(wrappers)
        tiled = cic_kernels.uses_tiled(shape)
        used = [name for name, count in launches.items() if count > 0]
        check(
            sorted(used) == sorted(name for name in wrappers if (name in TILED_WRAPPERS) == tiled),
            f"{shape}: the checks launched {launches}",
        )
        results.append({"grid": list(shape), "tiled": tiled, "launches": launches})
    emit("autograd_kernels", dtype="float64", orders=[list(o) for o in orders],
         checks=["gradcheck", "gradgradcheck"], passed=True, grids=results)


def _sc_value_and_grad(segment, beam, length_value):
    """sum(px^2) after the segment and its derivative with respect to the
    first drift's length (``space_charge_grad`` of ``scripts/bench_all.py``)."""
    length = torch.tensor(
        length_value, dtype=beam.particles.dtype, device=beam.particles.device,
        requires_grad=True,
    )
    segment.elements[0].length = length
    value = torch.sum(torch.square(segment.track(beam).px))
    (grad,) = torch.autograd.grad(value, length)
    return value.detach(), grad


def phase_sc_grad(ctt, wrappers, grid_shape, uses_tiled: bool) -> tuple[dict, dict]:
    """value_and_grad of the space-charge segment at 1M particles on the
    card (float32): launches of the forward and of the backward (tile plans
    included, none of them by ``torch.sort``), the gradient against the
    port's float64 CPU run and against a float64 central difference on the
    card, the CUDA-event time and a profile. Returns the launches and the
    profile's CIC kernel times."""
    from cheetah_tpu_torch.ops import cic_tiled

    label = f"sc_grad_{grid_shape[0]}"
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    beam = _bench_beam(ctt, NUM_PARTICLES, "cuda", generator)
    segment = _sc_segment(ctt, torch.float32, "cuda", grid_shape)

    length = torch.tensor(0.1, device="cuda", requires_grad=True)
    segment.elements[0].length = length
    sorts_before = cic_tiled.tile_plan.calls
    _reset_launches(wrappers)
    value = torch.sum(torch.square(segment.track(beam).px))
    forward = _launches(wrappers)
    _reset_launches(wrappers)
    (grad,) = torch.autograd.grad(value, length)
    backward = _launches(wrappers)
    check(cic_tiled.tile_plan.calls == sorts_before, f"{label}: a plan went through torch.sort")
    check(bool(torch.isfinite(grad)) and grad.item() != 0, f"{label}: gradient {grad.item()}")
    # Per kick: forward, one deposit (charge) and one gather (forces);
    # backward, the gather's transpose (one deposit of the force
    # gradients), its raised-order gather for the positions, and the
    # deposit's raised-order gather for the positions (the charges need no
    # gradient). Only the pair that the grid is dispatched to may launch.
    # On the tiled pair each kick's deposit and gather make one plan each,
    # in forward, which every launch of their backward reuses.
    kind = "tiled_3d" if uses_tiled else "3d"
    expected_forward = {name: 0 for name in wrappers}
    expected_backward = dict(expected_forward)
    expected_forward.update({f"deposit_multi_{kind}": 2, f"gather_multi_{kind}": 2})
    expected_backward.update({f"deposit_multi_{kind}": 2, f"gather_multi_{kind}": 4})
    if uses_tiled:
        expected_forward["plan_tiles"] = 4
    check(forward == expected_forward and backward == expected_backward,
          f"{label}: launches forward {forward}, backward {backward}")

    start = time.perf_counter()
    value_cpu, grad_cpu = _sc_value_and_grad(
        _sc_segment(ctt, torch.float64, "cpu", grid_shape), beam.to("cpu", torch.float64), 0.1
    )
    cpu_seconds = time.perf_counter() - start
    f32_error = abs(grad.item() - grad_cpu.item()) / abs(grad_cpu.item())

    segment64 = _sc_segment(ctt, torch.float64, "cuda", grid_shape)
    beam64 = beam.to(dtype=torch.float64)
    _, grad64 = _sc_value_and_grad(segment64, beam64, 0.1)
    f64_error = abs(grad64.item() - grad_cpu.item()) / abs(grad_cpu.item())

    def loss64(length_value):
        segment64.elements[0].length = torch.tensor(
            length_value, dtype=torch.float64, device="cuda"
        )
        return torch.sum(torch.square(segment64.track(beam64).px)).item()

    with torch.no_grad():
        fd = (loss64(0.1 + SC_GRAD_FD_STEP) - loss64(0.1 - SC_GRAD_FD_STEP)) / (2 * SC_GRAD_FD_STEP)
    fd_error = abs(fd - grad64.item()) / abs(grad64.item())

    ms = time_ms(lambda: _sc_value_and_grad(segment, beam, 0.1), runs=10, warmup=2)
    families = profile_path(
        label, lambda: _sc_value_and_grad(segment, beam, 0.1), ms
    )["cic_kernels"]
    emit(
        label,
        particles=NUM_PARTICLES, grid=list(grid_shape), dtype="float32", ms=ms,
        value=value.item(), grad=grad.item(),
        launches={"forward": forward, "backward": backward},
        grad_cpu_f64=grad_cpu.item(), grad_rel_err_vs_cpu_f64=f32_error,
        grad_card_f64=grad64.item(), card_f64_rel_err_vs_cpu_f64=f64_error,
        finite_difference_f64=fd, fd_step=SC_GRAD_FD_STEP, fd_rel_diff=fd_error,
        cpu_f64_seconds=cpu_seconds,
    )
    check(f32_error <= SC_GRAD_F32_RTOL[grid_shape], f"{label}: f32 gradient off by {f32_error}")
    check(f64_error <= SC_GRAD_F64_RTOL, f"{label}: f64 gradient off by {f64_error}")
    check(fd_error <= SC_GRAD_FD_RTOL, f"{label}: finite difference off by {fd_error}")
    return {name: forward[name] + backward[name] for name in wrappers}, families


def phase_env_step_grad(ctt, wrappers) -> None:
    """d sum(sigma_x) / d k1 of the env step on the card (float32), one
    instance at exactly k1 = 0, against the port's float64 CPU gradient."""
    from cheetah_tpu_torch.lattices import ares_ea_subcell

    num_instances, num_particles = 4096, 10_000
    zero = num_instances // 2
    segment = ares_ea_subcell(torch.float32)
    k1 = torch.linspace(-20, 20, num_instances, device="cuda")
    k1[zero] = 0.0
    k1.requires_grad_()
    segment.AREAMQZM1.k1 = k1
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    beam = _bench_beam(ctt, num_particles, "cuda", generator)

    def value_and_grad():
        value = segment.track(beam).sigma_x.sum()
        return value.detach(), torch.autograd.grad(value, k1)[0]

    _reset_launches(wrappers)
    _, grad = value_and_grad()
    launches = _launches(wrappers)
    check(tuple(grad.shape) == (num_instances,), f"k1 gradient shape {tuple(grad.shape)}")
    check(bool(torch.isfinite(grad).all()), "non-finite k1 gradient")

    picks = sorted({*torch.linspace(0, num_instances - 1, 8).round().long().tolist(), zero})
    reference = ares_ea_subcell(torch.float64, device="cpu")
    k1_cpu = k1.detach()[picks].cpu().double().requires_grad_()
    reference.AREAMQZM1.k1 = k1_cpu
    (expected,) = torch.autograd.grad(
        reference.track(beam.to("cpu", torch.float64)).sigma_x.sum(), k1_cpu
    )
    actual = grad[picks].cpu().double()
    error = ((actual - expected).abs().max() / expected.abs().max()).item()
    ms = time_ms(value_and_grad, runs=10)
    profile_path("env_step_grad", value_and_grad, ms)
    emit(
        "env_step_grad",
        instances=num_instances, particles=num_particles, ms=ms,
        grad_at_k1_zero=grad[zero].item(),
        grad_at_k1_zero_cpu_f64=expected[picks.index(zero)].item(),
        grad_err_vs_cpu_f64=error, kernel_launches=launches,
    )
    check(error <= ENV_GRAD_TOLERANCE, f"env step k1 gradient off by {error}")


def _no_cic_launches(wrappers, label: str) -> dict:
    """The CIC kernels' launch counts since the last reset, which must all
    be 0: the diagnostics paths run no hand-written kernel."""
    launches = _launches(wrappers)
    check(not any(launches.values()), f"{label} launched CIC kernels: {launches}")
    return launches


def phase_parameter_beam_env_step(ctt, wrappers) -> None:
    """The ARES EA env step with the ParameterBeam of
    ``scripts/bench_all.py:300-308``: 4096 instances of ``k1``, f32, every
    instance's sigma_x against the port's float64 CPU run."""
    from cheetah_tpu_torch.lattices import ares_ea_subcell

    num_instances = 4096
    segment = ares_ea_subcell(torch.float32)
    segment.AREAMQZM1.k1 = torch.linspace(-20, 20, num_instances, device="cuda")
    beam = ctt.ParameterBeam.from_twiss(
        beta_x=5.0, emittance_x=2e-9, beta_y=3.0, emittance_y=2e-9, energy=1.54e8,
        dtype=torch.float32, device="cuda",
    )

    _reset_launches(wrappers)
    sigma_x = segment.track(beam).sigma_x
    launches = _no_cic_launches(wrappers, "the ParameterBeam env step")
    check(tuple(sigma_x.shape) == (num_instances,), f"sigma_x shape {tuple(sigma_x.shape)}")
    check(bool(torch.isfinite(sigma_x).all()), "non-finite sigma_x")

    reference = ares_ea_subcell(torch.float64, device="cpu")
    reference.AREAMQZM1.k1 = segment.AREAMQZM1.k1.cpu().double()
    expected = reference.track(beam.to("cpu", torch.float64)).sigma_x
    error = ((sigma_x.cpu().double() - expected).abs() / expected).max().item()

    def step():
        return segment.track(beam).sigma_x

    ms = time_ms(step, runs=50)
    profile_path("parameter_beam_env_step", step, ms)
    emit(
        "parameter_beam_env_step",
        instances=num_instances, elements=len(segment.elements), ms=ms, graph_ms=graph_ms(step),
        sigma_x_rel_err_vs_cpu_f64=error, cic_kernel_launches=launches,
    )
    check(error <= PARAMETER_BEAM_RTOL, f"ParameterBeam sigma_x off by {error} relative")


def phase_env_moments(ctt, wrappers) -> None:
    """``Segment.track_moments`` of the 10k-particle beam through the 4096
    instances (``env_moments`` of ``scripts/bench_all.py:155-165``): sigma_x
    against ``track(...).sigma_x`` on the card and the port's float64 CPU
    run of ``track_moments``."""
    from cheetah_tpu_torch.lattices import ares_ea_subcell

    num_instances, num_particles = 4096, 10_000
    segment = ares_ea_subcell(torch.float32)
    segment.AREAMQZM1.k1 = torch.linspace(-20, 20, num_instances, device="cuda")
    beam = _bench_beam(ctt, num_particles, "cuda", torch.Generator(device="cuda").manual_seed(SEED))

    _reset_launches(wrappers)
    moments = segment.track_moments(beam)
    launches = _no_cic_launches(wrappers, "track_moments")
    check(isinstance(moments, ctt.ParameterBeam), f"track_moments gave {type(moments)}")
    sigma_x = moments.sigma_x
    check(bool(torch.isfinite(sigma_x).all()), "non-finite track_moments sigma_x")
    tracked = segment.track(beam).sigma_x
    vs_track = ((sigma_x - tracked).abs() / tracked).max().item()

    reference = ares_ea_subcell(torch.float64, device="cpu")
    reference.AREAMQZM1.k1 = segment.AREAMQZM1.k1.cpu().double()
    expected = reference.track_moments(beam.to("cpu", torch.float64)).sigma_x
    vs_cpu = ((sigma_x.cpu().double() - expected).abs() / expected).max().item()

    def step():
        return segment.track_moments(beam).sigma_x

    ms = time_ms(step, runs=50)
    profile_path("env_moments", step, ms)
    emit(
        "env_moments",
        instances=num_instances, particles=num_particles, ms=ms,
        track_ms=time_ms(lambda: segment.track(beam).sigma_x, runs=20),
        sigma_x_rel_diff_vs_track=vs_track, sigma_x_rel_err_vs_cpu_f64=vs_cpu,
        cic_kernel_launches=launches,
    )
    check(vs_track <= MOMENTS_RTOL, f"track_moments vs track: sigma_x off by {vs_track}")
    check(vs_cpu <= MOMENTS_RTOL, f"track_moments sigma_x off by {vs_cpu} against the CPU")


SCREEN_CASES = (("histogram", 1), ("cloud-in-cell", 1), ("kde", 8), ("kde", 1))


def _screen_segment(dtype, device, method, binning):
    from cheetah_tpu_torch.lattices import ares_ea_subcell

    segment = ares_ea_subcell(dtype, device=device, screen=True)
    segment.AREABSCR1.method = method
    segment.AREABSCR1.binning = binning
    return segment


def _read_screen(segment, beam) -> torch.Tensor:
    return segment.track_with_readings(beam)[1]["AREABSCR1"]


def _image_errors(method: str, image: torch.Tensor, expected: torch.Tensor) -> dict:
    image, expected = image.cpu().double(), expected.cpu().double()
    mass = expected.sum().item()
    errors = {"mass_rel_err": abs(image.sum().item() - mass) / abs(mass)}
    if method == "histogram":
        errors["l1_over_mass"] = (image - expected).abs().sum().item() / abs(mass)
        check(errors["l1_over_mass"] <= HISTOGRAM_L1_TOLERANCE, f"{method}: {errors}")
    else:
        errors["max_rel_err"] = relative_error(image, expected)[1]
        check(errors["max_rel_err"] <= IMAGE_MAX_TOLERANCE, f"{method}: {errors}")
    check(errors["mass_rel_err"] <= IMAGE_MASS_RTOL, f"{method}: {errors}")
    return errors


def phase_screen_readings(ctt, wrappers) -> None:
    """``ares_ea_subcell(screen=True)`` read through ``track_with_readings``
    with the 100k-particle beam of ``scripts/bench_all.py:115-128``, in each
    method of ``bench_all.py:326-348`` (histogram, cloud-in-cell, KDE at
    binning 8, KDE at binning 1 on its window), each image against a
    float64 run of the port: on the CPU, or for the KDE at binning 1 the
    card's own float64 run plus a 10k-particle float64 run on the CPU."""
    from cheetah_tpu_torch.utils import kde

    num_particles = 100_000
    generator = torch.Generator(device="cuda").manual_seed(SEED)
    beam = _bench_beam(ctt, num_particles, "cuda", generator)
    beam_cpu = beam.to("cpu", torch.float64)
    for method, binning in SCREEN_CASES:
        label = f"screen_{method.replace('-', '_')}_binning{binning}"
        segment = _screen_segment(torch.float32, "cuda", method, binning)
        _reset_launches(wrappers)
        image = _read_screen(segment, beam)
        launches = _no_cic_launches(wrappers, label)
        nx, ny = segment.AREABSCR1.effective_resolution
        check(tuple(image.shape) == (ny, nx), f"{label}: image shape {tuple(image.shape)}")
        check(bool(torch.isfinite(image).all()), f"{label}: non-finite image")
        fields = {}
        if method == "kde" and binning == 1:
            at_screen = segment.track(beam)
            screen = segment.AREABSCR1
            _, _, fits = kde.window_placement(
                at_screen.x, at_screen.y, *screen.pixel_bin_centers, screen.kde_bandwidth,
                512,
            )
            fields["kde_window"] = "held" if fits else "fell back to the full evaluation"
            card64 = _read_screen(_screen_segment(torch.float64, "cuda", method, binning),
                                  beam.to(dtype=torch.float64))
            fields["vs_card_f64"] = _image_errors(method, image, card64)
            small = _bench_beam(ctt, 10_000, "cuda",
                                torch.Generator(device="cuda").manual_seed(SEED + 1))
            start = time.perf_counter()
            small_cpu = _read_screen(_screen_segment(torch.float64, "cpu", method, binning),
                                     small.to("cpu", torch.float64))
            fields["cpu_f64_seconds"] = time.perf_counter() - start
            fields["vs_cpu_f64_10k"] = _image_errors(method, _read_screen(segment, small),
                                                     small_cpu)
        else:
            start = time.perf_counter()
            expected = _read_screen(_screen_segment(torch.float64, "cpu", method, binning),
                                    beam_cpu)
            fields["cpu_f64_seconds"] = time.perf_counter() - start
            fields["vs_cpu_f64"] = _image_errors(method, image, expected)

        def read():
            return _read_screen(segment, beam)

        ms = time_ms(read, runs=10)
        profile_path(label, read, ms)
        emit("screen_readings", case=label, particles=num_particles, pixels=[nx, ny],
             dtype="float32", ms=ms, cic_kernel_launches=launches, **fields)


def _centroid(segment) -> tuple:
    """``centroid_loss`` of ``scripts/bench_all.py:359-365`` on the beam's
    reading of AREABSCR1."""

    def loss(beam):
        image = _read_screen(segment, beam)
        centers_x, _ = segment.AREABSCR1.pixel_bin_centers
        column_mass = torch.sum(image, dim=-2)
        return torch.sum(column_mass * centers_x) / torch.sum(column_mass)

    return loss


def _centroid_value_and_grads(segment, beam, k1: float, angle: float):
    """The centroid and its gradients with respect to AREAMQZM1's k1 and
    AREAMCHM1's angle."""
    dtype, device = beam.particles.dtype, beam.particles.device
    k1 = torch.tensor(k1, dtype=dtype, device=device, requires_grad=True)
    angle = torch.tensor(angle, dtype=dtype, device=device, requires_grad=True)
    segment.AREAMQZM1.k1 = k1
    segment.AREAMCHM1.angle = angle
    value = _centroid(segment)(beam)
    grad_k1, grad_angle = torch.autograd.grad(value, (k1, angle))
    return value.item(), grad_k1.item(), grad_angle.item()


def phase_grad_screen_centroid(ctt, wrappers) -> None:
    """value_and_grad of the AREABSCR1 centroid (cloud-in-cell, binning 1)
    at ``k1 = 4.0``, 10k particles, f32 on the card, against the port's
    float64 CPU run and a float64 central difference on the card."""
    num_particles, k1, angle = 10_000, 4.0, -1e-4
    beam = _bench_beam(ctt, num_particles, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
    segment = _screen_segment(torch.float32, "cuda", "cloud-in-cell", 1)
    _reset_launches(wrappers)
    value, grad_k1, grad_angle = _centroid_value_and_grads(segment, beam, k1, angle)
    launches = _no_cic_launches(wrappers, "grad_screen_centroid")

    start = time.perf_counter()
    beam_cpu = beam.to("cpu", torch.float64)
    segment_cpu = _screen_segment(torch.float64, "cpu", "cloud-in-cell", 1)
    cpu = _centroid_value_and_grads(segment_cpu, beam_cpu, k1, angle)
    cpu_seconds = time.perf_counter() - start
    k1_atol = CENTROID_K1_GRAD_ATOL_PER_SIGMA * segment_cpu.track(beam_cpu).sigma_x.item()

    segment64 = _screen_segment(torch.float64, "cuda", "cloud-in-cell", 1)
    beam64 = beam.to(dtype=torch.float64)
    card64 = _centroid_value_and_grads(segment64, beam64, k1, angle)

    def centroid64(k1_value, angle_value):
        segment64.AREAMQZM1.k1 = torch.tensor(k1_value, dtype=torch.float64, device="cuda")
        segment64.AREAMCHM1.angle = torch.tensor(angle_value, dtype=torch.float64, device="cuda")
        return _centroid(segment64)(beam64).item()

    with torch.no_grad():
        fd_k1 = (centroid64(k1 + 1e-3, angle) - centroid64(k1 - 1e-3, angle)) / 2e-3
        fd_angle = (centroid64(k1, angle + 1e-6) - centroid64(k1, angle - 1e-6)) / 2e-6

    ms = time_ms(lambda: _centroid_value_and_grads(segment, beam, k1, angle), runs=10)
    profile_path("grad_screen_centroid",
                 lambda: _centroid_value_and_grads(segment, beam, k1, angle), ms)
    value_error = abs(value - cpu[0]) / abs(cpu[0])
    angle_error = abs(grad_angle - cpu[2]) / abs(cpu[2])
    fd_angle_error = abs(fd_angle - card64[2]) / abs(card64[2])
    emit(
        "grad_screen_centroid",
        particles=num_particles, pixels=[2448, 2040], method="cloud-in-cell", dtype="float32",
        ms=ms, value=value, value_cpu_f64=cpu[0], value_rel_err=value_error,
        grad_k1=grad_k1, grad_k1_cpu_f64=cpu[1], grad_k1_card_f64=card64[1],
        finite_difference_k1_f64=fd_k1, grad_k1_atol=k1_atol,
        grad_angle=grad_angle, grad_angle_cpu_f64=cpu[2], grad_angle_rel_err=angle_error,
        grad_angle_card_f64=card64[2], finite_difference_angle_f64=fd_angle,
        fd_angle_rel_diff=fd_angle_error, cpu_f64_seconds=cpu_seconds,
        cic_kernel_launches=launches,
    )
    check(value_error <= CENTROID_RTOL, f"centroid off by {value_error}")
    check(abs(grad_k1 - cpu[1]) <= k1_atol, f"k1 gradient {grad_k1} against {cpu[1]}")
    check(abs(card64[1] - fd_k1) <= k1_atol, f"k1 gradient {card64[1]} against its FD {fd_k1}")
    check(angle_error <= CENTROID_ANGLE_GRAD_RTOL, f"angle gradient off by {angle_error}")
    check(fd_angle_error <= CENTROID_FD_RTOL, f"angle FD off by {fd_angle_error}")


def _nonlinear_chain(ctt, dtype, device="cuda"):
    """BASELINE config 3 (``scripts/bench_all.py:379-410``): a cavity, a
    drift-kick-drift dipole and a second-order sextupole between drifts."""
    kw = {"dtype": dtype, "device": device}
    return ctt.Segment(
        [
            ctt.Drift(0.2, **kw),
            ctt.Cavity(1.0, voltage=2e7, phase=30.0, frequency=1.3e9, name="cav", **kw),
            ctt.Drift(0.2, **kw),
            ctt.Dipole(0.4, angle=0.15, tracking_method="drift_kick_drift", name="dip", **kw),
            ctt.Drift(0.2, **kw),
            ctt.Sextupole(0.2, k2=60.0, name="sext", **kw),
            ctt.Drift(0.2, **kw),
        ]
    )


def phase_nonlinear_chain(ctt, wrappers) -> None:
    """Config 3 at 100k particles (the beam of ``bench_all.py:115-128``) in
    float32 on the card, against the same chain in float64 on the card: each
    coordinate's largest error against its float64 standard deviation (p
    absolute), the outgoing energy, the plan (ending in the sextupole's
    second-order bracket), CUDA-event and CUDA-graph times and a profile."""
    num_particles = 100_000
    beam = _bench_beam(ctt, num_particles, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
    chain = _nonlinear_chain(ctt, torch.float32)
    plan = [type(todo).__name__ for todo in chain._plan()]
    check(plan == ["Segment", "Cavity", "Segment", "Dipole", "_SecondOrderBracket"],
          f"config 3 plan {plan}")
    _reset_launches(wrappers)
    out = chain.track(beam)
    launches = _no_cic_launches(wrappers, "the nonlinear chain")
    out64 = _nonlinear_chain(ctt, torch.float64).track(beam.to(dtype=torch.float64))
    check(tuple(out.particles.shape) == (num_particles, 7), f"shape {tuple(out.particles.shape)}")
    check(bool(torch.isfinite(out.particles).all()), "non-finite particles")
    error = (out.particles.double() - out64.particles).abs().amax(dim=0)
    std = out64.particles.std(dim=0)
    shares = {name: (error[i] / std[i]).item() for i, name in enumerate(("x", "px", "y", "py", "tau"))}
    p_error = error[5].item()
    energy_error = abs(out.energy.double().item() - out64.energy.item()) / out64.energy.item()

    def step():
        return chain.track(beam).particles

    ms = time_ms(step, runs=20)
    profile = profile_path("nonlinear_chain", step, ms)
    emit(
        "nonlinear_chain",
        particles=num_particles, elements=len(chain.elements), plan=plan, dtype="float32",
        ms=ms, graph_ms=graph_ms(step), kernel_launches=profile["kernel_launches"],
        idle_share=profile["idle_share"], cic_kernel_launches=launches,
        max_err_over_f64_std=shares, p_max_abs_err=p_error, sigma_p_f64=std[5].item(),
        energy=out.energy.item(), energy_rel_err=energy_error,
    )
    for name, share in shares.items():
        check(share <= CHAIN_STD_SHARE, f"config 3 {name}: {share} of its std")
    check(p_error <= CHAIN_P_ATOL, f"config 3 p off by {p_error}")
    check(energy_error <= CHAIN_ENERGY_RTOL, f"config 3 energy off by {energy_error}")


def _chain_grad(ctt, dtype, beam, index, attribute, value) -> float:
    chain = _nonlinear_chain(ctt, dtype)
    parameter = torch.tensor(value, dtype=dtype, device="cuda", requires_grad=True)
    setattr(chain.elements[index], attribute, parameter)
    (grad,) = torch.autograd.grad(chain.track(beam).sigma_x, parameter)
    return grad.item()


def phase_nonlinear_chain_grad(ctt, wrappers) -> None:
    """d sigma_x / d (k2, dipole angle, cavity voltage, cavity phase) of
    config 3 at 100k particles: float32 on the card against float64 on the
    card, and the float64 gradient against a float64 central difference."""
    num_particles = 100_000
    beam = _bench_beam(ctt, num_particles, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
    beam64 = beam.to(dtype=torch.float64)
    chain64 = _nonlinear_chain(ctt, torch.float64)
    results = {}
    _reset_launches(wrappers)
    for name, (index, attribute, value, step) in CHAIN_GRAD_CASES.items():
        grad32 = _chain_grad(ctt, torch.float32, beam, index, attribute, value)
        grad64 = _chain_grad(ctt, torch.float64, beam64, index, attribute, value)
        element = chain64.elements[index]

        def sigma_x(v, element=element, attribute=attribute):
            setattr(element, attribute, torch.tensor(v, dtype=torch.float64, device="cuda"))
            return chain64.track(beam64).sigma_x.item()

        with torch.no_grad():
            fd = (sigma_x(value + step) - sigma_x(value - step)) / (2 * step)
        setattr(element, attribute, torch.tensor(value, dtype=torch.float64, device="cuda"))
        results[name] = {
            "grad": grad32, "grad_card_f64": grad64, "finite_difference_f64": fd, "fd_step": step,
            "rel_err_vs_f64": abs(grad32 - grad64) / abs(grad64),
            "fd_rel_diff": abs(fd - grad64) / abs(grad64),
        }
    launches = _no_cic_launches(wrappers, "the nonlinear chain's gradients")

    chain = _nonlinear_chain(ctt, torch.float32)
    parameters = {}
    for name, (index, attribute, value, _) in CHAIN_GRAD_CASES.items():
        parameters[name] = torch.tensor(value, device="cuda", requires_grad=True)
        setattr(chain.elements[index], attribute, parameters[name])

    def value_and_grads():
        value = chain.track(beam).sigma_x
        return value.detach(), torch.autograd.grad(value, list(parameters.values()))

    ms = time_ms(value_and_grads, runs=20)
    profile = profile_path("nonlinear_chain_grad", value_and_grads, ms)
    emit(
        "nonlinear_chain_grad", particles=num_particles, dtype="float32", ms=ms,
        kernel_launches=profile["kernel_launches"], idle_share=profile["idle_share"],
        cic_kernel_launches=launches, grads=results,
    )
    for name, result in results.items():
        check(result["rel_err_vs_f64"] <= CHAIN_GRAD_F32_RTOL[name],
              f"d sigma_x / d {name}: float32 off by {result['rel_err_vs_f64']}")
        check(result["fd_rel_diff"] <= CHAIN_GRAD_FD_RTOL,
              f"d sigma_x / d {name}: finite difference off by {result['fd_rel_diff']}")


class _PlainVersionsForbidden:
    """Within the block, any call of a CIC kernel's plain version raises."""

    def __init__(self, cic_kernels, cic_tiled):
        self.patches = [
            (module, name)
            for module, names in (
                (cic_kernels, ("deposit_multi_3d_reference", "gather_multi_3d_reference")),
                (cic_tiled, ("deposit_multi_tiled_3d_reference",
                             "gather_multi_tiled_3d_reference", "tile_plan")),
            )
            for name in names
        ]
        self.saved = []

    def __enter__(self):
        for module, name in self.patches:
            self.saved.append(getattr(module, name))

            def refuse(*args, name=name, **kwargs):
                raise AssertionError(f"the plain version {name} ran on the card")

            setattr(module, name, refuse)
        return self

    def __exit__(self, *exc):
        for (module, name), original in zip(self.patches, self.saved):
            setattr(module, name, original)
        return False


def phase_func_transforms(ctt, wrappers, cic_kernels, cic_tiled) -> None:
    """``torch.func`` through the 32^3 space-charge kick on the card (float64,
    100k particles): the jvp of sum(px^2) along a direction against the
    reverse-mode gradient contracted with it, and ``vmap`` over two beams
    against two calls; the kernels' launch counts rise, and a call of any
    plain version would raise."""
    num_particles = 100_000
    beam = _bench_beam(
        ctt, num_particles, "cuda", torch.Generator(device="cuda").manual_seed(SEED + 3)
    ).to(dtype=torch.float64)
    kick = ctt.SpaceChargeKick(0.2, grid_shape=(32, 32, 32), dtype=torch.float64, device="cuda")

    def kicked(particles):
        return kick.track(
            ctt.ParticleBeam(particles, beam.energy, particle_charges=beam.particle_charges)
        ).particles

    def loss(particles):
        return torch.sum(torch.square(kicked(particles)[..., 1]))

    generator = torch.Generator(device="cuda").manual_seed(SEED + 4)
    particles = beam.particles
    direction = torch.randn(particles.shape, generator=generator, dtype=torch.float64,
                            device="cuda") * particles.std(dim=0)
    direction[..., 6] = 0.0
    with _PlainVersionsForbidden(cic_kernels, cic_tiled):
        _reset_launches(wrappers)
        _, jvp = torch.func.jvp(loss, (particles,), (direction,))
        jvp_launches = _launches(wrappers)
        _reset_launches(wrappers)
        contracted = torch.sum(torch.func.grad(loss)(particles) * direction)
        grad_launches = _launches(wrappers)
        jvp_error = abs(jvp.item() - contracted.item()) / abs(contracted.item())

        other = particles * 1.1
        _reset_launches(wrappers)
        mapped = torch.func.vmap(kicked)(torch.stack([particles, other]))
        vmap_launches = _launches(wrappers)
        separate = torch.stack([kicked(particles), kicked(other)])
    kick_size = (separate - torch.stack([particles, other])).abs().amax().item()
    vmap_error = (mapped - separate).abs().amax().item() / kick_size
    emit(
        "func_transforms", grid=[32, 32, 32], particles=num_particles, dtype="float64",
        jvp=jvp.item(), grad_dot_direction=contracted.item(), jvp_rel_diff=jvp_error,
        vmap_instances=2, vmap_max_diff_over_kick=vmap_error,
        launches={"jvp": jvp_launches, "grad": grad_launches, "vmap": vmap_launches},
        plain_versions_ran=0,
    )
    for label, launches in (("jvp", jvp_launches), ("grad", grad_launches),
                            ("vmap", vmap_launches)):
        check(launches["deposit_multi_3d"] > 0 and launches["gather_multi_3d"] > 0,
              f"torch.func.{label} launched {launches}")
        check(not any(launches[name] for name in TILED_WRAPPERS),
              f"torch.func.{label} launched tiled kernels at 32^3: {launches}")
    check(jvp_error <= FUNC_RTOL, f"jvp against the contracted gradient: {jvp_error}")
    check(vmap_error <= FUNC_RTOL, f"vmap against two calls: {vmap_error}")



# ---------------------------------------------------------------------------
# The ARES stage-3 lattice and the remaining elements (no hand-written kernel)
# ---------------------------------------------------------------------------

STAGE3_MODES = ("linear", "second_order", "drift_kick_drift", "parameter_beam")


def _set_mode(segment, mode: str) -> None:
    """Every element to ``mode`` with ``num_steps=5``, as the reference's
    benchmark sets it (``tests/test_full_ares.py:154-161``); elements without
    the method keep ``"linear"`` with a warning."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        segment.set_attrs_on_every_element(tracking_method=mode, num_steps=5)


def _stage3(dtype, device="cuda", mode="linear", seeded=False):
    """``lattices.ares_stage3`` in ``mode``; with ``seeded``, its quadrupoles,
    solenoids and correctors set from a numpy Generator (SEED), in the
    lattice's order."""
    from cheetah_tpu_torch.lattices import ares_stage3

    segment = ares_stage3(dtype, device=device)
    if seeded:
        rng = np.random.default_rng(SEED)
        settings = {
            "Quadrupole": ("k1", iter(rng.uniform(-STAGE3_K1_RANGE, STAGE3_K1_RANGE, 13))),
            "Solenoid": ("k", iter(rng.uniform(-STAGE3_SOLENOID_RANGE, STAGE3_SOLENOID_RANGE, 2))),
            "corrector": ("angle", iter(rng.uniform(-STAGE3_ANGLE_RANGE, STAGE3_ANGLE_RANGE, 30))),
        }
        for element in segment.elements:
            kind = type(element).__name__
            kind = "corrector" if kind in ("HorizontalCorrector", "VerticalCorrector") else kind
            if kind in settings:
                attribute, values = settings[kind]
                setattr(element, attribute, float(next(values)))
    _set_mode(segment, "linear" if mode == "parameter_beam" else mode)
    return segment


def _stage3_beams(ctt):
    """The 100k-particle float32 beam of ``scripts/bench_all.py:115-128``
    (seed SEED) and the ParameterBeam of the same Twiss parameters."""
    beam = _bench_beam(ctt, 100_000, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
    parameter_beam = ctt.ParameterBeam.from_twiss(
        beta_x=5.0, alpha_x=-1.0, emittance_x=2e-9, beta_y=3.0, alpha_y=0.5, emittance_y=2e-9,
        energy=1.54e8, dtype=torch.float32, device="cuda",
    )
    return beam, parameter_beam


def _std_shares(out, out64, rows=None) -> tuple[dict, float]:
    """Each coordinate's largest error over its float64 standard deviation,
    and p's largest absolute error, over the particles ``rows`` (all when
    ``None``)."""
    actual, expected = out.particles.detach().double().cpu(), out64.particles.detach().cpu()
    if rows is not None:
        actual, expected = actual[rows], expected[rows]
    error = (actual - expected).abs().amax(dim=-2)
    std = expected.std(dim=-2)
    names = ("x", "px", "y", "py", "tau", "p")
    return {name: (error[i] / std[i]).item() for i, name in enumerate(names)}, error[5].item()


def _check_shares(label: str, shares: dict, p_error: float, drift_kick_drift: bool) -> None:
    """A linear or second-order map holds every coordinate to
    NEW_ELEMENT_STD_SHARE of its std; a drift-kick-drift map x to tau as the
    nonlinear chain and p absolutely (the Bmad round trip)."""
    for name, share in shares.items():
        if drift_kick_drift and name == "p":
            check(p_error <= CHAIN_P_ATOL, f"{label} p off by {p_error}")
        else:
            limit = CHAIN_STD_SHARE if drift_kick_drift else NEW_ELEMENT_STD_SHARE
            check(share <= limit, f"{label} {name}: {share} of its std")


def phase_ares_stage3(ctt, wrappers) -> None:
    """The full ARES stage-3 lattice (195 elements) at 100k particles in
    float32, as the reference's benchmark runs it: a ParticleBeam in linear,
    second-order and drift-kick-drift mode and a ParameterBeam in linear
    mode. Timed on the vendored lattice (CUDA events eagerly, a CUDA graph,
    a profile for launches and idle share); checked with its magnets set
    from SEED against the port's float64 run on the CPU; and the gradient of
    sigma_x by AREAMQZM1's k1 against float64 on the CPU and an float64
    central difference on the card."""
    beam, parameter_beam = _stage3_beams(ctt)
    beam64 = beam.to("cpu", torch.float64)
    parameter64 = parameter_beam.to("cpu", torch.float64)
    incoming = {mode: beam for mode in STAGE3_MODES}
    incoming["parameter_beam"] = parameter_beam
    lattice = _stage3(torch.float32)
    timings, accuracy = {}, {}
    _reset_launches(wrappers)
    with warnings.catch_warnings():
        # The apertures let a ParameterBeam through with a warning.
        warnings.simplefilter("ignore")
        for mode in STAGE3_MODES:
            _set_mode(lattice, "linear" if mode == "parameter_beam" else mode)

            def step(mode=mode):
                out = lattice.track(incoming[mode])
                return out.sigma_x if mode == "parameter_beam" else out.particles

            # The second-order lattice dispatches ~116k operators a call.
            heavy = mode == "second_order"
            ms = time_ms(step, runs=5 if heavy else 20, warmup=1 if heavy else 3)
            profile = profile_path(f"ares_stage3_{mode}", step, ms)
            timings[mode] = {
                "plan_entries": len(lattice._plan()), "ms": ms,
                "graph_ms": graph_ms(step, calls=1 if heavy else 10, runs=5 if heavy else 20),
                "kernel_launches": profile["kernel_launches"],
                "device_busy_ms": profile["device_busy_ms"], "idle_share": profile["idle_share"],
            }

        for mode in STAGE3_MODES:
            out = _stage3(torch.float32, "cuda", mode, seeded=True).track(incoming[mode])
            out64 = _stage3(torch.float64, "cpu", mode, seeded=True).track(
                parameter64 if mode == "parameter_beam" else beam64
            )
            sigma_errors = {
                name: abs(getattr(out, name).double().item() / getattr(out64, name).item() - 1)
                for name in ("sigma_x", "sigma_y")
            }
            if mode == "drift_kick_drift":
                lost64 = ~torch.isfinite(out64.particles).all(dim=-1)
                lost = ~torch.isfinite(out.particles).all(dim=-1).cpu()
                shares, p_error = _std_shares(out, out64, ~lost64)
                accuracy[mode] = {
                    "max_err_over_f64_std": shares, "p_max_abs_err": p_error,
                    "lost_f64": int(lost64.sum()), "lost_card": int(lost.sum()),
                    "same_particles_lost": bool(torch.equal(lost, lost64)),
                }
            else:
                finite = bool(torch.isfinite(out.mu if mode == "parameter_beam"
                                             else out.particles).all())
                accuracy[mode] = {**{f"{k}_rel_err": v for k, v in sigma_errors.items()},
                                  "finite": finite}
    launches = _no_cic_launches(wrappers, "the stage-3 lattice")

    def grad_k1(dtype, device, incoming):
        segment = _stage3(dtype, device, seeded=True)
        k1 = segment.AREAMQZM1.k1.clone().requires_grad_()
        segment.AREAMQZM1.k1 = k1
        (grad,) = torch.autograd.grad(segment.track(incoming).sigma_x, k1)
        return grad.item()

    grad32 = grad_k1(torch.float32, "cuda", beam)
    grad_cpu = grad_k1(torch.float64, "cpu", beam64)
    card64 = beam.to(dtype=torch.float64)
    grad_card64 = grad_k1(torch.float64, "cuda", card64)
    segment64 = _stage3(torch.float64, "cuda", seeded=True)
    k1 = segment64.AREAMQZM1.k1.item()

    def sigma_x(value):
        segment64.AREAMQZM1.k1 = value
        return segment64.track(card64).sigma_x.item()

    with torch.no_grad():
        fd = (sigma_x(k1 + STAGE3_FD_STEP) - sigma_x(k1 - STAGE3_FD_STEP)) / (2 * STAGE3_FD_STEP)
    gradient = {
        "k1": k1, "grad": grad32, "grad_cpu_f64": grad_cpu, "grad_card_f64": grad_card64,
        "finite_difference_f64": fd, "fd_step": STAGE3_FD_STEP,
        "rel_err_vs_f64": abs(grad32 - grad_cpu) / abs(grad_cpu),
        "fd_rel_diff": abs(fd - grad_card64) / abs(grad_card64),
    }
    emit(
        "ares_stage3", elements=len(lattice.elements), particles=beam.particles.shape[-2],
        dtype="float32", timings=timings, accuracy=accuracy, gradient_AREAMQZM1_k1=gradient,
        cic_kernel_launches=launches,
    )
    for mode in ("linear", "second_order", "parameter_beam"):
        check(accuracy[mode]["finite"], f"stage 3 {mode}: non-finite output")
        for name in ("sigma_x", "sigma_y"):
            error = accuracy[mode][f"{name}_rel_err"]
            check(error <= STAGE3_SIGMA_RTOL[mode], f"stage 3 {mode} {name} off by {error}")
    dkd = accuracy["drift_kick_drift"]
    check(dkd["same_particles_lost"], f"stage 3 dkd lost {dkd['lost_card']} particles on the "
          f"card, {dkd['lost_f64']} in float64, not the same")
    check(dkd["lost_f64"] * 1000 < beam.particles.shape[-2], "stage 3 dkd lost over 0.1%")
    _check_shares("stage 3 dkd", dkd["max_err_over_f64_std"], dkd["p_max_abs_err"], True)
    check(gradient["rel_err_vs_f64"] <= STAGE3_GRAD_F32_RTOL,
          f"stage 3 k1 gradient off by {gradient['rel_err_vs_f64']}")
    check(gradient["fd_rel_diff"] <= STAGE3_FD_RTOL,
          f"stage 3 k1 gradient against its FD: {gradient['fd_rel_diff']}")


def _new_element_cases(ctt, dtype, device) -> dict:
    """Each new element (RBend in its three methods) as a one-element
    segment, the ARES EA subcell merged by ``from_merging_elements`` and a
    quadrupole with an active BPM superimposed at its centre."""
    kw = {"dtype": dtype, "device": device}

    def rbend(method):
        return ctt.RBend(0.5, angle=0.2, rbend_e1=0.05, rbend_e2=-0.02, gap=0.02,
                         fringe_integral=0.4, tracking_method=method, **kw)

    return {
        "solenoid": ctt.Solenoid(0.4, k=2.5, misalignment=(1e-4, -1e-4), **kw),
        "undulator": ctt.Undulator(2.0, period=0.05, kx=1.2, ky=0.8, **kw),
        "combined_corrector": ctt.CombinedCorrector(
            0.1, horizontal_angle=2e-4, vertical_angle=-1e-4, **kw
        ),
        "rbend_linear": rbend("linear"),
        "rbend_second_order": rbend("second_order"),
        "rbend_drift_kick_drift": rbend("drift_kick_drift"),
        "transverse_deflecting_cavity": ctt.TransverseDeflectingCavity(
            0.6, voltage=1e6, phase=0.1, frequency=2.9e9, misalignment=(1e-4, -1e-4), tilt=0.05,
            **kw,
        ),
        "superimposed_bpm": ctt.Segment([
            ctt.Drift(0.4, **kw),
            ctt.Superimposed(ctt.Quadrupole(0.3, k1=4.2, **kw),
                             ctt.BPM(is_active=True, name="bpm", **kw)),
            ctt.Drift(0.2, **kw),
        ]),
    }


DKD_CASES = ("rbend_drift_kick_drift", "transverse_deflecting_cavity")


def _merged_subcell(ctt, dtype, device, beam):
    from cheetah_tpu_torch.lattices import ares_ea_subcell

    segment = ares_ea_subcell(dtype, device=device)
    return segment, ctt.CustomTransferMap.from_merging_elements(list(segment.elements), beam)


def phase_new_elements(ctt, wrappers) -> None:
    """Solenoid, Undulator, CombinedCorrector, RBend (three methods), the
    transverse deflecting cavity, ``CustomTransferMap.from_merging_elements``
    over the ARES EA subcell (against the subcell's own ``track``) and a
    Superimposed BPM read through ``track_with_readings``, at 100k particles
    in float32 on the card against the port's float64 run on the CPU."""
    beam, _ = _stage3_beams(ctt)
    beam64 = beam.to("cpu", torch.float64)
    cases = _new_element_cases(ctt, torch.float32, "cuda")
    cases64 = _new_element_cases(ctt, torch.float64, "cpu")
    results = {}
    _reset_launches(wrappers)
    for label, element in cases.items():
        if label == "superimposed_bpm":
            out, readings = element.track_with_readings(beam)
            out64, readings64 = cases64[label].track_with_readings(beam64)
            sizes = torch.stack([out64.sigma_x, out64.sigma_y])
            reading_error = ((readings["bpm"].double().cpu() - readings64["bpm"]).abs()
                             / sizes).max().item()
        else:
            out, out64 = element.track(beam), cases64[label].track(beam64)
        shares, p_error = _std_shares(out, out64)
        results[label] = {
            "ms": time_ms(lambda element=element: element.track(beam).particles, runs=10),
            "max_err_over_f64_std": shares, "p_max_abs_err": p_error,
            "finite": bool(torch.isfinite(out.particles).all()),
            "energy_rel_err": abs(out.energy.double().item() / out64.energy.item() - 1),
        }
    results["superimposed_bpm"]["bpm_err_over_beam_size"] = reading_error

    segment, merged = _merged_subcell(ctt, torch.float32, "cuda", beam)
    _, merged64 = _merged_subcell(ctt, torch.float64, "cpu", beam64)
    out = merged.track(beam)
    shares, p_error = _std_shares(out, merged64.track(beam64))
    against_segment = _std_shares(out, segment.track(beam))[0]
    results["custom_transfer_map_ares_ea"] = {
        "ms": time_ms(lambda: merged.track(beam).particles, runs=10),
        "max_err_over_f64_std": shares, "p_max_abs_err": p_error,
        "max_diff_over_std_vs_segment_track": against_segment,
        "finite": bool(torch.isfinite(out.particles).all()),
        "energy_rel_err": 0.0,
    }
    launches = _no_cic_launches(wrappers, "the new elements")
    emit("new_elements", particles=beam.particles.shape[-2], dtype="float32", cases=results,
         cic_kernel_launches=launches)
    for label, result in results.items():
        check(result["finite"], f"{label}: non-finite particles")
        _check_shares(label, result["max_err_over_f64_std"], result["p_max_abs_err"],
                      label in DKD_CASES)
        check(result["energy_rel_err"] <= CHAIN_ENERGY_RTOL, f"{label} energy off")
    _check_shares("merged subcell against the subcell's track",
                  results["custom_transfer_map_ares_ea"]["max_diff_over_std_vs_segment_track"],
                  0.0, False)
    check(reading_error <= BPM_READING_TOLERANCE, f"BPM reading off by {reading_error}")

def _cold_line(ctt, kicks, grid_shape, dtype=torch.float32):
    return ctt.lattices.cold_beam_line(
        kicks, grid_shape, NUM_PARTICLES, dtype, "cuda",
        torch.Generator(device="cuda").manual_seed(SEED),
    )


def _line_value_and_grad(line, beam, length, method):
    """sum(px^2) after the line and its derivative with respect to the first
    drift's length, tracked by ``line.<method>``."""
    line.elements[0].length = length
    value = torch.sum(torch.square(getattr(line, method)(beam).px))
    (grad,) = torch.autograd.grad(value, length)
    return value.detach(), grad


def _first_length(line) -> torch.Tensor:
    return line.elements[0].length.detach().clone().requires_grad_()


def _peak_mb(fn) -> float:
    """Device memory that ``fn`` takes at its peak above what was allocated
    before it, in MiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def phase_sc_line(ctt, wrappers, grid_shape, uses_tiled: bool) -> dict:
    """The space-charge line of the structure operations
    (``lattices.cold_beam_line``: ``Drift.split``, 10 kicks inserted,
    ``with_consecutive_elements_merged``) at 1M particles in float32: its
    plan (``explain_plan``), the cold beam's doubling, value_and_grad of
    sum(px^2) by the first drift's length through ``track`` and through
    ``track_checkpointed`` (launches forward, backward and in the recompute;
    the two gradients against each other in float32 and float64 on the card,
    bit for bit, beside ``track``'s own gradient over 5 runs, which must not
    move), peak memory at
    2 and 10 kicks both ways, CUDA-event and CUDA-graph times and profiles.
    Returns the launches of the checkpointed value_and_grad."""
    label = f"sc_line_{grid_shape[0]}"
    kicks = SC_LINE_KICKS
    beam, line = _cold_line(ctt, kicks, grid_shape)
    plan = line.explain_plan().splitlines()
    check(
        len(plan) == 2 * kicks + 1 and sum("SpaceChargeKick" in text for text in plan) == kicks,
        f"{label}: plan {plan}",
    )

    _reset_launches(wrappers)
    with torch.no_grad():
        out = line.track(beam)
    forward_no_grad = _launches(wrappers)
    check(bool(torch.isfinite(out.particles).all()), f"{label}: non-finite particles")
    ratios = {
        name: (getattr(out, name) / getattr(beam, name)).item()
        for name in ("sigma_x", "sigma_y", "sigma_tau")
    }

    kind = "tiled_3d" if uses_tiled else "3d"
    per_kick = {name: 0 for name in wrappers}
    forward_expected = per_kick | {f"deposit_multi_{kind}": kicks, f"gather_multi_{kind}": kicks}
    if uses_tiled:
        forward_expected["plan_tiles"] = 2 * kicks
    backward_expected = {
        "track": per_kick | {f"deposit_multi_{kind}": kicks, f"gather_multi_{kind}": 2 * kicks}
    }
    backward_expected["track_checkpointed"] = {
        name: backward_expected["track"][name] + forward_expected[name] for name in wrappers
    }
    check(forward_no_grad == forward_expected, f"{label}: forward launched {forward_no_grad}")

    launches, grads = {}, {}
    for method in ("track", "track_checkpointed"):
        length = _first_length(line)
        _reset_launches(wrappers)
        line.elements[0].length = length
        value = torch.sum(torch.square(getattr(line, method)(beam).px))
        forward = _launches(wrappers)
        _reset_launches(wrappers)
        (grad,) = torch.autograd.grad(value, length)
        backward = _launches(wrappers)
        check(forward == forward_expected and backward == backward_expected[method],
              f"{label} {method}: launches forward {forward}, backward {backward}")
        check(bool(torch.isfinite(grad)) and grad.item() != 0, f"{label}: gradient {grad.item()}")
        launches[method] = {"forward": forward, "backward": backward}
        grads[method] = grad.item()
    recompute = {
        name: launches["track_checkpointed"]["backward"][name] - launches["track"]["backward"][name]
        for name in wrappers
    }
    repeats = [grads["track"]] + [
        _line_value_and_grad(line, beam, _first_length(line), "track")[1].item()
        for _ in range(4)
    ]
    spread = (max(repeats) - min(repeats)) / abs(statistics.mean(repeats))

    _, line64 = _cold_line(ctt, kicks, grid_shape, torch.float64)
    beam64 = beam.to(dtype=torch.float64)
    grads64 = {
        method: _line_value_and_grad(line64, beam64, _first_length(line64), method)[1].item()
        for method in ("track", "track_checkpointed")
    }
    del line64, beam64

    peak_mb = {}
    for count in (2, kicks):
        counted = line if count == kicks else _cold_line(ctt, count, grid_shape)[1]
        for method in ("track", "track_checkpointed"):
            peak_mb[f"{method}_{count}"] = _peak_mb(
                lambda: _line_value_and_grad(counted, beam, _first_length(counted), method)
            )
    per_kick_mb = {
        method: (peak_mb[f"{method}_{kicks}"] - peak_mb[f"{method}_2"]) / (kicks - 2)
        for method in ("track", "track_checkpointed")
    }

    timings = {}
    length = _first_length(line)
    for method in ("track", "track_checkpointed"):
        def step(method=method):
            return _line_value_and_grad(line, beam, length, method)

        ms = time_ms(step, runs=5, warmup=1)
        profile = profile_path(f"{label}_{method}", step, ms)
        timings[method] = {
            "ms": ms, "graph_ms": graph_ms(step, calls=1, runs=5),
            "kernel_launches": profile["kernel_launches"],
            "idle_share": profile["idle_share"], "cic_kernels": profile["cic_kernels"],
        }
    emit(
        label,
        particles=NUM_PARTICLES, grid=list(grid_shape), kicks=kicks, dtype="float32",
        plan_entries=len(plan), plan_head=plan[:3], doubling_ratios=ratios,
        doubling_checked=not uses_tiled, launches=launches, recompute_launches=recompute,
        grad_track=grads["track"], grad_checkpointed=grads["track_checkpointed"],
        track_grad_runs_f32=repeats, track_grad_run_spread_f32=spread,
        grad_track_f64=grads64["track"], grad_checkpointed_f64=grads64["track_checkpointed"],
        peak_mib=peak_mb, peak_mib_per_kick=per_kick_mb,
        timings=timings,
    )
    if not uses_tiled:
        for name, ratio in ratios.items():
            check(abs(ratio - 2.0) / 2.0 <= SC_LINE_DOUBLING_RTOL, f"{label}: {name} grew {ratio}x")
    check(spread == 0.0, f"{label}: track's f32 gradient differs between runs: {repeats}")
    check(grads["track_checkpointed"] == grads["track"],
          f"{label}: checkpointed f32 gradient {grads['track_checkpointed']}, track's "
          f"{grads['track']}")
    check(grads64["track_checkpointed"] == grads64["track"],
          f"{label}: checkpointed f64 gradient {grads64['track_checkpointed']}, track's "
          f"{grads64['track']}")
    return {
        name: launches["track_checkpointed"]["forward"][name]
        + launches["track_checkpointed"]["backward"][name]
        for name in wrappers
    }


# ---------------------------------------------------------------------------
# The multi-device slice
# ---------------------------------------------------------------------------


def _env_settings() -> np.ndarray:
    """The 4096 instances' settings of the five tunables, from numpy."""
    rng = np.random.default_rng(SEED)
    return np.concatenate(
        [rng.uniform(-20, 20, (ENV_INSTANCES, 3)),
         rng.uniform(-ENV_ANGLE_RANGE, ENV_ANGLE_RANGE, (ENV_INSTANCES, 2))],
        axis=1,
    )


def _env(parallel, dtype, device, beam, **kw):
    from cheetah_tpu_torch.lattices import ares_ea_subcell

    return parallel.BatchedLatticeEnv(ares_ea_subcell(dtype, device=device), beam, ENV_TUNABLES,
                                      **kw)


def _reward_and_grad(env, settings):
    """The env's outgoing beam and reward, and d sum(reward) / d settings."""
    settings = settings.detach().requires_grad_()
    outgoing, _, reward = env.step(settings)
    (grad,) = torch.autograd.grad(reward.sum(), settings)
    return outgoing, reward.detach(), grad


def _column_errors(actual: torch.Tensor, expected: torch.Tensor) -> list:
    """Per column: max |actual - expected| over that of |expected|."""
    actual, expected = actual.double().cpu(), expected.double().cpu()
    return ((actual - expected).abs().amax(0) / expected.abs().amax(0)).tolist()


def _amplification(outgoing) -> torch.Tensor:
    """1 + (mu / sigma)^2 of each instance, the larger of x and y: how much
    the raw-moment variance amplifies the rounding of its float32 sums."""
    return 1 + torch.maximum((outgoing.mu_x / outgoing.sigma_x) ** 2,
                             (outgoing.mu_y / outgoing.sigma_y) ** 2).detach()


def phase_batched_env(ctt, parallel, wrappers) -> None:
    """``BatchedLatticeEnv`` at BASELINE config 5's width on the NCCL
    process group of one rank: 4096 instances of the five ARES EA tunables,
    the bench beam of 10k particles, f32. ``step`` against ``segment.track``
    with the settings assigned; sigma and the gradient against the port's
    float64 CPU run at 16 instances; ``grad_step`` against the gradient;
    ``moments_only`` with a ParameterBeam; eager times and profiles."""
    from cheetah_tpu_torch.lattices import ares_ea_subcell

    mesh = parallel.make_mesh({"instances": 1})
    settings = torch.tensor(_env_settings(), dtype=torch.float32, device="cuda")
    beam = _bench_beam(ctt, 10_000, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
    env = _env(parallel, torch.float32, "cuda", beam)

    _reset_launches(wrappers)
    outgoing, readings, reward = env.step(settings)
    launches = _no_cic_launches(wrappers, "the batched env step")
    check(tuple(reward.shape) == (ENV_INSTANCES,) and readings == {}, "env step shapes")
    check(bool(torch.isfinite(reward).all()), "non-finite env reward")

    plain = ares_ea_subcell(torch.float32)
    for index, (name, attribute) in enumerate(ENV_TUNABLES):
        setattr(getattr(plain, name), attribute, settings[:, index])
    tracked = plain.track(beam)
    same = max(
        ((getattr(outgoing, name) - getattr(tracked, name)).abs()
         / getattr(tracked, name)).max().item()
        for name in ("sigma_x", "sigma_y")
    )
    bit_equal = bool(torch.equal(outgoing.particles, tracked.particles))
    del tracked, plain

    _, reward_g, grad = _reward_and_grad(env, settings)
    stepped, step_reward = env.grad_step(settings, ENV_LEARNING_RATE)
    step_error = relative_error(stepped, settings + ENV_LEARNING_RATE * grad)[1]
    check(torch.equal(step_reward, reward_g), "grad_step's reward differs from step's")

    picks = torch.linspace(0, ENV_INSTANCES - 1, 16).round().long()
    env64 = _env(parallel, torch.float64, "cpu", beam.to("cpu", torch.float64))
    outgoing64, reward64, grad64 = _reward_and_grad(env64, settings[picks.cuda()].cpu().double())
    picked = ctt.ParticleBeam(outgoing.particles[picks.cuda()], outgoing.energy)
    bound = ENV_STEP_RTOL * _amplification(outgoing64)
    sigma_errors = {
        axis: (getattr(picked, f"sigma_{axis}").double().cpu()
               - getattr(outgoing64, f"sigma_{axis}")).abs()
        / getattr(outgoing64, f"sigma_{axis}")
        for axis in ("x", "y")
    }
    within = all(bool((error <= bound).all()) for error in sigma_errors.values())
    # Instances whose beam is near the axis, (mu / sigma)^2 <= 1.
    near = bound <= 2 * ENV_STEP_RTOL
    on_axis = max(error[near].max().item() for error in sigma_errors.values()) if near.any() else None
    grad_errors = _column_errors(grad[picks.cuda()], grad64)
    angle_scale = ENV_ANGLE_RANGE / reward64.abs()
    angle64 = (grad64[:, 3:].abs() * angle_scale[:, None]).max().item()
    angle32 = ((grad[picks.cuda(), 3:].double().cpu().abs() * angle_scale[:, None])
               / bound[:, None]).max().item()
    audit = parallel.collective_report(lambda: env.grad_step(settings, ENV_LEARNING_RATE), mesh,
                                       dcn_axes=("instances",))

    parameter_beam = ctt.ParameterBeam.from_twiss(
        beta_x=5.0, emittance_x=2e-9, beta_y=3.0, emittance_y=2e-9, energy=1.54e8,
        dtype=torch.float32, device="cuda",
    )
    env_moments = _env(parallel, torch.float32, "cuda", parameter_beam, moments_only=True)
    _reset_launches(wrappers)
    outgoing_m, _, reward_m = env_moments.step(settings)
    moments_launches = _no_cic_launches(wrappers, "the moments-only env step")
    check(isinstance(outgoing_m, ctt.ParameterBeam), f"moments_only gave {type(outgoing_m)}")
    env_m64 = _env(parallel, torch.float64, "cpu", parameter_beam.to("cpu", torch.float64),
                   moments_only=True)
    reward_m64 = env_m64.reward(settings[picks.cuda()].cpu().double())
    moments_error = ((reward_m[picks.cuda()].double().cpu() - reward_m64).abs()
                     / reward_m64.abs()).max().item()

    def step():
        return env.step(settings)[2]

    def grad_step():
        return env.grad_step(settings, ENV_LEARNING_RATE)

    timings = {}
    for name, fn in (("step", step), ("grad_step", grad_step),
                     ("moments_only_step", lambda: env_moments.step(settings)[2])):
        ms = time_ms(fn, runs=10)
        profile = profile_path(f"batched_env_{name}", fn, ms)
        timings[name] = {"ms": ms, "kernel_launches": profile["kernel_launches"],
                         "idle_share": profile["idle_share"]}
    emit(
        "batched_env",
        instances=ENV_INSTANCES, particles=10_000, tunables=[list(t) for t in ENV_TUNABLES],
        dtype="float32", step_vs_track_rel=same, step_bit_equal_to_track=bit_equal,
        grad_step_vs_grad_rel=step_error,
        sigma_rel_err_vs_cpu_f64={axis: error.max().item() for axis, error in sigma_errors.items()},
        sigma_bound_max=bound.max().item(),
        sigma_rel_err_on_axis=on_axis, k1_grad_col_err_vs_cpu_f64=grad_errors[:3],
        angle_grad_f64_share=angle64, angle_grad_f32_share_of_bound=angle32,
        moments_only_reward_rel_err_vs_cpu_f64=moments_error,
        cic_kernel_launches={"step": launches, "moments_only": moments_launches},
        grad_step_collectives=len(audit.ops), timings=timings,
    )
    check(same <= ENV_SAME_RTOL, f"env.step against segment.track off by {same}")
    check(step_error <= ENV_SAME_RTOL, f"grad_step against its gradient off by {step_error}")
    check(within, f"env sigma off its raw-moment bound: {sigma_errors}, bound {bound}")
    check(max(grad_errors[:3]) <= ENV_GRAD_TOLERANCE, f"env k1 gradients off by {grad_errors}")
    check(angle64 <= ENV_ANGLE_ZERO_F64, f"f64 angle gradients not zero: {angle64}")
    check(angle32 <= 1.0, f"f32 angle gradients past the reward's bound: {angle32}")
    check(moments_error <= PARAMETER_BEAM_RTOL, f"moments-only reward off by {moments_error}")
    check(not audit.ops, f"the env's grad step issued collectives: {audit.ops}")


def _sharded_segment(ctt, dtype, grid_shape, axis):
    """The space-charge segment of ``_sc_segment`` with both kicks over
    ``axis``."""
    segment = _sc_segment(ctt, dtype, "cuda", grid_shape)
    for element in segment.elements[1::2]:
        element.particle_axis = axis
    return segment


def _value_and_grad_launches(wrappers, segment, beam):
    """sum(px^2) and its derivative by the first drift's length, with the
    CIC launches of the forward and of the backward."""
    length = torch.tensor(0.1, dtype=beam.particles.dtype, device="cuda", requires_grad=True)
    segment.elements[0].length = length
    _reset_launches(wrappers)
    value = torch.sum(torch.square(segment.track(beam).px))
    forward = _launches(wrappers)
    _reset_launches(wrappers)
    (grad,) = torch.autograd.grad(value, length)
    return value.detach(), grad, forward, _launches(wrappers)


def phase_sc_sharded(ctt, parallel, wrappers, grid_shape) -> dict:
    """``SpaceChargeKick(particle_axis="particles")`` on the NCCL process
    group of one rank, where the all-reduces really launch: the 1M bench
    beam's kick against the unsharded kick, bit for bit; the space-charge segment's
    value_and_grad with both kicks sharded, its launches equal to the
    unsharded segment's and its gradient equal within section 2's limits
    in f32 and f64; the audit's bytes (the moment sums and the grid, per
    kick, forward and backward); the all-reduce's time. Returns the CIC
    launches of the sharded value_and_grad."""
    from cheetah_tpu_torch.parallel import collectives, comm_audit

    label = f"sc_sharded_{grid_shape[0]}"
    mesh = parallel.make_mesh({"particles": 1})
    beam = _bench_beam(ctt, NUM_PARTICLES, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
    with parallel.active_mesh(mesh):
        sharded_kick = ctt.SpaceChargeKick(0.2, grid_shape=grid_shape, particle_axis="particles",
                                           dtype=torch.float32)
        _reset_launches(wrappers)
        out = sharded_kick.track(beam)
        kick_launches = _launches(wrappers)
    _reset_launches(wrappers)
    reference = ctt.SpaceChargeKick(0.2, grid_shape=grid_shape, dtype=torch.float32).track(beam)
    check(kick_launches == _launches(wrappers), f"{label}: the sharded kick launched {kick_launches}")
    kick_errors = _check_kicks(label, beam, out, reference.to("cpu", torch.float64))
    kick_bit_for_bit = torch.equal(_bits(out.particles), _bits(reference.particles))
    check(kick_bit_for_bit, f"{label}: the sharded kick differs from the unsharded one")
    del out, reference

    results = {}
    for dtype in (torch.float32, torch.float64):
        typed = beam if dtype == torch.float32 else beam.to(dtype=dtype)
        with parallel.active_mesh(mesh), collectives.recording() as lines:
            sharded = _value_and_grad_launches(wrappers, _sharded_segment(ctt, dtype, grid_shape,
                                                                          "particles"), typed)
        unsharded = _value_and_grad_launches(wrappers, _sc_segment(ctt, dtype, "cuda", grid_shape),
                                             typed)
        check(sharded[2:] == unsharded[2:],
              f"{label}: launches {sharded[2:]} sharded, {unsharded[2:]} unsharded")
        results[dtype] = {
            "grad": sharded[1].item(), "grad_unsharded": unsharded[1].item(),
            "grad_rel_diff": abs(sharded[1].item() - unsharded[1].item()) / abs(unsharded[1].item()),
            "value_rel_diff": abs(sharded[0].item() - unsharded[0].item()) / abs(unsharded[0].item()),
            "launches": {"forward": sharded[2], "backward": sharded[3]}, "lines": lines,
        }
    f32, f64 = results[torch.float32], results[torch.float64]
    report = comm_audit.CollectiveReport(comm_audit.parse_collectives("\n".join(f32["lines"]), mesh),
                                         ("particles",))
    per_kick = (4 * 3 + math.prod(grid_shape)) * 4
    expected_bytes = 2 * 2 * per_kick  # two kicks, forward and backward

    grid = torch.zeros((1, *grid_shape), device="cuda")
    with parallel.active_mesh(mesh):
        all_reduce_ms = time_ms(lambda: collectives.all_reduce(grid, "particles"), per_event=10)
    length = torch.tensor(0.1, device="cuda", requires_grad=True)
    segment = _sharded_segment(ctt, torch.float32, grid_shape, "particles")
    plain = _sc_segment(ctt, torch.float32, "cuda", grid_shape)

    def sharded_step():
        with parallel.active_mesh(mesh):
            return _sc_value_and_grad(segment, beam, 0.1)

    ms = time_ms(sharded_step, runs=10, warmup=2)
    profile = profile_path(label, sharded_step, ms)
    emit(
        label,
        particles=NUM_PARTICLES, grid=list(grid_shape), backend=str(torch.distributed.get_backend()),
        world_size=torch.distributed.get_world_size(),
        kick_rms_rel_err_vs_unsharded=kick_errors, kick_bit_for_bit=kick_bit_for_bit,
        kick_launches=kick_launches,
        grad_f32=f32["grad"], grad_f32_unsharded=f32["grad_unsharded"],
        grad_f32_rel_diff=f32["grad_rel_diff"], value_f32_rel_diff=f32["value_rel_diff"],
        grad_f64_rel_diff=f64["grad_rel_diff"], launches=f32["launches"],
        collectives=[op.line for op in report.ops], audit_bytes=report.total_bytes,
        audit_bytes_expected=expected_bytes, nccl_grid_all_reduce_ms=all_reduce_ms,
        grid_bytes=math.prod(grid_shape) * 4, ms=ms,
        unsharded_ms=time_ms(lambda: _sc_value_and_grad(plain, beam, 0.1), runs=10, warmup=2),
        idle_share=profile["idle_share"], kernel_launches=profile["kernel_launches"],
        cic_kernels=profile["cic_kernels"],
    )
    check(f32["grad_rel_diff"] <= SC_GRAD_F32_RTOL[grid_shape],
          f"{label}: f32 gradient off the unsharded one by {f32['grad_rel_diff']}")
    check(f64["grad_rel_diff"] <= SC_GRAD_F64_RTOL,
          f"{label}: f64 gradient off the unsharded one by {f64['grad_rel_diff']}")
    check(len(report.ops) == 8 and report.total_bytes == expected_bytes,
          f"{label}: audit {report.total_bytes} bytes in {len(report.ops)} collectives")
    return {name: f32["launches"]["forward"][name] + f32["launches"]["backward"][name]
            for name in wrappers}


def _share_of_bound(actual, expected, amplification, scale=None) -> float:
    """max |actual - expected| / (scale * TWO_RANK_ENV_RTOL * amplification),
    scale |expected| unless given."""
    scale = expected.abs() if scale is None else scale
    return ((actual - expected).abs() / (scale * TWO_RANK_ENV_RTOL * amplification)).max().item()


def _angle_share(grad, reward, amplification) -> float:
    """The angle gradients (zero by construction) over a 1e-3 rad step,
    as a share of the reward's float32 bound."""
    return ((grad[:, 3:].abs() * ENV_ANGLE_RANGE / reward.abs()[:, None])
            / (ENV_STEP_RTOL * amplification[:, None])).max().item()


def _two_rank_worker(rank: int, store: str, directory: str) -> None:
    """One of two ranks over gloo on the one card (``phase_two_rank``): the
    env over the instance axis and the kick over the particle axis, each
    against the one-process run on the card; writes its results as JSON."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    import cheetah_tpu_torch as ctt
    from cheetah_tpu_torch import parallel
    from cheetah_tpu_torch.parallel import collectives

    results = {}
    instances = parallel.make_mesh({"instances": 2})
    beam = _bench_beam(ctt, 10_000, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
    settings = torch.tensor(_env_settings(), dtype=torch.float32, device="cuda")
    env = _env(parallel, torch.float32, "cuda", beam)
    outgoing, reward_full, grad_full = _reward_and_grad(env, settings)
    index, size = collectives.axis_index(instances, "instances")
    rows = settings.chunk(size)[index]
    _, reward, grad = _reward_and_grad(env, rows)
    with parallel.active_mesh(instances):
        gathered = collectives.all_gather(reward, "instances")
    amplification = _amplification(outgoing)
    own = slice(index * rows.shape[0], (index + 1) * rows.shape[0])
    results["env"] = {
        "rows": list(rows.shape),
        "bit_equal": bool(torch.equal(reward, reward_full[own]) and torch.equal(grad, grad_full[own])),
        "reward_rel_max": ((reward - reward_full[own]).abs() / reward_full[own].abs()).max().item(),
        "reward_share_of_bound": _share_of_bound(reward, reward_full[own], amplification[own]),
        "gathered_share_of_bound": _share_of_bound(gathered, reward_full, amplification),
        "k1_grad_share_of_bound": _share_of_bound(grad[:, :3], grad_full[own, :3],
                                                  amplification[own, None],
                                                  grad_full[:, :3].abs().amax(0)),
        "angle_grad_share_of_bound": max(
            _angle_share(grad, reward, amplification[own]),
            _angle_share(grad_full, reward_full, amplification),
        ),
    }
    report = parallel.collective_report(
        lambda: collectives.all_reduce(env.grad_step(rows, ENV_LEARNING_RATE)[1].sum(), "instances"),
        instances, dcn_axes=("instances",),
    )
    results["env"]["audit"] = {"lines": [op.line for op in report.ops],
                               "cross_bytes": report.dcn_bytes}
    del env, reward_full, grad_full

    particles = parallel.make_mesh({"particles": 2})
    big = _bench_beam(ctt, NUM_PARTICLES, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
    local = parallel.shard_beam(big, particles, particle_axis="particles")
    for grid_shape in ((32, 32, 32), (128, 128, 128)):
        label = f"{grid_shape[0]}"
        with parallel.active_mesh(particles):
            kicked = ctt.SpaceChargeKick(0.2, grid_shape=grid_shape, particle_axis="particles",
                                         dtype=torch.float32).track(local)
        reference = ctt.SpaceChargeKick(0.2, grid_shape=grid_shape, dtype=torch.float32).track(big)
        rows_reference = parallel.shard_beam(reference, particles, particle_axis="particles")
        kick_errors = _check_kicks(f"rank {rank} {label}^3 kick", local, kicked,
                                   rows_reference.to("cpu", torch.float64))
        grads = {}
        for dtype in (torch.float32, torch.float64):
            typed_local = local if dtype == torch.float32 else local.to(dtype=dtype)
            with parallel.active_mesh(particles), collectives.recording() as lines:
                value, grad = _sc_value_and_grad(
                    _sharded_segment(ctt, dtype, grid_shape, "particles"), typed_local, 0.1)
                value = collectives.all_reduce(value, "particles")
                grad = collectives.all_reduce(grad, "particles")
            typed = big if dtype == torch.float32 else big.to(dtype=dtype)
            value_one, grad_one = _sc_value_and_grad(_sc_segment(ctt, dtype, "cuda", grid_shape),
                                                     typed, 0.1)
            grads[str(dtype).split(".")[1]] = {
                "grad": grad.item(), "grad_one_process": grad_one.item(),
                "grad_rel": abs(grad.item() - grad_one.item()) / abs(grad_one.item()),
                "value_rel": abs(value.item() - value_one.item()) / abs(value_one.item()),
                "audit_bytes": parallel.collective_report("\n".join(lines), particles).total_bytes,
            }
        buffer = torch.zeros((1, *grid_shape), device="cuda")
        with parallel.active_mesh(particles):
            gloo_ms = time_ms(lambda: collectives.all_reduce(buffer, "particles"), runs=10)
        results[label] = {"kick_rms_rel_err": kick_errors, "gradients": grads,
                          "gloo_grid_all_reduce_ms": gloo_ms}
        del kicked, reference, rows_reference
    with open(f"{directory}/rank{rank}.json", "w") as handle:
        json.dump(results, handle)
    dist.barrier()
    dist.destroy_process_group()


def phase_two_rank() -> None:
    """Two processes on the one card over gloo (``torch.multiprocessing``
    and a file store): NCCL refuses two ranks on one device, and gloo
    all-reduces and broadcasts CUDA tensors. Each rank's env rows, kicks
    and gradients against the one-process run, and the audit's bytes."""
    import tempfile

    import torch.multiprocessing as mp

    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as directory:
        context = mp.spawn(_two_rank_worker, args=(f"{directory}/store", directory), nprocs=2,
                           join=False)
        deadline = time.monotonic() + TWO_RANK_TIMEOUT_S
        while not context.join(timeout=5):
            if time.monotonic() > deadline:
                for process in context.processes:
                    process.kill()
                raise AssertionError(f"two_rank: ranks still running after {TWO_RANK_TIMEOUT_S} s")
        ranks = []
        for rank in range(2):
            with open(f"{directory}/rank{rank}.json") as handle:
                ranks.append(json.load(handle))
    emit("two_rank", backend="gloo", world_size=2, seconds=time.perf_counter() - start,
         ranks=ranks)
    for rank, result in enumerate(ranks):
        env = result["env"]
        shares = {name: env[name] for name in ("reward_share_of_bound", "gathered_share_of_bound",
                                               "k1_grad_share_of_bound", "angle_grad_share_of_bound")}
        check(max(shares.values()) <= 1.0, f"two_rank {rank}: env rows past their bounds: {shares}")
        check(env["audit"]["cross_bytes"] <= AUDIT_READOUT_BYTES,
              f"two_rank {rank}: the env's grad step moved {env['audit']['cross_bytes']} bytes")
        for grid_shape in ((32, 32, 32), (128, 128, 128)):
            case = result[f"{grid_shape[0]}"]
            per_kick = (4 * 3 + math.prod(grid_shape))
            for dtype, limit in (("float32", SC_GRAD_F32_RTOL[grid_shape]),
                                 ("float64", SC_GRAD_F64_RTOL)):
                gradient = case["gradients"][dtype]
                check(gradient["grad_rel"] <= limit,
                      f"two_rank {rank} {grid_shape}: {dtype} gradient off by {gradient['grad_rel']}")
                width = 4 if dtype == "float32" else 8
                # Two kicks, forward and backward, plus the loss and its gradient.
                expected = 2 * 2 * per_kick * width + 2 * width
                check(gradient["audit_bytes"] == expected,
                      f"two_rank {rank} {grid_shape}: audit {gradient['audit_bytes']} bytes, "
                      f"not {expected}")


# ---------------------------------------------------------------------------
# The tenth slice: converters, beam I/O, export, plotting, profiling
# ---------------------------------------------------------------------------

RESOURCES = pathlib.Path(__file__).resolve().parent / "tests" / "resources"


def _imported_ares(ctt, dtype, device):
    """The ARES linac of ``tests/resources/Stage4v3_9.txt`` with its
    quadrupoles' k1 and its correctors' angles from SEED, in the lattice's
    order."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        segment = ctt.Segment.from_nx_tables(RESOURCES / "Stage4v3_9.txt", dtype=dtype,
                                             device=device)
    rng = np.random.default_rng(SEED)
    quadrupoles = [e for e in segment.elements if type(e).__name__ == "Quadrupole"]
    correctors = [e for e in segment.elements
                  if type(e).__name__ in ("HorizontalCorrector", "VerticalCorrector")]
    for quadrupole, k1 in zip(quadrupoles, rng.uniform(-IMPORTED_K1_RANGE, IMPORTED_K1_RANGE,
                                                       len(quadrupoles))):
        quadrupole.k1 = float(k1)
    for corrector, angle in zip(correctors, rng.uniform(-IMPORTED_ANGLE_RANGE,
                                                        IMPORTED_ANGLE_RANGE, len(correctors))):
        corrector.angle = float(angle)
    return segment


def _imported_file(ctt, name, dtype, device):
    filename, _ = IMPORTED_FILES[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if filename.endswith(".bmad"):
            return ctt.Segment.from_bmad(RESOURCES / filename, dtype=dtype, device=device)
        return ctt.Segment.from_elegant(RESOURCES / filename, name, sanitize_names=True,
                                        dtype=dtype, device=device)


def _moment_errors(particles, expected) -> dict:
    """mu_x and mu_y against sigma and sigma_x and sigma_y relative, of the
    card's particles summed in float64 against the float64 run's."""
    actual = particles.detach().double().cpu().reshape(-1, 7)
    expected = expected.detach().reshape(-1, 7)
    mu, sigma = actual.mean(0), actual.std(0)
    mu64, sigma64 = expected.mean(0), expected.std(0)
    return {
        **{f"mu_{n}": ((mu[i] - mu64[i]).abs() / sigma64[i]).item() for i, n in ((0, "x"), (2, "y"))},
        **{f"sigma_{n}": ((sigma[i] - sigma64[i]).abs() / sigma64[i]).item()
           for i, n in ((0, "x"), (2, "y"))},
    }


def phase_imported_ares(ctt, wrappers, smi) -> None:
    """The ARES linac imported from its NX Tables export on the card, 1M
    float32 particles with seeded magnets, against the port's float64 CPU
    run; the FODO, cavity and Bmad tutorial lattices the same way; the
    import through LatticeJSON and back; eager and graph time, launches and
    idle share."""
    import tempfile

    lattice = _imported_ares(ctt, torch.float32, "cuda")
    kinds = {}
    for element in lattice.elements:
        kinds[type(element).__name__] = kinds.get(type(element).__name__, 0) + 1
    length = float(lattice.length.sum())
    check(len(lattice.elements) == 226 and abs(length - 44.2215) < 1e-3,
          f"the NX Tables import has {len(lattice.elements)} elements over {length} m")
    beam = _bench_beam(ctt, NUM_PARTICLES, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
    beam64 = beam.to("cpu", torch.float64)

    _reset_launches(wrappers)
    out = lattice.track(beam)
    launches = _no_cic_launches(wrappers, "the imported ARES linac")
    finite = bool(torch.isfinite(out.particles).all())
    out64 = _imported_ares(ctt, torch.float64, "cpu").track(beam64)
    accuracy = {"ares": _moment_errors(out.particles, out64.particles)}

    with tempfile.TemporaryDirectory() as directory:
        lattice.to_lattice_json(f"{directory}/ares.json")
        restored = ctt.Segment.from_lattice_json(f"{directory}/ares.json", dtype=torch.float32,
                                                 device="cuda")
    same_bits = bool(torch.equal(restored.track(beam).particles, out.particles))

    files = {}
    for name, (_, mode) in IMPORTED_FILES.items():
        segment = _imported_file(ctt, name, torch.float32, "cuda")
        _reset_launches(wrappers)
        card = segment.track(beam)
        _no_cic_launches(wrappers, f"the {name} lattice")
        files[name] = {
            "mode": mode, "finite": bool(torch.isfinite(card.particles).all()),
            "plan": [type(todo).__name__ for todo in segment._plan()],
            **_moment_errors(card.particles,
                             _imported_file(ctt, name, torch.float64, "cpu").track(beam64).particles),
        }

    def step():
        return lattice.track(beam).particles

    ms = time_ms(step, runs=10)
    profile = profile_path("imported_ares", step, ms)
    emit(
        "imported_ares", card=smi, source="tests/resources/Stage4v3_9.txt",
        elements=len(lattice.elements), length_m=length, element_kinds=kinds,
        plan_entries=len(lattice._plan()), particles=NUM_PARTICLES, dtype="float32",
        ms=ms, graph_ms=graph_ms(step, calls=2, runs=10),
        kernel_launches=profile["kernel_launches"], device_busy_ms=profile["device_busy_ms"],
        idle_share=profile["idle_share"], finite=finite, accuracy_vs_cpu_f64=accuracy,
        lattice_json_bit_equal=same_bits, lattices=files, cic_kernel_launches=launches,
    )
    check(finite, "the imported ARES linac: non-finite particles")
    check(same_bits, "the imported ARES linac through LatticeJSON tracks differently")
    for name, error in accuracy["ares"].items():
        check(error <= IMPORTED_RTOL["linear"], f"imported ARES {name} off by {error}")
    for name, result in files.items():
        check(result["finite"], f"{name}: non-finite particles")
        for moment in ("sigma_x", "sigma_y"):
            check(result[moment] <= IMPORTED_RTOL[result["mode"]],
                  f"{name} {moment} off by {result[moment]}")


def _round_trip_errors(beam, loaded) -> dict:
    """Each coordinate's largest error over its largest value, and delta's
    largest error over eps E / p0c."""
    written = beam.particles.double()
    error = (loaded.particles.double() - written).abs().amax(dim=0)
    scale = written.abs().amax(dim=0)
    eps = torch.finfo(beam.particles.dtype).eps
    names = ("x", "px", "y", "py", "tau")
    return {
        **{name: (error[i] / scale[i]).item() for i, name in enumerate(names)},
        "p_over_si_bound": (error[5] / (eps * beam.energy.double() / beam.p0c.double())).item(),
        "charges_equal": bool(torch.equal(loaded.particle_charges, beam.particle_charges)),
    }


def phase_beam_io(ctt, wrappers) -> None:
    """The 1M float32 card beam through openPMD and back onto the card, then
    through the 32^3 space-charge segment: the kicks of the read-back beam
    against the original's, and the CIC launches of space_charge_segment.
    Without h5py the beam goes through the openPMD records in memory
    (``ParticleGroupData``), which the file holds."""
    import tempfile

    from cheetah_tpu_torch.converters.openpmd import ParticleGroupData

    beam = _bench_beam(ctt, NUM_PARTICLES, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
    try:
        import h5py  # noqa: F401

        has_h5py = True
    except ImportError:
        has_h5py = False

    def round_trip(original, directory, label):
        start = time.perf_counter()
        if has_h5py:
            path = f"{directory}/{label}.h5"
            original.save_as_openpmd_h5(path)
        else:
            group = ParticleGroupData(original._to_openpmd_data())
        written = time.perf_counter()
        if has_h5py:
            loaded = ctt.ParticleBeam.from_openpmd_file(path, energy=original.energy,
                                                        dtype=original.particles.dtype,
                                                        device="cuda")
        else:
            loaded = ctt.ParticleBeam.from_openpmd_particlegroup(
                group, energy=original.energy, dtype=original.particles.dtype, device="cuda")
        torch.cuda.synchronize()
        return loaded, written - start, time.perf_counter() - written

    with tempfile.TemporaryDirectory() as directory:
        loaded, write_s, read_s = round_trip(beam, directory, "f32")
        loaded64, write64_s, read64_s = round_trip(beam.to(dtype=torch.float64), directory, "f64")
    errors = _round_trip_errors(beam, loaded)
    errors64 = _round_trip_errors(beam.to(dtype=torch.float64), loaded64)

    segment = _sc_segment(ctt, torch.float32, "cuda")
    original = segment.track(beam)
    _reset_launches(wrappers)
    read_back = segment.track(loaded)
    launches = _launches(wrappers)
    expected = {name: 0 for name in wrappers} | {"deposit_multi_3d": 2, "gather_multi_3d": 2}
    kicks = {}
    for index, name in ((1, "px"), (3, "py"), (5, "p")):
        kick = (original.particles[..., index] - beam.particles[..., index]).double()
        kick_read = (read_back.particles[..., index] - loaded.particles[..., index]).double()
        kicks[name] = (torch.sqrt(torch.mean((kick_read - kick) ** 2))
                       / torch.sqrt(torch.mean(kick**2))).item()
    emit(
        "beam_io", particles=NUM_PARTICLES, h5py=has_h5py,
        route="openPMD HDF5 file" if has_h5py else "openPMD records in memory (no h5py)",
        write_s=write_s, read_s=read_s, write_f64_s=write64_s, read_f64_s=read64_s,
        device=str(loaded.particles.device), dtype=str(loaded.particles.dtype),
        round_trip_f32=errors, round_trip_f64=errors64, kick_rms_rel_diff=kicks,
        launches=launches,
    )
    check(loaded.particles.is_cuda and loaded.particles.dtype == torch.float32,
          f"the read-back beam is {loaded.particles.dtype} on {loaded.particles.device}")
    eps = torch.finfo(torch.float32).eps
    for name in ("x", "px", "y", "py", "tau"):
        check(errors[name] <= BEAM_IO_ULPS * eps, f"openPMD f32 {name} off by {errors[name]}")
        check(errors64[name] <= BEAM_IO_F64_RTOL, f"openPMD f64 {name} off by {errors64[name]}")
    check(errors["p_over_si_bound"] <= BEAM_IO_ULPS, f"openPMD f32 delta: {errors}")
    check(errors64["p_over_si_bound"] * torch.finfo(torch.float64).eps <= BEAM_IO_F64_RTOL,
          f"openPMD f64 delta: {errors64}")
    check(errors["charges_equal"] and errors64["charges_equal"], "openPMD changed the charges")
    check(launches == expected, f"the read-back beam's segment launched {launches}, not {expected}")
    for name, difference in kicks.items():
        check(difference <= KICK_RMS_TOLERANCE[name], f"read-back {name} kicks off by {difference}")


def _plot_data(ctt, lattice, beam, big_beam) -> tuple[bool, dict]:
    """What the deploy phase's plots draw: with matplotlib (Agg), the line
    data of ``plot_overview`` and ``plot_twiss_over_lattice`` of ``lattice``
    tracking ``beam`` and the line and mesh data of ``plot_distribution`` of
    ``big_beam``; without matplotlib the same numbers from the plotting
    module's data functions. Returns whether it drew, and the arrays under
    ``lattice`` and ``histograms``."""
    from cheetah_tpu_torch import plotting

    try:
        import matplotlib
    except ImportError:
        dimensions = ("x", "px", "y", "py", "tau", "p")
        lattice_data = [
            *plotting.beam_attrs_along_segment(
                lattice, beam, ("s", "mu_x", "sigma_x", "mu_y", "sigma_y"), broadcast=True),
            *plotting.beam_attrs_along_segment(lattice, beam, ("s", "beta_x", "beta_y")),
            plotting.segment_s_positions(lattice),
        ]
        histograms = [plotting.histogram_1d(big_beam, d)[1] for d in dimensions] + [
            plotting.histogram_2d(big_beam, a, b)[0]
            for a, b in itertools.combinations(dimensions, 2)
        ]
        return False, {"lattice": lattice_data, "histograms": histograms}

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import QuadMesh

    def lines(figure):
        return [line.get_xydata() for ax in figure.axes for line in ax.get_lines()]

    lattice_data = lines(lattice.plot_overview(beam)) + lines(lattice.plot_twiss_over_lattice(beam))
    figure, _ = big_beam.plot_distribution()
    histograms = lines(figure) + [
        np.ma.filled(collection.get_array(), 0.0)
        for ax in figure.axes for collection in ax.collections if isinstance(collection, QuadMesh)
    ]
    plt.close("all")
    return True, {"lattice": lattice_data, "histograms": histograms}


def _largest_share(actual: list, expected: list) -> float:
    """The largest difference of matching arrays over the largest value of
    each expected array."""
    check(len(actual) == len(expected), f"{len(actual)} plotted arrays, {len(expected)} expected")
    return max(
        float(np.max(np.abs(np.asarray(a, np.float64) - b)) / max(np.max(np.abs(b)), 1e-300))
        for a, b in zip(actual, expected)
    )


def phase_deploy(ctt, wrappers, futures) -> None:
    """The deployment path on the card: the env step exported by
    ``torch.export`` with the particle axis symbolic, saved, loaded and run
    at 10k and 100k particles against eager tracking, and the same program
    compiled by AOTInductor (by a compile process), loaded, and held to the
    same bound at both counts; the plots of the
    imported ARES linac (float64, from a card beam whose particles require
    grad) against the float64 CPU run, and of the 1M float32 beam against
    the same particles on the CPU;
    ``utils.profiling`` against chip_smoke's own timer."""
    import tempfile

    from cheetah_tpu_torch.utils import aot, profiling

    segment, step, beam = _deploy_step(ctt, "env_step")
    start = time.perf_counter()
    exported = _export(step, beam)
    export_s = time.perf_counter() - start
    with tempfile.TemporaryDirectory() as directory:
        torch.export.save(exported, f"{directory}/env_step.pt2")
        program = torch.export.load(f"{directory}/env_step.pt2").module()
    package, aoti_build_s = _built_package(futures, "env_step")

    _reset_launches(wrappers)
    runs = {}
    for num_particles in (10_000, 100_000):
        other = _bench_beam(ctt, num_particles, "cuda",
                            torch.Generator(device="cuda").manual_seed(SEED + 1))
        arguments = aot.beam_arguments(other)
        got, want = program(*arguments), segment.track(other).sigma_x
        built = package(*arguments)
        runs[num_particles] = {
            "shape": list(got.shape),
            "rel_err_vs_eager": ((got - want).abs() / want.abs()).max().item(),
            "aoti_shape": list(built.shape),
            "aoti_rel_err_vs_eager": ((built - want).abs() / want.abs()).max().item(),
            "loaded_ms": time_ms(lambda: program(*arguments), runs=10),
            "eager_track_ms": time_ms(lambda: segment.track(other).sigma_x, runs=10),
            "aoti_ms": time_ms(lambda: package(*arguments), runs=10),
        }
        if num_particles == 10_000:
            profile = profile_path("deploy_aoti", lambda: package(*arguments),
                                   runs[num_particles]["aoti_ms"])
            runs[num_particles]["aoti_kernel_launches"] = profile["kernel_launches"]
            runs[num_particles]["aoti_idle_share"] = profile["idle_share"]
    export_launches = _no_cic_launches(wrappers, "the exported env step")

    def env_step():
        return segment.track(beam).sigma_x

    own_ms = time_ms(env_step, runs=20)
    benchmark = profiling.benchmark(env_step, iters=20)
    stats = profiling.compiled_stats(env_step)
    slope_s = profiling.timeit_slope(env_step, iters=10, repeats=3)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lattice64, lattice_cpu = (
            ctt.Segment.from_nx_tables(RESOURCES / "Stage4v3_9.txt", dtype=torch.float64,
                                       device=device)
            for device in ("cuda", "cpu")
        )
    plot_beam = _bench_beam(ctt, 100_000, "cuda", torch.Generator(device="cuda").manual_seed(SEED))
    plot_beam = plot_beam.to(dtype=torch.float64)
    plot_beam.particles = plot_beam.particles.clone().requires_grad_()
    big_beam = _bench_beam(ctt, NUM_PARTICLES, "cuda",
                           torch.Generator(device="cuda").manual_seed(SEED))
    drew, card = _plot_data(ctt, lattice64, plot_beam, big_beam)
    _, cpu = _plot_data(ctt, lattice_cpu, plot_beam.to("cpu", torch.float64),
                        big_beam.to("cpu"))
    lattice_share = _largest_share(card["lattice"], cpu["lattice"])
    histogram_share = _largest_share(card["histograms"], cpu["histograms"])

    emit(
        "deploy", export_s=export_s, aoti_build_s=aoti_build_s, symbolic_axis="n", runs=runs,
        env_step_ms=own_ms, benchmark_mean_ms=benchmark["mean_ms"],
        benchmark_min_ms=benchmark["min_ms"], timeit_slope_ms=slope_s * 1e3,
        compiled_stats=stats, plots_drawn=drew, matplotlib=drew,
        plot_lattice_max_diff_over_largest=lattice_share,
        plot_histogram_max_diff_over_largest=histogram_share,
        plotted_arrays={"lattice": len(card["lattice"]), "histograms": len(card["histograms"])},
        cic_kernel_launches=export_launches,
    )
    for num_particles, run in runs.items():
        for how in ("", "aoti_"):
            check(run[f"{how}shape"] == [4096] and run[f"{how}rel_err_vs_eager"] <= DEPLOY_RTOL,
                  f"exported env step ({how or 'loaded'}) at {num_particles}: "
                  f"{run[f'{how}shape']}, off by {run[f'{how}rel_err_vs_eager']}")
    ratio = benchmark["mean_ms"] / own_ms
    check(1 / BENCHMARK_FACTOR <= ratio <= BENCHMARK_FACTOR,
          f"profiling.benchmark {benchmark['mean_ms']} ms against time_ms {own_ms} ms")
    check(lattice_share <= PLOT_F64_RTOL, f"plotted lattice data off by {lattice_share}")
    check(histogram_share == 0.0, f"plotted histograms off by {histogram_share}")


# ---------------------------------------------------------------------------
# The eleventh slice: the kernels as operators, a space-charge path exported
# ---------------------------------------------------------------------------

#: The operators each exported space-charge segment (two kicks) holds, by
#: grid: the untiled pair on 32^3, the x-tiled pair and a plan for each of
#: its autograd nodes on 128^3.
DEPLOY_SC_OPERATORS = {
    32: {"cheetah_tpu_torch.cic_deposit_multi.default": 2,
         "cheetah_tpu_torch.cic_gather_multi.default": 2},
    128: {"cheetah_tpu_torch.cic_tile_plan.default": 4,
          "cheetah_tpu_torch.cic_deposit_tiled.default": 2,
          "cheetah_tpu_torch.cic_gather_tiled.default": 2},
}
#: What the plain versions would leave in a graph: the untiled pair's
#: index_add_ and gather, the tiled gather's scatter_ and the plan's sort
#: and searchsorted. (The kick's own out-of-place index_add on the momentum
#: columns is aten.index_add, not index_add_.)
PLAIN_VERSION_TARGETS = ("aten.index_add_.", "aten.gather.", "aten.scatter_.", "aten.sort.",
                         "aten.searchsorted.")
DEPLOY_SC_PARTICLES = (NUM_PARTICLES, 100_000)
#: An AOTInductor package's float32 kicks against the card's float64 run:
#: within KICK_RMS_TOLERANCE, or, where eager tracking's own float32 kicks
#: lie further from that run (100k particles on 128^3), within this
#: factor of eager's error: as accurate as eager, in another rounding.
AOTI_KICK_FACTOR = 2.0


def _host_us(fn, calls: int = 200) -> float:
    """The host's time per call of ``fn``, in microseconds, over ``calls``
    back-to-back calls: what enqueueing a launch costs, the card working
    behind."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def _boundary_us(cic_kernels, cic_tiled, rounds: int = 5) -> dict:
    """The host's time per call of each operator, through the dispatcher
    and as its CUDA implementation called directly (medians of ``rounds``
    alternating rounds), on 4096 particles: the cost of the operator
    boundary."""
    from cheetah_tpu_torch.ops import cic_common

    generator = torch.Generator(device="cuda").manual_seed(SEED + 11)
    untiled, tiled = (32, 32, 32), (128, 128, 128)
    value = list(cic_common.orders_flat(cic_kernels.VALUE))
    normalized = {
        shape: _uniform_positions(generator, 1, shape, torch.float32)[:, :4096].contiguous()
        for shape in (untiled, tiled)
    }
    rows = torch.rand(1, 1, 1, 4096, generator=generator, device="cuda")
    grids = {shape: torch.rand(1, 3, *shape, generator=generator, device="cuda")
             for shape in (untiled, tiled)}
    plan = tuple(cic_tiled.plan_tiles(normalized[tiled], tiled)[2:])
    cases = {
        "cic_deposit_multi": (cic_kernels.DEPOSIT_MULTI, cic_kernels._deposit_kernel,
                              (normalized[untiled], rows, list(untiled), value)),
        "cic_gather_multi": (cic_kernels.GATHER_MULTI, cic_kernels._gather_kernel,
                             (grids[untiled], normalized[untiled], value)),
        "cic_tile_plan": (cic_tiled.TILE_PLAN, cic_tiled._plan_kernel,
                          (normalized[tiled], list(tiled))),
        "cic_deposit_tiled": (cic_tiled.DEPOSIT_TILED, cic_tiled._deposit_kernel,
                              (normalized[tiled], rows, list(tiled), value, *plan)),
        "cic_gather_tiled": (cic_tiled.GATHER_TILED, cic_tiled._gather_kernel,
                             (grids[tiled], normalized[tiled], value, *plan)),
    }
    results = {}
    for name, (operator, implementation, arguments) in cases.items():
        through, direct = [], []
        for _ in range(rounds):
            through.append(_host_us(lambda: operator(*arguments)))
            direct.append(_host_us(lambda: implementation(*arguments)))
        results[name] = {"operator_us": statistics.median(through),
                         "implementation_us": statistics.median(direct)}
        results[name]["boundary_us"] = (results[name]["operator_us"]
                                        - results[name]["implementation_us"])
    return results


def phase_deploy_space_charge(ctt, wrappers, cic_kernels, cic_tiled, futures) -> dict:
    """The space-charge segment (two kicks) exported by ``torch.export``
    from a 1M-particle float32 beam, the particle axis symbolic, on the
    32^3 grid (the untiled pair) and on 128^3 (the x-tiled pair and its
    plans); saved, loaded, and called at 1M and 100k particles: its
    particles equal to eager ``segment.track``'s of the same beam bit for
    bit (and its kicks within ``KICK_RMS_TOLERANCE``), its launches equal to
    eager tracking's, no plan
    by ``torch.sort``, its graph holding the ``cheetah_tpu_torch``
    operators and none of the plain versions' operators; the export's
    seconds, the loaded program's CUDA-event and graph ms against eager
    tracking's. Each exported program is also compiled by AOTInductor
    (``aot.AOTI_CONFIGS``) by a compile process and loaded: the package
    launches the kernels as eager tracking does, its kicks stay within
    ``KICK_RMS_TOLERANCE`` of the card's float64 run's and repeat bit for
    bit, with its build seconds, CUDA-event ms, launches and idle share. Then the host's time per call of each operator
    against its CUDA implementation called directly. Returns each program's
    launches at 1M particles, by grid, and each package's under
    ``aoti_<grid>``."""
    import tempfile

    from cheetah_tpu_torch.utils import aot

    programs, launches_by_grid = {}, {}
    for grid in ((32, 32, 32), (128, 128, 128)):
        label = f"deploy_sc_{grid[0]}"
        segment, step, beam = _deploy_step(ctt, f"sc_{grid[0]}")
        segment64 = _sc_segment(ctt, torch.float64, "cuda", grid)
        start = time.perf_counter()
        exported = _export(step, beam)
        export_s = time.perf_counter() - start
        targets = collections.Counter(
            str(node.target) for node in exported.graph.nodes if node.op == "call_function"
        )
        operators = {name: count for name, count in targets.items()
                     if name.startswith("cheetah_tpu_torch.")}
        plain = {name: count for name, count in targets.items()
                 if name.startswith(PLAIN_VERSION_TARGETS)}
        check(operators == DEPLOY_SC_OPERATORS[grid[0]],
              f"{label}: the graph holds the operators {operators}")
        check(not plain, f"{label}: the graph holds the plain versions' {plain}")
        with tempfile.TemporaryDirectory() as directory:
            torch.export.save(exported, f"{directory}/{label}.pt2")
            program = torch.export.load(f"{directory}/{label}.pt2").module()
        package, aoti_build_s = _built_package(futures, f"sc_{grid[0]}")

        kind = "tiled_3d" if cic_kernels.uses_tiled(grid) else "3d"
        expected = {name: 0 for name in wrappers}
        expected.update({f"deposit_multi_{kind}": 2, f"gather_multi_{kind}": 2})
        if kind == "tiled_3d":
            expected["plan_tiles"] = 4
        runs = {}
        for num_particles in DEPLOY_SC_PARTICLES:
            other = _bench_beam(ctt, num_particles, "cuda",
                                torch.Generator(device="cuda").manual_seed(SEED + 1))
            arguments = aot.beam_arguments(other)
            sorts = cic_tiled.tile_plan.calls
            _reset_launches(wrappers)
            got = program(*arguments)
            loaded = _launches(wrappers)
            _reset_launches(wrappers)
            want = segment.track(other).particles
            eager = _launches(wrappers)
            check(cic_tiled.tile_plan.calls == sorts, f"{label}: a plan went through torch.sort")
            check(loaded == eager == expected,
                  f"{label} at {num_particles}: loaded launched {loaded}, eager {eager}")
            check(tuple(got.shape) == (num_particles, 7) and bool(torch.isfinite(got).all()),
                  f"{label} at {num_particles}: particles {tuple(got.shape)}, not all finite")
            errors = _check_kick_particles(
                f"{label} at {num_particles}", other.particles.cpu().double(), got, want
            )
            check(torch.equal(_bits(got), _bits(want)),
                  f"{label} at {num_particles}: the loaded program's particles differ from eager")
            # The AOTInductor package: the kernels as often as eagerly, the
            # kicks as close to the card's float64 run as eager tracking's
            # (Inductor's code rounds the float32 field computation in its
            # own order; at 128^3 its kicks and eager's differ by 1e-4 to
            # 2e-4 RMS), the same bits twice.
            _reset_launches(wrappers)
            built = package(*arguments)
            built_launches = _launches(wrappers)
            check(built_launches == eager,
                  f"{label} at {num_particles}: the AOTInductor package launched "
                  f"{built_launches}, eager {eager}")
            before = other.particles.cpu().double()
            want64 = segment64.track(other.to(dtype=torch.float64)).particles
            eager_errors = _kick_errors(before, want, want64)
            aoti_errors = _kick_errors(before, built, want64)
            aoti_vs_eager = _kick_errors(before, built, want)
            for name, error in aoti_errors.items():
                bound = max(KICK_RMS_TOLERANCE[name], AOTI_KICK_FACTOR * eager_errors[name])
                check(error <= bound, f"{label} AOTInductor at {num_particles}: {name} kick "
                      f"off the card's float64 run by {error} RMS, eager by "
                      f"{eager_errors[name]}")
            check(torch.equal(_bits(built), _bits(package(*arguments))),
                  f"{label} at {num_particles}: the AOTInductor package moved between runs")
            # Loaded, eager, loaded again: the host's load drifts during a run.
            loaded_ms = time_ms(lambda: program(*arguments), runs=10)
            eager_ms = time_ms(lambda: segment.track(other), runs=10)
            aoti_ms = time_ms(lambda: package(*arguments), runs=10)
            runs[num_particles] = {
                "kick_rms_rel_err_vs_eager": errors, "bit_for_bit_vs_eager": True,
                "launches": loaded, "aoti_launches": built_launches,
                "aoti_kick_rms_rel_err_vs_card_f64": aoti_errors,
                "eager_kick_rms_rel_err_vs_card_f64": eager_errors,
                "aoti_kick_rms_rel_diff_vs_eager": aoti_vs_eager,
                "loaded_ms": loaded_ms, "eager_track_ms": eager_ms, "aoti_ms": aoti_ms,
                "loaded_again_ms": time_ms(lambda: program(*arguments), runs=10),
                "loaded_graph_ms": graph_ms(lambda: program(*arguments), runs=10),
            }
            if num_particles == NUM_PARTICLES:
                launches_by_grid[grid[0]] = loaded
                launches_by_grid[f"aoti_{grid[0]}"] = built_launches
                for how, fn, ms in (("loaded", lambda: program(*arguments), loaded_ms),
                                    ("aoti", lambda: package(*arguments), aoti_ms),
                                    ("eager", lambda: segment.track(other), eager_ms)):
                    profile = profile_path(f"{label}_{how}", fn, ms)
                    runs[num_particles][f"{how}_kernel_launches"] = profile["kernel_launches"]
                    runs[num_particles][f"{how}_idle_share"] = profile["idle_share"]
        programs[label] = {"grid": list(grid), "export_s": export_s,
                           "aoti_build_s": aoti_build_s, "operators": operators, "runs": runs}
    moved = _moved_program(ctt, wrappers, beam)
    boundary = _boundary_us(cic_kernels, cic_tiled)
    emit("deploy_space_charge", symbolic_axis="n", dtype="float32", kicks=2,
         exported_from=NUM_PARTICLES, programs=programs, exported_on_cpu=moved,
         operator_boundary=boundary)
    return launches_by_grid


def _moved_program(ctt, wrappers, beam) -> dict:
    """Nothing about the operators is decided at export: the 32^3 segment
    exported from a CPU beam of 10k particles (the particle axis symbolic)
    and moved to the card by ``move_to_device_pass`` launches the untiled
    pair on the 1M beam, and its kicks match eager tracking's."""
    from torch.export.passes import move_to_device_pass

    from cheetah_tpu_torch.utils import aot

    cpu_beam = _bench_beam(ctt, 10_000, "cpu", torch.Generator().manual_seed(SEED))
    cpu_segment = _sc_segment(ctt, torch.float32, "cpu")
    exported = torch.export.export(
        aot.TrackReadout(cpu_segment, "particles", cpu_beam.species),
        aot.beam_arguments(cpu_beam), dynamic_shapes=aot.symbolic_particle_beam(cpu_beam),
    )
    program = move_to_device_pass(exported, "cuda").module()
    _reset_launches(wrappers)
    got = program(*aot.beam_arguments(beam))
    launches = _launches(wrappers)
    expected = {name: 0 for name in wrappers} | {"deposit_multi_3d": 2, "gather_multi_3d": 2}
    check(launches == expected, f"the moved program launched {launches}, not {expected}")
    want = _sc_segment(ctt, torch.float32, "cuda").track(beam).particles
    errors = _check_kick_particles("the moved program", beam.particles.cpu().double(), got,
                                   want)
    return {"grid": [32, 32, 32], "launches": launches, "kick_rms_rel_err_vs_eager": errors}


# ---------------------------------------------------------------------------
# The fourteenth slice: the paths under torch.compile, the exported
# programs built by AOTInductor
# ---------------------------------------------------------------------------

#: Where Inductor and Triton keep what they build, and where the
#: AOTInductor packages go: the git-ignored build/.
COMPILE_CACHE = pathlib.Path(__file__).resolve().parent / "build" / "compile_cache"
#: Runs of a compiled space-charge gradient that must give the same bits.
COMPILED_REPEATS = 5
#: Slice paths 1-6 as chip_smoke compiles them (``_compiled_case``).
COMPILED_PATHS = ("env_step", "env_step_grad", "parameter_beam_env_step", "sc_segment_32",
                  "sc_grad_32", "sc_grad_128", "batched_env_step", "batched_env_grad_step")
#: The compile processes (``_start_compiles``), each with its tasks, which
#: it runs while the path phases run: it builds the AOTInductor packages
#: that the deploy phases load (first, as those phases come first) and
#: compiles and checks its paths (``_compile_path``); at the end it times
#: them (``_time_path``). A cold compile is mostly Inductor's
#: single-threaded lowering and code generation (120-200 s a path in both
#: modes on the card's host beside the path phases, a package 130-140 s),
#: which one after another would not fit the script's time limit; more
#: processes than four slow each compile as much as they add (six: a
#: package 225-235 s). The groups even out each process's share; the two
#: space-charge gradients, which compile the same function, lie in
#: different processes.
COMPILE_GROUPS = (
    ("aoti_sc_128", "batched_env_grad_step"),
    ("aoti_env_step", "sc_grad_32", "env_step_grad"),
    ("sc_grad_128", "batched_env_step", "env_step"),
    ("aoti_sc_32", "sc_segment_32", "parameter_beam_env_step"),
)
COMPILE_THREADS = 2
COMPILE_TIMEOUT_S = 900


def _compile_cache() -> None:
    """Point Inductor and Triton at ``COMPILE_CACHE``, in the environment
    that the compile processes inherit, before the first compile."""
    import os

    COMPILE_CACHE.mkdir(parents=True, exist_ok=True)
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(COMPILE_CACHE / "inductor")
    os.environ["TRITON_CACHE_DIR"] = str(COMPILE_CACHE / "triton")


def _inductor_recording(graphs: list):
    """Inductor, keeping the operators of every graph it gets from
    AOTAutograd (a step's forward, and its backward)."""
    from torch._inductor.compile_fx import compile_fx, compile_fx_inner

    def inner(graph_module, example_inputs, **kwargs):
        graphs.append(collections.Counter(
            str(node.target) for node in graph_module.graph.nodes if node.op == "call_function"
        ))
        return compile_fx_inner(graph_module, example_inputs, **kwargs)

    def backend(graph_module, example_inputs):
        return compile_fx(graph_module, example_inputs, inner_compile=inner)

    return backend


def _graph_operators(graphs: list) -> tuple[dict, dict]:
    """The ``cheetah_tpu_torch`` operators and the plain versions' operators
    that the compiled graphs hold, summed over the graphs."""
    total = sum(graphs, collections.Counter())
    return ({name: count for name, count in total.items() if name.startswith("cheetah_tpu_torch.")},
            {name: count for name, count in total.items() if name.startswith(PLAIN_VERSION_TARGETS)})


def _detached(outputs) -> tuple:
    """A step's outputs as copies, which a later replay of a CUDA graph
    does not overwrite."""
    return tuple(output.detach().clone() for output in outputs)


def _output_bits(outputs) -> torch.Tensor:
    return _bits(torch.cat([output.detach().flatten() for output in outputs]))


def _compile_stages(count: int = 6) -> dict:
    """The longest stages of the compiles since the metrics were cleared
    (Dynamo's tracing, AOTAutograd, Inductor, Triton), in seconds."""
    names, values = torch._dynamo.utils.compile_times(repr="csv", aggregate=True)
    stages = sorted(zip(names, (float(value) for value in values)), key=lambda item: -item[1])
    return dict(stages[:count])


def _rel_max(actual: torch.Tensor, expected: torch.Tensor) -> float:
    """max |actual - expected| / |expected|, element by element."""
    return ((actual.double() - expected.double()).abs() / expected.double().abs()).max().item()


class _CompiledCase(NamedTuple):
    """One slice path as a user compiles it: ``fn`` is what
    ``torch.compile`` gets; ``call(f)`` runs one step through ``f`` (``fn``
    itself or a compiled ``fn``) and returns its outputs; ``renew()`` gives
    the step's parameters new values of the same shapes; ``compare(actual,
    expected)`` holds a compiled step's outputs to the uncompiled step's
    (raising past the path's bound) and returns the errors;
    ``expected_cic`` the wrappers' launches of one step; ``repeats`` how
    many runs must give the same bits."""

    fn: object
    call: object
    renew: object
    compare: object
    expected_cic: dict
    repeats: int = 0


def _compiled_case(name: str, ctt, parallel, cic_kernels) -> _CompiledCase:
    """The slice path ``name`` (of ``COMPILED_PATHS``) at the full widths,
    float32 on the card, its parameters at their first values."""
    from cheetah_tpu_torch.lattices import ares_ea_subcell

    generator = torch.Generator(device="cuda").manual_seed(SEED)
    if name in ("env_step", "env_step_grad", "parameter_beam_env_step"):
        segment = ares_ea_subcell(torch.float32)
        beam = _bench_beam(ctt, 10_000, "cuda", generator)
        grad = name == "env_step_grad"
        spans = iter([(-20.0, 20.0), (-12.0, 15.0)] * 2)

        def renew():
            low, high = next(spans)
            segment.AREAMQZM1.k1 = torch.linspace(low, high, ENV_INSTANCES, device="cuda",
                                                  requires_grad=grad)

        renew()
        if grad:

            def value_and_grad(f):
                k1 = segment.AREAMQZM1.k1
                value = f(segment, beam)
                return value, torch.autograd.grad(value, k1)[0]

            def compare_grad(actual, expected):
                value = _rel_max(actual[0], expected[0])
                k1_grad = relative_error(actual[1], expected[1])[1]
                check(value <= ENV_STEP_RTOL and k1_grad <= ENV_GRAD_TOLERANCE,
                      f"compiled env gradient off eager: value {value}, k1 gradient {k1_grad}")
                return {"value": value, "k1_grad": k1_grad}

            return _CompiledCase(lambda s, b: s.track(b).sigma_x.sum(), value_and_grad, renew,
                                 compare_grad, {})
        bound = ENV_STEP_RTOL
        if name == "parameter_beam_env_step":
            bound = PARAMETER_BEAM_RTOL
            beam = ctt.ParameterBeam.from_twiss(
                beta_x=5.0, emittance_x=2e-9, beta_y=3.0, emittance_y=2e-9, energy=1.54e8,
                dtype=torch.float32, device="cuda",
            )
            fn = lambda s, b: s.track_moments(b).sigma_x  # noqa: E731
        else:
            fn = lambda s, b: s.track(b).sigma_x  # noqa: E731

        def compare_sigma(actual, expected):
            error = _rel_max(actual[0], expected[0])
            check(error <= bound, f"compiled {name}: sigma_x off eager by {error}")
            return error

        return _CompiledCase(fn, lambda f: (f(segment, beam),), renew, compare_sigma, {})

    if name.startswith("sc_"):
        grid = (int(name.rsplit("_", 1)[1]),) * 3
        segment = _sc_segment(ctt, torch.float32, "cuda", grid)
        beam = _bench_beam(ctt, NUM_PARTICLES, "cuda", generator)
        grad = name.startswith("sc_grad")
        lengths = iter([0.1, 0.12] * 2)

        def renew():
            segment.elements[0].length = torch.tensor(next(lengths), device="cuda",
                                                      requires_grad=grad)

        renew()
        kind = "tiled_3d" if cic_kernels.uses_tiled(grid) else "3d"
        if not grad:
            before = beam.particles.cpu().double()

            def compare_kicks(actual, expected):
                return _check_kick_particles(f"compiled {name}", before, actual[0], expected[0])

            return _CompiledCase(lambda s, b: s.track(b).particles, lambda f: (f(segment, beam),),
                                 renew, compare_kicks,
                                 {f"deposit_multi_{kind}": 2, f"gather_multi_{kind}": 2})

        def value_and_grad(f):
            length = segment.elements[0].length
            value = f(segment, beam)
            return value, torch.autograd.grad(value, length)[0]

        def compare_grad(actual, expected):
            error = abs(actual[1].item() - expected[1].item()) / abs(expected[1].item())
            check(error <= SC_GRAD_F32_RTOL[grid], f"compiled {name} off eager by {error}")
            return error

        expected = {f"deposit_multi_{kind}": 4, f"gather_multi_{kind}": 6}
        if kind == "tiled_3d":
            expected["plan_tiles"] = 4
        return _CompiledCase(lambda s, b: torch.sum(torch.square(s.track(b).px)),
                             value_and_grad, renew, compare_grad, expected, COMPILED_REPEATS)

    # BatchedLatticeEnv (config 5), compiled as a user compiles it:
    # torch.compile(env.step), new settings every call.
    settings = torch.tensor(_env_settings(), dtype=torch.float32, device="cuda")
    beam = _bench_beam(ctt, 10_000, "cuda", generator)
    env = _env(parallel, torch.float32, "cuda", beam)
    current = {"settings": settings}
    shifts = iter([0.0, 0.5] * 2)

    def renew():
        shift = next(shifts)
        current["settings"] = settings + torch.tensor([shift, -shift, shift, 0.0, 0.0],
                                                      device="cuda")

    renew()
    if name == "batched_env_step":

        def step_call(f):
            outgoing, _, reward = f(current["settings"])
            return reward, outgoing.particles

        def compare_step(actual, expected):
            # The raw-moment variance amplifies float32 rounding by 1 +
            # (mu / sigma)^2 per instance: the bound of phase batched_env.
            got, want = (ctt.ParticleBeam(outputs[1], beam.energy)
                         for outputs in (actual, expected))
            bound = ENV_STEP_RTOL * _amplification(want)
            errors = [((a - e).abs() / e.abs() / bound).max().item()
                      for a, e in ((actual[0], expected[0]), (got.sigma_x, want.sigma_x),
                                   (got.sigma_y, want.sigma_y))]
            check(max(errors) <= 1.0, f"compiled env.step off eager by {errors} of its bound")
            return max(errors)

        return _CompiledCase(env.step, step_call, renew, compare_step, {})

    def compare_grad_step(actual, expected):
        # The steps taken: the k1 gradients within their bound; the
        # gradients by the corrector angles are zero up to float32
        # rounding (sigma does not depend on the centroid; phase
        # batched_env bounds that rounding), and the learning rate times
        # that rounding moves the angles differently in each rounding order.
        grads = [(outputs[0] - current["settings"]) / ENV_LEARNING_RATE
                 for outputs in (actual, expected)]
        k1_grad = relative_error(grads[0][:, :3], grads[1][:, :3])[1]
        reward = relative_error(actual[1], expected[1])[1]
        check(k1_grad <= ENV_GRAD_TOLERANCE and reward <= ENV_STEP_RTOL,
              f"compiled grad_step off eager: k1 gradients {k1_grad}, reward {reward}")
        return {"k1_grad": k1_grad, "reward": reward,
                "angle_grad_max_diff": (grads[0][:, 3:] - grads[1][:, 3:]).abs().max().item()}

    return _CompiledCase(env.grad_step, lambda f: f(current["settings"], ENV_LEARNING_RATE),
                         renew, compare_grad_step, {})


def _graphed(fn):
    """``fn`` compiled with CUDA graphs (``mode="reduce-overhead"``)."""
    return torch.compile(fn, fullgraph=True, dynamic=False, mode="reduce-overhead")


def _graphed_call(case: _CompiledCase, graphed):
    torch.compiler.cudagraph_mark_step_begin()
    return case.call(graphed)


def _compile_process_init() -> None:
    """A compile process's settings: the main process's full float32
    products, and ``COMPILE_THREADS`` Triton compile workers."""
    import torch._inductor.config

    torch._inductor.config.compile_threads = COMPILE_THREADS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _build_package(name: str) -> float:
    """In a compile process: deploy step ``name`` exported and built by
    AOTInductor into ``COMPILE_CACHE / <name>.pt2``; the build's seconds."""
    import cheetah_tpu_torch as ctt

    _, step, beam = _deploy_step(ctt, name)
    start = time.perf_counter()
    _aoti_build(_export(step, beam), name)
    seconds = time.perf_counter() - start
    del step, beam
    torch.cuda.empty_cache()  # the card's memory back to the path phases
    return seconds


def _start_compiles():
    """Start the compile processes, one ``ProcessPoolExecutor`` of one
    process for each of ``COMPILE_GROUPS``, and give each its tasks:
    ``aoti_<program>`` (``_build_package``), or a path (``_compile_path``).
    Returns the pools and the futures by task."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pools, futures = [], {}
    for group in COMPILE_GROUPS:
        pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"),
                                   initializer=_compile_process_init)
        pools.append(pool)
        for task in group:
            if task.startswith("aoti_"):
                futures[task] = pool.submit(_build_package, task.removeprefix("aoti_"))
            else:
                futures[task] = pool.submit(_compile_path, task)
    return pools, futures


def _profiled_cic_kernels(fn) -> dict:
    """The CIC kernels that torch.profiler records in one call of ``fn``,
    launches by kernel name, its trace opened one call before the call it
    counts (the schedule's warm-up step). In a process that runs
    Inductor's code the profiler loses a few kernel records of a step,
    now and then a CIC kernel's (``scripts_torch/profiler_drops.py``), so
    these counts name the kernels; the wrappers count the launches
    (``_compile_path``). (The warm-up also inflates the device times of
    the counted call, which ``profile_path`` measures with a trace of the
    call alone.)"""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as trace:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            trace.step()
    counts = collections.Counter()
    for e in trace.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and any(
            piece in e.key for pieces in KERNEL_FAMILIES.values() for piece in pieces
        ):
            counts[_kernel_name(e.key)] += e.count
    return dict(counts)


#: In a compile process: each path it compiled (``_compile_path``), kept
#: for ``_time_path``.
_COMPILED = {}


def _compile_path(name: str) -> dict:
    """In a compile process: path ``name`` under ``torch.compile(fn,
    fullgraph=True, dynamic=False)`` with Inductor, its graphs recorded:
    compiled cold by its first call, held against eager, not traced again
    after ``renew()``, held again; its graphs hold no plain version's
    operator; the wrappers count ``expected_cic`` launches a step;
    ``repeats`` runs give the same bits. Then compiled with
    ``mode="reduce-overhead"`` (CUDA graphs): the calls that run and
    record the step count ``expected_cic`` launches each, its replays none;
    held and repeated the same way. Keeps both for ``_time_path``; returns
    the path's fields."""
    import cheetah_tpu_torch as ctt
    from cheetah_tpu_torch import parallel
    from cheetah_tpu_torch.ops import cic_kernels, cic_tiled

    wrappers = _wrappers(cic_kernels, cic_tiled)
    case = _compiled_case(name, ctt, parallel, cic_kernels)
    label = f"compiled_{name}"
    graphs = []
    compiled = torch.compile(case.fn, fullgraph=True, dynamic=False,
                             backend=_inductor_recording(graphs))
    want = _detached(case.call(case.fn))
    torch._dynamo.utils.compilation_time_metrics.clear()
    start = time.perf_counter()
    got = _detached(case.call(compiled))
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - start
    stages = _compile_stages()
    errors = {"first": case.compare(got, want)}
    case.renew()
    want = _detached(case.call(case.fn))
    with torch._dynamo.config.patch(error_on_recompile=True):
        got = _detached(case.call(compiled))
    errors["renewed"] = case.compare(got, want)
    operators, plain = _graph_operators(graphs)
    check(not plain, f"{label}: the compiled graphs hold the plain versions' {plain}")

    _reset_launches(wrappers)
    case.call(compiled)
    launches = _launches(wrappers)
    expected = {name: 0 for name in wrappers} | case.expected_cic
    check(launches == expected, f"{label}: the compiled step launched {launches}")
    if case.repeats:
        runs = [_output_bits(case.call(compiled)) for _ in range(case.repeats)]
        check(all(torch.equal(run, runs[0]) for run in runs),
              f"{label}: the compiled step's outputs moved between runs")

    graphed = _graphed(case.fn)
    # Compile, warm up, record, replay: the wrappers count the launches of
    # each call that runs or records the step, and none of a replay, so the
    # calls before the first that launches nothing give the launches that
    # the CUDA graph holds.
    calls = []
    start = time.perf_counter()
    while len(calls) < 3 or (case.expected_cic and any(calls[-1].values())):
        check(len(calls) < 6, f"{label}: the CUDA-graph step never replayed: {calls}")
        _reset_launches(wrappers)
        got = _detached(_graphed_call(case, graphed))
        calls.append(_launches(wrappers))
    graphs_compile_s = time.perf_counter() - start
    if case.expected_cic:
        first_replay = next(i for i, call in enumerate(calls) if not any(call.values()))
        check(first_replay > 0 and all(call == expected for call in calls[:first_replay])
              and not any(value for call in calls[first_replay:] for value in call.values()),
              f"{label}: the CUDA-graph step's calls launched {calls}, not {expected} "
              "until its replays")
    errors["graphs"] = case.compare(got, want)
    if case.repeats:
        runs = [_output_bits(_graphed_call(case, graphed)) for _ in range(case.repeats)]
        check(all(torch.equal(run, runs[0]) for run in runs),
              f"{label}: the CUDA-graph step's outputs moved between runs")
    _COMPILED[name] = (case, compiled, graphed)
    torch.cuda.empty_cache()  # the card's memory back to the path phases
    return {
        "compile_s": compile_s, "graphs_compile_s": graphs_compile_s,
        "compile_seconds_by_stage": stages, "errors_vs_eager": errors, "operators": operators,
        "wrapper_launches": launches, "graphs_wrapper_launches_by_call": calls,
        "graph_count": len(graphs),
        "repeats_bit_for_bit": case.repeats,
    }


def _time_path(name: str) -> dict:
    """In the compile process that compiled path ``name``, with nothing
    else running: its eager, compiled and CUDA-graph steps timed with CUDA
    events (host included) and profiled (launches, idle share); the
    compiled and the CUDA-graph step run the CIC kernels that the eager
    step runs, by the profiler's kernel names (their launches are the
    wrappers', held in ``_compile_path``). Returns the fields."""
    case, compiled, graphed = _COMPILED.pop(name)
    label = f"compiled_{name}"
    timings, profiles, names = {}, {}, {}
    for how, step in (("eager", lambda: case.call(case.fn)),
                      ("compiled", lambda: case.call(compiled)),
                      ("graphs", lambda: _graphed_call(case, graphed))):
        ms = time_ms(step, runs=10)
        profile = profile_path(f"{label}_{how}", step, ms)
        cic = _profiled_cic_kernels(step)
        timings[f"{how}_ms"] = ms
        profiles[how] = {"kernel_launches": profile["kernel_launches"],
                         "idle_share": profile["idle_share"],
                         "device_busy_ms": profile["device_busy_ms"], "cic": cic}
        # The kernels named in either profile of the step.
        names[how] = sorted(set(cic).union(*(family["by_kernel"]
                                             for family in profile["cic_kernels"].values())))
    for how in ("compiled", "graphs"):
        check(names[how] == names["eager"],
              f"{label}: CIC kernels {how} {names[how]}, eager {names['eager']}")
    del case, compiled, graphed
    torch.cuda.empty_cache()  # the card's memory for the next path, in another process
    return {**timings, "profiles": profiles, "cic_kernel_names": names["eager"]}


def phase_compiled(pools, futures) -> dict:
    """Slice paths 1-6 (``COMPILED_PATHS``) under ``torch.compile(fullgraph=
    True, dynamic=False)`` with Inductor at the full widths: each compiled
    cold and checked by a compile process while the path phases ran
    (``_compile_path``), then timed and profiled by that process
    (``_time_path``), one path after another while every other process
    waits, on a quiet card. One line per path, then ``compiled`` with the
    compile seconds. Returns the wrappers' launches of one compiled step of
    each space-charge path."""
    import triton

    check(not torch._dynamo.config.suppress_errors, "Dynamo would hide a compile failure")
    paths = {name: futures[name].result(timeout=COMPILE_TIMEOUT_S) for name in COMPILED_PATHS}
    torch.cuda.empty_cache()  # this process's cached card memory, for the compile processes
    for group, pool in zip(COMPILE_GROUPS, pools):
        for name in group:
            if name in paths:
                paths[name].update(pool.submit(_time_path, name).result(timeout=COMPILE_TIMEOUT_S))
                emit(f"compiled_{name}", **paths[name])
    emit("compiled", triton=triton.__version__, processes=len(COMPILE_GROUPS),
         compile_s={name: fields["compile_s"] for name, fields in paths.items()},
         graphs_compile_s={name: fields["graphs_compile_s"] for name, fields in paths.items()})
    return {f"compiled_{name}": paths[name]["wrapper_launches"]
            for name in COMPILED_PATHS if name.startswith("sc_")}


def _stop_compiles(pools) -> None:
    """Stop the compile processes (their queued tasks cancelled, a running
    one finished)."""
    for pool in pools:
        pool.shutdown(cancel_futures=True)


def _aoti_compiler() -> str:
    """The C++ compiler for AOTInductor's wrapper, which it builds with
    ``-fopenmp``: ``$CXX`` where that compiler builds OpenMP code, else
    ``g++``. (On one card's host ``$CXX`` is a g++ without ``libgomp.spec``
    and fails every package build.)"""
    import os

    source = COMPILE_CACHE / f"openmp_probe_{os.getpid()}.cpp"
    source.write_text("int probe() { int n = 0;\n#pragma omp parallel\n{ n = 1; }\nreturn n; }\n")
    for compiler in (os.environ.get("CXX"), "g++"):
        if compiler and subprocess.run(
            [compiler, "-fopenmp", "-shared", "-fPIC", str(source), "-o",
             str(source.with_suffix(".so"))], capture_output=True, timeout=120,
        ).returncode == 0:
            return compiler
    raise AssertionError("no C++ compiler here builds OpenMP code, which AOTInductor needs")


def _deploy_step(ctt, name: str):
    """The segment, its ``aot.TrackReadout`` step and the beam it is
    exported from, for the deploy phases and the AOTInductor builds:
    ``env_step`` (the env step's sigma_x, 4096 instances, 10k particles) or
    ``sc_<n>`` (the two-kick space-charge segment's particles on n^3, 1M)."""
    from cheetah_tpu_torch.lattices import ares_ea_subcell
    from cheetah_tpu_torch.utils import aot

    generator = torch.Generator(device="cuda").manual_seed(SEED)
    if name == "env_step":
        segment = ares_ea_subcell(torch.float32, device="cuda")
        segment.AREAMQZM1.k1 = torch.linspace(-20, 20, ENV_INSTANCES, device="cuda")
        beam = _bench_beam(ctt, 10_000, "cuda", generator)
        return segment, aot.TrackReadout(segment, "sigma_x", beam.species), beam
    grid = (int(name.removeprefix("sc_")),) * 3
    segment = _sc_segment(ctt, torch.float32, "cuda", grid)
    beam = _bench_beam(ctt, NUM_PARTICLES, "cuda", generator)
    return segment, aot.TrackReadout(segment, "particles", beam.species), beam


def _export(step, beam):
    """``step`` exported by ``torch.export`` from ``beam``, the particle
    axis symbolic."""
    from cheetah_tpu_torch.utils import aot

    return torch.export.export(step, aot.beam_arguments(beam),
                               dynamic_shapes=aot.symbolic_particle_beam(beam))


def _aoti_build(exported, name: str) -> str:
    """``exported`` compiled by AOTInductor (``aot.AOTI_CONFIGS``) into the
    package ``<name>.pt2`` of the run's compile cache."""
    import torch._inductor

    from cheetah_tpu_torch.utils import aot

    return torch._inductor.aoti_compile_and_package(
        exported, package_path=str(COMPILE_CACHE / f"{name}.pt2"),
        inductor_configs=aot.AOTI_CONFIGS | {"cpp.cxx": (None, _aoti_compiler())},
    )


def _built_package(futures, name: str):
    """The AOTInductor package of deploy step ``name``, once a compile
    process has built it, loaded; and its build's seconds."""
    import torch._inductor

    seconds = futures[f"aoti_{name}"].result(timeout=COMPILE_TIMEOUT_S)
    return torch._inductor.aoti_load_package(str(COMPILE_CACHE / f"{name}.pt2")), seconds


def _path_phases(ctt, wrappers, cic_kernels, cic_tiled, smi, futures) -> tuple:
    """The path phases, from the env step to the deploy phases, which load
    the packages of ``futures``. Returns the CIC wrappers' launches of the
    space-charge segment, and by grid those of its gradient, the line, the
    sharded gradient and the exported and AOTInductor programs."""
    phase_env_step(ctt, wrappers)
    segment_launches = phase_space_charge(ctt, wrappers)
    phase_env_step_grad(ctt, wrappers)
    grad_launches = {
        grid[0]: phase_sc_grad(ctt, wrappers, grid, cic_kernels.uses_tiled(grid))[0]
        for grid in ((32, 32, 32), (128, 128, 128))
    }
    phase_parameter_beam_env_step(ctt, wrappers)
    phase_env_moments(ctt, wrappers)
    phase_screen_readings(ctt, wrappers)
    phase_grad_screen_centroid(ctt, wrappers)
    phase_nonlinear_chain(ctt, wrappers)
    phase_nonlinear_chain_grad(ctt, wrappers)
    phase_func_transforms(ctt, wrappers, cic_kernels, cic_tiled)
    phase_ares_stage3(ctt, wrappers)
    phase_new_elements(ctt, wrappers)
    line_launches = {
        grid[0]: phase_sc_line(ctt, wrappers, grid, cic_kernels.uses_tiled(grid))
        for grid in ((32, 32, 32), (128, 128, 128))
    }
    # The multi-device slice: a process group of one rank over NCCL, then
    # two ranks over gloo on the same card.
    import shutil
    import tempfile

    from cheetah_tpu_torch import parallel

    store = tempfile.mkdtemp()
    parallel.initialize(f"file://{store}/store", 1, 0)
    phase_batched_env(ctt, parallel, wrappers)
    sharded_launches = {
        grid[0]: phase_sc_sharded(ctt, parallel, wrappers, grid)
        for grid in ((32, 32, 32), (128, 128, 128))
    }
    check(sharded_launches == grad_launches,
          f"the sharded segments launched {sharded_launches}, the unsharded {grad_launches}")
    torch.distributed.destroy_process_group()
    shutil.rmtree(store)
    phase_two_rank()
    # The tenth slice: the imported ARES linac, beam I/O and deployment.
    phase_imported_ares(ctt, wrappers, smi)
    phase_beam_io(ctt, wrappers)
    phase_deploy(ctt, wrappers, futures)
    # The eleventh slice: the space-charge segment exported and loaded (and,
    # since the fourteenth, built by AOTInductor).
    deploy_launches = phase_deploy_space_charge(ctt, wrappers, cic_kernels, cic_tiled,
                                                futures)
    return segment_launches, grad_launches, line_launches, sharded_launches, deploy_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available.", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    _compile_cache()
    import cheetah_tpu_torch as ctt
    from cheetah_tpu_torch.ops import cic_kernels, cic_tiled

    wrappers = _wrappers(cic_kernels, cic_tiled)
    smi = phase_environment()
    phase_build([cic_kernels.LIBRARY, cic_tiled.LIBRARY])
    numbers = phase_kernels(cic_kernels)
    tiled_numbers = phase_kernels_tiled(cic_kernels, cic_tiled)
    emit("deposit_crowded", particles=NUM_PARTICLES, cells=8,
         cases=_crowded_deposit_errors(cic_kernels, cic_tiled,
                                       torch.Generator(device="cuda").manual_seed(SEED + 5)))
    phase_determinism(ctt, cic_kernels, cic_tiled)
    phase_gather_order_sets(cic_kernels, cic_tiled)
    phase_autograd_kernels(cic_kernels, wrappers)
    # The compile processes build the AOTInductor packages and compile the
    # slice paths cold beside the path phases (after the kernels are timed);
    # the deploy phases load the packages, and the compiled phase at the end
    # compiles the paths again from their cache and times them.
    pools, futures = _start_compiles()
    try:
        paths = _path_phases(ctt, wrappers, cic_kernels, cic_tiled, smi, futures)
        # The fourteenth slice: the paths under torch.compile.
        compiled_launches = phase_compiled(pools, futures)
    finally:
        _stop_compiles(pools)
    segment_launches, grad_launches, line_launches, sharded_launches, deploy_launches = paths

    def entry(name, source, replaces, measured, **extra):
        by_path = {"space_charge_segment": segment_launches[name],
                   "sc_grad_32": grad_launches[32][name], "sc_grad_128": grad_launches[128][name],
                   "sc_line_32": line_launches[32][name], "sc_line_128": line_launches[128][name],
                   "sc_sharded_32": sharded_launches[32][name],
                   "sc_sharded_128": sharded_launches[128][name],
                   "deploy_sc_32": deploy_launches[32][name],
                   "deploy_sc_128": deploy_launches[128][name],
                   "aoti_sc_32": deploy_launches["aoti_32"][name],
                   "aoti_sc_128": deploy_launches["aoti_128"][name],
                   **{path: counts[name] for path, counts in compiled_launches.items()}}
        launches = sum(count for path, count in by_path.items()
                       if path != "space_charge_segment")
        check(launches > 0, f"{name} was not launched on its path")
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_by_path": by_path, **measured, **extra,
        }

    untiled, tiled = "cheetah_tpu_torch/csrc/cic.cu", "cheetah_tpu_torch/csrc/cic_tiled.cu"
    kernels = [
        entry("deposit_multi_3d", untiled, "cheetah_tpu/ops/pallas_cic.py:316",
              numbers["deposit"]),
        entry("gather_multi_3d", untiled, "cheetah_tpu/ops/pallas_cic.py:238", numbers["gather"]),
        entry("deposit_multi_tiled_3d", tiled, "cheetah_tpu/ops/pallas_cic_tiled.py:248",
              tiled_numbers["deposit"]),
        entry("gather_multi_tiled_3d", tiled, "cheetah_tpu/ops/pallas_cic_tiled.py:393",
              tiled_numbers["gather"]),
        entry("plan_tiles", tiled, "cheetah_tpu/ops/pallas_cic_tiled.py:108",
              tiled_numbers["plan"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
