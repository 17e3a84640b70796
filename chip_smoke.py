"""Smoke run of the PyTorch / CUDA port (blacklight_tpu_torch) on one
NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no final line):

1. device: the card's name, power limit and maximum SM clock
   (nvidia-smi);
2. build: compile csrc/*.cu with nvcc (one process per source, all at
   once) and hold the size of the formula and simulation kernels' launch
   constants to the host's packing; then, in the main process while phase
   3's jobs run, report registers, spills and the FP64 instructions of
   each kernel instantiation (every formula, simulation and polarized
   one), the static instruction mix of each formula and simulation
   kernel's step loop, of its per-step path and of the sample's part of
   that path (scripts/sass_step_mix.py, on those units built again with
   line tables), and hold the thermal kernels' SASS to
   scripts/thermal_sass.json;
3. checks, each kernel against its plain PyTorch version on identical
   rays, WORKERS processes at once on the one card (the plain versions
   are bound by the host's launches, so they overlap; their times here
   are not comparable with a lone run):
   - formula, 128^2 camera on golden_formula_32.input: dp float32/float64,
     rk4 float64, rk2 float32; and at three frequencies with tangents for
     cn0, r0 and h (h = 0.4, absorption on): rk4 float64, dp float32;
   - simulation, 128^2 camera on golden_sim_rk4_32.input with
     mock_small.athdf: rk4 float64, rk2 float32, dp float32/float64;
     and the phase kernel of phased dispatch (K2.3) on its second phase
     from the carried state of its first (KERNEL_PHASE_STEPS each, as the
     phased route runs them): rk4 float64, rk2 float32;
   - polarized, 64^2 camera on golden_polarized_rk4_32.input with
     mock_small.athdf (ray_step 0.04, 400 steps), camera-frame I, Q, U,
     V: rk4 float64, dp float32, rk2 float32 with image_rotation_split
     and two frequencies; each float32 case also against the plain
     version in float64 on the same rays (truth_gate);
   - the plain polarized version in float64 (on one host core) and in
     float32 (on the card) on 4,096 rays of phase 9's main path, which
     phase 9 holds its float32 route against;
   - the plain simulation version on every ray of phase 7's float32 rk4
     cell, which phase 7 holds its kernel against, and phase 13's second
     phase (steps 1000-1999 of that cell from the phase kernel's carried
     state) through the phase kernel and its plain version, which phase
     13 holds its own run to (bit for bit, then the statistical gate);
   - phase 12's ``python -m blacklight_tpu_torch.fit_demo``;
   - the polarized route's three kernels at phase 9's cell (4,096 of its
     rays, every PLAIN_STRIDE-th in spatial_order), each against its plain
     version on the same inputs: the trace kernel on the rays, the derive
     kernel on the trace kernel's samples, the chain kernel on the derive
     kernel's records;
   - the plain formula version on 4,096 rays (every PLAIN_STRIDE-th) of
     each full-width formula cell (phases 5, 10 and 11), which those
     phases hold their kernel against;
   - the instantiations of many mesh blocks and of the nearest cell, on
     mock_amr.athdf (two refinement levels; exact interblock sampling, or
     the nearest cell of its blocks), 400 steps of 0.04: the simulation
     kernel at 128^2 in rk4 float64 and rk2 float64 at three frequencies
     (exact), dp float32 and float64, rk2 float32; the phase kernel's
     second phase of 200 steps in rk4 float64 and rk2 float32; the
     polarized route at 64^2 in rk4 float64 and rk2 float32; the derive
     kernel against its plain version at phase 14's mb-amr cell (4,096
     rays) in float32 and float64; the plain simulation version on
     4,096 rays of phase 14's cells (MESH_PLAIN: each mode in float32
     and float64), and the plain phase version on 4,096 rays of mb-amr's
     second phase (steps 1000-1999, float32), which phase 14 holds its
     kernels against;
   - phase 15's jobs (AUX_JOBS): the scan route on the CPU on 4,096 of
     its rays, the 128^2 and polarized cases on the card and on the CPU,
     and the two A.5 goldens on the card;
   - phase 17's: the FMKS instantiations on the FMKS torus over
     mock_small.athdf's grid (FMKS_CHECK_GRID), 128^2 against their plain
     versions: the simulation kernel in rk4 float64 trilinear and at the
     nearest cell and the mixture's in rk4 float64 (400 steps of 0.04,
     exact), dp float32 (steps of 0.04, statistical); the phase kernel on
     its second phase of 200 steps (rk4 float64, exact); and the plain
     version on one host core on 4,096 of the card's rays of each of
     phase 17's cells (1,024 polarized, in float32 and in float64), which
     phase 17 holds its kernels against;
   - phase 18's: the CKS instantiations on a small AthenaK cube of the
     same torus (ATHENAK_CHECK_LAYOUT: 22 blocks on two levels), 128^2
     against their plain versions: the simulation kernel in rk4 float64
     with interblock sampling and at the nearest cell and the mixture's
     with interblock sampling (400 steps of 0.04, exact), dp float32
     trilinear (statistical); the CKS phase kernel on its second phase of
     200 steps (rk4 float64 interblock, exact); and the plain version on
     4,096 of the camera's rays of each of phase 18's cells on the card
     and on 1,024 polarized on one host core (in float32 and in float64),
     once the main process has written phase 18's file;
   - phase 19's: the code_kappa phase kernel on its second phase of 200
     steps at 128^2 on mock_small.athdf's snapshot with a kappa slot (rk4
     float64, exact); the plain version on 4,096 of the camera's rays of
     each of phase 19's cells (CK_PLAIN: phase 7's cell in float32 and in
     float64, the mixture, mb-amr, the nearest cell, the FMKS torus on one
     host core each, the AthenaK cube on the card), and the polarized cell
     on 1,024 rays on one host core in float32 and in float64;
   jobs start longest first (PHASE3_SECONDS), the main process running
   MAIN_JOBS itself once its own host work is done (phase 2's report,
   phase 17's and 18's mocks); each job's start, end and seconds are
   printed ("checks_job"), and the "checks" line names the job that
   ended phase 3;
4. the 32^2 formula goldens through pipeline.run(cfg, device="cuda") at
   the tolerances of tests/test_formula_e2e.py;
5. the formula main path at full width: golden_formula_32.input at
   1024^2, dp, float32 through pipeline.run, counting kernel launches;
   then kernel times (rays/s) at 1024^2 in float32 and float64 (float64
   beside its bound), the float32 kernel held to phase 3's plain run on
   its subset, each in the order the pipeline launches it
   (pipeline.formula_launch_order); each
   formula timing (phases 5, 10 and 11) also prints that order, the
   128-ray block efficiency of camera order and of that order, and the
   issue estimate of phase 2's per-step path over this run's ray-steps;
6. the 32^2 simulation goldens through pipeline.run(cfg, device="cuda"),
   reading the .athdf file, at the tolerances of
   tests/test_simulation_e2e.py, and golden_amr_rk4_32 on mock_amr.athdf
   (exact interblock sampling across two refinement levels) at rtol 1e-8
   with its NaN set (tests/test_amr.py:39-52);
7. the simulation main path at full width: a 288 x 128 x 128 (r, theta,
   phi) SKS snapshot (the grid of the EHT GRMHD image library), 1024^2
   camera, rk4, 2000 steps, float32 through pipeline.run, counting kernel
   launches; a torch.profiler trace of one warm run (device idle share,
   kernel time by name); the time of the snapshot's kernel tables and
   guides (kernel_tables, kernel_grid); then kernel times at 1024^2 in
   float32 rk4, float64 rk4 and float32 dp, each beside its bound and the
   issue estimate of phase 2's per-step path, the float32 rk4 kernel held
   to phase 3's plain version on every ray (sim_full_width_plain, on the
   card in the pool);
8. the 32^2 polarized goldens through pipeline.run(cfg, device="cuda"),
   reading the .athdf file, at the tolerances of
   tests/test_polarized_e2e.py;
9. the polarized main path at full width: phase 7's snapshot, 1024^2
   camera, rk4, 2000 steps, float32, one frequency through pipeline.run,
   counting the launches of each of the route's three kernels, with the
   trace chunks, record pieces and peak device memory; a torch.profiler
   trace of the same run (device idle share, kernel time by name); then
   route times at 1024^2 in spatial_order (the order run launches) in
   float32 rk4, float64 rk4 and float32 dp, float32 rk4 also in camera
   order, each stage's time and the glue's, phase 3's plain version in
   float32 rk4 on 4,096 of the same rays (every PLAIN_STRIDE-th; held to
   the route and both to phase 3's float64 run), and a render under
   CHUNK_CHECK's byte caps (several trace chunks and record pieces) that
   must give the same image bit for bit;
10. K1.3 at full width: phase 5's cell at three frequencies (100-400 GHz,
    log-spaced) through pipeline.run, counting launches; the kernel time
    against phase 3's plain subset, and one, three and six frequencies
    (two launches) timed in turns on the same rays;
11. K1.4 at full width: scripts/bench_gradient.py's path at 1024^2 and
    2000 steps: value and gradient of the total flux through the vjp
    renderer (cn0) and the fit renderer (cn0, r0, h; h = 0.4), counting
    launches, best of 3, each gradient against central finite differences
    through the kernel; the tangent kernel's time against phase 3's plain
    subset;
12. the fit: ``python -m blacklight_tpu_torch.fit_demo`` (32^2, 200 Adam
    iterations; run in phase 3's pool) must have printed FIT OK; then 10
    iterations at 1024^2, whose loss must be finite and fall;
13. K2.3, phased dispatch, run right after phase 7 on its snapshot:
    phase 7's configuration through pipeline.run with
    pipeline_simulation.KERNEL_PHASED on, counting phase launches (at
    most 2000 / KERNEL_PHASE_STEPS), whose image must be phase 7's bit for
    bit; the phase kernel held to its plain version on the route's own
    second phase (KERNEL_PHASE_STEPS) at full width (phase 3's run of
    the plain version); the phased route's
    bound (each phase's);
    warp and block efficiencies of each ray order (camera order,
    spatial_order per tile size, each phase's launch order); best of 3 of
    the monolithic kernel in camera order and in spatial_order and of the
    phased render, with each phase's survivors, kernel time and
    compaction time.

14. mesh blocks, run right after phase 13: phase 7's snapshot built in
    memory as Athena++ mesh blocks of 32^3 (athena_blocks, by
    write_athena_amr's rules): mb-uniform, 9 x 4 x 4 blocks at level 0;
    mb-amr, the 16 root blocks of the inner disk each in 8 level-1
    children and the sentinel block (257 blocks, exact interblock
    sampling); and phase 7's single block at the nearest cell. Each cell
    through pipeline.run at 1024^2 (rk4, 2000 steps, float32), counting
    each sampling mode's launches; each kernel alone in spatial_order,
    best of 3 in turns with the single-block kernel, beside its bound
    (the block search and the interblock corners counted in
    OPS_PER_SAMPLE) and held to phase 3's plain version on 4,096 of its
    rays (float32 statistical, float64 exact); on those rays in float64,
    fields without phi structure in 4 phi blocks with interblock sampling
    against the same fields in one block (within MESH_PHI_ATOL of I's
    peak, tests/test_loaders.py:262), and mb-uniform with and without
    interblock sampling against the single block (measured, and in
    float32 on the whole image); K2.3 through pipeline.run with
    KERNEL_PHASED on mb-amr, bit for bit the monolithic image, and its
    phase kernel on the route's second phase (steps 1000-1999) of every
    ray alive, best of 3, beside its bound and held to phase 3's plain
    version on 4,096 of those rays (statistical gate); the polarized
    route once on mb-amr.

15. the auxiliary image planes' scan route (ROADMAP A.5; torch ops on
    the card, no kernel), run after phase 14: phase 7's cell (1024^2, rk4,
    2000 steps, float32) with all nine planes through pipeline.run, after
    a warm call (AUX_WARM_STEPS steps on 4,096 of its rays) that asserts
    the route; no kernel launch counter may move; its I_nu held to phase
    7's kernel image (statistical gate), every plane on every
    PLAIN_STRIDE-th ray to phase 3's run of the route on the CPU on those
    rays (aux_full_width_cpu: the statistical gate per plane, equal NaN
    sets, crossings equal on AUX_CROSSINGS_SHARE of the rays); its wall
    time, steps, time a step and peak device memory beside phase 7's
    kernel time. From phase 3's
    pool: 128^2 float64 rk4 on mock_small.athdf with every plane, the
    route on the card against the kernel route's I_nu (equal flags,
    n_samples and NaN sets, rtol 1e-9) and every plane against the route
    on the CPU (every AUX_EXACT_STRIDE-th ray, rtol 1e-9); the goldens
    golden_formula_aux_32 (tests/test_formula_e2e.py:38-69) and
    golden_sim_tau_rk4_32 (rtol 1e-8) through pipeline.run on the card;
    golden_polarized_rk4_32.input at 64^2 float64 rk4 with image_tau,
    image_emission_ave and image_crossings, the route on the card against
    the route on the CPU (rtol 1e-9 with the per-channel floor, V at
    V_EXACT_RTOL) and its Stokes against the K3.1 route's
    (polarized_gate, exact).

16. the power-law and kappa populations (ROADMAP B.2), run after phase
    9: phase 7's cell with thermal + power-law 0.3 + kappa 0.2 electrons
    (golden_plasma_mix_rk4_32.input's plasma; 1024^2, rk4, 2000 steps,
    float32) through pipeline.run, counting the launches of the mixture's
    kernel (simulation_mixture_kernel), then the mixture kernel and the
    thermal one in spatial_order, best of 3 in turns, the mixture's held to
    phase 3's plain version on every PLAIN_STRIDE-th ray (statistical
    gate) beside its bound (OPS_PER_SAMPLE "simulation_mixture"); the
    phased route of the mixture (KERNEL_PHASED on) bit for bit the
    mixture's image, with its time; the same cell polarized
    (golden_plasma_mix_pol_rk4_32.input) through pipeline.run, counting
    the mixture's derive kernel (polarized_derive_mixture_kernel), the
    route best of 3 in turns with the thermal route, held to phase 3's
    plain version on every PLAIN_STRIDE-th ray (polarized_gate, float32).
    Phase 2 also holds every thermal kernel's SASS to the digests of
    scripts/thermal_sass.json (scripts/sass_digests.py: the kernels as
    built before the mixture existed) and reports the mixture
    instantiations' registers and spills; phase 3 holds the mixture
    kernels to their plain versions at 128^2 (rk4 float64 exact at 400
    steps of 0.04, dp float32 statistical at 2000 of 0.01; the phase kernel
    on its second phase of 200 steps, rk4 float64 exact), and phases 6 and
    8 render the
    plasma goldens golden_plasma_{pow,kap,mix}_rk4_32 and
    golden_plasma_mix_pol_rk4_32 through the kernel route
    (tests/test_simulation_e2e.py:88-114).

17. iharm3d and harm3d snapshots (ROADMAP B.4), run after phase 16:
    FULL_GRID's torus written by write_iharm3d_fmks (FMKS, the writer's
    parameters: hslope 0.3, mks_smooth 0.5, poly_xt 0.82, poly_alpha 14),
    recorded in memory (scripts/mock_iharm3d_datasets.py) and built by
    grid/iharm3d.iharm3d_grid (the writer's and the loader's host times,
    the inverse table's time on the card); write_harm3d's file of
    FULL_GRID, read by load_harm3d. Through pipeline.run at 1024^2 (rk4,
    2000 steps, float32), each with every launch count zeroed just before
    and read just after: fmks-rk4-f32 (simulation_fmks_kernel), its
    mixture (golden_plasma_mix_rk4_32.input's electrons,
    simulation_mixture_kernel in SAMPLE_FMKS), the polarized route
    (polarized_derive_fmks_kernel) and harm3d-rk4-f32 (the file read by
    the run; simulation_kernel, SAMPLE_SINGLE); the phased route
    (KERNEL_PHASED) bit for bit the FMKS image. Then each kernel alone in
    spatial_order, best of 3 in turns with phase 7's SKS single block,
    beside its bound and held to phase 3's plain version on its subset
    (statistical gate); the FMKS phase kernel on the route's second phase;
    the polarized route in turns with phase 9's, with each stage's time,
    held as phase 9's is (within TRUTH_FACTOR of the float32 plain
    version's error to the float64 one, truth_gate, with equal NaN sets)
    and its float64 run on the same 1,024 rays exact (polarized_gate).
    The script's host work for phase 17 (the FMKS datasets, the harm3d
    file) runs in the main process while phase 3's jobs run.

18. AthenaK snapshots in Cartesian Kerr-Schild coordinates (ROADMAP B.4),
    run after phase 17: FULL_GRID's torus on write_athenak's cube
    (half-width r_max / sqrt(2), spin 0) as a root grid of 8^3 blocks of
    32^3 cells with the central 2 x 2 x 2 refined once (568 blocks, 18.6 M
    cells, ~600 MB), written by scripts/mock_athenak.py to a file under
    build/ while phase 3 runs and read by the port's load_athenak (the
    writer's, the loader's and the neighbour table's times). Through
    pipeline.run at 1024^2 (rk4, 2000 steps, float32; off-grid samples
    take fallback values), each with every launch count zeroed just
    before and read just after: athenak-amr-rk4-f32 (exact interblock
    sampling, simulation_mode_kernel in SAMPLE_CKS_INTERBLOCK),
    athenak-rk4-f32 (trilinear clamped to the block, SAMPLE_CKS_BLOCKS),
    athenak-mix-rk4-f32 (golden_plasma_mix_rk4_32.input's electrons,
    simulation_mixture_kernel in SAMPLE_CKS_BLOCKS) and the polarized route
    (polarized_derive_mode_kernel in a CKS mode); the phased route
    (KERNEL_PHASED) bit for bit the first cell's image. Then each kernel
    alone in spatial_order, best of 3 in turns with phase 14's mb-amr,
    beside its bound and held to
    phase 3's plain version on its subset (statistical gate); the CKS phase
    kernel on the route's second phase; the polarized route in turns with
    phase 14's polarized route on mb-amr, with each stage's time, held as
    phase 9's is (truth_gate, equal NaN sets) and its float64 run on the
    same 1,024 rays exact (polarized_gate).

19. plasma_model = code_kappa (ROADMAP B.2), run after phase 18: the
    electron temperature from a ninth sampled primitive, the electron
    entropy kappa = KAPPA_SCALE * pgas / rho^gamma_adi of each snapshot's
    own rho and pgas (scripts/mock_athenak.py with_kappa), on the mixture's
    instantiations (the thermal ones keep their SASS, phase 2). Phase 7's
    cell (1024^2, rk4, 2000 steps, float32) through pipeline.run, counting
    the code_kappa launches of each mode (CODE_KAPPA_MODE_LAUNCHES); the
    kernel in spatial_order, best of 3 in turns with phase 7's thermal
    kernel, beside its bound, held to phase 3's plain version on every
    PLAIN_STRIDE-th ray (statistical gate) and in float64 on those rays to
    the plain version in float64 (exact); the phased route bit for bit
    its image, the phase kernel's second phase timed; the polarized route
    through pipeline.run and in turns with phase 9's, with each stage's
    time, held as phase 9's is (truth_gate, equal NaN sets); then the
    kernel on the PLAIN_STRIDE-th rays of each other cell (the mixture,
    mb-amr's interblock sampling, the nearest cell, the FMKS torus and the
    AthenaK cube with interblock sampling) held to its plain version there.

20. adaptive image-plane refinement (ROADMAP A.9), run after phase 19:
    golden_adaptive_32 through pipeline.run(cfg, device="cuda") on
    write_athena's mock built in memory (golden_adaptive_snapshot), float64
    rk4, at tests/test_reference_goldens.py:21-49's gates (equal levels,
    block counts and refined locations, rtol 1e-8); then phase 7's
    sim-rk4-f32 cell (two levels), phase 5's formula-dp-f32 and phase 9's
    pol-rk4-f32 (one level) at a 1024^2 root on phase 7's snapshot, blocks
    of ADAPTIVE_BLOCK refined by golden_adaptive_32's criteria and a forced
    region over the centre: pipeline.run without refinement (warm), then
    with it, counting launches, each level's blocks, rays and render time;
    every level must refine some but not all of its candidate blocks and
    equal, bit for bit, the same kernel's render of the same pixels' rays
    from the finer camera (pixel_grid(1024 * 2**level)) launched in that
    camera's row-major order (adaptive_level_gate). It adds no plain-version
    job: the kernels are held to their plain versions in phase 3.

21. false-color rendering (ROADMAP D.1), run after phase 20, on the scan
    route (transfer/unpolarized.integrate_unpolarized with
    transfer/rendering.Renderer; ops/geodesic.trace_compacted drops
    finished rays and replays each bundle's step from a CUDA graph):
    golden_render_rk4_32 (float64 rk4, rtol 1e-8 over 1e-10 of the peak)
    and golden_render_32 (dp, mean error < 5e-3 and max < 2e-1 of the peak;
    tests/test_render_truecolor.py:16-34) through pipeline.run(cfg,
    device="cuda") on mock_small.athdf, in phase 3's pool (RENDER_JOBS);
    then phase 7's cell (1024^2, float32 rk4, 2000 steps) with
    golden_render_rk4_32's three features (fill rho, fill sigma, thresh
    beta_inverse = 0.15) through pipeline.run, timed, counting every kernel
    launch (none may launch) and the lock steps, held channel by channel
    to phase 3's run of the route on the CPU on every PLAIN_STRIDE-th ray
    (plane_gate: bench.py:181-186's statistical gate, which takes the
    pixels where a thresh crossing flips in float32) and its light image
    to phase 7's kernel image (statistical gate).

Phases 4 to 21 run alone on the card, after phase 3.

``python3 chip_smoke.py --chunk-sweep`` runs phases 1 and 2, then times
the polarized route at 1024^2 (float32 rk4, spatial_order) for trace
chunks of 2 to 14 GiB of samples (CHUNK_SWEEP) and at the route's own
caps, each image bit for bit the first's: how polarized_kernel's
SAMPLE_SHARE was chosen.

Each kernel's bound is the least time the card could take for the same
work: the larger of its bytes (each input read once, each output written
once) over the memory rate and its floating-point operations over the
peak rate of its type. The operations are this run's mean samples per ray
times hand counts per step and per sample (OPS_PER_STEP, OPS_PER_SAMPLE,
and per further frequency and tangent FORMULA_OPS_PER_FREQUENCY,
FORMULA_OPS_PER_TANGENT). A formula kernel's entry also carries a static
issue estimate (issue_estimate_ms): the instructions of its step loop's
per-step path times this run's ray-steps over the card's issue rate. It
is not a bound: a step may skip some of those instructions (branches not
taken) and run others more often (the code of a rejected dp step, of a
ray's start and end, which it leaves out). The polarized route's entry also carries each
of its three kernels with its own bound: the bytes of its own inputs and
outputs (samples, records) against its share of the operations.

Every line but the last two is a JSON object with the measurements and
its seconds since the script started ("at_s") (the
kernels line lists formula K1.1/K1.2, K1.3, K1.4, simulation, phased
simulation and polarized, then the instantiations of many blocks: the
simulation kernel on mb-uniform, mb-amr and at the nearest cell, the
phase kernel and the derive kernel of interblock sampling, then the
mixture's: the simulation kernel, the phase kernel and the polarized
route's derive kernel, then phase 17's: the FMKS simulation kernel, the
mixture's on FMKS, the single-block kernel on the harm3d grid, the FMKS
phase kernel and the polarized route with the FMKS derive kernel, then
phase 18's: the CKS simulation kernel with interblock sampling and
trilinear, the mixture's on the CKS grid, the CKS phase kernel and the
polarized route with the CKS derive kernel, then phase 19's: the
code_kappa simulation kernel, its phase kernel, the polarized route with
its derive kernel, and the code_kappa kernel of the mixture, of
interblock sampling, of the nearest cell, of FMKS and of a CKS grid);
then
come the card's name and power limit, and
the last line is {"ok": true, "device": {...}}. The script prints its
total time on the line before the kernels line.
"""

from __future__ import annotations

import argparse
import gc
import json
import multiprocessing
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures"
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]
KERNEL_SOURCE = "blacklight_tpu_torch/csrc/formula_kernel.cuh"
KERNEL_REPLACES = "blacklight_tpu/ops/pallas_formula.py:192"
MULTI_REPLACES = ("blacklight_tpu/ops/pallas_formula.py:192 (_make_kernel "
                  "with len(nus) > 1, K1.3)")
TANGENT_REPLACES = ("blacklight_tpu/ops/pallas_formula.py:192 (_make_kernel "
                    "with diff_params, K1.4)")
SIM_KERNEL_SOURCE = "blacklight_tpu_torch/csrc/simulation_kernel.cuh"
SIM_KERNEL_REPLACES = "blacklight_tpu/ops/pallas_simulation.py:795"
PHASE_REPLACES = ("blacklight_tpu/ops/pallas_simulation.py:795 (_make_kernel "
                  "with carry_io=True, K2.3; launched at :1552)")
POL_KERNEL_SOURCE = "blacklight_tpu_torch/csrc/polarized_kernel.cuh"
POL_KERNEL_REPLACES = "blacklight_tpu/ops/pallas_polarized.py:286"
# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s and
# floating-point operations/s outside the tensor cores, and the H100's
# SMs and registers per SM (the chain kernel's fill figure).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
N_SMS = 132
REGISTERS_PER_SM = 65536
# An SM's four schedulers each issue one warp instruction (32 lanes) a
# cycle: the issue estimate of a kernel is its instructions per ray-step
# (the static count of its step loop's per-step path, phase 2) times this
# run's ray-steps over N_SMS * ISSUE_LANES_PER_SM lanes at the card's
# maximum SM clock (phase 1).
ISSUE_LANES_PER_SM = 4 * 32
# Phase 2's static instruction mixes of each formula kernel's step loop
# and its per-step path, by kernel label (scripts/sass_step_mix.py
# loop_mixes), and phase 1's maximum SM clock in Hz.
STEP_LOOPS = {}
SM_CLOCK_HZ = {}
# Floating-point operations, counted by hand from the CUDA sources (an
# add, multiply, divide, square root, compare-and-select or transcendental
# is one; about +-30 %): per geodesic step of each integrator (dp: per
# attempt), and per stored sample of each kernel at one frequency. The
# polarized sample counts its fluid state, three transport matrices and
# the tetrad once and POL_OPS_PER_FREQUENCY per frequency, of which the
# chain kernel's share is POL_CHAIN_OPS_PER_FREQUENCY (two 16-component
# transports ~450, N -> Stokes ~140, the coupling ~200, Stokes -> N
# ~110) and the rest (the coefficients) the derive kernel's; one step
# per sample. The simulation sample on many blocks (csrc/sim_sample.cuh
# sample_blocks; compares and integer operations counted as operations):
# the previous block's box (6) and the scan of the block list when a ray
# leaves it (~6 a block, n_b / 2 blocks once a block's ~32 samples: ~20
# a sample); exact interblock sampling adds the ghost fractions (~12) and
# a cell index through the neighbour table for each of its 8 corners
# (~65 each: the crossing and half of each axis, the entry, the case's
# cell index and nudge per axis, the flat index) in place of ~3. The
# nearest cell of one block (sample_block with the nearest flag): the
# block's box (6) and none of the trilinear sample's 170: the weights
# (3 subtractions, 16 products), the 8 x 8 blend (a product and a sum
# each, less the first corner's sums: 120), the repair (2), the float32
# rounding (8), the fractions (3 x 3) and the anchors' selects and
# clamps (3 x 4).
# The mixture of populations (csrc/sim_sample.cuh mixture_i) adds at a
# sample and frequency to the thermal j and alpha the power law's (the
# ratio, its two powers and ten products: ~17) and the kappa
# population's (nu_kappa and xx, the cube root and two powers, the
# bracket terms: ~36; two bridges of ~12: a min, a max, two compares, two
# selects, a division, two powers, a sum and a product), and the shared
# (nu0 / nu)^2 and sums (~5): ~80; polarized (csrc/polarized_kernel.cuh
# mixture_polarized), per frequency, the power law's eight coefficients
# (~60) and the kappa population's six bridges (~72), eight sin and xx
# powers (~16), rotativities of two brackets (~70) and the rest (~40):
# ~260 more than the thermal POL_OPS_PER_FREQUENCY.
# The FMKS map (csrc/sim_sample.cuh sample_fmks) adds at a sample the SKS
# domain test (6), the table coordinates (2 subtractions or divisions
# each, a floor, 2 compares and a clamp: ~10), the weights (2 subtractions
# and 4 clamps) and the bilinear lookup (9 products, 5 sums, 3
# subtractions): ~40, in front of the single block's sample.
# A CKS grid (csrc/sim_sample.cuh SAMPLE_CKS_*, AthenaK) drops the SKS
# sample's CKS -> SKS (acos, atan2, atan, the wrap: ~15), its SKS fluid
# state's metric, frame and field (~95) and the Jacobian to CKS (~48) for
# the CKS fluid state (fluid_state_cks: f and l ~17, the metric's 13
# products and sums, g u u ~20, the lapse, shift and u ~16, u_mu and
# b_mu 56, b^0, b^i and b^2 ~21: ~146): 12 fewer. Its point location is
# counted as the SKS blocks' is (~20 a sample): the linear scan over
# phase 18's 568 blocks costs the kernels more (~53 a sample, and the
# polarized derive kernel, which keeps no block from a previous sample,
# ~2,000), but that is the kernels' own overhead, not work the function
# needs, so no bound counts it. The polarized CKS sample counts the
# block's box (6) in place of the SKS sample's 12.
# The code_kappa sample (phase 19) is the thermal one of its mode with the
# code_kappa temperature in place of ti_te_beta's (~15): rho_e and its
# product with kappa (3), the cube root (~20), theta_e (6) and kb_tt_e
# (2), ~+20, and its mixture's the mixture's +20; the polarized sample
# the thermal one's +20 (POL_MIX_OPS_PER_FREQUENCY only where the cell
# mixes in power-law or kappa electrons).
OPS_PER_STEP = {"rk4": 830, "rk2": 500, "dp": 2020}
OPS_PER_SAMPLE = {"formula": 130, "simulation": 495, "polarized": 2740,
                  "simulation_blocks": 520, "simulation_interblock": 1030,
                  "simulation_nearest": 331, "simulation_mixture": 575,
                  "polarized_mixture": 2740, "simulation_fmks": 535,
                  "simulation_mixture_fmks": 615, "polarized_fmks": 2780,
                  "simulation_cks": 508, "simulation_cks_interblock": 1018,
                  "simulation_mixture_cks": 588, "polarized_cks": 2734,
                  "simulation_code_kappa": 515,
                  "simulation_code_kappa_mixture": 595,
                  "simulation_code_kappa_interblock": 1050,
                  "simulation_code_kappa_nearest": 351,
                  "simulation_code_kappa_fmks": 555,
                  "simulation_code_kappa_cks_interblock": 1038,
                  "polarized_code_kappa": 2760}
POL_OPS_PER_FREQUENCY = 1090
POL_MIX_OPS_PER_FREQUENCY = 260
POL_CHAIN_OPS_PER_FREQUENCY = 900
# The formula sample beyond its first frequency (csrc/formula_kernel.cuh):
# each further frequency's power laws and selects (formula_jalpha, ~21)
# and its transfer update (~29); each tangent per frequency: dj, dalpha,
# ddt (3), dss (3), dcontrib (6), datten (4), the dI and dtau updates (6),
# and its share of the frequency's 1/alpha and exp(-dtau) (4) and of the
# sample's weights w_r0, w_h (7).
FORMULA_OPS_PER_FREQUENCY = 50
FORMULA_OPS_PER_TANGENT = 25
# V's gate for the kernel against its plain version in float64 rk4/rk2
# (polarized_gate).
V_EXACT_RTOL = 5e-5
# truth_gate (tests/test_pallas_polarized.py:99-119): the float32 kernel's
# error against the float64 plain version stays within this factor of the
# float32 plain version's, plus about one float32 ulp of I's peak.
TRUTH_FACTOR = 3.0
TRUTH_SLACK = 1e-7
# Processes that run phase 3's checks at once: each plain version spends
# its time launching small kernels from one host core, so several overlap
# on one card (an H100 host has 8 cores; 8 processes ran every job 25-40 %
# slower than 7).
WORKERS = 7
# Phase 9: the plain version runs on every PLAIN_STRIDE-th ray of the
# 1024^2 bundle, and a render with CHUNK_CHECK's byte caps (trace chunks of
# 2 GiB of samples: 28 at 2000 steps of float32; records of 6 GiB: about
# two pieces a chunk) must reproduce the image bit for bit.
# --chunk-sweep: the trace byte caps it times.
PLAIN_STRIDE = 256
CHUNK_CHECK = (2 << 30, 6 << 30)
CHUNK_SWEEP = (2 << 30, 4 << 30, 7 << 30, 14 << 30)
# K1.3 and K1.4 cells: three frequencies log-spaced over 100-400 GHz (the
# ones tests/test_pallas_kernel.py:78-82 uses); tangents for cn0, r0 and h
# with h = 0.4 (h = 0 zeroes the h tangent, tests/test_gradients.py:133).
# Phase 3's tangent checks also turn absorption on (formula_a = 1e5:
# optical depths of order one), so that every branch of the tangent update
# runs; the golden input has formula_a = 0.
MULTI_FREQUENCIES = dict(image_num_frequencies=3, image_frequency_start=1e11,
                         image_frequency_end=4e11,
                         image_frequency_spacing="log")
FIT_PARAMS = ("cn0", "r0", "h")
FIT_H = 0.4
CHECK_A = 1e5
# K1.4's cell: scripts/bench_gradient.py's path (cn0, float32, the vjp
# kernel) at 1024^2 and 2000 steps; finite differences at its step 1e-3 of
# the value and the JAX tests' tolerances (tests/test_gradients.py:108,
# :156-157)
GRAD_STEPS = 2000
FD_STEP = 1e-3
FD_RTOL = {"vjp": 1e-3, "fit": 5e-3}
STOKES = ("I_nu", "Q_nu", "U_nu", "V_nu")
# the full-width snapshot: the EHT GRMHD image library's grid (EHT M87*
# Paper V) over mock_small.athdf's radii, as scripts/bench_simulation.py
# builds its mock
FULL_GRID = dict(n_r=288, n_th=128, n_ph=128, r_min=1.916, r_max=52.2,
                 pert_amp=0.1)


# The script's start: each line carries its seconds since then ("at_s")
STARTED = time.perf_counter()
STARTED_EPOCH = time.time()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - STARTED}), flush=True)


def smi(query) -> str:
    return subprocess.run(query, capture_output=True, text=True,
                          check=True).stdout.strip()


def rel_error(a, b):
    """|a - b| relative to |b| plus a floor of 1e-6 of the image maximum
    (bench.py:177-178), NaN where either is NaN."""
    import numpy as np
    return np.abs(a - b) / (np.abs(b) + np.nanmax(np.abs(b)) * 1e-6)


def statistical_gate(a, b) -> dict:
    """bench.py:181-186: identical NaN sets, fewer than 0.5% of pixels
    past 1e-3 relative, total flux within 1e-3."""
    import numpy as np
    rel = rel_error(a, b)
    frac = float(np.mean(np.nan_to_num(rel) > 1e-3))
    flux = float(abs(np.nansum(a) - np.nansum(b)) / abs(np.nansum(b)))
    same_nan = bool(np.array_equal(np.isnan(a), np.isnan(b)))
    return {"same_nan": same_nan, "frac_past_1e-3": frac, "flux_rel": flux,
            "max_rel": float(np.nanmax(rel)), "mean_rel": float(np.nanmean(rel)),
            "ok": same_nan and frac < 5e-3 and flux < 1e-3}


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "run needs an NVIDIA GPU")
    if not (ROOT / "blacklight_tpu_torch").is_dir():
        raise RuntimeError(f"{ROOT} holds no blacklight_tpu_torch package")
    sys.path.insert(0, str(ROOT))
    card = smi(SMI_QUERY)
    print(card, flush=True)
    clock = smi(["nvidia-smi", "--query-gpu=clocks.max.sm",
                 "--format=csv,noheader,nounits"])
    SM_CLOCK_HZ["max"] = float(clock) * 1e6
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         max_sm_clock_mhz=float(clock))
    return card


def _ptxas_table(report: str) -> dict:
    """Registers, stack and spills per kernel from nvcc -Xptxas -v."""
    table, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)'?", line)
        if m:
            name = _kernel_label(m.group(1))
            table.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            table[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            table[name]["registers"] = int(m.group(1))
    return {k: v for k, v in table.items() if v}


SAMPLE_MODE_NAMES = ("single block", "blocks", "interblock", "fmks",
                     "cks blocks", "cks interblock")


def _kernel_label(mangled: str) -> str:
    m = re.search(r"(simulation|simulation_phase)_fmks_kernelI([fd])Li(\d)E"
                  r"Li(\d+)E", mangled)
    if m:
        kind, tp, integrator, nf = m.groups()
        return (f"{kind}_fmks_kernel<{'float' if tp == 'f' else 'double'}, "
                f"{('dp', 'rk4', 'rk2')[int(integrator)]}, NF={nf}>")
    m = re.search(r"polarized_derive_fmks_kernelI([fd])Lb([01])E", mangled)
    if m:
        tp, geometry = m.groups()
        args = ["float" if tp == "f" else "double"]
        if geometry == "0":
            args.append("coefficients only")
        return f"polarized_derive_fmks_kernel<{', '.join(args)}>"
    m = re.search(r"(simulation|simulation_phase)_mixture_kernelI([fd])"
                  r"Li(\d)ELi(\d+)ELi(\d)E", mangled)
    if m:
        kind, tp, integrator, nf, mode = m.groups()
        return (f"{kind}_mixture_kernel<{'float' if tp == 'f' else 'double'}"
                f", {('dp', 'rk4', 'rk2')[int(integrator)]}, NF={nf}, "
                f"{SAMPLE_MODE_NAMES[int(mode)]}>")
    m = re.search(r"polarized_derive_mixture_kernelI([fd])Lb([01])ELi(\d)E",
                  mangled)
    if m:
        tp, geometry, mode = m.groups()
        args = ["float" if tp == "f" else "double"]
        if geometry == "0":
            args.append("coefficients only")
        args.append(SAMPLE_MODE_NAMES[int(mode)])
        return f"polarized_derive_mixture_kernel<{', '.join(args)}>"
    m = re.search(r"(simulation|simulation_phase)_mode_kernelI([fd])Li(\d)E"
                  r"Li(\d+)ELi(\d)E", mangled)
    if m:
        kind, tp, integrator, nf, mode = m.groups()
        return (f"{kind}_mode_kernel<{'float' if tp == 'f' else 'double'}, "
                f"{('dp', 'rk4', 'rk2')[int(integrator)]}, NF={nf}, "
                f"{SAMPLE_MODE_NAMES[int(mode)]}>")
    m = re.search(r"polarized_derive_mode_kernelI([fd])Lb([01])ELi(\d)E",
                  mangled)
    if m:
        tp, geometry, mode = m.groups()
        args = ["float" if tp == "f" else "double"]
        if geometry == "0":
            args.append("coefficients only")
        args.append(SAMPLE_MODE_NAMES[int(mode)])
        return f"polarized_derive_mode_kernel<{', '.join(args)}>"
    m = re.search(r"polarized_(trace|derive|chain)_kernelI([fd])"
                  r"(?:Li(\d+)E|Lb([01])E)", mangled)
    if m:
        stage, tp, value, geometry = m.groups()
        args = ["float" if tp == "f" else "double"]
        if stage == "trace":
            args.append(("dp", "rk4", "rk2")[int(value)])
        elif stage == "chain":
            args.append(f"NF={value}")
        elif geometry == "0":
            args.append("coefficients only")
        return f"polarized_{stage}_kernel<{', '.join(args)}>"
    m = re.search(r"(formula|simulation|simulation_phase|polarized)_kernelI"
                  r"([fd])Li(\d)E"
                  r"(?:Li(\d+)E)?(?:Lb([01])E)?", mangled)
    if not m:
        return mangled
    kind, tp, integrator, nf, tangents = m.groups()
    args = ["float" if tp == "f" else "double", ("dp", "rk4", "rk2")[int(integrator)]]
    if nf:
        args.append(f"NF={nf}")
    if tangents == "1":
        args.append("tangents")
    return f"{kind}_kernel<{', '.join(args)}>"


def _sass(lib_path):
    """cuobjdump -sass of the library, or None without cuobjdump."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(cuobjdump).exists():
        return None
    return smi([cuobjdump, "-sass", str(lib_path)])


def _step_loops() -> dict:
    """The instruction mixes of each formula and simulation kernel's step
    loop, its per-step path and the sample's part of it
    (scripts/sass_step_mix.py, those units built with line tables, all at
    once), by kernel label."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "sass_step_mix", ROOT / "scripts" / "sass_step_mix.py")
    mix = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mix)
    csrc = (ROOT / KERNEL_SOURCE).parent
    units = sorted(p.name for pattern in ("formula_kernel*.cu",
                                          "simulation_*.cu")
                   for p in csrc.glob(pattern)
                   if not any(kind in p.name for kind in ("blocks", "mixture",
                                                          "fmks", "cks")))
    per_ray, per_sample = mix.per_ray_lines(ROOT), mix.per_sample_lines(ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        sass = mix.disassemble(ROOT, units, pathlib.Path(tmp))
    return {_kernel_label(name): mix.loop_mixes(code, per_ray, per_sample)
            for unit in sass.values() for name, code in unit.items()
            if "formula_kernel" in name or "simulation" in name}


def _sass_fp64(sass) -> dict:
    """FP64 instructions per kernel in the compiled SASS: arithmetic
    (DADD, DMUL, DFMA) and everything else that touches FP64 (compares,
    min/max, conversions)."""
    if sass is None:
        return {"not_measured": "cuobjdump not found"}
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _kernel_label(m.group(1))
            counts[name] = {"arith": 0, "other": 0}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                      line)
        if name is None or not m:
            continue
        op = m.group(1)
        if op.split(".")[0] in ("DADD", "DMUL", "DFMA"):
            counts[name]["arith"] += 1
        elif op.startswith("D") or "F64" in op:
            counts[name]["other"] += 1
    return counts


def phase_build():
    """Phase 2's build: the library from the checkout's sources, loaded
    with each C interface's checks, and the launch constants' sizes held
    to the host's packing. Returns the library's path for
    phase_build_report."""
    from blacklight_tpu_torch.ops import _build
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    t0 = time.perf_counter()
    path = _build.build()
    build_s = time.perf_counter() - t0
    fk._library()
    sk._phase_library()
    pk._library()
    emit("build", seconds=build_s, library=path.name, units=len(
        _build.sources()),
         formula_consts_bytes={f"{str(k[0])[6:]}, NF={k[1]}": v for k, v in
                               fk.consts_sizes(fk._library()).items()},
         simulation_consts_bytes={f"{str(k[0])[6:]}, NF={k[1]}": v for k, v
                                  in sk.consts_sizes(sk._library()).items()},
         simulation_mixture_consts_bytes={
             f"{str(k[0])[6:]}, NF={k[1]}": v for k, v in
             sk.consts_sizes(sk._library(), mixture=True).items()})
    if fk.consts_sizes(fk._library()) != fk.host_consts_sizes():
        raise RuntimeError("FormulaLaunchConsts and launch_consts disagree")
    for mixture in (False, True):
        if sk.consts_sizes(sk._library(), mixture) \
                != sk.host_consts_sizes(mixture):
            raise RuntimeError("SimLaunchConsts (SimMixLaunchConsts) and "
                               "launch_consts disagree")
    return path


def phase_build_report(path):
    """Phase 2's report of the library at ``path``: registers, spills and
    FP64 instructions of each kernel, the step loops' instruction mixes
    (which later phases' issue estimates read) and the thermal kernels'
    SASS held to scripts/thermal_sass.json. The main process makes it
    while phase 3's jobs run: it needs no card, and its disassembly and
    line-table builds would otherwise hold the card idle."""
    from blacklight_tpu_torch.ops import _build
    t0 = time.perf_counter()
    sass = _sass(path)
    STEP_LOOPS.update(_step_loops())
    ptxas = _ptxas_table(_build.ptxas_report())
    thermal_sass = _thermal_sass(sass)
    emit("build_report", seconds=time.perf_counter() - t0, ptxas=ptxas,
         fp64_sass=_sass_fp64(sass),
         simulation_registers={k: v for k, v in ptxas.items()
                               if k.startswith("simulation")},
         step_loops=STEP_LOOPS)
    emit("mixture_registers", ptxas={k: v for k, v in ptxas.items()
                                     if "mixture" in k})
    emit("fmks_registers", ptxas={k: v for k, v in ptxas.items()
                                  if "fmks" in k})
    emit("cks_registers", ptxas={k: v for k, v in ptxas.items()
                                 if ", cks " in k})
    emit("thermal_sass", **thermal_sass)
    if not thermal_sass["ok"]:
        raise RuntimeError(f"a thermal kernel's SASS changed: {thermal_sass}")


def _thermal_sass(sass) -> dict:
    """Every kernel of scripts/thermal_sass.json (the kernels as built
    before the mixture of populations existed) against this build's SASS
    (scripts/sass_digests.py), instruction for instruction; the kernels
    whose SASS varies between builds of the same sources (UNSTABLE: the
    polarized chain kernels) are reported, not held. Not ok where another
    kernel differs or is missing under the nvcc that built the reference;
    under another nvcc the comparison is reported and not held."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "sass_digests", ROOT / "scripts" / "sass_digests.py")
    digests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(digests)
    reference = json.loads(digests.REFERENCE.read_text())
    if sass is None:
        return {"ok": False, "not_measured": "cuobjdump not found"}
    nvcc = digests.nvcc_version()
    result = digests.compare(digests.digests(sass), reference["kernels"])
    comparable = nvcc == reference["nvcc"]
    return {"nvcc": nvcc, "reference_nvcc": reference["nvcc"],
            "reference_kernels": len(reference["kernels"]),
            "comparable": comparable, **result,
            "ok": not comparable or not (result["different"]
                                          or result["missing"])}


def _config(name, **overrides):
    from blacklight_tpu_torch import RayIntegrator, read_config
    from blacklight_tpu_torch.constants import FrequencySpacing
    cfg = read_config(str(FIXTURES / name))
    for key, value in overrides.items():
        if key == "ray_integrator":
            value = RayIntegrator(value)
        elif key == "image_frequency_spacing":
            value = FrequencySpacing(value)
        setattr(cfg, key, value)
    return cfg


def _renderer(cfg):
    """The arguments and keywords of render_formula (the kernel on the
    card, or the plain version) on the camera's rays, in camera order."""
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.models import formula as formula_model
    render_fn, geom, rays, freqs, mass_msun = pipeline.make_formula_renderer(
        cfg, device="cuda")
    fp = formula_model.formula_params_from_config(cfg)
    args = (rays.positions, rays.directions, rays.momentum_factors,
            freqs.tolist(), render_fn.geodesic_params, fp, mass_msun,
            geom.cam_x.tolist(), formula_model.formula_log_j_scale(fp))
    kwargs = dict(fallback_nan=cfg.require("fallback_nan"),
                  integrator=cfg.require("ray_integrator").value)
    return args, kwargs


def _fit_values(fp) -> dict:
    """The fitted parameters' values in ``fp``, for diff_values."""
    return {p: getattr(fp, p) for p in FIT_PARAMS}


def _outputs(out) -> list:
    """I_nu and every dI/dp of a render_formula output, (B, F) each."""
    return [out[0], *out[3]] if len(out) == 4 else [out[0]]


def signed_gate(a, b) -> dict:
    """statistical_gate, with a signed tangent's flux held to 1e-3 of the
    sum of |b| (the same as bench.py's for a positive image; an all-zero
    plane must then match exactly)."""
    import numpy as np
    scale = float(np.nansum(np.abs(b)))
    gap = float(abs(np.nansum(a) - np.nansum(b)))
    if not scale:
        same_nan = bool(np.array_equal(np.isnan(a), np.isnan(b)))
        return {"same_nan": same_nan, "all_zero": True, "flux_gap": gap,
                "ok": same_nan and not gap}
    gate = statistical_gate(a, b)
    gate["flux_rel"] = gap / scale if scale else gap
    gate["ok"] = (gate["same_nan"] and gate["frac_past_1e-3"] < 5e-3
                  and gap <= 1e-3 * scale)
    return gate


def gate_outputs(ours, ref, exact_rtol=None) -> dict:
    """Every output (I_nu, then each dI/dp) and frequency of a kernel run
    against the plain version's: the statistical gate (signed_gate), or
    with exact_rtol identical NaN sets and values within that rtol.
    Arrays are (B, F) numpy."""
    import numpy as np
    names = ["I_nu", *(f"dI_d{p}" for p in FIT_PARAMS)][:len(ours)]
    result, ok, err = {}, True, 0.0
    for name, a, b in zip(names, ours, ref):
        for f in range(b.shape[1]):
            x, y = a[:, f], b[:, f]
            both = np.isfinite(x) & np.isfinite(y)
            if both.any():
                err = max(err, float(np.max(np.abs(x[both] - y[both]))))
            if exact_rtol is None:
                gate = signed_gate(x, y)
            else:
                with np.errstate(divide="ignore", invalid="ignore"):
                    rel = np.abs(x - y) / np.abs(y)
                gate = {"same_nan": bool(np.array_equal(np.isnan(x),
                                                        np.isnan(y))),
                        "max_rel": float(np.nanmax(np.where(x == y, 0.0,
                                                            rel)))}
                gate["ok"] = bool(gate["same_nan"] and np.allclose(
                    x, y, rtol=exact_rtol, atol=0.0, equal_nan=True))
            ok = ok and gate["ok"]
            result[f"{name}_{f}"] = {k: v for k, v in gate.items()
                                     if k != "ok"}
    result.update(max_abs_err=err, ok=bool(ok))
    return result


def _timed(fn, *args, **kwargs):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_checks(pool, prep=None) -> tuple:
    """Phase 3 on ``pool``: every check at once, longest first; emits each
    result in that order and raises at the first that failed. ``prep``, if
    given, is called once every job is queued, so that the main process's
    own host work overlaps the jobs, and its result is returned last.
    Returns
    phase 9's float64 reference (positions, Stokes) with its float32 plain
    version (pol_full_width_plain's result), the plain formula
    version on the subsets of the full-width formula cells, by cell, the
    polarized route's per-kernel checks, and phase 14's: the phase and
    derive kernels of many blocks against their plain versions, the plain
    version on the subset of each full-width mesh cell (mesh_plain_subset,
    by cell and precision, under "plain") and the plain phase version on
    mb-amr's second phase (mesh_phase_plain_subset, "phase_plain"); and
    phase 15's jobs (AUX_JOBS) by name; and phase 16's: the mixture's
    phase kernel against its plain version ("phase"), the plain version
    on its cells' subsets ("plain", "pol_plain"); and phase 17's, alike,
    with the float64 polarized subset ("pol_truth"), and phase 18's, alike.
    Jobs start longest first (PHASE3_SECONDS)."""
    t0 = time.perf_counter()
    jobs = {("check", fn.__name__, args): (fn, args) for fn, args in CHECKS}
    jobs.update({("mesh_phase", "check_mesh_phase", args):
                 (check_mesh_phase, args) for args in MESH_PHASE_CHECKS})
    jobs.update({("subset", "formula_plain_subset", (cell,)):
                 (formula_plain_subset, (cell,)) for cell in FORMULA_CELLS})
    jobs[("subset", "sim_full_width_plain", ("sim",))] = (
        sim_full_width_plain, ())
    jobs[("subset", "sim_second_phase_plain", ("second_phase",))] = (
        sim_second_phase_plain, ())
    jobs[("subset", "fit_demo_run", ("fit_demo",))] = (fit_demo_run, ())
    jobs.update({("mesh_plain", "mesh_plain_subset", key):
                 (mesh_plain_subset, key) for key in MESH_PLAIN})
    jobs.update({(kind, fn.__name__, ()): (fn, ()) for kind, fn in (
        ("truth", pol_full_width_truth), ("stages", check_polarized_stages),
        ("mesh_phase_plain", mesh_phase_plain_subset),
        ("pol_plain", pol_full_width_plain))})
    jobs[("derive", "check_mesh_derive", ("float32",))] = (
        check_mesh_derive, ("float32",))
    jobs.update({("aux", fn.__name__, ()): (fn, ()) for _, fn in AUX_JOBS})
    jobs.update({("render", fn.__name__, ()): (fn, ())
                 for _, fn in RENDER_JOBS})
    jobs.update({("mixture", fn.__name__, ()): (fn, ()) for fn in (
        check_mixture_phase, mixture_plain_subset, mixture_pol_plain_subset)})
    jobs.update({("fmks", "check_fmks_simulation", args):
                 (check_fmks_simulation, args) for args in FMKS_CHECKS})
    jobs.update({("fmks_plain", "fmks_plain_subset", (cell,)):
                 (fmks_plain_subset, (cell,)) for cell in FMKS_CELLS})
    jobs[("fmks_phase", "check_fmks_phase", ())] = (check_fmks_phase, ())
    jobs.update({("fmks_pol", "fmks_pol_subset", (p,)):
                 (fmks_pol_subset, (p,)) for p in ("float32", "float64")})
    jobs.update({("athenak", "check_athenak_simulation", args):
                 (check_athenak_simulation, args) for args in ATHENAK_CHECKS})
    jobs.update({("athenak_plain", "athenak_plain_subset", (cell,)):
                 (athenak_plain_subset, (cell,)) for cell in ATHENAK_RUNS})
    jobs[("athenak_phase", "check_athenak_phase", ())] = (
        check_athenak_phase, ())
    jobs.update({("athenak_pol", "athenak_pol_subset", (p,)):
                 (athenak_pol_subset, (p,)) for p in ("float32", "float64")})
    jobs.update({("code_kappa", "code_kappa_plain", key):
                 (code_kappa_plain, key) for key in CK_PLAIN})
    jobs.update({("code_kappa_pol", "code_kappa_pol_plain", (p,)):
                 (code_kappa_pol_plain, (p,)) for p in ("float32", "float64")})
    jobs[("code_kappa_phase", "check_code_kappa_phase", ())] = (
        check_code_kappa_phase, ())
    # longest first (a stable sort: jobs of no measured length keep the
    # table's order after the measured ones); MAIN_JOBS run in this
    # process once its own host work is done, on the core the pool leaves
    order = sorted((key for key in jobs if key[1:] not in MAIN_JOBS),
                   key=lambda key: -PHASE3_SECONDS.get(key[1:], 0.0))
    started = {key: _PoolJob(pool.apply_async(_pool_job, jobs[key]))
               for key in order}
    t_prep = time.perf_counter()
    prepared = prep() if prep is not None else None
    t_main = time.perf_counter()
    import torch
    threads = torch.get_num_threads()
    for key in jobs:
        if key[1:] in MAIN_JOBS:
            started[key] = _DoneJob(_pool_job(*jobs[key]))
    torch.set_num_threads(threads)
    emit("checks_main_process", prep_s=t_main - t_prep,
         jobs_s=time.perf_counter() - t_main,
         jobs=[[name, list(args)] for name, args in MAIN_JOBS])

    def results(kind):
        return {key[2]: job for key, job in started.items()
                if key[0] == kind}

    checks = [started[("check", fn.__name__, args)] for fn, args in CHECKS]
    mesh_phase = [started[("mesh_phase", "check_mesh_phase", args)]
                  for args in MESH_PHASE_CHECKS]
    subsets = {args[0]: job for args, job in results("subset").items()}
    mesh_plain = results("mesh_plain")
    truth = started[("truth", "pol_full_width_truth", ())]
    pol_plain = started[("pol_plain", "pol_full_width_plain", ())]
    stages = started[("stages", "check_polarized_stages", ())]
    mesh_phase_plain = started[("mesh_phase_plain",
                                "mesh_phase_plain_subset", ())]
    mesh_derive = started[("derive", "check_mesh_derive", ("float32",))]
    aux = {name: started[("aux", fn.__name__, ())] for name, fn in AUX_JOBS}
    mixture = {key[1]: job for key, job in started.items()
               if key[0] == "mixture"}
    for check in checks:
        phase, result = check.get()
        emit(phase, workers=WORKERS, **result)
        if not result["ok"]:
            raise RuntimeError(f"{phase}: kernel disagrees with plain: "
                               f"{result}")
    phase, stages = stages.get()
    emit(phase, workers=WORKERS, **stages)
    if not stages["ok"]:
        raise RuntimeError(f"{phase}: a polarized kernel disagrees with its "
                           f"plain version: {stages}")
    mesh = {}
    for name, job in (("phase", mesh_phase[0]), ("nearest phase",
                                                mesh_phase[1]),
                      ("derive", mesh_derive)):
        phase, result = job.get()
        emit(phase, workers=WORKERS, **result)
        if not result["ok"]:
            raise RuntimeError(f"{phase}: kernel disagrees with plain: "
                               f"{result}")
        mesh[name] = result
    mesh["plain"] = {key: job.get() for key, job in mesh_plain.items()}
    mesh["phase_plain"] = mesh_phase_plain.get()
    truth = (*truth.get(), pol_plain.get())
    subsets = {cell: result.get() for cell, result in subsets.items()}
    aux = {name: job.get() for name, job in aux.items()}
    aux["render"] = {name: started[("render", fn.__name__, ())].get()
                     for name, fn in RENDER_JOBS}
    phase, result = mixture["check_mixture_phase"].get()
    emit(phase, workers=WORKERS, **result)
    if not result["ok"]:
        raise RuntimeError(f"{phase}: kernel disagrees with plain: {result}")
    mixture = {"phase": result,
               "plain": mixture["mixture_plain_subset"].get(),
               "pol_plain": mixture["mixture_pol_plain_subset"].get()}
    fmks_phase = started[("fmks_phase", "check_fmks_phase", ())]
    for job in (*(started[("fmks", "check_fmks_simulation", args)]
                  for args in FMKS_CHECKS), fmks_phase):
        phase, result = job.get()
        emit(phase, workers=WORKERS, **result)
        if not result["ok"]:
            raise RuntimeError(f"{phase}: kernel disagrees with plain: "
                               f"{result}")
    fmks = {"phase": fmks_phase.get()[1],
            "plain": {args[0]: job.get()
                      for args, job in results("fmks_plain").items()},
            "pol_plain": results("fmks_pol")[("float32",)].get(),
            "pol_truth": results("fmks_pol")[("float64",)].get()}
    athenak_phase = started[("athenak_phase", "check_athenak_phase", ())]
    for job in (*(started[("athenak", "check_athenak_simulation", args)]
                  for args in ATHENAK_CHECKS), athenak_phase):
        phase, result = job.get()
        emit(phase, workers=WORKERS, **result)
        if not result["ok"]:
            raise RuntimeError(f"{phase}: kernel disagrees with plain: "
                               f"{result}")
    athenak = {"phase": athenak_phase.get()[1],
               "plain": {args[0]: job.get() for args, job in
                         results("athenak_plain").items()},
               "pol_plain": results("athenak_pol")[("float32",)].get(),
               "pol_truth": results("athenak_pol")[("float64",)].get()}
    phase, result = started[("code_kappa_phase", "check_code_kappa_phase",
                             ())].get()
    emit(phase, workers=WORKERS, **result)
    if not result["ok"]:
        raise RuntimeError(f"{phase}: kernel disagrees with plain: {result}")
    code_kappa = {"phase": result,
                  "plain": {key: job.get() for key, job in
                            results("code_kappa").items()},
                  "pol_plain": results("code_kappa_pol")[("float32",)].get(),
                  "pol_truth": results("code_kappa_pol")[("float64",)].get()}
    spans = {key: job.span() for key, job in started.items()}
    for key in sorted(spans, key=lambda k: spans[k][0]):
        begin, end = spans[key]
        emit("checks_job", job=key[1], args=list(key[2]),
             start_at_s=begin - STARTED_EPOCH, end_at_s=end - STARTED_EPOCH,
             seconds=end - begin)
    last = max(spans, key=lambda k: spans[k][1])
    emit("checks", workers=WORKERS, seconds=time.perf_counter() - t0,
         last_job=[last[1], list(last[2])],
         job_seconds=sum(end - begin for begin, end in spans.values()))
    return truth, subsets, stages, mesh, aux, mixture, fmks, athenak, \
        code_kappa, prepared


def _pool_job(fn, args):
    """A phase-3 job in a worker: its result and the epoch seconds at its
    start and end."""
    begin = time.time()
    return fn(*args), begin, time.time()


class _DoneJob:
    """A phase-3 job the main process ran: _PoolJob's get() and span()
    over _pool_job's result."""

    def __init__(self, result):
        self.result = result

    def get(self):
        return self.result[0]

    def span(self) -> tuple:
        return self.result[1:]


class _PoolJob:
    """A phase-3 job's AsyncResult whose get() gives the job's result;
    span() its (start, end) epoch seconds, once it has ended."""

    def __init__(self, async_result):
        self.async_result = async_result

    def get(self):
        return self.async_result.get()[0]

    def span(self) -> tuple:
        return self.async_result.get()[1:]


def _check_exact(kernel_out, plain_out, rtol) -> dict:
    """The unpolarized gates on identical rays: in rk4/rk2 float64
    identical flags, n_samples and NaN sets and I within ``rtol``;
    otherwise the statistical gate (bench.py:181-186)."""
    import numpy as np
    import torch
    (ik, fk_, nk), (ip, fp_, np_) = kernel_out, plain_out
    a, b = ik[:, 0].cpu().numpy(), ip[:, 0].cpu().numpy()
    gate = statistical_gate(a, b)
    result = dict(rays=a.size, max_n_samples=int(np_.max()), **gate)
    if rtol is None:
        result["gate"] = "statistical (bench.py:181-186)"
        return result
    exact = (bool(np.array_equal(np.isnan(a), np.isnan(b)))
             and torch.equal(fk_.cpu(), fp_.cpu())
             and torch.equal(nk.cpu(), np_.cpu()))
    close = bool(np.allclose(a, b, rtol=rtol, atol=0.0, equal_nan=True))
    result.update(gate=f"exact flags/n_samples/NaN, rtol {rtol:g}",
                  ok=exact and close)
    return result


def check_formula(integrator, precision) -> tuple:
    """The formula kernel against its plain version, 128^2."""
    from blacklight_tpu_torch.ops import formula_kernel as fk
    cfg = _config("golden_formula_32.input", camera_resolution=128,
                  ray_integrator=integrator, precision=precision)
    args, kwargs = _renderer(cfg)
    out_k, t_k = _timed(fk.render_formula, *args, **kwargs)
    out_p, t_p = _timed(fk.render_formula_reference, *args, **kwargs)
    exact = integrator != "dp" and precision == "float64"
    return "kernel_vs_plain", dict(
        integrator=integrator, precision=precision, kernel_s=t_k,
        plain_s=t_p, **_check_exact(out_k, out_p, 1e-9 if exact else None))


def check_formula_tangents(integrator, precision) -> tuple:
    """K1.3 and K1.4 against the plain version, 128^2: three frequencies
    with tangents for cn0, r0 and h (h = FIT_H, formula_a = CHECK_A); rk4
    float64 identical flags and n_samples and every output within rtol
    1e-9 per frequency, dp float32 the statistical gate on each."""
    import torch
    from blacklight_tpu_torch.ops import formula_kernel as fk
    cfg = _config("golden_formula_32.input", camera_resolution=128,
                  ray_integrator=integrator, precision=precision,
                  formula_h=FIT_H, formula_a=CHECK_A, **MULTI_FREQUENCIES)
    args, kwargs = _renderer(cfg)
    kwargs["diff_values"] = _fit_values(args[5])
    out_k, t_k = _timed(fk.render_formula, *args, **kwargs)
    out_p, t_p = _timed(fk.render_formula_reference, *args, **kwargs)
    exact = integrator != "dp" and precision == "float64"
    gate = gate_outputs([o.cpu().numpy() for o in _outputs(out_k)],
                        [o.cpu().numpy() for o in _outputs(out_p)],
                        1e-9 if exact else None)
    same = (torch.equal(out_k[1].cpu(), out_p[1].cpu())
            and torch.equal(out_k[2].cpu(), out_p[2].cpu()))
    gate["ok"] = gate["ok"] and (same or not exact)
    return "tangent_kernel_vs_plain", dict(
        integrator=integrator, precision=precision, frequencies=3,
        tangents=list(FIT_PARAMS), formula_h=FIT_H, formula_a=CHECK_A,
        rays=int(args[0].shape[0]), kernel_s=t_k, plain_s=t_p,
        same_flags_n_samples=same, max_n_samples=int(out_p[2].max()),
        gate=("exact flags/n_samples/NaN, rtol 1e-9" if exact
              else "statistical (bench.py:181-186) per output and frequency"),
        **gate)


def _formula_cell(cell):
    """The configuration, renderer arguments and keywords of a full-width
    formula cell: "k11" golden_formula_32 at 1024^2, dp, float32 (phase
    5); "k13" the same at three frequencies (phase 10); "k14" the same at
    one frequency with tangents for FIT_PARAMS at h = FIT_H (phase 11);
    "grad" scripts/bench_gradient.py's setting, GRAD_STEPS steps without
    NaN poisoning, at h = FIT_H (phase 11)."""
    overrides = dict(camera_resolution=1024, precision="float32",
                     ray_integrator="dp")
    if cell == "k13":
        overrides.update(MULTI_FREQUENCIES)
    elif cell == "k14":
        overrides.update(formula_h=FIT_H)
    elif cell == "grad":
        overrides.update(ray_max_steps=GRAD_STEPS, fallback_nan=False,
                         formula_h=FIT_H)
    cfg = _config("golden_formula_32.input", **overrides)
    args, kwargs = _renderer(cfg)
    if cell == "k14":
        kwargs["diff_values"] = _fit_values(args[5])
    return cfg, args, kwargs


def formula_plain_subset(cell) -> tuple:
    """Phase 3: the plain formula version on every PLAIN_STRIDE-th ray of a
    full-width cell, which that cell's phase holds its kernel against:
    (the rays' positions, the outputs (B, F) each, seconds). Run in phase
    3's pool, its time is not comparable with a lone run."""
    from blacklight_tpu_torch.ops import formula_kernel as fk
    _, args, kwargs = _formula_cell(cell)
    _, sub = _plain_subset(args)
    out, t_plain = _timed(fk.render_formula_reference, *sub, **kwargs)
    return (sub[0].cpu().numpy(), [o.cpu().numpy() for o in _outputs(out)],
            t_plain)


def phase_goldens(tmp: pathlib.Path):
    import numpy as np
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.ops import formula_kernel as fk
    for name, exact in (("golden_formula_cam_rk4_32", True),
                        ("golden_formula_rk2_32", True),
                        ("golden_formula_32", False)):
        cfg = _config(f"{name}.input", output_file=str(tmp / f"{name}.npz"))
        before = fk.LAUNCHES
        arrays = pipeline.run(cfg, quiet=True, device="cuda")
        launched = fk.LAUNCHES - before
        ours = arrays["I_nu"]
        gold = np.load(FIXTURES / f"{name}.npz")["I_nu"]
        rel = np.abs(ours - gold) / (np.abs(gold) + gold.max() * 1e-8)
        if exact:
            ok = bool(np.allclose(ours, gold, rtol=1e-7, atol=0.0))
            gate = "rtol 1e-7"
        else:
            ok = bool(np.nanmax(rel) < 5e-3 and np.nanmean(rel) < 1e-3)
            gate = "max rel < 5e-3, mean rel < 1e-3"
        ok = ok and launched > 0
        emit("golden", name=name, gate=gate, launches=launched,
             max_rel=float(np.nanmax(rel)), mean_rel=float(np.nanmean(rel)),
             ok=ok)
        if not ok:
            raise RuntimeError(f"golden {name} failed")


def warp_efficiency(n_samples, order, width=32) -> float:
    """Share of lane-steps doing work when rays run ``width`` to a warp
    (or a block) in ``order`` and it lasts as long as its longest ray,
    with n_samples standing in for a ray's step count; a ragged last
    group's empty lanes count as idle."""
    import numpy as np
    lanes = n_samples[order].astype("int64")
    lanes = np.concatenate([lanes, np.zeros(-lanes.size % width, "int64")])
    lanes = lanes.reshape(-1, width)
    return float(lanes.sum() / (width * lanes.max(axis=1).sum()))


def phase_full_width(tmp: pathlib.Path, card: str, subset) -> dict:
    """Phase 5; ``subset`` is phase 3's plain version on this cell's
    subset of rays (formula_plain_subset("k11"))."""
    import numpy as np
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk

    res = 1024
    cfg, _, _ = _formula_cell("k11")
    cfg.output_file = str(tmp / "full_width.npz")
    fk.LAUNCHES = sk.LAUNCHES = pk.LAUNCHES = 0
    t0 = time.perf_counter()
    arrays = pipeline.run(cfg, quiet=True, device="cuda")
    run_s = time.perf_counter() - t0
    launches = fk.LAUNCHES
    image = arrays["I_nu"]
    if image.shape != (res, res) or not np.isfinite(np.nanmax(image)):
        raise RuntimeError("full-width image is not finite or has the wrong "
                           "shape")
    if launches == 0 or sk.LAUNCHES or pk.LAUNCHES:
        raise RuntimeError("the formula main path launched no formula "
                           "kernel, or another kernel")
    emit("main_path", resolution=res, precision="float32", integrator="dp",
         seconds=run_s, launches=launches, nan_pixels=int(np.isnan(image).sum()),
         max_I_nu=float(np.nanmax(image)))

    timings = {}
    for precision in ("float32", "float64"):
        cfg.precision = precision
        (args, kwargs), t_setup = _timed(_renderer, cfg)
        # in the order run launches the bundle in; the plain version runs
        # in float32 only (camera order), on phase 3's subset
        order = pipeline.formula_launch_order(args[0])
        if order is not None:
            args = (*(t[order].contiguous() for t in args[:3]), *args[3:])
        tp = "float" if precision == "float32" else "double"
        timings[precision] = time_kernel(
            "timing", fk.render_formula,
            subset if precision == "float32" else None,
            args, kwargs, res, card,
            step_loop=f"formula_kernel<{tp}, dp, NF=1>", order=order,
            precision=precision, integrator="dp", camera_setup_s=t_setup)
    f64 = timings["float64"]
    f64_bound = bound("formula", "dp", "float64", res * res,
                      f64["mean_n_samples"], in_bytes=0, out_values=1)
    emit("timing_bound", card=card, precision="float64", integrator="dp",
         kernel_ms=f64["kernel_ms"],
         kernel_over_bound=f64["kernel_ms"] / f64_bound["bound_ms"],
         issue_estimate_ms=f64["issue_estimate_ms"], **f64_bound)
    f32 = timings["float32"]
    return {"name": "formula_kernel", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
            "launches": launches, "max_abs_err": f32["max_abs_err"],
            "ms": f32["kernel_ms"], "plain_ms": f32["plain_ms"],
            "plain_rays": res * res // PLAIN_STRIDE,
            **bound("formula", "dp", "float32", res * res,
                    f32["mean_n_samples"], in_bytes=0, out_values=1),
            "issue_estimate_ms": f32["issue_estimate_ms"],
            "library_ms": None}


def time_kernel(phase, kernel, plain, args, kwargs, res, card,
                step_loop=None, order=None, **fields):
    """Warm best of 3 of ``kernel`` on a res^2 ray bundle, and its outputs
    held to the plain version's by the statistical gate (per output and
    frequency): ``plain`` is None (no check), the plain version (run once
    on the same rays) or a phase-3 job's result for every ray or every
    PLAIN_STRIDE-th (formula_plain_subset, sim_full_width_plain).
    Emits the timing line and, for a formula kernel, the order its rays
    were launched in (``order``: the permutation of the camera's rays that
    ``args`` hold, None for camera order), the 128-ray block efficiency of
    camera order and of that order, and the issue estimate of
    ``step_loop`` (a STEP_LOOPS label); returns the numbers the kernels
    line needs."""
    import numpy as np
    kernel(*args, **kwargs)  # warm up
    times = []
    for _ in range(3):
        out_k, t = _timed(kernel, *args, **kwargs)
        times.append(t)
    nk = out_k[2]
    t_kernel, n = min(times), res * res
    out = {"kernel_ms": t_kernel * 1e3, "plain_ms": None, "max_abs_err": None,
           "mean_n_samples": float(nk.double().mean())}
    extra = {}
    if plain is not None:
        ours = [o.cpu().numpy() for o in _outputs(out_k)]
        if callable(plain):
            out_p, t_plain = _timed(plain, *args, **kwargs)
            ref, n_plain = [o.cpu().numpy() for o in _outputs(out_p)], n
        else:
            positions, ref, t_plain = plain
            pick = np.arange(0, n, n // positions.shape[0])
            if not np.array_equal(positions, args[0][pick].cpu().numpy()):
                raise RuntimeError("the plain version traced other rays")
            ours, n_plain = [o[pick] for o in ours], pick.size
        gate = gate_outputs(ours, ref)
        if not gate["ok"]:
            raise RuntimeError(f"{kernel.__name__} disagrees with plain "
                               f"at {res}^2 {fields}: {gate}")
        out["max_abs_err"] = gate.pop("max_abs_err")
        out["plain_ms"] = t_plain * 1e3
        extra = dict(plain_rays=n_plain, plain_rays_per_s=n_plain / t_plain,
                     gate="statistical (bench.py:181-186)", **gate)
    ns = nk.cpu().numpy()
    camera = ns  # n_samples in camera order
    if order is not None:
        camera = np.empty_like(ns)
        camera[order.cpu().numpy()] = ns
    # 8 x 4 pixel tiles, 32 rays each, in place of 32 pixels of one row
    tiles = np.arange(n).reshape(res // 4, 4, res // 8, 8).transpose(
        0, 2, 1, 3).reshape(-1)
    if step_loop is not None:
        from blacklight_tpu_torch import pipeline
        extra.update(
            fetch_order=("camera" if order is None else
                         f"spatial_order {pipeline.FORMULA_ORDER_BLOCK}"),
            block_efficiency_128={
                "camera": warp_efficiency(camera, np.arange(n), 128),
                "fetch_order": warp_efficiency(ns, np.arange(n), 128)})
        mixes = STEP_LOOPS.get(step_loop, {})
        out["step_loop"] = step_loop
        out["sample_instructions"] = mixes.get("per_sample", {}).get("total")
        out["step_instructions"] = mixes.get("per_step", {}).get("total")
        out["loop_instructions"] = mixes.get("step_loop", {}).get("total")
        out["ray_steps"] = int(ns.astype("int64").sum())
        out["issue_estimate_ms"] = None if out["step_instructions"] is None \
            else (out["step_instructions"] * out["ray_steps"]
                  / (N_SMS * ISSUE_LANES_PER_SM * SM_CLOCK_HZ["max"]) * 1e3)
        extra.update({k: out[k] for k in (
            "step_loop", "step_instructions", "sample_instructions",
            "loop_instructions", "ray_steps", "issue_estimate_ms")})
    emit(phase, resolution=res, card=card, **fields, kernel_s_runs=times,
         kernel_ms=out["kernel_ms"], plain_ms=out["plain_ms"],
         kernel_rays_per_s=n / t_kernel, max_abs_err=out["max_abs_err"],
         mean_n_samples=float(ns.mean()), max_n_samples=int(ns.max()),
         warp_efficiency_rows=warp_efficiency(camera, np.arange(n)),
         warp_efficiency_8x4_tiles=warp_efficiency(camera, tiles),
         clocks_power=smi(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                           "temperature.gpu", "--format=csv,noheader"]),
         **extra)
    return out


def _sim_config(name="golden_sim_rk4_32.input", **overrides):
    return _config(name, **{
        "simulation_file": str(FIXTURES / "mock_small.athdf"), **overrides})


def _sim_args(cfg, grid=None):
    """The simulation renderer's rays and kernel arguments on the card."""
    from blacklight_tpu_torch.pipeline_simulation import (
        make_simulation_renderer)
    render_fn, geom, rays, freqs, mass_msun = make_simulation_renderer(
        cfg, device="cuda", grid=grid)
    args = (rays.positions, rays.directions, rays.momentum_factors,
            *render_fn.kernel_args)
    return args, {"integrator": cfg.require("ray_integrator").value}


def check_simulation(integrator, precision) -> tuple:
    """The simulation kernel against its plain version, 128^2."""
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    cfg = _sim_config(camera_resolution=128, ray_integrator=integrator,
                      precision=precision)
    args, kwargs = _sim_args(cfg)
    out_k, t_k = _timed(sk.render_simulation, *args, **kwargs)
    out_p, t_p = _timed(sk.render_simulation_reference, *args, **kwargs)
    exact = integrator != "dp" and precision == "float64"
    return "sim_kernel_vs_plain", dict(
        integrator=integrator, precision=precision, kernel_s=t_k,
        plain_s=t_p, **_check_exact(out_k, out_p, 1e-7 if exact else None))


def _first_phase(args, integrator, phase_steps):
    """The phase kernel's first phase of ``phase_steps`` over ``args``'
    rays: (the carried state after it, the indices of the rays still
    alive, the phase kernel's arguments after the carried state's)."""
    import torch
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    positions, directions, mom, freqs, params, sp, grid, mass, cam, _ = args
    carry = sk.initial_carry(positions, directions, params, freqs.shape[0])
    index = torch.arange(positions.shape[0], dtype=torch.int32,
                         device=positions.device)
    phase = (directions, mom, freqs, params, sp, grid, mass, cam, integrator)
    sk.render_simulation_phase(carry, index, 0, phase_steps, *phase)
    index = index[(carry.masks[index.long()] & sk.ALIVE) != 0]
    return carry, index, phase


def _second_phase(args, integrator, phase_steps, with_plain=True):
    """The carried state of ``args``' rays after the phase kernel's first
    phase of ``phase_steps``, then their second phase through the kernel
    and (``with_plain``) through its plain version from that state:
    (kernel outputs, plain outputs, kernel seconds, plain seconds, rays in
    the second phase, their samples in it), the outputs as finish_rays
    gives them (None and 0.0 for the plain version without it)."""
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    carry, index, phase = _first_phase(args, integrator, phase_steps)
    freqs, sp, log_js = args[3], args[5], args[9]
    plain = sk.SimCarry(*(t.clone() for t in carry)) if with_plain else None
    before = carry.n_samp[index.long()]
    _, t_k = _timed(sk.render_simulation_phase, carry, index, phase_steps,
                    phase_steps, *phase)
    t_p = 0.0
    if with_plain:
        _, t_p = _timed(sk.render_simulation_phase_reference, plain, index,
                        phase_steps, phase_steps, *phase)
    samples = int((carry.n_samp[index.long()] - before).sum())
    fallback_nan = sp.sampler.fallback_nan
    return (sk.finish_rays(carry, index, freqs, log_js, fallback_nan),
            sk.finish_rays(plain, index, freqs, log_js, fallback_nan)
            if with_plain else None,
            t_k, t_p, int(index.numel()), samples)


def check_simulation_phase(integrator, precision) -> tuple:
    """The phase kernel (K2.3) against its plain version, 128^2: the
    second phase of KERNEL_PHASE_STEPS from the kernel's carried state
    after the first; rk4 float64 exact flags, n_samples and NaN sets and
    I within rtol 1e-7, rk2 float32 the statistical gate."""
    from blacklight_tpu_torch.pipeline_simulation import KERNEL_PHASE_STEPS
    cfg = _sim_config(camera_resolution=128, ray_integrator=integrator,
                      precision=precision)
    args, _ = _sim_args(cfg)
    out_k, out_p, t_k, t_p, rays, _ = _second_phase(
        args, integrator, KERNEL_PHASE_STEPS)
    exact = precision == "float64"
    return "sim_phase_kernel_vs_plain", dict(
        integrator=integrator, precision=precision,
        phase_steps=KERNEL_PHASE_STEPS, phase_rays=rays,
        kernel_s=t_k, plain_s=t_p,
        **_check_exact(out_k, out_p, 1e-7 if exact else None))


def phase_sim_goldens(tmp: pathlib.Path):
    import numpy as np
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    for name, exact, snapshot in (
            ("golden_sim_rk4_32", True, "mock_small.athdf"),
            ("golden_sim_32", False, "mock_small.athdf"),
            ("golden_amr_rk4_32", True, "mock_amr.athdf"),
            ("golden_plasma_pow_rk4_32", True, "mock_small.athdf"),
            ("golden_plasma_kap_rk4_32", True, "mock_small.athdf"),
            ("golden_plasma_mix_rk4_32", True, "mock_small.athdf")):
        cfg = _sim_config(f"{name}.input",
                          output_file=str(tmp / f"{name}.npz"),
                          simulation_file=str(FIXTURES / snapshot))
        before = sk.LAUNCHES, sk.MIXTURE_LAUNCHES
        arrays = pipeline.run(cfg, quiet=True, device="cuda")
        launched = sk.LAUNCHES - before[0]
        mixture = sk.MIXTURE_LAUNCHES - before[1]
        ours = arrays["I_nu"]
        gold = np.load(FIXTURES / f"{name}.npz")["I_nu"]
        rel = np.abs(ours - gold) / (np.abs(gold) + np.nanmax(gold) * 1e-8)
        if exact:
            # tests/test_simulation_e2e.py, with the NaN sets of
            # tests/test_amr.py:39-52
            ok = bool(np.array_equal(np.isnan(ours), np.isnan(gold))
                      and np.allclose(ours, gold, rtol=1e-8, atol=0.0,
                                      equal_nan=True))
            gate = "NaN sets, rtol 1e-8"
        else:
            ok = bool(np.nanmax(rel) < 6e-2 and np.nanmean(rel) < 5e-3)
            gate = "max rel < 6e-2, mean rel < 5e-3"
        # the plasma goldens through the mixture's kernel, the others
        # through the thermal one
        ok = ok and launched > 0 and (mixture == launched) == ("plasma"
                                                                in name)
        emit("sim_golden", name=name, gate=gate, launches=launched,
             mixture_launches=mixture,
             max_rel=float(np.nanmax(rel)), mean_rel=float(np.nanmean(rel)),
             ok=ok)
        if not ok:
            raise RuntimeError(f"golden {name} failed")


def full_width_snapshot(dtype, device=None, size=FULL_GRID):
    """FULL_GRID (or ``size``, over the generator's defaults) from
    scripts/generate_mock_simulation.make_fields on the card (or
    ``device``), as an Athena++ file would hold it (float32 values and
    coordinates; the coordinates then in ``dtype``), through the function
    that load_athdf ends in. The card's Python has no h5py to write the
    file."""
    import numpy as np
    import torch
    from blacklight_tpu_torch.grid.athena import (
        PRIMITIVE_NAMES,
        simulation_grid,
    )
    sys.path.insert(0, str(ROOT / "scripts"))
    import generate_mock_simulation as mock
    fields = mock.make_fields(dict(mock.DEFAULTS, **size))
    names = ["rho", "press", "vel1", "vel2", "vel3", "Bcc1", "Bcc2", "Bcc3"]
    prim = np.stack([fields[k] for k in ("rho", "pgas", "uur", "uuth", "uuph",
                                         "bbr", "bbth", "bbph")])
    rows = [np.asarray(fields[k], np.float32)[None]
            for k in ("rf", "r", "thf", "th", "phf", "ph")]
    return simulation_grid(
        prim[:, None].astype(np.float32), *rows,
        {key: names.index(var) for key, var in PRIMITIVE_NAMES.items()}, 0.0,
        device=device or torch.device("cuda", torch.cuda.current_device()),
        dtype=dtype)


def sim_full_width_plain() -> tuple:
    """Phase 3: the plain version on every ray of phase 7's float32 rk4
    cell, on the card, which phase 7 holds its kernel against (it ran in
    phase 7, after phase 3, ~43 s alone on the card: PERF.md): (the rays'
    positions, (I_nu,), seconds), numpy. In phase 3's pool its time is not
    comparable with a lone run."""
    import torch
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    args, kwargs = _sim_args(_sim_config(
        camera_resolution=1024, precision="float32", ray_integrator="rk4",
        ray_max_steps=2000), full_width_snapshot(torch.float32))
    out, t_plain = _timed(sk.render_simulation_reference, *args, **kwargs)
    return args[0].cpu().numpy(), [out[0].cpu().numpy()], t_plain


def phase_sim_full_width(tmp: pathlib.Path, card: str, grids: dict,
                         plain32) -> dict:
    """Phase 7; ``plain32``: sim_full_width_plain's result."""
    import numpy as np
    import torch
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk

    res = 1024
    t0 = time.perf_counter()
    if "float32" not in grids:
        grids["float32"] = full_width_snapshot(torch.float32)
    t_grid = time.perf_counter() - t0
    cfg = _sim_config(camera_resolution=res, precision="float32",
                      ray_integrator="rk4", ray_max_steps=2000,
                      output_file=str(tmp / "sim_full_width.npz"))
    fk.LAUNCHES = sk.LAUNCHES = pk.LAUNCHES = 0
    t0 = time.perf_counter()
    arrays = pipeline.run(cfg, quiet=True, device="cuda",
                          grid=grids["float32"])
    run_s = time.perf_counter() - t0
    launches = sk.LAUNCHES
    image = arrays["I_nu"]
    if image.shape != (res, res) or not np.isfinite(np.nanmax(image)):
        raise RuntimeError("full-width simulation image is not finite or has "
                           "the wrong shape")
    if launches == 0 or fk.LAUNCHES or pk.LAUNCHES:
        raise RuntimeError("the simulation main path launched no simulation "
                           "kernel")
    nvar, _, n_k, n_j, n_i = grids["float32"].prim.shape
    emit("sim_main_path", resolution=res, grid=[n_i, n_j, n_k],
         grid_mb=grids["float32"].prim.numel() * 4 / 1e6, precision="float32",
         integrator="rk4", max_steps=2000, snapshot_build_s=t_grid,
         seconds=run_s, launches=launches,
         nan_pixels=int(np.isnan(image).sum()),
         max_I_nu=float(np.nanmax(image)),
         npz_written=(tmp / "sim_full_width.npz").exists())

    cfg.output_file = str(tmp / "sim_profile.npz")
    emit("sim_profile", resolution=res, card=card,
         **profile_run(cfg, grids["float32"]))
    tables = {}
    for name, fn in (("kernel_tables", sk.kernel_tables),
                     ("kernel_grid", sk.kernel_grid)):
        tables[f"{name}_ms"] = min(
            _timed(fn, grids["float32"], torch.float32)[1]
            for _ in range(3)) * 1e3
    emit("sim_kernel_tables", card=card, table_mb=grid_bytes(
        grids["float32"]) / 1e6, guide_bins=sk.kernel_grid(
        grids["float32"], torch.float32).axes[3::sk.GUIDE_AXIS_VALUES]
        .tolist(), **tables)

    timings = {}
    for precision, integrator in (("float32", "rk4"), ("float64", "rk4"),
                                  ("float32", "dp")):
        if precision not in grids:
            grids[precision] = full_width_snapshot(torch.float64)
        cfg = _sim_config(camera_resolution=res, precision=precision,
                          ray_integrator=integrator, ray_max_steps=2000)
        (args, kwargs), t_setup = _timed(_sim_args, cfg, grids[precision])
        plain = plain32 if (precision, integrator) == ("float32", "rk4") \
            else None
        tp = "float" if precision == "float32" else "double"
        cell = time_kernel(
            "sim_timing", sk.render_simulation, plain, args, kwargs, res,
            card, step_loop=f"simulation_kernel<{tp}, {integrator}, NF=1>",
            precision=precision, integrator=integrator,
            camera_setup_s=t_setup)
        cell.update(bound("simulation", integrator, precision, res * res,
                          cell["mean_n_samples"],
                          in_bytes=grid_bytes(grids[precision]),
                          out_values=1))
        emit("sim_timing_bound", card=card, precision=precision,
             integrator=integrator, order="camera",
             kernel_ms=cell["kernel_ms"], bound_ms=cell["bound_ms"],
             bound_by=cell["bound_by"],
             kernel_over_bound=cell["kernel_ms"] / cell["bound_ms"],
             issue_estimate_ms=cell["issue_estimate_ms"])
        timings[precision, integrator] = cell
        del args, kwargs
    f32 = timings["float32", "rk4"]
    return {"name": "simulation_kernel", "route": "cuda",
            "source": SIM_KERNEL_SOURCE, "replaces": SIM_KERNEL_REPLACES,
            "launches": launches, "max_abs_err": f32["max_abs_err"],
            "ms": f32["kernel_ms"], "plain_ms": f32["plain_ms"],
            **{k: f32[k] for k in ("bound_ms", "bound_by", "bound_ops",
                                   "bound_bytes", "issue_estimate_ms")},
            "library_ms": None}, arrays


# Carried bytes per ray and phase launch besides the working type's
# values: read the index, n_samp, masks and bad (16); write n_samp, masks
# and bad (12). Values of the working type: read y (7), r_mid_prev, p_0,
# the momentum factor and per frequency intensity and tau (10 + 2), write
# y, r_mid_prev and per frequency intensity and tau (8 + 2).
PHASE_INT_BYTES = 28
PHASE_VALUES = 18
SPATIAL_BLOCKS = (128, 256, 512, 1024, 2048, 4096, 16384)


def phase_bound(rays, samples, precision, in_bytes,
                kind="simulation") -> dict:
    """bound() for one phase launch: the carried state of ``rays`` rays
    and the snapshot read and written once, and ``samples`` samples of
    rk4 work (this phase's, counted from n_samples) with ``kind``'s
    sample."""
    item = 4 if precision == "float32" else 8
    n_bytes = rays * (PHASE_VALUES * item + PHASE_INT_BYTES) + in_bytes
    ops = samples * (OPS_PER_STEP["rk4"] + OPS_PER_SAMPLE[kind])
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[precision]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bound_ops": ops, "bound_bytes": n_bytes}


def sim_second_phase_plain() -> tuple:
    """Phase 3: phase 13's second phase: phase 7's cell (float32 rk4)
    through the phase kernel's first phase of KERNEL_PHASE_STEPS, then its
    second phase through the kernel and through the plain version from
    that state, on the card (it took ~22 s after phase 3 alone): (kernel
    outputs, plain outputs, plain seconds, the second phase's rays),
    numpy."""
    import torch
    from blacklight_tpu_torch import pipeline_simulation as ps
    args, _ = _sim_args(_sim_config(
        camera_resolution=1024, precision="float32", ray_integrator="rk4",
        ray_max_steps=2000), full_width_snapshot(torch.float32))
    out_k, out_p, _, t_p, rays, _ = _second_phase(args, "rk4",
                                                  ps.KERNEL_PHASE_STEPS)
    return ([o.cpu().numpy() for o in out_k],
            [o.cpu().numpy() for o in out_p], t_p, rays)


def phase_phased_full_width(tmp: pathlib.Path, card: str, grids: dict,
                            mono: dict, second) -> dict:
    """Phase 13 (K2.3): phase 7's configuration through pipeline.run with
    KERNEL_PHASED on, held bit for bit to phase 7's image ``mono``; the
    phase kernel against its plain version on the second phase (phase 3's
    run of it, ``second``: sim_second_phase_plain's result); the
    efficiencies and times of each ray order."""
    import numpy as np
    import torch
    from blacklight_tpu_torch import pipeline, pipeline_simulation as ps
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk

    res, grid = 1024, grids["float32"]
    cfg = _sim_config(camera_resolution=res, precision="float32",
                      ray_integrator="rk4", ray_max_steps=2000,
                      output_file=str(tmp / "phased_full_width.npz"))
    ps.KERNEL_PHASED = True
    try:
        fk.LAUNCHES = sk.LAUNCHES = pk.LAUNCHES = sk.PHASE_LAUNCHES = 0
        arrays, run_s = _timed(pipeline.run, cfg, quiet=True, device="cuda",
                               grid=grid)
        launches = sk.PHASE_LAUNCHES
        others = fk.LAUNCHES + sk.LAUNCHES + pk.LAUNCHES
    finally:
        ps.KERNEL_PHASED = False
    a, b = arrays["I_nu"], mono["I_nu"]
    same = (a.shape == b.shape == (res, res)
            and np.array_equal(np.isnan(a), np.isnan(b))
            and np.array_equal(a[~np.isnan(a)], b[~np.isnan(b)])
            and all(np.array_equal(arrays[k], mono[k])
                    for k in mono if k != "I_nu"))
    n_phases = -(-2000 // ps.KERNEL_PHASE_STEPS)
    emit("phased_main_path", resolution=res, precision="float32",
         integrator="rk4", max_steps=2000, phase_steps=ps.KERNEL_PHASE_STEPS,
         seconds=run_s, launches=launches, other_launches=others,
         identical_to_monolithic=bool(same),
         nan_pixels=int(np.isnan(a).sum()))
    if not same or not 0 < launches <= n_phases or others:
        raise RuntimeError(f"the phased main path launched {launches} phase "
                           f"kernels ({others} others), or its image "
                           "differs from the monolithic kernel's")

    args, kwargs = _sim_args(_sim_config(
        camera_resolution=res, precision="float32", ray_integrator="rk4",
        ray_max_steps=2000), grid)
    steps = ps.KERNEL_PHASE_STEPS
    out_k, _, t_k, _, rays2, samples2 = _second_phase(
        args, "rk4", steps, with_plain=False)
    # phase 3's run of the same two phases: its kernel outputs are these
    # bit for bit, its plain version's held to them
    job_k, job_p, t_p, job_rays = second
    out_k = [o.cpu().numpy() for o in out_k]
    same = job_rays == rays2 and all(
        np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
        for a, b in zip(out_k, job_k))
    gate = _check_exact(tuple(torch.from_numpy(o) for o in out_k),
                        tuple(torch.from_numpy(o) for o in job_p), None)
    gate["ok"] = bool(gate["ok"] and same)
    emit("phase_kernel_vs_plain", resolution=res, card=card,
         phase_steps=steps, second_phase_rays=rays2, kernel_ms=t_k * 1e3,
         plain_ms=t_p * 1e3, plain_in="phase 3's pool",
         kernel_same_as_phase_3=same, **gate)
    if not gate["ok"]:
        raise RuntimeError(f"the phase kernel disagrees with plain at "
                           f"{res}^2: {gate}")
    both = np.isfinite(out_k[0]) & np.isfinite(job_p[0])
    max_abs_err = float(np.max(np.abs(out_k[0][both] - job_p[0][both])))

    # ray orders: the monolithic kernel's n_samples stand in for steps
    positions, n = args[0], res * res
    ns = sk.render_simulation(*args, **kwargs)[2].cpu().numpy()
    eff = {"camera": {"warp": warp_efficiency(ns, np.arange(n)),
                      "block": warp_efficiency(ns, np.arange(n), 128)}}
    for block in SPATIAL_BLOCKS:
        order = sk.spatial_order(positions, block=block)
        rays = (*(t[order] for t in args[:3]), *args[3:])
        kernel_ms = min(_timed(sk.render_simulation, *rays, **kwargs)[1]
                        for _ in range(2)) * 1e3
        order = order.cpu().numpy()
        eff[f"spatial_{block}"] = {"warp": warp_efficiency(ns, order),
                                   "block": warp_efficiency(ns, order, 128),
                                   "kernel_ms": kernel_ms}
    emit("ray_order_efficiency", resolution=res, card=card,
         proxy="n_samples", blocks_of=128,
         chosen_block=ps.KERNEL_ORDER_BLOCK, **eff)

    order = sk.spatial_order(positions, block=ps.KERNEL_ORDER_BLOCK)
    ordered = (*(t[order] for t in args[:3]), *args[3:])
    phased_kwargs = dict(kwargs, phase_steps=ps.KERNEL_PHASE_STEPS,
                         block=ps.KERNEL_ORDER_BLOCK)
    routes = {"camera": lambda: sk.render_simulation(*args, **kwargs),
              "spatial": lambda: sk.render_simulation(*ordered, **kwargs),
              "phased": lambda: sk.render_simulation_phased(
                  *ordered, **phased_kwargs)}
    for fn in routes.values():
        fn()  # warm up
    best = dict.fromkeys(routes, float("inf"))
    runs = {k: [] for k in routes}
    for _ in range(3):
        for name, fn in routes.items():
            _, t = _timed(fn)
            runs[name].append(t)
            best[name] = min(best[name], t)
    # each phase's times, from the best of 3 runs that synchronize at
    # every phase boundary
    stats_runs = [[] for _ in range(3)]
    for stats in stats_runs:
        sk.render_simulation_phased(*ordered, **phased_kwargs, stats=stats)
    stats = min(stats_runs, key=lambda st: sum(p["kernel_s"] + p["compact_s"]
                                               for p in st))
    phases = []
    for p in stats:
        samples = p["samples"]
        phases.append(dict(
            phase=p["phase"], rays=p["rays"], survivors=p["survivors"],
            kernel_ms=p["kernel_s"] * 1e3, compact_ms=p["compact_s"] * 1e3,
            mean_samples=float(samples.mean()),
            warp_efficiency=warp_efficiency(samples, np.arange(samples.size)),
            block_efficiency=warp_efficiency(samples, np.arange(samples.size),
                                             128),
            **phase_bound(p["rays"], int(samples.sum()), "float32",
                          grid_bytes(grid))))
    kernel_ms = sum(p["kernel_ms"] for p in phases)
    bound_ms = sum(p["bound_ms"] for p in phases)
    emit("phased_timing", resolution=res, card=card, precision="float32",
         integrator="rk4", order_block=ps.KERNEL_ORDER_BLOCK,
         **{f"{k}_ms": v * 1e3 for k, v in best.items()},
         **{f"{k}_s_runs": v for k, v in runs.items()},
         phased_over_camera=best["phased"] / best["camera"],
         spatial_over_camera=best["spatial"] / best["camera"],
         phased_over_spatial=best["phased"] / best["spatial"],
         phases=phases, phase_kernel_ms_total=kernel_ms,
         compact_ms_total=sum(p["compact_ms"] for p in phases),
         phases_bound_ms_total=bound_ms,
         clocks_power=smi(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                           "temperature.gpu", "--format=csv,noheader"]))
    second = phase_bound(rays2, samples2, "float32", grid_bytes(grid))
    return {"name": "simulation_phase_kernel", "route": "cuda",
            "source": SIM_KERNEL_SOURCE, "replaces": PHASE_REPLACES,
            "launches": launches, "max_abs_err": max_abs_err,
            "ms": t_k * 1e3, "plain_ms": t_p * 1e3,
            "work": (f"phase 1 (steps {steps}-{min(2 * steps, 2000) - 1}) "
                     f"of the 1024^2 image, {rays2} rays"),
            **second, "library_ms": None}


# Phase 14: FULL_GRID in Athena++ mesh blocks of MESH_BLOCK^3 cells laid
# out by write_athena_amr's rules (scripts/generate_mock_simulation.py,
# each block's values from eval_fields at its own centres): mb-uniform,
# 9 x 4 x 4 blocks at level 0; mb-amr, the same with the 16 root blocks at
# li, lj in {1, 2} (r 2.8-5.8, theta 45-135 degrees: the inner disk) each
# replaced by its 8 level-1 children, and the sentinel block of
# write_athena_amr(pad_block=True) (257 blocks). The nearest cell: FULL_GRID
# in one block with simulation_interp = false. The reference's interblock
# sampling takes its fraction past a block's upper face from x?v(b, n),
# the next block's first centre in block order (grid/sampling.py
# interblock_corners), which differs from the one-block trilinear
# wherever the field varies across that face: mb-uniform is measured
# against one block, not gated. The gate is tests/test_loaders.py:244-262's
# case: fields without phi structure (pert_amp = 0) in PHI_SPLIT phi
# blocks, within MESH_PHI_ATOL of I's peak of the same fields in one
# block.
MESH_BLOCK = 32
AMR_REFINE = tuple((li, lj, lk) for li in (1, 2) for lj in (1, 2)
                   for lk in range(4))
PHI_SPLIT = 4
MESH_PHI_ATOL = 2e-5
# cell -> (layout, input overrides): layout "uniform", "amr", "phi" or
# "single"
MESH_CELLS = {
    "mb_uniform": ("uniform", {}),
    "mb_uniform_interblock": ("uniform", {"simulation_block_interp": True}),
    "mb_amr": ("amr", {"simulation_block_interp": True}),
    "nearest": ("single", {"simulation_interp": False}),
}
# Phase 3's checks of the new instantiations on mock_amr.athdf (two
# levels, exact interblock sampling, or the nearest cell on its blocks).
MESH_MODES = {"interblock": {"simulation_block_interp": True},
              "nearest": {"simulation_interp": False}}
# Their steps (as phase 3's polarized cases): a plain version's time goes
# with its steps, not its rays.
MESH_CHECK_STEPS = dict(ray_step=0.04, ray_max_steps=400)
# Phase 14's cells held to the plain version on 4,096 rays, by precision:
# each mode's float32 main path, and float64 (exact) for each mode.
MESH_PLAIN = (("mb_uniform", "float32"), ("mb_amr", "float32"),
              ("nearest", "float32"), ("mb_uniform", "float64"),
              ("mb_amr", "float64"), ("nearest", "float64"))
# The phase kernel of interblock sampling is held to its plain version on
# this many of the rays alive in mb-amr's second phase.
MESH_PHASE_RAYS = 4096


def athena_blocks(dtype, block_size, refine=(), sentinel=False,
                  device=None, **fields):
    """FULL_GRID as an Athena++ file of mesh blocks of ``block_size`` (n_i,
    n_j, n_k) cells holds it, laid out by write_athena_amr's rules (the
    unrefined root blocks in (lk, lj, li) order, then the 8 children of
    each location in ``refine``, sorted; the sentinel block last), float32
    values and coordinates, on ``device`` (None: the card) through
    simulation_grid with the refinement metadata; the coordinates then in
    ``dtype``. ``fields``: FULL_GRID's field parameters overridden."""
    import numpy as np
    import torch
    from blacklight_tpu_torch.grid.athena import (
        PRIMITIVE_NAMES,
        simulation_grid,
    )
    mock = _mock()
    p = dict(mock.DEFAULTS, **{**FULL_GRID, **fields})
    n = (p["n_r"], p["n_th"], p["n_ph"])
    layout = [n[a] // block_size[a] for a in range(3)]
    refine = sorted(set(refine))
    blocks = [(0, li, lj, lk) for lk in range(layout[2])
              for lj in range(layout[1]) for li in range(layout[0])
              if (li, lj, lk) not in refine]
    blocks += [(1, 2 * li + ci, 2 * lj + cj, 2 * lk + ck)
               for li, lj, lk in refine for ck in range(2)
               for cj in range(2) for ci in range(2)]
    n_b = len(blocks) + int(sentinel)
    faces = [np.zeros((n_b, m + 1)) for m in block_size]
    centres = [np.zeros((n_b, m)) for m in block_size]
    prim = np.zeros((8, n_b, *block_size[::-1]), np.float32)
    spans = ((np.log(p["r_min"]), np.log(p["r_max"])), (0.0, np.pi),
             (0.0, 2.0 * np.pi))
    for b, (level, *loc) in enumerate(blocks):
        for a in range(3):
            m = block_size[a]
            f = np.linspace(*spans[a], (n[a] << level) + 1)[
                loc[a] * m:(loc[a] + 1) * m + 1]
            c = 0.5 * (f[:-1] + f[1:])
            faces[a][b], centres[a][b] = (np.exp(f), np.exp(c)) if a == 0 \
                else (f, c)
        fl = mock.eval_fields(p, centres[0][b], centres[1][b],
                              centres[2][b])
        prim[:, b] = [fl[k] for k in ("rho", "pgas", "uur", "uuth", "uuph",
                                      "bbr", "bbth", "bbph")]
    locations = np.array([loc for _, *loc in blocks]
                         + [(9999, 9999, 9999)] * int(sentinel), np.int64)
    levels = np.array([lev for lev, *_ in blocks] + [0] * int(sentinel),
                      np.int32)
    if sentinel:
        # far outside the domain, floor values (write_athena_amr)
        for a, (lo, hi) in enumerate(((1e3, 1.001e3), (0.0, np.pi),
                                      (0.0, 2.0 * np.pi))):
            faces[a][-1] = np.linspace(lo, hi, block_size[a] + 1)
            centres[a][-1] = 0.5 * (faces[a][-1][:-1] + faces[a][-1][1:])
        prim[0, -1], prim[1, -1] = p["rho_floor"], p["pgas_floor"]
    names = ["rho", "press", "vel1", "vel2", "vel3", "Bcc1", "Bcc2", "Bcc3"]
    rows = [np.asarray(x, np.float32) for a in range(3)
            for x in (faces[a], centres[a])]
    return simulation_grid(
        prim, *rows,
        {key: names.index(var) for key, var in PRIMITIVE_NAMES.items()}, 0.0,
        device=device or torch.device("cuda", torch.cuda.current_device()),
        dtype=dtype, levels=levels, locations=locations, n3_root=n[2])


def _mock():
    sys.path.insert(0, str(ROOT / "scripts"))
    import generate_mock_simulation as mock
    return mock


def _mock_athenak():
    sys.path.insert(0, str(ROOT / "scripts"))
    import mock_athenak
    return mock_athenak


def mesh_grid(layout, dtype):
    """A phase-14 snapshot of ``layout`` ("uniform", "amr", "single"; "phi"
    and "phi_single" without phi structure) in ``dtype``, with its
    neighbour table where it has blocks (the table does not depend on the
    type)."""
    from blacklight_tpu_torch.grid.amr import with_amr_table
    m = MESH_BLOCK
    n = (FULL_GRID["n_r"], FULL_GRID["n_th"], FULL_GRID["n_ph"])
    if layout == "single":
        return full_width_snapshot(dtype)
    if layout == "phi_single":
        return athena_blocks(dtype, n, pert_amp=0.0)
    if layout == "phi":
        grid = athena_blocks(dtype, (n[0], n[1], n[2] // PHI_SPLIT),
                             pert_amp=0.0)
    else:
        grid = athena_blocks(dtype, (m, m, m),
                             AMR_REFINE if layout == "amr" else (),
                             sentinel=layout == "amr")
    return with_amr_table(grid)


def _mesh_cell_config(cell, precision, res=1024):
    """Phase 7's configuration (rk4, 2000 steps) with ``cell``'s sampling
    overrides."""
    return _sim_config(camera_resolution=res, precision=precision,
                       ray_integrator="rk4", ray_max_steps=2000,
                       **MESH_CELLS[cell][1])


def mesh_plain_subset(cell, precision) -> tuple:
    """The plain version on phase 14's ``cell`` at 1024^2 in ``precision``
    on every PLAIN_STRIDE-th ray of the camera's: (their positions,
    (I_nu, flags, n_samples), seconds), numpy."""
    import torch
    dtype = torch.float32 if precision == "float32" else torch.float64
    grid = mesh_grid(MESH_CELLS[cell][0], dtype)
    args, kwargs = _sim_args(_mesh_cell_config(cell, precision), grid)
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    pick = torch.arange(0, args[0].shape[0], PLAIN_STRIDE,
                        device=args[0].device)
    sub = (*(a[pick].contiguous() for a in args[:3]), *args[3:])
    out, t_p = _timed(sk.render_simulation_reference, *sub, **kwargs)
    return (sub[0].cpu().numpy(), [o.cpu().numpy() for o in out], t_p)


def mesh_phase_plain_subset() -> tuple:
    """Phase 3: the plain phase version on mb-amr's second phase (float32,
    rk4, steps KERNEL_PHASE_STEPS to twice that) from the phase kernel's
    carried state after the first, on MESH_PHASE_RAYS of the rays alive
    then (evenly spaced): (their indices, the carried state they enter
    with, (I_nu, flags, n_samples), seconds, the rays alive), numpy."""
    import torch
    from blacklight_tpu_torch.pipeline_simulation import KERNEL_PHASE_STEPS
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    args, _ = _sim_args(_mesh_cell_config("mb_amr", "float32"),
                        mesh_grid("amr", torch.float32))
    steps = KERNEL_PHASE_STEPS
    carry, index, phase = _first_phase(args, "rk4", steps)
    pick = _phase_pick(index)
    carried = [t[..., pick.long()].cpu().numpy() for t in carry]
    _, t_p = _timed(sk.render_simulation_phase_reference, carry, pick, steps,
                    steps, *phase)
    out = sk.finish_rays(carry, pick, args[3], args[9],
                         args[5].sampler.fallback_nan)
    return (pick.cpu().numpy(), carried, [o.cpu().numpy() for o in out], t_p,
            int(index.numel()))


def _phase_pick(index):
    """MESH_PHASE_RAYS of the rays ``index``, evenly spaced."""
    step = max(1, index.numel() // MESH_PHASE_RAYS)
    return index[::step][:MESH_PHASE_RAYS].contiguous()


def _mesh_config(mode, **overrides):
    return _sim_config(**{"simulation_file": str(FIXTURES / "mock_amr.athdf"),
                          **MESH_MODES[mode], **overrides})


def check_mesh_simulation(mode, integrator, precision, nf) -> tuple:
    """The simulation kernel of many blocks (``mode`` of MESH_MODES on
    mock_amr.athdf) against its plain version, 128^2 with MESH_CHECK_STEPS;
    nf = 3 takes the 16-frequency instantiation."""
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    cfg = _mesh_config(mode, camera_resolution=128, ray_integrator=integrator,
                       precision=precision, **MESH_CHECK_STEPS,
                       **(MULTI_FREQUENCIES if nf > 1 else {}))
    args, kwargs = _sim_args(cfg)
    out_k, t_k = _timed(sk.render_simulation, *args, **kwargs)
    out_p, t_p = _timed(sk.render_simulation_reference, *args, **kwargs)
    exact = integrator != "dp" and precision == "float64"
    result = _check_exact(out_k, out_p, 1e-9 if exact else None)
    if nf > 1 and result["ok"] and not exact:
        result = _check_frequencies(out_k, out_p, result)
    return "sim_mesh_kernel_vs_plain", dict(
        mode=mode, integrator=integrator, precision=precision,
        frequencies=nf, kernel_s=t_k, plain_s=t_p, **result)


def _check_frequencies(out_k, out_p, result) -> dict:
    """The statistical gate on every frequency after the first."""
    for f in range(1, out_k[0].shape[1]):
        gate = statistical_gate(out_k[0][:, f].cpu().numpy(),
                                out_p[0][:, f].cpu().numpy())
        result["ok"] = result["ok"] and gate["ok"]
    return result


def check_mesh_phase(mode, integrator, precision) -> tuple:
    """The phase kernel of many blocks against its plain version, 128^2 on
    mock_amr.athdf with MESH_CHECK_STEPS: the second of two phases from
    the kernel's carried state after the first."""
    import numpy as np
    cfg = _mesh_config(mode, camera_resolution=128, ray_integrator=integrator,
                       precision=precision, **MESH_CHECK_STEPS)
    args, _ = _sim_args(cfg)
    phase_steps = MESH_CHECK_STEPS["ray_max_steps"] // 2
    out_k, out_p, t_k, t_p, rays, samples = _second_phase(
        args, integrator, phase_steps)
    exact = precision == "float64"
    both = [o[0].cpu().numpy() for o in (out_k, out_p)]
    finite = ~(np.isnan(both[0]) | np.isnan(both[1]))
    return "sim_mesh_phase_kernel_vs_plain", dict(
        mode=mode, integrator=integrator, precision=precision,
        grid_bytes=grid_bytes(args[6]),
        phase_steps=phase_steps, phase_rays=rays,
        phase_samples=samples, kernel_s=t_k, plain_s=t_p,
        max_abs_err=float(abs(both[0][finite] - both[1][finite]).max()),
        **_check_exact(out_k, out_p, 1e-9 if exact else None))


def check_mesh_polarized(mode, integrator, precision) -> tuple:
    """The polarized route with the derive kernel of many blocks against
    its plain version, 64^2 on mock_amr.athdf (phase 3's polarized case)."""
    import torch
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    cfg = _pol_case_config(integrator, precision, False, 1)
    cfg.simulation_file = str(FIXTURES / "mock_amr.athdf")
    for key, value in MESH_MODES[mode].items():
        setattr(cfg, key, value)
    args, kwargs, geom = _pol_args(cfg)
    out_k, t_k = _timed(pk.render_polarized, *args, **kwargs)
    out_p, t_p = _timed(pk.render_polarized_reference, *args, **kwargs)
    exact = precision == "float64" and integrator != "dp"
    gate = polarized_gate(_pol_stokes(out_k, args, geom, True),
                          _pol_stokes(out_p, args, geom, True), exact)
    same = (torch.equal(out_k[2].cpu(), out_p[2].cpu())
            and torch.equal(out_k[3].cpu(), out_p[3].cpu()))
    ok = bool(gate.pop("ok") and (same or not exact))
    return "pol_mesh_kernel_vs_plain", dict(
        mode=mode, integrator=integrator, precision=precision,
        rays=int(args[0].shape[0]), kernel_s=t_k, plain_s=t_p,
        same_flags_n_samples=same, **gate, ok=ok)


def check_mesh_derive(precision) -> tuple:
    """The derive kernel of exact interblock sampling at phase 14's mb-amr
    cell (the polarized configuration of phase 9) against
    derive_records_reference on the trace kernel's samples of 4,096 rays
    (every PLAIN_STRIDE-th in spatial_order): every record value of every
    stored sample, float64 within 1e-9 of each value's peak, float32 at
    the polarized stages' gate; the bad bits equal. Returns its times and
    bound beside."""
    import torch
    from blacklight_tpu_torch import pipeline_simulation as ps
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    dtype = torch.float32 if precision == "float32" else torch.float64
    grid = mesh_grid("amr", dtype)
    args, _, _ = _pol_args(_pol_full_config(
        precision, "rk4", simulation_block_interp=True), grid)
    order = sk.spatial_order(args[0], block=ps.KERNEL_ORDER_BLOCK)
    pick = order[::PLAIN_STRIDE]
    positions, directions, mom = (a[pick].contiguous() for a in args[:3])
    freqs, params, sp, grid, mass, cam, _ = args[3:]
    stages = pk._CudaStages(positions, directions, mom, freqs, params, sp,
                            grid, mass, cam, "rk4", False, None, 1 << 30,
                            1 << 31)
    b = positions.shape[0]
    flags = torch.empty(b, dtype=torch.int32, device="cuda")
    ns = torch.empty(b, dtype=torch.int32, device="cuda")
    samples = stages.trace(0, b, flags, ns)
    lengths = pk.warp_lengths(ns)
    piece = pk.Piece(0, b, samples, ns, lengths, pk.record_offsets(lengths),
                     int(lengths.sum()))
    stages.derive(piece, 0, 1, None)  # warm up
    before = list(pk.DERIVE_MODE_LAUNCHES)
    (geometry, coefficients, bits), t_k = _timed(stages.derive, piece, 0, 1,
                                                 None)
    launched = [a - b_ for a, b_ in zip(pk.DERIVE_MODE_LAUNCHES, before)]
    (geo_p, coef_p, bits_p), t_p = _timed(
        pk.derive_records_reference, samples, ns, lengths, piece.offsets,
        directions, mom, freqs, 0, 1, params, sp, grid, mass, cam)
    w, t, lane, _ = pk._stored(samples, ns, lengths)
    slot = piece.offsets[w] + t
    ours = torch.cat((geometry[slot, :, lane], coefficients[slot, :, lane]), 1)
    ref = torch.cat((geo_p[slot, :, lane], coef_p[slot, :, lane]), 1)
    if precision == "float64":
        scale = ref.abs().amax(dim=0).clamp_min(1e-300)
        err = float(((ours - ref).abs() / scale).amax())
        gate = {"max_err_over_peak": err, "ok": err < 1e-9,
                "gate": "every value within 1e-9 of its peak"}
    else:
        gate = _gate_columns(ours, ref)
    gate["max_abs_err"] = float((ours - ref).abs().max())
    n_samples = int(w.numel())
    bounds = pol_stage_bounds(
        b, n_samples, precision,
        sample_ops=OPS_PER_SAMPLE["simulation_interblock"]
        - OPS_PER_SAMPLE["simulation"])["derive"]
    return "pol_mesh_derive_vs_plain", dict(
        precision=precision, samples=n_samples, kernel_ms=t_k * 1e3,
        plain_ms=t_p * 1e3, mode_launches=launched,
        same_bad_bits=bool(torch.equal(bits, bits_p)), **bounds,
        **{k: v for k, v in gate.items() if k != "ok"},
        ok=bool(gate["ok"] and torch.equal(bits, bits_p)
                and launched[sk.INTERBLOCK] == 1))


def _launch_counts(fk, sk, pk) -> dict:
    """Every kernel's launch count so far, by kernel and mode."""
    return {"formula": fk.LAUNCHES, "simulation": list(sk.MODE_LAUNCHES),
            "phase": list(sk.PHASE_MODE_LAUNCHES),
            "polarized": pk.LAUNCHES,
            "derive": list(pk.DERIVE_MODE_LAUNCHES)}


def _zero_counts(fk, sk, pk) -> None:
    fk.LAUNCHES = sk.LAUNCHES = pk.LAUNCHES = sk.PHASE_LAUNCHES = 0
    for counts in (sk.MODE_LAUNCHES, sk.PHASE_MODE_LAUNCHES,
                   pk.DERIVE_MODE_LAUNCHES):
        counts[:] = [0] * len(counts)
    for stage in pk.STAGE_LAUNCHES:
        pk.STAGE_LAUNCHES[stage] = 0


def _subset_gate(out, plain, exact) -> dict:
    """A kernel's (I_nu, flags, n_samples) on phase 14's plain rays
    against the plain version's (numpy): float64 exact flags, n_samples
    and NaN sets and I within rtol 1e-9, float32 the statistical gate."""
    import numpy as np
    a, b = out[0][:, 0].cpu().numpy(), plain[0][:, 0]
    gate = statistical_gate(a, b)
    finite = ~(np.isnan(a) | np.isnan(b))
    gate["max_abs_err"] = float(np.abs(a[finite] - b[finite]).max())
    if exact:
        gate["ok"] = bool(
            np.array_equal(out[1].cpu().numpy(), plain[1])
            and np.array_equal(out[2].cpu().numpy(), plain[2])
            and np.array_equal(np.isnan(a), np.isnan(b))
            and np.allclose(a, b, rtol=1e-9, atol=0.0, equal_nan=True))
        gate["gate"] = "exact flags/n_samples/NaN, rtol 1e-9"
    else:
        gate["gate"] = "statistical (bench.py:181-186)"
    return gate


def phase_mesh_blocks(tmp: pathlib.Path, card: str, grids: dict,
                      plain: dict, checks: dict) -> list:
    """Phase 14: Athena++ mesh blocks and the nearest cell at full width.
    ``plain``: phase 3's mesh_plain_subset results by (cell, precision);
    ``checks``: phase 3's mesh checks (their kernel and plain times)."""
    import numpy as np
    import torch
    from blacklight_tpu_torch import pipeline, pipeline_simulation as ps
    from blacklight_tpu_torch.grid import sampling
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk

    res, t_phase = 1024, time.perf_counter()
    t0 = time.perf_counter()
    mesh = {"uniform": mesh_grid("uniform", torch.float32),
            "amr": mesh_grid("amr", torch.float32),
            "single": grids["float32"]}
    grids["mb_amr"] = mesh["amr"]  # phase 18 times its kernels beside it
    emit("mesh_snapshots", seconds=time.perf_counter() - t0, **{
        name: {"blocks": g.n_blocks, "cells": int(g.prim[0].numel()),
               "table_mb": grid_bytes(g) / 1e6,
               "levels": sorted(set(g.levels.tolist()))
               if g.levels is not None else [0]}
        for name, g in mesh.items()})

    # the three cells through pipeline.run, each with every count zeroed
    # just before and read just after
    expect = {"mb_uniform": sampling.BLOCKS, "mb_amr": sampling.INTERBLOCK,
              "nearest": sampling.BLOCKS}
    images, launches = {}, {}
    for cell, mode in expect.items():
        layout, overrides = MESH_CELLS[cell]
        cfg = _mesh_cell_config(cell, "float32")
        cfg.output_file = str(tmp / f"{cell}.npz")
        _zero_counts(fk, sk, pk)
        arrays, run_s = _timed(pipeline.run, cfg, quiet=True, device="cuda",
                               grid=mesh[layout])
        counts = _launch_counts(fk, sk, pk)
        image = arrays["I_nu"]
        ok = (image.shape == (res, res) and np.isfinite(np.nanmax(image))
              and counts["simulation"][mode] > 0
              and sum(counts["simulation"]) == counts["simulation"][mode]
              and not (counts["formula"] or counts["polarized"]
                       or sum(counts["phase"])))
        emit("mesh_main_path", cell=cell, resolution=res, precision="float32",
             integrator="rk4", max_steps=2000, seconds=run_s,
             launches=counts, nan_pixels=int(np.isnan(image).sum()),
             max_I_nu=float(np.nanmax(image)), ok=bool(ok))
        if not ok:
            raise RuntimeError(f"{cell}: the main path did not render through "
                               f"the kernel of its mode: {counts}")
        images[cell], launches[cell] = image, counts["simulation"][mode]

    # each kernel alone in spatial_order, best of 3 in turns with the
    # single-block kernel (phase 7's cell)
    variants = {"single": ("single", {})}
    variants.update({c: MESH_CELLS[c] for c in MESH_CELLS})
    runs = {}
    for name, (layout, overrides) in variants.items():
        cfg = _sim_config(camera_resolution=res, precision="float32",
                          ray_integrator="rk4", ray_max_steps=2000,
                          **overrides)
        args, kwargs = _sim_args(cfg, mesh[layout])
        order = sk.spatial_order(args[0], block=ps.KERNEL_ORDER_BLOCK)
        runs[name] = ((*(a[order].contiguous() for a in args[:3]),
                       *args[3:]), kwargs, args)
    times = {name: [] for name in runs}
    out = {}
    for name, (args, kwargs, _) in runs.items():
        out[name] = sk.render_simulation(*args, **kwargs)  # warm up
    for _ in range(3):
        for name, (args, kwargs, _) in runs.items():
            times[name].append(_timed(sk.render_simulation, *args,
                                      **kwargs)[1])
    single_ms = min(times["single"]) * 1e3
    cells = {}
    for name, (args, kwargs, camera_args) in runs.items():
        layout = variants[name][0]
        mode = sampling.sampling_mode(args[6], args[5].sampler)
        kind = ("simulation", "simulation_blocks",
                "simulation_interblock")[mode]
        if not args[5].sampler.interp:
            kind = "simulation_nearest"
        mean = float(out[name][2].double().mean())
        cell = {"kernel_ms": min(times[name]) * 1e3,
                "kernel_s_runs": times[name], "mode": int(mode),
                "mean_n_samples": mean,
                "over_single": min(times[name]) * 1e3 / single_ms,
                **bound(kind, "rk4", "float32", res * res, mean,
                        in_bytes=grid_bytes(mesh[layout]), out_values=1)}
        if (name, "float32") in plain:
            # the plain version on phase 3's subset of the camera's rays
            pick = torch.arange(0, res * res, PLAIN_STRIDE, device="cuda")
            sub = (*(a[pick].contiguous() for a in camera_args[:3]),
                   *camera_args[3:])
            positions, ref, t_plain = plain[name, "float32"]
            if not np.array_equal(positions, sub[0].cpu().numpy()):
                raise RuntimeError("the plain version traced other rays")
            gate = _subset_gate(sk.render_simulation(*sub, **kwargs), ref,
                                False)
            cell.update(plain_ms=t_plain * 1e3,
                        plain_rays=res * res // PLAIN_STRIDE, **gate)
            if not gate["ok"]:
                raise RuntimeError(f"{name}: kernel disagrees with plain: "
                                   f"{gate}")
        cells[name] = cell
        emit("mesh_timing", cell=name, resolution=res, card=card,
             precision="float32", integrator="rk4",
             order=f"spatial_order {ps.KERNEL_ORDER_BLOCK}", **cell)

    # float64 on the plain subset: each kernel exact against its plain
    # version, and mb-uniform with interblock sampling against the single
    # block (and the phi split, which the reference keeps within
    # MESH_PHI_ATOL of I's peak)
    mesh64 = {"uniform": mesh_grid("uniform", torch.float64),
              "amr": mesh_grid("amr", torch.float64),
              "phi": mesh_grid("phi", torch.float64),
              "phi_single": mesh_grid("phi_single", torch.float64),
              "single": grids["float64"]}
    interblock = MESH_CELLS["mb_uniform_interblock"][1]
    sub64 = {}
    for name, (layout, overrides) in [("single", ("single", {})),
                                      ("phi", ("phi", interblock)),
                                      ("phi_single", ("phi_single", {})),
                                      *MESH_CELLS.items()]:
        cfg = _sim_config(camera_resolution=res, precision="float64",
                          ray_integrator="rk4", ray_max_steps=2000,
                          **overrides)
        args, kwargs = _sim_args(cfg, mesh64[layout])
        pick = torch.arange(0, res * res, PLAIN_STRIDE, device="cuda")
        sub = (*(a[pick].contiguous() for a in args[:3]), *args[3:])
        sub64[name] = sk.render_simulation(*sub, **kwargs)
        if (name, "float64") in plain:
            _, ref, t_plain = plain[name, "float64"]
            gate = _subset_gate(sub64[name], ref, True)
            emit("mesh_kernel_vs_plain_f64", cell=name,
                 rays=res * res // PLAIN_STRIDE, plain_s=t_plain, **gate)
            if not gate["ok"]:
                raise RuntimeError(f"{name}: float64 kernel disagrees with "
                                   f"plain: {gate}")
    against = {}
    for name, one in (("phi", "phi_single"), ("mb_uniform_interblock",
                                              "single"),
                      ("mb_uniform", "single")):
        a = sub64[name][0][:, 0].cpu().numpy()
        i_one = sub64[one][0][:, 0].cpu().numpy()
        same_nan = bool(np.array_equal(np.isnan(a), np.isnan(i_one)))
        both = ~(np.isnan(a) | np.isnan(i_one))
        against[name] = {"same_nan": same_nan,
                         "max_abs_over_peak": float(np.abs(
                             a[both] - i_one[both]).max()
                             / np.nanmax(np.abs(i_one))),
                         "flux_ratio": float(np.nansum(a) / np.nansum(i_one))}
    phi_ok = (against["phi"]["same_nan"]
              and against["phi"]["max_abs_over_peak"] < MESH_PHI_ATOL)
    # float32: the whole images (the same rays in the same order) by the
    # statistical gate's measures
    single = out["single"][0][:, 0].cpu().numpy()
    f32 = {name: statistical_gate(out[name][0][:, 0].cpu().numpy(), single)
           for name in ("mb_uniform_interblock", "mb_uniform")}
    emit("mesh_against_single_block", rays_float64=res * res // PLAIN_STRIDE,
         float64=against, float32=f32, phi_split_ok=bool(phi_ok),
         phi_gate=f"fields without phi structure, {PHI_SPLIT} phi blocks "
                  f"against one: NaN sets, max |delta| < {MESH_PHI_ATOL:g} "
                  "of I's peak (tests/test_loaders.py:262)",
         note="mb-uniform is measured, not gated: the reference's "
              "interblock fraction past a block's upper face reads "
              "x?v(b, n), the next block's first centre in block order "
              "(grid/sampling.py interblock_corners)")
    if not phi_ok:
        raise RuntimeError(f"the phi split disagrees with one block: "
                           f"{against['phi']}")

    # K2.3 and the polarized route once each on mb-amr
    cfg = _mesh_cell_config("mb_amr", "float32")
    cfg.output_file = str(tmp / "mb_amr_phased.npz")
    ps.KERNEL_PHASED = True
    try:
        _zero_counts(fk, sk, pk)
        arrays, phased_s = _timed(pipeline.run, cfg, quiet=True,
                                  device="cuda", grid=mesh["amr"])
        counts = _launch_counts(fk, sk, pk)
    finally:
        ps.KERNEL_PHASED = False
    a, b = arrays["I_nu"], images["mb_amr"]
    same = bool(np.array_equal(np.isnan(a), np.isnan(b))
                and np.array_equal(a[~np.isnan(a)], b[~np.isnan(b)]))
    phase_launches = counts["phase"][sampling.INTERBLOCK]
    emit("mesh_phased_main_path", cell="mb_amr", seconds=phased_s,
         launches=counts, identical_to_monolithic=same)
    if not same or not phase_launches or sum(counts["simulation"]):
        raise RuntimeError(f"phased mb_amr: {counts}, identical {same}")

    phase_kernel = mesh_second_phase(mesh["amr"], checks["phase_plain"])
    emit("mesh_phase_kernel_vs_plain", cell="mb_amr", resolution=res,
         card=card, **phase_kernel)
    if not phase_kernel["ok"]:
        raise RuntimeError(f"mb_amr's second phase: kernel disagrees with "
                           f"plain: {phase_kernel}")

    cfg = _pol_full_config("float32", "rk4", simulation_block_interp=True,
                           output_file=str(tmp / "mb_amr_pol.npz"))
    _zero_counts(fk, sk, pk)
    arrays, pol_s = _timed(pipeline.run, cfg, quiet=True, device="cuda",
                           grid=mesh["amr"])
    counts = _launch_counts(fk, sk, pk)
    derive_launches = counts["derive"][sampling.INTERBLOCK]
    image = arrays["I_nu"]
    ok = (image.shape == (res, res) and np.isfinite(np.nanmax(image))
          and derive_launches > 0 and sum(counts["derive"]) == derive_launches
          and not sum(counts["simulation"]))
    emit("mesh_polarized_main_path", cell="mb_amr", resolution=res,
         precision="float32", seconds=pol_s, launches=counts,
         stage_launches=dict(pk.STAGE_LAUNCHES),
         nan_pixels=int(np.isnan(image).sum()),
         max_I_nu=float(np.nanmax(image)), ok=bool(ok))
    if not ok:
        raise RuntimeError(f"polarized mb_amr: {counts}")
    emit("mesh_phase", seconds=time.perf_counter() - t_phase)

    def entry(name, replaces, n, **fields):
        return {"name": name, "route": "cuda", "source": replaces[0],
                "replaces": replaces[1], "launches": n,
                "library_ms": None, **fields}

    sim = (SIM_KERNEL_SOURCE, SIM_KERNEL_REPLACES)
    kernels = []
    for cell, label in (("mb_uniform", "blocks"), ("mb_amr", "interblock"),
                        ("nearest", "blocks, nearest cell")):
        c = cells[cell]
        kernels.append(entry(
            f"simulation_mode_kernel ({label}; {cell})", sim, launches[cell],
            max_abs_err=c["max_abs_err"], ms=c["kernel_ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], single_block_ms=single_ms))
    ph = phase_kernel
    kernels.append(entry(
        "simulation_phase_mode_kernel (interblock)",
        (SIM_KERNEL_SOURCE, PHASE_REPLACES), phase_launches,
        max_abs_err=ph["max_abs_err"], ms=ph["kernel_ms"],
        plain_ms=ph["plain_ms"], bound_ms=ph["bound_ms"],
        bound_by=ph["bound_by"],
        work=(f"phase 1 (steps {ph['steps']}) of mb_amr at 1024^2, "
              f"{ph['rays']} rays (the plain version on {ph['plain_rays']} "
              "of them)")))
    dv = checks["derive"]
    kernels.append(entry(
        "polarized_derive_mode_kernel (interblock)",
        (POL_KERNEL_SOURCE, POL_KERNEL_REPLACES), derive_launches,
        max_abs_err=dv["max_abs_err"], ms=dv["kernel_ms"],
        plain_ms=dv["plain_ms"], bound_ms=dv["bound_ms"],
        bound_by=dv["bound_by"],
        work=(f"mb_amr at 1024^2, 4,096 rays (every {PLAIN_STRIDE}-th in "
              f"spatial_order), {dv['samples']} samples")))
    return kernels


def mesh_second_phase(grid, phase_plain) -> dict:
    """The phase kernel of interblock sampling on mb-amr's second phase
    (float32 rk4, steps KERNEL_PHASE_STEPS to twice that) over every ray
    alive after the first, best of 3, beside its bound; held to phase 3's
    plain version (``phase_plain``, mesh_phase_plain_subset) on its
    MESH_PHASE_RAYS rays from the same carried state, which it checks
    first."""
    import numpy as np
    from blacklight_tpu_torch.pipeline_simulation import KERNEL_PHASE_STEPS
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    pick_np, carried, ref, t_plain, alive = phase_plain
    args, _ = _sim_args(_mesh_cell_config("mb_amr", "float32"), grid)
    steps = KERNEL_PHASE_STEPS
    carry0, index, phase = _first_phase(args, "rk4", steps)
    pick = _phase_pick(index)
    if not (index.numel() == alive
            and np.array_equal(pick.cpu().numpy(), pick_np)
            and all(np.array_equal(t[..., pick.long()].cpu().numpy(), c)
                    for t, c in zip(carry0, carried))):
        raise RuntimeError("mb_amr's first phase carried another state than "
                           "phase 3's")
    times = []
    for _ in range(3):
        carry = sk.SimCarry(*(t.clone() for t in carry0))
        times.append(_timed(sk.render_simulation_phase, carry, index, steps,
                            steps, *phase)[1])
    samples = int((carry.n_samp[index.long()]
                   - carry0.n_samp[index.long()]).sum())
    gate = _subset_gate(sk.finish_rays(carry, pick, args[3], args[9],
                                       args[5].sampler.fallback_nan),
                        ref, False)
    return {"steps": f"{steps}-{2 * steps - 1}",
            "kernel_ms": min(times) * 1e3, "kernel_s_runs": times,
            "plain_ms": t_plain * 1e3, "rays": alive,
            "plain_rays": int(pick.numel()), "samples": samples,
            **phase_bound(alive, samples, "float32", grid_bytes(grid),
                          kind="simulation_interblock"), **gate}


# Phase 15: the auxiliary image planes' scan route (ROADMAP A.5)

# Every plane of the scan route, as config attributes.
AUX_PLANES = dict(image_time=True, image_length=True, image_lambda=True,
                  image_emission=True, image_tau=True, image_lambda_ave=True,
                  image_emission_ave=True, image_tau_int=True,
                  image_crossings=True)
# The polarized case's planes.
AUX_POL_PLANES = dict(image_tau=True, image_emission_ave=True,
                      image_crossings=True)
# Every AUX_EXACT_STRIDE-th ray of the 128^2 exact case also goes through
# the route on the CPU.
AUX_EXACT_STRIDE = 4
# Share of the full width's subset rays whose crossings must equal the
# CPU route's.
AUX_CROSSINGS_SHARE = 0.99
# Rays and steps of the warm call before the full-width render.
AUX_WARM_RAYS = 4096
AUX_WARM_STEPS = 50


def _aux_full_config(**overrides):
    """Phase 15's main path: phase 7's cell with every plane on."""
    return _sim_config(**{"camera_resolution": 1024, "precision": "float32",
                          "ray_integrator": "rk4", "ray_max_steps": 2000,
                          **AUX_PLANES, **overrides})


def _aux_exact_config(**overrides):
    """The 128^2 float64 rk4 case on mock_small.athdf."""
    return _sim_config(**{"camera_resolution": 128, "precision": "float64",
                          "ray_integrator": "rk4", **overrides})


def _aux_pol_config(**overrides):
    """The polarized case: golden_polarized_rk4_32.input at 64^2,
    float64 rk4. At the 400 steps of 0.04 of phase 3's polarized cases
    its Q and U on the card part from the CPU's by 7e-9 (the Faraday
    rotation over longer steps), past this case's 1e-9; at the golden's
    2000 steps of 0.01 by 4e-10."""
    return _pol_config(**{"camera_resolution": 64, "precision": "float64",
                          "ray_integrator": "rk4", **overrides})


def plane_columns(out) -> dict:
    """A render's outputs (one frequency) as numpy columns (B,) under
    their npz names (output.assemble_npz_arrays), "_flags" and
    "_n_samples" included."""
    import numpy as np
    from blacklight_tpu_torch.constants import CELL_VALUE_NAMES
    cols = {}
    for key, value in out.items():
        v = value.cpu().numpy() if hasattr(value, "cpu") else np.asarray(value)
        if key in ("lambda_ave", "emission_ave", "tau_int"):
            for c, name in enumerate(CELL_VALUE_NAMES):
                cols[f"{key}_{name}"] = v[:, 0, c]
        else:
            cols[key] = v[:, 0] if v.ndim == 2 else v
    return cols


def _scan(cfg, device, grid=None, rays=None) -> tuple:
    """cfg through the simulation renderer on ``device`` (its own camera
    rays, or ``rays`` there): (plane_columns of the output, seconds)."""
    from blacklight_tpu_torch.pipeline_simulation import (
        make_simulation_renderer)
    render_fn, _, own, _, _ = make_simulation_renderer(cfg, device=device,
                                                       grid=grid)
    rays = rays or (own.positions, own.directions, own.momentum_factors)
    out, seconds = _timed(render_fn, *rays)
    return plane_columns(out), seconds, render_fn.route


def _card_rays(cfg, stride=1) -> tuple:
    """Every ``stride``-th of the camera rays of ``cfg`` built on the card,
    on the host: the rays the CPU route takes."""
    args, _ = _sim_args(cfg)
    return tuple(a[::stride].contiguous().cpu() for a in args[:3])


def aux_full_width_cpu() -> tuple:
    """Phase 3: phase 15's route on the CPU on every PLAIN_STRIDE-th ray
    of its camera (built on the card) through FULL_GRID on the host:
    (plane_columns, seconds, route, the rays' positions). Its time is not
    comparable with a lone run."""
    import torch
    torch.set_num_threads(1)
    cfg = _aux_full_config()
    rays = _card_rays(cfg, PLAIN_STRIDE)
    grid = full_width_snapshot(torch.float32, device=torch.device("cpu"))
    return (*_scan(cfg, "cpu", grid, rays), rays[0].numpy())


def aux_exact_card() -> dict:
    """Phase 3: the 128^2 exact case on the card: the route's outputs with
    every plane and the kernel route's (no plane), each with seconds."""
    route = _scan(_aux_exact_config(**AUX_PLANES), "cuda")
    kernel = _scan(_aux_exact_config(), "cuda")
    return {"route": route, "kernel": kernel}


def aux_exact_cpu() -> tuple:
    """Phase 3: the 128^2 exact case's route on the CPU on every
    AUX_EXACT_STRIDE-th ray of the card's camera."""
    import torch
    torch.set_num_threads(1)
    cfg = _aux_exact_config(**AUX_PLANES)
    return _scan(cfg, "cpu", rays=_card_rays(cfg, AUX_EXACT_STRIDE))


def aux_pol_card() -> dict:
    """Phase 3: the polarized case on the card, the scan route with
    AUX_POL_PLANES and the K3.1 route (no plane)."""
    route = _scan(_aux_pol_config(**AUX_POL_PLANES), "cuda")
    kernel = _scan(_aux_pol_config(), "cuda")
    return {"route": route, "kernel": kernel}


def aux_pol_cpu() -> tuple:
    """Phase 3: the polarized case's route on the CPU on the card's
    camera rays."""
    import torch
    torch.set_num_threads(1)
    cfg = _aux_pol_config(**AUX_POL_PLANES)
    return _scan(cfg, "cpu", rays=_card_rays(cfg))


def _aux_run(cfg) -> tuple:
    """pipeline.run of ``cfg`` on the card, in a scratch directory: (the
    arrays, seconds, kernel launches)."""
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    with tempfile.TemporaryDirectory(dir=ROOT / "build" / "kernels") as tmp:
        cfg.output_file = str(pathlib.Path(tmp) / "golden.npz")
        _zero_counts(fk, sk, pk)
        arrays, seconds = _timed(pipeline.run, cfg, quiet=True,
                                 device="cuda")
        launches = _launch_counts(fk, sk, pk)
    return arrays, seconds, launches


def aux_golden_formula() -> dict:
    """Phase 3: golden_formula_aux_32 (dp, 7000 steps) through
    pipeline.run on the card, at tests/test_formula_e2e.py:38-69's
    tolerances."""
    import numpy as np
    arrays, seconds, launches = _aux_run(
        _config("golden_formula_aux_32.input"))
    gold = np.load(FIXTURES / "golden_formula_aux_32.npz")
    result, ok = {}, True
    for name, tol in (("time", 2e-2), ("length", 2e-2), ("lambda", 2e-2),
                      ("emission", 1e-2)):
        g = gold[name]
        rel = np.abs(arrays[name] - g) / (np.abs(g)
                                          + np.nanmax(np.abs(g)) * 1e-8)
        result[name] = {"max_rel": float(np.nanmax(rel)), "tol": tol}
        ok = ok and np.nanmax(rel) < tol
    share = float(np.mean(arrays["crossings"] != gold["crossings"]))
    result["crossings"] = {"share_differing": share, "tol": 0.02}
    tau_ok = bool(np.allclose(arrays["tau"], gold["tau"], rtol=1e-7,
                              atol=1e-300))
    result["tau"] = {"identically_equal_to_gold": tau_ok}
    return {"name": "golden_formula_aux_32", "seconds": seconds,
            "launches": launches, **result,
            "ok": bool(ok and share < 0.02 and tau_ok)}


def aux_golden_sim_tau() -> dict:
    """Phase 3: golden_sim_rk4_32.input with image_tau through
    pipeline.run on the card against golden_sim_tau_rk4_32 (rtol 1e-8,
    tests/test_simulation_e2e.py:119-123)."""
    import numpy as np
    arrays, seconds, launches = _aux_run(_sim_config(image_tau=True))
    gold = np.load(FIXTURES / "golden_sim_tau_rk4_32.npz")["tau"]
    ours = arrays["tau"]
    rel = np.abs(ours - gold) / np.abs(gold)
    ok = bool(np.array_equal(np.isnan(ours), np.isnan(gold))
              and np.allclose(ours, gold, rtol=1e-8, atol=0.0,
                              equal_nan=True))
    return {"name": "golden_sim_tau_rk4_32", "seconds": seconds,
            "launches": launches, "max_rel": float(np.nanmax(rel)),
            "gate": "NaN sets, rtol 1e-8", "ok": ok}


# Phase 15's jobs in phase 3's pool, by name.
AUX_JOBS = (("pol_card", aux_pol_card), ("golden_formula", aux_golden_formula),
            ("pol_cpu", aux_pol_cpu), ("exact_card", aux_exact_card),
            ("full_cpu", aux_full_width_cpu), ("exact_cpu", aux_exact_cpu),
            ("golden_sim_tau", aux_golden_sim_tau))


def plane_gate(a, b) -> dict:
    """The statistical gate on one plane column; equal columns (an
    all-zero plane among them) pass as they are."""
    import numpy as np
    if np.array_equal(a, b, equal_nan=True):
        return {"identical": True, "ok": True}
    return statistical_gate(a, b)


def exact_columns(ours: dict, ref: dict, rtol: float, floors=None) -> dict:
    """Columns of two runs on the same rays: flags, n_samples, NaN sets
    and crossings equal, the rest within ``rtol`` of ``ref`` over an
    absolute floor of 1e-14 of each column's peak (``floors`` may set a
    column's floor and rtol: {key: (floor, rtol)})."""
    import numpy as np
    result, ok = {}, True
    for key, b in ref.items():
        a = ours[key]
        if b.dtype.kind != "f" or key == "crossings":
            same = bool(np.array_equal(a, b))
            result[key] = {"equal": same}
            ok = ok and same
            continue
        peak = float(np.nanmax(np.abs(b))) if np.isfinite(b).any() else 0.0
        floor, tol = (floors or {}).get(key, (1e-14 * peak, rtol))
        with np.errstate(invalid="ignore", divide="ignore"):
            rel = np.abs(a - b) / (np.abs(b) + floor)
        worst = float(np.nanmax(rel)) if np.isfinite(rel).any() else 0.0
        same_nan = bool(np.array_equal(np.isnan(a), np.isnan(b)))
        result[key] = {"max_rel": worst, "rtol": tol, "same_nan": same_nan}
        ok = ok and same_nan and worst <= tol
    result["ok"] = bool(ok)
    return result


def phase_aux_planes(tmp: pathlib.Path, card: str, grids: dict, mono: dict,
                     simulation: dict, aux: dict) -> None:
    """Phase 15 (the module's docstring); ``mono`` and ``simulation``
    are phase 7's arrays and kernels-line entry, ``aux`` phase 3's
    AUX_JOBS results."""
    import numpy as np
    import torch
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import geodesic
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    from blacklight_tpu_torch.pipeline_simulation import (
        make_simulation_renderer)

    cfg = _aux_full_config(output_file=str(tmp / "aux_full_width.npz"))
    res = cfg.camera_resolution
    render_fn, _, rays, _, _ = make_simulation_renderer(
        _aux_full_config(ray_max_steps=AUX_WARM_STEPS), device="cuda",
        grid=grids["float32"])
    _, t_warm = _timed(render_fn, *(t[:AUX_WARM_RAYS] for t in (
        rays.positions, rays.directions, rays.momentum_factors)))
    route = render_fn.route
    subset_positions = rays.positions[::PLAIN_STRIDE].cpu().numpy()
    del render_fn, rays
    cpu_cols, cpu_s, cpu_route, cpu_positions = aux["full_cpu"]
    if route != "scan" or cpu_route != "scan":
        raise RuntimeError(f"the aux planes took the {route} route")
    if not np.array_equal(subset_positions, cpu_positions):
        raise RuntimeError("phase 3's CPU route ran on other rays")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    steps = [geodesic.LOCK_STEPS]
    _zero_counts(fk, sk, pk)
    arrays, wall = _timed(pipeline.run, cfg, quiet=True, device="cuda",
                          grid=grids["float32"])
    launches = _launch_counts(fk, sk, pk)
    steps[0] = geodesic.LOCK_STEPS - steps[0]
    peak = torch.cuda.max_memory_allocated() - base
    moved = [v for v in launches.values()
             if (sum(v) if isinstance(v, list) else v)]
    image = arrays["I_nu"]
    if moved or image.shape != (res, res) \
            or not np.isfinite(np.nanmax(image)):
        raise RuntimeError(f"the aux route launched a kernel or its image "
                           f"is wrong: {launches}")
    kernel_gate = statistical_gate(image.ravel(), mono["I_nu"].ravel())
    emit("aux_main_path", resolution=res, precision="float32",
         integrator="rk4", max_steps=2000, planes=sorted(AUX_PLANES),
         route=route, card=card, seconds=wall, steps=steps[0],
         ms_per_step=wall / steps[0] * 1e3, warm_call_rays=AUX_WARM_RAYS,
         warm_call_steps=AUX_WARM_STEPS, warm_call_s=t_warm, peak_device_bytes=peak, launches=launches,
         phase7_kernel_ms=simulation["ms"],
         route_over_kernel=wall * 1e3 / simulation["ms"],
         i_nu_vs_kernel_image=kernel_gate,
         nan_pixels=int(np.isnan(image).sum()))

    ours = {k: arrays[k].ravel()[::PLAIN_STRIDE] for k in cpu_cols
            if not k.startswith("_")}
    gates = {}
    for key, a in ours.items():
        b = cpu_cols[key]
        if key == "crossings":
            share = float(np.mean(a == b))
            gates[key] = {"share_equal": share,
                          "ok": share >= AUX_CROSSINGS_SHARE}
        else:
            gates[key] = plane_gate(a, b)
    subset_ok = all(g["ok"] for g in gates.values())
    emit("aux_vs_cpu_route", rays=int(subset_positions.shape[0]),
         cpu_route_s=cpu_s, workers=WORKERS, gates=gates,
         ok=bool(subset_ok))

    exact_card, exact_cpu = aux["exact_card"], aux["exact_cpu"]
    route_cols, t_route, _ = exact_card["route"]
    kernel_cols, t_kernel, _ = exact_card["kernel"]
    vs_kernel = exact_columns(
        {k: route_cols[k] for k in ("I_nu", "_flags", "_n_samples")},
        {k: kernel_cols[k] for k in ("I_nu", "_flags", "_n_samples")},
        1e-9)
    stride = {k: v[::AUX_EXACT_STRIDE] for k, v in route_cols.items()}
    vs_cpu = exact_columns(stride, exact_cpu[0], 1e-9)
    emit("aux_exact_128", precision="float64", integrator="rk4",
         route_s=t_route, kernel_route_s=t_kernel, cpu_route_s=exact_cpu[1],
         cpu_rays=int(exact_cpu[0]["_flags"].shape[0]),
         vs_kernel_route=vs_kernel, vs_cpu_route=vs_cpu)

    goldens = [aux["golden_formula"], aux["golden_sim_tau"]]
    for golden in goldens:
        golden["ok"] = golden["ok"] and not any(
            (sum(v) if isinstance(v, list) else v)
            for v in golden["launches"].values())
        emit("aux_golden", **golden)

    pol_card, (pol_cpu, t_pol_cpu, _) = aux["pol_card"], aux["pol_cpu"]
    pol_cols, t_pol, _ = pol_card["route"]
    pol_kernel, t_pol_kernel, _ = pol_card["kernel"]
    i_scale = float(np.nanmax(np.abs(pol_cpu["I_nu"])))
    floors = {k: (max(float(np.nanmax(np.abs(pol_cpu[k]))) * 1e-4,
                      i_scale * 1e-8), V_EXACT_RTOL if k == "V_nu" else 1e-9)
              for k in STOKES}
    pol_vs_cpu = exact_columns(pol_cols, pol_cpu, 1e-9, floors)
    pol_vs_kernel = polarized_gate(
        {k: pol_cols[k][:, None] for k in STOKES},
        {k: pol_kernel[k][:, None] for k in STOKES}, exact=True)
    pol_ok = pol_vs_kernel["ok"] and bool(
        np.array_equal(pol_cols["_flags"], pol_kernel["_flags"])
        and np.array_equal(pol_cols["_n_samples"], pol_kernel["_n_samples"]))
    emit("aux_polarized", resolution=64, precision="float64",
         integrator="rk4", planes=sorted(AUX_POL_PLANES), route_s=t_pol,
         kernel_route_s=t_pol_kernel, cpu_route_s=t_pol_cpu,
         vs_cpu_route=pol_vs_cpu, vs_kernel_route=pol_vs_kernel)

    failed = [name for name, ok in (
        ("I_nu against phase 7's kernel image", kernel_gate["ok"]),
        ("full width against the CPU route", subset_ok),
        ("128^2 against the kernel route", vs_kernel["ok"]),
        ("128^2 against the CPU route", vs_cpu["ok"]),
        *((g["name"], g["ok"]) for g in goldens),
        ("polarized against the CPU route", pol_vs_cpu["ok"]),
        ("polarized against the K3.1 route", pol_ok)) if not ok]
    if failed:
        raise RuntimeError(f"phase 15 failed: {failed}")


def grid_bytes(grid) -> int:
    """Bytes the kernels read of a snapshot: each block's (k, j, i, 8)
    float32 table and coordinates, of many blocks their bounds, and of an
    FMKS grid its inverse table."""
    nvar, n_b, n_k, n_j, n_i = grid.prim.shape
    item = grid.x1f.element_size()
    per_block = 32 * n_k * n_j * n_i + item * (2 * (n_i + n_j + n_k) + 3)
    fmks = 0 if grid.sks_map is None else grid.sks_map.numel() * item
    return n_b * per_block + (6 * item * n_b if n_b > 1 else 0) + fmks


def bound(kernel, integrator, precision, rays, mean_samples, *, in_bytes,
          out_values, frequencies=1, tangents=0, extra_out_bytes=8) -> dict:
    """The least time the card could take for a launch's work: the larger
    of its bytes over HBM_BYTES_PER_S (rays, momentum factors and
    ``in_bytes`` read once; ``out_values`` values of the working type and
    ``extra_out_bytes`` per ray written once) and its operations over the
    type's peak (mean samples per ray standing in for the steps)."""
    item = 4 if precision == "float32" else 8
    n_bytes = rays * (9 * item + out_values * item + extra_out_bytes) + in_bytes
    per_sample = OPS_PER_STEP[integrator] + OPS_PER_SAMPLE[kernel]
    if kernel == "formula":
        per_sample += FORMULA_OPS_PER_FREQUENCY * (frequencies - 1) \
            + FORMULA_OPS_PER_TANGENT * frequencies * tangents
    if kernel in ("polarized", "polarized_fmks", "polarized_cks",
                  "polarized_code_kappa"):
        per_sample += POL_OPS_PER_FREQUENCY * frequencies
    if kernel == "polarized_mixture":
        per_sample += (POL_OPS_PER_FREQUENCY + POL_MIX_OPS_PER_FREQUENCY) \
            * frequencies
    ops = rays * mean_samples * per_sample
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[precision]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bound_ops": ops, "bound_bytes": n_bytes}


def _pol_config(name="golden_polarized_rk4_32.input", **overrides):
    return _sim_config(name, **overrides)


def _pol_args(cfg, grid=None):
    """The polarized renderer's rays, kernel arguments and keywords on the
    card, and its camera geometry."""
    from blacklight_tpu_torch.pipeline_simulation import (
        make_simulation_renderer)
    render_fn, geom, rays, freqs, mass_msun = make_simulation_renderer(
        cfg, device="cuda", grid=grid)
    args = (rays.positions, rays.directions, rays.momentum_factors,
            *render_fn.kernel_args)
    return args, dict(render_fn.kernel_kwargs), geom


def _pol_stokes(out, args, geom, fallback_nan) -> dict:
    """Camera-frame I, Q, U, V (B, F) on the host from render_polarized's
    output, NaN-poisoned as the pipeline does."""
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    nn_re, nn_im, flags, _, bad = out
    positions, directions, _, freqs, params = args[:5]
    image = pk.poisoned_stokes(nn_re, nn_im, flags, bad, positions,
                               directions, freqs, params, geom, args[-1],
                               fallback_nan)
    return {k: v.cpu().numpy() for k, v in image.items()}


def polarized_gate(ours: dict, ref: dict, exact: bool) -> dict:
    """Kernel against plain on identical rays, each frequency scaled by its
    own peak of I. exact (rk4/rk2 float64): identical NaN sets and I, Q, U
    each within max rel 1e-7 with the per-channel floor of
    tests/test_polarized_e2e.py:40 (the channel's peak x 1e-4, at least
    I's peak x 1e-8); V within max rel V_EXACT_RTOL with that floor and
    |delta V| / max|I| below 1e-9. The Faraday rotation amplifies rounding
    into V most: a 1e-15 relative change of the camera rays moves the
    plain version's own V by 1e-8 (8^2, CPU), and the card measured
    7.0e-6 at 64^2 (PERF.md). Otherwise (dp, float32): identical NaN
    sets; I, Q, U, V with |delta| / max|I| below 1e-3 at the 99.5th
    percentile and 1e-2 at the maximum; I's flux within 1e-3. bench.py's
    share of pixels past 1e-3 relative is recorded, not gated: float32
    polarized transfer rounds differently pixel by pixel wherever the
    Faraday rotation is deep, in the plain version as in the kernel
    (truth_gate holds both to the float64 plain version; PERF.md)."""
    import numpy as np
    i_scale = np.nanmax(np.abs(ref["I_nu"]), axis=0)
    out = {"same_nan": all(bool(np.array_equal(np.isnan(ours[k]),
                                               np.isnan(ref[k])))
                           for k in ref)}
    ok = out["same_nan"]
    for k in STOKES:
        a, b = ours[k], ref[k]
        floor = np.maximum(np.nanmax(np.abs(b), axis=0) * 1e-4,
                           i_scale * 1e-8)
        rel = np.abs(a - b) / (np.abs(b) + floor)
        frac = np.abs(a - b) / i_scale
        out[k] = {"max_rel_floor": float(np.nanmax(rel)),
                  "frac_p99_5": float(np.nanpercentile(frac, 99.5)),
                  "frac_max": float(np.nanmax(frac))}
        if exact:
            ok = ok and out[k]["max_rel_floor"] <= (
                V_EXACT_RTOL if k == "V_nu" else 1e-7)
            if k == "V_nu":
                ok = ok and out[k]["frac_max"] <= 1e-9
        else:
            ok = ok and out[k]["frac_p99_5"] < 1e-3 and out[k]["frac_max"] < 1e-2
    if not exact:
        for f in range(ref["I_nu"].shape[1]):
            gate = statistical_gate(ours["I_nu"][:, f], ref["I_nu"][:, f])
            del gate["ok"]
            out[f"I_statistical_{f}"] = gate
            ok = ok and gate["same_nan"] and gate["flux_rel"] < 1e-3
    out["max_abs_err"] = max(float(np.nanmax(np.abs(ours[k] - ref[k])))
                             for k in ref)
    out["ok"] = bool(ok)
    return out


def truth_gate(ours: dict, ref: dict, truth: dict) -> dict:
    """The float32 kernel (``ours``) and the float32 plain version
    (``ref``) each against the plain version in float64 (``truth``) on the
    same rays, as tests/test_pallas_polarized.py:99-119 holds the TPU
    kernel's coupling: per frequency and channel, |x - truth| over that
    frequency's peak |I| on the pixels finite in all three; the kernel's
    max and mean within TRUTH_FACTOR times the plain version's plus
    TRUTH_SLACK."""
    import numpy as np
    out, ok = {}, True
    for f in range(truth["I_nu"].shape[1]):
        scale = float(np.nanmax(np.abs(truth["I_nu"][:, f])))
        finite = np.all([np.isfinite(x[k][:, f]) for x in (ours, ref, truth)
                         for k in STOKES], axis=0)
        out[f"pixels_{f}"] = int(finite.sum())
        if not finite.any():
            ok = False
            continue
        for k in STOKES:
            t = truth[k][finite, f]
            e_k = np.abs(ours[k][finite, f] - t) / scale
            e_p = np.abs(ref[k][finite, f] - t) / scale
            entry = {"kernel_max": float(e_k.max()),
                     "plain_max": float(e_p.max()),
                     "kernel_mean": float(e_k.mean()),
                     "plain_mean": float(e_p.mean())}
            ok = ok and all(entry[f"kernel_{s}"] <= TRUTH_FACTOR
                            * entry[f"plain_{s}"] + TRUTH_SLACK
                            for s in ("max", "mean"))
            out[f"{k}_{f}"] = entry
    out["ok"] = bool(ok)
    return out


def _pol_truth(cfg64, args, grid=None) -> dict:
    """Camera-frame Stokes of the plain version in float64 (``cfg64``;
    ``grid`` the float64 snapshot, None reads cfg64's) on the float32 rays
    and frequencies of ``args`` (a render_polarized argument tuple),
    widened, with its log_j_scale."""
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    args64, kwargs, geom = _pol_args(cfg64, grid)
    args64 = (*(a.double() for a in args[:4]), *args64[4:-1], args[-1])
    return _pol_stokes(pk.render_polarized_reference(*args64, **kwargs),
                       args64, geom, True)


def _pol_case_config(integrator, precision, split, nf):
    """Phase 3's polarized case: 64^2, 400 steps of 0.04; two or more
    frequencies log-spaced over 150-460 GHz."""
    from blacklight_tpu_torch.constants import FrequencySpacing
    overrides = dict(camera_resolution=64, ray_integrator=integrator,
                     precision=precision, ray_step=0.04, ray_max_steps=400,
                     image_rotation_split=split)
    if nf > 1:
        overrides.update(image_num_frequencies=nf,
                         image_frequency_start=1.5e11,
                         image_frequency_end=4.6e11,
                         image_frequency_spacing=FrequencySpacing.log)
    return _pol_config(**overrides)


def check_polarized(integrator, precision, split, nf) -> tuple:
    """The polarized kernel against its plain version, 64^2; float32 (and
    dp) also against the plain version in float64 on the same rays."""
    import torch
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    cfg = _pol_case_config(integrator, precision, split, nf)
    args, kwargs, geom = _pol_args(cfg)
    out_k, t_k = _timed(pk.render_polarized, *args, **kwargs)
    out_p, t_p = _timed(pk.render_polarized_reference, *args, **kwargs)
    exact = precision == "float64" and integrator != "dp"
    ours = _pol_stokes(out_k, args, geom, True)
    ref = _pol_stokes(out_p, args, geom, True)
    gate = polarized_gate(ours, ref, exact)
    same_flags = torch.equal(out_k[2].cpu(), out_p[2].cpu())
    same_ns = torch.equal(out_k[3].cpu(), out_p[3].cpu())
    ok = gate["ok"] and (same_flags and same_ns if exact else True)
    result = dict(
        integrator=integrator, precision=precision, rotation_split=split,
        frequencies=nf, rays=int(args[0].shape[0]), kernel_s=t_k,
        plain_s=t_p, same_flags=same_flags, same_n_samples=same_ns,
        max_n_samples=int(out_p[3].max()),
        gate=("exact flags/n_samples/NaN, max rel 1e-7 with floor" if exact
              else "NaN sets, I flux, IQUV frac of max I per frequency; "
              "kernel within 3x the plain version's error to float64"),
        **{k: v for k, v in gate.items() if k != "ok"})
    if precision == "float32":
        cfg64 = _pol_case_config(integrator, "float64", split, nf)
        truth, result["truth_s"] = _timed(_pol_truth, cfg64, args)
        result["float64_truth"] = truth_gate(ours, ref, truth)
        ok = ok and result["float64_truth"]["ok"]
    result["ok"] = bool(ok)
    return "pol_kernel_vs_plain", result


def _pol_full_config(precision, integrator, **overrides):
    """Phase 9's configuration: 1024^2, 2000 steps, no rotation split."""
    return _pol_config(camera_resolution=1024, precision=precision,
                       ray_integrator=integrator, ray_max_steps=2000,
                       image_rotation_split=False, **overrides)


def _plain_subset(args):
    """Phase 9's plain-version rays: every PLAIN_STRIDE-th of ``args``."""
    import torch
    pick = torch.arange(0, args[0].shape[0], PLAIN_STRIDE,
                        device=args[0].device)
    return pick, (*(a[pick].contiguous() for a in args[:3]), *args[3:])


def pol_full_width_truth() -> tuple:
    """The plain version in float64 on phase 9's float32 plain-version
    rays (widened), through the float64 snapshot, on one host core (on the
    card it took 2.6x as long in phase 3's pool, PERF.md): (their
    positions, Stokes)."""
    import torch
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    torch.set_num_threads(1)
    # the camera's rays do not depend on the snapshot: cfg's small one
    # stands in for it here
    cfg = _pol_full_config("float32", "rk4")
    card_args, _, _ = _pol_args(cfg)
    sub, kwargs, geom = _host_subset(
        cfg, card_args, full_width_snapshot(torch.float64,
                                            torch.device("cpu")),
        PLAIN_STRIDE, _pol_full_config("float64", "rk4"))
    del card_args
    out = pk.render_polarized_reference(*sub, **kwargs)
    return sub[0].numpy(), _pol_stokes(out, sub, geom, True)


def pol_full_width_plain() -> tuple:
    """The plain version in float32 on phase 9's plain-version rays (every
    PLAIN_STRIDE-th of its 1024^2 bundle in camera order), through the
    float32 snapshot: (their positions, Stokes, seconds). Run in phase 3's
    pool, beside the float64 run on the same rays."""
    import torch
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    args, kwargs, geom = _pol_args(_pol_full_config("float32", "rk4"),
                                   full_width_snapshot(torch.float32))
    _, sub = _plain_subset(args)
    out, t_plain = _timed(pk.render_polarized_reference, *sub, **kwargs)
    return sub[0].cpu().numpy(), _pol_stokes(out, sub, geom, True), t_plain


def phase_pol_goldens(tmp: pathlib.Path):
    import numpy as np
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    tols = {"I_nu": 1e-8, "Q_nu": 1e-6, "U_nu": 1e-7, "V_nu": 1e-6}
    # tests/test_simulation_e2e.py:104-114
    mix_tols = {"I_nu": 1e-7, "Q_nu": 1e-3, "U_nu": 1e-3, "V_nu": 1e-3}
    for name, exact in (("golden_polarized_rk4_32", True),
                        ("golden_polarized_32", False),
                        ("golden_plasma_mix_pol_rk4_32", "mix")):
        cfg = _pol_config(f"{name}.input",
                          output_file=str(tmp / f"{name}.npz"))
        before = pk.LAUNCHES, pk.DERIVE_MIXTURE_LAUNCHES
        arrays = pipeline.run(cfg, quiet=True, device="cuda")
        launched = pk.LAUNCHES - before[0]
        mixture = pk.DERIVE_MIXTURE_LAUNCHES - before[1]
        gold = np.load(FIXTURES / f"{name}.npz")
        i_scale = float(np.nanmax(np.abs(gold["I_nu"])))
        ok = launched > 0 and (mixture > 0) == (exact == "mix")
        result = {"mixture_derive_launches": mixture}
        for k in ("I_nu", "Q_nu", "U_nu", "V_nu"):
            ours, g = arrays[k], gold[k]
            if exact == "mix":
                rel = float(np.nanmax(np.abs(ours - g)
                                      / (np.abs(g) + i_scale * 1e-8)))
                result[k] = {"max_rel": rel, "tol": mix_tols[k]}
                ok = ok and rel < mix_tols[k] and bool(np.array_equal(
                    np.isnan(ours), np.isnan(g)))
            elif exact:
                floor = max(float(np.nanmax(np.abs(g))) * 1e-4, i_scale * 1e-8)
                rel = float(np.nanmax(np.abs(ours - g) / (np.abs(g) + floor)))
                result[k] = {"max_rel_floor": rel, "tol": tols[k]}
                ok = ok and rel < tols[k]
            elif k == "I_nu":
                rel = float(np.nanmax(np.abs(ours - g)
                                      / (np.abs(g) + i_scale * 1e-8)))
                result[k] = {"max_rel": rel, "tol": 6e-2}
                ok = ok and rel < 6e-2
            else:
                frac = np.abs(ours - g) / i_scale
                result[k] = {"mean_frac": float(np.nanmean(frac)),
                             "max_frac": float(np.nanmax(frac)),
                             "tol": [5e-3, 1e-1]}
                ok = ok and np.nanmean(frac) < 5e-3 and np.nanmax(frac) < 1e-1
        emit("pol_golden", name=name, launches=launched,
             gate=("tests/test_simulation_e2e.py:104-114" if exact == "mix"
                   else "tests/test_polarized_e2e.py:28-42" if exact
                   else "tests/test_polarized_e2e.py:53-61"),
             **result, ok=bool(ok))
        if not ok:
            raise RuntimeError(f"golden {name} failed: {result}")


def pol_stage_bounds(rays, samples, precision, frequencies=1,
                     sample_ops=0) -> dict:
    """Each kernel of the polarized route with its own bound: the bytes
    of its own inputs and outputs (rays, samples, records, coherency
    components) against its share of the operations (``samples`` stored
    samples in all; ``sample_ops`` more a sample for the derive kernel's
    grid sample)."""
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    item = 4 if precision == "float32" else 8
    sample = pk.SAMPLE_VALUES * item
    record = (pk.GEOMETRY_VALUES + pk.COEFFICIENT_VALUES * frequencies) * item
    chain_ops = POL_CHAIN_OPS_PER_FREQUENCY * frequencies
    work = {
        "trace": (rays * (9 * item + 8) + samples * sample,
                  samples * OPS_PER_STEP["rk4"]),
        "derive": (samples * (sample + record) + rays * 2 * item,
                   samples * (OPS_PER_SAMPLE["polarized"] + sample_ops
                              + POL_OPS_PER_FREQUENCY * frequencies
                              - chain_ops)),
        "chain": (samples * record + rays * (16 * frequencies * item + 4),
                  samples * chain_ops),
    }
    out = {}
    for stage, (n_bytes, ops) in work.items():
        t_bytes = n_bytes / HBM_BYTES_PER_S
        t_ops = ops / PEAK_OPS_PER_S[precision]
        out[stage] = {"bound_ms": max(t_bytes, t_ops) * 1e3,
                      "bound_by": "bytes" if t_bytes > t_ops
                      else "operations"}
    return out


def _gate_columns(ours, plain) -> dict:
    """The float32 gate of polarized_gate on value columns (N, V): each
    value's |delta| over its column's peak, past 1e-3 for fewer than
    0.5 % of the values (its 99.5th percentile below 1e-3) and below
    1e-2 at the maximum."""
    import torch
    if not plain.numel():
        return {"frac_past_1e-3": 0.0, "frac_max": 0.0, "max_abs_err": 0.0,
                "finite": True, "ok": True}
    scale = plain.abs().amax(dim=0).clamp_min(1e-30)
    frac = (ours - plain).abs() / scale
    past = float((frac > 1e-3).float().mean())
    worst = float(frac.max())
    finite = bool(torch.isfinite(ours).all())
    return {"frac_past_1e-3": past, "frac_max": worst,
            "max_abs_err": float((ours - plain).abs().max()),
            "finite": finite, "ok": finite and past < 5e-3 and worst < 1e-2}


def check_polarized_stages() -> tuple:
    """The polarized route's three kernels at phase 9's cell, each against
    its plain version on the same inputs: 4,096 rays (every PLAIN_STRIDE-th
    of the 1024^2 float32 rk4 bundle in spatial_order, as run launches it);
    the trace kernel against trace_samples_reference on the rays (sample
    counts equal on 99 % of the rays, the samples of those rays at the
    float32 gate), the derive kernel against derive_records_reference on
    the trace kernel's samples (every record value of every stored sample;
    the bad bits equal), the chain kernel against chain_records_reference
    on the derive kernel's records (every coherency component)."""
    import torch
    from blacklight_tpu_torch import pipeline_simulation as ps
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    grid = full_width_snapshot(torch.float32)
    args, _, _ = _pol_args(_pol_full_config("float32", "rk4"), grid)
    order = sk.spatial_order(args[0], block=ps.KERNEL_ORDER_BLOCK)
    pick = order[::PLAIN_STRIDE]
    positions, directions, mom = (a[pick].contiguous() for a in args[:3])
    freqs, params, sp, grid, mass, cam, _ = args[3:]
    # byte caps of one trace chunk and one piece for the 4,096 rays
    stages = pk._CudaStages(positions, directions, mom, freqs, params, sp,
                            grid, mass, cam, "rk4", False, None, 1 << 30,
                            1 << 31)
    b = positions.shape[0]
    flags = torch.empty(b, dtype=torch.int32, device="cuda")
    ns = torch.empty(b, dtype=torch.int32, device="cuda")
    samples, t_k = _timed(stages.trace, 0, b, flags, ns)
    (samples_p, flags_p, ns_p), t_p = _timed(
        pk.trace_samples_reference, positions, directions, params, "rk4")
    same = ns == ns_p
    lengths = pk.warp_lengths(torch.where(same, ns, 0))
    w, t, lane, _ = pk._stored(samples, torch.where(same, ns, 0), lengths)
    trace = {"rays": b, "same_n_samples": float(same.float().mean()),
             "same_flags": float((flags.bool() == flags_p).float().mean()),
             "kernel_s": t_k, "plain_s": t_p,
             **_gate_columns(samples[w, t, :, lane], samples_p[w, t, :, lane])}
    trace["ok"] = trace["ok"] and trace["same_n_samples"] >= 0.99

    lengths = pk.warp_lengths(ns)
    piece = pk.Piece(0, b, samples, ns, lengths, pk.record_offsets(lengths),
                     int(lengths.sum()))
    (geometry, coefficients, bits), t_k = _timed(stages.derive, piece, 0, 1,
                                                 None)
    (geo_p, coef_p, bits_p), t_p = _timed(
        pk.derive_records_reference, samples, ns, lengths, piece.offsets,
        directions, mom, freqs, 0, 1, params, sp, grid, mass, cam)
    w, t, lane, _ = pk._stored(samples, ns, lengths)
    slot = piece.offsets[w] + t
    derive = {"samples": int(w.numel()), "kernel_s": t_k, "plain_s": t_p,
              "same_bad_bits": bool(torch.equal(bits, bits_p))}
    g = _gate_columns(torch.cat((geometry[slot, :, lane],
                                 coefficients[slot, :, lane]), 1),
                      torch.cat((geo_p[slot, :, lane],
                                 coef_p[slot, :, lane]), 1))
    derive.update(g, ok=g["ok"] and derive["same_bad_bits"])

    nn, t_k = _timed(stages.chain, piece, geometry, coefficients, 1)
    nn_p, t_p = _timed(pk.chain_records_reference, samples, ns, lengths,
                       piece.offsets, geometry, coefficients, 1, False)
    chain = {"rays": b, "kernel_s": t_k, "plain_s": t_p,
             **_gate_columns(nn.reshape(b, -1), nn_p.reshape(b, -1))}
    ok = trace["ok"] and derive["ok"] and chain["ok"]
    return "pol_stages_vs_plain", {
        "trace": trace, "derive": derive, "chain": chain,
        "gate": "float32: per value, |delta| over its peak below 1e-3 at "
                "the 99.5th percentile and 1e-2 at the maximum",
        "ok": bool(ok)}


def device_busy_share(trace_file: str) -> dict:
    """Device busy time (kernels, copies, sets; overlaps counted once)
    over the trace's span, and kernel time by name, from a chrome
    trace."""
    events = json.loads(pathlib.Path(trace_file).read_text())["traceEvents"]
    spans, by_name = [], {}
    t_lo, t_hi = float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        t_lo, t_hi = min(t_lo, ts), max(t_hi, ts + dur)
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((ts, ts + dur))
            if cat == "kernel":
                name = e.get("name", "?")[:80]
                by_name[name] = by_name.get(name, 0.0) + dur
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    span = t_hi - t_lo
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / span if span > 0 else None,
            "kernel_ms_by_name": {k: v / 1e3 for k, v in top}}


def profile_run(cfg, grid) -> dict:
    """torch.profiler over one warm pipeline.run of ``cfg``: the device's
    idle share and kernel time by name."""
    import torch
    from blacklight_tpu_torch import pipeline
    pipeline.run(cfg, quiet=True, device="cuda", grid=grid)  # warm up
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        trace = str(pathlib.Path(tmp) / "trace.json")
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            pipeline.run(cfg, quiet=True, device="cuda", grid=grid)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        prof.export_chrome_trace(trace)
        return {"run_s": run_s, **device_busy_share(trace)}


def _chain_fill(regs: int) -> dict:
    """Rays the chain kernel needs in flight to fill every SM at ``regs``
    registers a thread (a warp's registers allocated in 256s)."""
    per_warp = -(-regs * 32 // 256) * 256
    warps = min(64, REGISTERS_PER_SM // per_warp // 4 * 4)
    return {"registers": regs, "warps_per_sm": warps,
            "rays_to_fill": N_SMS * warps * 32}


def _spatial(args):
    """``args`` (a render_polarized argument tuple) with its rays in
    spatial_order, as pipeline.run launches them."""
    from blacklight_tpu_torch import pipeline_simulation as ps
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    order = sk.spatial_order(args[0], block=ps.KERNEL_ORDER_BLOCK)
    return (*(a[order].contiguous() for a in args[:3]), *args[3:])


def phase_pol_full_width(tmp: pathlib.Path, card: str, grids: dict,
                         truth: tuple, stage_checks: dict) -> dict:
    """Phase 9; ``truth`` is phase 3's float64 plain version on the
    float32 plain version's rays (their positions, Stokes) and its float32
    plain version there (pol_full_width_plain), ``stage_checks`` phase 3's
    check of each kernel against its plain version."""
    import numpy as np
    import torch
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.ops import _build
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk

    res, steps = 1024, 2000
    if "float32" not in grids:
        grids["float32"] = full_width_snapshot(torch.float32)
    cfg = _pol_full_config("float32", "rk4",
                           output_file=str(tmp / "pol_full_width.npz"))
    free = pk.free_device_bytes(grids["float32"].prim.device)
    fk.LAUNCHES = sk.LAUNCHES = pk.LAUNCHES = 0
    pk.STAGE_LAUNCHES.update(dict.fromkeys(pk.STAGE_LAUNCHES, 0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    arrays = pipeline.run(cfg, quiet=True, device="cuda",
                          grid=grids["float32"])
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches, stage_launches = pk.LAUNCHES, dict(pk.STAGE_LAUNCHES)
    image = {k: arrays[k] for k in ("I_nu", "Q_nu", "U_nu", "V_nu")}
    finite_i = np.isfinite(image["I_nu"])
    if any(v.shape != (res, res) for v in image.values()) \
            or not finite_i.any() \
            or not all(np.isfinite(v[finite_i]).all() for v in image.values()):
        raise RuntimeError("full-width polarized image has the wrong shape or "
                           "non-finite Q/U/V where I is finite")
    if not all(stage_launches.values()) or fk.LAUNCHES or sk.LAUNCHES:
        raise RuntimeError(f"the polarized main path did not launch each of "
                           f"its kernels ({stage_launches}), or launched "
                           f"another kernel")
    ptxas = _ptxas_table(_build.ptxas_report())
    chain_regs = ptxas.get("polarized_chain_kernel<float, NF=1>", {}).get(
        "registers")
    # the rays of a trace chunk, all but the last alike: the first holds
    # at least the mean
    chunk = res * res // stage_launches["trace"]
    fill = _chain_fill(chain_regs) if chain_regs else {
        "not_measured": "no ptxas report"}
    emit("pol_main_path", resolution=res, precision="float32",
         integrator="rk4", max_steps=steps, rotation_split=False,
         seconds=run_s, launches=launches, stage_launches=stage_launches,
         trace_chunks=stage_launches["trace"],
         record_pieces=stage_launches["chain"],
         mean_rays_per_trace_chunk=chunk,
         chain_fill=fill, chain_launch_fills_card=bool(
             chain_regs and chunk >= fill["rays_to_fill"]),
         peak_memory_bytes=peak, free_bytes_before_run=free,
         byte_caps_before_run=pk.byte_caps(free),
         nan_pixels=int((~finite_i).sum()),
         max_I_nu=float(np.nanmax(image["I_nu"])),
         max_pol_frac=float(np.nanmax(
             np.sqrt(image["Q_nu"] ** 2 + image["U_nu"] ** 2
                     + image["V_nu"] ** 2) / image["I_nu"])),
         npz_written=(tmp / "pol_full_width.npz").exists())
    cfg.output_file = str(tmp / "pol_profile.npz")
    emit("pol_profile", resolution=res, card=card,
         **profile_run(cfg, grids["float32"]))

    timings, stages = {}, {}
    for precision, integrator in (("float32", "rk4"), ("float64", "rk4"),
                                  ("float32", "dp")):
        if precision not in grids:
            grids[precision] = full_width_snapshot(torch.float64)
        cfg = _pol_full_config(precision, integrator)
        (args, kwargs, geom), t_setup = _timed(_pol_args, cfg, grids[precision])
        bundles = {"spatial_order": _spatial(args)}
        if (precision, integrator) == ("float32", "rk4"):
            bundles["camera_order"] = args
        best = dict.fromkeys(bundles, float("inf"))
        for bundle in bundles.values():
            pk.render_polarized(*bundle, **kwargs)  # warm up
        times, outs = {k: [] for k in bundles}, {}
        for _ in range(3):
            for name, bundle in bundles.items():
                outs[name], t = _timed(pk.render_polarized, *bundle,
                                       **kwargs)
                times[name].append(t)
                best[name] = min(best[name], t)
        ns = outs["spatial_order"][3].cpu().numpy()
        entry = {"kernel_ms": best["spatial_order"] * 1e3, "plain_ms": None,
                 "max_abs_err": None, "mean_n_samples": float(ns.mean())}
        extra = {}
        if (precision, integrator) == ("float32", "rk4"):
            extra = _pol_full_width_checks(args, kwargs, geom,
                                           outs["camera_order"], truth)
            entry.update(plain_ms=extra.pop("plain_ms"),
                         max_abs_err=extra.pop("max_abs_err"))
            extra["camera_order_ms"] = best["camera_order"] * 1e3
            extra["camera_order_s_runs"] = times["camera_order"]
            stages = _pol_stage_times(bundles["spatial_order"], kwargs)
            extra["stages"] = stages
        b = bound("polarized", integrator, precision, res * res,
                  entry["mean_n_samples"], in_bytes=grid_bytes(grids[precision]),
                  out_values=16, extra_out_bytes=12)
        timings[precision, integrator] = {**entry, **b}
        emit("pol_timing", resolution=res, card=card, precision=precision,
             integrator=integrator, order="spatial_order",
             camera_setup_s=t_setup, kernel_s_runs=times["spatial_order"],
             kernel_ms=entry["kernel_ms"],
             kernel_rays_per_s=res * res / best["spatial_order"],
             plain_ms=entry["plain_ms"], max_abs_err=entry["max_abs_err"],
             mean_n_samples=entry["mean_n_samples"],
             max_n_samples=int(ns.max()),
             warp_efficiency=warp_efficiency(ns, np.arange(res * res)),
             **b,
             clocks_power=smi(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                               "temperature.gpu", "--format=csv,noheader"]),
             **extra)
    f32 = timings["float32", "rk4"]
    stage_bounds = pol_stage_bounds(res * res,
                                    res * res * f32["mean_n_samples"],
                                    "float32")
    per_stage = {}
    for stage in ("trace", "derive", "chain"):
        check = stage_checks[stage]
        per_stage[stage] = {
            "launches": stage_launches[stage],
            "ms": stages["stage_ms"][stage],
            "plain_ms": check["plain_s"] * 1e3,
            "plain_rays": res * res // PLAIN_STRIDE,
            "kernel_ms_at_plain_rays": check["kernel_s"] * 1e3,
            "max_abs_err": check["max_abs_err"], **stage_bounds[stage]}
    return {"name": "polarized_kernel", "route": "cuda",
            "source": POL_KERNEL_SOURCE, "replaces": POL_KERNEL_REPLACES,
            "launches": launches, "max_abs_err": f32["max_abs_err"],
            "ms": f32["kernel_ms"], "plain_ms": f32["plain_ms"],
            "plain_rays": res * res // PLAIN_STRIDE,
            "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
            "library_ms": None, "stages": per_stage}


def _pol_stage_times(args, kwargs) -> dict:
    """One route render of ``args`` with CUDA events around each launch:
    each stage's device time and the rest of the wall time (the glue:
    host syncs, offsets, orders, allocations)."""
    import torch
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    events = []
    out, wall = _timed(pk._render_cuda, *args, kwargs["integrator"],
                       kwargs["rotation_split"], events=events)
    stage_ms = dict.fromkeys(pk.STAGE_LAUNCHES, 0.0)
    launches = dict.fromkeys(pk.STAGE_LAUNCHES, 0)
    for stage, start, end in events:
        stage_ms[stage] += start.elapsed_time(end)
        launches[stage] += 1
    return {"wall_ms": wall * 1e3, "stage_ms": stage_ms,
            "glue_ms": wall * 1e3 - sum(stage_ms.values()),
            "launches": launches,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def _pol_full_width_checks(args, kwargs, geom, out, truth) -> dict:
    """Phase 9's checks of the float32 rk4 route's output ``out`` (in
    camera order): phase 3's plain version on every PLAIN_STRIDE-th ray
    against it (polarized_gate) and both against phase 3's float64 run
    (truth_gate); a render under CHUNK_CHECK's byte caps equal to ``out``
    bit for bit. Raises on a failure; returns the numbers for the timing
    line."""
    import numpy as np
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    pick, sub = _plain_subset(args)
    positions, truth, (plain_positions, ref, t_plain) = truth
    if not (np.array_equal(positions, sub[0].cpu().numpy())
            and np.array_equal(plain_positions, positions)):
        raise RuntimeError("the plain and float64 references traced other "
                           "rays")
    ours = _pol_stokes(tuple(o[pick] for o in out), sub, geom, True)
    gate = polarized_gate(ours, ref, exact=False)
    to_truth = truth_gate(ours, ref, truth)
    if not (gate["ok"] and to_truth["ok"]):
        raise RuntimeError(f"polarized route disagrees with plain at "
                           f"1024^2: {gate}, against float64 {to_truth}")
    before = dict(pk.STAGE_LAUNCHES)
    other = pk._render_cuda(*args, kwargs["integrator"],
                            kwargs["rotation_split"],
                            trace_bytes=CHUNK_CHECK[0],
                            record_bytes=CHUNK_CHECK[1])
    chunks = {k: pk.STAGE_LAUNCHES[k] - before[k] for k in before}
    if not all(_same_bits(a, b) for a, b in zip(other, out)):
        raise RuntimeError(f"the polarized image under byte caps "
                           f"{CHUNK_CHECK} differs from the default's")
    return dict(plain_ms=t_plain * 1e3, max_abs_err=gate["max_abs_err"],
                plain_rays=int(pick.numel()),
                plain_rays_per_s=pick.numel() / t_plain,
                gate="NaN sets, I flux, IQUV frac of max I; route within "
                     "3x the plain version's error to float64",
                **{k: v for k, v in gate.items()
                   if k not in ("ok", "max_abs_err")},
                float64_truth=to_truth,
                bit_identical_under_caps=dict(caps=list(CHUNK_CHECK),
                                              launches=chunks))


def _same_bits(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = torch.int32 if a.element_size() == 4 else torch.int64
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


def phase_pol_chunks(card: str, grid):
    """The trace chunk size of the polarized route (how
    polarized_kernel.SAMPLE_SHARE was chosen): float32 rk4 at 1024^2 in
    spatial_order on the full-width snapshot, best of 2 for each trace
    byte cap in CHUNK_SWEEP and for the route's own caps (None), the
    records under the route's own cap; every cap must give the same image
    bit for bit."""
    import torch
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    args, kwargs, _ = _pol_args(_pol_full_config("float32", "rk4"), grid)
    args = _spatial(args)
    ref = None
    for cap in (*CHUNK_SWEEP, None):
        def run():
            return pk._render_cuda(*args, kwargs["integrator"],
                                   kwargs["rotation_split"], trace_bytes=cap)
        run()  # warm up
        times = []
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats()
            before = pk.STAGE_LAUNCHES["trace"]
            out, t = _timed(run)
            chunks = pk.STAGE_LAUNCHES["trace"] - before
            times.append(t)
        if ref is None:
            ref = out
        elif not all(_same_bits(a, b) for a, b in zip(out, ref)):
            raise RuntimeError(f"trace cap {cap} changed the image")
        emit("pol_chunks", trace_bytes=cap if cap else "route's own",
             card=card, trace_chunks=chunks, kernel_s_runs=times,
             kernel_ms=min(times) * 1e3,
             peak_memory_bytes=torch.cuda.max_memory_allocated())


def _only_formula_launched(fk, sk, pk, plain_before) -> bool:
    """Whether the formula kernel, and nothing else, ran since the counts
    were set to 0 (its plain version included)."""
    return (fk.LAUNCHES > 0 and not sk.LAUNCHES and not pk.LAUNCHES
            and fk.PLAIN_CALLS == plain_before)


def phase_multi_full_width(tmp: pathlib.Path, card: str, subset) -> dict:
    """Phase 10, K1.3: golden_formula_32.input at 1024^2, dp, float32,
    three frequencies through pipeline.run, counting launches; the kernel
    (best of 3) held to the plain version on phase 3's subset; then, in
    turns on the same rays, one frequency, three, and six (two launches,
    each tracing the rays again)."""
    import math
    import numpy as np
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk

    res = 1024
    cfg, args, kwargs = _formula_cell("k13")
    cfg.output_file = str(tmp / "multi_full_width.npz")
    plain_before = fk.PLAIN_CALLS
    fk.LAUNCHES = sk.LAUNCHES = pk.LAUNCHES = 0
    t0 = time.perf_counter()
    arrays = pipeline.run(cfg, quiet=True, device="cuda")
    run_s = time.perf_counter() - t0
    launches = fk.LAUNCHES
    image = arrays["I_nu"]
    if image.shape != (3, res, res) or not all(
            np.isfinite(np.nanmax(image[f])) for f in range(3)):
        raise RuntimeError("the three-frequency image is not finite or has "
                           "the wrong shape")
    if not _only_formula_launched(fk, sk, pk, plain_before):
        raise RuntimeError("the three-frequency path launched no formula "
                           "kernel, another kernel, or the plain version")
    emit("multi_main_path", resolution=res, precision="float32",
         integrator="dp", frequencies=arrays["frequency"].tolist(),
         seconds=run_s, launches=launches,
         nan_pixels=int(np.isnan(image[0]).sum()),
         max_I_nu=[float(np.nanmax(image[f])) for f in range(3)])

    timing = time_kernel("multi_timing", fk.render_formula, subset, args,
                         kwargs, res, card,
                         step_loop="formula_kernel<float, dp, NF=4>",
                         precision="float32", integrator="dp", frequencies=3)
    cases = {"one": args[3][:1], "three": args[3],
             "six": np.geomspace(1e11, 4e11, 6).tolist()}
    best = dict.fromkeys(cases, math.inf)
    for _ in range(3):
        for name, nus in cases.items():
            _, t = _timed(fk.render_formula, *args[:3], nus, *args[4:],
                          **kwargs)
            best[name] = min(best[name], t)
    emit("multi_frequency_cost", resolution=res, card=card,
         **{f"{name}_ms": t * 1e3 for name, t in best.items()},
         three_over_one=best["three"] / best["one"],
         six_over_three=best["six"] / best["three"])
    return {"name": "formula_kernel_frequencies", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": MULTI_REPLACES,
            "launches": launches, "max_abs_err": timing["max_abs_err"],
            "ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"],
            "plain_rays": res * res // PLAIN_STRIDE,
            **bound("formula", "dp", "float32", res * res,
                    timing["mean_n_samples"], in_bytes=0, out_values=3,
                    frequencies=3),
            "issue_estimate_ms": timing["issue_estimate_ms"],
            "library_ms": None}


def phase_grad_full_width(card: str, subset) -> dict:
    """Phase 11, K1.4: the tangent kernel (cn0, r0 and h at h = FIT_H) on
    phase 5's rays and step budget, best of 3, held to the plain version
    on phase 3's subset, and timed in turns with the launch without
    tangents and with cn0's alone; then scripts/bench_gradient.py's path
    at 1024^2 and GRAD_STEPS steps without NaN poisoning: the value and
    gradient of the total flux with respect to cn0 through the vjp
    renderer (h = 0, the golden input) and with respect to cn0, r0 and h
    through the fit renderer, counting launches, each best of 3 and each
    gradient against central finite differences through the kernel
    itself."""
    import dataclasses
    import math
    import numpy as np
    import torch
    from blacklight_tpu_torch.models import formula as formula_model
    from blacklight_tpu_torch.ops import formula_fit
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk

    res = 1024
    _, args, kwargs = _formula_cell("k14")
    fp = args[5]
    timing = time_kernel("tangent_timing", fk.render_formula, subset, args,
                         kwargs, res, card,
                         step_loop="formula_kernel<float, dp, NF=1, tangents>",
                         precision="float32", integrator="dp",
                         tangents=list(FIT_PARAMS), formula_h=FIT_H)
    # the same rays without tangents and with cn0 alone, in turns
    plain_kwargs = {k: v for k, v in kwargs.items() if k != "diff_values"}
    cases = {"none": plain_kwargs, "cn0": dict(plain_kwargs, cn0=fp.cn0),
             "all": kwargs}
    best = dict.fromkeys(cases, math.inf)
    for _ in range(3):
        for name, kw in cases.items():
            _, t = _timed(fk.render_formula, *args, **kw)
            best[name] = min(best[name], t)
    emit("tangent_cost", resolution=res, card=card,
         **{f"tangents_{name}_ms": t * 1e3 for name, t in best.items()},
         cn0_over_none=best["cn0"] / best["none"],
         all_over_none=best["all"] / best["none"])

    _, grad_args, _ = _formula_cell("grad")
    positions, directions, mom, nus, params, fp = grad_args[:6]
    mass_msun, camera_x = grad_args[6:8]
    golden = dataclasses.replace(fp, h=0.0)
    renderers = {
        "vjp": (formula_fit.make_formula_vjp_renderer(
            nus, params, golden, mass_msun, camera_x,
            formula_model.formula_log_j_scale(golden), fallback_nan=False),
            {"cn0": golden.cn0}),
        "fit": (formula_fit.make_formula_fit_renderer(
            nus, params, fp, mass_msun, camera_x,
            formula_model.formula_log_j_scale(fp), fallback_nan=False,
            fit_params=FIT_PARAMS), _fit_values(fp)),
    }

    def flux(name, values, grad=False):
        """The total flux (summed in float64) and, with grad, its gradient
        by backward through the renderer."""
        render = renderers[name][0]
        theta = {p: torch.tensor(v, dtype=torch.float32, device="cuda",
                                 requires_grad=grad)
                 for p, v in values.items()}
        with torch.set_grad_enabled(grad):
            if name == "vjp":
                i_img = render(theta["cn0"], positions, directions, mom)[0]
            else:
                i_img = render(theta, positions, directions, mom)[0]
            total = i_img.double().sum()
        if not grad:
            return total.item(), None
        total.backward()
        return total.item(), {p: t.grad.item() for p, t in theta.items()}

    plain_before = fk.PLAIN_CALLS
    fk.LAUNCHES = sk.LAUNCHES = pk.LAUNCHES = 0
    for name, (_, values) in renderers.items():
        flux(name, values, grad=True)
    launches = fk.LAUNCHES
    if launches != len(renderers) or not _only_formula_launched(
            fk, sk, pk, plain_before):
        raise RuntimeError("value and gradient did not take one tangent "
                           "kernel launch each, or ran the plain version")
    for name, (_, values) in renderers.items():
        times = []
        for _ in range(3):
            (value, grad), t = _timed(flux, name, values, True)
            times.append(t)
        fd, ok = {}, True
        for p, v in values.items():
            hi = float(np.float32(v * (1.0 + FD_STEP)))
            lo = float(np.float32(v * (1.0 - FD_STEP)))
            f_hi = flux(name, dict(values, **{p: hi}))[0]
            f_lo = flux(name, dict(values, **{p: lo}))[0]
            fd[p] = (f_hi - f_lo) / (hi - lo)
            ok = ok and grad[p] != 0.0 and bool(np.isclose(
                grad[p], fd[p], rtol=FD_RTOL[name], atol=0.0))
        emit("gradient", renderer=name, resolution=res, card=card,
             max_steps=GRAD_STEPS, precision="float32", integrator="dp",
             wrt=list(values), value=value, grad=grad, finite_difference=fd,
             fd_step=FD_STEP, rtol=FD_RTOL[name],
             value_and_grad_s_runs=times,
             value_and_grad_ms=min(times) * 1e3,
             rays_per_s=res * res / min(times), ok=bool(ok))
        if not ok:
            raise RuntimeError(f"the {name} gradient disagrees with finite "
                               f"differences: {grad} against {fd}")
    return {"name": "formula_kernel_tangents", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": TANGENT_REPLACES,
            "launches": launches, "max_abs_err": timing["max_abs_err"],
            "ms": timing["kernel_ms"], "plain_ms": timing["plain_ms"],
            "plain_rays": res * res // PLAIN_STRIDE,
            **bound("formula", "dp", "float32", res * res,
                    timing["mean_n_samples"], in_bytes=0,
                    out_values=1 + len(FIT_PARAMS),
                    tangents=len(FIT_PARAMS)),
            "issue_estimate_ms": timing["issue_estimate_ms"],
            "library_ms": None}


def fit_demo_run() -> tuple:
    """Phase 3: ``python -m blacklight_tpu_torch.fit_demo`` as a user runs
    it (32^2, 200 Adam iterations on the card; it took ~22 s after phase
    3 alone): (return code, its output's lines, its error output's end,
    seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "blacklight_tpu_torch.fit_demo"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    return (proc.returncode, proc.stdout.strip().splitlines(),
            proc.stderr[-2000:], time.perf_counter() - t0)


def phase_fit(card: str, demo):
    """Phase 12: phase 3's run of ``python -m blacklight_tpu_torch.fit_demo``
    (``demo``: fit_demo_run's result) must have printed FIT OK; then 10
    iterations of the same problem at 1024^2, whose loss must be finite
    and fall, with the time of each iteration."""
    import math
    from blacklight_tpu_torch import fit_demo
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk

    returncode, lines, stderr, seconds = demo
    ok = returncode == 0 and "FIT OK" in lines
    emit("fit_demo", resolution=32, iterations=200, card=card,
         returncode=returncode, seconds=seconds, ran_in="phase 3's pool",
         output=lines[-4:], stderr=stderr, ok=ok)
    if not ok:
        raise RuntimeError("fit_demo did not print FIT OK")

    plain_before = fk.PLAIN_CALLS
    fk.LAUNCHES = sk.LAUNCHES = pk.LAUNCHES = 0
    result = fit_demo.fit(1024, 10, "cuda", log=lambda *_: None)
    losses = result["losses"]
    ok = (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
          and _only_formula_launched(fk, sk, pk, plain_before))
    emit("fit_1024", resolution=1024, iterations=10, card=card,
         launches=fk.LAUNCHES, losses=losses,
         seconds_per_iteration=result["seconds"],
         best_iteration_ms=min(result["seconds"]) * 1e3, ok=bool(ok))
    if not ok:
        raise RuntimeError("the 1024^2 fit's loss is not finite or did not "
                           "fall, or it ran no tangent kernel")


# ---------------------------------------------------------------------------
# Phase 16: the power-law and kappa populations (ROADMAP B.2)

MIX_INPUT = "golden_plasma_mix_rk4_32.input"
MIX_POL_INPUT = "golden_plasma_mix_pol_rk4_32.input"
MIX_SOURCE = "blacklight_tpu_torch/csrc/sim_sample.cuh"
POL_MIX_SOURCE = "blacklight_tpu_torch/csrc/polarized_kernel.cuh"
# Phase 3's checks of the mixture: 128^2, 400 steps of 0.04; the phase
# kernel's second phase of MIX_PHASE_STEPS.
MIX_CHECK_STEPS = dict(ray_step=0.04, ray_max_steps=400)
MIX_PHASE_STEPS = 200
# Phase 16's cells: phase 7's and phase 9's resolution and step budget.
MIX_RES, MIX_STEPS = 1024, 2000
# Phase 16's polarized cell is held to the plain version on every
# MIX_POL_STRIDE-th ray (1,024 rays: the plain polarized version takes
# ~35 ms a ray on one host core, and phase 3 has little room left).
MIX_POL_STRIDE = 4 * PLAIN_STRIDE


def _mix_full_config(**overrides):
    """Phase 16's cell: phase 7's (1024^2, rk4, 2000 steps, float32) with
    the mixed golden's plasma."""
    return _sim_config(MIX_INPUT, camera_resolution=MIX_RES,
                       precision="float32", ray_integrator="rk4",
                       ray_max_steps=MIX_STEPS, **overrides)


def _mix_pol_full_config(**overrides):
    """Phase 16's polarized cell: phase 9's with the mixed plasma."""
    return _pol_config(MIX_POL_INPUT, camera_resolution=MIX_RES,
                       precision="float32", ray_integrator="rk4",
                       ray_max_steps=MIX_STEPS, image_rotation_split=False,
                       **overrides)


def check_mixture_simulation(integrator, precision) -> tuple:
    """The mixture's simulation kernel against its plain version, 128^2:
    rk4 float64 exact (rtol 1e-9) in MIX_CHECK_STEPS; dp at the input's
    2000 steps of 0.01, as check_simulation runs it (a float32 dp ray
    whose step count nears a budget of 400 can end flagged in one version
    and not the other), statistical."""
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    cfg = _sim_config(MIX_INPUT, camera_resolution=128,
                      ray_integrator=integrator, precision=precision,
                      **(MIX_CHECK_STEPS if integrator != "dp" else {}))
    args, kwargs = _sim_args(cfg)
    before = sk.MIXTURE_LAUNCHES
    out_k, t_k = _timed(sk.render_simulation, *args, **kwargs)
    launched = sk.MIXTURE_LAUNCHES - before
    out_p, t_p = _timed(sk.render_simulation_reference, *args, **kwargs)
    exact = integrator != "dp" and precision == "float64"
    result = _check_exact(out_k, out_p, 1e-9 if exact else None)
    result["ok"] = bool(result["ok"] and launched == 1)
    return "mixture_kernel_vs_plain", dict(
        integrator=integrator, precision=precision, mixture_launches=launched,
        kernel_s=t_k, plain_s=t_p, **result)


def check_mixture_phase() -> tuple:
    """The mixture's phase kernel against its plain version, 128^2
    (MIX_CHECK_STEPS): the second phase of MIX_PHASE_STEPS from the
    kernel's carried state after the first, rk4 float64 exact."""
    import numpy as np
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    cfg = _sim_config(MIX_INPUT, camera_resolution=128, ray_integrator="rk4",
                      precision="float64", **MIX_CHECK_STEPS)
    args, _ = _sim_args(cfg)
    before = sk.PHASE_MIXTURE_LAUNCHES
    out_k, out_p, t_k, t_p, rays, samples = _second_phase(
        args, "rk4", MIX_PHASE_STEPS)
    launched = sk.PHASE_MIXTURE_LAUNCHES - before
    result = _check_exact(out_k, out_p, 1e-9)
    result["ok"] = bool(result["ok"] and launched == 2)
    a, b = out_k[0].cpu().numpy(), out_p[0].cpu().numpy()
    both = np.isfinite(a) & np.isfinite(b)
    result["max_abs_err"] = float(np.max(np.abs(a[both] - b[both]))) \
        if both.any() else 0.0
    return "mixture_phase_kernel_vs_plain", dict(
        integrator="rk4", precision="float64", phase_steps=MIX_PHASE_STEPS,
        phase_rays=rays, phase_samples=samples, mixture_launches=launched,
        kernel_s=t_k, plain_s=t_p, **result)


def mixture_plain_subset() -> tuple:
    """The plain version on phase 16's cell on every PLAIN_STRIDE-th ray:
    (their positions, (I_nu, flags, n_samples), seconds), numpy."""
    import torch
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    args, kwargs = _sim_args(_mix_full_config(),
                             full_width_snapshot(torch.float32))
    _, sub = _plain_subset(args)
    out, t_p = _timed(sk.render_simulation_reference, *sub, **kwargs)
    return (sub[0].cpu().numpy(), [o.cpu().numpy() for o in out], t_p)


def mixture_pol_plain_subset() -> tuple:
    """The plain polarized version on phase 16's polarized cell on every
    MIX_POL_STRIDE-th ray: (their positions, Stokes, seconds)."""
    import torch
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    args, kwargs, geom = _pol_args(_mix_pol_full_config(),
                                   full_width_snapshot(torch.float32))
    pick = torch.arange(0, args[0].shape[0], MIX_POL_STRIDE,
                        device=args[0].device)
    sub = (*(a[pick].contiguous() for a in args[:3]), *args[3:])
    out, t_p = _timed(pk.render_polarized_reference, *sub, **kwargs)
    return sub[0].cpu().numpy(), _pol_stokes(out, sub, geom, True), t_p


def _best_in_turns(fns: dict, rounds=3) -> tuple:
    """Each of ``fns`` (name: callable) warm, then ``rounds`` rounds in
    turns: (best seconds by name, every run's seconds by name, the last
    outputs by name)."""
    for fn in fns.values():
        fn()
    runs, outs = {k: [] for k in fns}, {}
    for _ in range(rounds):
        for name, fn in fns.items():
            outs[name], t = _timed(fn)
            runs[name].append(t)
    return {k: min(v) for k, v in runs.items()}, runs, outs


def phase_mixture_full_width(tmp: pathlib.Path, card: str, grids: dict,
                             checks: dict) -> list:
    """Phase 16; ``checks``: phase 3's mixture results ("plain",
    "pol_plain", "phase", each the job's result). Returns the kernels
    line's entries of the mixture's simulation, phase and polarized
    routes."""
    import numpy as np
    import torch
    from blacklight_tpu_torch import pipeline, pipeline_simulation as ps
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk

    res, steps = MIX_RES, MIX_STEPS
    if "float32" not in grids:
        grids["float32"] = full_width_snapshot(torch.float32)
    grid = grids["float32"]
    n = res * res

    # the unpolarized mixture through pipeline.run
    fk.LAUNCHES = sk.LAUNCHES = pk.LAUNCHES = sk.MIXTURE_LAUNCHES = 0
    arrays, run_s = _timed(pipeline.run, _mix_full_config(
        output_file=str(tmp / "mix_full_width.npz")), quiet=True,
        device="cuda", grid=grid)
    launches = sk.MIXTURE_LAUNCHES
    others = fk.LAUNCHES + pk.LAUNCHES + sk.LAUNCHES - launches
    image = arrays["I_nu"]
    emit("mixture_main_path", resolution=res, precision="float32",
         integrator="rk4", max_steps=steps, seconds=run_s,
         mixture_launches=launches, other_launches=others,
         nan_pixels=int(np.isnan(image).sum()),
         max_I_nu=float(np.nanmax(image)))
    if image.shape != (res, res) or not np.isfinite(np.nanmax(image)) \
            or launches == 0 or others:
        raise RuntimeError("the mixture's main path launched no mixture "
                           "kernel, another kernel, or gave no finite image")

    # the mixture and the thermal kernel in turns, as run launches them
    (args_m, kwargs), t_setup = _timed(_sim_args, _mix_full_config(), grid)
    args_t, _ = _sim_args(_sim_config(camera_resolution=res,
                                      precision="float32",
                                      ray_integrator="rk4",
                                      ray_max_steps=steps), grid)
    bundles = {"mixture": _spatial(args_m), "thermal": _spatial(args_t)}
    best, runs, outs = _best_in_turns({
        name: (lambda b=b: sk.render_simulation(*b, **kwargs))
        for name, b in bundles.items()})
    mean_samples = float(outs["mixture"][2].double().mean())
    positions, plain, t_plain = checks["plain"]
    pick = np.arange(0, n, PLAIN_STRIDE)
    out_cam = sk.render_simulation(*args_m, **kwargs)
    if not np.array_equal(positions, args_m[0][pick].cpu().numpy()):
        raise RuntimeError("the plain version traced other rays")
    gate = gate_outputs([out_cam[0].cpu().numpy()[pick]], [plain[0]])
    b_mix = bound("simulation_mixture", "rk4", "float32", n, mean_samples,
                  in_bytes=grid_bytes(grid), out_values=1)
    b_th = bound("simulation", "rk4", "float32", n,
                 float(outs["thermal"][2].double().mean()),
                 in_bytes=grid_bytes(grid), out_values=1)
    emit("mixture_timing", resolution=res, card=card, order="spatial_order",
         camera_setup_s=t_setup, kernel_s_runs=runs,
         kernel_ms=best["mixture"] * 1e3,
         thermal_kernel_ms=best["thermal"] * 1e3,
         mixture_over_thermal=best["mixture"] / best["thermal"],
         mean_n_samples=mean_samples, plain_ms=t_plain * 1e3,
         plain_rays=pick.size, gate="statistical (bench.py:181-186)",
         **gate, **b_mix, thermal_bound_ms=b_th["bound_ms"],
         clocks_power=smi(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                           "temperature.gpu", "--format=csv,noheader"]))
    if not gate["ok"]:
        raise RuntimeError(f"the mixture kernel disagrees with plain at "
                           f"{res}^2: {gate}")
    simulation = {"name": "simulation_mixture_kernel", "route": "cuda",
                  "source": MIX_SOURCE, "replaces": SIM_KERNEL_REPLACES,
                  "launches": launches, "max_abs_err": gate["max_abs_err"],
                  "ms": best["mixture"] * 1e3, "plain_ms": t_plain * 1e3,
                  "plain_rays": int(pick.size),
                  **{k: b_mix[k] for k in ("bound_ms", "bound_by")},
                  "thermal_ms": best["thermal"] * 1e3, "library_ms": None}

    # the phased route of the mixture: bit for bit its monolithic image
    ps.KERNEL_PHASED = True
    try:
        fk.LAUNCHES = sk.LAUNCHES = pk.LAUNCHES = sk.PHASE_LAUNCHES = 0
        sk.PHASE_MIXTURE_LAUNCHES = 0
        phased = pipeline.run(_mix_full_config(), quiet=True, device="cuda",
                              grid=grid)
        phase_launches = sk.PHASE_MIXTURE_LAUNCHES
        others = fk.LAUNCHES + sk.LAUNCHES + pk.LAUNCHES \
            + sk.PHASE_LAUNCHES - phase_launches
    finally:
        ps.KERNEL_PHASED = False
    a = phased["I_nu"]
    same = bool(a.shape == image.shape and np.array_equal(
        np.isnan(a), np.isnan(image)) and np.array_equal(
        a[~np.isnan(a)], image[~np.isnan(image)]))
    out2_k, _, t2_k, _, rays2, samples2 = _second_phase(
        args_m, "rk4", ps.KERNEL_PHASE_STEPS, with_plain=False)
    b_phase = phase_bound(rays2, samples2, "float32", grid_bytes(grid),
                          kind="simulation_mixture")
    phase_check = checks["phase"]
    emit("mixture_phased", resolution=res, card=card,
         phase_steps=ps.KERNEL_PHASE_STEPS, phase_launches=phase_launches,
         other_launches=others, identical_to_monolithic=same,
         second_phase_rays=rays2, second_phase_kernel_ms=t2_k * 1e3,
         **b_phase)
    if not same or not phase_launches or others:
        raise RuntimeError("the mixture's phased route launched no mixture "
                           "phase kernel, another kernel, or its image "
                           "differs from the monolithic one")
    phase_entry = {"name": "simulation_phase_mixture_kernel", "route": "cuda",
                   "source": SIM_KERNEL_SOURCE, "replaces": PHASE_REPLACES,
                   "launches": phase_launches,
                   "max_abs_err": phase_check["max_abs_err"],
                   "ms": t2_k * 1e3, "plain_ms": phase_check["plain_s"] * 1e3,
                   "plain_rays": phase_check["phase_rays"],
                   "kernel_ms_at_plain_rays": phase_check["kernel_s"] * 1e3,
                   **{k: b_phase[k] for k in ("bound_ms", "bound_by")},
                   "library_ms": None}

    # the polarized mixture through pipeline.run
    fk.LAUNCHES = sk.LAUNCHES = pk.LAUNCHES = pk.DERIVE_MIXTURE_LAUNCHES = 0
    pk.STAGE_LAUNCHES.update(dict.fromkeys(pk.STAGE_LAUNCHES, 0))
    arrays, run_s = _timed(pipeline.run, _mix_pol_full_config(
        output_file=str(tmp / "mix_pol_full_width.npz")), quiet=True,
        device="cuda", grid=grid)
    stage_launches = dict(pk.STAGE_LAUNCHES)
    derive_launches = pk.DERIVE_MIXTURE_LAUNCHES
    pol_launches = pk.LAUNCHES
    finite_i = np.isfinite(arrays["I_nu"])
    emit("mixture_pol_main_path", resolution=res, seconds=run_s,
         launches=pol_launches, stage_launches=stage_launches,
         mixture_derive_launches=derive_launches,
         nan_pixels=int((~finite_i).sum()),
         max_I_nu=float(np.nanmax(arrays["I_nu"])))
    if not all(stage_launches.values()) or fk.LAUNCHES or sk.LAUNCHES \
            or derive_launches != stage_launches["derive"] \
            or not all(np.isfinite(arrays[k][finite_i]).all()
                       for k in STOKES):
        raise RuntimeError("the polarized mixture did not launch each stage "
                           "with the mixture's derive kernel, or its image "
                           "is not finite where I is")
    (args_pm, kw_p, geom), _ = _timed(_pol_args, _mix_pol_full_config(),
                                      grid)
    args_pt, _, _ = _pol_args(_pol_config(
        camera_resolution=res, precision="float32", ray_integrator="rk4",
        ray_max_steps=steps, image_rotation_split=False), grid)
    pol_bundles = {"mixture": _spatial(args_pm), "thermal": _spatial(args_pt)}
    best_p, runs_p, outs_p = _best_in_turns({
        name: (lambda b=b: pk.render_polarized(*b, **kw_p))
        for name, b in pol_bundles.items()})
    stages = {name: _pol_stage_times(b, kw_p)["stage_ms"]
              for name, b in pol_bundles.items()}
    positions, plain_stokes, t_plain_p = checks["pol_plain"]
    pol_pick = np.arange(0, n, MIX_POL_STRIDE)
    if not np.array_equal(positions, args_pm[0][pol_pick].cpu().numpy()):
        raise RuntimeError("the plain version traced other rays")
    ours = _pol_stokes(pk.render_polarized(*args_pm, **kw_p), args_pm, geom,
                       True)
    pol_gate = polarized_gate({k: v[pol_pick] for k, v in ours.items()},
                              plain_stokes, exact=False)
    mean_p = float(outs_p["mixture"][3].double().mean())
    b_pol = bound("polarized_mixture", "rk4", "float32", n, mean_p,
                  in_bytes=grid_bytes(grid), out_values=16,
                  extra_out_bytes=12)
    emit("mixture_pol_timing", resolution=res, card=card,
         order="spatial_order", kernel_s_runs=runs_p,
         route_ms=best_p["mixture"] * 1e3,
         thermal_route_ms=best_p["thermal"] * 1e3,
         mixture_over_thermal=best_p["mixture"] / best_p["thermal"],
         stage_ms=stages, mean_n_samples=mean_p, plain_ms=t_plain_p * 1e3,
         plain_rays=pol_pick.size, gate=pol_gate, **b_pol)
    if not pol_gate["ok"]:
        raise RuntimeError(f"the polarized mixture disagrees with plain at "
                           f"{res}^2: {pol_gate}")
    polarized = {"name": "polarized_kernel (mixture derive)",
                 "route": "cuda", "source": POL_MIX_SOURCE,
                 "replaces": POL_KERNEL_REPLACES,
                 "launches": pol_launches,
                 "derive_launches": derive_launches,
                 "max_abs_err": pol_gate["max_abs_err"],
                 "ms": best_p["mixture"] * 1e3, "plain_ms": t_plain_p * 1e3,
                 "plain_rays": int(pol_pick.size),
                 **{k: b_pol[k] for k in ("bound_ms", "bound_by")},
                 "thermal_ms": best_p["thermal"] * 1e3,
                 "derive_ms": stages["mixture"]["derive"],
                 "thermal_derive_ms": stages["thermal"]["derive"],
                 "library_ms": None}
    return [simulation, phase_entry, polarized]


# Phase 17: iharm3d (FMKS) and harm3d snapshots (ROADMAP B.4). The FMKS
# torus of scripts/generate_mock_simulation.write_iharm3d_fmks with the
# writer's parameters (hslope 0.3, mks_smooth 0.5, poly_xt 0.82,
# poly_alpha 14: those of the EHT library's iharm3d runs) on FULL_GRID,
# recorded in memory (scripts/mock_iharm3d_datasets.py: the card's Python
# has no h5py) and built by grid/iharm3d.iharm3d_grid; the harm3d file of
# write_harm3d on FULL_GRID, written and read by load_harm3d.
FMKS_SOURCE = "blacklight_tpu_torch/csrc/sim_sample.cuh"
FMKS_RES, FMKS_STEPS = 1024, 2000
# Phase 3's FMKS checks run on the FMKS torus over mock_small.athdf's
# grid and radii (the camera of the golden inputs), 400 steps of 0.04 (dp
# within the inputs' budget of 2000), at FMKS_CHECK_RES^2.
FMKS_CHECK_GRID = dict(n_r=64, n_th=32, n_ph=32, r_min=1.916, r_max=52.2)
FMKS_CHECK_RES = 128
# The polarized FMKS cell's plain rays: every FMKS_POL_STRIDE-th (1,024),
# in float32 and in float64
FMKS_POL_STRIDE = 4 * PLAIN_STRIDE


def fmks_datasets(size=None) -> tuple:
    """The datasets write_iharm3d_fmks writes for the torus on ``size``
    (FULL_GRID by default), recorded in memory: (datasets, the writer's
    host seconds)."""
    mock = _mock()
    from mock_iharm3d_datasets import record_datasets
    p = dict(mock.DEFAULTS, **(size or FULL_GRID))
    t0 = time.perf_counter()
    datasets = record_datasets(mock.write_iharm3d_fmks, mock.make_fields(p),
                               p)
    return datasets, time.perf_counter() - t0


def fmks_snapshot(dtype, size=None, datasets=None) -> tuple:
    """The FMKS torus on ``size`` (FULL_GRID by default; or ``datasets``,
    fmks_datasets' recorded ones) on the card in ``dtype``: (grid,
    {"write_s": the mock writer's host time, "load_s": iharm3d_grid's,
    the inverse table on the card included})."""
    import torch
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.grid.iharm3d import iharm3d_grid
    write_s = None
    if datasets is None:
        datasets, write_s = fmks_datasets(size)
    t1 = time.perf_counter()
    grid = iharm3d_grid(datasets, _fmks_config(), dtype=dtype,
                        device=pipeline.resolve_device("cuda"))
    torch.cuda.synchronize()
    return grid, {"write_s": write_s, "load_s": time.perf_counter() - t1}


def fmks_host_prep(directory: pathlib.Path) -> dict:
    """Phase 17's host work, which the main process does while phase 3's
    jobs run: the FMKS datasets of FULL_GRID and the harm3d file of
    FULL_GRID in ``directory``, with the writers' seconds."""
    datasets, write_s = fmks_datasets()
    path, harm_s = write_harm3d_file(directory)
    return {"datasets": datasets, "write_s": write_s, "harm3d_path": path,
            "harm3d_write_s": harm_s}


def write_harm3d_file(directory: pathlib.Path) -> tuple:
    """write_harm3d's file of FULL_GRID in ``directory``: (path, the
    writer's seconds)."""
    mock = _mock()
    p = dict(mock.DEFAULTS, **FULL_GRID)
    path = directory / "full_width.harm"
    t0 = time.perf_counter()
    mock.write_harm3d(str(path), mock.make_fields(p), p)
    return path, time.perf_counter() - t0


def _fmks_config(name="golden_sim_rk4_32.input", **overrides):
    """``name`` as an FMKS iharm3d configuration (the snapshot is passed
    to the renderer, not read from simulation_file)."""
    from blacklight_tpu_torch.constants import Coordinates, SimulationFormat
    return _sim_config(name, simulation_format=SimulationFormat.iharm3d,
                       simulation_coord=Coordinates.fmks, **overrides)


def _fmks_full_config(name="golden_sim_rk4_32.input", **overrides):
    """Phase 17's cells: phase 7's (1024^2, rk4, 2000 steps, float32)."""
    return _fmks_config(name, camera_resolution=FMKS_RES,
                        precision="float32", ray_integrator="rk4",
                        ray_max_steps=FMKS_STEPS, **overrides)


def _harm3d_full_config(path, **overrides):
    from blacklight_tpu_torch.constants import SimulationFormat
    return _sim_config(simulation_format=SimulationFormat.harm3d,
                       simulation_file=str(path), camera_resolution=FMKS_RES,
                       precision="float32", ray_integrator="rk4",
                       ray_max_steps=FMKS_STEPS, **overrides)


# Phase 17's unpolarized cells: name -> (input, snapshot)
FMKS_CELLS = {"fmks": ("golden_sim_rk4_32.input", "fmks"),
              "fmks_mix": (MIX_INPUT, "fmks"),
              "harm3d": ("golden_sim_rk4_32.input", "harm3d")}


def _fmks_cell_config(cell):
    name, snapshot = FMKS_CELLS[cell]
    if snapshot == "fmks":
        return _fmks_full_config(name)
    return _sim_config(name, camera_resolution=FMKS_RES, precision="float32",
                       ray_integrator="rk4", ray_max_steps=FMKS_STEPS)


def _host_grid(grid):
    """``grid`` with its tensors on the host."""
    import dataclasses
    import torch
    return dataclasses.replace(grid, **{
        f.name: getattr(grid, f.name).cpu() for f in dataclasses.fields(grid)
        if isinstance(getattr(grid, f.name), torch.Tensor)})


def _host_subset(cfg, card_args, grid, stride, cfg64=None):
    """Every ``stride``-th of the card's camera rays ``card_args`` (a
    render_simulation argument tuple, float32) on the host, with the
    renderer arguments of ``cfg`` (or, widened, of ``cfg64``) on the host
    through ``grid`` (the host copy of the snapshot in that precision):
    (the argument tuple, the keywords, the camera geometry). The plain
    versions of phase 17's cells run there, one host core each: in phase
    3's pool they are launch-bound on the card (PERF.md)."""
    from blacklight_tpu_torch.pipeline_simulation import (
        make_simulation_renderer)
    rays = [a[::stride].contiguous().cpu() for a in card_args[:3]]
    render_fn, geom, _, _, _ = make_simulation_renderer(
        cfg64 or cfg, device="cpu", grid=grid)
    rest = render_fn.kernel_args
    if cfg64 is not None:
        rays = [r.double() for r in rays]
    # the float32 configuration's frequencies and log_j_scale (widened)
    args = (*rays, card_args[3].cpu().to(rays[0].dtype), *rest[1:-1],
            card_args[-1])
    return args, dict(render_fn.kernel_kwargs), geom


def fmks_plain_subset(cell) -> tuple:
    """Phase 3: the plain version on phase 17's ``cell`` on every
    PLAIN_STRIDE-th ray, on one host core: (their positions, (I_nu, flags,
    n_samples), seconds), numpy."""
    import torch
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.grid.harm3d import load_harm3d
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    torch.set_num_threads(1)
    if FMKS_CELLS[cell][1] == "fmks":
        grid, _ = fmks_snapshot(torch.float32)
    else:
        with tempfile.TemporaryDirectory(dir=ROOT / "build" / "kernels") \
                as tmp:
            path, _ = write_harm3d_file(pathlib.Path(tmp))
            grid = load_harm3d(str(path), _harm3d_full_config(path),
                               device=pipeline.resolve_device("cuda"),
                               dtype=torch.float32)
    cfg = _fmks_cell_config(cell)
    card_args, _ = _sim_args(cfg, grid)
    sub, kwargs, _ = _host_subset(cfg, card_args, _host_grid(grid),
                                  PLAIN_STRIDE)
    del card_args, grid
    out, t_p = _timed(sk.render_simulation_reference, *sub, **kwargs)
    return (sub[0].numpy(), [o.numpy() for o in out], t_p)


def fmks_pol_subset(precision) -> tuple:
    """Phase 3: the plain polarized version on phase 17's polarized cell
    in ``precision`` on every FMKS_POL_STRIDE-th ray of the float32
    camera's (float64 widens them), on one host core: (their positions,
    Stokes, seconds). Phase 17 holds its float64 route to the float64 run
    (exact) and both float32 versions to it (truth_gate)."""
    import torch
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    torch.set_num_threads(1)
    datasets, _ = fmks_datasets()
    grid, _ = fmks_snapshot(torch.float32, datasets=datasets)
    cfg = _fmks_pol_full_config()
    card_args, _, _ = _pol_args(cfg, grid)
    if precision == "float64":
        grid, _ = fmks_snapshot(torch.float64, datasets=datasets)
    sub, kwargs, geom = _host_subset(
        cfg, card_args, _host_grid(grid), FMKS_POL_STRIDE,
        _fmks_pol_full_config("float64") if precision == "float64" else None)
    del card_args, grid
    out, t_p = _timed(pk.render_polarized_reference, *sub, **kwargs)
    return sub[0].numpy(), _pol_stokes(out, sub, geom, True), t_p


def _fmks_pol_full_config(precision="float32"):
    return _fmks_config("golden_polarized_rk4_32.input",
                        camera_resolution=FMKS_RES, precision=precision,
                        ray_integrator="rk4", ray_max_steps=FMKS_STEPS,
                        image_rotation_split=False)


def _fmks_check_args(name, precision, **overrides):
    """The small FMKS check's renderer arguments (FMKS_CHECK_GRID)."""
    import torch
    dtype = torch.float32 if precision == "float32" else torch.float64
    grid, _ = fmks_snapshot(dtype, FMKS_CHECK_GRID)
    return _fmks_config(name, precision=precision, **overrides), grid


def check_fmks_simulation(population, integrator, precision,
                          interp=True) -> tuple:
    """The FMKS instantiation of the simulation kernel (thermal or the
    mixture) against its plain version at FMKS_CHECK_RES^2: rk4 float64
    exact (rtol 1e-9, 400 steps of 0.04), dp float32 statistical (steps of
    0.04 within the input's budget of 2000, which no ray nears: a float32
    dp ray near its budget can end flagged in one version and not the
    other)."""
    from blacklight_tpu_torch.grid import sampling
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    steps = MIX_CHECK_STEPS if integrator != "dp" else {"ray_step": 0.04}
    cfg, grid = _fmks_check_args(
        "golden_sim_rk4_32.input" if population == "thermal" else MIX_INPUT,
        precision, camera_resolution=FMKS_CHECK_RES,
        ray_integrator=integrator, simulation_interp=interp, **steps)
    args, kwargs = _sim_args(cfg, grid)
    counts = sk.MODE_LAUNCHES if population == "thermal" \
        else sk.MIXTURE_MODE_LAUNCHES
    before = counts[sampling.FMKS]
    out_k, t_k = _timed(sk.render_simulation, *args, **kwargs)
    launched = counts[sampling.FMKS] - before
    out_p, t_p = _timed(sk.render_simulation_reference, *args, **kwargs)
    exact = integrator != "dp" and precision == "float64"
    result = _check_exact(out_k, out_p, 1e-9 if exact else None)
    result["ok"] = bool(result["ok"] and launched == 1)
    return "fmks_kernel_vs_plain", dict(
        population=population, integrator=integrator, precision=precision,
        interp=interp, fmks_launches=launched, kernel_s=t_k, plain_s=t_p,
        **result)


def check_fmks_phase() -> tuple:
    """The FMKS phase kernel against its plain version at
    FMKS_CHECK_RES^2 (MIX_CHECK_STEPS): the second phase of
    MIX_PHASE_STEPS from the kernel's carried state after the first, rk4
    float64 exact."""
    import numpy as np
    from blacklight_tpu_torch.grid import sampling
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    cfg, grid = _fmks_check_args("golden_sim_rk4_32.input", "float64",
                                 camera_resolution=FMKS_CHECK_RES,
                                 ray_integrator="rk4", **MIX_CHECK_STEPS)
    args, _ = _sim_args(cfg, grid)
    before = sk.PHASE_MODE_LAUNCHES[sampling.FMKS]
    out_k, out_p, t_k, t_p, rays, samples = _second_phase(
        args, "rk4", MIX_PHASE_STEPS)
    launched = sk.PHASE_MODE_LAUNCHES[sampling.FMKS] - before
    result = _check_exact(out_k, out_p, 1e-9)
    result["ok"] = bool(result["ok"] and launched == 2)
    a, b = out_k[0].cpu().numpy(), out_p[0].cpu().numpy()
    both = np.isfinite(a) & np.isfinite(b)
    result["max_abs_err"] = float(np.max(np.abs(a[both] - b[both]))) \
        if both.any() else 0.0
    return "fmks_phase_kernel_vs_plain", dict(
        integrator="rk4", precision="float64", phase_steps=MIX_PHASE_STEPS,
        phase_rays=rays, phase_samples=samples, fmks_launches=launched,
        kernel_s=t_k, plain_s=t_p, **result)


FMKS_CHECKS = (("thermal", "rk4", "float64", True),
               ("thermal", "rk4", "float64", False),
               ("mixture", "rk4", "float64", True),
               ("thermal", "dp", "float32", True))


def _only_mode(counts, kind, mode) -> bool:
    """Whether ``counts`` (_launch_counts) hold launches of ``kind``'s
    kernel in ``mode`` and of no other kernel or mode."""
    launched = sum(sum(v) if isinstance(v, list) else v
                   for v in counts.values())
    return counts[kind][mode] > 0 and launched == counts[kind][mode]


def _fmks_counts(fk, sk, pk) -> dict:
    """_launch_counts with the mixture's kernels by mode."""
    return {**_launch_counts(fk, sk, pk),
            "mixture": list(sk.MIXTURE_MODE_LAUNCHES),
            "phase_mixture": list(sk.PHASE_MIXTURE_MODE_LAUNCHES),
            "derive_mixture": list(pk.DERIVE_MIXTURE_MODE_LAUNCHES)}


def _zero_fmks_counts(fk, sk, pk) -> None:
    _zero_counts(fk, sk, pk)
    for counts in (sk.MIXTURE_MODE_LAUNCHES, sk.PHASE_MIXTURE_MODE_LAUNCHES,
                   pk.DERIVE_MIXTURE_MODE_LAUNCHES):
        counts[:] = [0] * len(counts)
    sk.MIXTURE_LAUNCHES = sk.PHASE_MIXTURE_LAUNCHES = 0
    pk.DERIVE_MIXTURE_LAUNCHES = 0


def phase_fmks_full_width(card: str, grids: dict, checks: dict,
                          host: dict) -> list:
    """Phase 17; ``checks``: phase 3's FMKS results ("plain" by cell,
    "pol_plain", "phase"); ``host``: fmks_host_prep's result (the FMKS
    datasets and the harm3d file, made while phase 3 ran). Returns the
    kernels line's entries."""
    import numpy as np
    import torch
    from blacklight_tpu_torch import pipeline, pipeline_simulation as ps
    from blacklight_tpu_torch.grid import mks, sampling
    from blacklight_tpu_torch.grid.harm3d import load_harm3d
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk

    res, n = FMKS_RES, FMKS_RES * FMKS_RES
    if "float32" not in grids:
        grids["float32"] = full_width_snapshot(torch.float32)
    t_phase = time.perf_counter()
    fmks, t_fmks = fmks_snapshot(torch.float32, datasets=host["datasets"])
    # the inverse table alone, on the card (part of load_s)
    params = mks.FmksParams(h=0.3, r_in=fmks.map_r_in, poly_xt=0.82,
                            poly_alpha=14.0, mks_smooth=0.5)
    r_out = float(np.exp(fmks.host_faces[0][0, -1]))
    _, t_map = _timed(mks.generate_sks_map, params, fmks.map_r_in, r_out,
                      device=fmks.prim.device)
    harm_path = host["harm3d_path"]
    tmp = harm_path.parent
    harm, t_harm = _timed(load_harm3d, str(harm_path),
                          _harm3d_full_config(harm_path),
                          device=fmks.prim.device, dtype=torch.float32)
    emit("fmks_snapshots", card=card, grid=list(fmks.prim.shape[:1:-1]),
         fmks_write_s=host["write_s"], fmks_load_s=t_fmks["load_s"],
         generate_sks_map_s=t_map, sks_map=list(fmks.sks_map.shape),
         sks_map_mb=fmks.sks_map.numel() * 4 / 1e6,
         fmks_table_mb=grid_bytes(fmks) / 1e6,
         harm3d_write_s=host["harm3d_write_s"],
         harm3d_file_mb=harm_path.stat().st_size / 1e6,
         harm3d_load_s=t_harm, harm3d_table_mb=grid_bytes(harm) / 1e6)

    # each cell through pipeline.run, every count zeroed just before and
    # read just after
    runs = {
        "fmks": (_fmks_full_config(), fmks, "simulation", sampling.FMKS),
        "fmks_mix": (_fmks_full_config(MIX_INPUT), fmks, "mixture",
                     sampling.FMKS),
        "fmks_pol": (_fmks_pol_full_config(), fmks, "derive",
                     sampling.FMKS),
        "harm3d": (_harm3d_full_config(harm_path), None, "simulation",
                   sampling.SINGLE)}
    images, launches = {}, {}
    for cell, (cfg, grid, kind, mode) in runs.items():
        cfg.output_file = str(tmp / f"{cell}.npz")
        _zero_fmks_counts(fk, sk, pk)
        arrays, run_s = _timed(pipeline.run, cfg, quiet=True, device="cuda",
                               grid=grid)
        counts = _fmks_counts(fk, sk, pk)
        image = arrays["I_nu"]
        finite = np.isfinite(image)
        if kind == "derive":
            # the route's three kernels, its derive launches all FMKS
            stages = dict(pk.STAGE_LAUNCHES)
            only = (all(stages.values())
                    and counts["derive"][mode] == stages["derive"]
                    and counts["polarized"] == sum(stages.values())
                    and not (counts["formula"] or sum(counts["simulation"])
                             or sum(counts["phase"])
                             or sum(counts["derive_mixture"])))
        else:
            only = _only_mode(counts, kind, mode)
        ok = bool(image.shape == (res, res) and finite.any() and only)
        if cell == "fmks_pol":
            ok = ok and all(np.isfinite(arrays[k][finite]).all()
                            for k in STOKES)
        emit("fmks_main_path", cell=cell, resolution=res,
             precision="float32", integrator="rk4", max_steps=FMKS_STEPS,
             seconds=run_s, launches=counts,
             stage_launches=dict(pk.STAGE_LAUNCHES) if kind == "derive"
             else None, nan_pixels=int((~finite).sum()),
             max_I_nu=float(np.nanmax(image)), ok=ok)
        if not ok:
            raise RuntimeError(f"{cell}: the main path did not render through "
                               f"the kernel of its mode: {counts}")
        images[cell] = image
        launches[cell] = counts[kind][mode] if kind != "derive" \
            else counts["polarized"]

    # the phased route on fmks: bit for bit its monolithic image
    ps.KERNEL_PHASED = True
    try:
        _zero_fmks_counts(fk, sk, pk)
        phased = pipeline.run(_fmks_full_config(), quiet=True, device="cuda",
                              grid=fmks)
        counts = _fmks_counts(fk, sk, pk)
    finally:
        ps.KERNEL_PHASED = False
    a, b = phased["I_nu"], images["fmks"]
    same = bool(np.array_equal(np.isnan(a), np.isnan(b))
                and np.array_equal(a[~np.isnan(a)], b[~np.isnan(b)]))
    phase_launches = counts["phase"][sampling.FMKS]
    emit("fmks_phased", resolution=res, card=card,
         phase_steps=ps.KERNEL_PHASE_STEPS, launches=counts,
         identical_to_monolithic=same)
    if not same or not _only_mode(counts, "phase", sampling.FMKS):
        raise RuntimeError("the FMKS phased route launched no FMKS phase "
                           "kernel, another kernel, or its image differs "
                           f"from the monolithic one: {counts}")

    # each kernel alone in spatial_order, best of 3 in turns with the SKS
    # single block (phase 7's cell), each held to phase 3's plain version
    # on every PLAIN_STRIDE-th ray of the camera's
    cells = {"single": _sim_args(_sim_config(
        camera_resolution=res, precision="float32", ray_integrator="rk4",
        ray_max_steps=FMKS_STEPS), grids["float32"])}
    cells.update({c: _sim_args(_fmks_cell_config(c),
                               fmks if c != "harm3d" else harm)
                  for c in FMKS_CELLS})
    bundles = {c: _spatial(args) for c, (args, _) in cells.items()}
    kwargs = cells["single"][1]
    best, times, outs = _best_in_turns({
        c: (lambda b=b: sk.render_simulation(*b, **kwargs))
        for c, b in bundles.items()})
    entries, pick = [], np.arange(0, n, PLAIN_STRIDE)
    kinds = {"fmks": "simulation_fmks", "fmks_mix": "simulation_mixture_fmks",
             "harm3d": "simulation"}
    names = {"fmks": "simulation_fmks_kernel",
             "fmks_mix": "simulation_mixture_kernel (FMKS)",
             "harm3d": "simulation_kernel (harm3d grid)"}
    for c in FMKS_CELLS:
        args = cells[c][0]
        positions, plain, t_plain = checks["plain"][c]
        if not np.array_equal(positions, args[0][pick].cpu().numpy()):
            raise RuntimeError("the plain version traced other rays")
        out_cam = sk.render_simulation(*args, **kwargs)
        gate = gate_outputs([out_cam[0].cpu().numpy()[pick]], [plain[0]])
        mean = float(outs[c][2].double().mean())
        grid = args[6]
        b = bound(kinds[c], "rk4", "float32", n, mean,
                  in_bytes=grid_bytes(grid), out_values=1)
        emit("fmks_timing", cell=c, resolution=res, card=card,
             order="spatial_order", kernel_s_runs=times[c],
             kernel_ms=best[c] * 1e3, single_block_ms=best["single"] * 1e3,
             over_single_block=best[c] / best["single"],
             mean_n_samples=mean, plain_ms=t_plain * 1e3,
             plain_rays=pick.size, gate="statistical (bench.py:181-186)",
             **gate, **b, kernel_over_bound=best[c] * 1e3 / b["bound_ms"],
             clocks_power=smi(["nvidia-smi", "--query-gpu=clocks.sm,"
                               "power.draw,temperature.gpu",
                               "--format=csv,noheader"]))
        if not gate["ok"]:
            raise RuntimeError(f"{c} disagrees with plain at {res}^2: {gate}")
        entries.append({
            "name": names[c], "route": "cuda", "source": FMKS_SOURCE,
            "replaces": SIM_KERNEL_REPLACES, "cell": c,
            "launches": launches[c], "max_abs_err": gate["max_abs_err"],
            "ms": best[c] * 1e3, "plain_ms": t_plain * 1e3,
            "plain_rays": int(pick.size),
            **{k: b[k] for k in ("bound_ms", "bound_by")},
            "single_block_ms": best["single"] * 1e3, "library_ms": None})

    # the FMKS phase kernel on the route's own second phase at full width
    phase_check = checks["phase"]
    out2_k, _, t2_k, _, rays2, samples2 = _second_phase(
        cells["fmks"][0], "rk4", ps.KERNEL_PHASE_STEPS, with_plain=False)
    b_phase = phase_bound(rays2, samples2, "float32", grid_bytes(fmks),
                          kind="simulation_fmks")
    emit("fmks_phase_timing", resolution=res, card=card,
         phase_steps=ps.KERNEL_PHASE_STEPS, second_phase_rays=rays2,
         second_phase_kernel_ms=t2_k * 1e3, **b_phase)
    entries.append({
        "name": "simulation_phase_fmks_kernel", "route": "cuda",
        "source": SIM_KERNEL_SOURCE, "replaces": PHASE_REPLACES,
        "launches": phase_launches,
        "max_abs_err": phase_check["max_abs_err"], "ms": t2_k * 1e3,
        "plain_ms": phase_check["plain_s"] * 1e3,
        "plain_rays": phase_check["phase_rays"],
        "kernel_ms_at_plain_rays": phase_check["kernel_s"] * 1e3,
        **{k: b_phase[k] for k in ("bound_ms", "bound_by")},
        "library_ms": None})

    # the polarized route with the FMKS derive kernel, best of 3 in turns
    # with phase 9's SKS route
    (args_f, kw_p, geom), _ = _timed(_pol_args, _fmks_pol_full_config(),
                                     fmks)
    args_s, _, _ = _pol_args(_pol_full_config("float32", "rk4"),
                             grids["float32"])
    pol = {"fmks": _spatial(args_f), "single": _spatial(args_s)}
    best_p, times_p, outs_p = _best_in_turns({
        c: (lambda b=b: pk.render_polarized(*b, **kw_p))
        for c, b in pol.items()})
    stages = {c: _pol_stage_times(b, kw_p)["stage_ms"]
              for c, b in pol.items()}
    # held as phase 9 holds its route (truth_gate) and the float64 route
    # exactly, on the same rays: float32 polarized transfer of this torus
    # is ill-conditioned (PERF.md, Findings), so the float32 route
    # is held to the float32 plain version only through their errors to
    # float64
    positions, plain_stokes, t_plain_p = checks["pol_plain"]
    positions64, truth, t_truth = checks["pol_truth"]
    pol_pick = np.arange(0, n, FMKS_POL_STRIDE)
    if not (np.array_equal(positions, args_f[0][pol_pick].cpu().numpy())
            and np.array_equal(positions64, positions.astype(np.float64))):
        raise RuntimeError("the plain version traced other rays")
    ours = _pol_stokes(pk.render_polarized(*args_f, **kw_p), args_f, geom,
                       True)
    ours = {k: v[pol_pick] for k, v in ours.items()}
    pol_gate = polarized_gate(ours, plain_stokes, exact=False)
    to_truth = truth_gate(ours, plain_stokes, truth)
    fmks64, _ = fmks_snapshot(torch.float64, datasets=host["datasets"])
    args64, kw64, geom64 = _pol_args(_fmks_pol_full_config("float64"),
                                     fmks64)
    pick_t = torch.as_tensor(pol_pick, device=args64[0].device)
    sub64 = (*(a[pick_t].contiguous() for a in (args_f[0].double(),
                                                 args_f[1].double(),
                                                 args_f[2].double())),
             args_f[3].double(), *args64[4:-1], args_f[-1])
    gate64 = polarized_gate(_pol_stokes(pk.render_polarized(*sub64, **kw64),
                                        sub64, geom64, True), truth, True)
    del fmks64
    mean_p = float(outs_p["fmks"][3].double().mean())
    b_pol = bound("polarized_fmks", "rk4", "float32", n, mean_p,
                  in_bytes=grid_bytes(fmks), out_values=16,
                  extra_out_bytes=12)
    emit("fmks_pol_timing", resolution=res, card=card, order="spatial_order",
         kernel_s_runs=times_p, route_ms=best_p["fmks"] * 1e3,
         single_block_route_ms=best_p["single"] * 1e3,
         over_single_block=best_p["fmks"] / best_p["single"],
         stage_ms=stages, mean_n_samples=mean_p, plain_ms=t_plain_p * 1e3,
         plain_rays=pol_pick.size, float32_plain=pol_gate,
         float64_truth=to_truth, float64_route=gate64,
         gate="float32: NaN sets, within 3x the plain version's error to "
              "float64 (truth_gate); float64 route exact (polarized_gate)",
         **b_pol)
    if not (pol_gate["same_nan"] and to_truth["ok"] and gate64["ok"]):
        raise RuntimeError(f"the FMKS polarized route disagrees with plain "
                           f"at {res}^2: {pol_gate}, against float64 "
                           f"{to_truth}, float64 route {gate64}")
    entries.append({
        "name": "polarized_kernel (FMKS derive)", "route": "cuda",
        "source": POL_KERNEL_SOURCE, "replaces": POL_KERNEL_REPLACES,
        "launches": launches["fmks_pol"],
        "max_abs_err": pol_gate["max_abs_err"],
        "max_abs_err_float64": gate64["max_abs_err"],
        "ms": best_p["fmks"] * 1e3,
        "plain_ms": t_plain_p * 1e3, "plain_rays": int(pol_pick.size),
        **{k: b_pol[k] for k in ("bound_ms", "bound_by")},
        "single_block_ms": best_p["single"] * 1e3,
        "derive_ms": stages["fmks"]["derive"],
        "single_block_derive_ms": stages["single"]["derive"],
        "library_ms": None})
    emit("fmks_phase", card=card, seconds=time.perf_counter() - t_phase)
    return entries


# Phase 18: AthenaK snapshots in Cartesian Kerr-Schild (CKS) coordinates
# (ROADMAP B.4). FULL_GRID's torus on write_athenak's cube (half-width
# r_max / sqrt(2)) at the golden inputs' spin (0), written by
# scripts/mock_athenak.write_blocks: a root grid of ATHENAK_ROOT^3 blocks
# of ATHENAK_CELLS^3 cells (256^3) with the central 2 x 2 x 2 root blocks
# refined once (568 blocks, 18.6 M cells, ~600 MB of float32), in a file
# under build/ that the port's load_athenak reads. The cube is smaller
# than the camera's distance, so off-grid samples take fallback values
# (fallback_nan off, test_loaders.py's fallback_rho and fallback_pgas).
ATHENAK_SOURCE = "blacklight_tpu_torch/csrc/sim_sample.cuh"
# The file's directory, which phase 3's jobs read it from (emptied at the
# script's start and removed at its end)
ATHENAK_DIR = ROOT / "build" / "kernels" / "athenak"
ATHENAK_ROOT, ATHENAK_CELLS = 8, 32
ATHENAK_REFINE = tuple((i, j, k) for i in (3, 4) for j in (3, 4)
                       for k in (3, 4))
ATHENAK_RES, ATHENAK_STEPS = 1024, 2000
ATHENAK_FALLBACK = dict(fallback_nan=False, fallback_rho=1.0e-8,
                        fallback_pgas=1.0e-10)
# Phase 3's checks: the same cube at 2^3 root blocks of 16^3 cells, two
# of them refined (22 blocks), 400 steps of 0.04 at 128^2.
ATHENAK_CHECK_LAYOUT = dict(root=2, cells=16, refine=((1, 1, 1), (0, 1, 1)))
ATHENAK_CHECK_RES = 128
# The polarized cell's plain rays: every ATHENAK_POL_STRIDE-th (1,024), in
# float32 and in float64
ATHENAK_POL_STRIDE = 4 * PLAIN_STRIDE
# Phase 18's unpolarized cells: name -> (input, sampling overrides)
ATHENAK_RUNS = {
    "athenak_amr": ("golden_sim_rk4_32.input",
                    {"simulation_block_interp": True}),
    "athenak": ("golden_sim_rk4_32.input", {}),
    "athenak_mix": (MIX_INPUT, {}),
}


def write_athenak_file(directory: pathlib.Path, layout=None) -> tuple:
    """The AthenaK file of FULL_GRID's torus in ``directory`` (phase 18's
    layout, or write_blocks' keywords ``layout``), written under a
    temporary name and then renamed, so that a reader waiting for the
    name sees the whole file: (path, the writer's seconds)."""
    mock = _mock()
    mock_athenak = _mock_athenak()
    p = dict(mock.DEFAULTS, **FULL_GRID)
    layout = layout or dict(root=ATHENAK_ROOT, cells=ATHENAK_CELLS,
                            refine=ATHENAK_REFINE)
    path = directory / "athenak.bin"
    t0 = time.perf_counter()
    mock_athenak.write_blocks(str(path.with_suffix(".part")), p, **layout)
    path.with_suffix(".part").rename(path)
    return path, time.perf_counter() - t0


def _wait_for(path: pathlib.Path, limit_s=600.0) -> None:
    """Wait until ``path`` exists (the main process writes phase 18's
    file while phase 3's jobs run)."""
    t0 = time.perf_counter()
    while not path.exists():
        if time.perf_counter() - t0 > limit_s:
            raise RuntimeError(f"{path} was not written")
        time.sleep(0.5)


def athenak_snapshot(path, dtype, table=None) -> tuple:
    """The AthenaK file at ``path`` on the card in ``dtype`` through
    load_athenak, with its neighbour table (``table``: a grid of the same
    file whose table to take): (grid, load seconds, table seconds)."""
    import dataclasses
    import torch
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.grid.amr import with_amr_table
    from blacklight_tpu_torch.grid.athenak import load_athenak
    device = pipeline.resolve_device("cuda")
    t0 = time.perf_counter()
    grid = load_athenak(str(path), device=device, dtype=dtype)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if table is not None:
        grid = dataclasses.replace(grid, amr_table=table.amr_table,
                                   loc_parity=table.loc_parity)
    else:
        grid = with_amr_table(grid)
        torch.cuda.synchronize()
    return grid, t1 - t0, time.perf_counter() - t1


def _athenak_config(name="golden_sim_rk4_32.input", **overrides):
    """``name`` as an AthenaK configuration (the snapshot is passed to the
    renderer) with ATHENAK_FALLBACK."""
    from blacklight_tpu_torch.constants import Coordinates, SimulationFormat
    return _sim_config(name, simulation_format=SimulationFormat.athenak,
                       simulation_coord=Coordinates.cks,
                       **{**ATHENAK_FALLBACK, **overrides})


def _athenak_cell_config(cell, precision="float32", **overrides):
    """Phase 18's ``cell``: phase 7's (1024^2, rk4, 2000 steps)."""
    name, sampling_overrides = ATHENAK_RUNS[cell]
    return _athenak_config(name, camera_resolution=ATHENAK_RES,
                           precision=precision, ray_integrator="rk4",
                           ray_max_steps=ATHENAK_STEPS,
                           **sampling_overrides, **overrides)


def _athenak_pol_config(precision="float32"):
    return _athenak_config("golden_polarized_rk4_32.input",
                           camera_resolution=ATHENAK_RES, precision=precision,
                           ray_integrator="rk4", ray_max_steps=ATHENAK_STEPS,
                           image_rotation_split=False)


def athenak_plain_subset(cell) -> tuple:
    """Phase 3: the plain version on phase 18's ``cell`` on every
    PLAIN_STRIDE-th ray, on the card (its block search over 568 blocks
    made the version on one host core 1.6-1.9x slower, PERF.md), once the
    main process has written the file (athenak_path()): (their positions,
    (I_nu, flags, n_samples), seconds), numpy."""
    import torch
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    path = athenak_path()
    _wait_for(path)
    grid, _, _ = athenak_snapshot(path, torch.float32)
    args, kwargs = _sim_args(_athenak_cell_config(cell), grid)
    pick = torch.arange(0, args[0].shape[0], PLAIN_STRIDE,
                        device=args[0].device)
    sub = (*(a[pick].contiguous() for a in args[:3]), *args[3:])
    out, t_p = _timed(sk.render_simulation_reference, *sub, **kwargs)
    return (sub[0].cpu().numpy(), [o.cpu().numpy() for o in out], t_p)


def athenak_pol_subset(precision) -> tuple:
    """Phase 3: the plain polarized version on phase 18's polarized cell
    in ``precision`` on every ATHENAK_POL_STRIDE-th ray of the float32
    camera's (float64 widens them), on one host core: (their positions,
    Stokes, seconds)."""
    import torch
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    torch.set_num_threads(1)
    path = athenak_path()
    _wait_for(path)
    grid, _, _ = athenak_snapshot(path, torch.float32)
    card_args, _, _ = _pol_args(_athenak_pol_config(), grid)
    if precision == "float64":
        grid, _, _ = athenak_snapshot(path, torch.float64, table=grid)
    sub, kwargs, geom = _host_subset(
        _athenak_pol_config(), card_args, _host_grid(grid),
        ATHENAK_POL_STRIDE,
        _athenak_pol_config("float64") if precision == "float64" else None)
    del card_args, grid
    out, t_p = _timed(pk.render_polarized_reference, *sub, **kwargs)
    return sub[0].numpy(), _pol_stokes(out, sub, geom, False), t_p


def _athenak_check_args(name, precision, **overrides):
    """The small AthenaK check's configuration and snapshot
    (ATHENAK_CHECK_LAYOUT, written to a temporary file)."""
    import torch
    dtype = torch.float32 if precision == "float32" else torch.float64
    with tempfile.TemporaryDirectory(dir=ROOT / "build" / "kernels") as tmp:
        path, _ = write_athenak_file(pathlib.Path(tmp), ATHENAK_CHECK_LAYOUT)
        grid, _, _ = athenak_snapshot(path, dtype)
    return _athenak_config(name, precision=precision, **overrides), grid


# Phase 3's checks: (population, integrator, precision, sampling)
ATHENAK_SAMPLING = {"interblock": {"simulation_block_interp": True},
                    "trilinear": {}, "nearest": {"simulation_interp": False}}
ATHENAK_CHECKS = (("thermal", "rk4", "float64", "interblock"),
                  ("thermal", "rk4", "float64", "nearest"),
                  ("mixture", "rk4", "float64", "interblock"),
                  ("thermal", "dp", "float32", "trilinear"))


def check_athenak_simulation(population, integrator, precision,
                             sampling_name) -> tuple:
    """The CKS instantiation of the simulation kernel (thermal or the
    mixture) against its plain version at ATHENAK_CHECK_RES^2: rk4 float64
    exact (rtol 1e-9, 400 steps of 0.04), dp float32 statistical (steps of
    0.04 within the input's budget of 2000)."""
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    steps = MIX_CHECK_STEPS if integrator != "dp" else {"ray_step": 0.04}
    cfg, grid = _athenak_check_args(
        "golden_sim_rk4_32.input" if population == "thermal" else MIX_INPUT,
        precision, camera_resolution=ATHENAK_CHECK_RES,
        ray_integrator=integrator, **ATHENAK_SAMPLING[sampling_name],
        **steps)
    args, kwargs = _sim_args(cfg, grid)
    mode = sk.kernel_mode(grid, args[5].sampler)
    counts = sk.MODE_LAUNCHES if population == "thermal" \
        else sk.MIXTURE_MODE_LAUNCHES
    before = counts[mode]
    out_k, t_k = _timed(sk.render_simulation, *args, **kwargs)
    launched = counts[mode] - before
    out_p, t_p = _timed(sk.render_simulation_reference, *args, **kwargs)
    exact = integrator != "dp" and precision == "float64"
    result = _check_exact(out_k, out_p, 1e-9 if exact else None)
    result["ok"] = bool(result["ok"] and launched == 1
                        and mode in (sk.CKS_BLOCKS, sk.CKS_INTERBLOCK))
    return "athenak_kernel_vs_plain", dict(
        population=population, integrator=integrator, precision=precision,
        sampling=sampling_name, kernel_mode=mode, blocks=grid.n_blocks,
        cks_launches=launched, kernel_s=t_k, plain_s=t_p, **result)


def check_athenak_phase() -> tuple:
    """The CKS phase kernel against its plain version at
    ATHENAK_CHECK_RES^2 (MIX_CHECK_STEPS), exact interblock sampling: the
    second phase of MIX_PHASE_STEPS from the kernel's carried state after
    the first, rk4 float64 exact."""
    import numpy as np
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    cfg, grid = _athenak_check_args(
        "golden_sim_rk4_32.input", "float64",
        camera_resolution=ATHENAK_CHECK_RES, ray_integrator="rk4",
        **ATHENAK_SAMPLING["interblock"], **MIX_CHECK_STEPS)
    args, _ = _sim_args(cfg, grid)
    before = sk.PHASE_MODE_LAUNCHES[sk.CKS_INTERBLOCK]
    out_k, out_p, t_k, t_p, rays, samples = _second_phase(
        args, "rk4", MIX_PHASE_STEPS)
    launched = sk.PHASE_MODE_LAUNCHES[sk.CKS_INTERBLOCK] - before
    result = _check_exact(out_k, out_p, 1e-9)
    result["ok"] = bool(result["ok"] and launched == 2)
    a, b = out_k[0].cpu().numpy(), out_p[0].cpu().numpy()
    both = np.isfinite(a) & np.isfinite(b)
    result["max_abs_err"] = float(np.max(np.abs(a[both] - b[both]))) \
        if both.any() else 0.0
    return "athenak_phase_kernel_vs_plain", dict(
        integrator="rk4", precision="float64", phase_steps=MIX_PHASE_STEPS,
        phase_rays=rays, phase_samples=samples, cks_launches=launched,
        kernel_s=t_k, plain_s=t_p, **result)


def athenak_host_prep() -> dict:
    """Phase 18's host work, which the main process does while phase 3's
    jobs run: the AthenaK file (athenak_path()), with the writer's
    seconds and the file's size."""
    path, write_s = write_athenak_file(ATHENAK_DIR)
    return {"path": path, "write_s": write_s,
            "file_mb": path.stat().st_size / 1e6}


def athenak_path() -> pathlib.Path:
    """Where athenak_host_prep writes phase 18's file."""
    return ATHENAK_DIR / "athenak.bin"


def phase_athenak_full_width(card: str, grids: dict, checks: dict,
                             host: dict) -> list:
    """Phase 18; ``checks``: phase 3's AthenaK results ("plain" by cell,
    "pol_plain", "pol_truth", "phase"); ``host``: athenak_host_prep's
    result (the file, written while phase 3 ran). Returns the kernels
    line's entries."""
    import numpy as np
    import torch
    from blacklight_tpu_torch import pipeline, pipeline_simulation as ps
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk

    res, n = ATHENAK_RES, ATHENAK_RES * ATHENAK_RES
    t_phase = time.perf_counter()
    path = host["path"]
    device = torch.device("cuda", torch.cuda.current_device())
    allocated = torch.cuda.memory_allocated(device)
    gc.collect()
    torch.cuda.empty_cache()
    memory = {"allocated_bytes_at_entry": allocated,
              "allocated_bytes_after_gc": torch.cuda.memory_allocated(device)}
    grid, load_s, table_s = athenak_snapshot(path, torch.float32)
    if "mb_amr" not in grids:
        grids["mb_amr"] = mesh_grid("amr", torch.float32)
    emit("athenak_snapshot", card=card, blocks=grid.n_blocks,
         cells=int(grid.prim[0].numel()),
         levels=sorted(set(grid.levels.tolist())),
         block_cells=list(grid.prim.shape[:1:-1]),
         half_width=float(grid.host_faces[0].max()),
         file_mb=host["file_mb"], write_s=host["write_s"],
         load_athenak_s=load_s, neighbour_table_s=table_s,
         table_mb=grid_bytes(grid) / 1e6, **memory,
         route_free_bytes=pk.free_device_bytes(device))

    # each cell through pipeline.run, every count zeroed just before and
    # read just after
    expect = {"athenak_amr": sk.CKS_INTERBLOCK, "athenak": sk.CKS_BLOCKS,
              "athenak_mix": sk.CKS_BLOCKS, "athenak_pol": sk.CKS_BLOCKS}
    images, launches = {}, {}
    for cell, mode in expect.items():
        cfg = _athenak_pol_config() if cell == "athenak_pol" \
            else _athenak_cell_config(cell)
        cfg.output_file = str(path.parent / f"{cell}.npz")
        kind = {"athenak_mix": "mixture",
                "athenak_pol": "derive"}.get(cell, "simulation")
        _zero_fmks_counts(fk, sk, pk)
        arrays, run_s = _timed(pipeline.run, cfg, quiet=True, device="cuda",
                               grid=grid)
        counts = _fmks_counts(fk, sk, pk)
        image = arrays["I_nu"]
        finite = np.isfinite(image)
        if kind == "derive":
            # the route's three kernels, its derive launches all CKS
            stages = dict(pk.STAGE_LAUNCHES)
            only = (all(stages.values())
                    and counts["derive"][mode] == stages["derive"]
                    and counts["polarized"] == sum(stages.values())
                    and not (counts["formula"] or sum(counts["simulation"])
                             or sum(counts["phase"])
                             or sum(counts["derive_mixture"])))
        else:
            only = _only_mode(counts, kind, mode)
        ok = bool(image.shape == (res, res) and finite.all() and only
                  and np.nanmax(image) > 0.0)
        if cell == "athenak_pol":
            ok = ok and all(np.isfinite(arrays[k]).all() for k in STOKES)
        emit("athenak_main_path", cell=cell, resolution=res,
             precision="float32", integrator="rk4", max_steps=ATHENAK_STEPS,
             kernel_mode=mode, seconds=run_s, launches=counts,
             stage_launches=dict(pk.STAGE_LAUNCHES) if kind == "derive"
             else None, nan_pixels=int((~finite).sum()),
             max_I_nu=float(np.nanmax(image)), ok=ok)
        if not ok:
            raise RuntimeError(f"{cell}: the main path did not render through "
                               f"the CKS kernel of its mode: {counts}")
        images[cell] = image
        launches[cell] = counts[kind][mode] if kind != "derive" \
            else counts["polarized"]

    # athenak_amr's run again, warm (its first run is the grid's first)
    _, warm_s = _timed(pipeline.run, _athenak_cell_config("athenak_amr"),
                       quiet=True, device="cuda", grid=grid)
    emit("athenak_warm_run", cell="athenak_amr", card=card,
         seconds=warm_s)

    # the phased route on athenak_amr: bit for bit its monolithic image
    ps.KERNEL_PHASED = True
    try:
        _zero_fmks_counts(fk, sk, pk)
        phased, phased_s = _timed(pipeline.run,
                                  _athenak_cell_config("athenak_amr"),
                                  quiet=True, device="cuda", grid=grid)
        counts = _fmks_counts(fk, sk, pk)
    finally:
        ps.KERNEL_PHASED = False
    a, b = phased["I_nu"], images["athenak_amr"]
    same = bool(np.array_equal(np.isnan(a), np.isnan(b))
                and np.array_equal(a[~np.isnan(a)], b[~np.isnan(b)]))
    phase_launches = counts["phase"][sk.CKS_INTERBLOCK]
    emit("athenak_phased", resolution=res, card=card, seconds=phased_s,
         phase_steps=ps.KERNEL_PHASE_STEPS, launches=counts,
         identical_to_monolithic=same)
    if not same or not _only_mode(counts, "phase", sk.CKS_INTERBLOCK):
        raise RuntimeError("the CKS phased route launched no CKS phase "
                           "kernel, another kernel, or its image differs "
                           f"from the monolithic one: {counts}")

    # each kernel alone in spatial_order, best of 3 in turns with phase
    # 14's mb-amr, each held to phase 3's plain version on every
    # PLAIN_STRIDE-th ray of the camera's
    cells = {"mb_amr": _sim_args(_mesh_cell_config("mb_amr", "float32",
                                                   res=res),
                                 grids["mb_amr"])}
    cells.update({c: _sim_args(_athenak_cell_config(c), grid)
                  for c in ATHENAK_RUNS})
    bundles = {c: _spatial(args) for c, (args, _) in cells.items()}
    kwargs = cells["mb_amr"][1]
    best, times, outs = _best_in_turns({
        c: (lambda b=b: sk.render_simulation(*b, **kwargs))
        for c, b in bundles.items()})
    entries, pick = [], np.arange(0, n, PLAIN_STRIDE)
    kinds = {"athenak_amr": "simulation_cks_interblock",
             "athenak": "simulation_cks", "athenak_mix":
             "simulation_mixture_cks"}
    names = {"athenak_amr": "simulation_mode_kernel (CKS interblock)",
             "athenak": "simulation_mode_kernel (CKS blocks)",
             "athenak_mix": "simulation_mixture_kernel (CKS blocks)"}
    for c in ATHENAK_RUNS:
        args = cells[c][0]
        positions, plain, t_plain = checks["plain"][c]
        if not np.array_equal(positions, args[0][pick].cpu().numpy()):
            raise RuntimeError("the plain version traced other rays")
        out_cam = sk.render_simulation(*args, **kwargs)
        gate = gate_outputs([out_cam[0].cpu().numpy()[pick]], [plain[0]])
        mean = float(outs[c][2].double().mean())
        b = bound(kinds[c], "rk4", "float32", n, mean,
                  in_bytes=grid_bytes(grid), out_values=1)
        emit("athenak_timing", cell=c, resolution=res, card=card,
             order="spatial_order", kernel_s_runs=times[c],
             kernel_ms=best[c] * 1e3, mb_amr_ms=best["mb_amr"] * 1e3,
             over_mb_amr=best[c] / best["mb_amr"],
             mean_n_samples=mean, plain_ms=t_plain * 1e3,
             plain_rays=pick.size, gate="statistical (bench.py:181-186)",
             **gate, **b, kernel_over_bound=best[c] * 1e3 / b["bound_ms"],
             clocks_power=smi(["nvidia-smi", "--query-gpu=clocks.sm,"
                               "power.draw,temperature.gpu",
                               "--format=csv,noheader"]))
        if not gate["ok"]:
            raise RuntimeError(f"{c} disagrees with plain at {res}^2: {gate}")
        entries.append({
            "name": names[c], "route": "cuda", "source": ATHENAK_SOURCE,
            "replaces": SIM_KERNEL_REPLACES, "cell": c,
            "launches": launches[c], "max_abs_err": gate["max_abs_err"],
            "ms": best[c] * 1e3, "plain_ms": t_plain * 1e3,
            "plain_rays": int(pick.size),
            **{k: b[k] for k in ("bound_ms", "bound_by")},
            "mb_amr_ms": best["mb_amr"] * 1e3, "library_ms": None})

    # the CKS phase kernel on the route's own second phase at full width,
    # best of 3 in turns with the same second phase of the clamped
    # trilinear cell and of mb-amr (which sampling, which grid makes it
    # slower)
    phase_check = checks["phase"]
    steps = ps.KERNEL_PHASE_STEPS
    firsts = {c: _first_phase(cells[c][0], "rk4", steps)
              for c in ("athenak_amr", "athenak", "mb_amr")}
    second = {c: {"kernel_s_runs": []} for c in firsts}
    for _ in range(3):
        for c, (carry0, index, phase) in firsts.items():
            carry = sk.SimCarry(*(t.clone() for t in carry0))
            second[c]["kernel_s_runs"].append(_timed(
                sk.render_simulation_phase, carry, index, steps, steps,
                *phase)[1])
            second[c].update(rays=int(index.numel()), samples=int(
                (carry.n_samp[index.long()]
                 - carry0.n_samp[index.long()]).sum()))
    for c in second:
        second[c]["kernel_ms"] = min(second[c]["kernel_s_runs"]) * 1e3
    del firsts, carry
    t2_k = second["athenak_amr"]["kernel_ms"] / 1e3
    rays2, samples2 = (second["athenak_amr"][k] for k in ("rays", "samples"))
    b_phase = phase_bound(rays2, samples2, "float32", grid_bytes(grid),
                          kind="simulation_cks_interblock")
    emit("athenak_phase_timing", resolution=res, card=card,
         phase_steps=steps, second_phase_rays=rays2,
         second_phase_samples=samples2, second_phase_kernel_ms=t2_k * 1e3,
         second_phase_runs=second["athenak_amr"]["kernel_s_runs"],
         **{f"{c}_second_phase": second[c] for c in ("athenak", "mb_amr")},
         over_mb_amr=t2_k * 1e3 / second["mb_amr"]["kernel_ms"], **b_phase)
    entries.append({
        "name": "simulation_phase_mode_kernel (CKS interblock)",
        "route": "cuda", "source": SIM_KERNEL_SOURCE,
        "replaces": PHASE_REPLACES, "launches": phase_launches,
        "max_abs_err": phase_check["max_abs_err"], "ms": t2_k * 1e3,
        "plain_ms": phase_check["plain_s"] * 1e3,
        "plain_rays": phase_check["phase_rays"],
        "kernel_ms_at_plain_rays": phase_check["kernel_s"] * 1e3,
        **{k: b_phase[k] for k in ("bound_ms", "bound_by")},
        "library_ms": None})

    # the polarized route with the CKS derive kernel, best of 3 in turns
    # with phase 14's polarized route on mb-amr (interblock sampling)
    (args_k, kw_p, geom), _ = _timed(_pol_args, _athenak_pol_config(), grid)
    args_m, _, _ = _pol_args(_pol_config(
        camera_resolution=res, precision="float32", ray_integrator="rk4",
        ray_max_steps=ATHENAK_STEPS, image_rotation_split=False,
        simulation_block_interp=True), grids["mb_amr"])
    pol = {"athenak": _spatial(args_k), "mb_amr": _spatial(args_m)}
    best_p, times_p, outs_p = _best_in_turns({
        c: (lambda b=b: pk.render_polarized(*b, **kw_p))
        for c, b in pol.items()})
    stages = {c: _pol_stage_times(b, kw_p)["stage_ms"]
              for c, b in pol.items()}
    # held as phase 9 holds its route (truth_gate) and the float64 route
    # exactly, on the same rays
    positions, plain_stokes, t_plain_p = checks["pol_plain"]
    positions64, truth, _ = checks["pol_truth"]
    pol_pick = np.arange(0, n, ATHENAK_POL_STRIDE)
    if not (np.array_equal(positions, args_k[0][pol_pick].cpu().numpy())
            and np.array_equal(positions64, positions.astype(np.float64))):
        raise RuntimeError("the plain version traced other rays")
    ours = _pol_stokes(pk.render_polarized(*args_k, **kw_p), args_k, geom,
                       False)
    ours = {k: v[pol_pick] for k, v in ours.items()}
    pol_gate = polarized_gate(ours, plain_stokes, exact=False)
    to_truth = truth_gate(ours, plain_stokes, truth)
    grid64, _, _ = athenak_snapshot(path, torch.float64, table=grid)
    args64, kw64, geom64 = _pol_args(_athenak_pol_config("float64"), grid64)
    pick_t = torch.as_tensor(pol_pick, device=args64[0].device)
    sub64 = (*(a[pick_t].contiguous() for a in (args_k[0].double(),
                                                 args_k[1].double(),
                                                 args_k[2].double())),
             args_k[3].double(), *args64[4:-1], args_k[-1])
    gate64 = polarized_gate(_pol_stokes(pk.render_polarized(*sub64, **kw64),
                                        sub64, geom64, False), truth, True)
    del grid64
    mean_p = float(outs_p["athenak"][3].double().mean())
    b_pol = bound("polarized_cks", "rk4", "float32", n, mean_p,
                  in_bytes=grid_bytes(grid), out_values=16,
                  extra_out_bytes=12)
    emit("athenak_pol_timing", resolution=res, card=card,
         order="spatial_order", kernel_s_runs=times_p,
         route_ms=best_p["athenak"] * 1e3,
         mb_amr_route_ms=best_p["mb_amr"] * 1e3,
         over_mb_amr=best_p["athenak"] / best_p["mb_amr"],
         stage_ms=stages, mean_n_samples=mean_p, plain_ms=t_plain_p * 1e3,
         plain_rays=pol_pick.size, float32_plain=pol_gate,
         float64_truth=to_truth, float64_route=gate64,
         gate="float32: NaN sets, within 3x the plain version's error to "
              "float64 (truth_gate); float64 route exact (polarized_gate)",
         **b_pol)
    if not (pol_gate["same_nan"] and to_truth["ok"] and gate64["ok"]):
        raise RuntimeError(f"the CKS polarized route disagrees with plain "
                           f"at {res}^2: {pol_gate}, against float64 "
                           f"{to_truth}, float64 route {gate64}")
    entries.append({
        "name": "polarized_kernel (CKS derive)", "route": "cuda",
        "source": POL_KERNEL_SOURCE, "replaces": POL_KERNEL_REPLACES,
        "launches": launches["athenak_pol"],
        "max_abs_err": pol_gate["max_abs_err"],
        "max_abs_err_float64": gate64["max_abs_err"],
        "ms": best_p["athenak"] * 1e3,
        "plain_ms": t_plain_p * 1e3, "plain_rays": int(pol_pick.size),
        **{k: b_pol[k] for k in ("bound_ms", "bound_by")},
        "mb_amr_ms": best_p["mb_amr"] * 1e3,
        "derive_ms": stages["athenak"]["derive"],
        "mb_amr_derive_ms": stages["mb_amr"]["derive"],
        "library_ms": None})
    emit("athenak_phase", card=card, seconds=time.perf_counter() - t_phase)
    return entries


# Phase 19: plasma_model = code_kappa (ROADMAP B.2): the electron
# temperature from a ninth sampled primitive, the electron entropy, on
# the mixture's instantiations of K2.1, K2.3 and K3.1's derive kernel
# (csrc/sim_sample.cuh code_kappa_state; the thermal instantiations keep
# their SASS). Every snapshot takes kappa = KAPPA_SCALE * pgas /
# rho^gamma_adi of its own float32 rho and pgas (with_kappa):
# write_athena's field, scaled (scripts/mock_athenak.py KAPPA_SCALE says
# why).
CK_SOURCE = "blacklight_tpu_torch/csrc/sim_sample.cuh"
CK_RES, CK_STEPS = 1024, 2000
# The polarized cell's plain rays: every CK_POL_STRIDE-th (1,024), in
# float32 and in float64
CK_POL_STRIDE = 4 * PLAIN_STRIDE
# Phase 19's unpolarized cells: name -> (snapshot, input, sampling
# overrides); "ck" is phase 7's cell, the others the other sampling
# modes (each held on its PLAIN_STRIDE-th rays) and the mixture
CK_CELLS = {
    "ck": ("single", "golden_sim_rk4_32.input", {}),
    "ck_mix": ("single", MIX_INPUT, {}),
    "ck_amr": ("amr", "golden_sim_rk4_32.input",
               {"simulation_block_interp": True}),
    "ck_nearest": ("single", "golden_sim_rk4_32.input",
                   {"simulation_interp": False}),
    "ck_fmks": ("fmks", "golden_sim_rk4_32.input", {}),
    "ck_athenak": ("athenak", "golden_sim_rk4_32.input",
                   {"simulation_block_interp": True}),
}
# The cells whose plain version runs on the card (the AthenaK block
# search over 568 blocks is slower on one host core, PERF.md); the others
# run on one host core each
CK_CARD_PLAIN = ("ck_athenak",)
# The kernel mode each cell launches (ops/simulation_kernel.kernel_mode)
CK_MODES = {"ck": 0, "ck_mix": 0, "ck_amr": 2, "ck_nearest": 1,
            "ck_fmks": 3, "ck_athenak": 5}
# Phase 3's plain runs of phase 19's cells: (cell, precision)
CK_PLAIN = (("ck", "float32"), ("ck", "float64"), *(
    (cell, "float32") for cell in CK_CELLS if cell != "ck"))


def with_kappa(grid):
    """``grid`` with a ninth primitive "kappa" (scripts/mock_athenak.py
    with_kappa: KAPPA_SCALE * pgas / rho^gamma_adi of its float32 rho and
    pgas, formed in float64 and stored in float32)."""
    return _mock_athenak().with_kappa(grid, _mock().DEFAULTS["gamma_adi"])


def _ck_config(cell, precision="float32", polarized=False, **overrides):
    """Phase 19's ``cell`` (CK_CELLS; polarized: golden_polarized's input
    on the cell's snapshot) at CK_RES^2, rk4, CK_STEPS steps."""
    from blacklight_tpu_torch.constants import PlasmaModel
    snapshot, name, sampling = CK_CELLS[cell]
    if polarized:
        name = "golden_polarized_rk4_32.input"
        overrides = dict(image_rotation_split=False, **overrides)
    make = {"fmks": _fmks_config, "athenak": _athenak_config}.get(
        snapshot, _sim_config)
    return make(name, camera_resolution=CK_RES, precision=precision,
                ray_integrator="rk4", ray_max_steps=CK_STEPS,
                plasma_model=PlasmaModel.code_kappa,
                simulation_kappa_name="kappa", **sampling, **overrides)


def ck_snapshot(cell, dtype, grids=None):
    """The snapshot of phase 19's ``cell`` on the card in ``dtype``, with
    its kappa slot (``grids``: phase 7's and phase 14's grids by key,
    reused where present)."""
    import torch
    snapshot = CK_CELLS[cell][0]
    key = {"single": str(dtype).split(".")[-1], "amr": "mb_amr"}.get(
        snapshot)
    if grids is not None and key in grids and dtype == torch.float32:
        grid = grids[key]
    elif snapshot == "single":
        grid = full_width_snapshot(dtype)
    elif snapshot == "amr":
        grid = mesh_grid("amr", dtype)
    elif snapshot == "fmks":
        grid, _ = fmks_snapshot(dtype, datasets=(grids or {}).get(
            "fmks_datasets"))
    else:
        path = athenak_path()
        _wait_for(path)
        grid, _, _ = athenak_snapshot(path, dtype)
    return with_kappa(grid)


def code_kappa_plain(cell, precision) -> tuple:
    """Phase 3: the plain version on phase 19's ``cell`` in ``precision``
    on every PLAIN_STRIDE-th ray of the float32 camera's (float64 widens
    them): on one host core, or on the card for CK_CARD_PLAIN: (their
    positions, (I_nu, flags, n_samples), seconds), numpy."""
    import torch
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    torch.set_num_threads(1)
    grid = ck_snapshot(cell, torch.float32)
    card_args, kwargs = _sim_args(_ck_config(cell), grid)
    if cell in CK_CARD_PLAIN:
        _, sub = _plain_subset(card_args)
    else:
        wide = precision == "float64"
        if wide:
            grid = ck_snapshot(cell, torch.float64)
        sub, kwargs, _ = _host_subset(
            _ck_config(cell), card_args, _host_grid(grid), PLAIN_STRIDE,
            _ck_config(cell, "float64") if wide else None)
        kwargs = {"integrator": kwargs["integrator"]}
    del card_args, grid
    out, t_p = _timed(sk.render_simulation_reference, *sub, **kwargs)
    return (sub[0].cpu().numpy(), [o.cpu().numpy() for o in out], t_p)


def code_kappa_pol_plain(precision) -> tuple:
    """Phase 3: the plain polarized version on phase 19's polarized cell
    in ``precision`` on every CK_POL_STRIDE-th ray of the float32
    camera's, on one host core: (their positions, Stokes, seconds)."""
    import torch
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    torch.set_num_threads(1)
    grid = ck_snapshot("ck", torch.float32)
    cfg = _ck_config("ck", polarized=True)
    card_args, _, _ = _pol_args(cfg, grid)
    wide = precision == "float64"
    if wide:
        grid = ck_snapshot("ck", torch.float64)
    sub, kwargs, geom = _host_subset(
        cfg, card_args, _host_grid(grid), CK_POL_STRIDE,
        _ck_config("ck", "float64", polarized=True) if wide else None)
    del card_args, grid
    out, t_p = _timed(pk.render_polarized_reference, *sub, **kwargs)
    return sub[0].numpy(), _pol_stokes(out, sub, geom, True), t_p


def check_code_kappa_phase() -> tuple:
    """Phase 3: the code_kappa phase kernel against its plain version,
    128^2 on mock_small.athdf's snapshot with its kappa slot
    (MIX_CHECK_STEPS): the second phase of MIX_PHASE_STEPS from the
    kernel's carried state after the first, rk4 float64 exact."""
    import numpy as np
    import torch
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.constants import PlasmaModel
    from blacklight_tpu_torch.grid.athena import load_athdf
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    cfg = _sim_config(camera_resolution=128, ray_integrator="rk4",
                      precision="float64",
                      plasma_model=PlasmaModel.code_kappa,
                      simulation_kappa_name="kappa", **MIX_CHECK_STEPS)
    grid = with_kappa(load_athdf(str(FIXTURES / "mock_small.athdf"),
                                 device=pipeline.resolve_device("cuda"),
                                 dtype=torch.float64))
    args, _ = _sim_args(cfg, grid)
    before = sk.PHASE_CODE_KAPPA_MODE_LAUNCHES[0]
    out_k, out_p, t_k, t_p, rays, samples = _second_phase(
        args, "rk4", MIX_PHASE_STEPS)
    launched = sk.PHASE_CODE_KAPPA_MODE_LAUNCHES[0] - before
    result = _check_exact(out_k, out_p, 1e-9)
    result["ok"] = bool(result["ok"] and launched == 2)
    a, b = out_k[0].cpu().numpy(), out_p[0].cpu().numpy()
    both = np.isfinite(a) & np.isfinite(b)
    result["max_abs_err"] = float(np.max(np.abs(a[both] - b[both]))) \
        if both.any() else 0.0
    return "code_kappa_phase_kernel_vs_plain", dict(
        integrator="rk4", precision="float64", phase_steps=MIX_PHASE_STEPS,
        phase_rays=rays, phase_samples=samples, code_kappa_launches=launched,
        kernel_s=t_k, plain_s=t_p, **result)


def _ck_grid_bytes(grid) -> int:
    """grid_bytes and the kappa table (4 bytes a cell) the code_kappa
    kernels read besides."""
    return grid_bytes(grid) + 4 * grid.prim[0].numel()


def _ck_entry(name, source, replaces, launches, gate, ms, plain_ms,
              plain_rays, b, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": gate["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "plain_rays": int(plain_rays),
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": None, **extra}


def phase_code_kappa(tmp: pathlib.Path, card: str, grids: dict,
                     checks: dict) -> list:
    """Phase 19; ``checks``: phase 3's code_kappa results ("plain" by
    (cell, precision), "pol_plain", "pol_truth", "phase"). Returns the
    kernels line's entries."""
    import numpy as np
    import torch
    from blacklight_tpu_torch import pipeline, pipeline_simulation as ps
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk

    res, n = CK_RES, CK_RES * CK_RES
    t_phase = time.perf_counter()
    grid = ck_snapshot("ck", torch.float32, grids)
    pick = np.arange(0, n, PLAIN_STRIDE)

    def zero():
        fk.LAUNCHES = sk.LAUNCHES = pk.LAUNCHES = sk.PHASE_LAUNCHES = 0
        for counts in (sk.CODE_KAPPA_MODE_LAUNCHES,
                       sk.PHASE_CODE_KAPPA_MODE_LAUNCHES,
                       pk.DERIVE_CODE_KAPPA_MODE_LAUNCHES):
            counts[:] = [0] * len(counts)
        pk.STAGE_LAUNCHES.update(dict.fromkeys(pk.STAGE_LAUNCHES, 0))

    # the main path: phase 7's cell at the code_kappa temperature through
    # pipeline.run, every count zeroed just before and read just after
    zero()
    arrays, run_s = _timed(pipeline.run, _ck_config(
        "ck", output_file=str(tmp / "code_kappa.npz")), quiet=True,
        device="cuda", grid=grid)
    launches = sk.CODE_KAPPA_MODE_LAUNCHES[0]
    others = fk.LAUNCHES + pk.LAUNCHES + sk.LAUNCHES - launches
    image = arrays["I_nu"]
    emit("code_kappa_main_path", resolution=res, precision="float32",
         integrator="rk4", max_steps=CK_STEPS,
         kappa_scale=_mock_athenak().KAPPA_SCALE,
         seconds=run_s, code_kappa_launches=launches, other_launches=others,
         nan_pixels=int(np.isnan(image).sum()),
         zero_pixels=int((image == 0).sum()),
         max_I_nu=float(np.nanmax(image)))
    if image.shape != (res, res) or not np.nanmax(image) > 0.0 \
            or not np.isfinite(np.nanmax(image)) or launches != 1 or others:
        raise RuntimeError("the code_kappa main path did not launch the "
                           "code_kappa kernel once alone, or gave no finite "
                           "positive image")

    # the code_kappa kernel and phase 7's thermal kernel in turns, as run
    # launches them
    (args_k, kwargs), t_setup = _timed(_sim_args, _ck_config("ck"), grid)
    args_t, _ = _sim_args(_sim_config(camera_resolution=res,
                                      precision="float32",
                                      ray_integrator="rk4",
                                      ray_max_steps=CK_STEPS),
                          grids.get("float32") or full_width_snapshot(
                              torch.float32))
    best, runs, outs = _best_in_turns({
        name: (lambda b=b: sk.render_simulation(*b, **kwargs))
        for name, b in (("code_kappa", _spatial(args_k)),
                        ("thermal", _spatial(args_t)))})
    mean_samples = float(outs["code_kappa"][2].double().mean())
    positions, plain, t_plain = checks["plain"][("ck", "float32")]
    out_cam = sk.render_simulation(*args_k, **kwargs)
    if not np.array_equal(positions, args_k[0][pick].cpu().numpy()):
        raise RuntimeError("the plain version traced other rays")
    gate = gate_outputs([out_cam[0].cpu().numpy()[pick]], [plain[0]])
    b_ck = bound("simulation_code_kappa", "rk4", "float32", n, mean_samples,
                 in_bytes=_ck_grid_bytes(grid), out_values=1)
    # float64: the kernel on the plain version's rays (the float32
    # camera's, widened) through the float64 snapshot, held to the plain
    # version in float64 (exact)
    grid64 = ck_snapshot("ck", torch.float64)
    full64, _ = _sim_args(_ck_config("ck", "float64"), grid64)
    pick_t = torch.from_numpy(pick).to(args_k[0].device)
    args64 = (*(a[pick_t].double().contiguous() for a in args_k[:3]),
              args_k[3].double(), *full64[4:-1], args_k[-1])
    out64, t64 = _timed(sk.render_simulation, *args64, **kwargs)
    positions64, plain64, t_plain64 = checks["plain"][("ck", "float64")]
    exact64 = _check_exact(out64, tuple(torch.from_numpy(p) for p in plain64),
                           1e-9)
    exact64["max_abs_err"] = gate_outputs(
        [out64[0].cpu().numpy()], [plain64[0]], 1e-9)["max_abs_err"]
    del grid64, full64, args64, out64
    emit("code_kappa_timing", resolution=res, card=card,
         order="spatial_order", camera_setup_s=t_setup,
         kernel_s_runs=runs, kernel_ms=best["code_kappa"] * 1e3,
         thermal_kernel_ms=best["thermal"] * 1e3,
         code_kappa_over_thermal=best["code_kappa"] / best["thermal"],
         mean_n_samples=mean_samples, plain_ms=t_plain * 1e3,
         plain_rays=pick.size, gate="statistical (bench.py:181-186)", **gate,
         **b_ck, float64_kernel_ms_plain_rays=t64 * 1e3,
         float64_plain_ms=t_plain64 * 1e3, float64_gate=exact64,
         clocks_power=smi(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                           "temperature.gpu", "--format=csv,noheader"]))
    if not gate["ok"] or not exact64["ok"] or not np.array_equal(
            positions64, positions):
        raise RuntimeError(f"the code_kappa kernel disagrees with plain at "
                           f"{res}^2: {gate} {exact64}")
    entries = [_ck_entry(
        "simulation_mixture_kernel (code_kappa)", CK_SOURCE,
        SIM_KERNEL_REPLACES, launches, gate, best["code_kappa"] * 1e3,
        t_plain * 1e3, pick.size, b_ck,
        thermal_ms=best["thermal"] * 1e3,
        float64_max_abs_err=exact64["max_abs_err"])]

    # the phased route: bit for bit the monolithic image
    ps.KERNEL_PHASED = True
    try:
        zero()
        phased = pipeline.run(_ck_config("ck"), quiet=True, device="cuda",
                              grid=grid)
        phase_launches = sk.PHASE_CODE_KAPPA_MODE_LAUNCHES[0]
        others = fk.LAUNCHES + sk.LAUNCHES + pk.LAUNCHES \
            + sk.PHASE_LAUNCHES - phase_launches
    finally:
        ps.KERNEL_PHASED = False
    a = phased["I_nu"]
    same = bool(a.shape == image.shape and np.array_equal(
        np.isnan(a), np.isnan(image)) and np.array_equal(
        a[~np.isnan(a)], image[~np.isnan(image)]))
    out2_k, _, t2_k, _, rays2, samples2 = _second_phase(
        args_k, "rk4", ps.KERNEL_PHASE_STEPS, with_plain=False)
    b_phase = phase_bound(rays2, samples2, "float32", _ck_grid_bytes(grid),
                          kind="simulation_code_kappa")
    phase_check = checks["phase"]
    emit("code_kappa_phased", resolution=res, card=card,
         phase_steps=ps.KERNEL_PHASE_STEPS, phase_launches=phase_launches,
         other_launches=others, identical_to_monolithic=same,
         second_phase_rays=rays2, second_phase_kernel_ms=t2_k * 1e3,
         **b_phase)
    if not same or not phase_launches or others:
        raise RuntimeError("the code_kappa phased route launched no "
                           "code_kappa phase kernel, another kernel, or its "
                           "image differs from the monolithic one")
    entries.append(_ck_entry(
        "simulation_phase_mixture_kernel (code_kappa)", SIM_KERNEL_SOURCE,
        PHASE_REPLACES, phase_launches, phase_check, t2_k * 1e3,
        phase_check["plain_s"] * 1e3, phase_check["phase_rays"], b_phase,
        kernel_ms_at_plain_rays=phase_check["kernel_s"] * 1e3))

    # the polarized route: through pipeline.run, then in turns with phase
    # 9's thermal route, held as phase 9's is
    zero()
    pol_arrays, pol_run_s = _timed(pipeline.run, _ck_config(
        "ck", polarized=True, output_file=str(tmp / "code_kappa_pol.npz")),
        quiet=True, device="cuda", grid=grid)
    stage_launches = dict(pk.STAGE_LAUNCHES)
    derive_launches = pk.DERIVE_CODE_KAPPA_MODE_LAUNCHES[0]
    pol_launches = pk.LAUNCHES
    finite_i = np.isfinite(pol_arrays["I_nu"])
    emit("code_kappa_pol_main_path", resolution=res, seconds=pol_run_s,
         launches=pol_launches, stage_launches=stage_launches,
         code_kappa_derive_launches=derive_launches,
         nan_pixels=int((~finite_i).sum()),
         max_I_nu=float(np.nanmax(pol_arrays["I_nu"])))
    if not all(stage_launches.values()) or fk.LAUNCHES or sk.LAUNCHES \
            or derive_launches != stage_launches["derive"] \
            or not all(np.isfinite(pol_arrays[k][finite_i]).all()
                       for k in STOKES):
        raise RuntimeError("the code_kappa polarized route did not launch "
                           "each stage with the code_kappa derive kernel, or "
                           "its image is not finite where I is")
    args_p, kw_p, geom = _pol_args(_ck_config("ck", polarized=True), grid)
    args_pt, _, _ = _pol_args(_pol_config(
        camera_resolution=res, precision="float32", ray_integrator="rk4",
        ray_max_steps=CK_STEPS, image_rotation_split=False),
        grids.get("float32") or full_width_snapshot(torch.float32))
    pol_bundles = {"code_kappa": _spatial(args_p),
                   "thermal": _spatial(args_pt)}
    best_p, runs_p, outs_p = _best_in_turns({
        name: (lambda b=b: pk.render_polarized(*b, **kw_p))
        for name, b in pol_bundles.items()})
    stages = {name: _pol_stage_times(b, kw_p)["stage_ms"]
              for name, b in pol_bundles.items()}
    positions, plain_stokes, t_plain_p = checks["pol_plain"]
    positions64, truth, _ = checks["pol_truth"]
    pol_pick = np.arange(0, n, CK_POL_STRIDE)
    if not (np.array_equal(positions, args_p[0][pol_pick].cpu().numpy())
            and np.array_equal(positions64, positions)):
        raise RuntimeError("the plain version traced other rays")
    ours = _pol_stokes(pk.render_polarized(*args_p, **kw_p), args_p, geom,
                       True)
    ours = {k: v[pol_pick] for k, v in ours.items()}
    pol_gate = truth_gate(ours, plain_stokes, truth)
    finite = np.isfinite(ours["I_nu"]) & np.isfinite(plain_stokes["I_nu"])
    pol_gate["same_nan"] = bool(np.array_equal(
        np.isnan(ours["I_nu"]), np.isnan(plain_stokes["I_nu"])))
    pol_gate["max_abs_err"] = float(np.max(np.abs(
        ours["I_nu"][finite] - plain_stokes["I_nu"][finite]), initial=0.0))
    pol_gate["ok"] = pol_gate["ok"] and pol_gate["same_nan"]
    mean_p = float(outs_p["code_kappa"][3].double().mean())
    b_pol = bound("polarized_code_kappa", "rk4", "float32", n, mean_p,
                  in_bytes=_ck_grid_bytes(grid), out_values=16,
                  extra_out_bytes=12)
    emit("code_kappa_pol_timing", resolution=res, card=card,
         order="spatial_order", kernel_s_runs=runs_p,
         route_ms=best_p["code_kappa"] * 1e3,
         thermal_route_ms=best_p["thermal"] * 1e3,
         code_kappa_over_thermal=best_p["code_kappa"] / best_p["thermal"],
         stage_ms=stages, mean_n_samples=mean_p, plain_ms=t_plain_p * 1e3,
         plain_rays=pol_pick.size, gate=pol_gate, **b_pol)
    if not pol_gate["ok"]:
        raise RuntimeError(f"the code_kappa polarized route disagrees with "
                           f"plain at {res}^2: {pol_gate}")
    entries.append(_ck_entry(
        "polarized_kernel (code_kappa derive)", POL_MIX_SOURCE,
        POL_KERNEL_REPLACES, pol_launches, pol_gate,
        best_p["code_kappa"] * 1e3, t_plain_p * 1e3, pol_pick.size, b_pol,
        derive_launches=derive_launches,
        derive_ms=stages["code_kappa"]["derive"],
        thermal_ms=best_p["thermal"] * 1e3,
        thermal_derive_ms=stages["thermal"]["derive"]))
    del pol_bundles, outs_p, args_p, args_pt

    # the other cells: the kernel on the PLAIN_STRIDE-th rays of each,
    # every count zeroed just before and read just after, held to its
    # plain version there
    ops = {"ck_mix": "simulation_code_kappa_mixture",
           "ck_amr": "simulation_code_kappa_interblock",
           "ck_nearest": "simulation_code_kappa_nearest",
           "ck_fmks": "simulation_code_kappa_fmks",
           "ck_athenak": "simulation_code_kappa_cks_interblock"}
    for cell, kind in ops.items():
        cell_grid = grid if CK_CELLS[cell][0] == "single" \
            else ck_snapshot(cell, torch.float32, grids)
        args_c, kwargs_c = _sim_args(_ck_config(cell), cell_grid)
        _, sub = _plain_subset(args_c)
        sk.render_simulation(*sub, **kwargs_c)  # warm
        zero()
        out, t_k = _timed(sk.render_simulation, *sub, **kwargs_c)
        mode = CK_MODES[cell]
        launched = sk.CODE_KAPPA_MODE_LAUNCHES[mode]
        others = fk.LAUNCHES + pk.LAUNCHES + sk.LAUNCHES - launched
        positions, plain, t_p = checks["plain"][(cell, "float32")]
        if not np.array_equal(positions, sub[0].cpu().numpy()):
            raise RuntimeError("the plain version traced other rays")
        cell_gate = gate_outputs([out[0].cpu().numpy()], [plain[0]])
        b_c = bound(kind, "rk4", "float32", pick.size,
                    float(out[2].double().mean()),
                    in_bytes=_ck_grid_bytes(cell_grid), out_values=1)
        emit("code_kappa_mode", cell=cell, mode=mode, rays=pick.size,
             card=card, kernel_ms=t_k * 1e3, code_kappa_launches=launched,
             other_launches=others, plain_ms=t_p * 1e3,
             plain_on="card" if cell in CK_CARD_PLAIN else "host core",
             gate="statistical (bench.py:181-186)", **cell_gate, **b_c,
             max_I_nu=float(np.nanmax(plain[0])))
        if not cell_gate["ok"] or launched != 1 or others \
                or not np.nanmax(plain[0]) > 0.0:
            raise RuntimeError(f"code_kappa {cell}: {cell_gate}, "
                               f"{launched} launches, {others} others")
        entries.append(_ck_entry(
            f"simulation_mixture_kernel (code_kappa, {cell})", CK_SOURCE,
            SIM_KERNEL_REPLACES, launched, cell_gate, t_k * 1e3, t_p * 1e3,
            pick.size, b_c, mode=SAMPLE_MODE_NAMES[mode]))
        del args_c, sub, cell_grid
    emit("code_kappa", card=card, seconds=time.perf_counter() - t_phase)
    return entries


# Phase 20 (adaptive refinement, ROADMAP A.9): the golden's criteria (the
# Laplacian, golden_adaptive_32.input) and a forced region over the centre
# of half-width ADAPTIVE_REGION of the camera's width, blocks of
# ADAPTIVE_BLOCK at the ADAPTIVE_RES^2 root; levels by cell.
ADAPTIVE_RES = 1024
ADAPTIVE_BLOCK = 32
ADAPTIVE_REGION = 0.08
ADAPTIVE_LEVELS = {"sim-rk4-f32": 2, "formula-dp-f32": 1, "pol-rk4-f32": 1}


def golden_adaptive_snapshot(dtype, device=None):
    """write_athena's mock torus at the generator's defaults (the
    snapshot of golden_adaptive_32, tests/test_reference_goldens.py:21-49)
    as load_athdf reads it, built in memory: the card has no h5py."""
    return full_width_snapshot(dtype, device, size={})


def _adaptive_config(cfg, max_level):
    """``cfg`` refined to ``max_level`` levels of ADAPTIVE_BLOCK blocks by
    golden_adaptive_32's criteria and the central forced region."""
    import dataclasses
    from blacklight_tpu_torch.utils.config import AdaptiveRegion
    golden = _config("golden_adaptive_32.input")
    for field in dataclasses.fields(golden):
        if field.name.startswith("adaptive_"):
            setattr(cfg, field.name, getattr(golden, field.name))
    half = ADAPTIVE_REGION * cfg.camera_width
    cfg.adaptive_max_level = max_level
    cfg.adaptive_block_size = ADAPTIVE_BLOCK
    cfg.adaptive_num_regions = 1
    cfg.adaptive_regions = [AdaptiveRegion(level=max_level, x_min=-half,
                                           x_max=half, y_min=-half,
                                           y_max=half)]
    return cfg


def level_pixels(locs, block, resolution):
    """Row-major indices into a ``resolution``^2 camera of the pixels of
    blocks ``locs`` (B, 2) (v, u), block-major then row-major within a
    block, as an adaptive level's bundle holds them."""
    import numpy as np
    m = np.arange(block * block)
    rows = (locs[:, 0] * block)[:, None] + m // block
    cols = (locs[:, 1] * block)[:, None] + m % block
    return (rows * resolution + cols).reshape(-1)


def adaptive_level_gate(cfg, arrays, grid) -> list:
    """Every level's images against the same kernel's render of the same
    pixels' rays from the finer camera (pixel_grid(resolution * 2**l)),
    launched in that camera's row-major order: (per level, blocks, rays,
    whether every Stokes channel is equal bit for bit, the direct
    render's seconds)."""
    import dataclasses
    import numpy as np
    import torch
    from blacklight_tpu_torch import pipeline, pipeline_simulation
    res, block = cfg.camera_resolution, cfg.adaptive_block_size
    counts = arrays["adaptive_num_blocks"]
    result = []
    for level in range(1, int(arrays["adaptive_num_levels"][0]) + 1):
        fine = dataclasses.replace(cfg, camera_resolution=res << level,
                                   adaptive_max_level=0)
        if grid is None:
            render_fn, _, rays, _, _ = pipeline.make_formula_renderer(
                fine, device="cuda")
        else:
            render_fn, _, rays, _, _ = \
                pipeline_simulation.make_simulation_renderer(
                    fine, device="cuda", grid=grid)
        pick = level_pixels(arrays[f"adaptive_block_locs_{level}"], block,
                            res << level)
        order = np.argsort(pick)
        index = torch.from_numpy(pick[order]).to(rays.positions.device)
        rays = [t[index] for t in (rays.positions, rays.directions,
                                   rays.momentum_factors)]
        direct, t_direct = _timed(render_fn, *rays)
        equal = {}
        for key in STOKES:
            if key in direct:
                values = direct[key][:, 0].cpu().numpy()[np.argsort(order)]
                ours = arrays[f"adaptive_{key}_{level}"].reshape(-1)
                equal[key] = bool(ours.dtype == values.dtype and np.array_equal(
                    ours, values, equal_nan=True))
        result.append({"level": level, "blocks": int(counts[level]),
                       "rays": int(pick.size), "bit_for_bit": equal,
                       "direct_s": t_direct})
        del rays, direct
    return result


def phase_adaptive(tmp: pathlib.Path, card: str, grids: dict):
    """Phase 20: adaptive refinement (ROADMAP A.9) through pipeline.run on
    the card: golden_adaptive_32 at its gates, then each cell of
    ADAPTIVE_LEVELS at 1024^2 (phase 7's, phase 5's and phase 9's, on
    phase 7's snapshot in ``grids``) with and without refinement, each
    level's blocks, rays and render time, and each level bit for bit the
    kernel's direct render of the same pixels (adaptive_level_gate)."""
    import numpy as np
    import torch
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk

    t_phase = time.perf_counter()
    name = "golden_adaptive_32"
    before = sk.LAUNCHES
    ours = pipeline.run(_config(f"{name}.input",
                                output_file=str(tmp / f"{name}.npz")),
                        quiet=True, device="cuda",
                        grid=golden_adaptive_snapshot(torch.float64))
    launched = sk.LAUNCHES - before
    ref = np.load(FIXTURES / f"{name}.npz")
    # tests/test_reference_goldens.py:21-49
    scale = np.nanmax(np.abs(ref["I_nu"]))
    worst = float(np.nanmax(np.abs(ours["I_nu"] - ref["I_nu"])
                            / (np.abs(ref["I_nu"]) + scale * 1e-8)))
    ours_at = {tuple(v): i for i, v in enumerate(
        ours["adaptive_block_locs_1"])}
    ref_at = {tuple(v): i for i, v in enumerate(
        ref["adaptive_block_locs_1"])}
    same_locs = set(ours_at) == set(ref_at)
    for loc in set(ours_at) & set(ref_at):
        a = ours["adaptive_I_nu_1"][ours_at[loc]]
        b = ref["adaptive_I_nu_1"][ref_at[loc]]
        worst = max(worst, float(np.nanmax(np.abs(a - b)
                                           / (np.abs(b) + scale * 1e-8))))
    ok = bool(np.array_equal(ours["adaptive_num_levels"],
                             ref["adaptive_num_levels"])
              and np.array_equal(ours["adaptive_num_blocks"],
                                 ref["adaptive_num_blocks"])
              and same_locs and worst < 1e-8 and launched == 2)
    emit("adaptive_golden", name=name, launches=launched,
         num_blocks=ours["adaptive_num_blocks"].tolist(),
         same_locations=same_locs, max_rel=worst,
         gate="equal levels, blocks and locations, rtol 1e-8", ok=ok)
    if not ok:
        raise RuntimeError(f"golden {name} failed")

    res = ADAPTIVE_RES
    cells = {
        "sim-rk4-f32": (_sim_config(
            precision="float32", ray_integrator="rk4", ray_max_steps=2000),
            grids["float32"]),
        "formula-dp-f32": (_config(
            "golden_formula_32.input", precision="float32",
            ray_integrator="dp"), None),
        "pol-rk4-f32": (_pol_full_config("float32", "rk4"), grids["float32"]),
    }
    real_loop = pipeline.adaptive_loop
    for cell in ADAPTIVE_LEVELS:
        cfg, grid = cells[cell]
        cfg.camera_resolution = res
        cfg.output_file = str(tmp / f"adaptive_{cell}.npz")
        # warm, then run without refinement
        for _ in range(2):
            _, plain_run_s = _timed(pipeline.run, cfg, quiet=True,
                                    device="cuda", grid=grid)
        cfg = _adaptive_config(cfg, ADAPTIVE_LEVELS[cell])
        renders = []

        def timed_loop(cfg_, render_fn, geom, root_image):
            def timed(*rays):
                out, seconds = _timed(render_fn, *rays)
                renders.append({"rays": rays[0].shape[0],
                                "render_s": seconds})
                return out
            return real_loop(cfg_, timed, geom, root_image)

        fk.LAUNCHES = sk.LAUNCHES = pk.LAUNCHES = sk.PHASE_LAUNCHES = 0
        pipeline.adaptive_loop = timed_loop
        try:
            arrays, run_s = _timed(pipeline.run, cfg, quiet=True,
                                   device="cuda", grid=grid)
        finally:
            pipeline.adaptive_loop = real_loop
        launches = {"formula": fk.LAUNCHES, "simulation": sk.LAUNCHES,
                    "polarized": pk.LAUNCHES, "phase": sk.PHASE_LAUNCHES}
        counts = arrays["adaptive_num_blocks"].tolist()
        levels = adaptive_level_gate(cfg, arrays, grid)
        for entry, render in zip(levels, renders):
            entry.update(render)
        kind = {"sim": "simulation", "formula": "formula",
                "pol": "polarized"}[cell.split("-")[0]]
        ok = (len(levels) == ADAPTIVE_LEVELS[cell]
              and all(0 < counts[i] < 4 * counts[i - 1]
                      for i in range(1, len(counts)))
              and all(all(e["bit_for_bit"].values()) and e["bit_for_bit"]
                      for e in levels)
              and launches[kind] >= 1 + len(levels)
              and sum(launches.values()) == launches[kind]
              and arrays["I_nu"].shape == (res, res))
        emit("adaptive", card=card, cell=cell, resolution=res,
             block=ADAPTIVE_BLOCK, max_level=ADAPTIVE_LEVELS[cell],
             num_blocks=counts, run_s=run_s,
             run_without_refinement_s=plain_run_s, levels=levels,
             launches=launches, ok=ok)
        if not ok:
            raise RuntimeError(f"adaptive cell {cell} failed")
        del arrays
    emit("adaptive_phase", card=card, seconds=time.perf_counter() - t_phase)


def _render_features(cfg, name="golden_render_rk4_32.input"):
    """``cfg`` with the renderings of ``name`` (its render_* lines)."""
    golden = _config(name)
    cfg.render_num_images = golden.render_num_images
    cfg.render_images = golden.render_images
    return cfg


def _render_full_config(**overrides):
    """Phase 21's main path: phase 7's cell with golden_render_rk4_32's
    renderings beside its light image."""
    return _render_features(_sim_config(**{
        "camera_resolution": 1024, "precision": "float32",
        "ray_integrator": "rk4", "ray_max_steps": 2000, **overrides}))


def render_full_width_cpu() -> tuple:
    """Phase 3: phase 21's route on the CPU on every PLAIN_STRIDE-th ray
    of its camera (built on the card) through FULL_GRID on the host:
    (plane_columns, seconds, route, the rays' positions)."""
    import torch
    torch.set_num_threads(1)
    cfg = _render_full_config()
    rays = _card_rays(cfg, PLAIN_STRIDE)
    grid = full_width_snapshot(torch.float32, device=torch.device("cpu"))
    return (*_scan(cfg, "cpu", grid, rays), rays[0].numpy())


def render_golden(name) -> dict:
    """Phase 3: golden_render_rk4_32 (rk4, float64: rtol 1e-8 over 1e-10
    of the peak) or golden_render_32 (dp: mean error < 5e-3, max < 2e-1 of
    the peak; tests/test_render_truecolor.py:16-34) through pipeline.run
    on the card."""
    import numpy as np
    arrays, seconds, launches = _aux_run(_config(
        f"{name}.input", simulation_file=str(FIXTURES / "mock_small.athdf")))
    gold = np.load(FIXTURES / f"{name}.npz")["rendering"]
    ours = arrays["rendering"].reshape(gold.shape)
    peak = float(np.abs(gold).max())
    err = np.abs(ours - gold) / peak
    if name == "golden_render_rk4_32":
        gate = "rtol 1e-8, atol 1e-10 of the peak"
        ok = bool(np.allclose(ours, gold, rtol=1e-8, atol=peak * 1e-10))
    else:
        gate = "mean error < 5e-3, max < 2e-1 of the peak"
        ok = bool(np.nanmean(err) < 5e-3 and np.nanmax(err) < 2e-1)
    ok = ok and not any((sum(v) if isinstance(v, list) else v)
                        for v in launches.values())
    return {"name": name, "seconds": seconds, "launches": launches,
            "max_err_over_peak": float(np.nanmax(err)),
            "mean_err_over_peak": float(np.nanmean(err)), "gate": gate,
            "ok": ok}


def render_golden_rk4() -> dict:
    return render_golden("golden_render_rk4_32")


def render_golden_dp() -> dict:
    return render_golden("golden_render_32")


# Phase 21's jobs in phase 3's pool, by name.
RENDER_JOBS = (("golden_rk4", render_golden_rk4),
               ("golden_dp", render_golden_dp),
               ("full_cpu", render_full_width_cpu))


def phase_rendering(tmp: pathlib.Path, card: str, grids: dict, mono: dict,
                    render: dict) -> None:
    """Phase 21 (the module's docstring); ``mono`` is phase 7's arrays,
    ``render`` phase 3's RENDER_JOBS results."""
    import numpy as np
    import torch
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import geodesic
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    from blacklight_tpu_torch.pipeline_simulation import (
        make_simulation_renderer)

    t_phase = time.perf_counter()
    goldens = [render["golden_rk4"], render["golden_dp"]]
    for golden in goldens:
        emit("render_golden", **golden)

    grid = grids.get("float32")
    if grid is None:
        grid = full_width_snapshot(torch.float32)
    cfg = _render_full_config(output_file=str(tmp / "render_full.npz"))
    res = cfg.camera_resolution
    render_fn, _, rays, _, _ = make_simulation_renderer(
        _render_full_config(ray_max_steps=AUX_WARM_STEPS), device="cuda",
        grid=grid)
    _, t_warm = _timed(render_fn, *(t[:AUX_WARM_RAYS] for t in (
        rays.positions, rays.directions, rays.momentum_factors)))
    route = render_fn.route
    subset_positions = rays.positions[::PLAIN_STRIDE].cpu().numpy()
    del render_fn, rays
    cpu_cols, cpu_s, cpu_route, cpu_positions = render["full_cpu"]
    if route != "scan" or cpu_route != "scan":
        raise RuntimeError(f"the rendering took the {route} route")
    if not np.array_equal(subset_positions, cpu_positions):
        raise RuntimeError("phase 3's CPU route ran on other rays")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    steps = geodesic.LOCK_STEPS
    _zero_counts(fk, sk, pk)
    arrays, wall = _timed(pipeline.run, cfg, quiet=True, device="cuda",
                          grid=grid)
    launches = _launch_counts(fk, sk, pk)
    steps = geodesic.LOCK_STEPS - steps
    peak = torch.cuda.max_memory_allocated() - base
    moved = [v for v in launches.values()
             if (sum(v) if isinstance(v, list) else v)]
    rendering = arrays["rendering"]
    if moved or rendering.shape != (1, 3, res, res) \
            or not np.isfinite(rendering).all() or not steps:
        raise RuntimeError(f"the rendering launched a kernel or is wrong: "
                           f"{launches}, {rendering.shape}, {steps} steps")
    kernel_gate = statistical_gate(arrays["I_nu"].ravel(),
                                   mono["I_nu"].ravel())
    emit("render_main_path", resolution=res, precision="float32",
         integrator="rk4", max_steps=2000, route=route, card=card,
         features=["fill rho", "fill sigma", "thresh beta_inverse 0.15"],
         seconds=wall, steps=steps, ms_per_step=wall / steps * 1e3,
         warm_call_rays=AUX_WARM_RAYS, warm_call_steps=AUX_WARM_STEPS,
         warm_call_s=t_warm, peak_device_bytes=peak, launches=launches,
         i_nu_vs_kernel_image=kernel_gate,
         nonzero_pixels=int((rendering.sum(axis=(0, 1)) > 0).sum()))

    ours = rendering.reshape(1, 3, -1)[:, :, ::PLAIN_STRIDE]
    theirs = np.transpose(cpu_cols["rendering"], (1, 2, 0))
    gates = {"XYZ"[c]: plane_gate(ours[0, c], theirs[0, c])
             for c in range(3)}
    subset_ok = all(g["ok"] for g in gates.values())
    emit("render_vs_cpu_route", rays=int(subset_positions.shape[0]),
         cpu_route_s=cpu_s, workers=WORKERS, gates=gates,
         ok=bool(subset_ok))
    emit("render_phase", card=card, seconds=time.perf_counter() - t_phase)
    failed = [name for name, ok in (
        ("I_nu against phase 7's kernel image", kernel_gate["ok"]),
        ("rendering against the CPU route", subset_ok),
        *((g["name"], g["ok"]) for g in goldens)) if not ok]
    if failed:
        raise RuntimeError(f"phase 21 failed: {failed}")


# Phase 3's kernel-against-plain checks, emitted in this order.
CHECKS = (
    (check_formula_tangents, ("rk4", "float64")),
    (check_formula_tangents, ("dp", "float32")),
    (check_formula, ("dp", "float32")),
    (check_formula, ("dp", "float64")),
    (check_polarized, ("dp", "float32", False, 1)),
    (check_polarized, ("rk2", "float32", True, 2)),
    (check_formula, ("rk4", "float64")),
    (check_simulation, ("dp", "float32")),
    (check_simulation, ("dp", "float64")),
    (check_polarized, ("rk4", "float64", False, 1)),
    (check_formula, ("rk2", "float32")),
    (check_simulation, ("rk4", "float64")),
    (check_simulation, ("rk2", "float32")),
    (check_simulation_phase, ("rk4", "float64")),
    (check_simulation_phase, ("rk2", "float32")),
    (check_mesh_derive, ("float64",)),
    (check_mesh_polarized, ("interblock", "rk4", "float64")),
    (check_mesh_polarized, ("nearest", "rk2", "float32")),
    (check_mesh_simulation, ("interblock", "rk4", "float64", 1)),
    (check_mesh_simulation, ("interblock", "rk2", "float64", 3)),
    (check_mesh_simulation, ("interblock", "dp", "float32", 1)),
    (check_mesh_simulation, ("interblock", "dp", "float64", 1)),
    (check_mesh_simulation, ("nearest", "rk4", "float64", 3)),
    (check_mesh_simulation, ("nearest", "rk2", "float32", 1)),
    (check_mixture_simulation, ("rk4", "float64")),
    (check_mixture_simulation, ("dp", "float32")))
MESH_PHASE_CHECKS = (("interblock", "rk4", "float64"),
                     ("nearest", "rk2", "float32"))
FORMULA_CELLS = ("k13", "k14", "k11")
# Phase 3's jobs that the main process runs itself, in this order, once
# its own host work (phase_checks' prep, ~195-240 s) is done, on the core
# the pool's 7 workers leave (idle ~550 s of phase 3 before, as measured
# on one H100 host): phase 19's plain versions on one host core, ~340 s
# there (~460 s on a slower host; with two of phase 17's jobs as well the
# main process ended last there, PERF.md). (function name, arguments)
MAIN_JOBS = tuple(("code_kappa_plain", key) for key in CK_PLAIN
                  if key[0] not in CK_CARD_PLAIN) + tuple(
    ("code_kappa_pol_plain", (p,)) for p in ("float64", "float32"))
# Seconds of phase 3's jobs, measured on an H100 host (its "checks_job"
# lines; MAIN_JOBS ran in the main process), by
# (function name, arguments); the pool starts the longest first, so that
# no long job starts last. Estimated: sim_second_phase_plain and
# fit_demo_run (~22 s each alone after phase 3 before).
PHASE3_SECONDS = {
    ("aux_pol_card", ()): 264.4,
    ("check_formula_tangents", ("dp", "float32")): 233.0,
    ("pol_full_width_plain", ()): 221.9,
    ("check_formula", ("dp", "float32")): 214.6,
    ("formula_plain_subset", ("k13",)): 211.6,
    ("formula_plain_subset", ("k14",)): 204.3,
    ("formula_plain_subset", ("k11",)): 202.0,
    ("sim_full_width_plain", ("sim",)): 146.9,
    ("aux_golden_formula", ()): 53.4,
    ("render_golden_rk4", ()): 30.8,
    ("render_golden_dp", ()): 21.9,
    ("render_full_width_cpu", ()): 23.5,
    ("check_polarized_stages", ()): 133.1,
    ("check_formula", ("dp", "float64")): 132.5,
    ("pol_full_width_truth", ()): 124.3,
    ("check_polarized", ("dp", "float32", False, 1)): 118.6,
    ("check_formula_tangents", ("rk4", "float64")): 101.6,
    ("aux_pol_cpu", ()): 97.3,
    ("mesh_plain_subset", ("mb_amr", "float32")): 97.2,
    ("check_simulation", ("dp", "float64")): 94.4,
    ("check_polarized", ("rk2", "float32", True, 2)): 93.3,
    ("code_kappa_plain", ("ck_athenak", "float32")): 92.9,
    ("check_formula", ("rk4", "float64")): 89.2,
    ("mesh_plain_subset", ("mb_amr", "float64")): 88.4,
    ("athenak_plain_subset", ("athenak_amr",)): 87.2,
    ("check_mixture_simulation", ("dp", "float32")): 86.5,
    ("check_simulation", ("dp", "float32")): 85.9,
    ("aux_exact_card", ()): 29.8,
    ("code_kappa_plain", ("ck_amr", "float32")): 82.6,
    ("check_mesh_polarized", ("interblock", "rk4", "float64")): 64.1,
    ("check_formula", ("rk2", "float32")): 63.0,
    ("athenak_plain_subset", ("athenak",)): 56.9,
    ("mesh_plain_subset", ("mb_uniform", "float64")): 55.2,
    ("mesh_phase_plain_subset", ()): 54.7,
    ("check_polarized", ("rk4", "float64", False, 1)): 48.8,
    ("code_kappa_plain", ("ck_fmks", "float32")): 47.9,
    ("check_simulation", ("rk4", "float64")): 47.5,
    ("fmks_plain_subset", ("harm3d",)): 46.3,
    ("code_kappa_plain", ("ck", "float32")): 46.0,
    ("sim_second_phase_plain", ("second_phase",)): 45.0,
    ("mixture_pol_plain_subset", ()): 44.7,
    ("athenak_plain_subset", ("athenak_mix",)): 43.6,
    ("mixture_plain_subset", ()): 43.3,
    ("code_kappa_plain", ("ck", "float64")): 42.7,
    ("code_kappa_plain", ("ck_mix", "float32")): 41.4,
    ("mesh_plain_subset", ("mb_uniform", "float32")): 41.0,
    ("fit_demo_run", ("fit_demo",)): 40.0,
    ("mesh_plain_subset", ("nearest", "float64")): 38.7,
    ("aux_exact_cpu", ()): 18.9,
    ("fmks_plain_subset", ("fmks",)): 38.1,
    ("aux_full_width_cpu", ()): 24.3,
    ("check_simulation", ("rk2", "float32")): 37.2,
    ("aux_golden_sim_tau", ()): 11.0,
    ("fmks_plain_subset", ("fmks_mix",)): 35.6,
    ("code_kappa_plain", ("ck_nearest", "float32")): 35.1,
    ("mesh_plain_subset", ("nearest", "float32")): 34.9,
    ("fmks_pol_subset", ("float64",)): 34.1,
    ("athenak_pol_subset", ("float64",)): 29.9,
    ("check_mesh_polarized", ("nearest", "rk2", "float32")): 29.0,
    ("check_athenak_simulation",
     ("thermal", "dp", "float32", "trilinear")): 28.0,
    ("check_simulation_phase", ("rk4", "float64")): 26.0,
    ("check_fmks_simulation", ("thermal", "dp", "float32", True)): 25.5,
    ("code_kappa_pol_plain", ("float64",)): 23.7,
    ("fmks_pol_subset", ("float32",)): 23.5,
    ("athenak_pol_subset", ("float32",)): 22.9,
    ("check_mesh_simulation", ("interblock", "dp", "float64", 1)): 20.6,
    ("check_mesh_simulation", ("interblock", "dp", "float32", 1)): 19.7,
    ("code_kappa_pol_plain", ("float32",)): 17.4,
    ("check_simulation_phase", ("rk2", "float32")): 16.9,
    ("check_mesh_simulation", ("interblock", "rk4", "float64", 1)): 15.6,
    ("check_fmks_simulation", ("mixture", "rk4", "float64", True)): 15.0,
    ("check_athenak_simulation",
     ("mixture", "rk4", "float64", "interblock")): 14.9,
    ("check_athenak_simulation",
     ("thermal", "rk4", "float64", "interblock")): 13.9,
    ("check_mesh_simulation", ("interblock", "rk2", "float64", 3)): 13.2,
    ("check_mixture_simulation", ("rk4", "float64")): 12.3,
    ("check_fmks_simulation", ("thermal", "rk4", "float64", True)): 12.0,
    ("check_fmks_simulation", ("thermal", "rk4", "float64", False)): 11.3,
    ("check_mesh_simulation", ("nearest", "rk4", "float64", 3)): 10.7,
    ("check_mesh_phase", ("interblock", "rk4", "float64")): 10.4,
    ("check_athenak_simulation",
     ("thermal", "rk4", "float64", "nearest")): 10.2,
    ("check_athenak_phase", ()): 10.2,
    ("check_mesh_simulation", ("nearest", "rk2", "float32", 1)): 10.0,
    ("check_fmks_phase", ()): 7.9,
    ("check_mixture_phase", ()): 7.4,
    ("check_mesh_phase", ("nearest", "rk2", "float32")): 5.2,
    ("check_code_kappa_phase", ()): 4.9,
    ("check_mesh_derive", ("float64",)): 2.2,
    ("check_mesh_derive", ("float32",)): 1.2,
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chunk-sweep", action="store_true",
                        help="only build and time the polarized route at "
                             "each trace chunk size")
    opts = parser.parse_args(argv)
    started = time.perf_counter()
    card = phase_device()
    import torch
    library = phase_build()
    if opts.chunk_sweep:
        phase_build_report(library)
        phase_pol_chunks(card, full_width_snapshot(torch.float32))
    else:
        with tempfile.TemporaryDirectory(dir=ROOT / "build" / "kernels") \
                as tmp:
            tmp = pathlib.Path(tmp)
            shutil.rmtree(ATHENAK_DIR, ignore_errors=True)
            ATHENAK_DIR.mkdir(parents=True)
            with multiprocessing.get_context("spawn").Pool(WORKERS) as pool:
                (truth, subsets, pol_stages, mesh_checks, aux, mixture_checks,
                 fmks_checks, athenak_checks, code_kappa_checks,
                 (athenak_host, fmks_host, _)) = phase_checks(
                    pool, prep=lambda: (athenak_host_prep(),
                                        fmks_host_prep(tmp),
                                        phase_build_report(library)))
            phase_goldens(tmp)
            formula = phase_full_width(tmp, card, subsets["k11"])
            phase_sim_goldens(tmp)
            grids = {}
            simulation, mono = phase_sim_full_width(tmp, card, grids,
                                                    subsets["sim"])
            phased = phase_phased_full_width(tmp, card, grids, mono,
                                             subsets["second_phase"])
            mesh = phase_mesh_blocks(tmp, card, grids, mesh_checks["plain"],
                                     mesh_checks)
            phase_aux_planes(tmp, card, grids, mono, simulation, aux)
            phase_pol_goldens(tmp)
            polarized = phase_pol_full_width(tmp, card, grids, truth,
                                             pol_stages)
            mixture = phase_mixture_full_width(tmp, card, grids,
                                               mixture_checks)
            fmks = phase_fmks_full_width(card, grids, fmks_checks, fmks_host)
            athenak = phase_athenak_full_width(card, grids, athenak_checks,
                                               athenak_host)
            grids["fmks_datasets"] = fmks_host["datasets"]
            code_kappa = phase_code_kappa(tmp, card, grids,
                                          code_kappa_checks)
            phase_adaptive(tmp, card, grids)
            phase_rendering(tmp, card, grids, mono, aux["render"])
            shutil.rmtree(ATHENAK_DIR, ignore_errors=True)
            grids.clear()
            multi = phase_multi_full_width(tmp, card, subsets["k13"])
            tangent = phase_grad_full_width(card, subsets["k14"])
            phase_fit(card, subsets["fit_demo"])
        emit("total", seconds=time.perf_counter() - started,
             epoch_s=time.time())
        print(json.dumps({"kernels": [formula, multi, tangent, simulation,
                                      phased, polarized, *mesh, *mixture,
                                      *fmks, *athenak, *code_kappa]}),
              flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
