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
   once), report registers, spills and the FP64 instructions of each
   kernel instantiation, the static instruction mix of each formula
   kernel's step loop and of its per-step path (scripts/sass_step_mix.py,
   on the formula units built again with line tables) and the size of the
   formula kernel's launch constants, held to the host's packing;
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
     from the carried state of its first: rk4 float64, rk2 float32;
   - polarized, 64^2 camera on golden_polarized_rk4_32.input with
     mock_small.athdf (ray_step 0.04, 400 steps), camera-frame I, Q, U,
     V: rk4 float64, dp float32, rk2 float32 with image_rotation_split
     and two frequencies; each float32 case also against the plain
     version in float64 on the same rays (truth_gate);
   - the plain polarized version in float64 on 4,096 rays of phase 9's
     main path, which phase 9 holds its float32 route against;
   - the polarized route's three kernels at phase 9's cell (4,096 of its
     rays, every PLAIN_STRIDE-th in spatial_order), each against its plain
     version on the same inputs: the trace kernel on the rays, the derive
     kernel on the trace kernel's samples, the chain kernel on the derive
     kernel's records;
   - the plain formula version on 4,096 rays (every PLAIN_STRIDE-th) of
     each full-width formula cell (phases 5, 10 and 11), which those
     phases hold their kernel against;
4. the 32^2 formula goldens through pipeline.run(cfg, device="cuda") at
   the tolerances of tests/test_formula_e2e.py;
5. the formula main path at full width: golden_formula_32.input at
   1024^2, dp, float32 through pipeline.run, counting kernel launches;
   then kernel times (rays/s) at 1024^2 in float32 and float64, the
   float32 kernel held to phase 3's plain run on its subset, each in the
   order the pipeline launches it (pipeline.formula_launch_order); each
   formula timing (phases 5, 10 and 11) also prints that order, the
   128-ray block efficiency of camera order and of that order, and the
   issue estimate of phase 2's per-step path over this run's ray-steps;
6. the 32^2 simulation goldens through pipeline.run(cfg, device="cuda"),
   reading the .athdf file, at the tolerances of
   tests/test_simulation_e2e.py;
7. the simulation main path at full width: a 288 x 128 x 128 (r, theta,
   phi) SKS snapshot (the grid of the EHT GRMHD image library), 1024^2
   camera, rk4, 2000 steps, float32 through pipeline.run, counting kernel
   launches; then kernel times at 1024^2 in float32 rk4, float64 rk4 and
   float32 dp, and the plain version's in float32 rk4;
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
   order, each stage's time and the glue's, the plain version's in
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
    iterations) must print FIT OK; then 10 iterations at 1024^2, whose
    loss must be finite and fall;
13. K2.3, phased dispatch, run right after phase 7 on its snapshot:
    phase 7's configuration through pipeline.run with
    pipeline_simulation.KERNEL_PHASED on, counting phase launches (at
    most 4), whose image must be phase 7's bit for bit; the phase kernel
    held to its plain version on the image's second phase at full width;
    warp and block efficiencies of each ray order (camera order,
    spatial_order per tile size, each phase's launch order); best of 3 of
    the monolithic kernel in camera order and in spatial_order and of the
    phased render, with each phase's survivors, kernel time and
    compaction time.

Phases 4 to 13 run alone on the card, after phase 3.

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

Every line but the last two is a JSON object with the measurements (the
kernels line lists formula K1.1/K1.2, K1.3, K1.4, simulation, phased
simulation and polarized); then come the card's name and power limit, and the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
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
# per sample.
OPS_PER_STEP = {"rk4": 830, "rk2": 500, "dp": 2020}
OPS_PER_SAMPLE = {"formula": 130, "simulation": 495, "polarized": 2740}
POL_OPS_PER_FREQUENCY = 1090
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
# on one card (an H100 host has 8 cores).
WORKERS = 6
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def _kernel_label(mangled: str) -> str:
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
    """The instruction mixes of each formula kernel's step loop and its
    per-step path (scripts/sass_step_mix.py, the formula units built with
    line tables, all at once), by kernel label."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "sass_step_mix", ROOT / "scripts" / "sass_step_mix.py")
    mix = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mix)
    units = sorted(p.name for p in (ROOT / KERNEL_SOURCE).parent.glob(
        "formula_kernel*.cu"))
    per_ray = mix.per_ray_lines(ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        sass = mix.disassemble(ROOT, units, pathlib.Path(tmp))
    return {_kernel_label(name): mix.loop_mixes(code, per_ray)
            for unit in sass.values() for name, code in unit.items()
            if "formula_kernel" in name}


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
    sass = _sass(path)
    STEP_LOOPS.update(_step_loops())
    emit("build", seconds=build_s, library=path.name,
         ptxas=_ptxas_table(_build.ptxas_report()), fp64_sass=_sass_fp64(sass),
         formula_consts_bytes={f"{str(k[0])[6:]}, NF={k[1]}": v for k, v in
                               fk.consts_sizes(fk._library()).items()},
         formula_step_loops=STEP_LOOPS)
    if fk.consts_sizes(fk._library()) != fk.host_consts_sizes():
        raise RuntimeError("FormulaLaunchConsts and launch_consts disagree")


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


def phase_checks(pool) -> tuple:
    """Phase 3 on ``pool``: every check at once, longest first; emits each
    result in that order and raises at the first that failed. Returns
    phase 9's float64 reference (positions, Stokes), the plain formula
    version on the subsets of the full-width formula cells, by cell, and
    the polarized route's per-kernel checks."""
    t0 = time.perf_counter()
    truth = pool.apply_async(pol_full_width_truth)
    stages = pool.apply_async(check_polarized_stages)
    subsets = {cell: pool.apply_async(formula_plain_subset, (cell,))
               for cell in ("k13", "k14", "k11")}
    checks = [pool.apply_async(fn, args) for fn, args in (
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
        (check_simulation_phase, ("rk2", "float32")))]
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
    truth = truth.get()
    subsets = {cell: result.get() for cell, result in subsets.items()}
    emit("checks", workers=WORKERS, seconds=time.perf_counter() - t0)
    return truth, subsets, stages


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
    on the same rays) or formula_plain_subset's result for these rays.
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
            pick = np.arange(0, n, PLAIN_STRIDE)
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
        out["step_instructions"] = mixes.get("per_step", {}).get("total")
        out["loop_instructions"] = mixes.get("step_loop", {}).get("total")
        out["ray_steps"] = int(ns.astype("int64").sum())
        out["issue_estimate_ms"] = None if out["step_instructions"] is None \
            else (out["step_instructions"] * out["ray_steps"]
                  / (N_SMS * ISSUE_LANES_PER_SM * SM_CLOCK_HZ["max"]) * 1e3)
        extra.update({k: out[k] for k in (
            "step_loop", "step_instructions", "loop_instructions",
            "ray_steps", "issue_estimate_ms")})
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
    return _config(name, simulation_file=str(FIXTURES / "mock_small.athdf"),
                   **overrides)


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


def _second_phase(args, integrator, phase_steps):
    """The carried state of ``args``' rays after the phase kernel's first
    phase of ``phase_steps``, then their second phase through the kernel
    and through its plain version from that state: (kernel outputs, plain
    outputs, kernel seconds, plain seconds, rays in the second phase,
    their samples in it), the outputs as finish_rays gives them."""
    import torch
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    positions, directions, mom, freqs, params, sp, grid, mass, cam, log_js \
        = args
    carry = sk.initial_carry(positions, directions, params, freqs.shape[0])
    index = torch.arange(positions.shape[0], dtype=torch.int32,
                         device=positions.device)
    phase = (directions, mom, freqs, params, sp, grid, mass, cam, integrator)
    sk.render_simulation_phase(carry, index, 0, phase_steps, *phase)
    index = index[(carry.masks[index.long()] & sk.ALIVE) != 0]
    plain = sk.SimCarry(*(t.clone() for t in carry))
    before = carry.n_samp[index.long()]
    _, t_k = _timed(sk.render_simulation_phase, carry, index, phase_steps,
                    phase_steps, *phase)
    _, t_p = _timed(sk.render_simulation_phase_reference, plain, index,
                    phase_steps, phase_steps, *phase)
    samples = int((carry.n_samp[index.long()] - before).sum())
    fallback_nan = sp.sampler.fallback_nan
    return (sk.finish_rays(carry, index, freqs, log_js, fallback_nan),
            sk.finish_rays(plain, index, freqs, log_js, fallback_nan),
            t_k, t_p, int(index.numel()), samples)


def check_simulation_phase(integrator, precision) -> tuple:
    """The phase kernel (K2.3) against its plain version, 128^2: the
    second phase of KERNEL_PHASE_STEPS from the kernel's carried state
    after the first; rk4 float64 exact flags, n_samples and NaN sets and
    I within rtol 1e-7, rk2 float32 the statistical gate."""
    from blacklight_tpu_torch import pipeline_simulation
    cfg = _sim_config(camera_resolution=128, ray_integrator=integrator,
                      precision=precision)
    args, _ = _sim_args(cfg)
    out_k, out_p, t_k, t_p, rays, _ = _second_phase(
        args, integrator, pipeline_simulation.KERNEL_PHASE_STEPS)
    exact = precision == "float64"
    return "sim_phase_kernel_vs_plain", dict(
        integrator=integrator, precision=precision,
        phase_steps=pipeline_simulation.KERNEL_PHASE_STEPS, phase_rays=rays,
        kernel_s=t_k, plain_s=t_p,
        **_check_exact(out_k, out_p, 1e-7 if exact else None))


def phase_sim_goldens(tmp: pathlib.Path):
    import numpy as np
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.ops import simulation_kernel as sk
    for name, exact in (("golden_sim_rk4_32", True), ("golden_sim_32", False)):
        cfg = _sim_config(f"{name}.input",
                          output_file=str(tmp / f"{name}.npz"))
        before = sk.LAUNCHES
        arrays = pipeline.run(cfg, quiet=True, device="cuda")
        launched = sk.LAUNCHES - before
        ours = arrays["I_nu"]
        gold = np.load(FIXTURES / f"{name}.npz")["I_nu"]
        rel = np.abs(ours - gold) / (np.abs(gold) + gold.max() * 1e-8)
        if exact:
            ok = bool(np.allclose(ours, gold, rtol=1e-8, atol=0.0))
            gate = "rtol 1e-8"
        else:
            ok = bool(np.nanmax(rel) < 6e-2 and np.nanmean(rel) < 5e-3)
            gate = "max rel < 6e-2, mean rel < 5e-3"
        ok = ok and launched > 0
        emit("sim_golden", name=name, gate=gate, launches=launched,
             max_rel=float(np.nanmax(rel)), mean_rel=float(np.nanmean(rel)),
             ok=ok)
        if not ok:
            raise RuntimeError(f"golden {name} failed")


def full_width_snapshot(dtype):
    """FULL_GRID from scripts/generate_mock_simulation.make_fields on the
    card, as an Athena++ file would hold it (float32 values and
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
    fields = mock.make_fields(dict(mock.DEFAULTS, **FULL_GRID))
    names = ["rho", "press", "vel1", "vel2", "vel3", "Bcc1", "Bcc2", "Bcc3"]
    prim = np.stack([fields[k] for k in ("rho", "pgas", "uur", "uuth", "uuph",
                                         "bbr", "bbth", "bbph")])
    rows = [np.asarray(fields[k], np.float32)[None]
            for k in ("rf", "r", "thf", "th", "phf", "ph")]
    return simulation_grid(
        prim[:, None].astype(np.float32), *rows,
        {key: names.index(var) for key, var in PRIMITIVE_NAMES.items()}, 0.0,
        device=torch.device("cuda", torch.cuda.current_device()), dtype=dtype)


def phase_sim_full_width(tmp: pathlib.Path, card: str, grids: dict) -> dict:
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

    timings = {}
    for precision, integrator in (("float32", "rk4"), ("float64", "rk4"),
                                  ("float32", "dp")):
        if precision not in grids:
            grids[precision] = full_width_snapshot(torch.float64)
        cfg = _sim_config(camera_resolution=res, precision=precision,
                          ray_integrator=integrator, ray_max_steps=2000)
        (args, kwargs), t_setup = _timed(_sim_args, cfg, grids[precision])
        plain = sk.render_simulation_reference \
            if (precision, integrator) == ("float32", "rk4") else None
        timings[precision, integrator] = time_kernel(
            "sim_timing", sk.render_simulation, plain, args, kwargs, res,
            card, precision=precision, integrator=integrator,
            camera_setup_s=t_setup)
    f32 = timings["float32", "rk4"]
    return {"name": "simulation_kernel", "route": "cuda",
            "source": SIM_KERNEL_SOURCE, "replaces": SIM_KERNEL_REPLACES,
            "launches": launches, "max_abs_err": f32["max_abs_err"],
            "ms": f32["kernel_ms"], "plain_ms": f32["plain_ms"],
            **bound("simulation", "rk4", "float32", res * res,
                    f32["mean_n_samples"], in_bytes=grid_bytes(grids["float32"]),
                    out_values=1),
            "library_ms": None}, arrays


# Carried bytes per ray and phase launch besides the working type's
# values: read the index, n_samp, masks and bad (16); write n_samp, masks
# and bad (12). Values of the working type: read y (7), r_mid_prev, p_0,
# the momentum factor and per frequency intensity and tau (10 + 2), write
# y, r_mid_prev and per frequency intensity and tau (8 + 2).
PHASE_INT_BYTES = 28
PHASE_VALUES = 18
SPATIAL_BLOCKS = (128, 256, 512, 1024, 2048, 4096, 16384)


def phase_bound(rays, samples, precision, in_bytes) -> dict:
    """bound() for one phase launch: the carried state of ``rays`` rays
    and the snapshot read and written once, and ``samples`` samples of
    rk4 work (this phase's, counted from n_samples)."""
    item = 4 if precision == "float32" else 8
    n_bytes = rays * (PHASE_VALUES * item + PHASE_INT_BYTES) + in_bytes
    ops = samples * (OPS_PER_STEP["rk4"] + OPS_PER_SAMPLE["simulation"])
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[precision]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bound_ops": ops, "bound_bytes": n_bytes}


def phase_phased_full_width(tmp: pathlib.Path, card: str, grids: dict,
                            mono: dict) -> dict:
    """Phase 13 (K2.3): phase 7's configuration through pipeline.run with
    KERNEL_PHASED on, held bit for bit to phase 7's image ``mono``; the
    phase kernel against its plain version on the second phase; the
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
    out_k, out_p, t_k, t_p, rays2, samples2 = _second_phase(
        args, "rk4", ps.KERNEL_PHASE_STEPS)
    gate = _check_exact(out_k, out_p, None)
    emit("phase_kernel_vs_plain", resolution=res, card=card,
         second_phase_rays=rays2, kernel_ms=t_k * 1e3, plain_ms=t_p * 1e3,
         **gate)
    if not gate["ok"]:
        raise RuntimeError(f"the phase kernel disagrees with plain at "
                           f"{res}^2: {gate}")
    both = np.isfinite(out_k[0].cpu().numpy()) & np.isfinite(
        out_p[0].cpu().numpy())
    max_abs_err = float(np.max(np.abs(out_k[0].cpu().numpy()[both]
                                      - out_p[0].cpu().numpy()[both])))

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
            "work": (f"phase 1 (steps {ps.KERNEL_PHASE_STEPS}-"
                     f"{2 * ps.KERNEL_PHASE_STEPS - 1}) of the 1024^2 image, "
                     f"{rays2} rays"),
            **second, "library_ms": None}


def grid_bytes(grid) -> int:
    """Bytes the kernels read of a snapshot: the (k, j, i, 8) float32
    table and the coordinates."""
    nvar, _, n_k, n_j, n_i = grid.prim.shape
    item = grid.x1f.element_size()
    return 32 * n_k * n_j * n_i + item * (2 * (n_i + n_j + n_k) + 3)


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
    if kernel == "polarized":
        per_sample += POL_OPS_PER_FREQUENCY * frequencies
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
    rays, through the float64 snapshot: (their positions, Stokes)."""
    import torch
    # the camera's rays do not depend on the snapshot: cfg's small one
    # stands in for it here
    args, _, _ = _pol_args(_pol_full_config("float32", "rk4"))
    _, sub = _plain_subset(args)
    truth = _pol_truth(_pol_full_config("float64", "rk4"), sub,
                       full_width_snapshot(torch.float64))
    return sub[0].cpu().numpy(), truth


def phase_pol_goldens(tmp: pathlib.Path):
    import numpy as np
    from blacklight_tpu_torch import pipeline
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    tols = {"I_nu": 1e-8, "Q_nu": 1e-6, "U_nu": 1e-7, "V_nu": 1e-6}
    for name, exact in (("golden_polarized_rk4_32", True),
                        ("golden_polarized_32", False)):
        cfg = _pol_config(f"{name}.input",
                          output_file=str(tmp / f"{name}.npz"))
        before = pk.LAUNCHES
        arrays = pipeline.run(cfg, quiet=True, device="cuda")
        launched = pk.LAUNCHES - before
        gold = np.load(FIXTURES / f"{name}.npz")
        i_scale = float(np.nanmax(np.abs(gold["I_nu"])))
        ok, result = launched > 0, {}
        for k in ("I_nu", "Q_nu", "U_nu", "V_nu"):
            ours, g = arrays[k], gold[k]
            if exact:
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
             gate=("tests/test_polarized_e2e.py:28-42" if exact
                   else "tests/test_polarized_e2e.py:53-61"),
             **result, ok=bool(ok))
        if not ok:
            raise RuntimeError(f"golden {name} failed: {result}")


def pol_stage_bounds(rays, samples, precision, frequencies=1) -> dict:
    """Each kernel of the polarized route with its own bound: the bytes
    of its own inputs and outputs (rays, samples, records, coherency
    components) against its share of the operations (``samples`` stored
    samples in all)."""
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    item = 4 if precision == "float32" else 8
    sample = pk.SAMPLE_VALUES * item
    record = (pk.GEOMETRY_VALUES + pk.COEFFICIENT_VALUES * frequencies) * item
    chain_ops = POL_CHAIN_OPS_PER_FREQUENCY * frequencies
    work = {
        "trace": (rays * (9 * item + 8) + samples * sample,
                  samples * OPS_PER_STEP["rk4"]),
        "derive": (samples * (sample + record) + rays * 2 * item,
                   samples * (OPS_PER_SAMPLE["polarized"]
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
    float32 plain version's rays (their positions, Stokes),
    ``stage_checks`` phase 3's check of each kernel against its plain
    version."""
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
    camera order): the plain version on every PLAIN_STRIDE-th ray against
    it (polarized_gate) and both against phase 3's float64 run
    (truth_gate); a render under CHUNK_CHECK's byte caps equal to ``out``
    bit for bit. Raises on a failure; returns the numbers for the timing
    line."""
    import numpy as np
    import torch
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    pick, sub = _plain_subset(args)
    positions, truth = truth
    if not np.array_equal(positions, sub[0].cpu().numpy()):
        raise RuntimeError("the float64 reference traced other rays")
    out_p, t_plain = _timed(pk.render_polarized_reference, *sub, **kwargs)
    ours = _pol_stokes(tuple(o[pick] for o in out), sub, geom, True)
    ref = _pol_stokes(out_p, sub, geom, True)
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


def phase_fit(card: str):
    """Phase 12: ``python -m blacklight_tpu_torch.fit_demo`` as a user runs
    it (32^2, 200 Adam iterations on the card), which must print FIT OK;
    then 10 iterations of the same problem at 1024^2, whose loss must be
    finite and fall, with the time of each iteration."""
    import math
    from blacklight_tpu_torch import fit_demo
    from blacklight_tpu_torch.ops import formula_kernel as fk
    from blacklight_tpu_torch.ops import polarized_kernel as pk
    from blacklight_tpu_torch.ops import simulation_kernel as sk

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "blacklight_tpu_torch.fit_demo"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    lines = proc.stdout.strip().splitlines()
    ok = proc.returncode == 0 and "FIT OK" in lines
    emit("fit_demo", resolution=32, iterations=200, card=card,
         returncode=proc.returncode, seconds=time.perf_counter() - t0,
         output=lines[-4:], stderr=proc.stderr[-2000:], ok=ok)
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chunk-sweep", action="store_true",
                        help="only build and time the polarized route at "
                             "each trace chunk size")
    opts = parser.parse_args(argv)
    card = phase_device()
    import torch
    phase_build()
    if opts.chunk_sweep:
        phase_pol_chunks(card, full_width_snapshot(torch.float32))
    else:
        with multiprocessing.get_context("spawn").Pool(WORKERS) as pool:
            truth, subsets, pol_stages = phase_checks(pool)
        with tempfile.TemporaryDirectory(dir=ROOT / "build" / "kernels") \
                as tmp:
            tmp = pathlib.Path(tmp)
            phase_goldens(tmp)
            formula = phase_full_width(tmp, card, subsets["k11"])
            phase_sim_goldens(tmp)
            grids = {}
            simulation, mono = phase_sim_full_width(tmp, card, grids)
            phased = phase_phased_full_width(tmp, card, grids, mono)
            phase_pol_goldens(tmp)
            polarized = phase_pol_full_width(tmp, card, grids, truth,
                                             pol_stages)
            grids.clear()
            multi = phase_multi_full_width(tmp, card, subsets["k13"])
            tangent = phase_grad_full_width(card, subsets["k14"])
            phase_fit(card)
        print(json.dumps({"kernels": [formula, multi, tangent, simulation,
                                      phased, polarized]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
