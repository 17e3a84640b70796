"""PyTorch port: scripts/sass_step_mix.py's reading of a kernel's SASS
(nvdisasm -gi output with inline line tables), checked on the CPU on a
made-up listing: the step loop it finds, the per-step path it keeps (the
loop without the instructions that the per-ray functions lead to) and the
per-ray lines it takes from the port's sources. The issue estimates of
chip_smoke.py and scripts/formula_kernel_ab.py rest on these."""

import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "blacklight_tpu_torch" / "csrc"


@pytest.fixture(scope="module")
def mix():
    spec = importlib.util.spec_from_file_location(
        "sass_step_mix", ROOT / "scripts" / "sass_step_mix.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


K = '"/src/csrc/formula_kernel.cuh"'
KERR = '"/src/csrc/kerr.cuh"'
LISTING = f"""
\t.section\t.text._Z6kernelv,"ax",@progbits
\t//## File {K}, line 500
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_0:
\t//## File {KERR}, line 96 inlined at {K}, line 520
\t//## File {K}, line 520 inlined at {K}, line 600
\t//## File {K}, line 600
        /*0010*/                   FADD R2, R2, R3 ;
        /*0020*/                   MUFU.RSQ R4, R2 ;
\t//## File {KERR}, line 96 inlined at {K}, line 610
\t//## File {K}, line 610
        /*0030*/                   FFMA R5, R4, R4, R2 ;
        /*0040*/               @P0 BRA `(.L_x_1) ;
        /*0050*/                   STL [R1], R5 ;
.L_x_1:
\t//## File {K}, line 612
        /*0060*/               @P1 BRA `(.L_x_0) ;
        /*0070*/                   EXIT ;
\t.section\t.text._Z5otherv,"ax",@progbits
        /*0000*/                   EXIT ;
"""


def test_functions_read_chains_and_labels(mix):
    code = mix.functions(LISTING)
    assert list(code) == ["_Z6kernelv", "_Z5otherv"]
    kernel = code["_Z6kernelv"]
    assert [c[0] for c in kernel] == list(range(0, 0x80, 0x10))
    assert kernel[1][3] == (("kerr.cuh", 96), ("formula_kernel.cuh", 520),
                            ("formula_kernel.cuh", 520),
                            ("formula_kernel.cuh", 600),
                            ("formula_kernel.cuh", 600))
    # an instruction after another keeps the chain above both
    assert kernel[2][3] == kernel[1][3]
    assert kernel[5][3] == kernel[4][3]
    # branch targets become the labels' addresses
    assert kernel[4][2].startswith("0x60")
    assert kernel[6][2].startswith("0x10")


def test_step_loop_and_per_step_path(mix):
    kernel = mix.functions(LISTING)["_Z6kernelv"]
    loop = mix.step_loop(kernel)
    assert [c[0] for c in loop] == [0x10, 0x20, 0x30, 0x40, 0x50, 0x60]
    # lines 515-530 of the kernel source run once per ray: the FADD and
    # MUFU inlined from there leave the per-step path, the FFMA inlined
    # from kerr.cuh elsewhere stays
    per_ray = {("formula_kernel.cuh", n) for n in range(515, 531)}
    step = mix.per_step(loop, per_ray)
    assert [c[1] for c in step] == ["FFMA", "BRA", "STL", "BRA"]
    mixes = mix.loop_mixes(kernel, per_ray)
    assert mixes["step_loop"]["total"] == 6
    assert mixes["step_loop"]["sqrt_sequences"] == 1
    assert mixes["per_step"]["total"] == 4
    assert mixes["per_step"]["sqrt_sequences"] == 0
    assert mixes["per_step"]["local_memory"] == 1
    assert mixes["per_step"]["branch"] == 2


def test_bodies_finds_functions_and_lambdas_not_calls(mix):
    text = "\n".join([
        "template <typename T>",                        # 1
        "__device__ void start_geometry(const T& g,",   # 2
        "                               T (&y)[7]) {",  # 3
        "  if (g.flat) {",                              # 4
        "    y[0] = T(0);",                             # 5
        "  }",                                          # 6
        "}",                                            # 7
        "void kernel() {",                              # 8
        "  auto finish_ray = [&]() {",                  # 9
        "    out[ray] = x;",                            # 10
        "  };",                                         # 11
        "  start_geometry<T, I>(g, y);",                # 12
        "  finish_ray();",                              # 13
        "}",                                            # 14
    ])
    assert list(mix._bodies(text, "start_geometry")) == [(2, 7)]
    assert list(mix._bodies(text, "finish_ray")) == [(9, 11)]
    assert list(mix._bodies(text, "take_rays")) == []


def test_per_ray_lines_cover_the_lanes_once_per_ray_code(mix):
    """In this checkout's formula kernel, every function of
    PER_RAY_FUNCTIONS is found, and the lines of the step itself and of the
    sample are not among them."""
    lines = mix.per_ray_lines(ROOT)
    for file, names in mix.PER_RAY_FUNCTIONS.items():
        text = (CSRC / file).read_text()
        for name in names:
            bodies = list(mix._bodies(text, name))
            assert bodies, name
            assert all((file, n) in lines for a, b in bodies
                       for n in range(a, b + 1))
    source = (CSRC / "formula_kernel.cuh").read_text().splitlines()
    for pattern in ("dp_control(tc, s, y, ye, y4, hs, accept",
                    "sample(ym, k1, k2, k3, hs, r_mid);",
                    "formula_jalpha(c, g, mom, c.nu[f], em.cn0"):
        line = next(i for i, t in enumerate(source, 1) if pattern in t)
        assert ("formula_kernel.cuh", line) not in lines
    rejected = next(i for i, t in enumerate(source, 1)
                    if "start_geometry<T, INTEGRATOR>(g, y, here);" in t)
    assert ("formula_kernel.cuh", rejected) not in lines
