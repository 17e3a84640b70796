"""AthenaK snapshots of the mock torus in mesh blocks, for the port's tests
and chip_smoke.py.

scripts/generate_mock_simulation.write_athenak writes the analytic a = 0
torus as one uniform Cartesian Kerr-Schild (CKS) block. ``write_blocks``
writes the same fields (``cks_fields``: write_athenak's formulas, at the
cell centres of each block) as a root grid of blocks with chosen root
blocks refined once, in AthenaK's binary format v1.1
(simulation_reader.cpp:915-1014 header, :433-588 block records): each
block's index range, logical location (at its level) and level, its six
face coordinates (float64) and its float32 variables. One root block
with no refinement gives write_athenak's file byte for byte. Only numpy
is needed (the card's Python has neither h5py nor JAX).
"""

from __future__ import annotations

import itertools

import numpy as np

# the variables AthenaK writes, in the order write_athenak writes them
VARIABLES = ("dens", "velx", "vely", "velz", "eint", "bcc1", "bcc2", "bcc3")
# The electron entropy of the port's code_kappa mocks: KAPPA_SCALE * pgas /
# rho^gamma_adi, write_athena's field scaled. Unscaled, the torus'
# electrons sit at theta_e ~ 1e-4, where every float32 intensity
# underflows to 0; scaled, theta_e spans ~0.2-3, the thermal cells' range,
# and the cold-cell branches (theta_e < 0.01) still occur.
KAPPA_SCALE = 1e7


def with_kappa(grid, gamma_adi, scale=KAPPA_SCALE):
    """The port's SimulationGrid ``grid`` with a ninth primitive "kappa":
    ``scale`` * pgas / rho^gamma_adi of its rho and pgas, formed in float64
    and stored in the grid's type, as a file's float32 variable would be
    read (torch is imported here: the writers need only numpy)."""
    import dataclasses

    import torch
    rho = grid.prim[grid.ind["rho"]].double()
    pgas = grid.prim[grid.ind["pgas"]].double()
    kappa = (scale * pgas / rho ** gamma_adi).float().to(grid.prim.dtype)
    return dataclasses.replace(
        grid, prim=torch.cat([grid.prim, kappa[None]]),
        ind={**grid.ind, "kappa": grid.prim.shape[0]})


def cks_fields(X, Y, Z, p) -> dict:
    """write_athenak's variables of the torus with parameters ``p``
    (generate_mock_simulation.DEFAULTS' keys) at CKS points X, Y, Z (any
    shape, float64): the SKS torus, its normal-frame velocity and
    cell-frame field carried to the CKS coordinate frame and then to the
    CKS normal frame (a = 0), in write_athenak's operation order."""
    R = np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
    TH = np.arccos(np.clip(Z / np.maximum(R, 1e-300), -1.0, 1.0))
    PH = np.mod(np.arctan2(Y, X), 2.0 * np.pi)

    def torus(amp, power, scale, floor=0.0):
        v = amp * R ** -power * np.exp(-np.abs(TH - np.pi / 2.0) / scale)
        keep = ((R >= p["cutoff_r_min"]) & (R <= p["cutoff_r_max"])
                & (TH >= p["cutoff_th_min"])
                & (TH <= np.pi - p["cutoff_th_min"]))
        return np.maximum(np.where(keep, v, 0.0), floor)

    rho = torus(p["rho_amp"], p["rho_r_power"], p["rho_th_scale"],
                p["rho_floor"])
    pgas = torus(p["pgas_amp"], p["pgas_r_power"], p["pgas_th_scale"],
                 p["pgas_floor"])
    uuph_sks = torus(p["uph_amp"], p["uph_r_power"], p["uph_th_scale"])
    rcyl = np.maximum(R * np.sin(TH), p["cutoff_r_min"])
    bbz = p["bz_amp"] * rcyl ** -p["bz_r_power"]
    bbr_sks = np.cos(TH) * bbz
    bbth_sks = -np.sin(TH) / R * bbz
    bbph_sks = (p["bph_amp"] * R ** -p["bph_r_power"]
                * np.exp(-np.abs(TH - np.pi / 2.0) / p["bph_th_scale"]))
    if not p["bph_no_flip"]:
        bbph_sks = bbph_sks * np.where(TH > np.pi / 2.0, -1.0, 1.0)

    # SKS normal frame -> SKS coordinate frame (a = 0)
    f2 = 2.0 / R
    g_rr = 1.0 + f2
    g_thth = R ** 2
    g_phph = (R * np.sin(TH)) ** 2
    gtt, gtr = -(1.0 + f2), f2
    alpha = 1.0 / np.sqrt(-gtt)
    uut = np.sqrt(1.0 + g_phph * uuph_sks ** 2)
    ut = uut / alpha
    ur = -alpha * uut * gtr
    uth = np.zeros_like(ut)
    uph = uuph_sks
    u_r = gtr * ut + g_rr * ur
    u_th = g_thth * uth
    u_ph = g_phph * uph
    bt = u_r * bbr_sks + u_th * bbth_sks + u_ph * bbph_sks
    br = (bbr_sks + bt * ur) / ut
    bth = (bbth_sks + bt * uth) / ut
    bph = (bbph_sks + bt * uph) / ut

    # SKS -> CKS vector components (a = 0)
    sth, cth = np.sin(TH), np.cos(TH)
    sph, cph = np.sin(PH), np.cos(PH)

    def to_cks(vr, vth, vph):
        vx = sth * cph * vr + R * cth * cph * vth - R * sth * sph * vph
        vy = sth * sph * vr + R * cth * sph * vth + R * sth * cph * vph
        vz = cth * vr - R * sth * vth
        return vx, vy, vz

    ux, uy, uz = to_cks(ur, uth, uph)
    bx, by, bz = to_cks(br, bth, bph)

    # CKS coordinate frame -> CKS normal frame (a = 0)
    fc = 2.0 / R
    alpha_c = 1.0 / np.sqrt(1.0 + fc)
    lx, ly, lz = X / R, Y / R, Z / R
    values = (rho, ux + alpha_c ** 2 * fc * lx * ut,
              uy + alpha_c ** 2 * fc * ly * ut,
              uz + alpha_c ** 2 * fc * lz * ut,
              pgas / (p["gamma_adi"] - 1.0),
              bx * ut - bt * ux, by * ut - bt * uy, bz * ut - bt * uz)
    return dict(zip(VARIABLES, values))


def block_layout(root: int, refine=()) -> list:
    """(level, (i, j, k)) of each block of a root grid of root^3 blocks
    with the root blocks ``refine`` ((i, j, k) each) split once into
    their 8 children, in file order: root blocks k, j, i, each refined
    one replaced in place by its children, k, j, i."""
    refine = {tuple(r) for r in refine}
    layout = []
    for k, j, i in itertools.product(range(root), repeat=3):
        if (i, j, k) not in refine:
            layout.append((0, (i, j, k)))
            continue
        for dk, dj, di in itertools.product((0, 1), repeat=3):
            layout.append((1, (2 * i + di, 2 * j + dj, 2 * k + dk)))
    return layout


def write_blocks(path, p, *, root=1, cells=None, refine=(), spin=0.0,
                 location_size=8, variable_size=4, extra_variables=(),
                 parameters="", kappa_scale=None) -> int:
    """Write the torus of ``p`` on write_athenak's cube [-w, w]^3 (w =
    r_max / sqrt(2)) as root^3 root blocks of
    ``cells``^3 cells (write_athenak's max(n_r, 32) by default), with the
    root blocks ``refine`` split once (block_layout), a block at a time.
    ``spin`` goes in the parameter section (the fields are the a = 0
    torus), and ``parameters`` after it (more sections, as text). Faces
    are written as floats of ``location_size`` bytes, variables of
    ``variable_size``; each of ``extra_variables`` (names) follows the
    eight with the density times 2, 3, ..., and with ``kappa_scale`` a
    variable "kappa" last: kappa_scale * pgas / dens^gamma_adi, pgas =
    (gamma_adi - 1) eint (write_athena's electron entropy, scaled).
    Returns the number of blocks."""
    n = cells or max(p["n_r"], 32)
    w = p["r_max"] / np.sqrt(2.0)
    layout = block_layout(root, refine)
    param_text = (f"<coord>\na = {float(spin)}\n<mhd>\ngamma = "
                  f"{p['gamma_adi']}\n{parameters}").encode()
    names = VARIABLES + tuple(extra_variables) + (
        ("kappa",) if kappa_scale is not None else ())
    loc_dtype = np.float32 if location_size == 4 else np.float64
    var_dtype = np.float32 if variable_size == 4 else np.float64
    with open(path, "wb") as f:
        f.write(b"Athena binary output version=1.1\n")
        f.write(b"  size of preheader=5\n")
        f.write(f"  time={p['time']}\n".encode())
        f.write(b"  cycle=0\n")
        f.write(f"  size of location={location_size}\n".encode())
        f.write(f"  size of variable={variable_size}\n".encode())
        f.write(f"  number of variables={len(names)}\n".encode())
        f.write(("  variables:" + "".join("  " + v for v in names)
                 + "\n").encode())
        f.write(f"  header offset={len(param_text)}\n".encode())
        f.write(param_text)
        idx = np.array([0, n - 1, 0, n - 1, 0, n - 1], dtype=np.int32)
        for level, loc in layout:
            span = 2.0 * w / (root << level)
            lo = [-w + span * c for c in loc]
            hi = [-w + span * (c + 1) for c in loc]
            axes = []
            for a in range(3):
                xf = np.linspace(lo[a], hi[a], n + 1)
                axes.append(0.5 * (xf[:-1] + xf[1:]))
            X, Y, Z = np.meshgrid(*axes, indexing="ij")
            fields = cks_fields(X.transpose(2, 1, 0), Y.transpose(2, 1, 0),
                                Z.transpose(2, 1, 0), p)
            f.write(idx.tobytes())
            f.write(np.array(loc, dtype=np.int32).tobytes())
            f.write(np.array([level], dtype=np.int32).tobytes())
            f.write(np.array([lo[0], hi[0], lo[1], hi[1], lo[2], hi[2]],
                             dtype=loc_dtype).tobytes())
            for q, name in enumerate(extra_variables):
                fields[name] = fields["dens"] * (q + 2.0)
            if kappa_scale is not None:
                gamma = p["gamma_adi"]
                fields["kappa"] = kappa_scale * (gamma - 1.0) \
                    * fields["eint"] / fields["dens"] ** gamma
            for name in names:
                f.write(np.ascontiguousarray(fields[name],
                                             dtype=var_dtype).tobytes())
    return len(layout)

