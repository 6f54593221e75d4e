# SPDX-License-Identifier: Apache-2.0
"""DFT-D3 parameter tables in the reference data format (numpy only).

A copy of the table construction in
``nvalchemiops_tpu/interactions/dispersion/d3_data.py``
(``build_d3_format_tables`` and the committed realistic H/He/C/N/O/Cl/Cs
slice ``realistic_test_tables``), so the port runs where JAX is not
installed.  See that module for the format contract and the provenance of
every constant; ``tests/test_torch_d3.py`` asserts the two copies produce
identical tables.
"""

from __future__ import annotations

import numpy as np

__all__ = ["build_d3_format_tables", "realistic_test_tables"]

_ZMAX = 94


def build_d3_format_tables(entries, rcov=None, r4r2=None,
                           zmax: int = _ZMAX) -> dict[str, np.ndarray]:
    """Assemble ``{rcov, r4r2, c6ab, cn_ref}`` from C6 reference records.

    ``entries``: iterable of ``(zi, zj, p, q, c6, cn_i, cn_j)`` with 0-based
    grid indices ``p, q``.  Reproduces the reference loader's fill semantics
    exactly (utils.py:505-560): symmetric C6 assignment, first-win CN
    values, -1.0 ``cn_ref`` fill, and the partner-0 column left at -1.
    """
    zi1 = zmax + 1
    c6ab = np.zeros((zi1, zi1, 5, 5), dtype=np.float32)
    cn_ref = np.full((zi1, zi1, 5, 5), -1.0, dtype=np.float32)
    cn_of: dict[int, dict[int, float]] = {}

    for zi, zj, p, q, c6, cn_i, cn_j in entries:
        c6ab[zi, zj, p, q] = c6
        c6ab[zj, zi, q, p] = c6
        cn_of.setdefault(zi, {}).setdefault(p, cn_i)
        cn_of.setdefault(zj, {}).setdefault(q, cn_j)

    for z, by_p in cn_of.items():
        for p, cn in by_p.items():
            cn_ref[z, 1:, p, :] = cn

    if rcov is None:
        rcov = np.zeros(zi1, dtype=np.float32)
    if r4r2 is None:
        r4r2 = np.zeros(zi1, dtype=np.float32)
    return {
        "rcov": np.asarray(rcov, np.float32),
        "r4r2": np.asarray(r4r2, np.float32),
        "c6ab": c6ab,
        "cn_ref": cn_ref,
    }


# --------------------------------------------------------------------------
# Committed realistic slice (H, He, C, N, O, Cl, Cs)
# --------------------------------------------------------------------------
#
# Structure (reference-CN grids per element, i.e. which (p, q) points exist)
# follows the published Grimme DFT-D3 data exactly: H has 2 reference
# systems, He 1, C 5, N 4, O 3.  Element constants below carry explicit
# provenance (Grimme, Antony, Ehrlich, Krieg, J. Chem. Phys. 132, 154104
# (2010) and the dftd3.f data blocks it ships):
#
# - ``_RCOV_ANG``: covalent radii in Angstrom (Pyykko & Atsumi, Chem. Eur.
#   J. 15 (2009) 188), metallic elements reduced by 10% as in dftd3.f.
#   The 4/3 / autoang scaling below reproduces the dftd3.f ``rcov`` block:
#   H 0.80628, He 1.15903, C 1.88973, N 1.78894, O 1.58737 (Li 3.02356
#   confirms the 10% metal reduction: 1.33 * 0.9 * 4/3 / autoang).
# - ``_R2R4_RAW``: the dftd3.f ``r2r4`` block (<r^4>/<r^2> expectation
#   values); the derived r4r2 = sqrt(0.5 r2r4 sqrt(z)) match the published
#   table: H 2.00735, He 1.56637, C 3.10493, N 2.71175, O 2.59362,
#   Cl 3.72932.
# - ``_C6_FREE``: free-atom-limit C6(z,z) from pars.f: H 7.5916, He 1.5583,
#   C 49.1130, N 25.2685, O 15.5059.
# - ``_C6_EXACT``: individually transcribed pars.f records (H-H pair grid).
#
# Provenance tiers (each constant below is tagged with one):
#
# - PARSF      — transcribed from Grimme's published dftd3.f / pars.f data
#                blocks (the values the reference loader would produce);
#                pinned bit-for-bit by test_real_tables.py.
# - PUBLISHED  — a published literature value with an explicit citation,
#                used where the pars.f record itself is not reproducible in
#                this offline environment (the reference downloads Grimme's
#                tarball at example runtime rather than shipping it,
#                examples/dispersion/utils.py:281-530).  Same physical
#                quantity, independent high-accuracy source.
# - MODEL      — generated filler with documented structure (used only for
#                cross-element C6 grids involving the light test elements;
#                never load-bearing for physical-energy assertions).
#
# Tests built on this slice validate format handling (element structure,
# -1 sentinels, availability masking, variable reference counts), engine
# cross-consistency, and the PARSF/PUBLISHED constants, with frozen
# physical-energy regressions (extending the role the reference's dummy
# tables play in its own suite, reference test conftest.py:38-160).

#: per-element reference coordination numbers (0-based grid order).
#: H/He/C/N/O: PARSF (published pars.f grids).  Cl/Cs: the element has
#: exactly two reference systems (free atom + the diatomic hydride /
#: halogen reference) with the bonded reference at CN ~ 0.97-0.99; the
#: grid values follow the published per-family pattern (halogens: Cl
#: 0.9737 matches the F/Cl/Br/I hydride-reference series; alkali metals:
#: Li..Cs all sit at 0.986-0.987).
_REF_CN = {
    1: [0.9118, 0.0],                          # H: H2, free atom   PARSF
    2: [0.0],                                  # He: free atom only PARSF
    6: [0.0, 0.9868, 1.9985, 2.9987, 3.9844],  # C                  PARSF
    7: [0.0, 0.9944, 2.0143, 2.9903],          # N                  PARSF
    8: [0.0, 0.9925, 1.9887],                  # O                  PARSF
    17: [0.0, 0.9737],                         # Cl (free, HCl)
    55: [0.0, 0.9867],                         # Cs (free, CsH)
}

#: free-atom (CN grid point with cn == 0) homo-pair C6 values, a.u.
#: H/He/C/N/O: PARSF.  Cl: PUBLISHED — the D3 paper's own comparison
#: table quotes the computed free-atom Cl-Cl C6 = 92.3 a.u. vs the
#: experimental (dipole-oscillator-strength) 94.6 a.u. of Kumar & Meath;
#: the TDDFT table value is used here.  Cs: PUBLISHED — accurate
#: relativistic many-body value for the Cs dimer, C6 = 6851(74) a.u.
#: (Derevianko, Johnson, Safronova, Babb, Phys. Rev. Lett. 82, 3589
#: (1999)); the pars.f TDDFT record is not reproducible offline, and
#: this is the best-established physical value of the same quantity.
_C6_FREE = {1: 7.5916, 2: 1.5583, 6: 49.1130, 7: 25.2685, 8: 15.5059,
            17: 92.3, 55: 6851.0}

#: static dipole polarizabilities, a.u. (PUBLISHED: CRC/Schwerdtfeger
#: recommended values; Cs 401.0 — Derevianko et al. 1999; Cl 14.6).
#: Used only for the Casimir-Polder/Tang two-point combination of
#: PUBLISHED homo-pair C6 into hetero pairs (see ``_c6_combine``).
_ALPHA0 = {1: 4.50, 2: 1.38, 6: 11.3, 7: 7.4, 8: 5.3, 17: 14.6, 55: 401.0}

#: individually transcribed pars.f records: (zi, zj, p, q) -> C6  PARSF
_C6_EXACT = {
    (1, 1, 0, 0): 3.0267,   # H(CN .9118) - H(CN .9118)
    (1, 1, 0, 1): 4.7379,   # H(CN .9118) - H(free)
}

#: covalent radii, Angstrom (PARSF: Pyykko-Atsumi radii as used by the
#: dftd3.f rcov block; metals x 0.9 per dftd3.f)
_RCOV_ANG = {1: 0.32, 2: 0.46, 6: 0.75, 7: 0.71, 8: 0.63, 17: 0.99,
             55: 2.088}  # Cs = 2.32 x 0.9 (metal)

#: dftd3.f r2r4 data block (raw <r^4>/<r^2>).  H..Cl: PARSF.
#: Cs: PUBLISHED — chosen to reproduce the sqrt(Z)-scaled table value
#: r4r2(Cs) = 11.02204549 shared by the standard D3 implementations
#: (the alkali series of that table runs Na 6.58586, K 7.97763,
#: Rb 9.55462, Cs 11.02205); raw = 2 * r4r2^2 / sqrt(55).
_R2R4_RAW = {1: 8.0589, 2: 3.4698, 6: 7.8715, 7: 5.5588, 8: 4.7566,
             17: 6.7463, 55: 2.0 * 11.02204549**2 / np.sqrt(55.0)}

_AUTOANG = 0.52917726

#: scaled covalent radii (Bohr): 4/3 x r_cov / autoang (dftd3.f scaling)
_RCOV = {z: (4.0 / 3.0) * r / _AUTOANG for z, r in _RCOV_ANG.items()}

#: sqrt-scaled <r^4>/<r^2>: sqrt(0.5 * r2r4 * sqrt(z)) (dftd3.f scaling)
_R4R2 = {z: float(np.sqrt(0.5 * v * np.sqrt(z)))
         for z, v in _R2R4_RAW.items()}


def _c6_combine(zi: int, zj: int) -> float:
    """Casimir-Polder/Tang two-point combination of free-atom C6 values.

    ``C6_AB = 2 C6_AA C6_BB / ((alpha_B/alpha_A) C6_AA
    + (alpha_A/alpha_B) C6_BB)`` with PUBLISHED static polarizabilities —
    the standard physically-grounded hetero-pair estimate (exact for
    single-frequency Drude oscillators).  Reduces to ``C6_AA`` for
    ``zi == zj``.
    """
    ci, cj = _C6_FREE[zi], _C6_FREE[zj]
    ai, aj = _ALPHA0[zi], _ALPHA0[zj]
    return 2.0 * ci * cj / ((aj / ai) * ci + (ai / aj) * cj)


def realistic_test_tables(dtype=np.float32) -> dict[str, np.ndarray]:
    """The committed H/He/C/N/O/Cl/Cs slice in the reference data format.

    C6 values: the verified constants where available (``_C6_FREE``
    homo-pair free-atom limits, ``_C6_EXACT`` transcribed records);
    hetero pairs from the Casimir-Polder combination of the free-atom
    coefficients (:func:`_c6_combine`); higher-coordination references
    damped multiplicatively (each CN step reduces C6 by ~12%, the
    qualitative trend of the real tables — a MODEL factor, the one piece
    with no offline-reproducible source).  Pairs among the light test
    elements additionally carry a small deterministic non-separable
    ripple so tests cannot silently rely on value separability; the
    Cs/Cl benchmark-path pairs (both elements in {17, 55}) are kept
    ripple-free so the headline crystal's physics is clean published
    base values x the documented CN damping.
    """
    bench_elems = {17, 55}
    entries = []
    elems = sorted(_REF_CN)
    for zi in elems:
        for zj in elems:
            for p, cn_i in enumerate(_REF_CN[zi]):
                for q, cn_j in enumerate(_REF_CN[zj]):
                    if (zi, zj, p, q) in _C6_EXACT:
                        c6 = _C6_EXACT[zi, zj, p, q]
                    elif (zj, zi, q, p) in _C6_EXACT:
                        c6 = _C6_EXACT[zj, zi, q, p]
                    elif zi == zj and cn_i == 0.0 and cn_j == 0.0:
                        c6 = _C6_FREE[zi]
                    else:
                        base = _c6_combine(zi, zj)
                        damp = 0.88 ** (cn_i + cn_j)
                        if zi in bench_elems and zj in bench_elems:
                            ripple = 1.0
                        else:
                            ripple = 1.0 + 0.05 * np.sin(3.1 * zi + 1.7 * zj
                                                         + 2.3 * p + 0.9 * q)
                        c6 = base * damp * ripple
                    entries.append((zi, zj, p, q, c6, cn_i, cn_j))
    zmax = max(elems)
    rcov = np.zeros(zmax + 1, dtype=np.float64)
    r4r2 = np.zeros(zmax + 1, dtype=np.float64)
    for z in elems:
        rcov[z] = _RCOV[z]
        r4r2[z] = _R4R2[z]
    out = build_d3_format_tables(entries, rcov=rcov, r4r2=r4r2, zmax=zmax)
    return {k: np.asarray(v, dtype) for k, v in out.items()}
