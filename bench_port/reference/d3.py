# SPDX-License-Identifier: Apache-2.0
"""DFT-D3(BJ) energy, forces and coordination numbers over an ordered
pair list (reference/neighbors.py), from the published formulas
(Grimme et al., J. Chem. Phys. 132, 154104 (2010); J. Comput. Chem. 32,
1456 (2011)), as the benchmark's tables state them:

- ``CN_i = sum_j 1 / (1 + exp(-k1 ((rcov_i + rcov_j) / r - 1)))``;
- ``C6_ij = sum_pq L_ip L_jq c6ab[z_i, z_j, p, q]`` with ``L_i.`` the
  softmax of ``k3 (CN_i - cn_ref[z_i, p])^2`` over the references that
  element ``z_i`` has (``c6ab`` nonzero);
- ``E = sum_pairs -C6 (s6 / (r^6 + R0^6) + s8 rr / (r^8 + R0^8))``, ``rr =
  3 r4r2_i r4r2_j``, ``R0 = a1 sqrt(rr) + a2``, every pair within the
  cutoff once;
- forces ``-dE/dr`` by autograd, the CN dependence included.
"""

from __future__ import annotations

import torch

PAIR_CHUNK = 1 << 22


def _chunks(n: int, step: int = PAIR_CHUNK):
    for a in range(0, n, step):
        yield slice(a, min(n, a + step))


class Tables:
    """The element tables as tensors: ``rcov [Z]``, ``r4r2 [Z]``, ``c6ab
    [Z, Z, m, m]``, ``cn_ref [Z, m]``; ``avail [Z, m]`` is where an
    element has a reference (``c6ab`` nonzero for some partner)."""

    def __init__(self, rcov, r4r2, c6ab, cn_ref, dtype, device):
        def t(a):
            return torch.as_tensor(a, dtype=torch.float64).to(device, dtype)

        self.rcov, self.r4r2, self.c6ab, self.cn_ref = (
            t(a) for a in (rcov, r4r2, c6ab, cn_ref))
        self.avail = (torch.as_tensor(c6ab) != 0).any(dim=3).any(dim=1).to(
            device)


def _weights(cn, z, tab: Tables):
    """``L [P, m]``: the Gaussian reference weights of atoms ``z`` at
    coordination ``cn``, normalized over the references they have."""
    arg = tab.k3 * (cn[:, None] - tab.cn_ref[z]) ** 2
    arg = torch.where(tab.avail[z], arg, torch.full((), -torch.inf,
                                                    dtype=arg.dtype,
                                                    device=arg.device))
    return torch.softmax(arg, dim=-1)


def _pair_energy(d, zi, zj, cn_i, cn_j, tab: Tables, p):
    r2 = (d * d).sum(-1)
    li = _weights(cn_i, zi, tab)
    lj = _weights(cn_j, zj, tab)
    c6 = torch.einsum("np,npq,nq->n", li, tab.c6ab[zi, zj], lj)
    rr = 3.0 * tab.r4r2[zi] * tab.r4r2[zj]
    r0 = p["a1"] * torch.sqrt(rr) + p["a2"]
    r6 = r2 * r2 * r2
    r8 = r6 * r2
    return -c6 * (p["s6"] / (r6 + r0 ** 6) + p["s8"] * rr / (r8 + r0 ** 8))


def _cn_pair(d, zi, zj, tab: Tables, k1: float):
    r = torch.sqrt((d * d).sum(-1))
    return torch.sigmoid(k1 * ((tab.rcov[zi] + tab.rcov[zj]) / r - 1.0))


def dftd3(pairs, numbers, n_atoms: int, rcov, r4r2, c6ab, cn_ref, params,
          dtype=torch.float64, acc=torch.float64):
    """``(energy, forces [n, 3], cn [n])`` of one system.

    ``pairs = (i, j, d)`` from :func:`reference.neighbors.ordered_pairs`;
    ``numbers [n]`` index the tables (0 is never an atom here);
    ``params`` holds ``a1, a2, s6, s8, k1, k3``."""
    i, j, d64 = pairs
    device = d64.device
    z = torch.as_tensor(numbers, device=device).long()
    tab = Tables(rcov, r4r2, c6ab, cn_ref, dtype, device)
    tab.k3 = float(params["k3"])
    k1 = float(params["k1"])
    p = {k: float(params[k]) for k in ("a1", "a2", "s6", "s8")}
    npairs = i.shape[0]

    cn = torch.zeros(n_atoms, dtype=acc, device=device)
    with torch.no_grad():
        for s in _chunks(npairs):
            f = _cn_pair(d64[s].to(dtype), z[i[s]], z[j[s]], tab, k1)
            cn.index_add_(0, i[s], f.to(acc))

    cn_leaf = cn.to(dtype).requires_grad_(True)
    energy = torch.zeros((), dtype=acc, device=device)
    forces = torch.zeros(n_atoms, 3, dtype=acc, device=device)
    de_dcn = torch.zeros(n_atoms, dtype=acc, device=device)
    for s in _chunks(npairs):
        ds = d64[s].to(dtype).requires_grad_(True)
        zi, zj = z[i[s]], z[j[s]]
        # ordered pairs: each pair twice, so half of each
        e = 0.5 * _pair_energy(ds, zi, zj, cn_leaf[i[s]], cn_leaf[j[s]], tab,
                               p).to(acc).sum()
        gd, gcn = torch.autograd.grad(e, (ds, cn_leaf))
        energy += e.detach()
        # d = r_j - r_i: F_i = +dE/dd, F_j = -dE/dd
        forces.index_add_(0, i[s], gd.to(acc))
        forces.index_add_(0, j[s], -gd.to(acc))
        de_dcn += gcn.to(acc)

    w = de_dcn.to(dtype)
    for s in _chunks(npairs):
        ds = d64[s].to(dtype).requires_grad_(True)
        chain = (w[i[s]] * _cn_pair(ds, z[i[s]], z[j[s]], tab, k1)).to(
            acc).sum()
        (gd,) = torch.autograd.grad(chain, (ds,))
        forces.index_add_(0, i[s], gd.to(acc))
        forces.index_add_(0, j[s], -gd.to(acc))
    return energy, forces, cn
