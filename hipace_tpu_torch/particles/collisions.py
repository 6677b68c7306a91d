"""Binary Coulomb collisions (Perez et al., Phys. Plasmas 19, 083104 (2012)).

Port of ``hipace_tpu/particles/collisions.py`` (ref
CoulombCollision.{H,cpp}, ElasticCollisionPerez.H, UpdateMomentumPerez.H,
ComputeTemperature.H), function for function. The per-cell binning and
shuffle is a sort by (cell, uniform); the per-cell pairing loop is one
elementwise pass over pairs, rank r with rank r + n/2 of its cell. A
same-species cell with an odd count runs the reference's cyclic reuse: a
second pass pairs rank 0, after its first kick, with rank n - 1 (ref
ElasticCollisionPerez.H:146-188). Another species (a plasma or a beam's
emitted lanes) pairs each of its lanes with a random lane of the plasma
in its cell.

The draws are arguments: every function takes the uniforms it uses as
tensors (the sort keys, the partner pick, and the four draws of
``_pair_kick``), so the same draws give the same collisions on any device.
Both sorts are stable argsorts, so tied uniforms keep lane order, as
``jnp.argsort`` does. Where several lanes pick the same partner, the
partner takes the kick of the last of them in lane order, which is what the
JAX package's scatter does on the CPU (ROADMAP R17); here it is chosen
explicitly, so the card gives the same answer. The cell sums are
``index_add_``, the cell starts ``searchsorted``; nothing is read back to
the host.

All momenta are proper velocities u = gamma beta c; plasma lanes carry
(ux, uy, psi), beams (ux, uy, uz).
"""

from __future__ import annotations

import math

import torch

from .. import constants as cst
from ..geometry import Geometry


def _cell_of(x, y, geom: Geometry):
    """Each lane's cell iy * nx + ix, nx * ny outside the grid, and the
    inside mask."""
    ix = torch.floor((x - geom.prob_lo[0]) / geom.dx).to(torch.int64)
    iy = torch.floor((y - geom.prob_lo[1]) / geom.dy).to(torch.int64)
    ok = (ix >= 0) & (ix < geom.nx) & (iy >= 0) & (iy < geom.ny)
    return torch.where(ok, iy * geom.nx + ix,
                       torch.full_like(ix, geom.nx * geom.ny)), ok


def _shuffled_cell_sort(cell, r):
    """The permutation that sorts the lanes by cell, in the order of their
    uniforms r within a cell; ties keep lane order."""
    perm0 = torch.argsort(r, stable=True)
    return perm0[torch.argsort(cell[perm0], stable=True)]


def _gamma_plasma(ux, uy, psi, inv_c2):
    return (1.0 + (ux * ux + uy * uy) * inv_c2 + psi * psi) / (2.0 * psi)


def _cellsum(cells, v, ncell):
    """Sum of v over each cell; lanes at cell ncell are dropped."""
    return torch.zeros(ncell + 1, dtype=v.dtype, device=v.device).index_add_(
        0, cells, v)[:ncell]


def _pair_kick(u1x, u1y, u1z, g1, u2x, u2y, u2z, g2, n1, n2, n12,
               q1, m1, w1, q2, m2, w2, dt, L, lmdD, normalized_units, draws):
    """Vectorized UpdateMomentumPerezElastic (ref UpdateMomentumPerez.H:
    28-292). draws: the four uniforms per pair (scattering angle, azimuth,
    and the two weight rejections), a (4, n) tensor or four (n,) ones.
    Returns (new u1 triple, new u2 triple) in the input unit system."""
    inv_c_SI = 1.0 / cst.SI_c
    inv_c2_SI = inv_c_SI * inv_c_SI
    tiny = 1e-300

    diffm = torch.sqrt((u1x - u2x) ** 2 + (u1y - u2y) ** 2
                       + (u1z - u2z) ** 2)
    summm = torch.sqrt(u1x ** 2 + u1y ** 2 + u1z ** 2) \
        + torch.sqrt(u2x ** 2 + u2y ** 2 + u2z ** 2)
    no_collide = (diffm < tiny) | (diffm < 1e-10 * summm)

    if normalized_units:
        m1v = m1 * cst.SI_m_e
        m2v = m2 * cst.SI_m_e
        c = cst.SI_c
        u1x, u1y, u1z = u1x * c, u1y * c, u1z * c
        u2x, u2y, u2z = u2x * c, u2y * c, u2z * c
    else:
        m1v, m2v = m1, m2

    p1x, p1y, p1z = u1x * m1v, u1y * m1v, u1z * m1v
    p2x, p2y, p2z = u2x * m2v, u2y * m2v, u2z * m2v

    mass_g = m1v * g1 + m2v * g2
    vcx = (p1x + p2x) / mass_g
    vcy = (p1y + p2y) / mass_g
    vcz = (p1z + p2z) / mass_g
    vcms = vcx * vcx + vcy * vcy + vcz * vcz
    gc = 1.0 / torch.sqrt(torch.clamp(1.0 - vcms * inv_c2_SI, min=1e-30))

    vcDv1 = (vcx * u1x + vcy * u1y + vcz * u1z) / g1
    vcDv2 = (vcx * u2x + vcy * u2y + vcz * u2z) / g2

    zero = torch.zeros_like(vcms)
    vc_ok = vcms > tiny
    ltf = torch.where(vc_ok, ((gc - 1.0) / torch.clamp(vcms, min=tiny)
                              * vcDv1 - gc) * m1v * g1, zero)
    p1sx = p1x + vcx * ltf
    p1sy = p1y + vcy * ltf
    p1sz = p1z + vcz * ltf
    p1sm = torch.sqrt(p1sx ** 2 + p1sy ** 2 + p1sz ** 2)
    p1sm_safe = torch.clamp(p1sm, min=tiny)

    g1s = (1.0 - vcDv1 * inv_c2_SI) * gc * g1
    g2s = (1.0 - vcDv2 * inv_c2_SI) * gc * g2

    # Coulomb log (ref :107-125)
    b0 = abs(q1 * q2) * inv_c2_SI / (4.0 * math.pi * cst.SI_ep0) \
        * gc / mass_g * (m1v * g1s * m2v * g2s
                         / (p1sm_safe * p1sm_safe * inv_c2_SI) + 1.0)
    bmin = torch.maximum(cst.SI_hbar * math.pi / p1sm_safe, b0)
    lnLmd_auto = torch.clamp(
        0.5 * torch.log(1.0 + lmdD * lmdD / (bmin * bmin)), min=2.0)
    lnLmd = lnLmd_auto if L <= 0.0 else torch.full_like(lnLmd_auto, L)

    # s parameter (ref :127-146)
    tts = m1v * g1s * m2v * g2s / (inv_c2_SI * p1sm_safe * p1sm_safe) + 1.0
    charge_fac = (cst.SI_q_e ** 4) if normalized_units else 1.0
    s = (n1 * n2 / torch.clamp(n12, min=tiny) * dt * lnLmd
         * q1 * q1 * q2 * q2 * charge_fac * inv_c2_SI * inv_c2_SI
         / (4.0 * math.pi * cst.SI_ep0 ** 2 * m1v * g1 * m2v * g2)
         * gc * p1sm / mass_g * tts * tts)
    coeff = (4.0 * math.pi / 3.0) ** (1.0 / 3.0)
    vrel = mass_g * p1sm / (m1v * g1s * m2v * g2s * gc)
    sp = (coeff * n1 * n2 / torch.clamp(n12, min=tiny) * dt * vrel
          * (m1v + m2v) / torch.maximum(m1v * n1 ** (2.0 / 3.0),
                                        m2v * n2 ** (2.0 / 3.0)))
    s = torch.minimum(s, sp)

    # scattering angle (ref :148-182), branch-free
    r, phi_draw, r1, r2 = draws
    cos_small = torch.clamp(1.0 + s * torch.log(torch.clamp(r, min=1e-30)),
                            min=-1.0)
    s2, s3, s4, s5 = s * s, s ** 3, s ** 4, s ** 5
    Ainv = (0.0056958 + 0.9560202 * s - 0.508139 * s2
            + 0.47913906 * s3 - 0.12788975 * s4 + 0.02389567 * s5)
    Ainv = torch.clamp(Ainv, min=1e-10)
    cos_mid = Ainv * torch.log(torch.exp(-1.0 / Ainv)
                               + 2.0 * r * torch.sinh(1.0 / Ainv))
    A = 3.0 * torch.exp(-torch.clamp(s, max=30.0))
    cos_big = 1.0 / A * torch.log(torch.exp(-A) + 2.0 * r * torch.sinh(A))
    cos_iso = 2.0 * r - 1.0
    cosXs = torch.where(s <= 0.1, cos_small,
                        torch.where(s <= 3.0, cos_mid,
                                    torch.where(s <= 6.0, cos_big, cos_iso)))
    cosXs = torch.clamp(cosXs, -1.0, 1.0)
    sinXs = torch.sqrt(torch.clamp(1.0 - cosXs * cosXs, min=0.0))

    phis = phi_draw * 2.0 * math.pi
    cosp, sinp = torch.cos(phis), torch.sin(phis)

    # post-collision momenta in COM (ref :189-231), with the axis fallback
    p1sp_a = torch.sqrt(p1sx ** 2 + p1sy ** 2)
    use_a = p1sp_a > tiny
    p1sp_b = torch.clamp(torch.sqrt(p1sy ** 2 + p1sz ** 2), min=tiny)
    p1sp_a = torch.clamp(p1sp_a, min=tiny)
    fax = (p1sx * p1sz / p1sp_a) * sinXs * cosp \
        + (p1sy * p1sm / p1sp_a) * sinXs * sinp + p1sx * cosXs
    fay = (p1sy * p1sz / p1sp_a) * sinXs * cosp \
        - (p1sx * p1sm / p1sp_a) * sinXs * sinp + p1sy * cosXs
    faz = -p1sp_a * sinXs * cosp + p1sz * cosXs
    fby = (p1sy * p1sx / p1sp_b) * sinXs * cosp \
        + (p1sz * p1sm / p1sp_b) * sinXs * sinp + p1sy * cosXs
    fbz = (p1sz * p1sx / p1sp_b) * sinXs * cosp \
        - (p1sy * p1sm / p1sp_b) * sinXs * sinp + p1sz * cosXs
    fbx = -p1sp_b * sinXs * cosp + p1sx * cosXs
    p1fsx = torch.where(use_a, fax, fbx)
    p1fsy = torch.where(use_a, fay, fby)
    p1fsz = torch.where(use_a, faz, fbz)

    # back to the lab frame (ref :233-259)
    vcDp1fs = vcx * p1fsx + vcy * p1fsy + vcz * p1fsz
    factor = (gc - 1.0) / torch.clamp(vcms, min=tiny)
    f1 = torch.where(vc_ok, factor * vcDp1fs + m1v * g1s * gc, zero)
    f2 = torch.where(vc_ok, factor * (-vcDp1fs) + m2v * g2s * gc, zero)
    p1fx = p1fsx + vcx * f1
    p1fy = p1fsy + vcy * f1
    p1fz = p1fsz + vcz * f1
    p2fx = -p1fsx + vcx * f2
    p2fy = -p1fsy + vcy * f2
    p2fz = -p1fsz + vcz * f2

    # rejection per species (ref :261-283)
    wmax = torch.maximum(w1, w2)
    take1 = (w2 > r1 * wmax) & ~no_collide
    take2 = (w1 > r2 * wmax) & ~no_collide

    scale = inv_c_SI if normalized_units else 1.0
    return ((torch.where(take1, p1fx / m1v * scale, u1x * scale),
             torch.where(take1, p1fy / m1v * scale, u1y * scale),
             torch.where(take1, p1fz / m1v * scale, u1z * scale)),
            (torch.where(take2, p2fx / m2v * scale, u2x * scale),
             torch.where(take2, p2fy / m2v * scale, u2y * scale),
             torch.where(take2, p2fz / m2v * scale, u2z * scale)))


def _time_step_SI(geom: Geometry, normalized_units: bool,
                  background_density_SI: float) -> float:
    """A slice's time step in seconds, dz / omega_p in normalized units."""
    if normalized_units:
        return geom.dz / cst.plasma_frequency_SI(background_density_SI)
    return geom.dz / cst.SI_c


def beam_plasma_collision(p1, p2, geom, cfg1, cfg2, pc, coulomb_log,
                          background_density_SI, normalized_units, draws,
                          dt_step):
    """A beam's lanes against a plasma (ref CoulombCollision.cpp:245-350)
    over the full time step dt_step. draws: as _inter_species_collision's.
    Returns (beam lanes, plasma)."""
    return _inter_species_collision(p1, p2, geom, cfg1, cfg2, pc,
                                    coulomb_log, background_density_SI,
                                    normalized_units, draws, beam1=True,
                                    dt_step=dt_step)


def plasma_plasma_collision(p1: dict, p2: dict, geom: Geometry, cfg1, cfg2,
                            pc, coulomb_log, background_density_SI,
                            normalized_units, draws, is_same_species: bool):
    """Intra- or inter-species plasma collisions on one slice (ref
    CoulombCollision.cpp:60-240). draws, for the same species: "sort" (n,),
    "kick" and "wrap kick" (4, n), the second pass's draws; for two
    species those of _inter_species_collision. Returns the updated
    (p1, p2)."""
    if not is_same_species:
        return _inter_species_collision(p1, p2, geom, cfg1, cfg2, pc,
                                        coulomb_log, background_density_SI,
                                        normalized_units, draws, beam1=False)
    p, cfg = p1, cfg1
    clight = pc.c
    inv_c = 1.0 / pc.c
    inv_c2 = inv_c * inv_c
    n = p["x"].numel()
    device = p["x"].device
    ncell = geom.nx * geom.ny
    dt = _time_step_SI(geom, normalized_units, background_density_SI)
    inv_dV = 1.0 / (geom.dx * geom.dy * geom.dz)

    cell, ok = _cell_of(p["x"], p["y"], geom)
    cell = torch.where(p["valid"] & ok, cell, torch.full_like(cell, ncell))
    idx = _shuffled_cell_sort(cell, draws["sort"])
    cs = cell[idx]

    starts = torch.searchsorted(cs, torch.arange(ncell + 1, device=device))
    counts = starts[1:] - starts[:-1]
    pos = torch.arange(n, device=device)
    my_cell = torch.clamp(cs, 0, ncell - 1)
    rank = pos - starts[my_cell]
    n_in_cell = counts[my_cell]
    nh = n_in_cell // 2     # group-1 size NI1 (ref CoulombCollision.cpp:122)
    is_a = rank < nh        # pair lead: rank k pairs rank k + NI1
    partner_pos = torch.where(is_a, pos + nh, pos)
    # odd cells: ceil(n/2) pairs with cyclic reuse, so lead rank 0
    # collides a second time with the leftover rank n-1 (ref
    # ElasticCollisionPerez.H:146-188)
    is_wrap = (n_in_cell % 2 == 1) & (n_in_cell >= 3) & (rank == 0)
    wrap_pos = torch.where(is_wrap, pos + n_in_cell - 1, pos)

    ux, uy, psi = p["ux"][idx], p["uy"][idx], p["psi"][idx]
    w = torch.where(p["valid"][idx], p["w"][idx], torch.zeros_like(ux))
    ion = p["ion_lev"][idx].to(ux.dtype) if cfg.can_ionize else None

    g = _gamma_plasma(ux, uy, psi, inv_c2)
    uz = clight * (g - psi)

    # per-cell temperature (ref ComputeTemperature.H)
    def cellsum(v):
        return _cellsum(cs, v, ncell)

    nn = torch.clamp(cellsum((cs < ncell).to(ux.dtype)), min=1.0)
    vx_m = cellsum(ux / g) / nn
    vy_m = cellsum(uy / g) / nn
    vz_m = cellsum(uz / g) / nn
    vs_m = cellsum((ux * ux + uy * uy + uz * uz) / (g * g)) / nn
    mass = cfg.mass
    T_cell = mass / 3.0 * (vs_m - (vx_m ** 2 + vy_m ** 2 + vz_m ** 2))

    n1_cell = cellsum(w)  # same species: n1 = n2 = total
    # n12 = 2 * sum over the ceil(n/2) (wrapped) pairs of min(w_a, w_b)
    # (ref ElasticCollisionPerez.H:106-116)
    bpos = torch.clamp(partner_pos, 0, n - 1)
    wpos = torch.clamp(wrap_pos, 0, n - 1)
    zero = torch.zeros_like(w)
    pair_min = torch.where(is_a, torch.minimum(w, w[bpos]), zero)
    wrap_min = torch.where(is_wrap, torch.minimum(w, w[wpos]), zero)
    n12_cell = 2.0 * cellsum(pair_min + wrap_min)

    dens_fac = background_density_SI if normalized_units else inv_dV
    n1 = n1_cell * dens_fac
    n12 = n12_cell * dens_fac

    q = cfg.charge
    # Debye length from SI-unit temperature and charge
    if normalized_units:
        T_SI = T_cell * cst.SI_m_e * cst.SI_c * cst.SI_c
        q_SI = q * cst.SI_q_e
    else:
        T_SI, q_SI = T_cell, q
    lmdD = torch.where(
        T_SI > 0.0,
        1.0 / torch.sqrt(torch.clamp(
            2.0 * n1 * q_SI * q_SI
            / (torch.clamp(T_SI, min=1e-300) * cst.SI_ep0), min=1e-300)),
        torch.zeros_like(T_SI))
    rmin = (4.0 * math.pi / 3.0 * torch.clamp(n1, min=1e-300)) \
        ** (-1.0 / 3.0)
    lmdD = torch.maximum(lmdD, rmin)

    q_a = q * ion if ion is not None else q
    q_b = q * ion[bpos] if ion is not None else q
    mc = my_cell
    dt_fac = 0.5 * (g / psi + (g / psi)[bpos])
    (a1x, a1y, a1z), (a2x, a2y, a2z) = _pair_kick(
        ux, uy, uz, g, ux[bpos], uy[bpos], uz[bpos],
        _gamma_plasma(ux[bpos], uy[bpos], psi[bpos], inv_c2),
        n1[mc], n1[mc], n12[mc], q_a, mass, w, q_b, mass, w[bpos],
        dt * dt_fac, coulomb_log, lmdD[mc], normalized_units,
        draws["kick"])

    # valid pairs only
    pair_ok = is_a & (w > 0) & (w[bpos] > 0) & (cs < ncell)
    new_ux = torch.where(pair_ok, a1x, ux)
    new_uy = torch.where(pair_ok, a1y, uy)
    new_uz = torch.where(pair_ok, a1z, uz)

    # partner updates from the lead lanes only: every other lane writes
    # into a dropped slot n (the partners of the leads are distinct)
    def scatter_partner(base, vals, okk, tgt):
        arr = torch.cat([base, base.new_zeros(1)])
        arr.index_put_((torch.where(okk, tgt, torch.full_like(tgt, n)),),
                       torch.where(okk, vals, torch.zeros_like(vals)))
        return arr[:-1]

    new_ux = scatter_partner(new_ux, a2x, pair_ok, bpos)
    new_uy = scatter_partner(new_uy, a2y, pair_ok, bpos)
    new_uz = scatter_partner(new_uz, a2z, pair_ok, bpos)

    # the wrap pass (odd cells): rank 0 collides again with rank n-1 after
    # its first kick, sequentially like the reference's per-cell loop (ref
    # ElasticCollisionPerez.H:148)
    g_w = torch.sqrt(1.0 + (new_ux ** 2 + new_uy ** 2 + new_uz ** 2)
                     * inv_c2)
    psi_w = g_w - new_uz * inv_c
    q_bw = q * ion[wpos] if ion is not None else q
    dt_fac_w = 0.5 * (g_w / psi_w + (g_w / psi_w)[wpos])
    (b1x, b1y, b1z), (b2x, b2y, b2z) = _pair_kick(
        new_ux, new_uy, new_uz, g_w,
        new_ux[wpos], new_uy[wpos], new_uz[wpos], g_w[wpos],
        n1[mc], n1[mc], n12[mc], q_a, mass, w, q_bw, mass, w[wpos],
        dt * dt_fac_w, coulomb_log, lmdD[mc], normalized_units,
        draws["wrap kick"])
    wrap_ok = is_wrap & (w > 0) & (w[wpos] > 0) & (cs < ncell)
    new_ux = torch.where(wrap_ok, b1x, new_ux)
    new_uy = torch.where(wrap_ok, b1y, new_uy)
    new_uz = torch.where(wrap_ok, b1z, new_uz)
    new_ux = scatter_partner(new_ux, b2x, wrap_ok, wpos)
    new_uy = scatter_partner(new_uy, b2y, wrap_ok, wpos)
    new_uz = scatter_partner(new_uz, b2z, wrap_ok, wpos)

    g_new = torch.sqrt(1.0 + (new_ux ** 2 + new_uy ** 2 + new_uz ** 2)
                       * inv_c2)
    new_psi = g_new - new_uz * inv_c

    # back to lane order: the sorted position of lane i is inv[i]
    inv = torch.empty_like(idx)
    inv[idx] = pos
    valid = p["valid"]
    out = dict(p)
    out["ux"] = torch.where(valid, new_ux[inv], p["ux"])
    out["uy"] = torch.where(valid, new_uy[inv], p["uy"])
    out["psi"] = torch.where(valid, new_psi[inv], p["psi"])
    return out, p2


def _plasma_uz(ux, uy, psi, inv_c2, clight):
    g = _gamma_plasma(ux, uy, psi, inv_c2)
    return g, clight * (g - psi)


def _inter_species_collision(p1, p2, geom, cfg1, cfg2, pc, coulomb_log,
                             background_density_SI, normalized_units, draws,
                             beam1: bool, dt_step=0.0):
    """Species 1 (a beam's lanes or a plasma) against plasma species 2:
    each species-1 lane pairs with a random species-2 lane of its cell (ref
    CoulombCollision.cpp:160-240, 245-350). draws: "sort" (n2,), the
    species-2 sort keys; "pick" (n1,), the partner picks; "kick" (4, n1).
    A species-2 lane picked by several takes the kick of the last of them
    (R17). Returns the updated (p1, p2)."""
    clight = pc.c
    inv_c = 1.0 / pc.c
    inv_c2 = inv_c * inv_c
    ncell = geom.nx * geom.ny
    inv_dV = 1.0 / (geom.dx * geom.dy * geom.dz)
    device = p2["x"].device

    n1p = p1["x"].numel()
    n2p = p2["x"].numel()
    cell1, ok1 = _cell_of(p1["x"], p1["y"], geom)
    cell1 = torch.where(p1["valid"] & ok1, cell1,
                        torch.full_like(cell1, ncell))
    cell2, ok2 = _cell_of(p2["x"], p2["y"], geom)
    cell2 = torch.where(p2["valid"] & ok2, cell2,
                        torch.full_like(cell2, ncell))

    perm2 = _shuffled_cell_sort(cell2, draws["sort"])
    cs2 = cell2[perm2]
    starts2 = torch.searchsorted(cs2, torch.arange(ncell + 1, device=device))
    counts2 = starts2[1:] - starts2[:-1]

    # each species-1 lane draws a random partner among the n2 of its cell
    c1 = torch.clamp(cell1, 0, ncell - 1)
    n2_in = counts2[c1]
    pick = torch.minimum((draws["pick"] * n2_in).to(torch.int64),
                         torch.clamp(n2_in - 1, min=0))
    partner = torch.clamp(starts2[c1] + pick, 0, max(n2p - 1, 0))
    has_partner = (n2_in > 0) & (cell1 < ncell)

    w1 = torch.where(p1["valid"], p1["w"], torch.zeros_like(p1["w"]))
    v2s = p2["valid"][perm2]
    w2s = torch.where(v2s, p2["w"][perm2], torch.zeros_like(p2["w"]))
    part1 = torch.where(has_partner, c1, torch.full_like(c1, ncell))

    dens_fac = background_density_SI if normalized_units else inv_dV
    n1_cell = _cellsum(part1, w1, ncell) * dens_fac
    n2_cell = _cellsum(cs2, w2s, ncell) * dens_fac
    w2_of_1 = w2s[partner]
    n12_cell = _cellsum(part1, torch.minimum(w1, w2_of_1), ncell) * dens_fac

    # species-1 kinematics
    u1x, u1y = p1["ux"], p1["uy"]
    if beam1:
        u1z = p1["uz"]
        g1 = torch.sqrt(1.0 + (u1x ** 2 + u1y ** 2 + u1z ** 2) * inv_c2)
    else:
        g1, u1z = _plasma_uz(u1x, u1y, p1["psi"], inv_c2, clight)

    uxs, uys, psis = p2["ux"][perm2], p2["uy"][perm2], p2["psi"][perm2]
    u2x, u2y, psi2 = uxs[partner], uys[partner], psis[partner]
    g2, u2z = _plasma_uz(u2x, u2y, psi2, inv_c2, clight)

    # per-cell temperatures, vs - |v|^2 (ref ComputeTemperature.H)
    def temp(uxt, uyt, uzt, gz, cells, valid):
        m = valid.to(uxt.dtype)
        nn = torch.clamp(_cellsum(cells, m, ncell), min=1.0)
        vx = _cellsum(cells, m * uxt / gz, ncell) / nn
        vy = _cellsum(cells, m * uyt / gz, ncell) / nn
        vz = _cellsum(cells, m * uzt / gz, ncell) / nn
        vs = _cellsum(cells, m * (uxt ** 2 + uyt ** 2 + uzt ** 2) / gz ** 2,
                      ncell) / nn
        return vs - (vx ** 2 + vy ** 2 + vz ** 2)

    T1 = cfg1.mass / 3.0 * temp(u1x, u1y, u1z, g1, cell1, p1["valid"])
    g2s, u2zs = _plasma_uz(uxs, uys, psis, inv_c2, clight)
    T2 = cfg2.mass / 3.0 * temp(uxs, uys, u2zs, g2s, cs2, v2s)

    if normalized_units:
        T1_SI = T1 * cst.SI_m_e * cst.SI_c ** 2
        T2_SI = T2 * cst.SI_m_e * cst.SI_c ** 2
        q1_SI = cfg1.charge * cst.SI_q_e
        q2_SI = cfg2.charge * cst.SI_q_e
    else:
        T1_SI, T2_SI = T1, T2
        q1_SI, q2_SI = cfg1.charge, cfg2.charge
    denom = (n1_cell * q1_SI ** 2 / torch.clamp(T1_SI, min=1e-300)
             + n2_cell * q2_SI ** 2 / torch.clamp(T2_SI, min=1e-300)) \
        / cst.SI_ep0
    lmdD = torch.where((T1_SI > 0) & (T2_SI > 0),
                       1.0 / torch.sqrt(torch.clamp(denom, min=1e-300)),
                       torch.zeros_like(denom))
    rmin = (4.0 * math.pi / 3.0 * torch.clamp(
        torch.maximum(n1_cell, n2_cell), min=1e-300)) ** (-1.0 / 3.0)
    lmdD = torch.maximum(lmdD, rmin)

    if beam1:
        # dt is the full time step (ref CoulombCollision.cpp:302)
        if normalized_units:
            dt = dt_step / cst.plasma_frequency_SI(background_density_SI)
        else:
            dt = dt_step
        dtv = torch.full_like(u1x, dt)
    else:
        dtv = _time_step_SI(geom, normalized_units, background_density_SI) \
            * 0.5 * (g1 / p1["psi"] + g2 / psi2)

    ion1 = (p1["ion_lev"].to(u1x.dtype)
            if getattr(cfg1, "can_ionize", False) else 1.0)
    (n1x, n1y, n1z), (n2x, n2y, n2z) = _pair_kick(
        u1x, u1y, u1z, g1, u2x, u2y, u2z, g2,
        n1_cell[c1], n2_cell[c1], n12_cell[c1],
        cfg1.charge * ion1, cfg1.mass, w1, cfg2.charge, cfg2.mass, w2_of_1,
        dtv, coulomb_log, lmdD[c1], normalized_units, draws["kick"])

    okp = has_partner & (w1 > 0) & (w2_of_1 > 0)
    out1 = dict(p1)
    out1["ux"] = torch.where(okp, n1x, p1["ux"])
    out1["uy"] = torch.where(okp, n1y, p1["uy"])
    if beam1:
        out1["uz"] = torch.where(okp, n1z, p1["uz"])
    else:
        gn = torch.sqrt(1.0 + (n1x ** 2 + n1y ** 2 + n1z ** 2) * inv_c2)
        out1["psi"] = torch.where(okp, gn - n1z * inv_c, p1["psi"])

    # species 2: a partner picked by several species-1 lanes takes the kick
    # of the last of them in lane order (R17), chosen explicitly so that
    # every device agrees; the others' writes are dropped
    gn2 = torch.sqrt(1.0 + (n2x ** 2 + n2y ** 2 + n2z ** 2) * inv_c2)
    psi2_new = gn2 - n2z * inv_c
    target = torch.where(okp, partner, torch.full_like(partner, n2p))
    lane1 = torch.arange(n1p, device=device)
    last = torch.full((n2p + 1,), -1, dtype=torch.int64,
                      device=device).scatter_reduce_(0, target, lane1,
                                                     "amax")[:n2p]
    hit = last >= 0
    src = torch.clamp(last, min=0)
    new_uxs = torch.where(hit, n2x[src], uxs) if n1p else uxs
    new_uys = torch.where(hit, n2y[src], uys) if n1p else uys
    new_psis = torch.where(hit, psi2_new[src], psis) if n1p else psis
    inv2 = torch.empty_like(perm2)
    inv2[perm2] = torch.arange(n2p, device=device)
    out2 = dict(p2)
    out2["ux"] = new_uxs[inv2]
    out2["uy"] = new_uys[inv2]
    out2["psi"] = new_psis[inv2]
    return out1, out2
