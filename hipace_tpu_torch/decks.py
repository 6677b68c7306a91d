"""Decks the port carries.

``BLOWOUT_WAKE`` is the repository's flagship case, the deck of
``__graft_entry__._DECK``: a blowout wake driven by a fixed_weight gaussian
beam through a 1 ppc electron plasma, with the explicit Bx/By solver. It is
kept here so that a run of the port needs nothing of the JAX package's
entry points; a test holds the two equal.

``PDF_BEAM`` is the flagship deck with a fixed_weight_pdf beam: a gaussian
pdf(z) of sigma 1.41 about z = -1, transverse sigma 0.3, uz = 2000 and peak
density 3. It is shaped like the reference's transverse benchmark deck
(``examples/benchmarks/inputs_transverse_benchmark``: a pdf beam, a 1 ppc
plasma, the explicit solver) and is not that file.

``PC_OPEN`` is the flagship deck on the predictor-corrector Bx/By solver
with open field boundaries and absorbing particle boundaries, at the
reference's default predictor-corrector parameters (tolerance 4e-2, at
most 30 iterations, mixing factor 0.05; ref Hipace.H:210-222). Its domain,
(-8..8)^2, holds x = y = 0, the open boundary's expansion point.

``ION_MOTION_EVEN`` is the flagship's grid, beam, order and explicit solver
at an even transverse size (full width 1024^2, the cell-centered multigrid)
with two mobile plasma species: electrons with a temperature (u_std 0.01 in
each direction) and hydrogen ions, 1 ppc each, neither with a neutralizing
background (the ions are the neutralizing charge). It is shaped like the
reference's ion-motion example (``examples/linear_wake/inputs_ion_motion_SI``:
electrons and mobile ions, the explicit solver) and is not that file.

``DRIVE_WITNESS`` is the flagship's grid, 1 ppc plasma and explicit solver
with two beams: the flagship's fixed_weight gaussian beam as the drive and,
behind it in the wake, a fixed_weight gaussian witness (z = -4.5, sigma_z
0.3, radius 0.3, density 3, uz = 2000 with a 1% spread) with a quarter of
the drive's particles, spin tracking from (1, 0, 0) and radiation reaction;
``hipace.background_density_SI`` (1e24 m^-3) gives radiation reaction its
plasma frequency. It is shaped like the reference's
``examples/get_started/inputs_pwfa`` (a drive and a witness beam) and is
not that file.

``GRID_CURRENT`` is a beam in vacuum with an analytic grid current of the
same shape as the beam, shaped like the reference's ``grid_current.1Rank``
checksum case (``examples/beam_in_vacuum/inputs_normalized`` with the grid
current on: order 0, peak current density 0.2, sigma 0.3 0.3 1.41).

``LASER_WAKE`` is a laser-driven blowout: the overrides of the reference's
``laser_blowout_wake_explicit.1Rank`` checksum case (no beam; prob_lo -20
-20 -7.5, prob_hi 20 20 6; lasers.lambda0 0.8e-6; one gaussian pulse of a0
4.5, w0 4 and L0 2 at the origin; the multigrid envelope solver) on the
flagship's 1 ppc electron plasma with the explicit Bx/By solver. Full width
is nxy = 1023: 1,046,529 plasma lanes and a 1025^2 complex envelope per
slice.

``ADAPTIVE_VACUUM`` is a beam in vacuum on the adaptive time step, shaped
like the reference's ``adaptive_time_step.1Rank`` case (32^3 cells over
(-2..2)^3, a fixed_ppc gaussian beam of ppc 4 4 1, density 1 and radius 1
with four subcycles, an external Ez = z/2, ``plasmas.adaptive_density`` 1,
nt_per_betatron 89.7597901025655) with ``hipace.max_time``, so that the run
lands on it and takes one more step with dt = 0.

``IONIZATION_WAKE`` is the JAX package's reduced copy of the reference's
``examples/blowout_wake/inputs_ionization_SI`` (``tests/test_ionization.py``:
SI units, ne = 1.25e24 m^-3, a (-20..20 um)^2 x (-30..30 um) box): a fixed_ppc
flattop beam of density 4 ne, radius kp_inv / 2, 2 kp_inv long behind z =
25 um, uz = 2000, tunnel-ionizes hydrogen (``ion``: ppc 1 1,
``initial_ion_level`` 0) whose electrons join ``elec`` (ppc 0 0); neither
species has a neutralizing background. ``hipace.dt`` is 1e-12 s, the
``ionization.2Rank`` checksum case's, so the beam moves. It is that test's
deck on an nxy^2 x nz grid and is not the reference's file. Full width is
nxy = 1023: 1,046,529 ion lanes and as many electron slots.

``COLLISION_WAKE`` is the flagship with ``hipace.background_density_SI =
1e24`` and two Coulomb collisions, ``pp`` (plasma with itself) and ``bp``
(the beam against the plasma): the shape of the ``collisions.SI.1Rank`` and
``collisions_beam.SI.1Rank`` checksum cases (the reference's
``examples/blowout_wake/inputs_SI`` with one of the two each) in one deck on
the flagship's grid, and not those files.

``SALAME_WAKE`` is the deck of the JAX package's SALAME test
(``tests/test_salame.py:11-51``), not a reference file: a fixed_weight
gaussian drive (z = 2, sigma_z 1.0, density 2, uz = 2000) and behind it a
``can`` witness (z -2.4..-1.4, radius 0.8, density 0.4, uz = 1000) with
``do_salame``, through a 1 ppc electron plasma in a (-8..8)^2 x (-7..5) box,
with four SALAME iterations. At full width (1023^2) the drive has the
flagship's 669,778 particles and the witness a third of that, the test's
3:1.

``MR_WAKE`` is the flagship with one mesh-refinement level around the
drive's core: an nfine^2 patch over (-2..2)^2 at z -4..0, and a fine plasma
patch of 2 x 2 ppc over (-2.3..2.3)^2 (the form of the JAX package's
``test_salame_with_mr``), with the level's on-axis Ez written as an xz
diagnostic in json (the GPU machine has no h5py). At full width nxy = 1023 and nfine = 511 (odd, the
node-centered multigrid): 2x refinement, 4,186,116 plasma slots, and the
level active on 33 of 64 slices (16-48).
"""

from __future__ import annotations

from .parser import Inputs

BLOWOUT_WAKE = """
amr.n_cell = {nxy} {nxy} {nz}
hipace.normalized_units = 1
max_step = 0
hipace.dt = 1.0
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -8. -8. -6.
geometry.prob_hi =  8.  8.  2.
beams.names = beam
beam.injection_type = fixed_weight
beam.num_particles = {npart}
beam.profile = gaussian
beam.position_mean = 0. 0. -1.
beam.position_std = 0.3 0.3 1.41
beam.zmin = -5.9
beam.zmax = 1.9
beam.density = 3.
beam.u_mean = 0. 0. 2000.
beam.u_std = 0. 0. 0.
plasmas.names = plasma
plasma.density(x,y,z) = 1.
plasma.ppc = 1 1
plasma.element = electron
diagnostic.output_period = 0
"""


def blowout_wake(nxy: int, nz: int, npart: int, extra: str = "") -> Inputs:
    """The flagship deck on an nxy^2 x nz grid with an npart-particle beam,
    followed by the deck lines in `extra`."""
    return Inputs(BLOWOUT_WAKE.format(nxy=nxy, nz=nz, npart=npart) + extra)


PDF_BEAM = """
amr.n_cell = {nxy} {nxy} {nz}
hipace.normalized_units = 1
max_step = 0
hipace.dt = 1.0
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -8. -8. -6.
geometry.prob_hi =  8.  8.  2.
beams.names = beam
beam.injection_type = fixed_weight_pdf
beam.num_particles = {npart}
beam.pdf(z) = exp(-0.5*((z+1.)/1.41)^2)
beam.position_mean = "0." "0."
beam.position_std = "0.3" "0.3"
beam.u_mean = "0." "0." "2000."
beam.u_std = "0." "0." "0."
beam.density = 3.
plasmas.names = plasma
plasma.density(x,y,z) = 1.
plasma.ppc = 1 1
plasma.element = electron
diagnostic.output_period = 0
"""


def pdf_beam(nxy: int, nz: int, npart: int, extra: str = "") -> Inputs:
    """PDF_BEAM on an nxy^2 x nz grid with an npart-particle beam, followed
    by the deck lines in `extra`; full width is nxy = 1023 with the
    bench's npart = nxy^2 * 10 * nz / 1000."""
    return Inputs(PDF_BEAM.format(nxy=nxy, nz=nz, npart=npart) + extra)


PC_OPEN = BLOWOUT_WAKE.replace(
    "boundary.field = Dirichlet\nboundary.particle = Periodic\n",
    "boundary.field = Open\nboundary.particle = Absorbing\n") + """\
hipace.bxby_solver = predictor-corrector
hipace.predcorr_B_error_tolerance = 4e-2
hipace.predcorr_max_iterations = 30
hipace.predcorr_B_mixing_factor = 0.05
"""


def pc_open(nxy: int, nz: int, npart: int, extra: str = "") -> Inputs:
    """PC_OPEN on an nxy^2 x nz grid with an npart-particle beam, followed
    by the deck lines in `extra`."""
    return Inputs(PC_OPEN.format(nxy=nxy, nz=nz, npart=npart) + extra)


ION_MOTION_EVEN = BLOWOUT_WAKE.replace(
    """plasmas.names = plasma
plasma.density(x,y,z) = 1.
plasma.ppc = 1 1
plasma.element = electron
""", """hipace.MG_tolerance_rel = 1e-4
plasmas.names = elec ions
elec.density(x,y,z) = 1.
elec.ppc = 1 1
elec.element = electron
elec.u_std = 0.01 0.01 0.01
elec.neutralize_background = 0
ions.density(x,y,z) = 1.
ions.ppc = 1 1
ions.element = H
ions.neutralize_background = 0
""")


def ion_motion_even(nxy: int, nz: int, npart: int, extra: str = "") -> Inputs:
    """ION_MOTION_EVEN on an nxy^2 x nz grid with an npart-particle beam,
    followed by the deck lines in `extra`; full width is nxy = 1024 with
    the flagship's npart."""
    return Inputs(ION_MOTION_EVEN.format(nxy=nxy, nz=nz, npart=npart)
                  + extra)


DRIVE_WITNESS = BLOWOUT_WAKE.replace("beams.names = beam\n",
                                     "beams.names = beam witness\n") + """\
hipace.background_density_SI = 1e24
witness.injection_type = fixed_weight
witness.num_particles = {nwit}
witness.profile = gaussian
witness.position_mean = 0. 0. -4.5
witness.position_std = 0.3 0.3 0.3
witness.zmin = -5.9
witness.zmax = -3.
witness.density = 3.
witness.u_mean = 0. 0. 2000.
witness.u_std = 0. 0. 20.
witness.do_spin_tracking = 1
witness.initial_spin = 1. 0. 0.
witness.do_radiation_reaction = 1
"""


def drive_witness(nxy: int, nz: int, npart: int, extra: str = "") -> Inputs:
    """DRIVE_WITNESS on an nxy^2 x nz grid with an npart-particle drive and
    an npart // 4 witness, followed by the deck lines in `extra`; full width
    is nxy = 1023 with the flagship's npart."""
    return Inputs(DRIVE_WITNESS.format(nxy=nxy, nz=nz, npart=npart,
                                       nwit=npart // 4) + extra)


GRID_CURRENT = """
amr.n_cell = {nxy} {nxy} {nz}
hipace.normalized_units = 1
max_step = 0
hipace.dt = 1.0
hipace.depos_order_xy = 0
boundary.field = Dirichlet
boundary.particle = Absorbing
geometry.prob_lo = -8. -8. -6.
geometry.prob_hi =  8.  8.  6.
grid_current.use_grid_current = 1
grid_current.peak_current_density = 0.2
grid_current.position_mean = 0. 0. 0.
grid_current.position_std = 0.3 0.3 1.41
beams.names = beam
beam.injection_type = fixed_weight
beam.num_particles = {npart}
beam.profile = gaussian
beam.position_mean = 0. 0. 0.
beam.position_std = 0.3 0.3 1.41
beam.radius = 1.
beam.density = 0.2
beam.u_mean = 0. 0. 2000.
plasmas.names = no_plasma
diagnostic.output_period = 0
"""


def grid_current(nxy: int, nz: int, npart: int, extra: str = "") -> Inputs:
    """GRID_CURRENT on an nxy^2 x nz grid with an npart-particle beam,
    followed by the deck lines in `extra`."""
    return Inputs(GRID_CURRENT.format(nxy=nxy, nz=nz, npart=npart) + extra)


LASER_WAKE = BLOWOUT_WAKE.replace(
    "geometry.prob_lo = -8. -8. -6.\ngeometry.prob_hi =  8.  8.  2.\n",
    "geometry.prob_lo = -20. -20. -7.5\ngeometry.prob_hi =  20.  20.  6.\n"
).replace("beams.names = beam\n", "beams.names = no_beam\n") + """\
lasers.names = laser
lasers.lambda0 = .8e-6
lasers.solver_type = multigrid
laser.a0 = 4.5
laser.position_mean = 0. 0. 0.
laser.w0 = 4.
laser.L0 = 2.
"""


def laser_wake(nxy: int, nz: int, npart: int = 0, extra: str = "") -> Inputs:
    """LASER_WAKE on an nxy^2 x nz grid, followed by the deck lines in
    `extra`; npart is unused (the deck has no beam), kept so that every
    deck function takes the same arguments."""
    return Inputs(LASER_WAKE.format(nxy=nxy, nz=nz, npart=npart) + extra)


ADAPTIVE_VACUUM = """
amr.n_cell = {nxy} {nxy} {nz}
hipace.normalized_units = 1
max_step = {max_step}
hipace.dt = adaptive
hipace.nt_per_betatron = 89.7597901025655
hipace.max_time = {max_time}
plasmas.adaptive_density = 1
hipace.adaptive_control_phase_advance = 0
boundary.field = Dirichlet
boundary.particle = Absorbing
geometry.prob_lo = -2. -2. -2.
geometry.prob_hi =  2.  2.  2.
beams.names = beam
beams.external_E(x,y,z,t) = 0. 0. .5*z
beam.injection_type = fixed_ppc
beam.profile = gaussian
beam.ppc = 4 4 1
beam.n_subcycles = 4
beam.density = 1.
beam.radius = 1.
beam.position_mean = 0. 0. 0.
beam.position_std = 0.3 0.3 0.5
beam.zmin = -1.9
beam.zmax = 1.9
beam.u_mean = 0. 0. 2000.
plasmas.names = no_plasma
diagnostic.output_period = 0
"""


def adaptive_vacuum(nxy: int, nz: int, max_step: int = 20,
                    max_time: float = 80.0, extra: str = "") -> Inputs:
    """ADAPTIVE_VACUUM on an nxy^2 x nz grid for max_step steps, landing on
    max_time, followed by the deck lines in `extra`."""
    return Inputs(ADAPTIVE_VACUUM.format(nxy=nxy, nz=nz, max_step=max_step,
                                         max_time=max_time) + extra)


IONIZATION_WAKE = """
amr.n_cell = {nxy} {nxy} {nz}
my_constants.ne = 1.25e24
my_constants.wp = sqrt(ne * q_e^2 / (epsilon0 * m_e))
my_constants.kp = wp / clight
my_constants.kp_inv = 1. / kp
max_step = 0
hipace.dt = 1e-12
hipace.depos_order_xy = 2
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -20.e-6 -20.e-6 -30.e-6
geometry.prob_hi =  20.e-6  20.e-6  30.e-6
beams.names = beam
beam.injection_type = fixed_ppc
beam.profile = flattop
beam.zmin = 25.e-6 - 2. * kp_inv
beam.zmax = 25.e-6
beam.radius = kp_inv / 2
beam.density = 4. * ne
beam.u_mean = 0. 0. 2000
beam.u_std = 0. 0. 0.
beam.ppc = 1 1 1
plasmas.names = elec ion
elec.density(x,y,z) = ne
elec.ppc = 0 0
elec.element = electron
elec.neutralize_background = false
ion.density(x,y,z) = ne
ion.ppc = 1 1
ion.element = H
ion.mass_Da = 1.008
ion.initial_ion_level = 0
ion.ionization_product = elec
diagnostic.output_period = 0
"""


def ionization_wake(nxy: int, nz: int, npart: int = 0,
                    extra: str = "") -> Inputs:
    """IONIZATION_WAKE on an nxy^2 x nz grid, followed by the deck lines in
    `extra`; npart is unused (the fixed_ppc beam's count follows the
    grid), kept so that every deck function takes the same arguments."""
    return Inputs(IONIZATION_WAKE.format(nxy=nxy, nz=nz) + extra)


COLLISION_WAKE = BLOWOUT_WAKE + """\
hipace.background_density_SI = 1e24
hipace.collisions = pp bp
pp.species = plasma plasma
bp.species = beam plasma
"""


def collision_wake(nxy: int, nz: int, npart: int, extra: str = "") -> Inputs:
    """COLLISION_WAKE on an nxy^2 x nz grid with an npart-particle beam,
    followed by the deck lines in `extra`; full width is nxy = 1023 with
    the flagship's npart."""
    return Inputs(COLLISION_WAKE.format(nxy=nxy, nz=nz, npart=npart)
                  + extra)


SALAME_WAKE = """
amr.n_cell = {nxy} {nxy} {nz}
hipace.normalized_units = 1
max_step = 0
hipace.dt = 0.
hipace.depos_order_xy = 2
hipace.salame_n_iter = 4
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -8. -8. -7.
geometry.prob_hi =  8.  8.  5.
beams.names = drive witness
drive.injection_type = fixed_weight
drive.num_particles = {npart}
drive.profile = gaussian
drive.position_mean = 0. 0. 2.
drive.position_std = 0.3 0.3 1.0
drive.zmin = -1.
drive.zmax = 4.9
drive.density = 2.
drive.u_mean = 0. 0. 2000.
drive.u_std = 0. 0. 0.
witness.injection_type = fixed_weight
witness.num_particles = {nwitness}
witness.profile = can
witness.zmin = -2.4
witness.zmax = -1.4
witness.radius = 0.8
witness.position_mean = 0. 0. 0.
witness.position_std = 0.2 0.2 1.
witness.density = 0.4
witness.u_mean = 0. 0. 1000.
witness.u_std = 0. 0. 0.
witness.do_salame = 1
plasmas.names = plasma
plasma.density(x,y,z) = 1.
plasma.ppc = 1 1
plasma.element = electron
diagnostic.output_period = 0
diagnostic.field_data = Ez
"""


def salame_wake(nxy: int, nz: int, npart: int, extra: str = "") -> Inputs:
    """SALAME_WAKE on an nxy^2 x nz grid with an npart-particle drive and a
    witness of npart // 3 particles, followed by the deck lines in
    `extra`."""
    return Inputs(SALAME_WAKE.format(nxy=nxy, nz=nz, npart=npart,
                                     nwitness=npart // 3) + extra)


MR_WAKE = BLOWOUT_WAKE + """\
amr.max_level = 1
mr_lev1.n_cell = {nfine} {nfine}
mr_lev1.patch_lo = -2. -2. -4.
mr_lev1.patch_hi =  2.  2.  0.
plasma.fine_patch(x,y) = (abs(x)<2.3)*(abs(y)<2.3)
plasma.fine_ppc = 2 2
diagnostic.names = lev0 lev1
lev1.base_geometry = level_1
lev1.field_data = Ez
lev1.diag_type = xz
lev1.output_period = 1
hipace.openpmd_backend = json
"""


def mr_wake(nxy: int, nz: int, npart: int, nfine: int,
            extra: str = "") -> Inputs:
    """MR_WAKE on an nxy^2 x nz grid with an npart-particle beam and an
    nfine^2 level, followed by the deck lines in `extra`."""
    return Inputs(MR_WAKE.format(nxy=nxy, nz=nz, npart=npart, nfine=nfine)
                  + extra)
